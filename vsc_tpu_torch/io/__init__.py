"""Host-side I/O of the port: the native vscmedia engine's decode, encode
and concat (``media.py``), the video probe (``probe.py``), PNG/TIFF frames
and depth maps with the read-back check (``image.py``) and the loader /
compute / saver pipeline of the step CLIs (``prefetch.py``), copied from
``vsc_tpu/io`` (framework-free) so that the port imports nothing of
``vsc_tpu``."""

from vsc_tpu_torch.io.probe import (get_video_framerate, parse_framerate,
                                    probe_video)

__all__ = ["get_video_framerate", "parse_framerate", "probe_video"]
