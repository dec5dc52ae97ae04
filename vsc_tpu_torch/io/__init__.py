"""Host-side media I/O of the port: the native vscmedia engine's decode,
encode and concat (``media.py``) and the video probe (``probe.py``), copied
from ``vsc_tpu/io`` (framework-free) so that the port imports nothing of
``vsc_tpu``."""

from vsc_tpu_torch.io.probe import (get_video_framerate, parse_framerate,
                                    probe_video)

__all__ = ["get_video_framerate", "parse_framerate", "probe_video"]
