"""Shared utilities of the port: frame numbering and console handling
(``frame_utils.py`` and ``console.py``, copies of ``vsc_tpu/utils``),
profiling (``profiling.py``, trace on ``torch.profiler``), the analytic
work counts and the card's peaks (``flops.py``) and the reference-semantics
oracle (``oracle.py``, a copy of ``tests/oracle.py``), which the bench
reads; the last two are imported by name, not from here."""

from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                         set_terminal_title,
                                         suppress_cv2_logging)
from vsc_tpu_torch.utils.frame_utils import (chunk_name, depth_name,
                                             extract_frame_number,
                                             frame_name, sbs_name)

__all__ = [
    "chunk_name",
    "depth_name",
    "ensure_utf8_console",
    "extract_frame_number",
    "frame_name",
    "sbs_name",
    "set_terminal_title",
    "suppress_cv2_logging",
]
