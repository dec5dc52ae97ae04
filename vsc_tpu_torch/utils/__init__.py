"""Shared utilities of the port: frame numbering (``frame_utils.py``, a copy
of ``vsc_tpu/utils/frame_utils.py``)."""
