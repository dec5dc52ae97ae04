"""Depth layer: CUDA-event milliseconds of the program's "depth.decoder"
spans (DepthPro's multires decoder and depth head) per frame copied out
in the same steps."""

from lib import program_spans


def read(rec):
    sp = program_spans.spans()
    return sp and program_spans.device_ms_per_frame(sp, "depth.decoder")
