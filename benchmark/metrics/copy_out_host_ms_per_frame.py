"""Transfer layer: host milliseconds of the program's "transfer.copy_out"
spans (``parallel/auto.gather``'s copy to host memory, after the wait for
the queued work, which has a span of its own) per frame copied."""

from lib import program_spans


def read(rec):
    sp = program_spans.spans()
    return sp and program_spans.host_ms_per_frame(sp, program_spans.COPY_OUT)
