"""Transfer layer: host milliseconds of the program's "transfer.copy_in"
spans (``parallel/auto.shard_batch``: the pinned staging copy and the
non-blocking enqueue) over the frames the same steps copied out."""

from lib import program_spans


def read(rec):
    sp = program_spans.spans()
    return sp and program_spans.host_ms_per_frame(sp, program_spans.COPY_IN)
