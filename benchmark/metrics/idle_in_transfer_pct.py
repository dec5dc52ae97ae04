"""Device: the share of the profiled steps' window in which no kernel,
copy or memset runs on the card while the program's copy in or copy out
span is open, in percent (a part of ``device_idle_pct``). The spans are
put on the profiler's clock by their marks in the trace's host events."""

from lib import program_spans


def read(rec):
    sp = program_spans.spans()
    return sp and program_spans.idle_in_transfer_pct(sp, rec["trace"])
