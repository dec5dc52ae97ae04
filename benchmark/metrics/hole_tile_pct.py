"""SBS layer: the postprocess kernel's tiles that ran the hole fill
(stages 2-5) over all its tiles in the profiled steps, in percent, from
the program's device counters ``postprocess.hole_tiles`` and
``postprocess.fast_tiles`` (the tiles that skipped it)."""

from lib import program_spans


def read(rec):
    c = program_spans.counters()
    if not c or "postprocess.hole_tiles" not in c:
        return None
    holes = c["postprocess.hole_tiles"]
    tiles = holes + c["postprocess.fast_tiles"]
    return 100.0 * holes / tiles if tiles else None
