"""Depth layer: device milliseconds per frame between CUDA events the
benchmark records around each ``depth_fn`` call (the steps outside the
profiled stretch)."""


def read(rec):
    if not rec["units_free"] or not rec["depth_ms_free"]:
        return None
    return rec["depth_ms_free"] / rec["units_free"]
