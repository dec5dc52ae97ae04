"""SBS layer: device milliseconds per frame between CUDA events around each
``generate_sbs`` call (the steps outside the profiled stretch)."""


def read(rec):
    if not rec["units_free"] or not rec["sbs_ms_free"]:
        return None
    return rec["sbs_ms_free"] / rec["units_free"]
