"""SBS layer: the planar-u8 path's least time per frame (frozen
``sbs_least_time`` at the cell's stereo parameters) times the frames, over
the SBS layer's event time, in percent."""


def read(rec):
    if not rec["units_free"] or not rec["sbs_ms_free"]:
        return None
    bound = rec["flops"].sbs_least_time(rec["H"], rec["W"], rec["params"])
    return 100.0 * bound["ms"] * rec["units_free"] / rec["sbs_ms_free"]
