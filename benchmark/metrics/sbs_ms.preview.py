"""SBS layer in the tester: device milliseconds between CUDA events around
the ``generate_sbs`` call inside each request, per request (the requests
outside the profiled stretch)."""


def read(rec):
    if not rec["sbs_calls_free"] or not rec["sbs_ms_free"]:
        return None
    return rec["sbs_ms_free"] / rec["sbs_calls_free"]
