"""Kernels on the SBS path: the sum of the hand-written kernels' stages of
frozen ``sbs_least_time`` (upsample, blur, warp, pools, pyramid,
postprocess, finish) per frame times the frames profiled, over those
kernels' device time in the profiled steps, in percent."""


def read(rec):
    tr = rec["trace"]
    lib = rec["trace_lib"]
    if not tr["device"] or not rec["units_traced"]:
        return None
    groups = lib.by_group(tr["device"])
    us = sum(groups.get(g, 0.0) for g in lib.SBS_KERNEL_GROUPS)
    if not us:
        return None
    f = rec["flops"]
    st = f.sbs_least_time(rec["H"], rec["W"], rec["params"])["stages"]
    per_frame = sum(v["ms"] for k, v in st.items()
                    if k in f.SBS_KERNEL_STAGES)
    return 100.0 * per_frame * rec["units_traced"] / (us / 1e3)
