"""Whole step: DepthPro's operations (frozen ``depthpro_flops``) per frame
times the frames converted, over the host seconds of those steps (copies
in, depth, SBS, copies out) at the card's bf16 tensor peak, in percent:
the whole step's share of the chip's peak."""


def read(rec):
    if "flops_per_frame" not in rec or not rec["host_s_free"]:
        return None
    peak = rec["flops"].PEAK_OPS_S["bf16_tensor"]
    work = rec["flops_per_frame"] * rec["units_free"]
    return 100.0 * work / (rec["host_s_free"] * peak)
