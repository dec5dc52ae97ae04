"""Depth layer: DepthPro's operations (frozen ``depthpro_flops``) per frame
times the frames, over the depth layer's event time at the card's bf16
tensor peak (989 TFLOP/s), in percent."""


def read(rec):
    if "flops_per_frame" not in rec or not rec["depth_ms_free"]:
        return None
    peak = rec["flops"].PEAK_OPS_S["bf16_tensor"]
    work = rec["flops_per_frame"] * rec["units_free"]
    return 100.0 * work / (rec["depth_ms_free"] / 1e3 * peak)
