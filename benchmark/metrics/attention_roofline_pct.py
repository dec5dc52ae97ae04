"""Kernels: the qkv attention kernel's least time (frozen ``least_time``
on its shapes: per frame 24 launches over the 35 tiles' tokens and 24 over
the image's, at the model's widths) over its device time in the profiled
steps, in percent. Nothing when the profile holds no such launch, or a
count of launches that the model's shapes do not explain."""


def read(rec):
    tr = rec["trace"]
    if "flops_per_frame" not in rec or not tr["device"]:
        return None
    us, n = rec["trace_lib"].kernel_time_us(tr["device"],
                                            r"qkv_attention_kernel")
    enc = rec["config"]["model"]["encoder"]
    steps = tr["steps"]
    if not n or not steps or n != 2 * enc["depth"] * steps:
        return None
    B = rec["units_traced"] // steps
    T = (enc["img_size"] // enc["patch_size"]) ** 2 + 1
    D, H = enc["embed_dim"], enc["num_heads"]
    f = rec["flops"]
    per_step = enc["depth"] * (
        f.qkv_attention_bound(35 * B, T, D, H)["bound_ms"]
        + f.qkv_attention_bound(B, T, D, H)["bound_ms"])
    return 100.0 * per_step * steps / (us / 1e3)
