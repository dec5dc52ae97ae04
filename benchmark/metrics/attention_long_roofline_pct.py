"""Kernels: the long-token attention kernel's least time (frozen
``dav2.flash_attention_bound``: 4 B T^2 D operations at 989 TFLOP/s
against the q, k, v and output bytes at 3.35 TB/s, one launch a ViT block
over the step's batch) over its device time in the profiled steps, in
percent. Nothing when the profile holds no such launch, or any count but
one a block a step."""

from frozen import dav2


def read(rec):
    tr, info = rec["trace"], rec.get("attention_long")
    if info is None or not tr["device"]:
        return None
    us, n = rec["trace_lib"].kernel_time_us(tr["device"], dav2.FLASH_KERNEL)
    steps = tr["steps"]
    if not n or not steps or not us or n != info["launches"] * steps:
        return None
    return 100.0 * info["bound_ms"] * steps / (us / 1e3)
