"""Device: the share of the profiled steps' host window in which no kernel,
copy or memset ran on the card, in percent."""


def read(rec):
    tr = rec["trace"]
    if not tr["device"] or tr["window"] is None:
        return None
    w0, w1 = tr["window"]
    return 100.0 * (1.0 - rec["trace_lib"].busy_us(tr["device"]) / (w1 - w0))
