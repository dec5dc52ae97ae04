"""Transfer layer: device milliseconds of the host-to-device and
device-to-host copies per frame in the profiled steps."""


def read(rec):
    tr = rec["trace"]
    if not tr["device"] or not rec["units_traced"]:
        return None
    groups = rec["trace_lib"].by_group(tr["device"])
    us = groups.get("copy host to device", 0.0) + \
        groups.get("copy device to host", 0.0)
    if not us:
        return None
    return us / 1e3 / rec["units_traced"]
