"""roofline_pct: the traced requests' least time on the card (the larger
of their least bytes over the bandwidth and their operations over the
peak, `counts/` and `peaks.json`) over their device busy time."""


def read(s: dict):
    if not s.get("least_s") or not s.get("busy_s"):
        return None
    return 100.0 * s["least_s"] / s["busy_s"]
