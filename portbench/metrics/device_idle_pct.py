"""device_idle_pct: the share of the traced requests' wall time in which
no kernel, copy or set ran on the device, both from the one trace."""


def read(s: dict):
    if not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
