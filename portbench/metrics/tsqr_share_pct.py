"""tsqr_share_pct: the share of the traced requests' device time in ops
launched inside the port's `lt.tsqr` span (its batched QRs, their
cuSOLVER kernels, the recombining bmm), attributed by correlation id
(`portbench/spans.py`); nothing to read where the program has no spans."""

from portbench.spans import span_summary


def read(s: dict):
    spans = span_summary(s.get("events") or [])
    if spans is None or not spans["device_s"]:
        return None
    return 100.0 * spans["spans"].get("lt.tsqr", {}).get("device_s", 0.0) / spans["device_s"]
