"""library_share_pct: the share of device time in ops that are not the
port's own kernels: cuBLAS, cuSOLVER, torch's kernels, copies and sets."""


def read(s: dict):
    total = s.get("own_s", 0.0) + s.get("library_s", 0.0)
    if not total:
        return None
    return 100.0 * s["library_s"] / total
