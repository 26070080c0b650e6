"""solve_ms: the window's length over the requests completed in it (the
window ends when the last request begun inside it returns), host clock."""


def read(s: dict):
    if not s.get("completed"):
        return None
    return s["window_s"] / s["completed"] * 1e3
