"""setup_s: process start to the window's start: imports, CUDA init, the
kernel library (built by nvcc on a checkout's first run), the inputs,
the operator's build and plan, and the warm-up requests; host clock."""


def read(s: dict):
    return s.get("setup_s")
