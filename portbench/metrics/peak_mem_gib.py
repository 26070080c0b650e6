"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window."""


def read(s: dict):
    if not s.get("peak_bytes"):
        return None
    return s["peak_bytes"] / 2**30
