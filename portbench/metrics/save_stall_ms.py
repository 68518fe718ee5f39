"""All the time the training loop was blocked by checkpointing in the
window (each ``async_take`` call until it returned, and each ``wait()`` on
the previous take before the next one), over the takes (host clock)."""


def read(run):
    w = run["window"]
    return w["stall_s"] / w["takes"] * 1e3 if w["takes"] else None
