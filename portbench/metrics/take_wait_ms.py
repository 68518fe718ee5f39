"""The part of the save stall spent in ``wait()`` on the previous take
before the next one (its writes and commit not done within the interval),
per take (host clock)."""


def read(run):
    w = run["window"]
    return w["take_wait_s"] / w["takes"] * 1e3 if w["takes"] else None
