"""The part of the save stall spent inside ``Snapshot.async_take`` calls
(staging the state, until the call returns), per take (host clock)."""


def read(run):
    w = run["window"]
    return w["take_call_s"] / w["takes"] * 1e3 if w["takes"] else None
