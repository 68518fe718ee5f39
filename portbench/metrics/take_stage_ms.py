"""Staging of a take (DtoH copies into the pinned pool, serialization): the
mean over the run's takes of the busy seconds of the ``stage_copy``
category of the port's critical-path attribution
(``telemetry/critpath.py``), in ms."""


def read(run):
    ops = run["telemetry"]["take"]
    if not ops or not any("stage_copy" in c for c in ops):
        return None
    return 1e3 * sum(c.get("stage_copy", 0.0) for c in ops) / len(ops)
