"""Storage writes of a take (through the S3 plugin into the store): the
mean over the run's takes of the busy seconds of the ``storage_write``
category of the port's critical-path attribution
(``telemetry/critpath.py``), in ms."""


def read(run):
    ops = run["telemetry"]["take"]
    if not ops or not any("storage_write" in c for c in ops):
        return None
    return 1e3 * sum(c.get("storage_write", 0.0) for c in ops) / len(ops)
