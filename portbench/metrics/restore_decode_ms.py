"""Decoding of a restore (verify, decode, HtoD into the live state): the
mean over the run's resumes of the busy seconds of the ``decode``
category of the port's critical-path attribution
(``telemetry/critpath.py``), in ms."""


def read(run):
    ops = run["telemetry"]["restore"]
    if not ops or not any("decode" in c for c in ops):
        return None
    return 1e3 * sum(c.get("decode", 0.0) for c in ops) / len(ops)
