"""How long a resume's ``Snapshot.restore`` takes, until the state is on
the device and synchronised: the mean over the resumes made after the
window, each from the newest committed take into the live train state,
after one more train step has moved that state on (host clock)."""


def read(run):
    r = run["resumes"]
    return r["seconds"] / r["count"] if r["count"] else None
