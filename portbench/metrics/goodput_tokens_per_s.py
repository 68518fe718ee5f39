"""Tokens of completed train steps over the whole window, checkpoint
stalls inside it (host clock)."""


def read(run):
    w = run["window"]
    return w["steps"] * w["tokens_per_step"] / w["seconds"] if w["steps"] else None
