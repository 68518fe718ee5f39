"""From the start of the process's first line to the window: imports, the
weights and batches made on the device, the compared and warm steps (which
build the kernels in a checkout's first run), and in a checkpointing cell
the staging pool, one take and one restore (host clock)."""


def read(run):
    return run["setup_s"]
