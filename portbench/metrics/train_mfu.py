"""The train step's share of the card's bf16 peak, in percent: the model's
FLOPs per step times the steps of the window, over the window's wall less
the time its checkpoint operations held the loop, times the peak (host
clock, the same window as the end-to-end metrics).

The FLOPs per step are the configuration's own count
(``model_flops_per_step`` of the module its file names, the published
model's matrix work), which the harness puts in the run's record.
"""


def read(run):
    w = run["window"]
    busy = w["seconds"] - w["ckpt_s"]
    if not w["steps"] or busy <= 0:
        return None
    return 100.0 * run["flops_per_step"] * w["steps"] / (busy * run["peaks"]["bf16_flop_per_s"])
