"""K1-K3, the port's attention kernels, against their roofline in the
traced segment, in percent: the sum over their launches of each launch's
least time, over the sum of their device times (torch.profiler).

A launch's least time is the larger of its bytes at the card's HBM rate
and its causal dots at the bf16 rate. Bytes: each operand (BH, S, d) read
once and each output written once, plus the f32 rows (lse, delta); dots:
2 * d FLOPs per attended pair each, 2 for the forward (q.k, p.v), 3 for
dq (q.k, dO.v, ds.k) and 4 for dk/dv (q.k, dO.v, p.dO, ds.q). Every
launch of a cell has its attention's shape: batch x heads, the sequence
and the head dim.
"""

# Kernel name stem -> (operands moved, f32 rows moved, dots).
KERNELS = {"flash_fwd": (4, 1, 2), "flash_bwd_dq": (5, 2, 3), "flash_bwd_dkv": (6, 2, 4)}
_ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_seconds(stem, bh, seq_len, d, element_bytes, peaks):
    operands, rows, dots = KERNELS[stem]
    nbytes = operands * bh * seq_len * d * element_bytes + rows * bh * seq_len * 4
    flops = dots * 2 * d * bh * (seq_len * (seq_len + 1) // 2)
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["bf16_flop_per_s"])


def stem_of(kernel_name):
    for stem in KERNELS:
        if stem + "_" in kernel_name:
            return stem
    return None


def read(run):
    t = run["trace"]
    if not t:
        return None
    port, tr = run["config"]["port"], run["traffic"]
    bh, d = tr["batch"] * port["n_heads"], port["d_model"] // port["n_heads"]
    least = spent = 0.0
    for name, (count, seconds) in t["kernels"].items():
        stem = stem_of(name)
        if stem is None:
            continue
        least += count * least_seconds(stem, bh, tr["seq_len"], d,
                                       _ELEMENT_BYTES[port["dtype"]], run["peaks"])
        spent += seconds
    return 100.0 * least / spent if spent > 0 else None
