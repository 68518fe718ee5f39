"""The readings that a configuration's limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --controls 3 --out <file>

For each of ``--seeds`` seeds, the program's compared steps (set-up's own
path) against the plain reference: the lower readings. For each of
``--controls`` seeds, the reference put in the program's place in float8
(the control), and with half of each batch left out, the mean taken over
the rest (a fault): the upper readings. A state left unchanged reads 1 on
``change_gap`` by its definition and needs no run. One process, one card;
the benchmark's runs never run this. Prints one JSON line and writes it to
``--out``.
"""

import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from portbench import harness, judge  # noqa: E402

FIRST_SEED = 2_147_483_000


def readings(cell, seeds, controls, device, program=None):
    out = {"cell": cell["name"], "program": {}, "control_fp8": {}, "fault_half_batch": {}}
    for i in range(seeds):
        seed = FIRST_SEED + i
        run = harness.CellRun(cell, seed, device, program)
        prog = run.first_steps()
        run.free()
        out["program"][seed] = judge.step_numbers(prog, run.follow_reference())[0]
    for i in range(controls):
        seed = FIRST_SEED + 1000 + i
        run = harness.CellRun(cell, seed, device, program)
        run.batches = harness.make_batches(cell["traffic"], cell["config"]["port"]["vocab_size"],
                                           seed, device)
        ref = run.follow_reference()
        out["control_fp8"][seed] = judge.step_numbers(run.follow_reference("fp8"), ref)[0]
        half = slice(0, cell["traffic"]["batch"] // 2)
        out["fault_half_batch"][seed] = judge.step_numbers(run.follow_reference(rows=half), ref)[0]
    for kind in ("program", "control_fp8", "fault_half_batch"):
        per = out[kind].values()
        out[kind + "_max" if kind == "program" else kind + "_min"] = {
            k: (max if kind == "program" else min)(r[k] for r in per) for k in judge.STEP_NUMBERS}
    return out


def main(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.resolve(bench, a.workload)
    t0 = time.perf_counter()
    out = readings(cell, a.seeds, a.controls, torch.device("cuda", 0))
    out["seconds"] = time.perf_counter() - t0
    out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    with open(a.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
