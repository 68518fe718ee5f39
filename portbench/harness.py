"""One run of one cell: set-up, the measured window, the check.

The cell names a configuration (``configs/<file>``: the published sizes,
the port's ``TransformerConfig`` under ``port``, the optimizer, and the
module of its block: initial parameters, leaf names, FLOPs per step and
the plain reference) and a traffic mix (``traffic/<name>.json``):

- ``batch``, ``seq_len``: the token batch of every step;
- ``take_every_steps`` (0: none): ``Snapshot.async_take`` of the whole
  train state after every that many steps, each after a ``wait()`` on the
  previous take;
- ``resumes`` (0: none): after the window, that many resumes, each one
  more train step and then ``Snapshot.restore`` of the newest committed
  take into the live state;
- ``trace_steps``: the steps of the traced segment of a ``--trace 1`` run;
- ``reference_rows``: batch rows the reference computes at a time (a
  matter of the card's memory at the mix's sizes).

Set-up makes the weights and ``POOL_BATCHES`` batches on the device from
the seed, runs the compared steps (``judge.COMPARE_STEPS``) and
``WARM_STEPS`` more through the window's own call and feed, and for a
checkpointing mix registers the staging pool and makes one take and one
resume. The window is a closed loop of train steps and takes for
``--seconds``; every checkpoint operation in it is timed between two
synchronisations, so that its time is its own. After the window the last
take is waited for, the resumes are made and timed, each checked byte for
byte, the device's peak is read, the program's state is freed, and the
reference follows the compared steps.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from portbench import devtrace, judge
from portbench.judge import norm

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "torchsnapshot_tpu")
BUCKET = "portbench"
# Distinct batches made from the seed and cycled, and the steps set-up
# runs after the compared ones: the same in every cell.
POOL_BATCHES = 64
WARM_STEPS = 2


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(bench: Dict, workload: str, root: str = ROOT) -> Dict:
    """The cell ``workload`` of ``bench`` with its files loaded: the
    configuration, its limits and reference, the traffic, and the
    metrics that a trace-0 and a trace-1 run report in it."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config_path = os.path.join(root, entry["file"])
    config = load_json(config_path)
    reference = load_module(os.path.join(os.path.dirname(config_path), config["reference"]),
                            "portbench_reference_" + cell["config"].replace("-", "_"))

    def reported(metrics: List[Dict]) -> List[Dict]:
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {
        "name": workload,
        "chips": cell["chips"],
        "config_name": cell["config"],
        "config": config,
        "reference": reference,
        "limits": load_json(os.path.join(PKG_DIR, "limits", cell["config"] + ".json")),
        "traffic": load_json(os.path.join(PKG_DIR, "traffic", cell["traffic"] + ".json")),
        "peaks": load_json(os.path.join(PKG_DIR, "peaks.json")),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
    }


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    return load_module(os.path.join(PKG_DIR, "metrics", name + ".py"),
                       "portbench_metric_" + name.replace(".", "_")).read


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(2 * seed + stream)


def make_params(cell: Dict, seed: int, device: torch.device) -> Dict:
    """The initial parameters of the cell's configuration, drawn on
    ``device`` from the seed by its module's ``make_params``."""
    return cell["reference"].make_params(cell["config"]["port"], _generator(device, seed, 0),
                                         device)


def make_batches(traffic: Dict, vocab: int, seed: int, device: torch.device) -> List[Dict]:
    """``POOL_BATCHES`` batches of uniform random tokens, targets the next
    token, drawn on ``device`` from the seed in one call."""
    g = _generator(device, seed, 1)
    B, S = traffic["batch"], traffic["seq_len"]
    seqs = torch.randint(0, vocab, (POOL_BATCHES, B, S + 1), generator=g, device=device)
    return [{"tokens": s[:, :-1].contiguous(), "targets": s[:, 1:].contiguous()} for s in seqs]


def tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a nest of dicts, tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensor_leaves(v)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


class CellRun:
    """The run of one cell with one seed on ``device``."""

    def __init__(self, cell: Dict, seed: int, device: torch.device, program=None) -> None:
        if program is None:
            from portbench import program
        self.prog = program
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell["traffic"]
        self.port = cell["config"]["port"]
        self.named_leaves = cell["reference"].named_leaves
        self.on_cuda = device.type == "cuda"
        self.losses: List[torch.Tensor] = []
        self.label = lambda name: contextlib.nullcontext()
        self.steps = self.takes = self.failed = 0
        self.ckpt_s = self.wait_s = self.call_s = 0.0
        self.bad_bytes = 0
        self.telemetry: Dict[str, List[Dict]] = {"take": [], "restore": []}
        self.op_seconds: Dict[str, List[float]] = {"take_wait": [], "take_call": [], "restore": []}
        self.tracing = False
        self.pending = None
        self.pending_n = 0
        self.snapshots: List[int] = []
        self.take_n = 0
        # The take whose state ``held`` keeps, and the newest committed one.
        self.held_n = self.newest = -1

    # ------------------------------------------------------------ clocks
    def sync(self) -> float:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ------------------------------------------------------------ set-up
    def first_steps(self) -> Dict:
        """Make the weights, the batches and the port's train step, and run
        the compared steps; returns the program's readings of them."""
        params = make_params(self.cell, self.seed, self.device)
        self.batches = make_batches(self.traffic, self.port["vocab_size"], self.seed, self.device)
        self.batch_i = 0
        self.state, opt = self.prog.train_state(params, self.cell["config"]["optimizer"]["lr"])
        self.step_fn = self.prog.make_step(self.port, opt)
        return self._compared_steps(judge.COMPARE_STEPS)

    def setup(self, tracing: bool) -> Dict:
        self.tracing = tracing
        self.prog.set_telemetry(tracing)
        readings = self.first_steps()
        for _ in range(WARM_STEPS):
            self.train_one()
        if self.traffic["take_every_steps"]:
            self._setup_checkpointing()
        self.losses.clear()
        self.sync()
        return readings

    def _compared_steps(self, n: int) -> Dict:
        b1 = self.cell["config"]["optimizer"]["b1"]
        start = {name: t.clone() for name, t in self.named_leaves(self.state["params"])}
        losses, grads = [], {}
        for i in range(n):
            losses.append(float(self.train_one()))
            if i == 0:
                grads = {name: norm(t) / (1 - b1)
                         for name, t in self.named_leaves(self.prog.first_moments(self.state))}
        change = {name: norm(t - start[name])
                  for name, t in self.named_leaves(self.state["params"])}
        del start
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def _setup_checkpointing(self) -> None:
        from portbench.store import MemoryS3Client

        self.store = MemoryS3Client()
        self.ckpt = self.prog.Checkpointer(self.state, self.store, BUCKET, f"s{self.seed}")
        self.held = [torch.empty_like(t) for t in tensor_leaves(self.state)]
        self.ckpt.warm_staging()
        # One take and one resume, as the window and the resumes make them.
        self._hold()
        self.held_n = 0
        self.ckpt.async_take(0).wait()
        self.snapshots, self.newest = [0], 0
        # The pool a second snapshot draws on, its pages touched now.
        self.store.reserve(self.store.sizes(BUCKET, f"s{self.seed}/0/"))
        self.train_one()
        self.ckpt.restore(0)
        self._check_restored()

    # ------------------------------------------------------------ the loop
    def train_one(self) -> torch.Tensor:
        batch = self.batches[self.batch_i % len(self.batches)]
        self.batch_i += 1
        with self.label("step"):
            self.state, loss = self.step_fn(self.state, batch)
        return loss

    def loop(self, seconds: Optional[float] = None, steps: Optional[int] = None) -> float:
        """Train for ``seconds`` or ``steps``; returns the wall seconds,
        from a synchronised start to a synchronised end."""
        every = self.traffic["take_every_steps"]
        t0 = self.sync()
        n = 0
        while (time.perf_counter() - t0 < seconds) if seconds is not None else n < steps:
            self.losses.append(self.train_one())
            n += 1
            self.steps += 1
            if every and self.steps % every == 0:
                self._checkpoint()
        return self.sync() - t0

    def _hold(self) -> None:
        """Copy the live state into the benchmark's own buffers: what the
        take about to start must hold."""
        with torch.no_grad():
            for dst, src in zip(self.held, tensor_leaves(self.state), strict=True):
                dst.copy_(src)

    def _check_restored(self) -> None:
        """Every byte of the live state against the state held at the
        take: the restore has to have put it back in place."""
        for held, live in zip(self.held, tensor_leaves(self.state), strict=True):
            self.bad_bytes += int((_bytes(held) != _bytes(live)).sum())

    def _wait(self) -> bool:
        try:
            self.pending.wait()
            return True
        except Exception:  # noqa: BLE001 - a failed take is counted, and the run goes on
            traceback.print_exc()
            self.failed += 1
            return False
        finally:
            self.pending = None

    def _drop_older(self, newest: int) -> None:
        for n in [s for s in self.snapshots if s < newest]:
            self.store.drop_prefix(BUCKET, f"s{self.seed}/{n}/")
            self.snapshots.remove(n)

    def _categories(self, kind: str) -> None:
        if self.tracing:
            cats = self.prog.last_categories()
            if cats is not None:
                self.telemetry[kind].append(cats)

    def _committed(self, n: int) -> None:
        self.newest = n
        self._drop_older(n)

    def _checkpoint(self) -> None:
        t0 = self.sync()
        if self.pending is not None:
            n = self.pending_n
            with self.label("wait"):
                ok = self._wait()
            self.op_seconds["take_wait"].append(time.perf_counter() - t0)
            self.wait_s += self.op_seconds["take_wait"][-1]
            if ok:
                self._categories("take")
                self._committed(n)
        with self.label("hold"):
            self._hold()
        ts = self.sync()
        self.take_n += 1
        self.held_n = self.take_n
        with self.label("take"):
            try:
                self.pending, self.pending_n = self.ckpt.async_take(self.take_n), self.take_n
                self.snapshots.append(self.take_n)
            except Exception:  # noqa: BLE001 - a failed take is counted, and the run goes on
                traceback.print_exc()
                self.failed += 1
        self.op_seconds["take_call"].append(time.perf_counter() - ts)
        self.call_s += self.op_seconds["take_call"][-1]
        self.takes += 1
        self.ckpt_s += self.sync() - t0

    def resume(self, count: int) -> Tuple[int, float]:
        """``count`` resumes from the newest committed take, each one more
        train step (the job ran on past its checkpoint) and then a restore
        into the live state, timed until the state is on the device, and
        checked byte for byte. Returns the resumes made and their seconds."""
        if self.newest < 0 or self.newest != self.held_n:
            return 0, 0.0  # the newest take failed, which is counted already
        seconds = 0.0
        for _ in range(count):
            self.train_one()
            tr = self.sync()
            try:
                self.ckpt.restore(self.newest)
            except Exception:  # noqa: BLE001 - a failed restore is counted, and the run goes on
                traceback.print_exc()
                self.failed += 1
                continue
            finally:
                self.op_seconds["restore"].append(self.sync() - tr)
                seconds += self.op_seconds["restore"][-1]
            self._categories("restore")
            self._check_restored()
        return count, seconds

    # ------------------------------------------------------------ trace
    def traced_segment(self, steps: int) -> Dict:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.on_cuda:
            activities.append(ProfilerActivity.CUDA)
        self.label = lambda name: record_function(devtrace.LABEL_PREFIX + name)
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            with profile(activities=activities) as prof:
                with record_function(devtrace.SEGMENT):
                    self.loop(steps=steps)
            prof.export_chrome_trace(path)
            return devtrace.reduce(devtrace.load(path))
        finally:
            self.label = lambda name: contextlib.nullcontext()
            os.remove(path)

    # ------------------------------------------------------------ after
    def settle(self) -> None:
        """Wait for the take still in flight: late, not wrong."""
        if self.pending is not None:
            n = self.pending_n
            if self._wait():
                self._committed(n)

    def free(self) -> None:
        for attr in ("state", "step_fn", "ckpt", "held", "store", "pending"):
            if hasattr(self, attr):
                delattr(self, attr)
        self.losses = [torch.stack(self.losses).float().cpu()] if self.losses else []
        gc.collect()
        if self.on_cuda:
            torch.cuda.empty_cache()

    def follow_reference(self, precision: str = "f32", rows: Optional[slice] = None) -> Dict:
        """The plain reference over the compared steps, from the initial
        parameters made again from the seed."""
        params0 = make_params(self.cell, self.seed, self.device)
        batches = self.batches[: judge.COMPARE_STEPS]
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        out = self.cell["reference"].follow(params0, batches, self.cell["config"],
                                           self.traffic["reference_rows"], precision)
        del params0
        return out

    def nonfinite(self) -> int:
        return int((~torch.isfinite(self.losses[0])).sum()) if self.losses else 0


def _device_ok(chips: int) -> Optional[str]:
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: this benchmark runs only on a CUDA card"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and {torch.cuda.device_count()} are visible"
    return None


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device: torch.device,
             started: float, program=None) -> Tuple[Dict, Dict]:
    """Run the cell. Returns the result line's object (without the import
    check, which :func:`main` makes) and notes for standard error: the
    numbers not compared, each checkpoint operation's seconds, the metrics
    that found nothing to read, and in an untraced run the per-layer
    metrics that read the host clock alone."""
    run = CellRun(cell, seed, device, program)
    readings = run.setup(tracing=trace)
    setup_s = time.perf_counter() - started
    window_s = run.loop(seconds=seconds)
    tr = run.traffic
    window = {"seconds": window_s, "steps": run.steps, "takes": run.takes,
              "stall_s": run.wait_s + run.call_s, "take_wait_s": run.wait_s,
              "take_call_s": run.call_s, "ckpt_s": run.ckpt_s,
              "tokens_per_step": tr["batch"] * tr["seq_len"]}
    reduced = run.traced_segment(tr["trace_steps"]) if trace else None
    run.settle()
    resumes, resume_s = run.resume(tr["resumes"]) if tr["take_every_steps"] else (0, 0.0)
    if run.on_cuda:
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    attempted = run.steps + run.takes + resumes
    run.free()
    ref = run.follow_reference()
    numbers, left_out = judge.step_numbers(readings, ref)
    numbers["nonfinite_losses"] = run.nonfinite()
    numbers["failed_ops"] = run.failed
    if tr["take_every_steps"]:
        numbers["restore_bad_bytes"] = run.bad_bytes
    table = judge.checks(numbers, cell["limits"])
    record = {"cell": cell["name"], "config": cell["config"], "traffic": tr,
              "peaks": cell["peaks"], "setup_s": setup_s, "window": window,
              "resumes": {"count": resumes, "seconds": resume_s},
              "flops_per_step": cell["reference"].model_flops_per_step(
                  cell["config"]["port"], tr["batch"], tr["seq_len"]),
              "telemetry": run.telemetry, "trace": reduced}
    metrics = {}
    missing = []
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = metric_reader(m["name"])(record)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    untraced = {} if trace else {
        m["name"]: metric_reader(m["name"])(record) for m in cell["per_layer"]
        if m["source"] == "host_clock"}
    device_info = {"platform": "gpu" if run.on_cuda else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": judge.passed(table), "attempted": attempted,
           "failed": run.failed + numbers["nonfinite_losses"], "metrics": metrics,
           "device": device_info}
    if reduced is not None:
        device_info["busy_s"] = reduced["busy_s"]
        device_info["window_s"] = reduced["window_s"]
        out["breakdown"] = devtrace.breakdown(reduced)
    out["checks"] = table
    notes = {"not_compared": {k: v for k, v in numbers.items() if k not in table},
             "op_seconds": run.op_seconds, "missing": missing, "leaves_left_out": left_out,
             "untraced": {k: v for k, v in untraced.items() if v is not None}}
    return out, notes


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], started: float) -> int:
    args = parse_args(argv)
    cell = resolve(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    problem = _device_ok(cell["chips"])
    if problem:
        print(f"portbench: {problem}", file=sys.stderr)
        return 2
    out, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), started)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("op_seconds " + json.dumps(notes["op_seconds"]), file=sys.stderr)
    print(f"leaves left out of change_gap: {notes['leaves_left_out']}", file=sys.stderr)
    for name, value in notes["not_compared"].items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, value in notes["untraced"].items():
        print(f"reading {name} {value!r} (per-layer, tracing off)", file=sys.stderr)
    if notes["missing"]:
        print(f"portbench: no reading for {', '.join(notes['missing'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
