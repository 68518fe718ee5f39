"""The port's command line against the JAX package's.

Each test takes the same numpy-seeded state with both packages and runs
the same argv through both ``main``s; exit code, stdout and stderr must
agree. The one deliberate difference of the text is the env prefix and the
module name in hints (``TORCHSNAPSHOT_GPU_``, ``torchsnapshot_tpu_torch``),
which ``torch_cli_env.both`` puts into the JAX text before comparing;
``lint`` is registered and refused (ROADMAP queue 3).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as J
import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import cli as jax_cli
from torchsnapshot_tpu import telemetry as jax_telemetry
from torchsnapshot_tpu_torch import cli, telemetry
from torchsnapshot_tpu_torch.telemetry import critpath
from torch_cli_env import both, jax_state, port_state, run_cli, state_arrays, take_both
from torch_test_env import autotune_never  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITERS = ["port", "jax"]


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """Plain, compressed and incremental snapshots of one state by each
    package."""
    root = str(tmp_path_factory.mktemp("cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCHSNAPSHOT_GPU_AUTOTUNE", "never")
        paths = {"plain": take_both(root + "/plain", record_digests=True),
                 "zlib": take_both(root + "/zlib", compression="zlib:1")}
        arrays = state_arrays(0)
        arrays["w"] = arrays["w"] + 1  # one leaf changes, the rest dedup
        inc = {"port": root + "/inc/port", "jax": root + "/inc/jax"}
        P.Snapshot.take(inc["port"], port_state(arrays), incremental_base=paths["plain"]["port"])
        J.Snapshot.take(inc["jax"], jax_state(arrays), incremental_base=paths["plain"]["jax"])
        paths["inc"] = inc
    return paths


def test_the_command_lists_agree() -> None:
    def commands(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return sorted(sub.choices)

    assert commands(cli.build_parser()) == commands(jax_cli.build_parser())
    assert cli.build_parser().prog == "python -m torchsnapshot_tpu_torch"


_INSPECT = [
    ["info"], ["ls"], ["ls", "--all"], ["ls", "--rank", "1"],
    ["verify"], ["verify", "-v"],
] + [["cat", leaf] for leaf in (
    "0/m/w", "0/m/bf", "0/m/h", "0/m/d", "0/m/i", "0/m/i8", "0/m/u8", "0/m/mask", "0/m/c",
    "0/m/s0", "0/m/step", "0/m/lr", "0/m/name", "0/m/opt/betas/1")] + [
    ["cat", "0/m/big"], ["cat", "0/m/big", "--limit", "8"], ["cat", "0/m/i", "--limit", "1000"],
    ["cat", "0/m/nope"], ["cat", "m/w"],
]


# cat reads the same leaves of every kind of snapshot: two suffice there.
_CASES = [(kind, argv) for kind in ("plain", "zlib", "inc") for argv in _INSPECT
          if kind == "plain" or argv[0] != "cat" or argv[1] in ("0/m/w", "0/m/bf")]


@pytest.mark.parametrize("kind,argv", _CASES,
                         ids=lambda a: "-".join(a).replace("/", ".") if isinstance(a, list) else a)
@pytest.mark.parametrize("writer", WRITERS)
def test_inspection_commands_agree(snaps, writer, kind, argv) -> None:
    jax_res, port_res = both([argv[0], snaps[kind][writer], *argv[1:]])
    assert port_res == jax_res
    if argv[:2] == ["cat", "0/m/bf"]:
        # bf16 prints as the JAX package's ml_dtypes array: ``%g``.
        assert port_res[1].splitlines()[0] == "bfloat16[12]"
        assert "[nan inf -0 0.100098 " in port_res[1]
    if argv[0] == "info" and kind == "inc":
        assert "referenced from base snapshot(s)" in port_res[1]
    if argv[0] == "info" and kind == "zlib":
        assert "compression: zlib" in port_res[1]


def test_a_missing_snapshot_is_exit_2(tmp_path) -> None:
    jax_res, port_res = both(["info", str(tmp_path / "absent")])
    assert port_res == jax_res and port_res[0] == 2 and port_res[2].startswith("error: ")


@pytest.mark.parametrize("writer", WRITERS)
def test_verify_finds_a_flipped_payload_byte(snaps, tmp_path, writer) -> None:
    snap = str(tmp_path / "s")
    shutil.copytree(snaps["plain"][writer], snap)
    meta = P.Snapshot(snap).metadata
    target = os.path.join(snap, meta.manifest["0/m/w"].chunks[0].array.location)
    blob = bytearray(open(target, "rb").read())
    blob[3] ^= 0x40
    open(target, "wb").write(bytes(blob))
    jax_res, port_res = both(["verify", snap])
    assert port_res == jax_res
    assert port_res[0] == 1 and "FAIL  0/m/w" in port_res[1] and ", 1 failed" in port_res[1]


def _take(pkg: str, path: str, arrays, **kw) -> None:
    if pkg == "port":
        P.Snapshot.take(path, port_state(arrays), **kw)
    else:
        J.Snapshot.take(path, jax_state(arrays), **kw)


@pytest.mark.parametrize("evidence", ["checksums", "digests", "device digests", "none"])
@pytest.mark.parametrize("writer", WRITERS)
def test_diff_classifies_alike(tmp_path, monkeypatch, writer, evidence) -> None:
    """An unchanged incremental, a changed leaf, an added and a removed
    leaf, by recorded content digests, else checksums, else structure
    only; a take with device digests (``xxh4x32:`` from K4's plain version
    here) records them beside the content digests."""
    kw = {}
    if evidence == "digests":
        kw["record_digests"] = True
    elif evidence == "device digests":
        kw["device_digests"] = True
        kw["record_digests"] = True
    elif evidence == "none":
        monkeypatch.setenv("TORCHSNAPSHOT_GPU_CHECKSUM", "0")
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_CHECKSUM", "0")
    arrays = state_arrays(1)
    a, same, changed = (str(tmp_path / n) for n in ("a", "same", "changed"))
    _take(writer, a, arrays, **kw)
    inc_kw = dict(kw, incremental_base=a) if evidence != "none" else kw
    _take(writer, same, arrays, **inc_kw)
    moved = dict(arrays)
    moved["w"] = moved["w"] * 2
    moved["new"] = np.ones(3, np.float32)
    del moved["i8"]
    _take(writer, changed, moved, **kw)
    if evidence == "device digests" and writer == "port":  # JAX's numpy leaves have none
        entry = P.Snapshot(a).metadata.manifest["0/m/w"].chunks[0].array
        assert entry.device_digest.startswith("xxh4x32:") and entry.digest.startswith("sha256:")
    for argv in (["diff", a, same], ["diff", a, same, "-v"], ["diff", a, changed],
                 ["diff", a, changed, "-v"]):
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    rc, out, _ = both(["diff", a, changed])[1]
    assert rc == 1 and "+ 0/m/new" in out and "- 0/m/i8" in out
    # With no checksum, equal structure cannot prove the change.
    assert ("~ 0/m/w  (float32[8, 16] (1 chunks))" in out) == (evidence != "none")
    rc, out, _ = both(["diff", a, same])[1]
    assert rc == 0
    assert ("indeterminate" in out) == (evidence == "none")


def test_diff_across_packages_matches_by_content(snaps) -> None:
    """The port's and the JAX package's takes of one state record the same
    digests and checksums, so each CLI finds every leaf unchanged."""
    argv = ["diff", snaps["plain"]["port"], snaps["plain"]["jax"], "-v"]
    jax_res, port_res = both(argv)
    assert port_res == jax_res
    assert port_res[0] == 0 and " 0 changed" in port_res[1] and "indeterminate" not in port_res[1]


def _chain(pkg: str, root: str) -> None:
    """step_0 <- step_1 and step_2 (incremental), step_3 standalone, in
    mtime order."""
    arrays = state_arrays(2)
    base = os.path.join(root, "step_0")
    _take(pkg, base, arrays, record_digests=True)
    for name in ("step_1", "step_2"):
        time.sleep(0.02)
        _take(pkg, os.path.join(root, name), arrays, incremental_base=base, record_digests=True)
    time.sleep(0.02)
    moved = dict(arrays)
    moved["w"] = moved["w"] - 1
    _take(pkg, os.path.join(root, "step_3"), moved)


@pytest.mark.parametrize("writer", WRITERS)
def test_deps_and_prune_agree(tmp_path, writer) -> None:
    root = str(tmp_path / "root")
    _chain(writer, root)
    # A tenants' shared pool and the history journal sit beside the steps.
    os.makedirs(os.path.join(root, ".tsnap_pool", "ab"))
    open(os.path.join(root, ".tsnap_pool", "ab", "cd"), "wb").close()
    jax_res, port_res = both(["deps", root])
    assert port_res == jax_res
    assert "step_0 [REQUIRED by step_1, step_2]" in port_res[1] and ".tsnap_pool" not in port_res[1]
    for argv in (["prune", root, "--keep", "2"], ["prune", root, "--keep", "0"],
                 ["prune", "s3://bucket/x", "--keep", "1"], ["deps", str(tmp_path / "none")]):
        if argv[0] == "deps":
            os.makedirs(argv[1])
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    # --yes, each CLI on its own copy of the root.
    results = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        copy = str(tmp_path / f"copy_{name}")
        shutil.copytree(root, copy)
        rc, out, err = run_cli(main, ["prune", copy, "--keep", "2", "--yes"])
        results.append((rc, out.replace(copy, "ROOT"), err))
        assert {"step_0", "step_2", "step_3"} <= set(os.listdir(copy))
        assert not os.path.exists(os.path.join(copy, "step_1"))
        assert os.path.exists(os.path.join(copy, ".tsnap_pool", "ab", "cd"))
    assert results[0] == results[1]
    assert "deleted 1 snapshot(s)" in results[1][1]


@pytest.mark.parametrize("writer", WRITERS)
def test_consolidate_agrees_and_stands_alone(snaps, tmp_path, writer) -> None:
    outs = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        dst = str(tmp_path / name)
        rc, out, err = run_cli(main, ["consolidate", snaps["inc"][writer], dst])
        outs.append((rc, out.replace(dst, "DST"), err))
        assert run_cli(cli.main, ["fsck", dst])[0] == 0
        assert "external:" not in run_cli(cli.main, ["info", dst])[1]
    assert outs[0] == outs[1] and outs[1][0] == 0
    arrays = state_arrays(0)
    arrays["w"] = arrays["w"] + 1
    dst = {"m": P.StateDict({k: torch.zeros_like(v) for k, v in port_state(arrays)["m"].items()
                             if isinstance(v, torch.Tensor)})}
    P.Snapshot(str(tmp_path / "port")).restore(dst)
    for k, v in port_state(arrays)["m"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(dst["m"][k].reshape(-1).view(torch.uint8),
                               v.reshape(-1).view(torch.uint8)), k


def test_plan_agrees_on_a_sharded_snapshot(tmp_path) -> None:
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    mesh = Mesh(np.array(jax.devices()), ("x",))
    vals = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    arr = jax.make_array_from_callback(vals.shape, NamedSharding(mesh, JP("x", None)),
                                       lambda i: vals[i])
    path = str(tmp_path / "snap")
    J.Snapshot.take(path, {"app": J.StateDict(w=arr, step=3)})
    layout = str(tmp_path / "dst.json")
    with open(layout, "w") as f:
        json.dump({"version": 1, "mesh": [["x", 4]],
                   "rules": [{"pattern": "app/w$", "spec": [[], ["x"]]}]}, f)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{")
    for argv in (["plan", path, layout, "--world", "4"],
                 ["plan", path, layout, "--world", "4", "--json"],
                 ["plan", path, layout, "--world", "4", "--min-requesters", "9"],
                 ["plan", path, bad, "--world", "4"]):
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    assert "4.0x reduction" in both(["plan", path, layout, "--world", "4"])[1][1]


@pytest.mark.parametrize("writer", WRITERS)
def test_plan_of_an_unsharded_snapshot_moves_nothing(snaps, tmp_path, writer) -> None:
    layout = str(tmp_path / "dst.json")
    with open(layout, "w") as f:
        json.dump({"version": 1, "mesh": [["x", 2]], "rules": []}, f)
    jax_res, port_res = both(["plan", snaps["plain"][writer], layout, "--world", "2"])
    assert port_res == jax_res
    assert "no sharded entries" in port_res[1]


@pytest.fixture()
def telemetry_snaps(tmp_path, monkeypatch):
    """Takes and restores of one state by each package with the bus on,
    under a root that also carries the history journal."""
    paths = {}
    for tel in (telemetry, jax_telemetry):
        tel.set_enabled(True)
        tel.reset()
    try:
        arrays = state_arrays(3)
        for pkg in WRITERS:
            paths[pkg] = str(tmp_path / pkg / "step_1")
            _take(pkg, paths[pkg], arrays)
    finally:
        for tel in (telemetry, jax_telemetry):
            tel.set_enabled(False)
            tel.reset()
    return paths


_STATS = [["stats"], ["stats", "--json"], ["stats", "-v"], ["stats", "--openmetrics"],
          ["explain"], ["explain", "--json"], ["explain", "-v"]]


@pytest.mark.parametrize("argv", _STATS, ids=lambda a: "-".join(a))
@pytest.mark.parametrize("writer", WRITERS)
def test_stats_and_explain_agree(telemetry_snaps, writer, argv) -> None:
    snap = telemetry_snaps[writer]
    jax_res, port_res = both([argv[0], snap, *argv[1:]])
    assert port_res == jax_res
    if argv == ["explain"]:
        with open(os.path.join(snap, critpath.ATTRIBUTION_FNAME)) as f:
            assert port_res[0] == critpath.binding_exit_code(json.load(f))
    if argv == ["stats", "--openmetrics"]:
        from prometheus_client.openmetrics import parser

        names = {f.name for f in parser.text_string_to_metric_families(port_res[1])}
        assert any(n.endswith("_bytes_written") for n in names)


@pytest.mark.parametrize("argv", [["stats"], ["explain"], ["stats", "--trend"],
                                  ["explain", "--profiles"]], ids=lambda a: "-".join(a))
def test_no_telemetry_is_exit_2_with_the_ports_hint(snaps, argv) -> None:
    jax_res, port_res = both([argv[0], snaps["plain"]["port"], *argv[1:]])
    assert port_res == jax_res and port_res[0] == 2
    if argv == ["stats"]:
        assert "TORCHSNAPSHOT_GPU_TELEMETRY=1" in port_res[2]


@pytest.mark.parametrize("walls", [[1.0] * 10, [1.0] * 8 + [1.8] * 5])
def test_stats_trend_agrees(tmp_path, walls) -> None:
    from torchsnapshot_tpu_torch.telemetry import history

    for i, wall in enumerate(walls):
        assert history.append_record(str(tmp_path), {
            "ts": time.time(), "op": "take", "snapshot": f"step_{i:010d}", "world_size": 1,
            "wall_s": wall, "write_gbps": 1.0 / wall})
    for argv in (["stats", str(tmp_path), "--trend"],
                 ["stats", str(tmp_path), "--trend", "--trend-metric", "write_gbps"],
                 ["stats", str(tmp_path), "--trend", "--trend-threshold", "0.1"]):
        jax_res, port_res = both(argv)
        assert port_res == jax_res, argv
    assert both(["stats", str(tmp_path), "--trend"])[1][0] == (1 if walls[-1] > 1 else 0)


def test_lint_is_registered_and_refused() -> None:
    rc, out, err = run_cli(cli.main, ["lint"])
    assert (rc, out) == (2, "")
    assert "not yet ported" in err
    # The JAX package's lint flags parse, and reach the same refusal.
    assert run_cli(cli.main, ["lint", "--json", "--rule", "R1", "--list-rules"])[:2] == (2, "")


def test_python_dash_m_runs_the_port_and_touches_no_device(snaps) -> None:
    """``python -m torchsnapshot_tpu_torch`` is the port's CLI; importing it
    and running the inspection commands leaves CUDA uninitialised."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    snap = snaps["plain"]["port"]
    proc = subprocess.run([sys.executable, "-m", "torchsnapshot_tpu_torch", "info", snap],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0
    assert proc.stdout == run_cli(cli.main, ["info", snap])[1]
    code = ("import sys, torch, torchsnapshot_tpu_torch.cli as c\n"
            f"snap = {snap!r}\n"
            "for argv in (['info', snap], ['ls', snap], ['cat', snap, '0/m/bf'],\n"
            "             ['verify', snap], ['fsck', snap], ['diff', snap, snap]):\n"
            "    assert c.main(argv) == 0, argv\n"
            "assert 'jax' not in sys.modules and 'torchsnapshot_tpu' not in sys.modules\n"
            "print('cuda initialized', torch.cuda.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "cuda initialized False"
