"""The port's lazy page-in restore (``pagein.py``): the counterparts of
``tests/test_pagein.py`` case for case, on torch state, a paged-in port
restore held against the JAX package's eager restore of the same
snapshot, and a Stateful that cannot hold a proxy restored eagerly.

In-process: default-off semantics, hot-set grammar, futures resolving
bit-exact under concurrent demand faults, learned first-touch replay as
prefetch order, admission interaction, abort leaving partial state
unreferencable. Chaos drills: SIGKILL mid-page-in leaves every committed
snapshot restorable and fsck-clean; a corrupt background read is
CRC-rejected and the leaf re-read direct, bit-exact. Multiprocess (w2):
env skew (one rank lazy, one not) degrades to eager everywhere via the
one election gather; both-ranks-lazy serves the hot set before the last
byte.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject, pagein
from torchsnapshot_tpu_torch.layout import Rule
from torchsnapshot_tpu_torch.test_utils import run_with_subprocesses
from torch_test_env import autotune_never  # noqa: F401 - autouse


def run_fsck(path):
    from torchsnapshot_tpu.cli import run_fsck as jax_fsck

    return jax_fsck(path)

LEAVES = ("emb", "w1", "w2", "w3")


def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        emb=rng.standard_normal((64, 32)).astype(np.float32),
        w1=rng.standard_normal((48, 16)).astype(np.float32),
        w2=rng.standard_normal((40, 20)).astype(np.float32),
        w3=rng.standard_normal((30, 30)).astype(np.float32),
        step=np.array([seed], dtype=np.int64),
    )


def _state(seed: int) -> dict:
    return {"model": StateDict(**{k: torch.from_numpy(v) for k, v in _arrays(seed).items()})}


def _zeros_like(state: dict) -> dict:
    return {"model": StateDict(**{k: torch.zeros_like(v) for k, v in state["model"].items()})}


def _value(leaf):
    """A restored leaf's value: under lazy restore a deferred leaf is a
    LeafFuture proxy; result() demand-faults and returns the value."""
    if isinstance(leaf, pagein.LeafFuture):
        return leaf.result(timeout=120)
    return leaf


def _equal(restored: dict, expected: dict) -> bool:
    return all(
        np.array_equal(
            np.asarray(_value(restored["model"][k])),
            np.asarray(expected["model"][k]),
        )
        for k in expected["model"]
    )


# ------------------------------------------------------------ default off


def test_default_off_returns_none(tmp_path):
    """No env: restore is eager (one env check), returns None, and a
    hot= declaration alone does not engage lazy mode."""
    assert os.environ.get("TORCHSNAPSHOT_GPU_LAZY_RESTORE") is None
    state = _state(0)
    Snapshot.take(str(tmp_path / "snap"), state)
    dst = _zeros_like(state)
    sess = Snapshot(str(tmp_path / "snap")).restore(dst, hot=["model/emb"])
    assert sess is None
    assert _equal(dst, state)
    assert not any(
        isinstance(v, pagein.LeafFuture) for v in dst["model"].values()
    )


def test_auto_without_hot_or_learned_stays_eager(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "auto")
    state = _state(1)
    Snapshot.take(str(tmp_path / "snap"), state)
    dst = _zeros_like(state)
    assert Snapshot(str(tmp_path / "snap")).restore(dst) is None
    assert _equal(dst, state)


# ------------------------------------------------------- hot-set grammar


def test_hot_set_rule_matching(monkeypatch):
    """hot= accepts regex strings and layout.Rule objects (re.search,
    first match wins); env patterns append; duplicates collapse."""
    rules = pagein.compile_hot_set(
        ["model/emb", Rule.of(r"^model/w1$", ()), "model/emb"],
        include_env=False,
    )
    assert [r.pattern for r in rules] == ["model/emb", r"^model/w1$"]
    hs = pagein.HotSet(rules)
    assert hs.matches("model/emb")
    assert hs.matches("model/emb_table")  # re.search, unanchored
    assert hs.matches("model/w1")
    assert not hs.matches("model/w10")  # anchored rule
    assert not hs.matches("model/w2")

    monkeypatch.setenv("TORCHSNAPSHOT_GPU_HOT_SET", "model/w2;model/emb")
    rules = pagein.compile_hot_set(["model/emb"])
    assert [r.pattern for r in rules] == ["model/emb", "model/w2"]

    # The vote signature keys engagement: same rules, same token;
    # different rules, different token (ranks must defer identically).
    a = pagein.HotSet(pagein.compile_hot_set(["x"], include_env=False))
    b = pagein.HotSet(pagein.compile_hot_set(["x"], include_env=False))
    c = pagein.HotSet(pagein.compile_hot_set(["y"], include_env=False))
    assert a.signature() == b.signature() != c.signature()
    assert pagein.vote_token(True, a) == f"lazy:{a.signature()}"
    assert pagein.vote_token(False, a) == ""

    with pytest.raises(Exception):
        pagein.compile_hot_set(["[invalid"], include_env=False)


# ------------------------------------------- futures under concurrent faults


def test_futures_bitexact_under_concurrent_faults(tmp_path, monkeypatch):
    """Threads demand-faulting deferred leaves while the background
    prefetch walks the same units: every future resolves bit-exact,
    residency reaches 1.0, and nothing is torn."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    state = _state(2)
    Snapshot.take(str(tmp_path / "snap"), state)
    dst = _zeros_like(state)
    sess = Snapshot(str(tmp_path / "snap")).restore(dst, hot=["model/emb"])
    assert sess is not None
    assert np.array_equal(dst["model"]["emb"], state["model"]["emb"])
    assert sess.resident_fraction() < 1.0

    errors = []

    def hammer(path):
        try:
            sess.leaf(path).result(timeout=120)
        except BaseException as e:  # noqa: B036
            errors.append((path, e))

    threads = [
        threading.Thread(target=hammer, args=(f"model/{name}",))
        for name in ("w1", "w2", "w3")
        for _ in range(3)  # several threads per leaf: racing faults
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    sess.wait(timeout=120)
    assert _equal(dst, state)
    assert sess.resident_fraction() == 1.0
    assert sess.pending_paths() == []


# -------------------------------------------------- learned-order replay


def test_prefetch_order_replay(tmp_path, monkeypatch):
    """First-touch order recorded by one lazy restore replays as the
    next restore's prefetch order (via the history journal), and auto
    mode engages on the learned order alone."""
    snap = str(tmp_path / "snap")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH", "0")
    state = _state(3)
    Snapshot.take(snap, state)
    dst = _zeros_like(state)
    sess = Snapshot(snap).restore(dst, hot=["model/emb"])
    assert sess is not None
    touch_order = ["model/w3", "model/step", "model/w1", "model/w2"]
    for path in touch_order:
        sess.fault(path, timeout=120)
    sess.wait(timeout=120)
    assert _equal(dst, state)

    assert pagein.learned_order(snap) == touch_order

    # Second restore: auto + no hot rules — the learned order alone
    # engages lazy mode and leads the prefetch order.
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "auto")
    dst2 = _zeros_like(state)
    sess2 = Snapshot(snap).restore(dst2)
    assert sess2 is not None
    assert sess2.prefetch_order()[:4] == touch_order
    sess2.wait(timeout=120)
    assert _equal(dst2, state)


# ------------------------------------------------- admission interaction


def test_admission_share_interaction(tmp_path, monkeypatch):
    """With a tenant ambient and admission on, the page-in engine arms
    its own admission session (the restore's was disarmed at return)
    and still drains bit-exact."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_TENANT", "acme")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_ADMISSION", "1")
    state = _state(4)
    Snapshot.take(str(tmp_path / "snap"), state)
    dst = _zeros_like(state)
    sess = Snapshot(str(tmp_path / "snap")).restore(dst, hot=["model/emb"])
    assert sess is not None
    sess.fault("model/w1", timeout=120)
    sess.wait(timeout=120)
    assert _equal(dst, state)


# ------------------------------------------------------------------ abort


def test_abort_leaves_partial_state_unreferencable(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH", "0")
    state = _state(5)
    Snapshot.take(str(tmp_path / "snap"), state)
    dst = _zeros_like(state)
    sess = Snapshot(str(tmp_path / "snap")).restore(dst, hot=["model/emb"])
    assert sess is not None
    pending = sess.pending_paths()
    assert pending
    sess.abort()
    for path in pending:
        with pytest.raises(pagein.PageInAborted):
            sess.leaf(path).result(timeout=5)
    # The hot set stays valid — it was resident before the abort.
    assert np.array_equal(dst["model"]["emb"], state["model"]["emb"])


# ------------------------------------------------------------ chaos drills

_KILL_CHILD = r"""
import os, sys
os.environ["TORCHSNAPSHOT_GPU_LAZY_RESTORE"] = "always"
import numpy as np
import torch
from torchsnapshot_tpu_torch import Snapshot, StateDict, faultinject

root = sys.argv[1]

def state(seed):
    rng = np.random.default_rng(seed)
    return {"model": StateDict(
        emb=torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
        w1=torch.from_numpy(rng.standard_normal((48, 16)).astype(np.float32)),
        w2=torch.from_numpy(rng.standard_normal((40, 20)).astype(np.float32)),
        w3=torch.from_numpy(rng.standard_normal((30, 30)).astype(np.float32)),
        step=torch.tensor([seed], dtype=torch.int64),
    )}

Snapshot.take(os.path.join(root, "prev"), state(0))
Snapshot.take(os.path.join(root, "cur"), state(1))
dst = {"model": StateDict(**{
    k: torch.zeros_like(v) for k, v in state(1)["model"].items()
})}
faultinject.configure("pagein.prefetch@1=kill")
sess = Snapshot(os.path.join(root, "cur")).restore(dst, hot=["model/emb"])
assert sess is not None
sess.wait(timeout=120)  # the first background batch SIGKILLs us here
print("SURVIVED")  # only reachable if the plan never fired
"""


def test_chaos_sigkill_mid_pagein(tmp_path):
    """SIGKILL while pages are in flight: restores never write into the
    snapshot, so every committed snapshot stays restorable and
    fsck-clean — the serving replica died, nothing else happened."""
    r = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, str(tmp_path)],
        capture_output=True,
        text=True,
        timeout=150,
    )
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert "SURVIVED" not in r.stdout
    state0 = _state(0)
    dst = _zeros_like(state0)
    assert Snapshot(str(tmp_path / "prev")).restore(dst) is None
    assert _equal(dst, state0)
    assert run_fsck(str(tmp_path / "prev"))[0] == 0
    assert run_fsck(str(tmp_path / "cur"))[0] == 0


def test_chaos_corrupt_background_read_degrades_direct(tmp_path, monkeypatch):
    """A corrupted background fault read is CRC-rejected; the engine
    re-reads the leaf with a blocking direct read — the accessor gets
    the bit-exact value, never a torn or stale one."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_CHECKSUM", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_VERIFY", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_STREAM_READS", "never")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH", "0")
    state = _state(6)
    Snapshot.take(str(tmp_path / "snap"), state)
    dst = _zeros_like(state)
    sess = Snapshot(str(tmp_path / "snap")).restore(dst, hot=["model/emb"])
    assert sess is not None
    try:
        # Armed AFTER restore returned: with prefetch off, the next
        # fs.read is the engine's background read for the fault below.
        faultinject.configure("fs.read@1=corrupt;seed=5")
        v = sess.leaf("model/w1").result(timeout=120)
        assert np.array_equal(np.asarray(v), state["model"]["w1"])
        # The corrupt read fired AND a clean re-read followed it.
        assert faultinject.hits().get("fs.read", 0) >= 2
    finally:
        faultinject.disable()
    sess.wait(timeout=120)
    assert _equal(dst, state)
    assert run_fsck(str(tmp_path / "snap"))[0] == 0


# --------------------------------------------------------- multiprocess


def _skew_worker(rank, world_size, root):
    """Env skew: rank 0 votes always, rank 1 never. The unanimity check
    on the (one) election gather fails; every rank restores eagerly —
    no session, no futures, no hang, bit-exact."""
    os.environ["TORCHSNAPSHOT_GPU_LAZY_RESTORE"] = "always" if rank == 0 else "never"
    os.environ["TORCHSNAPSHOT_GPU_COOP_RESTORE"] = "never"
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.pagein import LeafFuture

    g = torch.Generator().manual_seed(10 + rank)
    state = {"model": StateDict(w=torch.randn((64, 32), generator=g),
                                b=torch.randn(100, generator=g, dtype=torch.float64))}
    Snapshot.take(root, state)
    dst = {"model": StateDict(w=torch.zeros((64, 32)), b=torch.zeros(100, dtype=torch.float64))}
    sess = Snapshot(root).restore(dst)
    assert all(not isinstance(v, LeafFuture) for v in dst["model"].values())
    return {"session": sess is not None,
            "bitexact": all(torch.equal(dst["model"][k], state["model"][k]) for k in state["model"])}


@pytest.mark.multiprocess
def test_env_skew_degrades_to_eager_everywhere(tmp_path):
    results = run_with_subprocesses(_skew_worker, 2, str(tmp_path / "snap"), timeout=180.0)
    for rank, r in results.items():
        assert r["session"] is False, (rank, results)
        assert r["bitexact"], (rank, results)


def _ttfi_worker(rank, world_size, root):
    """Both ranks lazy with the same env hot set: restore returns with
    the hot leaf servable while deferred bytes are still unread (first
    inference before the last byte), then drains bit-exact."""
    os.environ["TORCHSNAPSHOT_GPU_LAZY_RESTORE"] = "always"
    os.environ["TORCHSNAPSHOT_GPU_HOT_SET"] = "model/emb"
    # Demand-only paging makes "bytes still unread at return" exact.
    os.environ["TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH"] = "0"
    import torch

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.pagein import LeafFuture

    g = torch.Generator().manual_seed(20 + rank)
    state = {"model": StateDict(emb=torch.randn((64, 32), generator=g),
                                w1=torch.randn((48, 16), generator=g),
                                w2=torch.randn((40, 20), generator=g))}
    Snapshot.take(root, state)
    dst = {"model": StateDict(emb=torch.zeros((64, 32)), w1=torch.zeros((48, 16)),
                              w2=torch.zeros((40, 20)))}
    sess = Snapshot(root).restore(dst)
    assert sess is not None
    hot_exact = torch.equal(dst["model"]["emb"], state["model"]["emb"])
    resident_at_return = sess.resident_fraction()
    sess.wait(timeout=120)

    def value(leaf):
        return leaf.result(timeout=120) if isinstance(leaf, LeafFuture) else leaf

    tail_exact = all(torch.equal(value(dst["model"][k]), state["model"][k]) for k in ("w1", "w2"))
    return {"hot_exact": hot_exact, "resident_at_return": resident_at_return,
            "tail_exact": tail_exact, "final_resident": sess.resident_fraction()}


@pytest.mark.multiprocess
def test_w2_first_inference_before_last_byte(tmp_path):
    results = run_with_subprocesses(_ttfi_worker, 2, str(tmp_path / "snap"), timeout=180.0)
    for rank, r in results.items():
        assert r["hot_exact"], (rank, results)
        assert r["resident_at_return"] < 1.0, (rank, results)
        assert r["tail_exact"], (rank, results)
        assert r["final_resident"] == 1.0, (rank, results)


# ------------------------------------------------------ torch and the JAX package


def test_paged_in_port_restore_equals_the_jax_eager_restore(tmp_path, monkeypatch):
    """A snapshot taken by the JAX package, restored lazily by the port and
    drained, equals the JAX package's own eager restore of it, leaf for
    leaf, bit-exact."""
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    arrays = _arrays(11)
    snap = str(tmp_path / "snap")
    J.Snapshot.take(snap, {"model": J.StateDict(**{k: jnp.asarray(v) for k, v in arrays.items()})})
    jdst = {"model": J.StateDict(**{k: jnp.zeros_like(jnp.asarray(v)) for k, v in arrays.items()})}
    J.Snapshot(snap).restore(jdst)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    dst = {"model": StateDict(**{k: torch.zeros_like(torch.from_numpy(v))
                                  for k, v in arrays.items()})}
    sess = Snapshot(snap).restore(dst, hot=["model/emb"])
    assert sess is not None and isinstance(dst["model"]["w2"], pagein.LeafFuture)
    sess.wait(timeout=120)
    for k in arrays:
        assert np.array_equal(_value(dst["model"][k]).numpy(), np.asarray(jdst["model"][k])), k


class _Module:
    """A Stateful whose load_state_dict copies every value into its own
    tensors at once, as ``nn.Module.load_state_dict`` does: it cannot
    hold a LeafFuture."""

    def __init__(self, arrays):
        self.params = {k: torch.zeros_like(torch.from_numpy(v)) for k, v in arrays.items()}

    def state_dict(self):
        return dict(self.params)

    def load_state_dict(self, sd):
        for k, v in sd.items():
            assert isinstance(v, torch.Tensor), (k, type(v))
            self.params[k].copy_(v)


def test_a_stateful_that_cannot_hold_a_proxy_restores_eagerly(tmp_path, monkeypatch):
    """The deliberate difference: only a StateDict's leaves defer. A
    module-like Stateful in the same lazy restore gets every leaf before
    the restore returns, so none is ever read stale."""
    arrays = _arrays(12)
    snap = str(tmp_path / "snap")
    Snapshot.take(snap, {"model": StateDict(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                         "mod": StateDict(**{k: torch.from_numpy(v) for k, v in arrays.items()})})
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PAGEIN_PREFETCH", "0")
    mod = _Module(arrays)
    dst = {"model": StateDict(**{k: torch.zeros_like(torch.from_numpy(v))
                                  for k, v in arrays.items()}), "mod": mod}
    sess = Snapshot(snap).restore(dst, hot=["model/emb"])
    assert sess is not None
    assert sess.pending_paths() == ["model/step", "model/w1", "model/w2", "model/w3"]
    for k, v in arrays.items():
        assert np.array_equal(mod.params[k].numpy(), v), k
    sess.wait(timeout=120)


def test_committed_journal_epochs_stand_lazy_mode_down(tmp_path, monkeypatch):
    """A page landing after the journal's replay would roll a leaf back, so
    with committed epochs the restore is eager (as in JAX), and the replayed
    values are what it returns."""
    from torchsnapshot_tpu_torch import journal

    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    state = _state(13)
    step_dir = str(tmp_path / "step_0000000001")
    Snapshot.take(step_dir, state)
    j = journal.DeltaJournal(step_dir, base_step=1, rank=0)
    j.capture_baseline(state)
    state["model"]["w1"] = state["model"]["w1"] + 1.0
    assert j.append_epoch(state) > 0
    assert pagein.journal_blocks_lazy(step_dir)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_LAZY_RESTORE", "always")
    dst = _zeros_like(state)
    assert Snapshot(step_dir).restore(dst, hot=["model/emb"]) is None
    assert _equal(dst, state)
