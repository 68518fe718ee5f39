"""Helpers shared by the tests that hold the port's command line against
the JAX package's (``tests/test_torch_cli.py``, ``test_torch_fsck.py``,
``test_torch_watch_cli.py``, ``test_torch_torchsnapshot_interop.py``).

- :func:`run_cli` runs one ``main(argv)`` and returns ``(exit code,
  stdout, stderr)``.
- :func:`both` runs the same argv through both packages' ``main`` and
  returns both results, the JAX package's text with its env prefix and
  module name put into the port's (the one deliberate difference of the
  text, ROADMAP queue 3).
- :func:`take_both` takes one numpy-seeded state with each package.
- :func:`recorders_from_env`, an autouse fixture for the files that
  import it, reads the flight recorder's and the hang watchdog's gates
  from a clean env: both are read at import and by ``refresh_from_env``,
  so an earlier test in the same process could leave them off.
"""

from __future__ import annotations

import contextlib
import io
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pytest
import torch

Result = Tuple[int, str, str]


@pytest.fixture(autouse=True)
def recorders_from_env(monkeypatch):
    from torchsnapshot_tpu_torch import faultinject
    from torchsnapshot_tpu_torch.telemetry import flightrec, forensics

    monkeypatch.delenv(flightrec.FLIGHTREC_ENV_VAR, raising=False)
    monkeypatch.delenv(forensics.FORENSICS_ENV_VAR, raising=False)
    flightrec.refresh_from_env()
    forensics.refresh_from_env()
    yield
    faultinject.disable()
    flightrec.refresh_from_env()
    forensics.refresh_from_env()


def run_cli(main: Callable[[List[str]], int], argv: Sequence[str]) -> Result:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def to_port_text(text: str) -> str:
    """The JAX package's text with the port's env prefix and module."""
    return (text.replace("TORCHSNAPSHOT_TPU_", "TORCHSNAPSHOT_GPU_")
            .replace("python -m torchsnapshot_tpu ", "python -m torchsnapshot_tpu_torch "))


def both(argv: Sequence[str]) -> Tuple[Result, Result]:
    """``(jax, port)`` results of one argv, the JAX text in port terms."""
    from torchsnapshot_tpu import cli as jax_cli
    from torchsnapshot_tpu_torch import cli

    rc, out, err = run_cli(jax_cli.main, argv)
    return (rc, to_port_text(out), to_port_text(err)), run_cli(cli.main, argv)


def state_arrays(seed: int = 0) -> Dict[str, np.ndarray]:
    """Leaves of every dtype both packages hold, bf16 with its specials."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    bf = rng.standard_normal(12).astype(np.float32)
    bf[:4] = [np.nan, np.inf, -0.0, 0.1]
    return {
        "w": rng.standard_normal((8, 16)).astype(np.float32),
        "big": rng.standard_normal(300).astype(np.float32),
        "bf": bf.astype(ml_dtypes.bfloat16),
        "h": rng.standard_normal((3, 3)).astype(np.float16),
        "d": rng.standard_normal(5),
        "i": np.arange(100, dtype=np.int64),
        "i8": rng.integers(-100, 100, 7).astype(np.int8),
        "u8": rng.integers(0, 255, 7).astype(np.uint8),
        "mask": rng.random(6) > 0.5,
        "c": (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64),
        "s0": np.full((), 2.5, np.float32),
        "z": np.zeros(4096, np.float32),
    }


def to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def port_state(arrays: Dict[str, np.ndarray], extra: Optional[Dict[str, Any]] = None):
    import torchsnapshot_tpu_torch as P

    return {"m": P.StateDict({**{k: to_torch(v) for k, v in arrays.items()}, **(extra or {})})}


def jax_state(arrays: Dict[str, np.ndarray], extra: Optional[Dict[str, Any]] = None):
    import torchsnapshot_tpu as J

    return {"m": J.StateDict({**{k: v.copy() for k, v in arrays.items()}, **(extra or {})})}


EXTRA = {"step": 7, "lr": 0.125, "name": "run/alpha", "opt": {"betas": [0.9, 0.999]}}


def take_both(root: str, seed: int = 0, **take_kw: Any) -> Dict[str, str]:
    """One state taken by each package: ``{"port": path, "jax": path}``."""
    import torchsnapshot_tpu as J
    import torchsnapshot_tpu_torch as P

    arrays = state_arrays(seed)
    paths = {"port": f"{root}/port", "jax": f"{root}/jax"}
    P.Snapshot.take(paths["port"], port_state(arrays, EXTRA), **take_kw)
    J.Snapshot.take(paths["jax"], jax_state(arrays, EXTRA), **take_kw)
    return paths
