"""The system under test: ``torchsnapshot_tpu_torch``, and nothing else.

This is the only module of the benchmark that imports the port. It builds
the port's transformer train step from a configuration file's ``port``
entry, hands the port a train state made of the benchmark's tensors, and
drives the port's checkpoint calls through its S3 plugin over the
benchmark's in-memory store. It also reads the port's op telemetry: the
critical-path categories of the last take or restore.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, telemetry, warmup_staging
from torchsnapshot_tpu_torch.models import transformer

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def model_config(port: Dict[str, Any]) -> transformer.TransformerConfig:
    kw = dict(port)
    for key in ("dtype", "param_dtype"):
        kw[key] = _DTYPES[kw[key]]
    return transformer.TransformerConfig(**kw)


def train_state(params: Dict[str, Any], lr: float):
    """The port's train state around ``params`` (the benchmark's tensors,
    used in place) and its AdamW with rate ``lr``: ``(state, step_fn)``,
    where ``step_fn(state, batch) -> (state, loss)`` is the port's train
    step, which updates the state in place."""
    opt = transformer.make_optimizer(lr)
    state = {
        "params": params,
        "opt_state": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=params["embed"].device),
    }
    return state, opt


def make_step(port: Dict[str, Any], opt) -> Callable:
    return transformer.make_train_step(model_config(port), opt)


def first_moments(state: Dict[str, Any]) -> Dict[str, Any]:
    """Adam's first moments, shaped like the params (optax's layout)."""
    return state["opt_state"][0].mu


class Checkpointer:
    """``Snapshot.async_take`` and ``Snapshot.restore`` of one app state
    ``{"train": StateDict(state)}`` at ``s3://<bucket>/<prefix>/<n>``."""

    def __init__(self, state: Dict[str, Any], client: Any, bucket: str, prefix: str) -> None:
        self.app = {"train": StateDict(state)}
        self.options = {"client": client}
        self.bucket, self.prefix = bucket, prefix

    def url(self, n: int) -> str:
        return f"s3://{self.bucket}/{self.prefix}/{n}"

    def warm_staging(self) -> int:
        return warmup_staging(self.app)

    def async_take(self, n: int):
        return Snapshot.async_take(self.url(n), self.app, storage_options=self.options)

    def restore(self, n: int) -> None:
        """Restore snapshot ``n`` into the app state, whose tensors are the
        live train state's."""
        Snapshot(self.url(n), storage_options=self.options).restore(self.app)


def set_telemetry(on: bool) -> None:
    telemetry.set_enabled(on)


def last_categories() -> Optional[Dict[str, float]]:
    """Busy seconds by critical-path category of the last take or restore
    (``telemetry/critpath.py``), or None with telemetry off."""
    att = telemetry.last_attribution()
    return None if att is None else dict(att.get("categories") or {})

