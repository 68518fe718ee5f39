"""The Stateful protocol: what can be checkpointed.

Counterpart of ``torchsnapshot_tpu/stateful.py``. Anything exposing
``state_dict()``/``load_state_dict()`` participates in an app state;
``StateDict`` adapts a raw dict of tensors and values into a Stateful.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class Stateful(Protocol):
    def state_dict(self) -> Dict[str, Any]:
        ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        ...


AppState = Dict[str, Stateful]
