"""Adapters for third-party state (tricks/ of the JAX package).

- :mod:`.train_state`: ``PytreeAdapter`` keys a nested tree's leaves by
  the JAX package's path strings, and ``TrainStateAdapter`` checkpoints
  the port's train state under the layout of the JAX package's flax
  ``TrainState`` adapter.
- :mod:`.dcp_interop`: migration to and from ``torch.distributed.checkpoint``
  (the counterpart of the JAX package's orbax migration).
- :mod:`.torchsnapshot_interop`: the reference (pytorch/torchsnapshot)
  on-disk format, both ways.

Imports are lazy, so importing the package pulls in nothing third-party.
"""

from typing import Any

__all__ = [
    "PytreeAdapter",
    "TrainStateAdapter",
    "load_torchsnapshot",
    "migrate_from_torchsnapshot",
    "migrate_to_torchsnapshot",
    "save_as_torchsnapshot",
]


def __getattr__(name: str) -> Any:
    if name in ("PytreeAdapter", "TrainStateAdapter"):
        from . import train_state

        return getattr(train_state, name)
    if name in (
        "load_torchsnapshot",
        "migrate_from_torchsnapshot",
        "migrate_to_torchsnapshot",
        "save_as_torchsnapshot",
    ):
        from . import torchsnapshot_interop as _tsi

        return getattr(_tsi, name)
    raise AttributeError(name)
