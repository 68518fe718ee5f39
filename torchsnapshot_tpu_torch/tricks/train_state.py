"""Stateful adapters for nested trees and the train state
(tricks/flax_train.py of the JAX package).

A state object that is not itself Stateful gets an adapter that exposes
``state_dict``/``load_state_dict`` and holds the current state, which it
*replaces* on load: callers read ``adapter.state`` (or ``adapter.tree``)
after a restore, as with the JAX package's adapters.
"""

from __future__ import annotations

from typing import Any, Dict


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_state_dict(x: Any) -> Any:
    """flax.serialization.to_state_dict's rules: a dict keeps its keys as
    strings, a namedtuple becomes a dict by field, a list or tuple a dict
    keyed by index strings; anything else is a leaf."""
    if isinstance(x, dict):
        return {str(k): _to_state_dict(v) for k, v in x.items()}
    if _is_namedtuple(x):
        return {f: _to_state_dict(getattr(x, f)) for f in x._fields}
    if isinstance(x, (list, tuple)):
        return {str(i): _to_state_dict(v) for i, v in enumerate(x)}
    return x


def _from_state_dict(target: Any, sd: Any) -> Any:
    """The inverse of :func:`_to_state_dict` onto ``target``'s structure."""
    if isinstance(target, dict):
        return type(target)((k, _from_state_dict(v, sd[str(k)])) for k, v in target.items())
    if _is_namedtuple(target):
        return type(target)(*(_from_state_dict(getattr(target, f), sd[f])
                              for f in target._fields))
    if isinstance(target, (list, tuple)):
        return type(target)(_from_state_dict(v, sd[str(i)]) for i, v in enumerate(target))
    return sd


class TrainStateAdapter:
    """Checkpoint the port's train state (``{params, opt_state, step}`` of
    ``models.*.init_state``, or any tree of dicts, lists and namedtuples)
    through Snapshot.

    The stored layout is the one flax's ``to_state_dict`` gives the JAX
    package's ``FlaxTrainStateAdapter`` for a ``TrainState`` of the same
    tree: nested dicts, tuples keyed by index strings, namedtuples by
    field. So a snapshot of either adapter restores into the other.
    """

    def __init__(self, state: Any) -> None:
        self.state = state

    def state_dict(self) -> Dict[str, Any]:
        return _to_state_dict(self.state)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.state = _from_state_dict(self.state, state_dict)


class PytreeAdapter:
    """Checkpoint an arbitrary tree of dicts, lists, tuples and namedtuples.

    Leaves are stored under their ``torch.utils._pytree.keystr`` paths
    (``['a'][0]``), the strings ``jax.tree_util.keystr`` gives, so a
    snapshot of one tree written by either package's adapter restores in
    the other. A ``None`` is an empty subtree, as in JAX. The destination
    tree must have the same structure; the restored tree replaces
    ``self.tree``.
    """

    def __init__(self, tree: Any) -> None:
        self.tree = tree

    def state_dict(self) -> Dict[str, Any]:
        from torch.utils import _pytree

        flat, _ = _pytree.tree_flatten_with_path(self.tree)
        # torch's pytree holds None as a leaf; JAX's as an empty node.
        return {_pytree.keystr(path): leaf for path, leaf in flat if leaf is not None}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        from torch.utils import _pytree

        flat, spec = _pytree.tree_flatten_with_path(self.tree)
        leaves = [None if leaf is None else state_dict[_pytree.keystr(path)]
                  for path, leaf in flat]
        self.tree = _pytree.tree_unflatten(leaves, spec)
