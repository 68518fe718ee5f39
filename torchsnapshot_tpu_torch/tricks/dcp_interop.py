"""Migration between ``torch.distributed.checkpoint`` (DCP) checkpoints and
snapshots: the port's counterpart of tricks/orbax_interop.py of the JAX
package, since DCP is the incumbent checkpoint format of torch as orbax is
of JAX.

Every function runs in one process with no process group (DCP's
``no_dist=True``). DCP flattens nested dicts into dotted keys and records
each key's path in its metadata (``planner_data``), from which
:func:`load_dcp_state_dict` rebuilds the nested dict when no target is
given.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def _target_from_metadata(dcp_path: str) -> Dict[str, Any]:
    """A nested dict of empty CPU tensors (and ``None`` for pickled
    values) shaped as the checkpoint's metadata records them."""
    import torch
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    md = FileSystemReader(dcp_path).read_metadata()
    paths = md.planner_data or {}
    target: Dict[str, Any] = {}
    for key, item in md.state_dict_metadata.items():
        path = paths.get(key, (key,))
        node = target
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if isinstance(item, TensorStorageMetadata):
            node[path[-1]] = torch.empty(item.size, dtype=item.properties.dtype)
        else:
            node[path[-1]] = None
    return target


def load_dcp_state_dict(dcp_path: str, target: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Read a DCP checkpoint into a nested dict. ``target`` (optional)
    gives the structure and the tensors to load into (CPU or CUDA); without
    it, CPU tensors of the recorded shapes and dtypes."""
    import torch.distributed.checkpoint as dcp

    state = _target_from_metadata(dcp_path) if target is None else target
    dcp.load(state, checkpoint_id=dcp_path, no_dist=True)
    return state


def migrate_from_dcp(dcp_path: str, snapshot_path: str,
                     target: Optional[Dict[str, Any]] = None) -> Any:
    """Convert a DCP checkpoint into a snapshot of app state ``"app"``;
    returns the Snapshot."""
    from .. import Snapshot, StateDict

    return Snapshot.take(snapshot_path, {"app": StateDict(load_dcp_state_dict(dcp_path, target))})


def migrate_to_dcp(snapshot_path: str, dcp_path: str, target: Dict[str, Any]) -> None:
    """Restore a snapshot into ``target`` (a dict matching the saved app
    state ``"app"``) and write it as a DCP checkpoint."""
    import torch.distributed.checkpoint as dcp

    from .. import Snapshot, StateDict

    dst = StateDict(**target)
    Snapshot(snapshot_path).restore({"app": dst})
    dcp.save(dict(dst), checkpoint_id=dcp_path, no_dist=True)
