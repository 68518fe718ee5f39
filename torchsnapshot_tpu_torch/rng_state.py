"""Host and device RNG state capture.

Counterpart of ``torchsnapshot_tpu/rng_state.py``, with one planned
divergence. JAX keys are explicit arrays, so the JAX package captures only
the ambient Python and NumPy generators. torch also has ambient
generators, so ``RNGState`` here captures four:

- ``python`` and ``numpy``: pickled as in the JAX package, same keys;
- ``torch``: the CPU generator's state bytes;
- ``cuda``: one state per visible CUDA device, present only when CUDA is
  available at capture time.

States are bytes, so they inline into the snapshot metadata as primitives.
The orchestrator captures RNG state at ``take`` entry and re-applies it
after, so a take never perturbs the streams; on ``restore`` RNG states are
restored last, from the generators the snapshot holds, whatever the
restoring host has: a snapshot from a host without CUDA, or with another
number of CUDA devices, sets the python, numpy and torch generators and
the CUDA generators of the devices both hosts have. A JAX-written
``RNGState`` carries no ``torch``/``cuda`` entries, so restore it into a
``StateDict`` with the two shared keys.
"""

from __future__ import annotations

import pickle
import random
from typing import Any, Dict

import numpy as np
import torch


def _to_bytes(state: torch.Tensor) -> bytes:
    return state.cpu().numpy().tobytes()


def _from_bytes(raw: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8)


class RNGState:
    def state_dict(self) -> Dict[str, Any]:
        sd: Dict[str, Any] = {
            "python": pickle.dumps(random.getstate()),
            "numpy": pickle.dumps(np.random.get_state()),
            "torch": _to_bytes(torch.get_rng_state()),
        }
        if torch.cuda.is_available():
            sd["cuda"] = [_to_bytes(s) for s in torch.cuda.get_rng_state_all()]
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        if "torch" not in state_dict:
            raise RuntimeError(
                "this RNG state has no torch generator (a JAX-written RNGState?); "
                "restore its python and numpy states into a StateDict instead"
            )
        random.setstate(pickle.loads(state_dict["python"]))
        np.random.set_state(pickle.loads(state_dict["numpy"]))
        torch.set_rng_state(_from_bytes(state_dict["torch"]))
        if "cuda" in state_dict and torch.cuda.is_available():
            states = state_dict["cuda"][: torch.cuda.device_count()]
            torch.cuda.set_rng_state_all([_from_bytes(s) for s in states])
