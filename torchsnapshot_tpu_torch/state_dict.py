"""StateDict: a dict that is its own state dict.

Counterpart of ``torchsnapshot_tpu/state_dict.py``. Captures raw state
(parameter tensors, step counters, objects) in an app state::

    app_state = {"model": StateDict(params=params, step=0)}

After ``restore``, the restored values are accessible via the same instance.
"""

from __future__ import annotations

from collections import UserDict
from typing import Any, Dict


class StateDict(UserDict):
    def state_dict(self) -> Dict[str, Any]:
        return self.data

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.data.update(state_dict)
