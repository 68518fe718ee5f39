"""An autouse fixture shared by the port's test files, which import it
(``from torch_test_env import autotune_never``): ``tests/conftest.py`` only
registers markers for them.

The port's integration tests assert fixed election outcomes (chunk
layouts, file counts, binding verdicts), and the process-global I/O
governor would carry profiles learned in one test into the next. So the
closed loop is off for them, as the JAX package's suite turns its own
off (``tests/conftest.py``); a test of the loop sets the knob in its body,
which runs after this fixture.
"""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def autotune_never(monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_AUTOTUNE", "never")
