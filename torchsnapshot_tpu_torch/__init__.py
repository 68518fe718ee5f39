"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

It imports torch and never jax, nor anything of the JAX package. Its env
knobs use the prefix ``TORCHSNAPSHOT_GPU_``.
"""

from .version import __version__  # noqa: F401
from .manifest import CorruptSnapshotError, SnapshotMetadata  # noqa: F401
from .rng_state import RNGState  # noqa: F401
from .snapshot import PendingRestore, PendingSnapshot, Snapshot, StaleCommitError  # noqa: F401
from .state_dict import StateDict  # noqa: F401
from .stateful import AppState, Stateful  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
from .preemption import PreemptionWatcher, simulate_preemption_now  # noqa: F401
from .io_preparers.array import warmup_staging  # noqa: F401
from .dist_store import StoreConnectionLostError  # noqa: F401
