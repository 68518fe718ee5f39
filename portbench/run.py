"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for. Without them it exits non-zero and prints no result.
"""

import time

_STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this directory: the port and ``portbench`` are
# imported as packages, and no module here shadows one of the library's.
sys.path[0] = _ROOT
# Caches of the toolchain stay at fixed paths inside the checkout.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_ROOT, ".portbench_cache", _sub)
os.environ["USE_FLAX"] = "0"

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], started=_STARTED))
