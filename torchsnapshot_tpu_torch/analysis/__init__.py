"""tsalint for torchsnapshot_tpu_torch: the package's static analyzer.

Counterpart of ``torchsnapshot_tpu/analysis/``, pointed at this package.
One shared AST core (:mod:`.core`), a verified suppression layer
(:mod:`.suppress`), and a plugin registry (:mod:`.plugins`) hosting the
five legacy invariant lints plus four deep passes: lock discipline,
restricted (finalizer/signal) contexts, resource lifecycle, and the
env-knob registry. Run it as ``python -m torchsnapshot_tpu_torch lint``;
docs/source/static_analysis.rst has the rule catalog and suppression
syntax, which are the JAX package's.
"""

from .core import Finding, FunctionInfo, Module, Project
from .runner import (
    EXIT_CLEAN,
    EXIT_ERROR,
    EXIT_FINDINGS,
    LintReport,
    render_text,
    run_lint,
)
from .suppress import BASELINE_ENV_VAR, DEFAULT_BASELINE, baseline_path

__all__ = [
    "Finding",
    "FunctionInfo",
    "Module",
    "Project",
    "LintReport",
    "run_lint",
    "render_text",
    "EXIT_CLEAN",
    "EXIT_FINDINGS",
    "EXIT_ERROR",
    "BASELINE_ENV_VAR",
    "DEFAULT_BASELINE",
    "baseline_path",
]
