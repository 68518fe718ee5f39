"""tsalint runner: build the Project once, run plugins, apply
suppressions, render.

Exit codes (the CLI contract, the JAX package's):

* ``0`` — clean: no unsuppressed findings, no suppression-hygiene
  failures.
* ``1`` — findings: at least one unsuppressed finding, stale
  suppression, or malformed suppression.
* ``2`` — usage/internal error: unknown ``--rule``, a plugin crashed,
  the package failed to parse.

Hygiene findings (``stale-suppression``, ``suppression-syntax``) fail
the run exactly like real findings — a suppression that no longer
matches anything is how baselines grow moss.

Counterpart of ``torchsnapshot_tpu/analysis/runner.py``: the same flags,
exit codes and ``--json`` schema.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import Dict, List, Optional, Sequence, Set

from .core import Finding, Project
from . import plugins as plugin_registry
from .suppress import apply as apply_suppressions
from .suppress import baseline_path

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_ERROR = 2


class LintReport:
    """One run's outcome: raw findings, suppression partition, errors."""

    def __init__(self) -> None:
        self.unsuppressed: List[Finding] = []
        self.suppressed: List = []  # (Finding, source) pairs
        self.hygiene: List[Finding] = []
        self.errors: List[str] = []
        self.rules_run: List[str] = []

    @property
    def exit_code(self) -> int:
        if self.errors:
            return EXIT_ERROR
        if self.unsuppressed or self.hygiene:
            return EXIT_FINDINGS
        return EXIT_CLEAN

    def to_json(self) -> Dict[str, object]:
        return {
            "rules": self.rules_run,
            "findings": [f.to_json() for f in self.unsuppressed],
            "hygiene": [f.to_json() for f in self.hygiene],
            "suppressed": [
                {**f.to_json(), "suppressed_by": src}
                for f, src in self.suppressed
            ],
            "errors": self.errors,
            "exit_code": self.exit_code,
        }


def run_lint(
    rules: Optional[Sequence[str]] = None,
    project: Optional[Project] = None,
    baseline_file: Optional[str] = None,
) -> LintReport:
    """Run the selected rules (default: all) over ``project`` (default:
    the installed package)."""
    report = LintReport()
    index = plugin_registry.rule_index()
    known = plugin_registry.all_rules()
    if rules:
        unknown = sorted(set(rules) - set(known))
        if unknown:
            report.errors.append(
                f"unknown rule(s): {', '.join(unknown)} "
                f"(known: {', '.join(known)})"
            )
            return report
        selected_plugins = []
        for name, mod in plugin_registry.PLUGINS.items():
            if any(r in rules for r in mod.RULES):
                selected_plugins.append((name, mod))
    else:
        selected_plugins = list(plugin_registry.PLUGINS.items())

    try:
        if project is None:
            project = Project()
    except SyntaxError as e:
        report.errors.append(f"package does not parse: {e}")
        return report

    active_rules: Set[str] = set()
    raw: List[Finding] = []
    for name, mod in selected_plugins:
        active_rules.update(mod.RULES)
        try:
            raw.extend(mod.run_pass(project))
        except Exception:
            report.errors.append(
                f"plugin {name!r} crashed:\n{traceback.format_exc()}"
            )
    report.rules_run = sorted(active_rules)
    if report.errors:
        return report
    if rules:
        # --rule selects individual rules, which may be a subset of what
        # the owning plugin emits
        raw = [f for f in raw if f.rule in rules]
        active_rules = set(rules)

    result = apply_suppressions(
        project.modules, raw, active_rules=active_rules,
        baseline_file=baseline_file,
    )
    report.unsuppressed = sorted(
        result.unsuppressed, key=lambda f: (f.file, f.line, f.rule, f.message)
    )
    report.suppressed = sorted(
        result.suppressed,
        key=lambda pair: (pair[0].file, pair[0].line, pair[0].rule),
    )
    report.hygiene = sorted(
        result.hygiene, key=lambda f: (f.file, f.line, f.rule, f.message)
    )
    return report


def render_text(report: LintReport, verbose: bool = False) -> str:
    lines: List[str] = []
    for err in report.errors:
        lines.append(f"tsalint error: {err}")
    for f in report.unsuppressed:
        lines.append(f.render())
    for f in report.hygiene:
        lines.append(f.render())
    if verbose:
        for f, src in report.suppressed:
            lines.append(f"suppressed ({src}): {f.render()}")
    n_sup = len(report.suppressed)
    if report.exit_code == EXIT_CLEAN:
        lines.append(
            f"tsalint: clean ({len(report.rules_run)} rule(s), "
            f"{n_sup} suppressed finding(s), baseline: {baseline_path()})"
        )
    else:
        lines.append(
            f"tsalint: {len(report.unsuppressed)} finding(s), "
            f"{len(report.hygiene)} suppression-hygiene failure(s), "
            f"{n_sup} suppressed"
        )
    return "\n".join(lines)


def add_lint_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="RULE",
        help=(
            "run only this rule id (repeatable); default is every "
            "registered rule"
        ),
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the report as JSON on stdout",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        metavar="PATH",
        help=(
            "suppression baseline file (default: "
            ".tsalint_baseline_torch.json at the repo root, or "
            "$TORCHSNAPSHOT_GPU_LINT_BASELINE)"
        ),
    )
    parser.add_argument(
        "--verbose",
        action="store_true",
        help="also list suppressed findings and their suppression source",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )


def cli_main(args: argparse.Namespace) -> int:
    if getattr(args, "list_rules", False):
        for name, mod in plugin_registry.PLUGINS.items():
            for rule in mod.RULES:
                print(f"{rule}  (plugin: {name})")
        return EXIT_CLEAN
    report = run_lint(rules=args.rule, baseline_file=args.baseline)
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        out = render_text(report, verbose=args.verbose)
        stream = sys.stdout if report.exit_code == EXIT_CLEAN else sys.stderr
        print(out, file=stream)
    return report.exit_code


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tsalint",
        description=(
            "torchsnapshot_tpu_torch static analyzer: concurrency, "
            "finalizer-context, resource-lifecycle, env-registry, and the "
            "five legacy invariant lints"
        ),
    )
    add_lint_arguments(parser)
    return cli_main(parser.parse_args(argv))
