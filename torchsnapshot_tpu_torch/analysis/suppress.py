"""tsalint suppressions: in-file justification comments + the baseline.

Two suppression channels, both *verified* (a suppression that matches
nothing fails the run — the baseline can only shrink):

**In-file** — the preferred channel for deliberate patterns. A comment
on the finding's line, or in the comment block directly above it (the
justification may continue over plain ``#`` lines — coverage slides
through the block to the first code line below)::

    # tsalint: allow[lock-order] sync path: documented amendment,
    # see the class docstring's locking rules.
    with link.lock:

The rule id must be bracketed and the justification text is REQUIRED —
an empty reason is itself a finding (``suppression-syntax``), because an
unexplained suppression is a review bypass, not a decision record.

**Baseline** — ``.tsalint_baseline_torch.json`` at the repo root
(override: ``TORCHSNAPSHOT_GPU_LINT_BASELINE``), for bulk-adopting the
analyzer on a tree with pre-existing findings. It is this package's own
file: the JAX package's ``.tsalint_baseline.json`` serves only that
package's analyzer. Entries are
``{"rule", "file", "reason"[, "line"][, "match"]}``; ``reason`` is
required, ``match`` is a message substring. The shipped baseline is
empty: every finding on today's tree is either fixed or carries an
in-file justification.

Stale detection runs per-channel: every in-file allow and every baseline
entry whose rule was part of the run must have matched at least one raw
finding, else a ``stale-suppression`` finding is emitted at the
suppression's own location.

Counterpart of ``torchsnapshot_tpu/analysis/suppress.py``: the same
comment syntax and sliding-block rule, so an allow comment carried over
from the JAX package counts here where it sits over the same code.
"""

from __future__ import annotations

import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, REPO_DIR

BASELINE_ENV_VAR = "TORCHSNAPSHOT_GPU_LINT_BASELINE"
DEFAULT_BASELINE = os.path.join(REPO_DIR, ".tsalint_baseline_torch.json")

_ALLOW_RE = re.compile(
    r"#\s*tsalint:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*:?\s*(.*)$"
)


@dataclass
class _Allow:
    """One in-file suppression comment."""

    file: str
    line: int  # line the comment sits on (1-based)
    rules: Tuple[str, ...]
    reason: str
    hits: int = 0


@dataclass
class _BaselineEntry:
    rule: str
    file: str
    reason: str
    line: Optional[int] = None
    match: Optional[str] = None
    index: int = 0
    hits: int = 0


@dataclass
class SuppressionResult:
    unsuppressed: List[Finding] = field(default_factory=list)
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)
    #: stale-suppression / suppression-syntax findings (fail the run)
    hygiene: List[Finding] = field(default_factory=list)


def baseline_path() -> str:
    return os.environ.get(BASELINE_ENV_VAR, "").strip() or DEFAULT_BASELINE


def _comment_tokens(source: str) -> List[Tuple[int, str]]:
    """(line, text) for each real COMMENT token — tokenizing (rather
    than grepping lines) keeps docstrings and string literals that
    MENTION the allow syntax from registering as suppressions."""
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # an unparseable file is the core parser's finding, not ours
    return out


def scan_allows(
    modules: Iterable[Module],
) -> Tuple[List[_Allow], List[Finding], Dict[str, Set[int]]]:
    """Collect in-file allow comments; malformed ones become findings.
    Also returns each file's set of comment lines, so ``apply`` can
    slide an allow's coverage through its comment block."""
    allows: List[_Allow] = []
    bad: List[Finding] = []
    comment_lines: Dict[str, Set[int]] = {}
    for mod in modules:
        lines = comment_lines.setdefault(mod.rel, set())
        for i, line in _comment_tokens(mod.source):
            lines.add(i)
            m = _ALLOW_RE.search(line)
            if m is None:
                if "tsalint:" in line:
                    bad.append(
                        Finding(
                            rule="suppression-syntax",
                            file=mod.rel,
                            line=i,
                            message=(
                                "unparseable tsalint comment — expected "
                                "'# tsalint: allow[rule-id] reason'"
                            ),
                        )
                    )
                continue
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            reason = m.group(2).strip()
            if not reason:
                bad.append(
                    Finding(
                        rule="suppression-syntax",
                        file=mod.rel,
                        line=i,
                        message=(
                            f"allow[{','.join(rules)}] has no justification "
                            "— a reason string is required"
                        ),
                    )
                )
                continue
            allows.append(_Allow(file=mod.rel, line=i, rules=rules, reason=reason))
    return allows, bad, comment_lines


def load_baseline(path: str) -> Tuple[List[_BaselineEntry], List[Finding]]:
    entries: List[_BaselineEntry] = []
    bad: List[Finding] = []
    if not os.path.exists(path):
        return entries, bad
    rel = os.path.relpath(path, REPO_DIR).replace(os.sep, "/")
    try:
        with open(path, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        bad.append(
            Finding(
                rule="suppression-syntax",
                file=rel,
                line=1,
                message=f"unreadable baseline: {e}",
            )
        )
        return entries, bad
    rows = doc.get("suppressions", []) if isinstance(doc, dict) else doc
    if not isinstance(rows, list):
        bad.append(
            Finding(
                rule="suppression-syntax", file=rel, line=1,
                message="baseline must be a list or {'suppressions': [...]}",
            )
        )
        return entries, bad
    for i, row in enumerate(rows):
        if not isinstance(row, dict) or not row.get("rule") or not row.get("file"):
            bad.append(
                Finding(
                    rule="suppression-syntax", file=rel, line=1,
                    message=f"baseline entry #{i}: 'rule' and 'file' required",
                )
            )
            continue
        if not str(row.get("reason", "")).strip():
            bad.append(
                Finding(
                    rule="suppression-syntax", file=rel, line=1,
                    message=(
                        f"baseline entry #{i} ({row['rule']} @ {row['file']}) "
                        "has no reason string"
                    ),
                )
            )
            continue
        entries.append(
            _BaselineEntry(
                rule=str(row["rule"]),
                file=str(row["file"]).replace(os.sep, "/"),
                reason=str(row["reason"]),
                line=row.get("line"),
                match=row.get("match"),
                index=i,
            )
        )
    return entries, bad


def apply(
    modules: Sequence[Module],
    findings: Sequence[Finding],
    active_rules: Optional[Set[str]] = None,
    baseline_file: Optional[str] = None,
) -> SuppressionResult:
    """Partition raw findings into suppressed / unsuppressed and verify
    suppression hygiene. ``active_rules`` limits stale detection to the
    rules that actually ran (a ``--rule`` subset must not flag other
    rules' suppressions as stale)."""
    path = baseline_file if baseline_file is not None else baseline_path()
    allows, bad_allows, comment_lines = scan_allows(modules)
    entries, bad_entries = load_baseline(path)
    result = SuppressionResult()
    result.hygiene.extend(bad_allows)
    result.hygiene.extend(bad_entries)

    by_file_line: Dict[Tuple[str, int], List[_Allow]] = {}
    for allow in allows:
        # a comment suppresses findings on its own line, on the rest of
        # its comment block, and on the first code line below the block
        # (so a multi-line justification still reaches the call it covers)
        by_file_line.setdefault((allow.file, allow.line), []).append(allow)
        in_file = comment_lines.get(allow.file, set())
        cursor = allow.line + 1
        while cursor in in_file:
            by_file_line.setdefault((allow.file, cursor), []).append(allow)
            cursor += 1
        by_file_line.setdefault((allow.file, cursor), []).append(allow)

    for finding in findings:
        src: Optional[str] = None
        for allow in by_file_line.get((finding.file, finding.line), []):
            if finding.rule in allow.rules:
                allow.hits += 1
                src = f"in-file:{allow.file}:{allow.line}"
                break
        if src is None:
            for entry in entries:
                if entry.rule != finding.rule or entry.file != finding.file:
                    continue
                if entry.line is not None and entry.line != finding.line:
                    continue
                if entry.match is not None and entry.match not in finding.message:
                    continue
                entry.hits += 1
                src = f"baseline:#{entry.index}"
                break
        if src is None:
            result.unsuppressed.append(finding)
        else:
            result.suppressed.append((finding, src))

    rel_baseline = os.path.relpath(path, REPO_DIR).replace(os.sep, "/")
    for allow in allows:
        if allow.hits:
            continue
        if active_rules is not None and not (set(allow.rules) & active_rules):
            continue
        result.hygiene.append(
            Finding(
                rule="stale-suppression",
                file=allow.file,
                line=allow.line,
                message=(
                    f"allow[{','.join(allow.rules)}] matches no finding — "
                    "remove it (the finding it justified is gone)"
                ),
            )
        )
    for entry in entries:
        if entry.hits:
            continue
        if active_rules is not None and entry.rule not in active_rules:
            continue
        result.hygiene.append(
            Finding(
                rule="stale-suppression",
                file=rel_baseline,
                line=1,
                message=(
                    f"baseline entry #{entry.index} ({entry.rule} @ "
                    f"{entry.file}) matches no finding — remove it; the "
                    "baseline only shrinks"
                ),
            )
        )
    return result
