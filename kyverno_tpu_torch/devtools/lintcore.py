# Copied from kyverno_tpu/devtools/lintcore.py, aimed at the port: the
# default baseline is the port's own file, and the dispatch modules
# kernels.py and tpu/graphs.py are hot.
"""Lint infrastructure: findings, per-file parse artifacts, baseline.

Each check module exports ``check(ctx) -> List[Finding]``. The runner
parses every package source ONCE into a ``SourceFile`` (AST + the
line->comment map the guarded-by convention rides on) and hands the
whole set to each check, so five checks cost one parse.

A finding names its CHECK CLASS (stable identifier the CLI's
``--fail-on`` and the baseline select on), the file:line it anchors
to, and a human message. Deliberately-kept findings live in a
checked-in ``devtools/lint_baseline.json``::

    [{"check": "guarded-by", "file": "serving/batcher.py",
      "match": "_stats", "reason": "aggregated under the flush cv"}]

Baseline entries match on (check, file suffix, message substring) —
never on line numbers, which drift with every edit above them.
"""

from __future__ import annotations

import ast
import io
import json
import os
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

CHECK_CLASSES = (
    "jax-import",          # worker import closure must stay JAX-free
    "guarded-by",          # annotated shared attrs touched outside lock
    "fault-site",          # fire()/arm() literals vs KNOWN_SITES + dead
    "metric-family",       # unregistered families / unbounded label keys
    "blocking-under-lock",  # sleep/IO/subprocess/dispatch inside a lock
)


@dataclass
class Finding:
    check: str
    file: str      # path relative to the lint root
    line: int
    message: str
    baselined: bool = False
    baseline_reason: str = ""

    def to_dict(self) -> dict:
        d = {"check": self.check, "file": self.file, "line": self.line,
             "message": self.message}
        if self.baselined:
            d["baselined"] = True
            d["baseline_reason"] = self.baseline_reason
        return d

    def render(self) -> str:
        tag = " [baselined]" if self.baselined else ""
        return f"{self.file}:{self.line}: [{self.check}] {self.message}{tag}"


@dataclass
class SourceFile:
    path: str        # absolute
    rel: str         # relative to the lint root, '/'-separated
    source: str
    tree: ast.Module
    # line number -> comment text (without the leading '#', stripped)
    comments: Dict[int, str] = field(default_factory=dict)
    # lines that are ONLY a comment: a standalone comment annotates the
    # statement below it; a trailing comment annotates its own line only
    standalone_comments: frozenset = frozenset()


@dataclass
class LintContext:
    root: str                      # directory being linted
    files: List[SourceFile]
    # faults.py site constants of the REAL package (name -> value) and
    # the registered metric families — the invariants are the engine's
    # even when the lint target is a fixture tree
    site_constants: Dict[str, str]
    known_sites: frozenset
    metric_families: frozenset
    # modules (rel paths) the blocking-under-lock check patrols; None
    # means every module in the target is hot (fixture trees)
    hot_modules: Optional[frozenset] = None

    def is_hot(self, rel: str) -> bool:
        if self.hot_modules is None:
            return True
        return any(rel == h or rel.startswith(h.rstrip("/") + "/")
                   for h in self.hot_modules)


class LintUsageError(ValueError):
    """Bad invocation (unknown check class, unreadable path/baseline) —
    the CLI maps this to exit code 2."""


# ---------------------------------------------------------------- parse

def _comment_map(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:
        pass  # a file ast can parse but tokenize trips on is still lintable
    return out


def load_tree(root: str) -> List[SourceFile]:
    if not os.path.isdir(root):
        raise LintUsageError(f"lint root is not a directory: {root}")
    files: List[SourceFile] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as f:
                source = f.read()
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                raise LintUsageError(f"unparseable source {path}: {e}") \
                    from None
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            comments = _comment_map(source)
            lines = source.splitlines()
            standalone = frozenset(
                ln for ln in comments
                if ln <= len(lines) and lines[ln - 1].lstrip().startswith("#"))
            files.append(SourceFile(path=path, rel=rel, source=source,
                                    tree=tree, comments=comments,
                                    standalone_comments=standalone))
    return files


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_engine_invariants() -> Tuple[Dict[str, str], frozenset, frozenset]:
    """(site constants, KNOWN_SITES values, metric families) extracted
    from the REAL package source — statically, so the linter never
    imports the engine (and never needs JAX)."""
    pkg = _package_root()
    sites: Dict[str, str] = {}
    with open(os.path.join(pkg, "resilience", "faults.py"),
              encoding="utf-8") as f:
        ftree = ast.parse(f.read())
    for node in ftree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("SITE_")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            sites[node.targets[0].id] = node.value.value
    families = set()
    for mod in (os.path.join(pkg, "observability", "metrics.py"),
                os.path.join(pkg, "observability", "analytics.py")):
        with open(mod, encoding="utf-8") as f:
            mtree = ast.parse(f.read())
        for node in ast.walk(mtree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("counter", "gauge", "histogram")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                families.add(node.args[0].value)
            # the RuleStatsCollector renders its families from literals
            # (f-string prefixes included) rather than instruments
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value.startswith("kyverno_")
                    and node.value.replace("_", "").isalnum()):
                families.add(node.value)
    return sites, frozenset(sites.values()), frozenset(families)


# modules where a blocking call under a held lock stalls the serving /
# scan hot path (queue waiters, the flusher, device feed, admission
# handlers) rather than a cold control loop
HOT_MODULES = frozenset({
    "serving/queue.py", "serving/batcher.py", "serving/dispatch.py",
    "webhooks/server.py", "webhooks/batcher.py",
    "tpu/engine.py", "tpu/pipeline.py", "tpu/cache.py",
    "encode/pool.py", "cluster/scanner.py", "cluster/policycache.py",
    "observability/metrics.py", "observability/analytics.py",
    "observability/flightrecorder.py", "resilience/breaker.py",
    "lifecycle/snapshot.py",
    # fleet: the peer-fetch path runs on admission submit and the
    # heartbeat/gossip threads share state with the scan tick — remote
    # IO must never happen under a held fleet lock
    "fleet/manager.py", "fleet/membership.py", "fleet/peering.py",
    # the port's device dispatch: kernel launches, builds and CUDA graph
    # captures / replays (the reference's sits in tpu/engine.py)
    "kernels.py", "tpu/graphs.py",
})


def build_context(root: Optional[str] = None,
                  hot_modules: Optional[frozenset] = HOT_MODULES,
                  ) -> LintContext:
    pkg = _package_root()
    target = os.path.abspath(root) if root else pkg
    # fixture trees get blanket hot coverage: their whole point is to
    # trip the checks
    is_pkg = os.path.isdir(target) and os.path.samefile(target, pkg)
    hot = hot_modules if is_pkg else None
    sites, known, families = load_engine_invariants()
    return LintContext(root=target, files=load_tree(target),
                       site_constants=sites, known_sites=known,
                       metric_families=families, hot_modules=hot)


# ------------------------------------------------------------- baseline

def default_baseline_path() -> str:
    """The port's own baseline, beside this module. Never a
    ``lint_baseline.json`` of the working directory or of the repo
    root: that one is the JAX package's."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.json")


def load_baseline(path: Optional[str]) -> List[dict]:
    """Explicit path, else the port's ``devtools/lint_baseline.json``.
    Missing implicit baseline = empty."""
    candidates = [path] if path else [default_baseline_path()]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            try:
                with open(cand, encoding="utf-8") as f:
                    entries = json.load(f)
            except (OSError, ValueError) as e:
                raise LintUsageError(f"unreadable baseline {cand}: {e}") \
                    from None
            if not isinstance(entries, list):
                raise LintUsageError(
                    f"baseline {cand} must be a JSON list of entries")
            for e in entries:
                if not isinstance(e, dict) or "check" not in e \
                        or "file" not in e or "reason" not in e:
                    raise LintUsageError(
                        f"baseline entry needs check/file/reason: {e!r}")
            return entries
    if path:
        raise LintUsageError(f"baseline not found: {path}")
    return []


def apply_baseline(findings: List[Finding],
                   baseline: List[dict]) -> None:
    for f in findings:
        for e in baseline:
            if (e["check"] == f.check
                    and (f.file == e["file"]
                         or f.file.endswith("/" + e["file"]))
                    and e.get("match", "") in f.message):
                f.baselined = True
                f.baseline_reason = e["reason"]
                break


# --------------------------------------------------------------- runner

def run_lint(root: Optional[str] = None,
             checks: Optional[List[str]] = None,
             baseline: Optional[List[dict]] = None) -> List[Finding]:
    from . import (check_blocking, check_faults, check_imports,
                   check_locks, check_metrics)

    registry = {
        "jax-import": check_imports.check,
        "guarded-by": check_locks.check,
        "fault-site": check_faults.check,
        "metric-family": check_metrics.check,
        "blocking-under-lock": check_blocking.check,
    }
    selected = checks if checks is not None else list(CHECK_CLASSES)
    for c in selected:
        if c not in registry:
            raise LintUsageError(
                f"unknown check class {c!r} (known: {', '.join(CHECK_CLASSES)})")
    ctx = build_context(root)
    findings: List[Finding] = []
    for c in selected:
        findings.extend(registry[c](ctx))
    findings.sort(key=lambda f: (f.file, f.line, f.check))
    if baseline:
        apply_baseline(findings, baseline)
    return findings
