# Copied from kyverno_tpu/devtools/check_imports.py, with torch, the
# port's device runtime, forbidden beside jax and jaxlib.
"""jax-import: the encode-worker import closure must stay free of the
device runtimes (torch, jax).

The encoder pool spawns ``python -m kyverno_tpu_torch.encode.worker``
processes whose whole value is being cheap, pure-NumPy feeders; a torch
import in that closure drags the CUDA runtime into every worker (and a
JAX import the XLA runtime). Today only the runtime ``ready`` handshake
(``torch_loaded`` / ``jax_loaded``) catches a leak — after the damage.
This check proves it statically.

Reachability model (matches what actually executes at worker startup):

- the root file's imports at EVERY nesting level are followed — the
  worker's ``main()`` does its real imports inside the function body,
  and they all run before the ready handshake;
- for every other module only MODULE-LEVEL imports are followed.
  Function-level imports elsewhere are the deliberate lazy-escape
  idiom (``tpu/__init__``'s PEP 562 exports, the breaker's lazy
  observability imports) and stay guarded by the runtime handshake;
- importing ``a.b.c`` executes ``a/__init__`` and ``a/b/__init__``
  too, so package ancestors join the closure;
- imports under ``if TYPE_CHECKING:`` never execute and are skipped.

A module-level ``import torch`` / ``jax`` / ``jaxlib`` anywhere in that
closure is a finding, reported with the import chain from the worker.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .lintcore import Finding, LintContext, SourceFile

ROOT_MODULE = "encode/worker.py"
FORBIDDEN = ("torch", "jax", "jaxlib")


def _is_type_checking_guard(node: ast.stmt) -> bool:
    if not isinstance(node, ast.If):
        return False
    t = node.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or \
        (isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING")


def _iter_imports(tree: ast.Module, all_levels: bool):
    """Import statements that EXECUTE when the module is imported:
    module-level (through try/if/with bodies) and class bodies (class
    bodies run at import time). Function bodies are deferred execution
    and only walked when ``all_levels`` (the root worker file, whose
    main() imports all run before the ready handshake).
    ``TYPE_CHECKING`` blocks never execute and are skipped."""
    def walk(body):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                yield node
            elif _is_type_checking_guard(node):
                continue
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if all_levels:
                    yield from walk(node.body)
            elif hasattr(node, "body"):
                yield from walk(node.body)
                for attr in ("orelse", "finalbody"):
                    yield from walk(getattr(node, attr, []) or [])
                for h in getattr(node, "handlers", []) or []:
                    yield from walk(h.body)
    yield from walk(tree.body)


def _module_name(rel: str) -> str:
    """'encode/worker.py' -> 'encode.worker'; '__init__.py' -> ''."""
    mod = rel[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    elif mod == "__init__":
        mod = ""
    return mod


def _resolve(mod: str, rel: str, node, by_name: Dict[str, SourceFile],
             ) -> List[Tuple[str, int]]:
    """Package-internal modules a single import statement pulls in, as
    (dotted name, lineno). External imports resolve to their top name
    so the forbidden check can see them."""
    out: List[Tuple[str, int]] = []

    def add(name: str) -> None:
        # ancestors' __init__ execute too
        parts = name.split(".")
        for i in range(1, len(parts)):
            anc = ".".join(parts[:i])
            if anc in by_name:
                out.append((anc, node.lineno))
        out.append((name, node.lineno))

    if isinstance(node, ast.Import):
        for alias in node.names:
            add(alias.name)
        return out
    assert isinstance(node, ast.ImportFrom)
    if node.level == 0:
        base = node.module or ""
    else:
        # relative: strip (level) trailing components off this module's
        # dotted package path. A module's package is its name minus the
        # leaf (or itself for __init__).
        pkg_parts = mod.split(".") if mod else []
        if not rel.endswith("__init__.py") and pkg_parts:
            pkg_parts = pkg_parts[:-1]
        up = node.level - 1
        if up:
            pkg_parts = pkg_parts[:-up] if up <= len(pkg_parts) else []
        prefix = ".".join(pkg_parts)
        base = f"{prefix}.{node.module}" if node.module and prefix \
            else (node.module or prefix)
    if base:
        add(base)
    for alias in node.names:
        if alias.name == "*":
            continue
        cand = f"{base}.{alias.name}" if base else alias.name
        # `from x import name` imports module x.name iff that is a
        # module; otherwise it's an attribute of x (already added)
        if cand in by_name:
            add(cand)
    return out


def check(ctx: LintContext) -> List[Finding]:
    by_rel = {f.rel: f for f in ctx.files}
    root = by_rel.get(ROOT_MODULE)
    if root is None:
        return []  # fixture tree without a worker: nothing to prove
    by_name: Dict[str, SourceFile] = {}
    for f in ctx.files:
        by_name[_module_name(f.rel)] = f

    findings: List[Finding] = []
    seen: Set[str] = set()
    # (module name, chain of rel paths that led here). The package's
    # own __init__ ('' module) executes before any submodule import —
    # spawning the worker runs it first — so it seeds the closure too.
    queue: List[Tuple[str, Tuple[str, ...]]] = [
        (_module_name(ROOT_MODULE), ()), ("", ())]
    while queue:
        name, chain = queue.pop()
        if name in seen:
            continue
        seen.add(name)
        sf = by_name.get(name)
        if sf is None:
            continue
        all_levels = sf.rel == ROOT_MODULE
        for node in _iter_imports(sf.tree, all_levels):
            for target, lineno in _resolve(name, sf.rel, node, by_name):
                top = target.split(".")[0]
                if top in FORBIDDEN:
                    via = " -> ".join(chain + (sf.rel,)) if chain else sf.rel
                    findings.append(Finding(
                        check="jax-import", file=sf.rel, line=lineno,
                        message=(f"'{target}' import reachable from the "
                                 f"encode worker (chain: {via}); "
                                 f"workers must stay free of torch and JAX")))
                elif target in by_name and target not in seen:
                    queue.append((target, chain + (sf.rel,)))
    return findings
