# Copied verbatim from kyverno_tpu/devtools/check_locks.py.
"""guarded-by: annotated shared attributes only move under their lock.

The convention: where a shared attribute is initialized, a trailing
comment names the lock that guards it::

    self._depth = 0            # guarded-by: _lock
    self._flows = {}           # guarded-by: _cv

(a standalone comment on the line directly above the assignment works
too). The checker is intraprocedural and lexical, by design — it
verifies every OTHER ``self.<attr>`` touch in the class happens inside
a ``with self.<lock>:`` block. Escapes, in order of preference:

- helper methods whose name ends in ``_locked`` are the documented
  called-with-lock-held convention and are exempt wholesale;
- ``__init__`` / ``__del__`` construction and teardown happen before
  publication / after the last reader and are exempt;
- a deliberately lock-free read (a racy-but-monotonic stats peek)
  goes in ``lint_baseline.json`` with its one-line justification.

Multiple locks may guard disjoint attr sets in one class; each
annotation names its own lock. An annotation naming a lock attribute
the class never creates is itself a finding (stale annotation).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from .lintcore import Finding, LintContext, SourceFile

_GUARDED = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

EXEMPT_METHODS = ("__init__", "__del__")


def _guard_for_line(sf: SourceFile, lineno: int) -> Optional[str]:
    # trailing comment on the assignment's own line, or a STANDALONE
    # comment on the line directly above (a trailing comment up there
    # belongs to that line's statement, not this one)
    comment = sf.comments.get(lineno)
    if not comment and lineno - 1 in sf.standalone_comments:
        comment = sf.comments.get(lineno - 1)
    if comment:
        m = _GUARDED.search(comment)
        if m:
            return m.group(1)
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _with_locks(node: ast.With) -> Set[str]:
    """Lock attr names a ``with`` statement holds: ``with self._lock:``
    / ``with self._cv:`` items (bare attribute context managers)."""
    out: Set[str] = set()
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr:
            out.add(attr)
    return out


class _MethodWalker(ast.NodeVisitor):
    """Walk one method body tracking lexically held locks. ``aliases``
    maps a lock attr to its whole alias group: a Condition constructed
    over an existing lock (``self._cv = threading.Condition(self._lock)``)
    IS that lock — holding either satisfies guarded-by the other."""

    def __init__(self, sf: SourceFile, cls_name: str, method: str,
                 guarded: Dict[str, str], findings: List[Finding],
                 aliases: Dict[str, Set[str]]):
        self.sf, self.cls_name, self.method = sf, cls_name, method
        self.guarded, self.findings = guarded, findings
        self.aliases = aliases
        self.held: List[str] = []

    def visit_With(self, node: ast.With) -> None:
        locks: List[str] = []
        for name in _with_locks(node):
            locks.extend(self.aliases.get(name, {name}))
        self.held.extend(locks)
        self.generic_visit(node)
        for _ in locks:
            self.held.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass  # a nested class is its own scope

    def visit_FunctionDef(self, node) -> None:
        # a nested def's body runs when CALLED, not where it is defined
        # — a deferred callback defined under the lock but invoked
        # later on another thread must still be flagged, so the body is
        # checked against an EMPTY held set (same rule as
        # check_blocking). A closure genuinely only called under the
        # lock earns a *_locked name or a baseline entry.
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            lock = self.guarded.get(attr)
            if lock is not None and lock not in self.held:
                self.findings.append(Finding(
                    check="guarded-by", file=self.sf.rel, line=node.lineno,
                    message=(f"{self.cls_name}.{attr} is guarded-by "
                             f"{lock} but {self.method}() touches it "
                             f"outside 'with self.{lock}'")))
        self.generic_visit(node)


def _walk_own_scope(cls: ast.ClassDef):
    """Every node of the class EXCLUDING nested ClassDef subtrees — a
    nested class is its own scope, and letting its annotations or attr
    assignments leak into the enclosing class's maps produces false
    findings on the outer class's unrelated attrs (each nested class
    gets its own _check_class pass)."""
    stack: List[ast.AST] = list(cls.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attr names assigned anywhere in the class's own scope — used to
    validate that a guard annotation names something that exists."""
    out: Set[str] = set()
    for node in _walk_own_scope(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    out.add(attr)
    return out


def _lock_aliases(cls: ast.ClassDef) -> Dict[str, Set[str]]:
    """Alias groups from ``self.X = threading.Condition(self.Y)``-shaped
    assignments: holding X means holding Y and vice versa."""
    groups: Dict[str, Set[str]] = {}
    for node in _walk_own_scope(cls):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        attr = _self_attr(node.targets[0])
        if attr is None or not isinstance(node.value, ast.Call):
            continue
        fn = node.value.func
        is_cond = (isinstance(fn, ast.Attribute) and fn.attr == "Condition") \
            or (isinstance(fn, ast.Name) and fn.id == "Condition")
        if not (is_cond and node.value.args):
            continue
        wrapped = _self_attr(node.value.args[0])
        if wrapped is None:
            continue
        group = groups.get(attr, {attr}) | groups.get(wrapped, {wrapped})
        for name in group:
            groups[name] = group
    return groups


def _check_class(sf: SourceFile, cls: ast.ClassDef,
                 findings: List[Finding]) -> None:
    guarded: Dict[str, str] = {}
    for node in _walk_own_scope(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    lock = _guard_for_line(sf, t.lineno)
                    if lock:
                        guarded[attr] = lock
    if not guarded:
        return
    attrs = _lock_attrs(cls)
    for attr, lock in sorted(guarded.items()):
        if lock not in attrs:
            findings.append(Finding(
                check="guarded-by", file=sf.rel, line=cls.lineno,
                message=(f"{cls.name}.{attr} annotated guarded-by {lock} "
                         f"but the class never assigns self.{lock} "
                         f"(stale annotation?)")))
    aliases = _lock_aliases(cls)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name in EXEMPT_METHODS or item.name.endswith("_locked"):
            continue
        walker = _MethodWalker(sf, cls.name, item.name, guarded, findings,
                               aliases)
        for stmt in item.body:
            walker.visit(stmt)


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                _check_class(sf, node, findings)
    return findings
