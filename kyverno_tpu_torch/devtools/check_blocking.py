# Copied from kyverno_tpu/devtools/check_blocking.py, with the port's
# host wait on the card (``synchronize``) beside JAX's.
"""blocking-under-lock: no sleeps/IO/dispatch inside a held lock.

A lock in a hot-path module serializes admission submitters, the
flusher, or the scan drain. A ``time.sleep``, file/pipe IO, a
subprocess, or — worst — a device dispatch (``guarded_launch``)
lexically inside ``with self._lock:`` turns every waiter's latency
into that call's latency. PR reviews caught several of these by hand
(the breaker's spool file-write, the queue's O(depth) walk under the
cv); this makes the class mechanical.

Scope: modules in ``lintcore.HOT_MODULES`` when linting the real
package (every module for fixture trees). ``Condition.wait`` is NOT
flagged — it releases the lock while sleeping; that is its job.
Deliberate exceptions (a rare-path write judged acceptable) go in the
baseline with a justification.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .lintcore import Finding, LintContext, SourceFile

# dotted call chains that block: matched against the rendered func
# expression ('time.sleep', 'subprocess.run', bare 'open', ...)
_BLOCKING_DOTTED = frozenset({
    "time.sleep", "sleep", "open", "os.open", "os.fdopen", "os.read",
    "os.write", "os.fsync", "os.replace", "io.open", "select.select",
    "socket.create_connection", "subprocess.run", "subprocess.Popen",
    "subprocess.check_output", "subprocess.check_call",
    "subprocess.call", "urlopen", "shutil.copyfile", "shutil.move",
})
# attribute leaf names that block regardless of the receiver: the
# device dispatch ladder, host waits on the device (torch.cuda /
# Event / Stream ``synchronize``) and process waits
_BLOCKING_LEAVES = frozenset({
    "guarded_launch", "guarded_complete", "block_until_ready",
    "synchronize",
    "communicate", "wait_for_process",
})


def _dotted(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return None


def _is_blocking(func: ast.expr) -> Optional[str]:
    dotted = _dotted(func)
    if dotted is None:
        return None
    if dotted in _BLOCKING_DOTTED:
        return dotted
    leaf = dotted.rsplit(".", 1)[-1]
    if leaf in _BLOCKING_LEAVES:
        return dotted
    return None


class _Walker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, findings: List[Finding]):
        self.sf, self.findings = sf, findings
        self.held: List[str] = []

    def visit_With(self, node: ast.With) -> None:
        locks: List[str] = []
        for item in node.items:
            d = _dotted(item.context_expr)
            # `with self._lock:` / `with self.cv:` / `with cache._lock:`
            # — any bare attribute/name context manager whose name says
            # lock/cv/mutex/rlock. Heuristic on purpose: `with open(...)`
            # is a Call and never matches.
            if d and any(tok in d.rsplit(".", 1)[-1].lower()
                         for tok in ("lock", "cv", "mutex", "cond")):
                locks.append(d)
        self.held.extend(locks)
        self.generic_visit(node)
        for _ in locks:
            self.held.pop()

    def visit_FunctionDef(self, node) -> None:
        # a nested def's body does not run under the enclosing with —
        # it runs whenever it is CALLED; don't inherit the held set
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            what = _is_blocking(node.func)
            if what is not None:
                self.findings.append(Finding(
                    check="blocking-under-lock", file=self.sf.rel,
                    line=node.lineno,
                    message=(f"blocking call {what}() while holding "
                             f"{self.held[-1]} — waiters on that lock "
                             f"inherit this call's latency")))
        self.generic_visit(node)


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        if not ctx.is_hot(sf.rel):
            continue
        _Walker(sf, findings).visit(sf.tree)
    return findings
