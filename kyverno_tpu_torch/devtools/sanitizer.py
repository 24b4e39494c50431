# Copied verbatim from kyverno_tpu/devtools/sanitizer.py.
"""Dynamic lock-order sanitizer — deadlock potentials without deadlocks.

Armed via ``KYVERNO_TPU_SANITIZE=1`` (the package ``__init__`` installs
it before any engine module creates a lock), this wraps
``threading.Lock`` / ``RLock`` / ``Condition`` so every lock created
afterwards is instrumented:

- each thread keeps the ordered list of instrumented locks it holds;
- acquiring B while holding A records the edge A->B in a process-wide
  lock-order graph, with compact acquisition stacks for BOTH ends
  captured the first time that edge appears;
- ``report()`` finds cycles in the graph (A->B somewhere, B->A
  elsewhere = a potential deadlock even if the schedule never
  deadlocked this run — the ThreadSanitizer framing: the ORDER
  inversion is the bug, the hang is the unlucky schedule);
- the device-dispatch hook (``tpu/engine.py`` calls
  ``note_device_dispatch()`` when sanitizing) reports any lock held
  across a device dispatch, with the lock's acquisition stack and the
  dispatch stack — a held lock across an XLA call serializes every
  waiter behind device latency.

The chaos suites run under this in ``scripts_lint_gate.sh``; at
process exit the report is written to ``KYVERNO_TPU_SANITIZE_REPORT``
(JSON) and cycles are summarized on stderr.

Instrumentation is by construction site: wrapping the factories means
stdlib locks created after install (queue internals, condition
internals) are covered too — more coverage, same graph. Uninstall
restores the factories; locks already created stay instrumented but
harmless.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

ENABLED = False

_ORIG: Dict[str, Any] = {}
_GRAPH_LOCK = None          # a RAW lock guarding the structures below
_EDGES: Dict[Tuple[int, int], dict] = {}     # (a_id, b_id) -> edge info
_LOCK_SITES: Dict[int, str] = {}             # lock id -> creation site
_DISPATCH_VIOLATIONS: List[dict] = []
_NEXT_ID = [0]
_TLS = threading.local()


def _compact_stack(skip: int = 2, depth: int = 8) -> List[str]:
    """file:line frames walking out of the sanitizer — cheap enough to
    take on every acquire (no source lookup, no traceback objects)."""
    out: List[str] = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return out
    while f is not None and len(out) < depth:
        code = f.f_code
        fn = code.co_filename
        if "devtools/sanitizer" not in fn.replace(os.sep, "/"):
            out.append(f"{fn}:{f.f_lineno} in {code.co_name}")
        f = f.f_back
    return out


def _held() -> List[Tuple[Any, List[str]]]:
    """This thread's held instrumented locks: (lock, acquire stack),
    innermost last. Re-entrant holds appear once."""
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def _note_acquired(lock: Any) -> None:
    held = _held()
    for entry in held:
        if entry[0] is lock:          # re-entrant: no new edge
            entry[2] += 1
            return
    stack = _compact_stack()
    for prior, prior_stack, _count in held:
        key = (prior._san_id, lock._san_id)
        if key not in _EDGES:
            with _GRAPH_LOCK:
                if key not in _EDGES:
                    _EDGES[key] = {
                        "from": prior._san_id, "to": lock._san_id,
                        "from_site": _LOCK_SITES.get(prior._san_id, "?"),
                        "to_site": _LOCK_SITES.get(lock._san_id, "?"),
                        "from_stack": list(prior_stack),
                        "to_stack": stack,
                        "thread": threading.current_thread().name,
                    }
    held.append([lock, stack, 1])


def _note_released(lock: Any) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][2] -= 1
            if held[i][2] <= 0:
                del held[i]
            return


def _note_released_fully(lock: Any) -> int:
    """Drop the lock from the held set regardless of recursion depth;
    returns the depth dropped so _acquire_restore can reinstate it."""
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            count = held[i][2]
            del held[i]
            return count
    return 0


class _SanLockBase:
    _reentrant = False

    def __init__(self, inner):
        self._inner = inner
        with _GRAPH_LOCK:
            _NEXT_ID[0] += 1
            self._san_id = _NEXT_ID[0]
        site = _compact_stack(skip=2, depth=3)
        _LOCK_SITES[self._san_id] = site[0] if site else "?"

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self)
        return got

    def release(self):
        _note_released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # stdlib thread machinery reinitializes its locks post-fork;
        # the child is single-threaded so held-tracking is moot
        self._inner._at_fork_reinit()

    def __repr__(self):
        return (f"<sanitized {'RLock' if self._reentrant else 'Lock'} "
                f"#{self._san_id} at {_LOCK_SITES.get(self._san_id)}>")


class SanLock(_SanLockBase):
    pass


class SanRLock(_SanLockBase):
    _reentrant = True

    # threading.Condition uses these when present so cv.wait() on an
    # RLock releases ALL recursion levels; tracking must mirror that
    # or the held-set claims the lock is held through the wait. The
    # recursion DEPTH rides the saved state: restoring at depth>1 with
    # a fresh count of 1 would let the first post-wait release drop
    # the lock from the held set while it is still actually held —
    # hiding every order edge in that window.
    def _release_save(self):
        count = _note_released_fully(self)
        return (self._inner._release_save(), count)

    def _acquire_restore(self, state):
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        _note_acquired(self)
        if count > 1:
            held = _held()
            for entry in held:
                if entry[0] is self:
                    entry[2] = count
                    break

    def _is_owned(self):
        return self._inner._is_owned()

    def locked(self):
        # best effort (RLock has no true locked()): owned-by-me is the
        # only answer available without perturbing the lock
        return self._inner._is_owned()


def _make_lock():
    return SanLock(_ORIG["allocate"]())


def _make_rlock():
    return SanRLock(_ORIG["RLock"]())


def _make_condition(lock=None):
    if lock is None:
        lock = _make_rlock()
    return _ORIG["Condition"](lock)


def install() -> None:
    """Wrap the threading lock factories. Idempotent."""
    global ENABLED, _GRAPH_LOCK
    if ENABLED:
        return
    _GRAPH_LOCK = threading._allocate_lock()
    _ORIG["Lock"] = threading.Lock
    _ORIG["RLock"] = threading.RLock
    _ORIG["Condition"] = threading.Condition
    _ORIG["allocate"] = threading._allocate_lock
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    ENABLED = True


def uninstall() -> None:
    global ENABLED
    if not ENABLED:
        return
    threading.Lock = _ORIG["Lock"]
    threading.RLock = _ORIG["RLock"]
    threading.Condition = _ORIG["Condition"]
    ENABLED = False


def reset() -> None:
    """Forget recorded edges/violations (tests)."""
    with (_GRAPH_LOCK or threading._allocate_lock()):
        _EDGES.clear()
        _DISPATCH_VIOLATIONS.clear()
        _DISPATCH_ALLOWED.clear()


# lock CREATION sites (substring match) whose holds across a device
# dispatch are by-design and reported separately instead of as
# violations. Default: the lifecycle manager's compile lock — the
# compile-ahead path intentionally warms XLA under it; serving paths
# read the active version lock-free and never wait on it.
_DEFAULT_ALLOWED_DISPATCH = ("lifecycle/manager.py",)
_ALLOWED_DISPATCH = tuple(
    s for s in os.environ.get(
        "KYVERNO_TPU_SANITIZE_ALLOW_DISPATCH",
        ",".join(_DEFAULT_ALLOWED_DISPATCH)).split(",") if s)
_DISPATCH_ALLOWED: List[dict] = []


def note_device_dispatch(site: str = "tpu.dispatch") -> None:
    """Called by the engine at device-dispatch entry when sanitizing:
    any instrumented lock held RIGHT NOW serializes its waiters behind
    device latency. Holds whose lock was created at an allowlisted site
    are recorded under ``dispatch_allowed`` (visible, non-failing)."""
    held = _held()
    if not held:
        return
    stack = _compact_stack()
    locks = [{"lock_site": _LOCK_SITES.get(lk._san_id, "?"),
              "acquire_stack": list(st)}
             for lk, st, _c in held]
    allowed = all(any(pat in l["lock_site"].replace(os.sep, "/")
                      for pat in _ALLOWED_DISPATCH) for l in locks)
    rec = {
        "site": site,
        "thread": threading.current_thread().name,
        "locks": locks,
        "dispatch_stack": stack,
    }
    with _GRAPH_LOCK:
        (_DISPATCH_ALLOWED if allowed else _DISPATCH_VIOLATIONS).append(rec)


def _find_cycles(edges: Dict[Tuple[int, int], dict]) -> List[List[dict]]:
    """Cycles in the lock-order digraph, reported as edge lists.
    Tarjan SCCs; any SCC with >1 node (or a self-loop) contains at
    least one cycle — we report the SCC's edges, which carry both
    acquisition stacks."""
    graph: Dict[int, List[int]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Dict[int, bool] = {}
    stack: List[int] = []
    counter = [0]
    sccs: List[List[int]] = []

    def strongconnect(v: int) -> None:
        # iterative Tarjan: chaos-suite graphs are small but deep
        # recursion limits are not worth trusting
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            advanced = False
            for i in range(pi, len(graph[node])):
                w = graph[node][i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in list(graph):
        if v not in index:
            strongconnect(v)
    cycles: List[List[dict]] = []
    for scc in sccs:
        members = set(scc)
        if len(scc) > 1:
            cyc = [info for (a, b), info in edges.items()
                   if a in members and b in members]
            cycles.append(cyc)
    return cycles


def report() -> dict:
    with (_GRAPH_LOCK or threading._allocate_lock()):
        edges = dict(_EDGES)
        dispatch = list(_DISPATCH_VIOLATIONS)
        allowed = list(_DISPATCH_ALLOWED)
    cycles = _find_cycles(edges)
    return {
        "enabled": ENABLED,
        "locks_tracked": _NEXT_ID[0],
        "edges": len(edges),
        "cycles": cycles,
        "dispatch_violations": dispatch,
        "dispatch_allowed": allowed,
    }


def _atexit_report() -> None:
    rep = report()
    path = os.environ.get("KYVERNO_TPU_SANITIZE_REPORT")
    if path:
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(rep, f, indent=1)
        except OSError as e:
            print(f"[sanitizer] cannot write report {path}: {e}",
                  file=sys.stderr)
    n_cyc = len(rep["cycles"])
    n_disp = len(rep["dispatch_violations"])
    if n_cyc or n_disp:
        print(f"[sanitizer] LOCK-ORDER VIOLATIONS: {n_cyc} cycle(s), "
              f"{n_disp} lock-held-across-dispatch", file=sys.stderr)
        for cyc in rep["cycles"]:
            print("[sanitizer] cycle:", file=sys.stderr)
            for e in cyc:
                print(f"  {e['from_site']} -> {e['to_site']} "
                      f"(thread {e['thread']})", file=sys.stderr)
                for line in e["to_stack"][:4]:
                    print(f"      {line}", file=sys.stderr)
    else:
        print(f"[sanitizer] clean: {rep['locks_tracked']} locks, "
              f"{rep['edges']} order edges, 0 cycles", file=sys.stderr)


def install_from_env() -> bool:
    """Package-init hook: arm when KYVERNO_TPU_SANITIZE=1."""
    if os.environ.get("KYVERNO_TPU_SANITIZE", "") not in ("1", "true", "on"):
        return False
    install()
    atexit.register(_atexit_report)
    return True
