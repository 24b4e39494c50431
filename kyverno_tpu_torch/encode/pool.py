# Copied from kyverno_tpu/encode/pool.py (spawns the port's worker; the
# worker state also reports torch).
"""EncoderPool — a supervised multiprocess device feed.

The device evaluates billions of rule cells per second; a single
Python encoder feeds it hundreds of resources per second
(ROADMAP item 1, measured by ``kyverno_tpu_feed_starvation_ratio``).
Scaling the feed means encoder *processes* — and a process pool in the
serving path needs the same robustness ladder the device plane got:

- **supervision** — every worker is a freshly spawned interpreter
  (encode/worker.py) under per-chunk deadlines and heartbeats: a
  crashed worker (OOM kill, segfaulting extension, injected ``crash``
  fault) is detected by pipe EOF, a hung one (C-level loop, injected
  ``delay`` fault) by its chunk deadline or silent heartbeat, and both
  are SIGKILLed and restarted with capped jittered backoff
  (resilience/retry.py RetryPolicy computes the delays);
- **retry** — a chunk in flight on a dead worker is retried ONCE on a
  healthy worker (transient death: the chunk was innocent);
- **poison isolation** — a chunk that kills two workers is bisected,
  probe-encoding halves on sacrificial workers until the single
  resource that reproduces the crash is found; the chunk re-encodes
  with the poison replaced by an empty placeholder and the caller
  routes the poison column through the existing encode-failure
  quarantine (scalar completion, per-rule ERROR — the scan never
  aborts);
- **breaker** — K consecutive pool-INFRA failures (dispatch faults,
  chunks that fail even after retry + bisect, stop-mid-chunk) open an
  ``encode_pool`` circuit breaker: callers bypass the pool to the
  in-process encoder (bit-identical, just serial) until a half-open
  probe chunk restores it. Worker-REPORTED encode errors are content
  failures, not infra — they fall back to the existing per-resource
  quarantine ladder and never trip the breaker;
- **hygiene** — ``stop()`` drains in-flight chunks, joins workers with
  a timeout, and escalates to SIGKILL; an atexit guard reaps whatever
  a crashed parent leaves behind. Zero orphan children, asserted by
  test_encode_pool.py.

``--encode-workers 0`` (the default) never constructs a pool: today's
in-process path runs byte-for-byte.
"""

from __future__ import annotations

import atexit
import os
import pickle
import random
import subprocess
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from ..observability.tracing import global_tracer
from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import SITE_ENCODE_POOL_DISPATCH, global_faults
from ..resilience.retry import RetryPolicy
from .tasks import profile_spec  # noqa: F401  (re-export for callers)

ENV_WORKERS = "KYVERNO_TPU_ENCODE_WORKERS"


class PoolBypassed(RuntimeError):
    """The encode-pool breaker is OPEN — encode in-process instead."""


class PoolInfraError(RuntimeError):
    """The pool infrastructure failed this chunk (counts toward the
    breaker) — encode in-process instead."""


class WorkerEncodeError(RuntimeError):
    """A worker *reported* an encode failure (hostile content, injected
    raise). Content problem, not infrastructure: the caller falls back
    to the existing quarantining ladder; the breaker is untouched."""


# capped jittered backoff between restarts of the same worker slot —
# a crash-looping worker must not busy-spin the supervisor
RESTART_BACKOFF = RetryPolicy(max_attempts=1, base_delay_s=0.05,
                              max_delay_s=2.0, multiplier=2.0, jitter=0.5,
                              deadline_s=None)


class PoolConfig:
    def __init__(
        self,
        chunk_deadline_s: float = 30.0,
        hb_interval_s: float = 0.25,
        hb_timeout_s: float = 5.0,
        drain_timeout_s: float = 30.0,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 10.0,
        restart_backoff: RetryPolicy = RESTART_BACKOFF,
    ):
        self.chunk_deadline_s = chunk_deadline_s
        self.hb_interval_s = hb_interval_s
        self.hb_timeout_s = hb_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.restart_backoff = restart_backoff


class _Chunk:
    __slots__ = ("task_id", "profile_id", "kind", "payload", "retries_left",
                 "crashes", "probe", "event", "outcome", "result", "error",
                 "started", "submitted_at")

    def __init__(self, task_id, profile_id, kind, payload, retries, probe):
        self.task_id = task_id
        self.profile_id = profile_id
        self.kind = kind
        self.payload = payload
        self.retries_left = retries
        self.crashes = 0
        self.probe = probe
        self.event = threading.Event()
        self.outcome: Optional[str] = None  # ok | err | crashed | stopped
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.started: Optional[float] = None
        self.submitted_at = time.monotonic()


class _Worker:
    __slots__ = ("idx", "proc", "wlock", "generation", "ready", "dead",
                 "busy", "last_seen", "consecutive_restarts", "restart_due",
                 "profiles_sent", "torch_loaded", "jax_loaded", "pid")

    def __init__(self, idx: int):
        self.idx = idx
        self.proc: Optional[subprocess.Popen] = None
        self.wlock = threading.Lock()
        self.generation = 0
        self.ready = False
        self.dead = True
        self.busy: Optional[_Chunk] = None
        self.last_seen = 0.0
        self.consecutive_restarts = 0
        self.restart_due: Optional[float] = None
        self.profiles_sent: set = set()
        self.torch_loaded: Optional[bool] = None
        self.jax_loaded: Optional[bool] = None
        self.pid: Optional[int] = None


# every live pool, for the interpreter-exit guard: whatever a dying
# parent leaves running is reaped here — workers must never orphan
_LIVE_POOLS: "weakref.WeakSet[EncoderPool]" = weakref.WeakSet()
_ATEXIT_REGISTERED = False


def _atexit_reap() -> None:
    for pool in list(_LIVE_POOLS):
        try:
            pool._kill_all_workers()
        except Exception:
            pass


class EncoderPool:
    def __init__(self, workers: int, config: Optional[PoolConfig] = None,
                 worker_faults: Optional[str] = None, metrics=None,
                 breaker: Optional[CircuitBreaker] = None):
        self.n_workers = max(1, int(workers))
        self.cfg = config or PoolConfig()
        if metrics is None:
            from ..observability.metrics import global_registry

            metrics = global_registry
        self.metrics = metrics
        self.breaker = breaker or CircuitBreaker(
            name="encode_pool",
            failure_threshold=self.cfg.breaker_threshold,
            reset_timeout_s=self.cfg.breaker_reset_s,
            metrics=metrics)
        # fault spec shipped to workers at init (and after restart) so
        # chaos tests arm worker-side sites without env plumbing; the
        # default inherits the process's own chaos knob
        self.worker_faults = (worker_faults if worker_faults is not None
                              else os.environ.get("KYVERNO_TPU_FAULTS", ""))
        self._lock = threading.RLock()
        self._workers: List[_Worker] = [_Worker(i)  # guarded-by: _lock
                                        for i in range(self.n_workers)]
        self._pending: "deque[_Chunk]" = deque()    # guarded-by: _lock
        self._chunks: Dict[int, _Chunk] = {}        # guarded-by: _lock
        self._profiles: Dict[int, Dict[str, Any]] = {}  # guarded-by: _lock
        self._task_seq = 0                          # guarded-by: _lock
        self._profile_seq = 0                       # guarded-by: _lock
        self._rng = random.Random(0xfeed)           # guarded-by: _lock
        self._started = False                       # guarded-by: _lock
        self._stopping = False                      # guarded-by: _lock
        self.restarts = 0
        self._monitor: Optional[threading.Thread] = None

    # -- lifecycle

    def start(self) -> "EncoderPool":
        global _ATEXIT_REGISTERED
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            for slot in self._workers:
                self._spawn_locked(slot)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="encode-pool-mon")
        self._monitor.start()
        _LIVE_POOLS.add(self)
        if not _ATEXIT_REGISTERED:
            atexit.register(_atexit_reap)
            _ATEXIT_REGISTERED = True
        return self

    @property
    def running(self) -> bool:
        with self._lock:
            return self._started and not self._stopping

    def wait_ready(self, timeout: float = 20.0) -> int:
        """Block until every worker has completed the ready handshake
        (or the timeout lapses); returns the number alive."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.workers_alive() >= self.n_workers:
                break
            time.sleep(0.01)
        return self.workers_alive()

    def workers_alive(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers
                       if w.ready and not w.dead
                       and w.proc is not None and w.proc.poll() is None)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Drain in-flight chunks (bounded), then shut workers down:
        cooperative stop message -> join with timeout -> SIGKILL. No
        child survives this call; callers still blocked in
        await_result resolve with a pool-stopped infra error (their
        in-process fallback answers — shutdown degrades, never hangs)."""
        timeout = self.cfg.drain_timeout_s if timeout is None else timeout
        with self._lock:
            if not self._started:
                return
            self._stopping = True
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._chunks and not self._pending:
                        break
                time.sleep(0.02)
        with self._lock:
            # whatever did not drain resolves NOW — waiters must not
            # block on workers that are about to die
            self._pending.clear()
            for chunk in list(self._chunks.values()):
                self._resolve_locked(chunk, "stopped",
                                     error="encoder pool stopped")
            for slot in self._workers:
                slot.restart_due = None
            procs = [(w, w.proc) for w in self._workers if w.proc is not None]
        # cooperative stop is BEST-EFFORT and must never block shutdown:
        # a wedged worker can leave its pipe full (or its wlock held by
        # a blocked _send_raw), so the sends run in disposable daemon
        # threads — the SIGKILL escalation below breaks the pipe, which
        # unblocks any stuck sender with EPIPE
        def _coop_stop(slot, proc):
            try:
                with slot.wlock:
                    pickle.dump(("stop",), proc.stdin,
                                protocol=pickle.HIGHEST_PROTOCOL)
                    proc.stdin.flush()
            except Exception:
                pass

        senders = []
        for slot, proc in procs:
            t = threading.Thread(target=_coop_stop, args=(slot, proc),
                                 daemon=True)
            t.start()
            senders.append(t)
        for t in senders:
            t.join(timeout=0.5)
        deadline = time.monotonic() + 5.0
        for slot, proc in procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except Exception:
                    pass
            try:
                proc.stdin.close()
            except Exception:
                pass
            with self._lock:
                slot.dead = True
                slot.ready = False
        with self._lock:
            self._started = False
        self._publish_gauges()
        _LIVE_POOLS.discard(self)

    def _kill_all_workers(self) -> None:
        with self._lock:
            procs = [w.proc for w in self._workers if w.proc is not None]
            self._stopping = True
        for proc in procs:
            try:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=2.0)
            except Exception:
                pass

    def worker_pids(self) -> List[int]:
        with self._lock:
            return [w.proc.pid for w in self._workers
                    if w.proc is not None and w.proc.poll() is None]

    # -- profiles

    def register_profile(self, spec: Dict[str, Any]) -> int:
        """Register a per-compiled-set encode profile; returns its id.
        Profiles ship to each worker once (lazily, and again after a
        restart) so steady-state tasks carry only chunk data."""
        with self._lock:
            self._profile_seq += 1
            pid = self._profile_seq
            self._profiles[pid] = spec
            return pid

    def release_profile(self, pid: int) -> None:
        """Drop a (scan-scoped) profile: parent-side registry entry and
        best-effort worker-side eviction — long-lived pools must not
        accumulate one ns-label snapshot per scan tick forever."""
        with self._lock:
            self._profiles.pop(pid, None)
            targets = [(w, w.proc) for w in self._workers
                       if pid in w.profiles_sent and not w.dead
                       and w.proc is not None]
            for w, _ in targets:
                w.profiles_sent.discard(pid)
        for slot, proc in targets:
            self._send(slot, proc, ("unprofile", pid))

    # -- the public dispatch ladder

    def submit(self, profile_id: int, kind: str,
               payload: Dict[str, Any]) -> _Chunk:
        """Breaker-gated async dispatch: returns an in-flight handle for
        await_result. Raises PoolBypassed when the breaker is open,
        PoolInfraError when dispatch itself fails — in both cases the
        caller encodes in-process."""
        if not self.breaker.allow():
            self._chunk_metric("bypass")
            raise PoolBypassed("encode-pool breaker is open")
        try:
            global_faults.fire(SITE_ENCODE_POOL_DISPATCH)
        except Exception as e:
            self._infra_failure(f"dispatch fault: {e}")
        with self._lock:
            if not self._started or self._stopping:
                self._infra_failure_locked("pool is not running")
        return self._enqueue(profile_id, kind, payload, retries=1,
                             probe=False)

    def await_result(self, chunk: _Chunk) -> Dict[str, Any]:
        """Block for a submitted chunk. Returns the worker's result
        (with a ``poison`` index list when the crash-bisect ladder ran)
        or raises WorkerEncodeError / PoolInfraError."""
        self._await(chunk)
        if chunk.outcome == "ok":
            self.breaker.record_success()
            self._chunk_metric("retried_ok" if chunk.crashes else "ok")
            return chunk.result
        if chunk.outcome == "err":
            # the pool did its job — the CONTENT failed; same failure
            # class as an in-process encode raise (quarantine ladder)
            self.breaker.record_success()
            self._chunk_metric("encode_error")
            raise WorkerEncodeError(chunk.error or "worker encode error")
        if chunk.outcome == "crashed":
            return self._recover_poison(chunk)
        self._infra_failure(chunk.error or "pool stopped mid-chunk")

    def encode_chunk(self, profile_id: int, kind: str,
                     payload: Dict[str, Any]) -> Dict[str, Any]:
        """submit + await_result in one blocking call (the admission
        rows path uses this)."""
        return self.await_result(self.submit(profile_id, kind, payload))

    # -- crash recovery: retry happened in the supervisor; two dead
    # workers later the chunk lands here, in the waiting caller's
    # thread, which owns the bisect

    def _recover_poison(self, chunk: _Chunk) -> Dict[str, Any]:
        resources = (chunk.payload or {}).get("resources") or []
        if not resources:
            self._infra_failure("chunk with no resources killed 2 workers")
        span = global_tracer.start_span(
            "encode_pool.poison_bisect", chunk_resources=len(resources),
            kind=chunk.kind)
        try:
            try:
                poisons = self._bisect(chunk.profile_id, chunk.kind,
                                       chunk.payload, 0, len(resources))
            except (PoolBypassed, PoolInfraError):
                raise
            except Exception as e:  # noqa: BLE001
                self._infra_failure(f"poison bisect failed: {e}")
            if not poisons:
                # both halves encode alone but the whole chunk kills
                # workers: no single culprit — that is an infra-class
                # failure, not a content one
                self._infra_failure(
                    "chunk kills workers but no single resource reproduces")
            pset = set(poisons)
            span.attributes["poison"] = sorted(pset)
            sanitized = dict(chunk.payload)
            sanitized["resources"] = [
                ({} if i in pset else r) for i, r in enumerate(resources)]
            redo = self._enqueue(chunk.profile_id, chunk.kind, sanitized,
                                 retries=1, probe=False)
            self._await(redo)
            if redo.outcome == "err":
                # the sanitized chunk still has hostile CONTENT (a
                # second bad resource that raises rather than crashes):
                # same class as any worker-reported encode error — the
                # in-process quarantine ladder owns it, the breaker
                # must not trip for it
                self.breaker.record_success()
                self._chunk_metric("encode_error")
                raise WorkerEncodeError(redo.error or "worker encode error")
            if redo.outcome != "ok":
                self._infra_failure(
                    f"re-encode after poison isolation failed "
                    f"({redo.outcome}: {redo.error})")
            self.breaker.record_success()
            self._chunk_metric("poison")
            global_tracer.add_event(
                "encode_poison_quarantined", resources=len(pset),
                indices=sorted(pset)[:16])
            result = dict(redo.result)
            result["poison"] = sorted(pset)
            return result
        except BaseException as e:
            span.set_status("error", f"{type(e).__name__}: {e}")
            raise
        finally:
            global_tracer.end_span(span)

    def _bisect(self, profile_id: int, kind: str, payload: Dict[str, Any],
                lo: int, hi: int) -> List[int]:
        """Probe-encode halves of [lo, hi) on sacrificial workers until
        single resources reproduce the crash. Probes never retry — a
        probe crash IS the signal."""
        if hi - lo <= 1:
            return [lo]
        mid = (lo + hi) // 2
        poisons: List[int] = []
        for a, b in ((lo, mid), (mid, hi)):
            sub = self._slice_payload(payload, a, b)
            probe = self._enqueue(profile_id, kind, sub, retries=0,
                                  probe=True)
            self._await(probe)
            if probe.outcome == "crashed":
                poisons.extend(
                    a + p for p in self._bisect(profile_id, kind, sub,
                                                0, b - a))
            elif probe.outcome not in ("ok", "err"):
                raise PoolInfraError(
                    f"bisect probe did not complete ({probe.outcome})")
        return poisons

    @staticmethod
    def _slice_payload(payload: Dict[str, Any], a: int, b: int) -> Dict[str, Any]:
        out = dict(payload)
        out["resources"] = list(payload["resources"][a:b])
        ops = payload.get("operations")
        if ops:
            out["operations"] = list(ops[a:b])
        return out

    # -- internals

    def _enqueue(self, profile_id: int, kind: str, payload: Dict[str, Any],
                 retries: int, probe: bool) -> _Chunk:
        with self._lock:
            if not self._started or self._stopping:
                self._infra_failure_locked("pool is not running")
            self._task_seq += 1
            chunk = _Chunk(self._task_seq, profile_id, kind, payload,
                           retries, probe)
            self._chunks[chunk.task_id] = chunk
            self._pending.append(chunk)
        self._dispatch()
        return chunk

    def _await(self, chunk: _Chunk) -> None:
        # the supervisor's deadline reaper resolves every chunk; this
        # caller-side timeout is a defensive backstop (restart backoff
        # + a retry + bisect rounds all fit comfortably inside it)
        budget = self.cfg.chunk_deadline_s * 3 + 30.0
        if not chunk.event.wait(budget):
            with self._lock:
                try:
                    self._pending.remove(chunk)
                except ValueError:
                    pass
                self._resolve_locked(chunk, "stopped",
                                     error="await timeout (supervisor wedged)")

    def _infra_failure(self, msg: str) -> None:
        self.breaker.record_failure()
        self._chunk_metric("infra_fail")
        raise PoolInfraError(msg)

    def _infra_failure_locked(self, msg: str) -> None:
        # breaker + metric calls are lock-free; safe under self._lock
        self.breaker.record_failure()
        self._chunk_metric("infra_fail")
        raise PoolInfraError(msg)

    def _chunk_metric(self, outcome: str) -> None:
        try:
            self.metrics.encode_pool_chunks.inc({"outcome": outcome})
        except Exception:
            pass

    def _resolve_locked(self, chunk: _Chunk, outcome: str,
                        result: Optional[Dict[str, Any]] = None,
                        error: Optional[str] = None) -> None:
        if chunk.outcome is not None:
            return
        chunk.outcome = outcome
        chunk.result = result
        chunk.error = error
        self._chunks.pop(chunk.task_id, None)
        chunk.event.set()

    # -- worker lifecycle

    def _spawn_locked(self, slot: _Worker) -> None:
        import kyverno_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(kyverno_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        stderr = (None if env.get("KYVERNO_TPU_ENCODE_POOL_DEBUG")
                  else subprocess.DEVNULL)
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "kyverno_tpu_torch.encode.worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=stderr, env=env)
        except Exception:
            # spawn itself failed (fd pressure, dead interpreter):
            # schedule another attempt through the same backoff ladder
            # — counting the failure, or spawn loops would retry at
            # the minimum delay forever and aggravate the fd pressure
            # that caused them
            slot.consecutive_restarts += 1
            slot.restart_due = (time.monotonic()
                                + self._restart_delay_locked(slot))
            return
        slot.proc = proc
        slot.pid = proc.pid
        slot.generation += 1
        slot.ready = False
        slot.dead = False
        slot.busy = None
        slot.restart_due = None
        slot.last_seen = time.monotonic()
        slot.profiles_sent = set()
        gen = slot.generation
        threading.Thread(target=self._read_loop, args=(slot, proc, gen),
                         daemon=True,
                         name=f"encode-pool-r{slot.idx}").start()
        # init is fire-and-forget: a worker that dies before reading it
        # is caught by the reader's EOF
        threading.Thread(
            target=self._send, daemon=True,
            args=(slot, proc,
                  ("init", {"faults": self.worker_faults,
                            "hb_interval": self.cfg.hb_interval_s}))).start()

    def _restart_delay_locked(self, slot: _Worker) -> float:
        return self.cfg.restart_backoff.delay(
            min(slot.consecutive_restarts, 8), self._rng)

    def _send(self, slot: _Worker, proc, msg) -> bool:
        try:
            with slot.wlock:
                pickle.dump(msg, proc.stdin,
                            protocol=pickle.HIGHEST_PROTOCOL)
                proc.stdin.flush()
            return True
        except Exception:
            return False  # reader EOF handles the death

    def _send_raw(self, slot: _Worker, proc, data: bytes) -> bool:
        try:
            with slot.wlock:
                proc.stdin.write(data)
                proc.stdin.flush()
            return True
        except Exception:
            return False

    def _read_loop(self, slot: _Worker, proc, gen: int) -> None:
        f = proc.stdout
        while True:
            try:
                msg = pickle.load(f)
            except Exception:
                break
            self._on_message(slot, gen, msg)
        self._on_worker_dead(slot, gen)

    def _on_message(self, slot: _Worker, gen: int, msg) -> None:
        op = msg[0]
        with self._lock:
            if slot.generation != gen:
                return  # stale reader from a replaced worker
            slot.last_seen = time.monotonic()
            if op == "hb":
                return
            if op == "ready":
                slot.ready = True
                slot.torch_loaded = bool(msg[1].get("torch_loaded"))
                slot.jax_loaded = bool(msg[1].get("jax_loaded"))
            elif op in ("ok", "err"):
                chunk = slot.busy
                slot.busy = None
                slot.consecutive_restarts = 0
                if chunk is not None and chunk.task_id == msg[1]:
                    if op == "ok":
                        result = msg[2]
                        result["encode_s"] = float(msg[3])
                        self._resolve_locked(chunk, "ok", result=result)
                    else:
                        self._resolve_locked(chunk, "err", error=msg[2])
        self._publish_gauges()
        self._dispatch()

    def _on_worker_dead(self, slot: _Worker, gen: int) -> None:
        with self._lock:
            if slot.generation != gen or slot.dead:
                return
            slot.dead = True
            slot.ready = False
            chunk = slot.busy
            slot.busy = None
            proc = slot.proc
            stopping = self._stopping
            if not stopping:
                self.restarts += 1
                slot.consecutive_restarts += 1
                slot.restart_due = (time.monotonic()
                                    + self._restart_delay_locked(slot))
                try:
                    self.metrics.encode_pool_restarts.inc()
                except Exception:
                    pass
                global_tracer.add_event(
                    "encode_worker_died", worker=slot.idx,
                    pid=slot.pid, consecutive=slot.consecutive_restarts,
                    had_chunk=chunk is not None)
                try:
                    from ..observability.log import global_oplog

                    global_oplog.emit(
                        "encode_worker_died", level="warn",
                        worker=slot.idx, pid=slot.pid,
                        consecutive=slot.consecutive_restarts,
                        had_chunk=chunk is not None)
                except Exception:
                    pass
            if chunk is not None:
                self._crashed_chunk_locked(chunk)
        if proc is not None:
            try:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=5.0)
            except Exception:
                pass
        self._publish_gauges()
        self._dispatch()

    def _crashed_chunk_locked(self, chunk: _Chunk) -> None:
        chunk.crashes += 1
        if self._stopping:
            self._resolve_locked(chunk, "stopped",
                                 error="pool stopping during chunk")
            return
        if chunk.retries_left > 0 and not chunk.probe:
            chunk.retries_left -= 1
            chunk.started = None
            self._pending.appendleft(chunk)  # retry ONCE, next healthy worker
            return
        self._resolve_locked(chunk, "crashed",
                             error=f"worker died {chunk.crashes}x on chunk")

    # -- dispatch + monitor

    def _dispatch(self) -> None:
        while True:
            with self._lock:
                if self._stopping or not self._pending:
                    break
                slot = next((w for w in self._workers
                             if w.ready and not w.dead and w.busy is None),
                            None)
                if slot is None:
                    break
                chunk = self._pending.popleft()
                slot.busy = chunk
                chunk.started = time.monotonic()
                proc = slot.proc
                need_profile = None
                if chunk.profile_id not in slot.profiles_sent:
                    need_profile = self._profiles.get(chunk.profile_id)
                    slot.profiles_sent.add(chunk.profile_id)
            # pipe writes happen OUTSIDE the pool lock: a wedged worker
            # that stops reading must stall only its own dispatch (the
            # deadline reaper frees it), never the whole supervisor.
            # The profile goes first so profiles_sent stays truthful
            # even when the TASK below turns out unpicklable.
            ok = True
            if need_profile is not None:
                ok = self._send(slot, proc,
                                ("profile", chunk.profile_id, need_profile))
            if ok:
                # an unpicklable chunk is a CONTENT failure, not a
                # dying worker: resolve it as an encode error NOW (the
                # caller's in-process quarantine ladder owns it)
                # instead of letting the deadline reaper kill an
                # innocent worker
                try:
                    task_bytes = pickle.dumps(
                        ("task", chunk.task_id, chunk.profile_id,
                         chunk.kind, chunk.payload),
                        protocol=pickle.HIGHEST_PROTOCOL)
                except Exception as e:  # noqa: BLE001
                    with self._lock:
                        if slot.busy is chunk:
                            slot.busy = None
                        self._resolve_locked(
                            chunk, "err", error=f"unpicklable chunk: {e}")
                    continue
                ok = self._send_raw(slot, proc, task_bytes)
            # a failed send means the worker is dead or dying — the
            # reader's EOF path reaps it and requeues the chunk
        self._publish_gauges()

    def _monitor_loop(self) -> None:
        tick = max(0.05, min(0.2, self.cfg.hb_interval_s))
        while True:
            time.sleep(tick)
            now = time.monotonic()
            to_kill: List[subprocess.Popen] = []
            with self._lock:
                if not self._started and self._stopping:
                    return
                stopping = self._stopping
                for slot in self._workers:
                    if slot.dead:
                        # no NEW workers once stopping — but the kill
                        # ladder below stays armed so a hung worker
                        # cannot outlive the drain window
                        if (not stopping
                                and slot.restart_due is not None
                                and now >= slot.restart_due):
                            self._spawn_locked(slot)
                        continue
                    proc = slot.proc
                    chunk = slot.busy
                    if (chunk is not None and chunk.started is not None
                            and now - chunk.started
                            > self.cfg.chunk_deadline_s):
                        # hung mid-chunk: deadline kill; the reader's
                        # EOF turns this into the crash/retry ladder
                        global_tracer.add_event(
                            "encode_worker_deadline_kill", worker=slot.idx,
                            chunk=chunk.task_id,
                            deadline_s=self.cfg.chunk_deadline_s)
                        to_kill.append(proc)
                    elif (slot.ready and chunk is None
                            and now - slot.last_seen
                            > self.cfg.hb_timeout_s):
                        # silent while idle: heartbeats stopped — the
                        # process is wedged even though the pipe lives
                        global_tracer.add_event(
                            "encode_worker_heartbeat_kill", worker=slot.idx)
                        to_kill.append(proc)
                # a pool whose workers never come up (crash-looping
                # spawn: venv mismatch, broken interpreter) must fail
                # queued chunks FAST so callers bypass in-process and
                # the breaker opens — not stall each one on the caller
                # backstop. With at least one ready worker the queue
                # drains and per-chunk execution deadlines bound it.
                if (not stopping and self._pending
                        and not any(w.ready and not w.dead
                                    for w in self._workers)):
                    for chunk in [c for c in self._pending
                                  if now - c.submitted_at
                                  > self.cfg.chunk_deadline_s]:
                        self._pending.remove(chunk)
                        self._resolve_locked(
                            chunk, "stopped",
                            error="no ready worker within the chunk "
                                  "deadline")
            for proc in to_kill:
                try:
                    proc.kill()
                except Exception:
                    pass
            self._publish_gauges()

    def _publish_gauges(self) -> None:
        try:
            with self._lock:
                alive = sum(1 for w in self._workers
                            if w.ready and not w.dead)
                depth = (len(self._pending)
                         + sum(1 for w in self._workers
                               if w.busy is not None))
            self.metrics.encode_pool_workers.set(alive)
            self.metrics.encode_pool_queue_depth.set(depth)
        except Exception:
            pass

    # -- introspection

    def state(self) -> Dict[str, Any]:
        with self._lock:
            workers = [{
                "idx": w.idx, "pid": w.pid, "ready": w.ready,
                "dead": w.dead, "busy": w.busy is not None,
                "consecutive_restarts": w.consecutive_restarts,
                "torch_loaded": w.torch_loaded,
                "jax_loaded": w.jax_loaded,
            } for w in self._workers]
            return {
                "enabled": True,
                "workers": self.n_workers,
                "alive": sum(1 for w in workers
                             if w["ready"] and not w["dead"]),
                "restarts": self.restarts,
                "queue_depth": (len(self._pending)
                                + sum(1 for w in workers if w["busy"])),
                "in_flight": len(self._chunks),
                "breaker": self.breaker.state,
                "stopping": self._stopping,
                "worker_slots": workers,
            }

    def summary(self) -> Dict[str, Any]:
        s = self.state()
        return {k: s[k] for k in ("workers", "alive", "restarts",
                                  "queue_depth", "breaker")}


# ---------------------------------------------------------------------------
# the process-wide pool (CLI --encode-workers / KYVERNO_TPU_ENCODE_WORKERS)

_global_lock = threading.Lock()
_global_pool: Optional[EncoderPool] = None
_configured = False


def configure_pool(workers: Optional[int] = None,
                   **kw) -> Optional[EncoderPool]:
    """(Re)configure the process-wide encoder pool. ``workers`` falls
    back to $KYVERNO_TPU_ENCODE_WORKERS, then 0; 0 disables — callers
    then take today's in-process encode path byte-for-byte."""
    global _global_pool, _configured
    if workers is None:
        try:
            workers = int(os.environ.get(ENV_WORKERS, "") or 0)
        except ValueError:
            workers = 0
    with _global_lock:
        _configured = True
        old, _global_pool = _global_pool, None
        if workers and workers > 0:
            _global_pool = EncoderPool(workers, **kw).start()
        pool = _global_pool
    if old is not None:
        # stop OUTSIDE the lock: the old pool's drain (up to
        # drain_timeout_s) must not block every get_pool() caller on
        # the admission hot path — they see the new reference (or
        # None) immediately and fall through accordingly
        old.stop()
    return pool


def get_pool() -> Optional[EncoderPool]:
    """The process-wide pool, or None when disabled. First call without
    an explicit configure_pool() initializes from the env knob (under
    the lock: concurrent first callers must not double-spawn)."""
    global _configured, _global_pool
    with _global_lock:
        if _configured:
            return _global_pool
        try:
            workers = int(os.environ.get(ENV_WORKERS, "") or 0)
        except ValueError:
            workers = 0
        _configured = True
        if workers > 0:
            _global_pool = EncoderPool(workers).start()
        return _global_pool


def shutdown_pool() -> None:
    global _global_pool
    with _global_lock:
        pool = _global_pool
        _global_pool = None
    if pool is not None:
        pool.stop()


def pool_state() -> Dict[str, Any]:
    with _global_lock:
        pool = _global_pool
    return pool.state() if pool is not None else {"enabled": False}
