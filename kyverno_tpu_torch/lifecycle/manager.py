# Copied from kyverno_tpu/lifecycle/manager.py, with four changes:
# default_compile_fn builds a TorchEngine (on the card unless the caller
# passes device="cpu"), its warm-up scans twice so the smallest bucket's
# CUDA graph is captured on the compile-ahead worker, with
# analyze_on_swap set a version to promote also has its lint tile's
# graph captured before the swap, and start() does not enable the XLA
# compile cache (the port builds its kernels once by content hash).
"""Policy-set lifecycle manager — compile-ahead, atomic hot swap,
per-policy quarantine, rollback under load.

The compiled policy program is a versioned, immutable artifact:

- every PolicyCache mutation produces a PolicySetSnapshot (revision +
  content hash), and wakes the background compile worker;
- the worker lowers the new snapshot OFF the request path while every
  serving surface keeps evaluating against the last-known-good
  compiled version (acquire() never blocks on a recompile once a
  version exists);
- on success the new version is swapped in atomically — a reference
  assignment under a lock; in-flight batches finish on the version
  they pinned at flush (serving/batcher.py version_provider);
- on failure the offending policy is bisected out and QUARANTINED
  (its rules become host-fallback entries: the scalar oracle answers
  for it, per-rule ERROR when even the oracle cannot), the rest of the
  set recompiles and still runs on the device, and serving rolls back
  to (i.e. simply stays on) the prior compiled version;
- quarantined policies re-probe automatically: immediately when their
  content changes (the operator fixed the policy), and on a capped
  jittered backoff schedule otherwise (resilience/retry.py), so a
  transient compile-infrastructure failure heals without operator
  action. Set-level failures with no single culprit (every probe
  fails) count against a compile breaker instead of quarantining the
  whole set.

Chaos: the full-set compile and each bisect probe pass through the
``policyset.compile`` fault site (resilience/faults.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..observability.metrics import MetricsRegistry, global_registry
from ..observability.tracing import global_tracer
from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import SITE_POLICYSET_COMPILE, global_faults
from ..resilience.retry import RetryPolicy
from .snapshot import PolicySetSnapshot, policy_key


def _oplog(event: str, level: str = "info", **fields) -> None:
    """Structured operational log (observability/log.py) — lifecycle
    transitions are exactly the events an operator greps for during an
    incident; emission must never affect the swap ladder."""
    try:
        from ..observability.log import global_oplog

        global_oplog.emit(event, level=level, **fields)
    except Exception:
        pass


class PolicySetUnavailable(RuntimeError):
    """No compiled policy-set version exists (initial compile failed
    and nothing was ever promoted). Serving layers degrade to the pure
    scalar path or resolve per failurePolicy."""


@dataclass
class QuarantineEntry:
    key: str
    error: str
    policy_hash: str       # content hash at quarantine time (heal detection)
    attempts: int = 1
    since: float = field(default_factory=time.monotonic)
    next_retry_at: float = 0.0

    def to_dict(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        return {
            "policy": self.key,
            "error": self.error,
            "attempts": self.attempts,
            "quarantined_for_s": round(now - self.since, 3),
            "next_retry_in_s": round(max(0.0, self.next_retry_at - now), 3),
        }


@dataclass
class PolicySetVersion:
    """One immutable compiled artifact: the snapshot it was compiled
    from, the engine serving it, and the quarantine set baked into it.
    Callers hold a reference for as long as they need it (batch
    pinning) — a swap never mutates a version in place."""

    snapshot: PolicySetSnapshot
    engine: Any  # TorchEngine (duck-typed: .cps, .scan, .coverage)
    quarantined: Tuple[str, ...] = ()
    compiled_at: float = field(default_factory=time.monotonic)

    @property
    def revision(self) -> int:
        return self.snapshot.revision

    @property
    def policies(self) -> Tuple[Any, ...]:
        return self.snapshot.policies


# compile_fn(policies, quarantine_idx) -> engine
CompileFn = Callable[[List[Any], Dict[int, str]], Any]


def default_compile_fn(exceptions=(), encode_cfg=None, meta_cfg=None,
                       data_sources=None, warm: bool = False,
                       device=None, warm_buckets=()) -> CompileFn:
    """Build a TorchEngine from a policy list with quarantined indices
    excluded from lowering. ``warm`` additionally dispatches empty
    batches twice at the MIN_BUCKET shape (or at each of
    ``warm_buckets``, an admission pipeline's buckets): the first is the
    program's eager run, the second captures its CUDA graph
    (tpu/graphs.py) — INSIDE the compile-ahead worker, not on the first
    post-swap flush."""

    def fn(policies: List[Any], quarantine: Dict[int, str]):
        from ..tpu.compiler import compile_policy_set
        from ..tpu.engine import TorchEngine

        cps = compile_policy_set(policies, encode_cfg=encode_cfg,
                                 meta_cfg=meta_cfg,
                                 data_sources=data_sources,
                                 quarantine=quarantine)
        eng = TorchEngine(cps=cps, exceptions=exceptions,
                          data_sources=data_sources, device=device)
        if warm and cps.device_programs:
            eng.warm_buckets(list(warm_buckets) or [eng.MIN_BUCKET])
        return eng

    return fn


class PolicySetLifecycleManager:
    """Versioned snapshots in, one atomically-swappable compiled
    version out. With the worker running, acquire() is wait-free once
    a first version exists; without it (CLI apply, unit tests), stale
    revisions compile synchronously so behavior matches the classic
    compile-on-demand path."""

    def __init__(
        self,
        cache,  # PolicyCache (duck-typed: policyset_snapshot/subscribe/revision)
        compile_fn: Optional[CompileFn] = None,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        metrics: Optional[MetricsRegistry] = None,
        warm: bool = False,
    ) -> None:
        self.cache = cache
        self._compile_fn = compile_fn or default_compile_fn(warm=warm)
        # backoff tuning for quarantine re-probes and set-level retries:
        # capped delay, so recovery is automatic and bounded
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=1, base_delay_s=0.5, max_delay_s=30.0,
            deadline_s=None)
        self.breaker = breaker or CircuitBreaker(
            name="policyset-compile", failure_threshold=3,
            reset_timeout_s=5.0, metrics=metrics)
        self.metrics = metrics or global_registry
        self._lock = threading.Lock()           # state (_active, quarantine)
        self._compile_lock = threading.Lock()   # one compile at a time
        self._active: Optional[PolicySetVersion] = None
        self._quarantine: Dict[str, QuarantineEntry] = {}  # guarded-by: _lock
        self._synced_revision = -1  # guarded-by: _compile_lock  (cache revision last reconciled)
        self._set_attempts = 0      # guarded-by: _lock  (consecutive set-level failures)
        self._set_next_retry_at = 0.0  # guarded-by: _lock
        self._failed_hash: Optional[str] = None
        self._last_error: Optional[str] = None
        self.stats: Dict[str, Any] = {
            "compiles": 0, "swaps": 0, "compile_failures": 0,
            "rollbacks": 0, "quarantine_enters": 0, "quarantine_exits": 0,
        }
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # compile-ahead lint (analysis/): after a successful swap the
        # worker runs static analysis on the ACTIVE engine — no
        # recompile, no graph capture beyond the tile shape buckets — and
        # publishes anomalies via the OpLog / kyverno_analysis_*
        # metrics / /debug/analysis. On the card the lint tile's bucket
        # has its CUDA graph captured before the swap (_warm_lint), so
        # the lint only replays the program the admission flushes
        # share. Probing-style priority: the lint runs strictly AFTER
        # reconcile returns (the swap is already atomic and served) and
        # aborts between tiles the moment a new mutation wakes the
        # worker, so a large set's analysis never delays the next swap
        # either.
        self.analyze_on_swap = False
        self.lint_tile = 128
        self._linted_key: Optional[Tuple[str, Tuple[str, ...]]] = None
        # True while _bisect single-policy probe compiles run (always
        # under _compile_lock): compile_fns use it to skip work that
        # only the version being promoted needs (e.g. graph warm-up)
        self._probing = False
        cache.subscribe(self._on_cache_change)

    @property
    def probing(self) -> bool:
        return self._probing

    # -- cache subscription / worker plumbing

    def _on_cache_change(self, key: str, change: str, revision: int) -> None:
        self._wake.set()

    @property
    def worker_running(self) -> bool:
        w = self._worker
        return w is not None and w.is_alive()

    def start(self) -> None:
        """Start the compile-ahead worker (idempotent)."""
        if self.worker_running:
            return
        self._stopped.clear()
        self._wake.set()  # reconcile once immediately (initial compile)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="policyset-compile-ahead")
        self._worker.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stopped.set()
        self._wake.set()
        w = self._worker
        if w is not None:
            w.join(timeout=timeout)
        self._worker = None

    def _next_wake_timeout(self) -> Optional[float]:
        """Sleep until the earliest pending retry (quarantine re-probe
        or set-level backoff); None = sleep until a mutation wakes us."""
        now = time.monotonic()
        deadlines: List[float] = []
        with self._lock:
            if self._set_next_retry_at:
                deadlines.append(self._set_next_retry_at)
            deadlines.extend(q.next_retry_at for q in self._quarantine.values())
        if not deadlines:
            return None
        return max(0.05, min(deadlines) - now)

    def _run(self) -> None:
        while not self._stopped.is_set():
            self._wake.wait(self._next_wake_timeout())
            if self._stopped.is_set():
                return
            self._wake.clear()
            try:
                self.reconcile()
            except Exception:
                # reconcile records its own failures; the worker thread
                # must survive anything (a dead worker = silent staleness)
                pass
            if self.analyze_on_swap:
                try:
                    self.run_lint()
                except Exception:
                    pass  # the lint is advisory; it must never kill
                    # the compile-ahead worker

    # -- serving-side acquisition

    def acquire(self) -> PolicySetVersion:
        """The version serving paths evaluate against. Wait-free with
        the worker running (last-known-good, compile-ahead catches up);
        synchronous compile-on-demand otherwise. Raises
        PolicySetUnavailable when no version was ever promoted."""
        v = self._active
        if self.worker_running:
            if v is None:
                v = self.reconcile()  # startup race: first compile
        else:
            rev = self.cache.revision
            if v is None or self._synced_revision != rev or self._retry_due():
                v = self.reconcile()
        if v is None:
            raise PolicySetUnavailable(
                f"no compiled policy set (last error: {self._last_error})")
        return v

    @property
    def active(self) -> Optional[PolicySetVersion]:
        return self._active

    def _retry_due(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if self._set_next_retry_at and now >= self._set_next_retry_at:
                return True
            return any(now >= q.next_retry_at
                       for q in self._quarantine.values())

    # -- the reconcile step (compile-ahead body)

    def reconcile(self) -> Optional[PolicySetVersion]:
        """Bring the compiled version up to date with the cache. Safe
        to call from any thread; one compile runs at a time and late
        arrivals see the result without recompiling."""
        with self._compile_lock:
            return self._reconcile_locked()

    def _reconcile_locked(self) -> Optional[PolicySetVersion]:
        now = time.monotonic()
        snap = self.cache.policyset_snapshot()
        active = self._active
        keys = snap.keys()
        key_set = set(keys)
        # quarantine bookkeeping vs the new snapshot: deleted policies
        # leave quarantine; content changes or a due retry schedule a
        # re-probe (the policy is simply NOT excluded from this compile)
        probe: set = set()
        with self._lock:
            for key in list(self._quarantine):
                q = self._quarantine[key]
                if key not in key_set:
                    del self._quarantine[key]
                    self.stats["quarantine_exits"] += 1
                elif (snap.policy_hashes.get(key) != q.policy_hash
                        or now >= q.next_retry_at):
                    probe.add(key)
            held = {k: self._quarantine[k].error
                    for k in self._quarantine if k not in probe}
        content_stale = (active is None
                         or active.snapshot.content_hash != snap.content_hash)
        quarantine_stale = (active is not None
                            and set(active.quarantined) != set(held))
        if not content_stale and not probe and not quarantine_stale:
            self._synced_revision = snap.revision
            # the cache healed BACK to the active content without a
            # compile (e.g. the offending mutation was reverted): the
            # recorded set-level failure is moot — clearing it here
            # stops the retry schedule from busy-waking the worker and
            # from reporting a stale compile error forever
            with self._lock:
                if self._failed_hash is not None:
                    self._failed_hash = None
                    self._set_attempts = 0
                    self._set_next_retry_at = 0.0
                    self._last_error = None
            return active
        # a compile already failed at this exact content: pace retries
        # with the backoff schedule instead of recompiling per acquire
        if (self._failed_hash == snap.content_hash and not probe
                and now < self._set_next_retry_at):
            return active
        if not self.breaker.allow():
            # breaker OPEN: compile infrastructure is sick; stay on the
            # last-known-good version without burning another attempt
            global_tracer.add_event("policyset_compile_deferred",
                                    breaker=self.breaker.state,
                                    revision=snap.revision)
            return active
        return self._compile_and_swap(snap, held, now, probe)

    def _try_compile(self, policies: List[Any], quarantine: Dict[int, str]):
        global_faults.fire(SITE_POLICYSET_COMPILE)
        engine = self._compile_fn(policies, quarantine)
        if self.analyze_on_swap and not self._probing:
            self._warm_lint(engine)
        return engine

    def _warm_lint(self, engine: Any) -> None:
        """Capture the graph of the lint tile's bucket on a CUDA engine
        before its version is promoted. A program runs one call at a
        time, so the lint's first calls at a new bucket (an eager run,
        then a capture) would otherwise hold every admission flush on
        the version it lints."""
        if getattr(getattr(engine, "device", None), "type", None) == "cuda":
            engine.warm_buckets([engine.bucket_size(self.lint_tile)])

    def _compile_and_swap(self, snap: PolicySetSnapshot,
                          held: Dict[str, str], now: float,
                          probe_keys: Optional[set] = None
                          ) -> Optional[PolicySetVersion]:
        keys = snap.keys()
        idx_of = {k: i for i, k in enumerate(keys)}
        q_idx = {idx_of[k]: err for k, err in held.items() if k in idx_of}
        policies = list(snap.policies)
        self.stats["compiles"] += 1
        t0 = time.monotonic()
        try:
            with global_tracer.span("policyset.compile_ahead",
                                    revision=snap.revision,
                                    policies=len(policies),
                                    quarantined=len(q_idx)):
                engine = self._try_compile(policies, q_idx)
        except Exception as e:
            offenders = self._bisect(snap, held, e, probe_keys)
            if offenders is None:
                return self._set_failure(snap, e, now)
            with self._lock:
                for key, err in offenders.items():
                    prior = self._quarantine.get(key)
                    attempts = (prior.attempts + 1) if prior else 1
                    entry = QuarantineEntry(
                        key=key, error=err,
                        policy_hash=snap.policy_hashes.get(key, ""),
                        attempts=attempts)
                    entry.next_retry_at = now + self.retry_policy.delay(
                        min(attempts - 1, 8), _rng())
                    if prior is not None:
                        entry.since = prior.since
                    self._quarantine[key] = entry
                    if prior is None:
                        self.stats["quarantine_enters"] += 1
                    global_tracer.add_event(
                        "policyset_quarantine", policy=key, error=err[:200],
                        attempts=attempts)
                    _oplog("policy_quarantined", level="warn", policy=key,
                           error=err[:200], attempts=attempts,
                           revision=snap.revision)
                held_all = {k: q.error for k, q in self._quarantine.items()}
            self._publish_quarantine()
            q_idx = {idx_of[k]: err for k, err in held_all.items()
                     if k in idx_of}
            try:
                with global_tracer.span("policyset.compile_ahead",
                                        revision=snap.revision,
                                        policies=len(policies),
                                        quarantined=len(q_idx),
                                        after_quarantine=True):
                    engine = self._try_compile(policies, q_idx)
            except Exception as e2:
                return self._set_failure(snap, e2, now)
        return self._swap_locked(snap, engine, now,
                                 compile_s=time.monotonic() - t0)

    def _bisect(self, snap: PolicySetSnapshot, held: Dict[str, str],
                err: Exception,
                probe_keys: Optional[set] = None) -> Optional[Dict[str, str]]:
        """Compile policies alone to find the culprit(s). Policies whose
        content moved since the last GOOD snapshot — plus quarantined
        policies being RE-probed this cycle (their content is unchanged
        by definition, but they are the prime suspects) — are probed
        first: the offender is almost always among them, so an N-policy
        set pays O(changed+1) probe compiles, not O(N); the full sweep
        only runs when the suspect set is clean. Returns {key: error},
        or None when the failure looks set-level/infrastructural (every
        probe failed — blaming every policy for a sick toolchain would
        quarantine the whole set)."""
        active = self._active
        baseline = active.snapshot.policy_hashes if active is not None else {}
        probe_keys = probe_keys or set()

        def probe(policies) -> Dict[str, str]:
            found: Dict[str, str] = {}
            self._probing = True
            try:
                for policy in policies:
                    try:
                        self._try_compile([policy], {})
                    except Exception as pe:
                        found[policy_key(policy)] = \
                            f"{type(pe).__name__}: {pe}"
            finally:
                self._probing = False
            return found

        eligible = [p for p in snap.policies if policy_key(p) not in held]
        changed = [p for p in eligible
                   if policy_key(p) in probe_keys
                   or baseline.get(policy_key(p))
                   != snap.policy_hashes.get(policy_key(p))]
        changed_keys = {policy_key(p) for p in changed}
        rest = [p for p in eligible if policy_key(p) not in changed_keys]
        offenders = probe(changed)
        if offenders:
            if len(offenders) < len(changed):
                # some changed policies compiled: probes demonstrably
                # work, so the failures are genuine culprits
                return offenders
            # EVERY changed policy failed — culprit or sick toolchain?
            # one unchanged sentinel probe tells them apart without
            # paying O(N) compiles
            if rest:
                return offenders if not probe([rest[0]]) else None
            return offenders if len(changed) == 1 else None
        offenders = probe(rest)
        if not offenders:
            return None  # full set failed, each policy alone compiles
        if len(rest) > 1 and len(offenders) == len(rest):
            return None  # everything failed: infrastructure, not policy
        return offenders

    def _set_failure(self, snap: PolicySetSnapshot, err: Exception,
                     now: float) -> Optional[PolicySetVersion]:
        """Set-level compile failure: keep serving the prior compiled
        version (rollback), count it on the breaker, schedule a capped
        backoff retry."""
        active = self._active
        self.breaker.record_failure()
        self.metrics.policyset_compile_failures.inc({"kind": "set"})
        with self._lock:
            self._set_attempts += 1
            self._set_next_retry_at = now + self.retry_policy.delay(
                min(self._set_attempts - 1, 8), _rng())
            self._failed_hash = snap.content_hash
            self._last_error = f"{type(err).__name__}: {err}"
            self.stats["compile_failures"] += 1
            if active is not None:
                self.stats["rollbacks"] += 1
        global_tracer.record_span(
            "policyset.rollback", now, time.monotonic(),
            target_revision=snap.revision,
            serving_revision=active.revision if active else None,
            error=self._last_error[:200], status="error")
        _oplog("policyset_rollback", level="error",
               target_revision=snap.revision,
               serving_revision=active.revision if active else None,
               error=self._last_error[:200])
        return active

    # callers hold _compile_lock (the compile-ahead path)
    def _swap_locked(self, snap: PolicySetSnapshot, engine, now: float,
              compile_s: float) -> PolicySetVersion:
        self.breaker.record_success()
        with self._lock:
            # quarantined keys NOT excluded from this engine's compiled
            # set were healed by this compile: they were in the probe
            # set, and the full-set compile including them succeeded
            excluded = _quarantined_keys(snap, engine)
            healed = [k for k in self._quarantine if k not in excluded]
            for k in healed:
                del self._quarantine[k]
                self.stats["quarantine_exits"] += 1
                global_tracer.add_event("policyset_quarantine_exit", policy=k)
                _oplog("policy_quarantine_healed", policy=k,
                       revision=snap.revision)
            quarantined = tuple(sorted(self._quarantine))
            prior = self._active
            version = PolicySetVersion(snapshot=snap, engine=engine,
                                       quarantined=quarantined)
            self._active = version   # THE swap: one reference assignment
            self._synced_revision = snap.revision
            self._set_attempts = 0
            self._set_next_retry_at = 0.0
            self._failed_hash = None
            self._last_error = None
            if prior is not None:
                self.stats["swaps"] += 1
        if prior is not None:
            self.metrics.policyset_swaps.inc()
        self.metrics.policyset_revision.set(snap.revision)
        self._publish_quarantine()
        # SLO surface: the swapped-in set's device coverage is the
        # coverage-floor SLO input (a quarantine-heavy or unloweable
        # set burning the floor shows up before latency does)
        try:
            from ..observability.analytics import global_slo

            dev, total = engine.coverage()
            global_slo.set_device_coverage(
                (dev / total) if total else 1.0)
        except Exception:
            pass
        # re-publish the DFA bank gauges for the set that is now
        # ACTIVE (probe/bisect compiles must not own these numbers)
        engine.cps.publish_dfa_gauges()
        global_tracer.record_span(
            "policyset.swap", now, time.monotonic(),
            from_revision=prior.revision if prior else None,
            to_revision=snap.revision, policies=len(snap.policies),
            quarantined=len(quarantined), compile_s=round(compile_s, 4))
        _oplog("policyset_swap",
               from_revision=prior.revision if prior else None,
               to_revision=snap.revision, policies=len(snap.policies),
               quarantined=len(quarantined), compile_s=round(compile_s, 4))
        return version

    def _publish_quarantine(self) -> None:
        with self._lock:
            n = len(self._quarantine)
        self.metrics.policyset_quarantined.set(n)

    # -- compile-ahead lint (analysis/)

    def run_lint(self, force: bool = False) -> Optional[Any]:
        """Static analysis of the ACTIVE version's already-compiled
        engine (no recompile — the engine IS the artifact the swap
        promoted; its CUDA graphs are already warm from serving).
        Idempotent per (content hash, quarantine set); ``force``
        re-runs regardless. Returns the AnalysisReport, or None when
        nothing is active, the version was already linted, or a
        pending policy-set change preempted the run (the worker's next
        wake retries — the linted key is only recorded on success)."""
        version = self._active
        if version is None:
            return None
        key = (version.snapshot.content_hash, version.quarantined)
        if not force and key == self._linted_key:
            return None
        from ..analysis import global_analysis, run_analysis

        global_analysis.lint_enabled = True

        def should_abort() -> bool:
            # a pending policy-set change preempts the lint: the cache
            # revision moving past the linted snapshot is the signal (a
            # raw _wake check would wedge sync-mode callers — nothing
            # clears the event without a worker)
            try:
                stale = self.cache.revision != version.snapshot.revision
            except Exception:
                stale = False
            return (self._stopped.is_set() or self._active is not version
                    or stale)

        t0 = time.monotonic()
        with global_tracer.span("policyset.lint", revision=version.revision,
                                policies=len(version.policies)):
            report = run_analysis(version.engine, tile=self.lint_tile,
                                  should_abort=should_abort)
        if report is None:
            # preempted between tiles: the mutation that aborted us
            # already set _wake, so the worker loops straight back into
            # reconcile and re-lints whatever version wins
            return None
        self._linted_key = key
        self.stats["lints"] = self.stats.get("lints", 0) + 1
        for a in report.anomalies:
            _oplog("policy_anomaly", level="warn", kind=a.kind,
                   policy=a.policy, rule=a.rule,
                   other=(f"{a.other_policy}/{a.other_rule}"
                          if a.other_policy or a.other_rule else ""),
                   detail=a.detail[:200], revision=version.revision)
        _oplog("policyset_lint", revision=version.revision,
               witnesses=report.stats.get("witnesses", 0),
               anomalies=report.counts(),
               wall_s=round(time.monotonic() - t0, 3))
        return report

    # -- introspection

    def state(self) -> Dict[str, Any]:
        """JSON-ready lifecycle snapshot for /readyz and /debug/state."""
        now = time.monotonic()
        active = self._active
        with self._lock:
            quarantined = [q.to_dict(now) for q in
                           sorted(self._quarantine.values(),
                                  key=lambda q: q.key)]
            stats = dict(self.stats)
            last_error = self._last_error
            retry_in = (max(0.0, self._set_next_retry_at - now)
                        if self._set_next_retry_at else None)
        out: Dict[str, Any] = {
            "active_revision": active.revision if active else None,
            "active_content_hash": (active.snapshot.content_hash
                                    if active else None),
            "cache_revision": self.cache.revision,
            "worker_running": self.worker_running,
            "compile_breaker": self.breaker.state,
            "quarantined": quarantined,
            "stats": stats,
        }
        if active is not None:
            dev, total = active.engine.coverage()
            out["device_rules"] = dev
            out["total_rules"] = total
            out["policies"] = [policy_key(p) for p in active.policies]
        if last_error:
            out["last_compile_error"] = last_error
        if retry_in is not None:
            out["set_retry_in_s"] = round(retry_in, 3)
        return out


def _quarantined_keys(snap: PolicySetSnapshot, engine) -> set:
    """Keys of policies the ENGINE's compiled set actually excluded."""
    keys = snap.keys()
    return {keys[i] for i in getattr(engine.cps, "quarantined", {}) or {}
            if i < len(keys)}


_rng_local = threading.local()


def _rng():
    import random

    r = getattr(_rng_local, "rng", None)
    if r is None:
        r = _rng_local.rng = random.Random()
    return r
