"""TorchEngine — batch policy evaluation on a CUDA device (the port of
kyverno_tpu/tpu/engine.py:TpuEngine: the validate scan and the mutate
triage).

``TorchEngine(policies).scan(resources)`` encodes the resources on the
host (NumPy, tpu/flatten.py + tpu/metadata.py), pads the batch to a
power-of-two bucket, moves the lane dict to the device in ONE copy from
pinned memory, runs the compiled program (evaluator.build_program),
reads back the verdict table and completes it on the scalar engine
(``assemble``): rules the compiler kept on the host, rules named by a
PolicyException, and HOST (5) / CONFIRM (6) cells are evaluated by the
scalar engine, so the returned ``ScanResult`` covers every rule with
codes 0..4 only, as the reference's does.

``scan_device`` returns the device layer alone: the (device rules, N)
int32 table as the program computed it (HOST and CONFIRM cells left
in) and the per-rule verdict-class counts with the bucket-pad columns
subtracted.

``triage_mutate`` runs the mutate bank's program
(``CompiledPolicySet.mutate_device_fn``) over a padded batch and
returns the needs-mutation table (``MutateTriageResult``) that
``mutation.coordinator.apply_mutations`` routes patches by.

Every device call goes through ONE guarded dispatch ladder
(``guarded_dispatch``, the reference's, which ``ShardedScanner.scan``
shares): the ``tpu.dispatch`` fault site, the program, the corrupt
filter, shape and dtype validation, and the process-wide circuit
breaker (``resilience.breaker.tpu_breaker``). A failed or refused
dispatch answers the batch all-HOST, so the scalar engine completes it
with the same verdicts, counted as ``breaker_fallback`` (metric and
trace event). A ``kernels.KernelError`` (a kernel of the port that
fails to build, load or launch, or a program that fails to be captured
as a CUDA graph) is not a batch's fault: it is counted as
``kernel_errors`` and raised, never answered all-HOST, so a broken
kernel cannot hide behind the scalar engine. A batch whose host encode
raises is quarantined (``_scan_quarantining``): the resources that
encode alone are scanned again, the others complete on the scalar
engine, with per-rule ERROR where that engine fails too. Triage
answers both failures all-HOST. The pipelined scan (``tpu/pipeline.py``)
takes the same ladder in two halves, ``guarded_launch`` (enqueue the
copy, the replay and the table's copy back, record an event) and
``guarded_complete`` (wait on the event, validate).

``scan`` and ``triage_mutate`` serve warm (resource, request) columns
from the process-wide verdict cache (``tpu/cache.py``) and send the
misses through ``_scan_uncached`` / ``_triage_uncached``; the row
encode restores unchanged resources from the encode cache and the
columnar store, and encodes the misses on the encoder pool when one is
configured (``_encode_rows``). Every assembled batch is folded into the
rule analytics (``observability/analytics.py``), as the reference's is.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without CUDA they raise instead of running elsewhere.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.policy import ClusterPolicy
from ..devtools import sanitizer as _sanitizer
from ..engine.context import Context
from ..engine.engine import Engine as ScalarEngine
from ..engine.match import RequestInfo
from ..engine.policycontext import PolicyContext
from ..engine.response import EngineResponse
from ..kernels import KernelError
from ..observability.analytics import (NUM_CLASSES, RuleIdent, class_counts,
                                       global_pattern_cells,
                                       global_rule_stats, global_starvation)
from ..observability.profiling import (PATH_DEVICE, PATH_SCALAR_FALLBACK,
                                       PHASE_DISPATCH, PHASE_ENCODE,
                                       PHASE_HOST_COMPLETE, PHASE_READBACK,
                                       global_profiler, last_dispatch_path,
                                       maybe_xla_trace, set_dispatch_path)
from ..observability.tracing import global_tracer
from ..resilience.faults import (SITE_MUTATE_TRIAGE, SITE_TPU_DISPATCH,
                                 global_faults)
from .compiler import CompiledPolicySet, compile_policy_set
from .evaluator import (CONFIRM, ERROR, FAIL, HOST, NOT_MATCHED, PASS, SKIP,
                        batch_to_host)
from .flatten import EncodeConfig, encode_resources
from .metadata import MetaConfig, encode_metadata

VERDICT_NAMES = {PASS: "pass", SKIP: "skip", FAIL: "fail",
                 NOT_MATCHED: "not_matched", ERROR: "error"}


class DeviceResultError(RuntimeError):
    """The device program returned a wrong-shaped/typed verdict table —
    treated exactly like a dispatch failure (breaker + scalar fallback),
    never silently consumed as truth."""


_STATUS_TO_CODE = {"pass": PASS, "skip": SKIP, "fail": FAIL, "error": ERROR}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without CUDA raises: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kyverno_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def lanes_to_device(batch: Dict[str, np.ndarray], device,
                    keep: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """The host lane dict as tensors on ``device``. uint32 hash lanes
    become int32 bit patterns (torch's uint32 supports no ordering and
    the program only tests them for equality). uint16 lanes (the
    vocabulary index tables) cross as their raw bytes in a
    ``torch.uint16`` tensor: the program only gathers through them
    (kernel K5 reads them as unsigned short; its plain twin widens
    them through int16 without any ordering op on uint16). On CUDA
    every lane is packed into ONE pinned host buffer (16-byte aligned
    slices) and moved with one asynchronous copy on the current
    stream; the lanes are views into the device buffer. ``keep``, when
    given, receives the pinned buffer so the caller can hold it until
    the copy has run."""
    device = torch.device(device)
    arrs = {}
    for k, v in batch.items():
        a = np.ascontiguousarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype == np.bool_:
            a = a.view(np.uint8)
        arrs[k] = a
    if device.type == "cpu":
        return {k: torch.from_numpy(a).view(_TORCH_DTYPES[a.dtype.str])
                for k, a in arrs.items()}
    offsets = {}
    total = 0
    for k, a in arrs.items():
        offsets[k] = total
        total += -(-a.nbytes // 16) * 16
    host = torch.empty((max(total, 16),), dtype=torch.uint8, pin_memory=True)
    hview = host.numpy()
    for k, a in arrs.items():
        o = offsets[k]
        hview[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    if keep is not None:
        keep.append(host)
    out = {}
    for k, a in arrs.items():
        o = offsets[k]
        t = dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype.str])
        out[k] = t.view(a.shape)
    # the caching host allocator keeps the pinned buffer alive until
    # the asynchronous copy has run
    return out


_TORCH_DTYPES = {
    np.dtype(np.uint8).str: torch.uint8,
    np.dtype(np.int8).str: torch.int8,
    np.dtype(np.int16).str: torch.int16,
    np.dtype(np.uint16).str: torch.uint16,
    np.dtype(np.int32).str: torch.int32,
    np.dtype(np.int64).str: torch.int64,
    np.dtype(np.float32).str: torch.float32,
}


# The JSON context of a scanned resource and the dynamic-operand lane
# encoding below are copied from kyverno_tpu/tpu/engine.py.


def _scan_json_context(resource: Dict[str, Any], operation: str = "",
                       admission_info: Optional[RequestInfo] = None) -> Context:
    """The JSON context both engines evaluate against for one scanned
    resource: request.object/namespace/operation/userInfo + images.*
    (policy_context.go:257)."""
    ctx = Context()
    ctx.add_resource(resource)
    ns = (resource.get("metadata") or {}).get("namespace", "")
    if ns:
        ctx.add_namespace(ns)
    if operation:
        ctx.add_operation(operation)
    info = admission_info or RequestInfo()
    ctx.add_user_info({"username": info.username, "uid": info.uid,
                       "groups": info.groups})
    try:
        from ..images import extract_images

        extracted = extract_images(resource)
        if extracted:
            ctx.add_image_infos({
                group: {key: info_.to_dict() for key, info_ in entries.items()}
                for group, entries in extracted.items()})
    except Exception:
        pass  # malformed image strings must not break context building
    return ctx



def _walk_values(node, segs, i=0):
    """Yield the values at a PathState segment chain over a raw
    resource dict (ARRAY_SEG iterates list elements)."""
    from .hashing import ARRAY_SEG

    if i == len(segs):
        yield node
        return
    seg = segs[i]
    if seg == ARRAY_SEG:
        if isinstance(node, list):
            for el in node:
                yield from _walk_values(el, segs, i + 1)
    elif isinstance(node, dict) and seg in node:
        yield from _walk_values(node[seg], segs, i + 1)


def build_scan_context(
    policy: ClusterPolicy,
    resource: Dict[str, Any],
    namespace_labels: Optional[Dict[str, str]],
    operation: str = "",
    admission_info: Optional[RequestInfo] = None,
) -> PolicyContext:
    """Background-scan PolicyContext (kyverno_tpu/tpu/engine.py:91):
    request.operation stays absent unless a real admission operation
    exists; match-gating still defaults to CREATE."""
    ctx = _scan_json_context(resource, operation, admission_info)
    info = admission_info or RequestInfo()
    return PolicyContext(
        policy=policy,
        new_resource=resource,
        admission_info=info,
        namespace_labels=namespace_labels or {},
        operation=operation or "CREATE",
        json_context=ctx,
    )


@dataclass
class ScanResult:
    """(num_rules_total, N) verdict table + rule metadata (the
    reference's ScanResult)."""

    verdicts: np.ndarray
    rules: List[Tuple[str, str]]  # (policy_name, rule_name) per row

    def counts(self) -> Dict[str, int]:
        return {name: int((self.verdicts == code).sum())
                for code, name in VERDICT_NAMES.items()}

    def violations(self) -> List[Tuple[int, int]]:
        """(rule_row, resource_idx) pairs with FAIL verdicts."""
        rows, cols = np.nonzero(self.verdicts == FAIL)
        return list(zip(rows.tolist(), cols.tolist()))


@dataclass
class MutateTriageResult:
    """(num_mutate_rules, N) needs-mutation verdict table in compiled
    bank order (the reference's). PASS/FAIL = rule applies;
    SKIP/NOT_MATCHED = it does not; ERROR/HOST/CONFIRM = undecidable on
    device, the coordinator routes the policy to the scalar patcher."""

    verdicts: np.ndarray
    rules: List[Tuple[str, str]]  # (policy_name, rule_name) per row

    def rows_for(self, ci: int) -> List[Tuple[Tuple[str, str], int]]:
        """One resource's bank-ordered ((policy, rule), code) rows —
        the coordinator's input shape."""
        return [(ident, int(self.verdicts[mi, ci]))
                for mi, ident in enumerate(self.rules)]

    def counts(self) -> Dict[str, int]:
        pos = int(((self.verdicts == PASS) | (self.verdicts == FAIL)).sum())
        neg = int(((self.verdicts == SKIP)
                   | (self.verdicts == NOT_MATCHED)).sum())
        return {"positive": pos, "negative": neg,
                "host": int(self.verdicts.size) - pos - neg}


def _scalar_rule_verdicts(
    engine: ScalarEngine, policy: ClusterPolicy, pctx: PolicyContext
) -> Dict[str, int]:
    """Run the scalar engine for one (policy, resource); map each
    validate rule to a verdict code (absent response = not matched)."""
    response: EngineResponse = engine.validate(pctx)
    got = {rr.name: _STATUS_TO_CODE.get(rr.status, ERROR)
           for rr in response.policy_response.rules}
    out: Dict[str, int] = {}
    for rule in policy.get_rules():
        if rule.has_validate():
            out[rule.name] = got.get(rule.name, NOT_MATCHED)
    return out


class TorchEngine:
    """Compile once, scan many, on one device."""

    # batch sizes bucket to powers of two, as the reference's do
    MIN_BUCKET = 16
    DYN_LIST_L = 32  # padded list-operand lanes per slot

    def __init__(
        self,
        policies: Sequence[ClusterPolicy] = (),
        device=None,
        encode_cfg: Optional[EncodeConfig] = None,
        meta_cfg: Optional[MetaConfig] = None,
        cps: Optional[CompiledPolicySet] = None,
        exceptions: Sequence[Any] = (),
        data_sources=None,
        breaker=None,
    ):
        self.device = resolve_device(device)
        self.cps: CompiledPolicySet = cps if cps is not None \
            else compile_policy_set(policies, encode_cfg, meta_cfg,
                                    data_sources)
        self.data_sources = data_sources  # runtime dyn-operand loading
        # device errors are device-wide, so engines share the process
        # breaker by default (engines churn with policy revisions)
        if breaker is None:
            from ..resilience.breaker import tpu_breaker

            breaker = tpu_breaker()
        self.breaker = breaker
        # the verdict-class counts ride from a dispatch to its caller
        # in a thread-local slot, as the reference's do
        self._tls = threading.local()
        self.scalar = ScalarEngine(exceptions=list(exceptions),
                                   background=True,
                                   data_sources=data_sources)
        # rules named by any PolicyException evaluate on the host: the
        # exception's match/conditions are per-resource dynamic state
        # the compiled program does not model (engine/exceptions.go)
        self._exception_rules: set = set()
        # same host routing for the mutate triage bank: an excepted
        # mutate rule's apply decision is per-resource dynamic state
        self._exception_mutate_rules: set = set()
        if exceptions:
            from ..api.exception import PolicyException

            typed = [e if isinstance(e, PolicyException)
                     else PolicyException.from_dict(e) for e in exceptions]
            for ri, entry in enumerate(self.cps.rules):
                if any(t.contains(entry.policy_name, entry.rule_name)
                       for t in typed):
                    self._exception_rules.add(ri)
            for mi, entry in enumerate(self.cps.mutate_entries):
                if any(t.contains(entry.policy_name, entry.rule_name)
                       for t in typed):
                    self._exception_mutate_rules.add(mi)
        # triage batches the device answered, and batches whose host
        # encode raised (answered all-HOST, as the reference does)
        self.triage_dispatches = 0
        self.triage_encode_fallbacks = 0
        # verdict-cache identity (tpu/cache.py): exceptions change
        # verdicts without changing the compiled set, so they join the
        # policy-set content key
        from .cache import digest as _digest

        self._exceptions_digest = _digest(
            [e if isinstance(e, dict) else getattr(e, "raw", None) or repr(e)
             for e in exceptions]) if exceptions else ""
        self._cache_ident: Optional[str] = None
        self._cache_eligible: Optional[bool] = None
        self._mutate_cache_eligible: Optional[bool] = None
        self._encode_cache_key: Optional[str] = None
        # encoder-pool profile for the rows feed, registered lazily per
        # pool instance (a reconfigured pool gets a fresh profile)
        self._pool_profile: Optional[Tuple[Any, int]] = None
        # per-rule analytics identities (observability/analytics.py)
        self._rule_idents: Optional[List[RuleIdent]] = None
        try:
            global_rule_stats.register(self.rule_idents())
        except Exception:
            pass  # analytics must never block engine construction
        self.cps.publish_dfa_gauges()

    @classmethod
    def from_compiled(cls, cps: CompiledPolicySet,
                      device=None) -> "TorchEngine":
        return cls(cps=cps, device=device)

    @property
    def rules(self) -> List[Tuple[str, str]]:
        """(policy, rule) of each device-table row (``scan_device``);
        ``scan`` returns every rule, in ``cps.rules`` order."""
        out: List[Tuple[str, str]] = [("", "")] * len(self.cps.device_programs)
        for e in self.cps.rules:
            if e.device_row is not None:
                out[e.device_row] = (e.policy_name, e.rule_name)
        return out

    def coverage(self) -> Tuple[int, int]:
        return self.cps.coverage()

    def mutate_coverage(self) -> Tuple[int, int]:
        return self.cps.mutate_coverage()

    # -- encoding (host NumPy)

    def encode(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
    ):
        rows = self._encode_rows(resources)
        meta = encode_metadata(resources, namespace_labels, operations,
                               admission_infos, self.cps.meta_cfg)
        batch = batch_to_host(rows, meta)
        if self.cps.dyn_slots:
            batch.update(self._encode_dyn_lanes(resources, operations,
                                                admission_infos))
        return batch, rows, meta

    # _encode_rows and _encode_rows_pooled are copied from
    # kyverno_tpu/tpu/engine.py

    def _encode_rows(self, resources: Sequence[Dict[str, Any]]):
        """Row encoding through the content-addressed encode cache: an
        unchanged resource's lane rows restore from the LRU (or the
        columnar store under it) instead of re-walking the JSON tree.
        Keyed by encode config + compiled byte-path sets, NOT policy
        content. With an encoder pool configured, cache MISSES encode
        on a worker process and the pooled results populate the shared
        cache; a pool bypass or infra failure falls back to in-process
        encode, and a poison resource comes back flagged for host
        fallback exactly like an encode-cap overflow."""
        from ..cluster.columnar import get_store
        from .cache import (EncodeRowCache, apply_rows_multi, extract_rows,
                            global_encode_cache, resource_content_hash)
        from .flatten import RowBatch

        ec = global_encode_cache
        store = get_store()
        if not ec.enabled and store is None:
            return encode_resources(resources, self.cps.encode_cfg,
                                    self.cps.byte_paths,
                                    self.cps.key_byte_paths)
        if self._encode_cache_key is None:
            self._encode_cache_key = EncodeRowCache.encode_key(
                self.cps.encode_cfg, self.cps.byte_paths,
                self.cps.key_byte_paths)
        batch = RowBatch(len(resources), self.cps.encode_cfg)
        misses: List[Tuple[int, Optional[Tuple[str, str]]]] = []
        hit_entries: List[Any] = []
        hit_idx: List[int] = []
        for i, res in enumerate(resources):
            h = resource_content_hash(res)
            key = (self._encode_cache_key, h) if h is not None else None
            entry = (ec.get_entry(key)
                     if key is not None and ec.enabled else None)
            if entry is None and key is not None and store is not None:
                # columnar tier under the LRU
                entry = store.get_entry(self._encode_cache_key, h)
            if entry is None:
                misses.append((i, key))
            else:
                hit_entries.append(entry)
                hit_idx.append(i)
        # all hits land in one vectorized scatter per lane
        apply_rows_multi(hit_entries, batch, hit_idx)
        if misses and self._encode_rows_pooled(resources, batch, misses, ec):
            return batch
        if misses:
            sub = encode_resources([resources[i] for i, _ in misses],
                                   self.cps.encode_cfg, self.cps.byte_paths,
                                   self.cps.key_byte_paths)
            sub_arrays = sub.arrays()
            batch_arrays = batch.arrays()
            for j, (i, key) in enumerate(misses):
                for name, arr in sub_arrays.items():
                    batch_arrays[name][i] = arr[j]
                if key is not None:
                    entry = extract_rows(sub, j)
                    ec.put_entry(key, entry)
                    if store is not None:
                        store.put_entry(self.cps.encode_cfg,
                                        self.cps.byte_paths,
                                        self.cps.key_byte_paths,
                                        key[1], entry)
        return batch

    # pooling a miss set smaller than this costs more in IPC round-trip
    # than the in-process encode it replaces
    POOL_ROWS_MIN = 4

    def _encode_rows_pooled(self, resources, batch, misses, ec) -> bool:
        """Encode the cache misses on the encoder pool; True when the
        batch rows were filled (False -> caller encodes in-process)."""
        if len(misses) < self.POOL_ROWS_MIN:
            return False
        from ..encode import (KIND_ROWS, PoolBypassed, PoolInfraError,
                              WorkerEncodeError, get_pool, profile_spec)
        from .cache import apply_rows

        pool = get_pool()
        if pool is None or not pool.running:
            return False
        try:
            if (self._pool_profile is None
                    or self._pool_profile[0] is not pool):
                self._pool_profile = (pool, pool.register_profile(
                    profile_spec(self.cps.encode_cfg,
                                 byte_paths=self.cps.byte_paths,
                                 key_byte_paths=self.cps.key_byte_paths)))
            out = pool.encode_chunk(
                self._pool_profile[1], KIND_ROWS,
                {"resources": [resources[i] for i, _ in misses]})
        except (PoolBypassed, PoolInfraError, WorkerEncodeError):
            # breaker open / infra out -> in-process path; a worker-
            # reported encode error re-raises in-process too, where the
            # quarantine ladder owns it
            return False
        from ..cluster.columnar import get_store

        store = get_store()
        poison = set(out.get("poison") or ())
        for j, (i, key) in enumerate(misses):
            if j in poison:
                # quarantined: empty lanes + the fallback flag route
                # this column to the scalar engine (HOST)
                batch.fallback[i] = 1
                continue
            entry = out["rows"][j]
            apply_rows(entry, batch, i)
            if key is not None:
                ec.put_entry(key, entry)
                if store is not None:
                    store.put_entry(self.cps.encode_cfg,
                                    self.cps.byte_paths,
                                    self.cps.key_byte_paths,
                                    key[1], entry)
        return True

    def _encode_dyn_lanes(self, resources, operations, admission_infos):
        """Host-resolved context operands (SURVEY §7 context-dependent
        rules): per (slot, resource), load the slot's context entries
        through the REAL loaders (apiCall/configMap I/O included,
        exactly the scalar engine's path) and encode the queried value
        as canonical lanes the device program compares against.
        Load results cache on the substituted entry spec, so
        request-independent entries (static urlPaths, configMaps)
        resolve once per batch."""
        S, N, L = len(self.cps.dyn_slots), len(resources), self.DYN_LIST_L
        lanes = {
            # type: 0=load-error 1=null 2=bool 3=num 4=str 5=list 6=other
            "dyn_type": np.zeros((S, N), np.int8),
            "dyn_bool": np.zeros((S, N), np.int8),
            # 0/1 = the value coerces to that bool ("true"/"false"
            # strings included, equal.go), 2 = no bool coercion
            "dyn_as_bool": np.full((S, N), 2, np.int8),
            "dyn_num": np.zeros((S, N), np.float32),
            "dyn_has_num": np.zeros((S, N), np.int8),
            # canonical number hash (rows carry canon hashes, not floats)
            "dyn_num_h": np.zeros((S, N, 2), np.uint32),
            "dyn_sprint": np.zeros((S, N, 2), np.uint32),
            "dyn_list_h": np.zeros((S, N, L, 2), np.uint32),
            "dyn_list_n": np.zeros((S, N), np.int32),
            # string value that decodes as a JSON string-array
            "dyn_json_list": np.zeros((S, N), np.int8),
            # host-completion flag: list overflow, glob/unit-bearing
            # values, or glob-bearing guarded resource values —
            # anything hash lanes can't compare the way the oracle does
            "dyn_host": np.zeros((S, N), np.int8),
        }
        cache: Dict[Any, Tuple[bool, Any]] = {}
        # scope backend-failure poisoning to this batch: a dead backend
        # costs ONE retry budget here, not one per (slot, resource)
        begin_batch = getattr(self.data_sources, "begin_batch", None)
        if begin_batch is not None:
            begin_batch()
        try:
            return self._encode_dyn_cells(resources, operations,
                                          admission_infos, lanes, cache)
        finally:
            end_batch = getattr(self.data_sources, "end_batch", None)
            if end_batch is not None:
                end_batch()

    def _encode_dyn_cells(self, resources, operations, admission_infos,
                          lanes, cache):
        import json as _json

        from ..engine.contextloaders import load_context_entries
        from ..utils.wildcard import contains_wildcard

        L = self.DYN_LIST_L
        for ci, res in enumerate(resources):
            op = (operations[ci] if operations else "") or ""
            info = admission_infos[ci] if admission_infos else None
            # ONE context build per resource (image extraction is the
            # expensive part); every slot loads into a shallow fork so
            # entries one slot resolves never leak into another slot's
            # substitution or query
            base_ctx = _scan_json_context(res, op, info)
            for si, slot in enumerate(self.cps.dyn_slots):
                ctx = base_ctx.shallow_fork()
                key = None
                try:
                    from ..engine.variables import substitute_all

                    key = (si, _json.dumps(
                        substitute_all(ctx, slot.entries), sort_keys=True,
                        default=str))
                except Exception:  # noqa: BLE001
                    key = None  # request-dependent substitution failed
                if key is not None and key in cache:
                    ok, val = cache[key]
                else:
                    try:
                        load_context_entries(ctx, slot.entries,
                                             self.data_sources)
                        val = ctx.query(slot.query)
                        ok = True
                    except Exception:  # noqa: BLE001
                        ok, val = False, None
                    if key is not None:
                        cache[key] = (ok, val)
                if not ok:
                    lanes["dyn_type"][si, ci] = 0
                    continue
                self._fill_dyn_value(lanes, si, ci, val, L)
                # guarded resource paths: glob-bearing string values
                # defeat hash membership -> host completes the cell
                for segs in slot.guard_paths:
                    for v in _walk_values(res, segs):
                        if isinstance(v, str) and contains_wildcard(v):
                            lanes["dyn_host"][si, ci] = 1
        return lanes

    @staticmethod
    def _fill_dyn_value(lanes, si, ci, val, L):
        from ..engine.pattern import go_parse_float
        from ..utils.duration import parse_duration
        from ..utils.quantity import parse_quantity
        from ..utils.wildcard import contains_wildcard
        from .flatten import go_sprint
        from .hashing import canon_number, hash_str, split32

        if isinstance(val, bool):
            lanes["dyn_type"][si, ci] = 2
            lanes["dyn_bool"][si, ci] = 1 if val else 0
            lanes["dyn_as_bool"][si, ci] = 1 if val else 0
        elif isinstance(val, (int, float)):
            lanes["dyn_type"][si, ci] = 3
            lanes["dyn_num"][si, ci] = float(val)
            lanes["dyn_has_num"][si, ci] = 1
            lanes["dyn_num_h"][si, ci] = split32(canon_number(val))
        elif isinstance(val, str):
            lanes["dyn_type"][si, ci] = 4
            lanes["dyn_sprint"][si, ci] = split32(hash_str(val, tag="s"))
            if val in ("true", "false"):
                lanes["dyn_as_bool"][si, ci] = 1 if val == "true" else 0
            f = go_parse_float(val)
            if f is not None:
                lanes["dyn_num"][si, ci] = f
                lanes["dyn_has_num"][si, ci] = 1
                lanes["dyn_num_h"][si, ci] = split32(canon_number(f))
            # globs act as patterns, unit strings coerce, and range
            # expressions compare structurally in the oracle — hash
            # equality can't see any of those
            from ..engine.operator import (Operator,
                                           get_operator_from_string_pattern)

            if contains_wildcard(val):
                lanes["dyn_host"][si, ci] = 1
            if (val != "0" and parse_duration(val) is not None) or \
                    (f is None and parse_quantity(val) is not None):
                lanes["dyn_host"][si, ci] = 1
            if get_operator_from_string_pattern(val) in (
                    Operator.IN_RANGE, Operator.NOT_IN_RANGE):
                lanes["dyn_host"][si, ci] = 1
            # a valid-JSON string-array value decodes for membership
            # (in.go keyExistsInArray / anyin.go _value_as_string_list)
            from ..engine.conditions import _value_as_string_list

            arr = _value_as_string_list(val)
            if arr is not None:
                lanes["dyn_json_list"][si, ci] = 1
                if len(arr) > L:
                    lanes["dyn_host"][si, ci] = 1
                n = 0
                for v in arr[:L]:
                    if contains_wildcard(v):
                        lanes["dyn_host"][si, ci] = 1
                    lanes["dyn_list_h"][si, ci, n] = split32(
                        hash_str(v, tag="s"))
                    n += 1
                lanes["dyn_list_n"][si, ci] = n
        elif val is None:
            lanes["dyn_type"][si, ci] = 1
        elif isinstance(val, list):
            lanes["dyn_type"][si, ci] = 5
            if len(val) > L:
                lanes["dyn_host"][si, ci] = 1
            n = 0
            for v in val[:L]:
                s = go_sprint(v)
                if s is None:
                    lanes["dyn_host"][si, ci] = 1
                    continue
                if contains_wildcard(s):
                    lanes["dyn_host"][si, ci] = 1
                lanes["dyn_list_h"][si, ci, n] = split32(hash_str(s, tag="s"))
                n += 1
            lanes["dyn_list_n"][si, ci] = n
        else:
            lanes["dyn_type"][si, ci] = 6


    # -- evaluation

    def bucket_size(self, n: int) -> int:
        b = self.MIN_BUCKET
        while b < n:
            b *= 2
        return b

    def pad(self, resources, operations=None, admission_infos=None):
        """Pad the batch to its bucket with empty resources."""
        n = len(resources)
        padded_n = self.bucket_size(max(n, 1))
        padded = list(resources) + [{} for _ in range(padded_n - n)]
        ops = (list(operations) + [""] * (padded_n - n)) if operations else None
        infos = (list(admission_infos) + [None] * (padded_n - n)) \
            if admission_infos else None
        return padded, ops, infos

    def warm_buckets(self, buckets: Sequence[int]) -> None:
        """Dispatch a batch of empty resources twice at each of
        ``buckets`` (bucket sizes), past the verdict cache: on CUDA the
        first dispatch is the bucket's eager run and the second captures
        its graph (``tpu/graphs.py``), so traffic at those buckets only
        replays. A failed capture raises ``KernelError``."""
        if not self.cps.device_programs:
            return
        for b in buckets:
            padded, _, _ = self.pad([{}] * b)
            if len(padded) != b:
                raise ValueError(f"{b} is not a bucket size (MIN_BUCKET "
                                 f"{self.MIN_BUCKET} times a power of two)")
            batch, _, _ = self.encode(padded)
            for _ in range(2):
                self._dispatch(batch, b, 0)
                self.take_pending_counts()

    def run(self, lanes: Dict[str, torch.Tensor]):
        """The compiled program on device lanes -> (table, counts)
        tensors on the device (asynchronous on CUDA; a CUDA graph
        replay per shape bucket, ``tpu/graphs.py``)."""
        return self.cps.device_fn(device=self.device)(lanes)

    def scan_device(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device layer only: the (device rules, n) int32 table as the
        program computed it (HOST and CONFIRM cells left in, host rules
        absent) and the (device rules, 7) int32 class counts over the
        n live columns (bucket-pad columns subtracted). The dispatch
        goes through the guarded ladder: a failed one gives the all-HOST
        table and its counts. A host encode error raises (the device
        layer has no scalar completion)."""
        n = len(resources)
        padded, ops, infos = self.pad(resources, operations, admission_infos)
        batch, _, _ = self.encode(padded, namespace_labels, ops, infos)
        table = np.ascontiguousarray(self._dispatch(batch, len(padded),
                                                    n)[:, :n])
        counts = self.take_pending_counts()
        if counts is None:
            counts = class_counts(table)
        return table, counts.astype(np.int32)

    # -- rule analytics (observability/analytics.py); this section and
    # the verdict-column caching below are copied from
    # kyverno_tpu/tpu/engine.py

    def rule_idents(self) -> List[RuleIdent]:
        """Per-rule analytics identities aligned with cps.rules rows:
        (policy spec hash, names, on-device placement). Exception-named
        rules report as host — that is where their verdicts resolve."""
        if self._rule_idents is None:
            hashes = self.cps.policy_spec_hashes()
            self._rule_idents = [
                RuleIdent(policy_hash=hashes[e.policy_idx],
                          policy_name=e.policy_name,
                          rule_name=e.rule_name,
                          on_device=(e.device_row is not None
                                     and ri not in self._exception_rules))
                for ri, e in enumerate(self.cps.rules)]
        return self._rule_idents

    def confirm_seen(self) -> bool:
        """Did the last scan() on this thread resolve any pattern-
        CONFIRM cell? Batch-scoped — scan() clears it at entry,
        assemble() sets it from the device table."""
        return bool(getattr(self._tls, "confirm_seen", False))

    # -- verdict-column caching (tpu/cache.py)

    @property
    def cache_eligible(self) -> bool:
        """A compiled set may serve verdicts from the content-addressed
        cache only when evaluation is a pure function of the cache key:
        no runtime dyn-operand slots, and no statically host-routed
        rule with context entries."""
        if self._cache_eligible is None:
            eligible = not self.cps.dyn_slots
            if eligible:
                for ri, entry in enumerate(self.cps.rules):
                    if (entry.device_row is not None
                            and ri not in self._exception_rules):
                        continue
                    policy = self.cps.policies[entry.policy_idx]
                    for rule in policy.get_rules():
                        if rule.name == entry.rule_name and rule.context:
                            eligible = False
            self._cache_eligible = eligible
        return self._cache_eligible

    def verdict_cache_keys(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
        resource_hashes: Optional[Sequence[Optional[str]]] = None,
    ) -> Optional[List[Optional[Tuple[str, str, str]]]]:
        """Per-resource verdict-cache keys (policy-set key, resource
        content hash, request digest), or None when this engine is not
        cache eligible. An entry is None for a resource that cannot be
        content-hashed (it bypasses the cache). ``resource_hashes``
        lets a caller that holds the canonical sha-16 skip the
        re-serialization."""
        from .cache import request_digest, resource_content_hash

        if not self.cache_eligible:
            return None
        if self._cache_ident is None:
            self._cache_ident = self.cps.cache_key() + self._exceptions_digest
        ns_labels = namespace_labels or {}
        keys: List[Optional[Tuple[str, str, str]]] = []
        for ci, res in enumerate(resources):
            h = (resource_hashes[ci] if resource_hashes is not None
                 else resource_content_hash(res))
            if h is None:
                keys.append(None)
                continue
            try:
                meta = res.get("metadata") or {}
                nsl = ns_labels.get(
                    meta.get("name", "") if res.get("kind") == "Namespace"
                    else meta.get("namespace", ""), {})
            except Exception:  # not dict-shaped
                keys.append(None)
                continue
            op = (operations[ci] if operations else "") or ""
            info = admission_infos[ci] if admission_infos else None
            keys.append((self._cache_ident, h,
                         request_digest(nsl, op, info)))
        return keys

    def scan(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
        live_n: Optional[int] = None,
    ) -> ScanResult:
        """The complete ScanResult over ALL rules. Verdict columns of
        content-identical (resource, request) pairs restore from the
        verdict cache; only the misses pay encode + dispatch through
        ``_scan_uncached`` (columns are independent in the program, so
        a miss-only sub-batch gives the same columns). ``live_n`` marks
        the first N resources as real for the rule analytics (padding
        resources must not inflate not-matched counts)."""
        from .cache import global_verdict_cache as vc

        self._tls.confirm_seen = False  # batch-scoped (see confirm_seen)
        keys = (self.verdict_cache_keys(resources, namespace_labels,
                                        operations, admission_infos)
                if vc.enabled else None)
        if keys is None:
            if vc.enabled:
                vc.bypass()
            return self._scan_uncached(resources, namespace_labels,
                                       operations, admission_infos,
                                       live_n=live_n)
        n = len(resources)
        rules = [(e.policy_name, e.rule_name) for e in self.cps.rules]
        total = np.full((len(rules), n), NOT_MATCHED, dtype=np.int32)
        miss: List[int] = []
        hits: List[int] = []
        for i, key in enumerate(keys):
            col = (vc.get(key, expect_rows=len(rules))
                   if key is not None else None)
            if col is None:
                miss.append(i)
            else:
                hits.append(i)
                total[:, i] = col
        if miss:
            # miss indices ascend and pad resources are a suffix, so the
            # sub-batch's live prefix is a count
            sub_live = (sum(1 for i in miss if i < live_n)
                        if live_n is not None else None)
            sub = self._scan_uncached(
                [resources[i] for i in miss], namespace_labels,
                [operations[i] for i in miss] if operations else None,
                [admission_infos[i] for i in miss] if admission_infos
                else None, live_n=sub_live)
            for j, i in enumerate(miss):
                total[:, i] = sub.verdicts[:, j]
                if keys[i] is not None:
                    vc.put(keys[i], sub.verdicts[:, j])
        if hits and global_rule_stats.enabled:
            # cache-served verdicts still count: replay the hit columns
            # so a warm rescan reports the same rule stats as a cold one
            live_hits = ([i for i in hits if i < live_n]
                         if live_n is not None else hits)
            if live_hits:
                global_rule_stats.ingest_table(
                    self.rule_idents(), total[:, live_hits],
                    source="cached")
                self.record_pattern_replay(len(live_hits))
        return ScanResult(verdicts=total, rules=rules)

    def record_pattern_replay(self, n_cols: int) -> None:
        """Pattern-cell accounting for cache-served verdict columns, as
        the cold scan that populated the cache counted them (cached
        columns count as path=device)."""
        if not n_cols:
            return
        for ri, entry in enumerate(self.cps.rules):
            if entry.device_row is None or ri in self._exception_rules:
                if entry.pattern_host:
                    global_pattern_cells.record(entry.policy_name,
                                                host=n_cols)
                continue
            if getattr(self.cps.device_programs[entry.device_row],
                       "uses_patterns", False):
                global_pattern_cells.record(entry.policy_name,
                                            device=n_cols)

    def _scan_uncached(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
        live_n: Optional[int] = None,
    ) -> ScanResult:
        """Encode, one guarded dispatch, ``assemble``. A batch whose
        encode raises is quarantined (``_scan_quarantining``)."""
        n = len(resources)
        padded, ops, infos = self.pad(resources, operations, admission_infos)
        t_enc0 = time.perf_counter()
        try:
            with global_profiler.phase(PHASE_ENCODE), \
                    global_tracer.span("tpu.encode", resources=n,
                                       padded=len(padded)):
                batch, _, _ = self.encode(padded, namespace_labels, ops,
                                          infos)
        except Exception:
            # a hostile resource broke batch encoding: quarantine it so
            # the rest of the batch still evaluates (device or scalar),
            # and the bad resource degrades to scalar / per-rule ERROR
            return self._scan_quarantining(resources, namespace_labels,
                                           operations, admission_infos,
                                           live_n=live_n)
        t_enc = time.perf_counter() - t_enc0
        t_disp0 = time.perf_counter()
        table = self._dispatch(batch, len(padded), n)[:, :n]
        # feed accounting: while the host encoded, the device sat idle;
        # only when the device actually ran
        if last_dispatch_path() == PATH_DEVICE:
            global_starvation.record(busy_s=time.perf_counter() - t_disp0,
                                     starved_s=t_enc)
        return self.assemble(table, resources, namespace_labels, operations,
                             admission_infos, live_n=live_n)

    # -- the guarded dispatch ladder (kyverno_tpu/tpu/engine.py:840-1043)

    def set_pending_counts(self, counts: Optional[np.ndarray]) -> None:
        """Stash the device's per-rule verdict-class counts for the
        caller that follows on this thread
        (kyverno_tpu/tpu/engine.py:set_pending_counts). With a
        corrupt-mode fault armed at the dispatch site the table read
        back may be altered behind the counts: drop them, so the caller
        counts the (corrupted) table it actually serves."""
        if counts is not None:
            spec = global_faults.armed().get(SITE_TPU_DISPATCH)
            if spec is not None and spec.mode == "corrupt":
                counts = None
        self._tls.pending_counts = counts

    def take_pending_counts(self) -> Optional[np.ndarray]:
        """The last dispatch's (device rules, 7) counts over its live
        columns on this thread (None after a fallback)."""
        counts = getattr(self._tls, "pending_counts", None)
        self._tls.pending_counts = None
        if counts is not None and (
                not isinstance(counts, np.ndarray)
                or counts.shape != (len(self.cps.device_programs),
                                    NUM_CLASSES)):
            return None
        return counts

    def _breaker_open_fallback(self) -> None:
        from ..observability.metrics import global_registry

        self._tls.pending_counts = None  # no device truth this batch
        set_dispatch_path(PATH_SCALAR_FALLBACK)
        global_registry.breaker_fallback.inc({"reason": "open"})
        global_tracer.add_event("breaker_fallback", reason="open",
                                breaker=self.breaker.name)

    def _record_dispatch_failure(self, e: Exception) -> None:
        from ..observability.metrics import global_registry
        from ..parallel.sharding import MeshPeerFailed

        # a stash from a dispatch that then failed validation must not
        # masquerade as truth for the all-HOST fallback table
        self._tls.pending_counts = None
        reason = "error"
        if isinstance(e, MeshPeerFailed):
            # a peer of a cross-process mesh (or the collective between
            # the ranks) failed, after this rank's card ran its part: a
            # success for this card's breaker, which the admission path
            # shares, and it ends a half-open probe
            reason = "mesh_peer"
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        set_dispatch_path(PATH_SCALAR_FALLBACK)
        global_registry.breaker_fallback.inc({"reason": reason})
        global_tracer.add_event(
            "breaker_fallback", reason=reason, breaker=self.breaker.name,
            breaker_state=self.breaker.state,
            error=f"{type(e).__name__}: {e}")

    def _record_kernel_error(self, e: KernelError) -> None:
        from ..observability.metrics import global_registry

        self._tls.pending_counts = None
        global_registry.kernel_errors.inc()
        global_tracer.add_event("kernel_error",
                                error=f"{type(e).__name__}: {e}")

    def guarded_dispatch(self, dispatch_fn, want_shape) -> Optional[np.ndarray]:
        """The ONE breaker-gated dispatch ladder (shared with
        ShardedScanner so the two paths cannot drift): fault hook,
        dispatch, corrupt filter, shape/dtype validation, breaker
        bookkeeping. Returns the validated verdict table, or None when
        the breaker is open or the dispatch failed — the caller falls
        back to scalar completion (all-HOST). A ``KernelError`` (a
        kernel of the port that fails to build, load or launch, or a
        failed CUDA-graph capture) is counted as ``kernel_errors`` and
        raised."""
        self._tls.pending_counts = None
        if not self.breaker.allow():
            self._breaker_open_fallback()
            return None
        try:
            with global_tracer.span("tpu.dispatch",
                                    breaker=self.breaker.state) as span:
                global_faults.fire(SITE_TPU_DISPATCH)
                if _sanitizer.ENABLED:
                    # lock-order sanitizer: any lock held across the
                    # device call serializes its waiters behind it
                    _sanitizer.note_device_dispatch()
                table = dispatch_fn()
                table = self._validate_device_table(table, want_shape)
                span.attributes["engine"] = PATH_DEVICE
                return table
        except KernelError as e:
            # a kernel of the port failed to build, load or launch, or
            # the program to be captured: the program is at fault, not
            # the batch, so it is raised (the breaker is left alone)
            self._record_kernel_error(e)
            raise
        except Exception as e:
            self._record_dispatch_failure(e)
            return None

    def guarded_launch(self, launch_fn) -> Optional[Tuple[Any]]:
        """Phase 1 of the pipelined ladder (tpu/pipeline.py): breaker
        gate, fault hook and ``launch_fn``, which enqueues the batch's
        copy, the program and the table's copy back and returns at
        once. Returns an opaque in-flight handle for
        ``guarded_complete``, or None when the breaker is open or the
        launch raised — the fallback of ``guarded_dispatch``. A
        ``KernelError`` is counted and raised, as there."""
        self._tls.pending_counts = None
        if not self.breaker.allow():
            self._breaker_open_fallback()
            return None
        try:
            global_faults.fire(SITE_TPU_DISPATCH)
            if _sanitizer.ENABLED:
                _sanitizer.note_device_dispatch()
            return (launch_fn(),)
        except KernelError as e:
            self._record_kernel_error(e)
            raise
        except Exception as e:
            self._record_dispatch_failure(e)
            return None

    def guarded_complete(self, handle: Optional[Tuple[Any]], readback_fn,
                         want_shape) -> Optional[np.ndarray]:
        """Phase 2: ``readback_fn`` (waits for the launch and reads the
        table back), the corrupt filter, shape/dtype validation and the
        breaker's bookkeeping. A None handle (a failed launch) passes
        through as None — the caller completes on the scalar engine, as
        after a failed ``guarded_dispatch``."""
        if handle is None:
            return None
        try:
            return self._validate_device_table(readback_fn(handle[0]),
                                               want_shape)
        except KernelError as e:
            self._record_kernel_error(e)
            raise
        except Exception as e:
            self._record_dispatch_failure(e)
            return None

    def _validate_device_table(self, table, want_shape) -> np.ndarray:
        table = global_faults.corrupt(SITE_TPU_DISPATCH, table)
        if not (isinstance(table, np.ndarray)
                and table.shape == want_shape
                and np.issubdtype(table.dtype, np.integer)):
            raise DeviceResultError(
                f"device returned shape "
                f"{getattr(table, 'shape', None)}, want {want_shape}")
        self.breaker.record_success()
        set_dispatch_path(PATH_DEVICE)
        return table

    def _dispatch(self, batch, padded_n: int,
                  n_live: Optional[int] = None) -> np.ndarray:
        """One device dispatch through the guarded ladder. Any failure
        returns an all-HOST table, which routes the WHOLE batch through
        the scalar engine in assemble(): verdicts stay the same, only
        latency degrades. The program's verdict-class counts are
        stashed (pad columns subtracted) for the caller."""
        if n_live is None:
            n_live = padded_n

        def run():
            with maybe_xla_trace():
                with global_profiler.phase(PHASE_DISPATCH):
                    out = self.run(lanes_to_device(batch, self.device))
                with global_profiler.phase(PHASE_READBACK):
                    # tolerate monkeypatched programs that still return
                    # a bare verdict table
                    if isinstance(out, tuple):
                        table = out[0].cpu().numpy()
                        counts = out[1].cpu().numpy()
                    else:
                        table, counts = out.cpu().numpy(), None
            if counts is not None and table.ndim == 2:
                # bucket-pad columns are encoded empties, not workload
                counts = counts.astype(np.int64) - class_counts(
                    table[:, n_live:])
            self.set_pending_counts(counts)
            return table

        D = len(self.cps.device_programs)
        table = self.guarded_dispatch(run, (D, padded_n))
        if table is None:
            return np.full((D, padded_n), HOST, dtype=np.int32)
        return table

    def _scan_quarantining(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
        live_n: Optional[int] = None,
    ) -> ScanResult:
        """Batch encode failed: split the batch into resources that
        encode alone (re-scanned as a clean sub-batch) and hostile ones,
        which complete per (policy, resource) on the scalar engine — a
        policy the scalar engine ALSO cannot evaluate yields per-rule
        ERROR verdicts instead of aborting the scan."""
        n = len(resources)
        good: List[int] = []
        bad: List[int] = []
        for ci, res in enumerate(resources):
            op = [(operations[ci] if operations else "") or ""]
            info = [admission_infos[ci]] if admission_infos else None
            try:
                # STRUCTURAL probe only (rows + meta lanes): dyn-lane
                # encoding does real context-backend I/O and catches its
                # own load errors. A dyn-lane value that still throws
                # re-enters quarantine from the good sub-batch's scan.
                encode_resources([res], self.cps.encode_cfg,
                                 self.cps.byte_paths, self.cps.key_byte_paths)
                encode_metadata([res], namespace_labels, op, info,
                                self.cps.meta_cfg)
                good.append(ci)
            except Exception:
                bad.append(ci)
        if not bad:
            # batch-level failure with no single culprit: degrade the
            # whole batch to the scalar path rather than loop forever
            good, bad = [], list(range(n))
        total = np.full((len(self.cps.rules), n), NOT_MATCHED, dtype=np.int32)
        if good:
            sub = self.scan(
                [resources[i] for i in good], namespace_labels,
                [operations[i] for i in good] if operations else None,
                [admission_infos[i] for i in good] if admission_infos
                else None,
                live_n=(sum(1 for i in good if i < live_n)
                        if live_n is not None else None))
            total[:, good] = sub.verdicts
        ns_labels = namespace_labels or {}
        for ci in bad:
            res = resources[ci]
            op = (operations[ci] if operations else "") or ""
            info = admission_infos[ci] if admission_infos else None
            try:
                kind = res.get("kind", "")
                meta = res.get("metadata") or {}
                nsl = ns_labels.get(
                    meta.get("name", "") if kind == "Namespace"
                    else meta.get("namespace", ""), {})
            except Exception:  # not even dict-shaped
                nsl = {}
            for pi, policy in enumerate(self.cps.policies):
                try:
                    pctx = build_scan_context(policy, res, nsl, op, info)
                    verdicts = _scalar_rule_verdicts(self.scalar, policy,
                                                     pctx)
                except Exception:
                    verdicts = None  # ERROR every rule of this policy
                for ri, entry in enumerate(self.cps.rules):
                    if entry.policy_idx != pi:
                        continue
                    total[ri, ci] = ERROR if verdicts is None \
                        else verdicts.get(entry.rule_name, NOT_MATCHED)
        # analytics: the good sub-batch ingested inside self.scan();
        # only the quarantined columns are counted here
        live_bad = [ci for ci in bad if live_n is None or ci < live_n]
        if live_bad and global_rule_stats.enabled:
            global_rule_stats.ingest_table(self.rule_idents(),
                                           total[:, live_bad],
                                           source="quarantine")
        return ScanResult(
            verdicts=total,
            rules=[(e.policy_name, e.rule_name) for e in self.cps.rules],
        )

    def assemble(
        self,
        device_table: np.ndarray,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
        live_n: Optional[int] = None,
    ) -> ScanResult:
        """Merge device verdicts with host completions (host rules,
        exception-named rules, HOST and CONFIRM cells), then fold the
        batch into the rule analytics — kyverno_tpu/tpu/engine.py:
        TpuEngine.assemble."""
        from ..engine.match import matches_resource_description

        n = len(resources)
        total = np.full((len(self.cps.rules), n), NOT_MATCHED, dtype=np.int32)
        ns_labels = namespace_labels or {}
        # assigned, not sticky: the pipelined scan calls assemble() per
        # chunk without going through scan()
        self._tls.confirm_seen = bool(
            (np.asarray(device_table) == CONFIRM).any())

        # requests whose identity strings carry globs defeat the
        # device's hash-equality userInfo lanes (_set_in matches
        # wildcards in either direction) -> per-cell host completion
        glob_identity_cis: List[int] = []
        if admission_infos:
            from ..utils.wildcard import contains_wildcard

            for ci in range(n):
                info = admission_infos[ci] if ci < len(admission_infos) else None
                if info is not None and any(
                        contains_wildcard(g) for g in (info.groups or [])):
                    glob_identity_cis.append(ci)

        # which (policy, resource) pairs need the scalar engine? HOST
        # and CONFIRM cells both resolve there; CONFIRM cells are
        # attributed in the pattern-cell accounting
        host_cells: Dict[Tuple[int, int], None] = {}
        live = n if live_n is None else min(live_n, n)
        for ri, entry in enumerate(self.cps.rules):
            if entry.device_row is None or ri in self._exception_rules:
                for ci in range(n):
                    host_cells[(entry.policy_idx, ci)] = None
                if entry.pattern_host and live:
                    global_pattern_cells.record(entry.policy_name,
                                                host=live)
            else:
                row = device_table[entry.device_row].copy()
                if glob_identity_cis and self.cps.device_programs[
                        entry.device_row].uses_userinfo:
                    row[glob_identity_cis] = HOST
                total[ri] = row
                for ci in np.nonzero(row >= HOST)[0]:
                    host_cells[(entry.policy_idx, int(ci))] = None
                if live and getattr(
                        self.cps.device_programs[entry.device_row],
                        "uses_patterns", False):
                    rowv = row[:live]
                    c = int((rowv == CONFIRM).sum())
                    h = int((rowv == HOST).sum())
                    global_pattern_cells.record(entry.policy_name,
                                                device=live - c - h,
                                                confirm=c)
                    if c:
                        try:
                            from ..observability.metrics import (
                                global_registry as _reg)
                            _reg.dfa_confirm_cells.inc(value=c)
                        except Exception:  # noqa: BLE001
                            pass

        cache: Dict[Tuple[int, int], Optional[Dict[str, int]]] = {}
        with global_profiler.phase(PHASE_HOST_COMPLETE):
            for (pi, ci) in host_cells:
                policy = self.cps.policies[pi]
                res = resources[ci]
                try:
                    kind = res.get("kind", "")
                    ns = (res.get("metadata") or {}).get("namespace", "")
                    nsl = ns_labels.get(
                        (res.get("metadata") or {}).get("name", "")
                        if kind == "Namespace" else ns, {})
                    op = (operations[ci] if operations else "") or ""
                    info = admission_infos[ci] if admission_infos else None
                    # pre-screen with the (cheap) matcher before paying
                    # for context construction + full validation
                    if not any(
                            not matches_resource_description(
                                res, rule, info, nsl,
                                policy_namespace=policy.namespace,
                                operation=op or "CREATE")
                            for rule in policy.get_rules()
                            if rule.has_validate()):
                        cache[(pi, ci)] = {}  # every rule NOT_MATCHED
                        continue
                    pctx = build_scan_context(policy, res, nsl, op, info)
                    cache[(pi, ci)] = _scalar_rule_verdicts(self.scalar,
                                                            policy, pctx)
                except Exception:
                    # the scalar engine itself choked on this (policy,
                    # resource): the cell reports per-rule ERROR, as the
                    # reference's does
                    cache[(pi, ci)] = None
        # merge indexed by policy: each rule row only visits its own
        # policy's completed cells
        by_policy: Dict[int, List[Tuple[int, Optional[Dict[str, int]]]]] = {}
        for (pi, ci), verdicts in cache.items():
            by_policy.setdefault(pi, []).append((ci, verdicts))
        # cells whose device verdict the host replaced, per device rule
        # — the analytics correction set
        replaced: Dict[int, List[int]] = {}
        for ri, entry in enumerate(self.cps.rules):
            cells = by_policy.get(entry.policy_idx)
            if not cells:
                continue
            host_rule = (entry.device_row is None
                         or ri in self._exception_rules)
            for ci, verdicts in cells:
                if host_rule or total[ri, ci] >= HOST:
                    # pre-screened cells carry no verdict rows: the
                    # whole policy was unmatched (HOST must not escape)
                    total[ri, ci] = ERROR if verdicts is None \
                        else verdicts.get(entry.rule_name, NOT_MATCHED)
                    if not host_rule:
                        replaced.setdefault(ri, []).append(ci)

        self._ingest_assembled(total, device_table, replaced, live_n)
        return ScanResult(
            verdicts=total,
            rules=[(e.policy_name, e.rule_name) for e in self.cps.rules],
        )

    def _ingest_assembled(self, total: np.ndarray, device_table: np.ndarray,
                          replaced: Dict[int, List[int]],
                          live_n: Optional[int]) -> None:
        """Exact per-rule verdict counts for one assembled batch
        (copied from kyverno_tpu/tpu/engine.py). With the device's
        counts stashed by the dispatch, a device rule's counts are
        those plus a correction per host-completed cell; without a
        stash (breaker fallback, scalar completion) one host reduction
        over the final table."""
        if not global_rule_stats.enabled or total.shape[0] == 0:
            return
        rules_n, n = total.shape
        dev_counts = self.take_pending_counts()
        if dev_counts is None:
            counts = class_counts(total)
            source = "host"
        else:
            counts = np.zeros((rules_n, NUM_CLASSES), dtype=np.int64)
            host_rows: List[int] = []
            for ri, entry in enumerate(self.cps.rules):
                if entry.device_row is None or ri in self._exception_rules:
                    host_rows.append(ri)
                    continue
                c = dev_counts[entry.device_row].astype(np.int64).copy()
                for ci in replaced.get(ri, ()):
                    c[int(device_table[entry.device_row, ci])] -= 1
                    c[int(total[ri, ci])] += 1
                counts[ri] = c
            if host_rows:
                counts[host_rows] = class_counts(total[host_rows])
            source = "device"
        if live_n is not None and live_n < n:
            counts = counts - class_counts(total[:, live_n:])
        global_rule_stats.ingest_counts(self.rule_idents(), counts,
                                        source=source)

    # -- mutate triage

    # mutate_cache_eligible, mutate_triage_cache_keys and the cached
    # triage_mutate are copied from kyverno_tpu/tpu/engine.py

    @property
    def mutate_cache_eligible(self) -> bool:
        """Mutate-side purity: no host-routed or excepted mutate rule
        carries context entries (the scalar patcher would load them
        live per request). Device-compiled triage rules are pure by
        construction."""
        if self._mutate_cache_eligible is None:
            eligible = True
            for mi, entry in enumerate(self.cps.mutate_entries):
                if (entry.device_row is not None
                        and mi not in self._exception_mutate_rules):
                    continue
                policy = self.cps.policies[entry.policy_idx]
                for rule in policy.get_rules():
                    if rule.name == entry.rule_name and rule.context:
                        eligible = False
            self._mutate_cache_eligible = eligible
        return self._mutate_cache_eligible

    def mutate_triage_cache_keys(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
    ) -> Optional[List[Optional[Tuple[str, str, str]]]]:
        """Verdict-cache keys for triage rows: the validate keys with a
        namespaced ident, so an (M,) triage column and an (R,) validate
        column for the same (resource, request) never collide."""
        if not self.mutate_cache_eligible:
            return None
        keys = self.verdict_cache_keys(resources, namespace_labels,
                                       operations, admission_infos)
        if keys is None:
            return None
        return [None if k is None else ("mutate|" + k[0], k[1], k[2])
                for k in keys]

    def triage_mutate(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
    ) -> MutateTriageResult:
        """Needs-mutation triage over the compiled mutate bank — the
        cached ladder of scan(): verdict-cache columns for warm
        (resource, request) pairs, ``_triage_uncached`` for the
        misses."""
        from ..observability.metrics import global_registry as reg
        from .cache import global_verdict_cache as vc

        rules = self.cps.mutate_rules
        m, n = len(rules), len(resources)
        if m == 0 or n == 0:
            return MutateTriageResult(np.zeros((m, n), dtype=np.int32), rules)
        keys = (self.mutate_triage_cache_keys(
                    resources, namespace_labels, operations,
                    admission_infos)
                if vc.enabled else None)
        if keys is None:
            return self._triage_uncached(resources, namespace_labels,
                                         operations, admission_infos)
        total = np.full((m, n), HOST, dtype=np.int32)
        miss: List[int] = []
        hits = 0
        for i, key in enumerate(keys):
            col = (vc.get(key, expect_rows=m)
                   if key is not None else None)
            if col is None:
                miss.append(i)
            else:
                hits += 1
                total[:, i] = col
        if hits:
            reg.mutate_triage.inc({"outcome": "cached"}, hits)
        if miss:
            sub = self._triage_uncached(
                [resources[i] for i in miss], namespace_labels,
                [operations[i] for i in miss] if operations else None,
                [admission_infos[i] for i in miss] if admission_infos
                else None)
            for j, i in enumerate(miss):
                total[:, i] = sub.verdicts[:, j]
                if keys[i] is not None:
                    vc.put(keys[i], sub.verdicts[:, j])
        return MutateTriageResult(verdicts=total, rules=rules)

    def _triage_uncached(
        self,
        resources: Sequence[Dict[str, Any]],
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        operations: Optional[Sequence[str]] = None,
        admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
    ) -> MutateTriageResult:
        """One device batch over the mutate bank
        (kyverno_tpu/tpu/engine.py:TpuEngine._triage_uncached).
        Host rows (bank host entries, excepted rules, userinfo globs)
        stay HOST; a host encode error or a failed dispatch (the guarded
        ladder, with the ``mutate.triage`` fault site) answers the whole
        batch HOST, as the reference's does — the coordinator then
        scalar-patches everything, bit-identically."""
        from ..observability.metrics import global_registry as reg

        rules = self.cps.mutate_rules
        m, n = len(rules), len(resources)
        total = np.full((m, n), HOST, dtype=np.int32)
        d = len(self.cps.mutate_programs)
        device_table = None
        if d:
            padded, ops, infos = self.pad(resources, operations,
                                          admission_infos)
            try:
                with global_profiler.phase(PHASE_ENCODE), \
                        global_tracer.span("tpu.encode_triage",
                                           resources=n, padded=len(padded)):
                    batch, _, _ = self.encode(padded, namespace_labels, ops,
                                              infos)
            except Exception:  # hostile resource: everything scalar
                batch = None
                self.triage_encode_fallbacks += 1
            if batch is not None:
                def run():
                    global_faults.fire(SITE_MUTATE_TRIAGE)
                    with maybe_xla_trace():
                        with global_profiler.phase(PHASE_DISPATCH):
                            out = self.cps.mutate_device_fn(
                                device=self.device)(
                                    lanes_to_device(batch, self.device))
                        with global_profiler.phase(PHASE_READBACK):
                            return out.cpu().numpy()

                device_table = self.guarded_dispatch(run, (d, len(padded)))
                if device_table is not None:
                    self.triage_dispatches += 1
        if device_table is not None:
            glob_cis: List[int] = []
            if admission_infos:
                from ..utils.wildcard import contains_wildcard

                for ci in range(n):
                    info = (admission_infos[ci]
                            if ci < len(admission_infos) else None)
                    if info is not None and any(
                            contains_wildcard(g)
                            for g in (info.groups or [])):
                        glob_cis.append(ci)
            for mi, entry in enumerate(self.cps.mutate_entries):
                if (entry.device_row is None
                        or mi in self._exception_mutate_rules):
                    continue  # stays HOST
                row = device_table[entry.device_row, :n].copy()
                if glob_cis and self.cps.mutate_programs[
                        entry.device_row].uses_userinfo:
                    row[glob_cis] = HOST
                total[mi] = row
            reg.mutate_triage.inc({"outcome": "device"})
        else:
            reg.mutate_triage.inc({"outcome": "fallback"})
        result = MutateTriageResult(verdicts=total, rules=rules)
        for label, count in result.counts().items():
            if count:
                reg.mutate_triage_rows.inc({"result": label}, count)
        return result
