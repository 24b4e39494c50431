# Copied from kyverno_tpu/tpu/cache.py, without enable_xla_compile_cache
# and xla_cache_dir: the port builds its kernels once by content hash.
"""Content-addressed result caches.

Hardware pattern-matching engines get their throughput by amortizing:
compiled automata are reused across packets, and identical flows skip
re-matching entirely (PAPERS: Hyperflex SIMD-DFA DPI; in-memory
pattern-matching codesign). This module brings the same two levers to
the policy engine:

- **VerdictCache** — a bounded LRU keyed by content, not identity:
  (compiled-policy-set content key, resource content hash, digest of
  ns-labels/operation/userinfo) -> that resource's (num_rules,) verdict
  column. Repeat admissions of identical manifests and full rescans of
  a mostly-unchanged cluster skip encoding AND the device entirely.
  Invalidation is free: a policy mutation, quarantine change, config
  knob, or context-dep (compile-folded configmap) movement changes the
  policy-set key; a resource edit changes the resource hash; an
  ns-label or userinfo change changes the request digest. Nothing is
  ever explicitly flushed — stale keys just stop being looked up and
  age out of the LRU.

- **EncodeRowCache** — resource content hash (+ encode-path config
  key) -> the resource's encoded lane rows, trimmed to the rows it
  actually uses. A verdict-cache miss after a policy-set revision bump
  still skips the Python tree-walk re-encode of unchanged resources
  (the encode key deliberately excludes policy CONTENT — only the
  encode caps and compiled byte paths shape the rows).

Caching is only consulted when the compiled set is *cache eligible*
(TorchEngine.cache_eligible): no runtime dyn-operand slots (those do real
context-backend I/O per request) and no host-routed rule with context
entries (the scalar oracle would do live I/O). Compile-time folded
configmaps are fine — their content hashes ride the policy-set key.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


def digest(*parts: Any) -> str:
    """Stable short digest over JSON-serializable parts."""
    payload = json.dumps(parts, sort_keys=True, default=str,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def resource_content_hash(resource: Any) -> Optional[str]:
    """Content hash of one resource dict; None when the object is not
    canonically hashable (non-JSON values) — such resources simply
    bypass the caches, they are never mis-keyed. MUST stay the same
    function as cluster/snapshot.py resource_hash (asserted in tests):
    the scanner threads the snapshot's stored hashes into
    verdict_cache_keys instead of re-serializing every body."""
    try:
        payload = json.dumps(resource, sort_keys=True,
                             separators=(",", ":"))
    except (TypeError, ValueError):
        return None
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def request_digest(ns_labels: Optional[Dict[str, str]], operation: str,
                   info: Any) -> str:
    """Digest of the per-request evaluation context that is NOT the
    resource body: the resource's namespace labels (namespaceSelector
    results can flip without the resource changing), the admission
    operation (raw — '' and 'CREATE' evaluate differently), and the
    requesting identity."""
    ident: Tuple = ()
    if info is not None:
        ident = (getattr(info, "username", ""), getattr(info, "uid", ""),
                 tuple(getattr(info, "groups", ()) or ()),
                 tuple(getattr(info, "roles", ()) or ()),
                 tuple(getattr(info, "cluster_roles", ()) or ()))
    return digest(sorted((ns_labels or {}).items()), operation or "", ident)


class LruCache:
    """Thread-safe bounded LRU. ``capacity <= 0`` disables the cache
    (get always misses, put is a no-op) — the disable knob the CLI
    flags and tests use."""

    def __init__(self, capacity: int, name: str = "lru"):
        self.name = name
        self._capacity = int(capacity)
        self._data: "OrderedDict[Any, Any]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.evictions = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = int(capacity)
            while len(self._data) > max(self._capacity, 0):
                self._data.popitem(last=False)
                self.evictions += 1

    @property
    def enabled(self) -> bool:
        return self._capacity > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key: Any) -> Optional[Any]:
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key: Any, value: Any) -> None:
        if self._capacity <= 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self._capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class VerdictCache:
    """LRU of verdict COLUMNS: key -> (num_rules,) int32 array. Values
    are stored and returned as copies so callers can never alias a
    cached column into a mutable verdict table."""

    def __init__(self, capacity: Optional[int] = None, metrics=None):
        if capacity is None:
            capacity = _env_int("KYVERNO_TPU_VERDICT_CACHE", 65536)
        self._lru = LruCache(capacity, name="verdict")
        self._metrics = metrics
        # optional fleet fan-out hook (fleet/manager.py): called with
        # (key, column) AFTER a locally computed column lands, so one
        # replica's scan warms its peers. Set/cleared by the fleet
        # manager; never called for peer-received columns (put with
        # fanout=False) — a column cannot ping-pong across the fleet.
        self.on_put = None

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    @property
    def enabled(self) -> bool:
        return self._lru.enabled

    @property
    def evictions(self) -> int:
        return self._lru.evictions

    def set_capacity(self, capacity: int) -> None:
        self._lru.set_capacity(capacity)

    def __len__(self) -> int:
        return len(self._lru)

    def clear(self) -> None:
        self._lru.clear()

    def get(self, key: Any,
            expect_rows: Optional[int] = None) -> Optional[np.ndarray]:
        """Lookup; with ``expect_rows`` a stored column whose length
        does not match the caller's compiled rule count is a MISS —
        the one place the wrong-shape defense lives (a hostile or
        racing fleet push may land a length-consistent column under a
        content key before the receive-side shape check can know the
        active rule count; no reader may crash on it)."""
        m = self._registry()
        col = self._lru.get(key)
        if col is not None and expect_rows is not None \
                and col.shape[0] != expect_rows:
            col = None
        if col is None:
            m.verdict_cache.inc({"outcome": "miss"})
            return None
        m.verdict_cache.inc({"outcome": "hit"})
        return col.copy()

    def bypass(self) -> None:
        """Count a scan that skipped the cache (ineligible set)."""
        self._registry().verdict_cache.inc({"outcome": "bypass"})

    def hit_rate(self) -> float:
        """Lifetime hit rate (hits / lookups) — the amortization signal
        /debug/utilization and the bench rollup surface."""
        m = self._registry()
        hits = m.verdict_cache.value({"outcome": "hit"})
        misses = m.verdict_cache.value({"outcome": "miss"})
        total = hits + misses
        return round(hits / total, 4) if total else 0.0

    def peek(self, key: Any) -> Optional[np.ndarray]:
        """Lookup WITHOUT hit/miss accounting — the fleet peer-fetch
        server path (a peer probing this cache must not skew the local
        hit-rate signal)."""
        col = self._lru.get(key)
        return col.copy() if col is not None else None

    def put(self, key: Any, column: np.ndarray,
            fanout: bool = True) -> None:
        if not self._lru.enabled:
            return
        before = self._lru.evictions
        self._lru.put(key, np.array(column, dtype=np.int32, copy=True))
        m = self._registry()
        evicted = self._lru.evictions - before
        if evicted:
            m.verdict_cache_evictions.inc(value=evicted)
        m.verdict_cache_size.set(len(self._lru))
        hook = self.on_put
        if fanout and hook is not None:
            try:
                hook(key, column)  # bounded enqueue, never blocks
            except Exception:
                pass


# per-resource row lanes stored trimmed to the rows the resource uses
# (everything past n_rows holds RowBatch defaults); pool slots trimmed
# to the last one carrying bytes
class _EncodedRows:
    __slots__ = ("lanes", "pool", "pool_len", "n_rows", "fallback")

    def __init__(self, lanes, pool, pool_len, n_rows, fallback):
        self.lanes = lanes
        self.pool = pool
        self.pool_len = pool_len
        self.n_rows = n_rows
        self.fallback = fallback


def extract_rows(batch, i: int) -> _EncodedRows:
    """Trim row ``i`` of an encoded RowBatch to the rows/pool slots it
    actually uses — the transferable per-resource form shared by the
    encode-row cache and the encoder-pool workers (encode/tasks.py),
    so pooled results and cached results are the same bytes."""
    m = int(batch.n_rows[i])
    lanes: Dict[str, np.ndarray] = {}
    for name, arr in batch.arrays().items():
        if name in ("pool", "pool_len", "n_rows", "fallback"):
            continue
        lanes[name] = arr[i, :m].copy()
    used = np.nonzero(batch.pool_len[i] > 0)[0]
    s = int(used.max()) + 1 if used.size else 0
    pool = batch.pool[i, :s].copy() if s else None
    pool_len = batch.pool_len[i, :s].copy() if s else None
    return _EncodedRows(lanes, pool, pool_len, m, int(batch.fallback[i]))


def apply_rows(entry: _EncodedRows, batch, i: int) -> None:
    """Write a trimmed per-resource row entry into row ``i`` of a fresh
    RowBatch (whose lanes still hold constructor defaults)."""
    for name, row in entry.lanes.items():
        getattr(batch, name)[i, : row.shape[0]] = row
    if entry.pool is not None:
        s = entry.pool.shape[0]
        batch.pool[i, :s] = entry.pool
        batch.pool_len[i, :s] = entry.pool_len
    batch.n_rows[i] = entry.n_rows
    batch.fallback[i] = entry.fallback


def apply_rows_multi(entries: Sequence[_EncodedRows], batch,
                     idxs: Sequence[int]) -> None:
    """Vectorized twin of ``apply_rows`` for a batch with >= 2 cache
    hits: ONE flat fancy-index scatter per lane across every hit row
    instead of a Python iteration per resource (bit-identical to the
    loop — asserted in tests). The dominant admission-warm case (most
    of a flush restores from the LRU or the columnar store) stops
    paying ~25 numpy scalar stores per resource."""
    if not entries:
        return
    if len(entries) == 1:
        apply_rows(entries[0], batch, idxs[0])
        return
    max_rows = batch.cfg.max_rows
    counts = np.array([e.n_rows for e in entries], dtype=np.int64)
    # flat destination indices: rows 0..m_i of each hit resource
    reps = np.repeat(np.asarray(idxs, dtype=np.int64) * max_rows, counts)
    within = np.concatenate([np.arange(m, dtype=np.int64) for m in counts]) \
        if counts.sum() else np.zeros((0,), dtype=np.int64)
    dst = reps + within
    lane_names = entries[0].lanes.keys()
    for name in lane_names:
        src = np.concatenate([e.lanes[name] for e in entries])
        getattr(batch, name).ravel()[dst] = src
    slots = batch.cfg.byte_pool_slots
    pdst: list = []
    psrc_pool: list = []
    psrc_len: list = []
    for e, i in zip(entries, idxs):
        if e.pool is None:
            continue
        s = e.pool.shape[0]
        pdst.append(i * slots + np.arange(s, dtype=np.int64))
        psrc_pool.append(e.pool)
        psrc_len.append(e.pool_len)
    if pdst:
        flat = np.concatenate(pdst)
        batch.pool.reshape(-1, batch.cfg.byte_pool_width)[flat] = \
            np.concatenate(psrc_pool)
        batch.pool_len.ravel()[flat] = np.concatenate(psrc_len)
    ia = np.asarray(idxs, dtype=np.int64)
    batch.n_rows[ia] = counts
    batch.fallback[ia] = np.array([e.fallback for e in entries],
                                  dtype=np.uint8)


class EncodeRowCache:
    """LRU of per-resource encoded rows. Keys are
    (encode-path key, resource content hash): the encode-path key
    covers the EncodeConfig caps and the compiled byte-path sets —
    everything that shapes the rows — and deliberately NOT the policy
    content, so a policy-set revision bump keeps every entry warm."""

    def __init__(self, capacity: Optional[int] = None, metrics=None):
        if capacity is None:
            capacity = _env_int("KYVERNO_TPU_ENCODE_CACHE", 8192)
        self._lru = LruCache(capacity, name="encode")
        self._metrics = metrics

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    @property
    def enabled(self) -> bool:
        return self._lru.enabled

    @property
    def evictions(self) -> int:
        return self._lru.evictions

    def set_capacity(self, capacity: int) -> None:
        self._lru.set_capacity(capacity)

    def __len__(self) -> int:
        return len(self._lru)

    def clear(self) -> None:
        self._lru.clear()

    def hit_rate(self) -> float:
        """Lifetime hit rate (hits / lookups)."""
        m = self._registry()
        hits = m.encode_cache.value({"outcome": "hit"})
        misses = m.encode_cache.value({"outcome": "miss"})
        total = hits + misses
        return round(hits / total, 4) if total else 0.0

    @staticmethod
    def encode_key(encode_cfg, byte_paths, key_byte_paths) -> str:
        return digest(
            (encode_cfg.max_rows, encode_cfg.max_instances,
             encode_cfg.byte_pool_slots, encode_cfg.byte_pool_width),
            sorted(byte_paths or ()), sorted(key_byte_paths or ()))

    def get_into(self, key: Any, batch, i: int) -> bool:
        """Write the cached rows for ``key`` into row ``i`` of a fresh
        RowBatch (whose lanes still hold constructor defaults). Returns
        False on miss."""
        entry = self.get_entry(key)
        if entry is None:
            return False
        apply_rows(entry, batch, i)
        return True

    def get_entry(self, key: Any) -> Optional[_EncodedRows]:
        """The trimmed entry itself (hit/miss counted) — callers that
        collect several hits apply them in one vectorized pass via
        ``apply_rows_multi`` instead of a per-resource loop."""
        m = self._registry()
        entry: Optional[_EncodedRows] = self._lru.get(key)
        if entry is None:
            m.encode_cache.inc({"outcome": "miss"})
            return None
        m.encode_cache.inc({"outcome": "hit"})
        return entry

    def put_from(self, key: Any, batch, i: int) -> None:
        """Trim + store row ``i`` of an encoded RowBatch."""
        if not self._lru.enabled:
            return
        self.put_entry(key, extract_rows(batch, i))

    def put_entry(self, key: Any, entry: _EncodedRows) -> None:
        """Store an already-trimmed per-resource entry (the encoder
        pool's rows results arrive in this form — they warm the cache
        without a round-trip through a RowBatch)."""
        if not self._lru.enabled:
            return
        before = self._lru.evictions
        self._lru.put(key, entry)
        reg = self._registry()
        evicted = self._lru.evictions - before
        if evicted:
            reg.encode_cache_evictions.inc(value=evicted)


global_verdict_cache = VerdictCache()
global_encode_cache = EncodeRowCache()


def configure(verdict_capacity: Optional[int] = None,
              encode_capacity: Optional[int] = None) -> None:
    """Resize (0 disables) the process-wide caches — the CLI knobs."""
    if verdict_capacity is not None:
        global_verdict_cache.set_capacity(verdict_capacity)
    if encode_capacity is not None:
        global_encode_cache.set_capacity(encode_capacity)
