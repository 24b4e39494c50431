# Copied from kyverno_tpu/cluster/columnar.py (one line of the docstring
# reworded).
"""Columnar resource store — encoded rows, not JSON, are the system of
record between watch event and device batch.

The feed story so far: the encoder pool and
vectorized vocab encoder fixed encode CPU, but every rescan still
re-derived rows from raw JSON — the accelerator sustains billions of
rule-evals/s while the host re-walks objects that did not change. The
in-memory pattern-matching literature (PAPERS.md) wins sustained
throughput by keeping data resident in the engine's native layout;
this module is that layout for resources:

- **struct-of-arrays arenas**: one contiguous 1-D buffer per row lane
  (the ``EncodeRowCache._EncodedRows`` trimmed form persisted
  columnar) plus an offsets table, per encode-path key. Batch assembly
  is ONE vectorized fancy-index gather per lane — no per-resource
  Python loop, no JSON in sight.
- **incremental watch-diff encode**: a resource's rows are emitted in
  DFS order, so each top-level subtree occupies a contiguous row range
  (tpu/flatten.py ``encode_segment``/``compose_segments``). A watch
  upsert diffs the stored per-subtree hashes (cluster/snapshot.py
  ``subhashes_of``) and re-encodes only the touched subtrees, splicing
  the rest from the stored segments — bit-identical to a fresh full
  walk, asserted in tests.
- **mmap spill** (``serve --columnar-dir``): arenas back onto memmapped
  files so restarts (and anything else mapping the same directory —
  encode-pool workers, future fleet replicas) share warm rows
  zero-copy. A truncated or corrupt file is detected at load (sizes +
  content checksum) and the table rebuilds empty — degraded to cold,
  never wrong.

Feed-work accounting: full JSON walks count on
``kyverno_tpu_encode_json_walks_total`` and diff segment encodes on
``kyverno_tpu_encode_diff_segments_total`` — an unchanged-resource
rescan with the store warm moves NEITHER (scripts_columnar_gate.sh
asserts exactly that while holding verdicts bit-identical).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..resilience import storage as st
from ..tpu.cache import (EncodeRowCache, _EncodedRows, extract_rows,
                         resource_content_hash)
from ..tpu.flatten import (ROOT_HASH, VOCAB_MATRIX_FIELDS, EncodeConfig,
                           Segment, VocabBatch, _ROW_LANE_DTYPES, _ROW_LANES,
                           compose_segments, encode_resources, encode_segment,
                           vocab_lanes_from_unique)

_FMT_VERSION = 1


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def subtree_hash(value: Any) -> Optional[str]:
    """Content hash of ONE top-level subtree — the diff unit. Same
    canonical serialization family as cluster/snapshot.py
    resource_hash, so equal hashes mean equal value trees."""
    try:
        payload = json.dumps(value, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _within(counts: np.ndarray, total: int) -> np.ndarray:
    """[0..c0), [0..c1), ... flattened — the per-entry row offsets used
    by every gather (one vectorized expression, no Python loop)."""
    if total == 0:
        return np.zeros((0,), dtype=np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


class _UidSegs:
    """Per-live-resource diff state: the content hash last encoded and
    the per-top-level-key (subhash, Segment) records to splice from."""

    __slots__ = ("content_hash", "segs")

    def __init__(self, content_hash: str,
                 segs: List[Tuple[str, str, Segment]]):
        self.content_hash = content_hash
        self.segs = segs


class _LaneTable:
    """Arenas + offsets for ONE encode-path key (encode caps + compiled
    byte-path sets — the same key space as EncodeRowCache)."""

    GROW_MIN_ROWS = 4096
    GROW_MIN_SLOTS = 256
    GROW_MIN_ENTRIES = 1024

    def __init__(self, ekey: str, cfg: EncodeConfig, byte_paths,
                 key_byte_paths, directory: Optional[str] = None):
        self.ekey = ekey
        self.cfg = cfg
        self.byte_paths = frozenset(byte_paths or ())
        self.key_byte_paths = frozenset(key_byte_paths or ())
        self.dir = directory
        self.rows_used = 0
        self.pool_used = 0
        self.n_entries = 0
        self.dead_rows = 0
        self.dead_entries = 0
        self.dirty = False
        # degraded-storage memory mode: arenas fell back to anonymous
        # arrays after an I/O error; the dir path is KEPT so a heal
        # probe can rebuild the mmap backing (ColumnarStore.sync)
        self.memory_only = False
        self.ids: "OrderedDict[str, int]" = OrderedDict()  # hash -> eid
        self.uid_segs: "OrderedDict[str, _UidSegs]" = OrderedDict()
        self.lanes: Dict[str, np.ndarray] = {}
        self.pool: Optional[np.ndarray] = None
        self.pool_len: Optional[np.ndarray] = None
        # offsets table (entry id -> arena coordinates)
        self.row_off = np.zeros((0,), dtype=np.int64)
        self.ent_rows = np.zeros((0,), dtype=np.int32)
        self.pool_off = np.zeros((0,), dtype=np.int64)
        self.ent_slots = np.zeros((0,), dtype=np.int32)
        self.ent_fallback = np.zeros((0,), dtype=np.uint8)
        # global row vocabulary: rows interned ONCE at append (keyed by
        # their exact lane bytes), so batch assembly needs a fast 1-D
        # unique over int32 ids instead of a lexicographic sort of the
        # full row matrix. Derived data — rebuilt on load/compaction,
        # never persisted.
        self.row_vid = np.zeros((0,), dtype=np.int32)  # arena row -> vid
        self.vocab_rep = np.zeros((0,), dtype=np.int64)  # vid -> arena row
        self.row_vocab: Dict[bytes, int] = {}
        self._alloc_rows(self.GROW_MIN_ROWS)
        self._alloc_pool(self.GROW_MIN_SLOTS)

    def _row_keys(self, lanes: Dict[str, np.ndarray], n: int) -> List[bytes]:
        """Exact per-row identity: the row's concatenated lane bytes
        (equal keys <=> identical lane bytes on every lane)."""
        if not n:
            return []
        flat = np.concatenate(
            [np.ascontiguousarray(lanes[name][:n]).view(np.uint8)
             .reshape(n, -1) for name in _ROW_LANES], axis=1)
        return [flat[i].tobytes() for i in range(n)]

    def intern_rows(self, off: int, n: int,
                    lanes: Dict[str, np.ndarray]) -> None:
        """Assign vocabulary ids to freshly appended arena rows
        [off, off+n)."""
        if self.row_vid.shape[0] < off + n:
            cap = max(self.GROW_MIN_ROWS, self.row_vid.shape[0] * 2, off + n)
            arr = np.zeros((cap,), dtype=np.int32)
            arr[: self.row_vid.shape[0]] = self.row_vid
            self.row_vid = arr
        vocab = self.row_vocab
        for i, key in enumerate(self._row_keys(lanes, n)):
            vid = vocab.get(key)
            if vid is None:
                vid = len(vocab)
                vocab[key] = vid
                if self.vocab_rep.shape[0] <= vid:
                    cap = max(self.GROW_MIN_ROWS,
                              self.vocab_rep.shape[0] * 2, vid + 1)
                    arr = np.zeros((cap,), dtype=np.int64)
                    arr[: self.vocab_rep.shape[0]] = self.vocab_rep
                    self.vocab_rep = arr
                self.vocab_rep[vid] = off + i
            self.row_vid[off + i] = vid

    def rebuild_vocab(self) -> None:
        """Re-intern every resident arena row (post-load and
        post-compaction, where arena coordinates moved)."""
        self.row_vocab = {}
        self.row_vid = np.zeros((0,), dtype=np.int32)
        self.vocab_rep = np.zeros((0,), dtype=np.int64)
        self.intern_rows(0, self.rows_used, self.lanes)

    # -- arena allocation (in-memory or mmap-backed)

    def _lane_path(self, name: str) -> str:
        return os.path.join(self.dir, f"lane_{name}.bin")

    def _map(self, path: str, dtype, shape) -> np.ndarray:
        """Grow ``path`` to cover ``shape`` and map it read-write. The
        file only ever grows in place, so earlier views of the shorter
        prefix stay valid."""
        need = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if not os.path.exists(path) or os.path.getsize(path) < need:
            with open(path, "ab") as f:
                f.truncate(need)
        return np.memmap(path, dtype=dtype, mode="r+", shape=tuple(shape))

    def _alloc_rows(self, cap: int) -> None:
        cap = max(cap, self.GROW_MIN_ROWS)
        if self.lanes and next(iter(self.lanes.values())).shape[0] >= cap:
            return
        if self.dir and not self.memory_only:
            try:
                st.makedirs(self.dir, st.SURFACE_COLUMNAR)
                self.lanes = {name: self._map(self._lane_path(name),
                                              _ROW_LANE_DTYPES[name], (cap,))
                              for name in _ROW_LANES}
                return
            except OSError as e:
                # an arena grow hit the sick disk on the ENCODE path:
                # fall back to anonymous arrays so the append (and its
                # verdicts) proceed bit-identically — only durability
                # degrades, counted on the columnar surface
                st.storage_health(st.SURFACE_COLUMNAR).record_error(
                    e, op="map_rows")
                self.memory_only = True
        new = {name: np.zeros((cap,), dtype=_ROW_LANE_DTYPES[name])
               for name in _ROW_LANES}
        for name, arr in self.lanes.items():
            new[name][: arr.shape[0]] = arr
        self.lanes = new

    def _alloc_pool(self, cap: int) -> None:
        cap = max(cap, self.GROW_MIN_SLOTS)
        if self.pool is not None and self.pool.shape[0] >= cap:
            return
        w = self.cfg.byte_pool_width
        if self.dir and not self.memory_only:
            try:
                st.makedirs(self.dir, st.SURFACE_COLUMNAR)
                self.pool = self._map(os.path.join(self.dir, "pool.bin"),
                                      np.uint8, (cap, w))
                self.pool_len = self._map(
                    os.path.join(self.dir, "pool_len.bin"), np.int32, (cap,))
                return
            except OSError as e:
                st.storage_health(st.SURFACE_COLUMNAR).record_error(
                    e, op="map_pool")
                self.memory_only = True
        new_pool = np.zeros((cap, w), dtype=np.uint8)
        new_len = np.zeros((cap,), dtype=np.int32)
        if self.pool is not None:
            new_pool[: self.pool.shape[0]] = self.pool
            new_len[: self.pool_len.shape[0]] = self.pool_len
        self.pool, self.pool_len = new_pool, new_len

    def to_memory(self) -> None:
        """Degraded-storage memory mode: copy every mmap arena into an
        anonymous array and stop touching the disk. The dir path stays
        so ``remount()`` can rebuild the backing on heal."""
        if self.memory_only or not self.dir:
            self.memory_only = True
            return
        lanes = {name: np.array(arr) for name, arr in self.lanes.items()}
        pool = np.array(self.pool) if self.pool is not None else None
        pool_len = np.array(self.pool_len) \
            if self.pool_len is not None else None
        self.lanes, self.pool, self.pool_len = lanes, pool, pool_len
        self.memory_only = True
        self.dirty = True

    def remount(self) -> None:
        """Heal: rebuild the mmap backing from the anonymous arenas —
        fresh files written at current capacity, contents copied in.
        Raises OSError (leaving the memory arenas untouched) if the
        disk is still sick; the caller keeps the surface degraded."""
        if not self.memory_only or not self.dir:
            return
        st.makedirs(self.dir, st.SURFACE_COLUMNAR)
        new_lanes = {}
        for name in _ROW_LANES:
            arr = self._map(self._lane_path(name), _ROW_LANE_DTYPES[name],
                            self.lanes[name].shape)
            arr[:] = self.lanes[name]
            new_lanes[name] = arr
        new_pool = new_len = None
        if self.pool is not None:
            new_pool = self._map(os.path.join(self.dir, "pool.bin"),
                                 np.uint8, self.pool.shape)
            new_pool[:] = self.pool
            new_len = self._map(os.path.join(self.dir, "pool_len.bin"),
                                np.int32, self.pool_len.shape)
            new_len[:] = self.pool_len
        self.lanes, self.pool, self.pool_len = new_lanes, new_pool, new_len
        self.memory_only = False
        self.dirty = True  # next sync writes a fresh manifest

    def _ensure_entries(self, n: int) -> None:
        cap = self.row_off.shape[0]
        if n <= cap:
            return
        new_cap = max(self.GROW_MIN_ENTRIES, cap * 2, n)
        for attr, dtype in (("row_off", np.int64), ("ent_rows", np.int32),
                            ("pool_off", np.int64), ("ent_slots", np.int32),
                            ("ent_fallback", np.uint8)):
            old = getattr(self, attr)
            arr = np.zeros((new_cap,), dtype=dtype)
            arr[: old.shape[0]] = old
            setattr(self, attr, arr)

    def _grow_rows(self, need: int) -> None:
        cap = next(iter(self.lanes.values())).shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        self._alloc_rows(cap)

    def _grow_pool(self, need: int) -> None:
        cap = self.pool.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        self._alloc_pool(cap)

    def row_bytes(self) -> int:
        per_row = sum(np.dtype(_ROW_LANE_DTYPES[n]).itemsize
                      for n in _ROW_LANES)
        return (self.rows_used * per_row
                + self.pool_used * (self.cfg.byte_pool_width + 4))

    def checksum(self) -> str:
        return _content_checksum(self.lanes, self.pool, self.pool_len,
                                 self.rows_used, self.pool_used)


def _content_checksum(lanes: Dict[str, np.ndarray], pool: np.ndarray,
                      pool_len: np.ndarray, rows: int, slots: int) -> str:
    h = hashlib.sha256()
    h.update(f"{rows}:{slots}".encode())
    for name in _ROW_LANES:
        h.update(np.ascontiguousarray(lanes[name][:rows]).tobytes())
    h.update(np.ascontiguousarray(pool[:slots]).tobytes())
    h.update(np.ascontiguousarray(pool_len[:slots]).tobytes())
    return h.hexdigest()


def _entries_checksum(entries: Dict[str, Any], ids: List) -> str:
    payload = json.dumps([entries, ids], sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


class ColumnarStore:
    """Process-wide store of encoded resource rows, keyed by
    (encode-path key, resource content hash) like the encode-row LRU —
    but columnar, diff-maintained, gather-assembled, and optionally
    mmap-persistent. Thread-safe; segment walks run outside the lock."""

    def __init__(self, directory: Optional[str] = None,
                 capacity: Optional[int] = None,
                 uid_capacity: Optional[int] = None, metrics=None):
        self.dir = os.path.abspath(directory) if directory else None
        self.capacity = (capacity if capacity is not None
                         else _env_int("KYVERNO_TPU_COLUMNAR_ENTRIES",
                                       131072))
        self.uid_capacity = (uid_capacity if uid_capacity is not None
                             else _env_int("KYVERNO_TPU_COLUMNAR_UIDS",
                                           131072))
        self._tables: Dict[str, _LaneTable] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        self._metrics = metrics
        self.enabled = True
        # compaction floor: don't bother reclaiming under this many
        # dead rows (tests lower it to exercise the path)
        self.compact_min_rows = 1024
        if self.dir:
            try:
                st.makedirs(self.dir, st.SURFACE_COLUMNAR)
                with self._lock:
                    self._load_dir_locked()
            except OSError:
                # unwritable store dir at boot (counted + degraded by
                # the shim): every table starts in anonymous memory
                # mode; sync()'s probes rebuild the backing on heal
                pass

    def _registry(self):
        if self._metrics is None:
            from ..observability.metrics import global_registry

            self._metrics = global_registry
        return self._metrics

    # -- table plumbing

    @staticmethod
    def encode_key(cfg: EncodeConfig, byte_paths, key_byte_paths) -> str:
        return EncodeRowCache.encode_key(cfg, byte_paths, key_byte_paths)

    def _table_locked(self, cfg: EncodeConfig, byte_paths, key_byte_paths,
               ekey: Optional[str] = None) -> _LaneTable:
        ekey = ekey or self.encode_key(cfg, byte_paths, key_byte_paths)
        t = self._tables.get(ekey)
        if t is None:
            tdir = os.path.join(self.dir, ekey) if self.dir else None
            t = _LaneTable(ekey, cfg, byte_paths, key_byte_paths, tdir)
            self._tables[ekey] = t
        return t

    def _publish_gauges(self) -> None:
        m = self._registry()
        with self._lock:
            m.columnar_store_entries.set(
                sum(len(t.ids) for t in self._tables.values()))
            m.columnar_store_rows.set(
                sum(t.rows_used for t in self._tables.values()))
            m.columnar_store_bytes.set(
                sum(t.row_bytes() for t in self._tables.values()))

    # -- entry append / lookup

    def _append(self, t: _LaneTable, h: Optional[str],
                entry: _EncodedRows) -> int:
        """Insert a trimmed entry; idempotent by content hash. Caller
        holds the lock."""
        if h is not None:
            eid = t.ids.get(h)
            if eid is not None:
                t.ids.move_to_end(h)
                return eid
        n = int(entry.n_rows)
        s = int(entry.pool.shape[0]) if entry.pool is not None else 0
        t._grow_rows(t.rows_used + n)
        t._grow_pool(t.pool_used + s)
        off, po = t.rows_used, t.pool_used
        for name in _ROW_LANES:
            t.lanes[name][off:off + n] = entry.lanes[name]
        if s:
            t.pool[po:po + s] = entry.pool
            t.pool_len[po:po + s] = entry.pool_len
        t.intern_rows(off, n, entry.lanes)
        t.rows_used += n
        t.pool_used += s
        eid = t.n_entries
        t._ensure_entries(eid + 1)
        t.row_off[eid] = off
        t.ent_rows[eid] = n
        t.pool_off[eid] = po
        t.ent_slots[eid] = s
        t.ent_fallback[eid] = entry.fallback
        t.n_entries = eid + 1
        t.dirty = True
        if h is None:
            # unhashable resource: gatherable this batch, then garbage
            t.dead_rows += n
            t.dead_entries += 1
        else:
            t.ids[h] = eid
            while len(t.ids) > max(self.capacity, 1):
                _, dead = t.ids.popitem(last=False)
                t.dead_rows += int(t.ent_rows[dead])
                t.dead_entries += 1
        return eid

    def _entry_view(self, t: _LaneTable, eid: int) -> _EncodedRows:
        off, n = int(t.row_off[eid]), int(t.ent_rows[eid])
        po, s = int(t.pool_off[eid]), int(t.ent_slots[eid])
        lanes = {name: t.lanes[name][off:off + n] for name in _ROW_LANES}
        pool = t.pool[po:po + s] if s else None
        pool_len = t.pool_len[po:po + s] if s else None
        return _EncodedRows(lanes, pool, pool_len, n,
                            int(t.ent_fallback[eid]))

    def get_entry(self, ekey: str, h: Optional[str]) -> Optional[_EncodedRows]:
        """Zero-copy trimmed-entry view by (encode key, content hash) —
        the admission path's store tier under the encode-row LRU."""
        if h is None:
            return None
        m = self._registry()
        with self._lock:
            t = self._tables.get(ekey)
            eid = t.ids.get(h) if t is not None else None
            if eid is None:
                m.columnar_store.inc({"outcome": "miss"})
                return None
            t.ids.move_to_end(h)
            m.columnar_store.inc({"outcome": "hit"})
            return self._entry_view(t, eid)

    def put_entry(self, cfg: EncodeConfig, byte_paths, key_byte_paths,
                  h: Optional[str], entry: _EncodedRows) -> None:
        """Store an already-trimmed entry (encode-pool worker results
        and in-process misses land here so the next batch gathers)."""
        if h is None:
            return
        with self._lock:
            self._append(self._table_locked(cfg, byte_paths, key_byte_paths),
                         h, entry)
        self._publish_gauges()

    # -- encode (diff-aware get-or-encode)

    def _encode_entry(self, t: _LaneTable, resource: Any, h: Optional[str],
                      uid: Optional[str], subhashes: Optional[Dict[str, str]],
                      ) -> Tuple[_EncodedRows, Optional[List[Tuple[str, str, Segment]]]]:
        """Encode ONE resource outside the lock. Returns the trimmed
        entry and (for dict resources) the new segment records for the
        uid diff index."""
        m = self._registry()
        if (not isinstance(resource, dict) or h is None
                or ROOT_HASH in t.key_byte_paths):
            # non-dict roots and root-level wildcard-key policies keep
            # the full-walk semantics (counts a JSON walk)
            batch = encode_resources([resource], t.cfg, t.byte_paths,
                                     t.key_byte_paths)
            return extract_rows(batch, 0), None
        prev: Dict[Tuple[str, str], Segment] = {}
        if uid is not None:
            with self._lock:
                rec = t.uid_segs.get(uid)
                if rec is not None:
                    prev = {(k, sh): seg for (k, sh, seg) in rec.segs}
        segs: List[Segment] = []
        segrecs: List[Tuple[str, str, Segment]] = []
        reused = 0
        sub = subhashes or {}
        for k, v in resource.items():
            ks = k if type(k) is str else str(k)
            sh = sub.get(ks) or subtree_hash(v)
            seg = prev.get((ks, sh)) if sh is not None else None
            if seg is None:
                seg = encode_segment(ks, v, t.cfg, t.byte_paths,
                                     t.key_byte_paths)
            else:
                reused += 1
            segs.append(seg)
            segrecs.append((ks, sh or "", seg))
        if reused:
            m.columnar_segments_reused.inc(value=reused)
        lanes, pool, pool_len, n_rows, fallback, _ = compose_segments(
            len(resource), segs, t.cfg)
        return _EncodedRows(lanes, pool, pool_len, n_rows, fallback), segrecs

    def warm(self, cfg: EncodeConfig, byte_paths, key_byte_paths,
             resource: Any, h: Optional[str] = None,
             uid: Optional[str] = None,
             subhashes: Optional[Dict[str, str]] = None) -> bool:
        """Ensure ``resource`` has a live entry (diff-encoding against
        the uid's stored segments when possible). Returns True on a
        store hit. The scan loop pre-warms its miss set through here so
        chunk assembly is pure gather."""
        m = self._registry()
        if h is None:
            h = resource_content_hash(resource)
        with self._lock:
            t = self._table_locked(cfg, byte_paths, key_byte_paths)
            if h is not None and h in t.ids:
                t.ids.move_to_end(h)
                m.columnar_store.inc({"outcome": "hit"})
                if uid is not None:
                    rec = t.uid_segs.get(uid)
                    if rec is not None and rec.content_hash == h:
                        t.uid_segs.move_to_end(uid)
                return True
        m.columnar_store.inc({"outcome": "miss"})
        entry, segrecs = self._encode_entry(t, resource, h, uid, subhashes)
        with self._lock:
            self._append(t, h, entry)
            if uid is not None and segrecs is not None and h is not None:
                t.uid_segs[uid] = _UidSegs(h, segrecs)
                t.uid_segs.move_to_end(uid)
                while len(t.uid_segs) > max(self.uid_capacity, 1):
                    t.uid_segs.popitem(last=False)
        self._publish_gauges()
        return False

    def forget_uid(self, uid: str) -> None:
        with self._lock:
            for t in self._tables.values():
                t.uid_segs.pop(uid, None)

    # -- batch assembly (the vocab-form scan feed)

    def encode_vocab(self, resources: Sequence[Any], cfg: EncodeConfig,
                     byte_paths=None, key_byte_paths=None,
                     hashes: Optional[Sequence[Optional[str]]] = None,
                     ) -> VocabBatch:
        """Drop-in for flatten.encode_resources_vocab assembled from
        the store: hits gather straight from the arenas (one fancy
        index per lane), misses segment-encode into the store first.
        Dedup and lane packing ride the same VOCAB_MATRIX_FIELDS path
        as the fresh encoder, so densified rows are bit-identical."""
        m = self._registry()
        hs: List[Optional[str]] = list(hashes) if hashes else []
        for i in range(len(hs), len(resources)):
            hs.append(resource_content_hash(resources[i]))
        with self._lock:
            t = self._table_locked(cfg, byte_paths, key_byte_paths)
            missing = [i for i, h in enumerate(hs)
                       if h is None or h not in t.ids]
        hits = len(resources) - len(missing)
        if hits:
            m.columnar_store.inc({"outcome": "hit"}, value=hits)
        if missing:
            m.columnar_store.inc({"outcome": "miss"}, value=len(missing))
        encoded = [(i, hs[i], self._encode_entry(t, resources[i], hs[i],
                                                 None, None)[0])
                   for i in missing]
        with self._lock:
            fresh_eids: Dict[int, int] = {}
            for i, h, entry in encoded:
                fresh_eids[i] = self._append(t, h, entry)
            eids = np.empty((len(resources),), dtype=np.int64)
            for i, h in enumerate(hs):
                eid = t.ids.get(h) if h is not None else None
                if eid is None:
                    # freshly appended (anonymous, or evicted between
                    # the miss check and here under extreme pressure)
                    eid = fresh_eids.get(i)
                    if eid is None:
                        eid = self._append(t, h, self._encode_entry(
                            t, resources[i], h, None, None)[0])
                else:
                    t.ids.move_to_end(h)
                eids[i] = eid
            vb = self._gather_vocab(t, eids, cfg)
        self._publish_gauges()
        self.maybe_compact()
        return vb

    def _gather_vocab(self, t: _LaneTable, eids: np.ndarray,
                      cfg: EncodeConfig) -> VocabBatch:
        m = self._registry()
        counts = t.ent_rows[eids].astype(np.int64)
        offs = t.row_off[eids]
        total = int(counts.sum())
        vb = VocabBatch(len(eids), cfg)
        vb.n_rows[:] = counts.astype(np.int32)
        vb.fallback[:] = t.ent_fallback[eids]
        if total:
            src = np.repeat(offs, counts) + _within(counts, total)
            # rows were interned at append: dedup is a 1-D unique over
            # the int32 vocabulary ids, and the local vocabulary lanes
            # gather straight from each id's representative arena row
            # (no row-matrix sort — the former warm-path hot spot)
            uniq, inverse = np.unique(t.row_vid[src], return_inverse=True)
            dst = np.repeat(np.arange(len(eids), dtype=np.int64)
                            * cfg.max_rows, counts) + _within(counts, total)
            vb.row_idx.ravel()[dst] = \
                (inverse.reshape(-1) + 1).astype(np.int32)
            rep = t.vocab_rep[uniq]
            V = uniq.shape[0] + 1
            lanes = {name: np.zeros((V,), dtype=_ROW_LANE_DTYPES[name])
                     for name in _ROW_LANES}
            for l in ("scope1", "scope2", "byte_slot", "key_byte_slot"):
                lanes[l][0] = -1
            for name in _ROW_LANES:
                lanes[name][1:] = t.lanes[name][rep]
            vb.lanes = lanes
        else:
            vb.lanes = vocab_lanes_from_unique(
                np.zeros((0, len(VOCAB_MATRIX_FIELDS)), dtype=np.int64))
        sids: Dict[bytes, int] = {b"": 0}
        for col, eid in enumerate(eids):
            s = int(t.ent_slots[eid])
            if not s:
                continue
            po = int(t.pool_off[eid])
            for slot in range(s):
                ln = int(t.pool_len[po + slot])
                data = bytes(t.pool[po + slot, :ln])
                sid = sids.get(data)
                if sid is None:
                    sid = len(vb.strs)
                    sids[data] = sid
                    vb.strs.append(data)
                vb.pool_sidx[col, slot] = sid
        m.columnar_gather_rows.inc(value=total)
        return vb

    # -- compaction

    def maybe_compact(self) -> None:
        with self._lock:
            for t in self._tables.values():
                if (t.dead_rows > self.compact_min_rows
                        and t.dead_rows * 2 > t.rows_used):
                    self._compact(t)

    def _compact(self, t: _LaneTable) -> None:
        """Rebuild arenas from live entries (append order preserved).
        New buffers are fresh allocations — outstanding views keep the
        old arrays (or the old unlinked mmap inode) alive."""
        live = sorted(t.ids.items(), key=lambda kv: kv[1])
        order = np.array([eid for _, eid in live], dtype=np.int64)
        counts = t.ent_rows[order].astype(np.int64) if len(order) else \
            np.zeros((0,), dtype=np.int64)
        slots = t.ent_slots[order].astype(np.int64) if len(order) else \
            np.zeros((0,), dtype=np.int64)
        total = int(counts.sum())
        stotal = int(slots.sum())
        src = np.repeat(t.row_off[order], counts) + _within(counts, total)
        psrc = np.repeat(t.pool_off[order], slots) + _within(slots, stotal)
        old_lanes, old_pool, old_len = t.lanes, t.pool, t.pool_len
        t.lanes, t.pool, t.pool_len = {}, None, None
        wrote_disk = False
        if t.dir and not t.memory_only:
            # write fresh files then rename over: a concurrent reader's
            # old mapping survives on the unlinked inode
            try:
                for name in _ROW_LANES:
                    path = t._lane_path(name)
                    tmp = path + ".tmp"
                    data = old_lanes[name][src]
                    with st.open_truncate(tmp, st.SURFACE_COLUMNAR,
                                          binary=True) as f:
                        st.write_frame(
                            f, np.ascontiguousarray(data).tobytes(),
                            st.SURFACE_COLUMNAR, path=tmp)
                    st.atomic_replace(tmp, path, st.SURFACE_COLUMNAR)
                for path, data in ((os.path.join(t.dir, "pool.bin"),
                                    old_pool[psrc]),
                                   (os.path.join(t.dir, "pool_len.bin"),
                                    old_len[psrc])):
                    tmp = path + ".tmp"
                    with st.open_truncate(tmp, st.SURFACE_COLUMNAR,
                                          binary=True) as f:
                        st.write_frame(
                            f, np.ascontiguousarray(data).tobytes(),
                            st.SURFACE_COLUMNAR, path=tmp)
                    st.atomic_replace(tmp, path, st.SURFACE_COLUMNAR)
                wrote_disk = True
            except OSError:
                # mid-compaction I/O error (counted + degraded by the
                # shim): finish the compaction into anonymous arenas —
                # the row data lives in old_lanes/old_pool, nothing lost
                t.memory_only = True
        t.rows_used, t.pool_used = total, stotal
        t._alloc_rows(max(total, t.GROW_MIN_ROWS))
        t._alloc_pool(max(stotal, t.GROW_MIN_SLOTS))
        if not wrote_disk:
            if total:
                for name in _ROW_LANES:
                    t.lanes[name][:total] = old_lanes[name][src]
            if stotal:
                t.pool[:stotal] = old_pool[psrc]
                t.pool_len[:stotal] = old_len[psrc]
        # rebuild the offsets table + id map (LRU order preserved)
        t.n_entries = len(order)
        t._ensure_entries(t.n_entries)
        new_eid = {int(old): i for i, old in enumerate(order)}
        t.row_off[: t.n_entries] = np.cumsum(counts) - counts
        t.ent_rows[: t.n_entries] = counts
        t.pool_off[: t.n_entries] = np.cumsum(slots) - slots
        t.ent_slots[: t.n_entries] = slots
        t.ent_fallback[: t.n_entries] = t.ent_fallback[order] \
            if len(order) else 0
        t.ids = OrderedDict((h, new_eid[eid]) for h, eid in t.ids.items())
        t.dead_rows = t.dead_entries = 0
        t.rebuild_vocab()  # arena coordinates moved
        t.dirty = True
        self._registry().columnar_compactions.inc()

    # -- persistence

    def _manifest_path(self, t: _LaneTable) -> str:
        return os.path.join(t.dir, "manifest.json")

    def sync(self) -> None:
        """Flush dirty mmap tables + write their manifests atomically.
        In-memory stores no-op. The offsets snapshot is taken under the
        lock, but serialization, checksumming, and the disk write run
        OUTSIDE it — arena rows within the captured rows_used are
        immutable, so admission-path lookups never wait on a manifest
        dump. (A compaction racing this window swaps the arena files;
        the stale manifest then fails its checksum at the next load and
        the table rebuilds cold — degraded, never wrong — and the
        compaction re-marks the table dirty so the next sync repairs
        it.)"""
        if not self.dir:
            return
        health = st.storage_health(st.SURFACE_COLUMNAR)
        if not health.allow():
            return  # degraded, no probe due: stay on anonymous arenas
        if health.degraded:
            # a due re-probe: try to rebuild the mmap backing for every
            # memory-mode table; still-sick disks keep us degraded
            try:
                with self._lock:
                    for t in self._tables.values():
                        t.remount()
            except OSError as e:
                health.record_error(e, op="remount")
                return
            health.record_success()
        snaps = []
        with self._lock:
            for t in self._tables.values():
                if not t.dirty or not t.dir or t.memory_only:
                    continue
                n = t.n_entries
                snaps.append({
                    "t": t,
                    "lanes": dict(t.lanes),
                    "pool": t.pool, "pool_len": t.pool_len,
                    "manifest": {
                        "version": _FMT_VERSION,
                        "ekey": t.ekey,
                        "cfg": [t.cfg.max_rows, t.cfg.max_instances,
                                t.cfg.byte_pool_slots,
                                t.cfg.byte_pool_width],
                        "byte_paths": sorted(t.byte_paths),
                        "key_byte_paths": sorted(t.key_byte_paths),
                        "rows_used": t.rows_used,
                        "pool_used": t.pool_used,
                        "entries": {
                            "row_off": t.row_off[:n].tolist(),
                            "n_rows": t.ent_rows[:n].tolist(),
                            "pool_off": t.pool_off[:n].tolist(),
                            "pool_slots": t.ent_slots[:n].tolist(),
                            "fallback": t.ent_fallback[:n].tolist(),
                        },
                        "ids": list(t.ids.items()),
                        "dead_rows": t.dead_rows,
                        "dead_entries": t.dead_entries,
                    },
                })
                t.dirty = False
        for snap in snaps:
            t, man = snap["t"], snap["manifest"]
            try:
                for arr in list(snap["lanes"].values()) + [snap["pool"],
                                                           snap["pool_len"]]:
                    if isinstance(arr, np.memmap):
                        st.mmap_sync(arr, st.SURFACE_COLUMNAR, path=t.dir)
                man["checksum"] = _content_checksum(
                    snap["lanes"], snap["pool"], snap["pool_len"],
                    man["rows_used"], man["pool_used"])
                man["entries_checksum"] = _entries_checksum(
                    man["entries"], man["ids"])
                tmp = self._manifest_path(t) + ".tmp"
                with st.open_truncate(tmp, st.SURFACE_COLUMNAR) as f:
                    st.write_frame(f, json.dumps(man), st.SURFACE_COLUMNAR,
                                   path=tmp)
                st.atomic_replace(tmp, self._manifest_path(t),
                                  st.SURFACE_COLUMNAR)
            except OSError:
                # sick disk mid-sync (counted + degraded by the shim):
                # drop this table — and any we haven't flushed yet — to
                # anonymous arenas; reads keep serving bit-identically
                with self._lock:
                    t.dirty = True
                    for tbl in self._tables.values():
                        if tbl.dir:
                            tbl.to_memory()
                return

    def _load_dir_locked(self) -> None:
        """Reattach every valid table under ``self.dir``; anything
        truncated, corrupt, or mismatched is discarded and rebuilds
        cold (counted on kyverno_tpu_columnar_rebuilds_total) — a bad
        file can degrade a restart to a full re-encode, never to a
        wrong row."""
        for name in sorted(os.listdir(self.dir)):
            tdir = os.path.join(self.dir, name)
            if not os.path.isdir(tdir):
                continue
            try:
                t = self._load_table(name, tdir)
            except Exception:
                t = None
            if t is None:
                self._registry().columnar_rebuilds.inc()
                for fn in os.listdir(tdir):
                    try:
                        os.remove(os.path.join(tdir, fn))
                    except OSError:
                        pass
            else:
                self._tables[name] = t

    def _load_table(self, ekey: str, tdir: str) -> Optional[_LaneTable]:
        mpath = os.path.join(tdir, "manifest.json")
        with open(mpath) as f:
            man = json.load(f)
        if man.get("version") != _FMT_VERSION or man.get("ekey") != ekey:
            return None
        cfg = EncodeConfig(*man["cfg"])
        t = _LaneTable(ekey, cfg, man["byte_paths"], man["key_byte_paths"],
                       tdir)
        rows, slots = int(man["rows_used"]), int(man["pool_used"])
        for lane in _ROW_LANES:
            path = t._lane_path(lane)
            need = rows * np.dtype(_ROW_LANE_DTYPES[lane]).itemsize
            if not os.path.exists(path) or os.path.getsize(path) < need:
                return None
        if os.path.getsize(os.path.join(tdir, "pool.bin")) < \
                slots * cfg.byte_pool_width or \
                os.path.getsize(os.path.join(tdir, "pool_len.bin")) < \
                slots * 4:
            return None
        if rows < 0 or slots < 0:
            return None
        ent = man["entries"]
        n = len(ent["n_rows"])
        if any(len(ent[k]) != n for k in ("row_off", "pool_off",
                                          "pool_slots", "fallback")):
            return None
        # the offsets table rides JSON, not the checksummed arenas:
        # validate it against its own checksum AND bound every value
        # (negative offsets would wrap via Python indexing; oversized
        # counts would serve another entry's rows) — a torn or edited
        # manifest degrades to a rebuild, never a wrong row
        if _entries_checksum(ent, man.get("ids", [])) != \
                man.get("entries_checksum"):
            return None
        for eid in range(n):
            ro, nr = int(ent["row_off"][eid]), int(ent["n_rows"][eid])
            po, ns = int(ent["pool_off"][eid]), int(ent["pool_slots"][eid])
            if (ro < 0 or nr < 0 or po < 0 or ns < 0
                    or nr > cfg.max_rows or ns > cfg.byte_pool_slots
                    or ro + nr > rows or po + ns > slots):
                return None
        t._grow_rows(rows)
        t._grow_pool(slots)
        t.rows_used, t.pool_used = rows, slots
        t._ensure_entries(n)
        t.n_entries = n
        t.row_off[:n] = ent["row_off"]
        t.ent_rows[:n] = ent["n_rows"]
        t.pool_off[:n] = ent["pool_off"]
        t.ent_slots[:n] = ent["pool_slots"]
        t.ent_fallback[:n] = ent["fallback"]
        t.ids = OrderedDict((h, int(e)) for h, e in man["ids"])
        t.dead_rows = int(man.get("dead_rows", 0))
        t.dead_entries = int(man.get("dead_entries", 0))
        if any(e < 0 or e >= n for e in t.ids.values()):
            return None
        if t.checksum() != man.get("checksum"):
            return None
        t.rebuild_vocab()
        t.dirty = False
        return t

    # -- introspection

    def state(self) -> Dict[str, Any]:
        m = self._registry()
        with self._lock:
            tables = [{
                "encode_key": t.ekey,
                "entries": len(t.ids),
                "rows": t.rows_used,
                "dead_rows": t.dead_rows,
                "uids_tracked": len(t.uid_segs),
                "bytes": t.row_bytes(),
                "mmap": bool(t.dir) and not t.memory_only,
                "memory_only": t.memory_only,
            } for t in self._tables.values()]
        return {
            "enabled": True,
            "dir": self.dir,
            "capacity_entries": self.capacity,
            "tables": tables,
            "hits": m.columnar_store.value({"outcome": "hit"}),
            "misses": m.columnar_store.value({"outcome": "miss"}),
            "segments_encoded": m.encode_diff_segments.value(),
            "segments_reused": m.columnar_segments_reused.value(),
            "json_walks": m.encode_json_walks.value(),
            "gathered_rows": m.columnar_gather_rows.value(),
            "rebuilds": m.columnar_rebuilds.value(),
            "compactions": m.columnar_compactions.value(),
        }


# ---------------------------------------------------------------------------
# process-global store (like the caches): None until configured

_store: Optional[ColumnarStore] = None
_store_lock = threading.Lock()


def get_store() -> Optional[ColumnarStore]:
    return _store


def configure_store(directory: Optional[str] = None,
                    enabled: Optional[bool] = None,
                    capacity: Optional[int] = None) -> Optional[ColumnarStore]:
    """Install (or disable) the process-wide columnar store. Library
    default is OFF; ``serve`` enables it (in-memory) unless
    --no-columnar, and --columnar-dir/$KYVERNO_TPU_COLUMNAR_DIR back it
    onto mmap files. $KYVERNO_TPU_COLUMNAR=1 force-enables for
    non-serve entrypoints."""
    global _store
    directory = directory or os.environ.get("KYVERNO_TPU_COLUMNAR_DIR") or None
    if enabled is None:
        env = os.environ.get("KYVERNO_TPU_COLUMNAR", "").lower()
        enabled = bool(directory) or env in ("1", "true", "on", "yes")
    with _store_lock:
        if not enabled:
            _store = None
            return None
        _store = ColumnarStore(directory=directory, capacity=capacity)
        return _store


def reset_store() -> None:
    """Drop the global store (tests)."""
    global _store
    with _store_lock:
        _store = None


def store_state() -> Dict[str, Any]:
    s = get_store()
    return s.state() if s is not None else {"enabled": False}
