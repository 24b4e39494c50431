"""Hand-written CUDA kernels of the port, their loader, and their plain
PyTorch twins: K1 ``dfa_scan`` (and its non-ASCII entry), K3
``instance_count``, K4 ``verdict_counts`` (and its uint8-table entry),
K5 ``vocab_gather``, K6 ``hash_match``, K7 ``pool_rows``, K8
``first_true_take``, K9 ``glob_nfa``, K10 ``meta_any``, K11
``class_fold`` and K12 ``row_fold``.

Every kernel lives in ``csrc/<name>.cu`` behind a plain C interface.
The first launch builds all sources at once (one ``nvcc`` per source,
started together) into shared libraries under ``build/kernels/`` at
the root of the checkout, named by the content hash of their source,
and loads them with ``ctypes``. Nothing is built or imported when this
module is imported.

Each wrapper:

- takes its plain PyTorch twin for tensors on the CPU, and only there;
- on CUDA tensors launches its kernel on the current stream or raises
  (there is no fallback);
- checks dtype, shape, device and contiguity before the launch;
- raises when the C entry returns a nonzero ``cudaGetLastError()``;
- raises ``KernelError`` when a kernel fails to build, load or launch
  (and ``tpu/graphs.py`` when a program fails to be captured): the
  guarded dispatch ladder passes it to the caller instead of answering
  the batch all-HOST, so a broken kernel never hides behind the scalar
  engine;
- adds one to ``LAUNCHES[<name>]`` for each kernel launch, and nowhere
  else.

A program replayed as a CUDA graph (``tpu/graphs.py``) runs no Python:
its capture counts into a dict of the capturing thread's own
(``counting_into``), which ``GraphedProgram`` adds again at every
replay, so ``LAUNCHES`` counts what the card runs, and a capture on one
thread takes nothing from another thread's counts.

The ``*_plain`` functions repeat each kernel's arithmetic in PyTorch;
the CPU tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NUM_VERDICT_CLASSES = 7

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "build", "kernels")
SOURCES = ("dfa_scan", "instance_count", "verdict_counts", "vocab_gather",
           "hash_match", "pool_rows", "first_true_take", "glob_nfa",
           "meta_any", "class_fold", "row_fold")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counts per kernel entry (see module docstring)
LAUNCHES: Dict[str, int] = {
    "dfa_scan_fused": 0,
    "dfa_scan_stride1": 0,
    "nonascii": 0,
    "instance_count": 0,
    "instance_count2": 0,
    "verdict_counts": 0,
    "verdict_counts_u8": 0,
    "vocab_gather": 0,
    "vocab_gather_rows": 0,
    "hash_match": 0,
    "pool_rows": 0,
    "first_true_take": 0,
    "glob_nfa": 0,
    "meta_any": 0,
    "class_fold": 0,
    "row_fold": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "dfa_scan_fused": ("dfa_scan", [_P, _P, _L, _I, _I, _P, _P, _I, _I, _P,
                                    _I, _I, _P, _L, _P, _P]),
    "dfa_scan_stride1": ("dfa_scan", [_P, _P, _L, _I, _I, _P, _P, _I, _I,
                                      _I, _P, _L, _P, _P]),
    "dfa_nonascii": ("dfa_scan", [_P, _P, _L, _I, _I, _P, _P]),
    "instance_count_many": ("instance_count",
                            [_P, _I, ctypes.c_uint, _P, _L, _I, _I, _P]),
    "instance_count2": ("instance_count", [_P, _P, _P, _P, _L, _I, _I, _P, _P]),
    "verdict_counts": ("verdict_counts", [_P, _I, _L, _P, _P, _I, _I, _I,
                                          _P]),
    "vocab_gather": ("vocab_gather", [_P, _P, _P, _I, _I, _L, _L, _P, _I, _L,
                                      _L, _P]),
    "vocab_gather_rows": ("vocab_gather",
                          [_P, _P, _P, _I, _L, _L, _I, _P, _P, _P]),
    "hash_match": ("hash_match", [_P, _P, _P, _L, _P, _I, _P, _P]),
    "pool_rows": ("pool_rows", [_P, _L, _L, _I, _P, _L, _I, _I, _I, _P, _P]),
    "first_true_take": ("first_true_take", [_P, _P, _L, _I, _I, _P, _P, _P]),
    "glob_nfa_pack": ("glob_nfa",
                      [_P, _P, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P]),
    "meta_any": ("meta_any", [_P, _I, _P, _I, _P, _P, _P, _P, _P, _L, _I,
                              _P, _P, _P]),
    "class_fold": ("class_fold", [_P, _I, _I, _I, _P, _I, _L, _I, _I, _I,
                                  _I, _I, _P]),
    "row_fold": ("row_fold", [_P, _I, _I, _P, _I, _I, _L, _I, _I, _P, _P]),
    "row_fold_occupancy": ("row_fold", [_I, _L, _P, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


class KernelError(RuntimeError):
    """A kernel of the port failed to build, load or launch, or a
    program failed to be captured as a CUDA graph."""


# several threads launch (the admission flusher, the lifecycle worker);
# a thread recording a CUDA graph counts into its own dict instead
_count_lock = threading.Lock()
_capture_counts = threading.local()


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of ``name``: to the capturing thread's dict
    while it records a graph (``counting_into``), else to ``LAUNCHES``
    and to the dicts the thread tallies into (``tallying_into``)."""
    sink = getattr(_capture_counts, "counts", None)
    if sink is not None:
        sink[name] = sink.get(name, 0) + n
        return
    with _count_lock:
        LAUNCHES[name] += n
        for tally in getattr(_capture_counts, "tallies", ()):
            tally[name] = tally.get(name, 0) + n


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]):
    """This thread's launches count into ``counts`` meanwhile."""
    prev = getattr(_capture_counts, "counts", None)
    _capture_counts.counts = counts
    try:
        yield counts
    finally:
        _capture_counts.counts = prev


@contextlib.contextmanager
def tallying_into(counts: Dict[str, int]):
    """This thread's launches that run (those ``LAUNCHES`` counts) are
    also added to ``counts`` meanwhile: the sharded step's launches by
    device."""
    prev = getattr(_capture_counts, "tallies", ())
    _capture_counts.tallies = prev + (counts,)
    try:
        yield counts
    finally:
        _capture_counts.tallies = prev


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use")


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"{name}-{tag.hexdigest()[:12]}.so")


def build_all() -> Dict[str, str]:
    """Build every kernel source that has no library for its current
    content, one ``nvcc`` per source, all started together, then load
    them. Returns {source: library path}."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return {n: _libs[n]._name for n in SOURCES}
        os.makedirs(_BUILD, exist_ok=True)
        procs: List[Tuple[str, str, str, subprocess.Popen]] = []
        for name in SOURCES:
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(_CSRC, name + ".cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise KernelError("kernel build failed: " + "\n".join(failed))
        for name in SOURCES:
            try:
                _libs[name] = ctypes.CDLL(_lib_path(name))
            except OSError as e:
                raise KernelError(f"kernel library {name} failed to load: "
                                  f"{e}") from e
        for fn, (src, argtypes) in _SIGNATURES.items():
            f = getattr(_libs[src], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _fns[fn] = f
        return {n: _libs[n]._name for n in SOURCES}


def _on_current(fn: str, device) -> None:
    """A launch goes to the current device's stream, and the kernel's
    shared-memory opt-in and SM count are the current device's: its
    tensors must lie there. Raises ``KernelError`` otherwise (the
    caller enters ``torch.cuda.device(d)``; nothing switches quietly)."""
    device = torch.device(device)
    cur = torch.cuda.current_device()
    if device.type != "cuda" or device.index != cur:
        raise KernelError(f"CUDA kernel {fn}: its tensors are on {device}, "
                          f"the current device is cuda:{cur}")


def _call(fn: str, device, *args) -> None:
    """Launch ``fn`` on the current stream of ``device``, which must be
    the current device."""
    if fn not in _fns:
        build_all()
    _on_current(fn, device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fns[fn](*args, stream)
    if rc != 0:
        raise KernelError(f"CUDA kernel {fn} failed to launch: cudaError {rc}")


def _check(t: torch.Tensor, name: str, dtype, device, ndim: Optional[int] = None
           ) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.device.type == "cuda":
        _on_current(name, t.device)
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: {t.ndim} dims, want {ndim}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K1 dfa_scan (csrc/dfa_scan.cu): replaces kyverno_tpu/tpu/dfa.py
# _scan_fused, _scan_stride1 and nonascii_mask, plus bank_match's accept
# lookup and column order. Bound by the latency of one dependent table
# read a pair or byte; the kernels serve those reads from shared memory,
# from tiles of pattern-local tables that ``pack_stride1`` /
# ``pack_fused`` build (csrc/dfa_scan.cu describes the layout).

# Two stride-1 tiles share an SM's 228 KB of shared memory; a fused tile
# takes an SM with its 4 KB pair map (four tenant patterns of 20 states x
# 1,089 columns). Both stay under the 227 KB a block may use (kMaxSmem).
# Tiles of up to 112 KB and 220 KB measured slower on an H100 at the
# tenant shapes (fewer blocks; PERF.md, Findings).
STRIDE1_TILE_BYTES = 90 << 10
FUSED_TILE_BYTES = 200 << 10
DFA_MIN_CHUNK = 64       # subjects a block's tile serves at least
DFA_SM_SMEM = 233472     # shared memory of one H100 SM (228 KB)
_CM_PITCH = 260          # kCmPitch: a class map's stride in a tile
_TILE_WIDE = 1           # kWide: uint16 rows (stride 1) / int32 entries (fused)
_TILE_GLOBAL = 2         # kGlobal: read in place from global memory


class DfaTiles:
    """K1's tables for one stride group of a bank's patterns on one
    device: ``kind`` "stride1" or "fused"; the packed tiles (``blob``,
    uint8, and ``tiles``, the (T, 4) int32 directory of blob offset,
    bytes, patterns and flags); ``smem_tile``, the bytes of the largest
    tile staged in shared memory; ``cols``, each pattern's column in the
    (S, ``width``) output plane; ``pairs`` and ``pitch``, the fused
    kernel's pair map and table pitch; and ``plain_args``, a function
    that returns the plain twin's table arguments, called at the first
    plain scan (the kernels read only the tiles)."""

    def __init__(self, kind: str, width: int, cols: torch.Tensor,
                 blob: torch.Tensor, tiles: torch.Tensor, smem_tile: int,
                 plain_args: Callable[[], tuple],
                 pairs: Optional[torch.Tensor] = None, pitch: int = 0):
        if kind not in ("stride1", "fused"):
            raise ValueError(f"DfaTiles: kind {kind!r}")
        self.kind, self.width, self.cols = kind, width, cols
        self.blob, self.tiles, self.smem_tile = blob, tiles, smem_tile
        self.plain_args, self.pairs, self.pitch = plain_args, pairs, pitch
        self._plain: Optional[tuple] = None

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block: its tile, and the fused
        kernel's pair map."""
        return self.smem_tile + (4096 if self.kind == "fused" else 0)

    def plain_scan(self, bytes_: torch.Tensor, lens: torch.Tensor
                   ) -> torch.Tensor:
        """The group's (S, K) accepts through the plain twin."""
        if self._plain is None:
            self._plain = self.plain_args()
        fn = dfa_scan_stride1_plain if self.kind == "stride1" \
            else dfa_scan_fused_plain
        return fn(bytes_, lens, *self._plain)

    def chunk(self, S: int, W: int, device) -> int:
        """Subjects a block walks in a launch over S subjects of W
        bytes (``dfa_chunks``)."""
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return -(-S // dfa_chunks(self.kind, S, W, self.n_tiles,
                                  int(self.cols.numel()), self.smem_tile, sms))


@functools.lru_cache(maxsize=1024)
def dfa_chunks(kind: str, S: int, W: int, T: int, K: int, smem_tile: int,
               sms: int) -> int:
    """The chunks each of T tiles splits S subjects of W bytes into:
    the count c of at least ``DFA_MIN_CHUNK`` subjects a chunk that
    minimises waves(c) x (walk / c + copy). A block copies its tile
    (``smem_tile`` bytes) and walks its chunk's share of the tile's
    (subject, pattern) steps, counted as four tile bytes a step at W/4
    steps a subject (stride 1) or W/8 (fused); a wave is the blocks the
    SMs hold at once (two 1,024-thread blocks an SM where their shared
    memory fits). On an H100, in ``chip_smoke.py``'s chunk sweep
    (PERF.md, Findings), it picks the fastest count at the tenant fused
    shapes (one chunk at triage, where the copy of a 174 KB tile
    outweighs the walk) and one within 5 % of the fastest at the
    stride-1 shapes; a fixed rule (tiles x chunks >= 2 x SMs) read up to
    1.7x slower at the fused ones."""
    smem = smem_tile + (4096 if kind == "fused" else 0)
    slots = sms * min(2, max(1, DFA_SM_SMEM // (smem + 1024)))
    walk = 4 * S * max(1, W // (4 if kind == "stride1" else 8)) * K / T
    most = max(1, min(-(-S // DFA_MIN_CHUNK), 4 * slots))
    return min(range(1, most + 1),
               key=lambda c: -(-T * c // slots) * (walk / c + smem_tile))


def _closure(step, starts: np.ndarray, n_states: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The states reachable from each start, which own disjoint blocks
    of states: (states sorted by owner then state, their owners, the
    count a start). ``step`` maps a frontier to its (F, C) successors."""
    owner = np.full((n_states,), -1, dtype=np.int64)
    owner[starts] = np.arange(starts.shape[0])
    front = starts
    while front.size:
        nxt = step(front)
        own = np.repeat(owner[front], nxt.shape[1])
        nxt = nxt.reshape(-1)
        new = owner[nxt] < 0
        nxt, first = np.unique(nxt[new], return_index=True)
        owner[nxt] = own[new][first]
        front = nxt
    states = np.nonzero(owner >= 0)[0]
    states = states[np.argsort(owner[states], kind="stable")]
    own = owner[states]
    return states, own, np.bincount(own, minlength=starts.shape[0])


def _local(step, starts: np.ndarray, n_states: int):
    """Per start, its reachable states (global ids) and the map from
    global to pattern-local ids (their rank among them)."""
    states, own, counts = _closure(step, starts, n_states)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    g2l = np.zeros((n_states,), dtype=np.int64)
    g2l[states] = np.arange(states.shape[0]) - offs[own]
    return [states[o:o + c] for o, c in zip(offs, counts)], g2l


def _a4(n: int) -> int:
    return -(-n // 4) * 4


def _assemble(entries, budget: int, with_cm: bool):
    """Pack (wide, class map or None, table, accept bytes, field 2,
    column) entries into tiles of at most ``budget`` bytes, narrow ones
    first, each kind in order; an entry larger than a tile alone gets a
    global tile of its own. -> (blob uint8, (T, 4) int32 directory,
    bytes of the largest shared-memory tile)."""
    head = 16 + (_CM_PITCH if with_cm else 0)

    def cost(e):
        return head + _a4(e[2].nbytes) + _a4(e[3].nbytes)

    tiles: List[Tuple[List, int]] = []
    for wide in (False, True):
        cur: List = []
        size = 0
        for e in (e for e in entries if e[0] == wide):
            c = cost(e)
            if c > budget - 16:
                tiles.append(([e], _TILE_GLOBAL))
                continue
            if size + c > budget - 16:
                tiles.append((cur, 0))
                cur, size = [], 0
            cur.append(e)
            size += c
        if cur:
            tiles.append((cur, 0))
    parts, rows, off, smem = [], [], 0, 0
    for ents, flags in tiles:
        P = len(ents)
        nbytes = -(-sum(cost(e) for e in ents) // 16) * 16
        buf = np.zeros((nbytes,), dtype=np.uint8)
        fields = np.zeros((4, P), dtype=np.uint32)
        pos = head * P
        for k, (_, cm, tab, acc, f2, col) in enumerate(ents):
            if with_cm:
                buf[16 * P + _CM_PITCH * k:16 * P + _CM_PITCH * k + 256] = cm
            fields[:, k] = (pos, _a4(pos + tab.nbytes), f2, col)
            buf[pos:pos + tab.nbytes] = tab.reshape(-1).view(np.uint8)
            pos = _a4(pos + tab.nbytes)
            buf[pos:pos + acc.nbytes] = acc
            pos = _a4(pos + acc.nbytes)
        buf[:16 * P] = fields.reshape(-1).view(np.uint8)
        flags |= _TILE_WIDE if ents[0][0] else 0
        rows.append((off, nbytes, P, flags))
        if not flags & _TILE_GLOBAL:
            smem = max(smem, nbytes)
        parts.append(buf)
        off += nbytes
    blob = np.concatenate(parts) if parts else np.zeros((16,), np.uint8)
    return blob, np.asarray(rows, dtype=np.int32).reshape(-1, 4), smem


def pack_stride1(trans: np.ndarray, class_map: np.ndarray,
                 start: np.ndarray, accept: np.ndarray, ids: Sequence[int],
                 cols: Sequence[int], budget: int = STRIDE1_TILE_BYTES):
    """K1 stride-1 tiles of a bank's patterns ``ids`` (their output
    columns ``cols``), from the bank's (states, classes) ``trans``, its
    per-pattern ``class_map`` and ``start`` and its per-state
    ``accept``: each pattern's class map, its rows over its own classes
    in pattern-local ids (uint8, uint16 past 256 states), its local
    start and its accept bytes."""
    idx = np.asarray(ids, dtype=np.int64)
    upid, inv = np.unique(idx, return_inverse=True)
    trans = trans.astype(np.int64)
    states, g2l = _local(lambda f: trans[f], start[upid].astype(np.int64),
                         trans.shape[0])
    entries = []
    for j, pid in enumerate(idx):
        st = states[inv[j]]
        cm = class_map[pid]
        C = int(cm.max()) + 1
        wide = st.shape[0] > 256
        rows = g2l[trans[st, :C]].astype(np.uint16 if wide else np.uint8)
        entries.append((wide, cm, rows, accept[st].astype(np.uint8),
                        C | (int(g2l[start[pid]]) << 16), int(cols[j])))
    return _assemble(entries, budget, with_cm=True)


def pack_fused(fused_trans: np.ndarray, pitch: int, fused_start: np.ndarray,
               fused_accept: np.ndarray, ids: Sequence[int],
               cols: Sequence[int], budget: int = FUSED_TILE_BYTES):
    """K1 fused tiles of a bank's patterns ``ids``, from its fused
    premultiplied table of row ``pitch``, per-pattern ``fused_start``
    and per-state ``fused_accept``: each pattern's slice rebased to
    local premultiplied ids (uint16 while states x pitch <= 65,536, else
    int32), its local premultiplied start and its accept bytes."""
    idx = np.asarray(ids, dtype=np.int64)
    upid, inv = np.unique(idx, return_inverse=True)
    ftab = fused_trans.reshape(-1, pitch).astype(np.int64)
    states, g2l = _local(lambda f: ftab[f] // pitch,
                         fused_start[upid].astype(np.int64) // pitch,
                         ftab.shape[0])
    entries = []
    for j, pid in enumerate(idx):
        st = states[inv[j]]
        wide = st.shape[0] * pitch > 65536
        tab = (g2l[ftab[st] // pitch] * pitch).astype(
            np.int32 if wide else np.uint16)
        entries.append((wide, None, tab, fused_accept[st].astype(np.uint8),
                        int(g2l[fused_start[pid] // pitch]) * pitch,
                        int(cols[j])))
    return _assemble(entries, budget, with_cm=False)


def dfa_scan_fused_plain(bytes_: torch.Tensor, lens: torch.Tensor,
                         trans: torch.Tensor, pairs: torch.Tensor,
                         starts: torch.Tensor, accept: torch.Tensor,
                         pitch: int, chain: int) -> torch.Tensor:
    """(S, W) uint8 subjects, (S,) int32 lengths -> (S, K) bool accepts
    through the fused pad-extended table (the reference's arithmetic:
    every pair of the chain-padded window, pad flag in bit 8)."""
    S, W = bytes_.shape
    K = starts.shape[0]
    npairs = -(-W // 2)
    G = -(-npairs // chain)
    wp = G * chain * 2
    b = torch.nn.functional.pad(bytes_, (0, wp - W)).to(torch.int64)
    lens_c = torch.clamp(lens.to(torch.int64), max=W)
    pos = torch.arange(wp, device=bytes_.device)
    bx = b + (pos[None, :] >= lens_c[:, None]).to(torch.int64) * 256
    pairs64 = pairs.to(torch.int64)
    u = pairs64[bx[:, 0::2]] + pairs64[512 + bx[:, 1::2]]  # (S, wp/2)
    trans64 = trans.to(torch.int64)
    state = starts.to(torch.int64)[None, :].expand(S, K)
    for p in range(wp // 2):
        state = trans64[state + u[:, p:p + 1]]
    return accept[state // pitch].to(torch.bool)


def dfa_scan_stride1_plain(bytes_: torch.Tensor, lens: torch.Tensor,
                           trans: torch.Tensor, n_classes: int,
                           class_map: torch.Tensor, starts: torch.Tensor,
                           accept: torch.Tensor) -> torch.Tensor:
    """(S, W) uint8, (S,) int32 -> (S, K) bool: one byte per step,
    ``trans[state * C + class_map[k][byte]]`` while ``w < len``."""
    S, W = bytes_.shape
    K = starts.shape[0]
    cmap_t = class_map.to(torch.int64).t()  # (256, K)
    trans64 = trans.to(torch.int64)
    state = starts.to(torch.int64)[None, :].expand(S, K)
    b = bytes_.to(torch.int64)
    for w in range(W):
        nxt = trans64[state * n_classes + cmap_t[b[:, w]]]
        state = torch.where((w < lens)[:, None], nxt, state)
    return accept[state].to(torch.bool)


def nonascii_plain(bytes_: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(S, W) uint8, (S,) -> (S,) bool: any byte >= 0x80 within len."""
    W = bytes_.shape[-1]
    live = torch.arange(W, device=bytes_.device)[None, :] < lens[:, None]
    return ((bytes_ >= 0x80) & live).any(dim=-1)


def _dfa_args(bytes_: torch.Tensor, lens: torch.Tensor):
    dev = bytes_.device
    _check(bytes_, "bytes", torch.uint8, dev, 2)
    _check(lens, "lens", torch.int32, dev, 1)
    if lens.shape[0] != bytes_.shape[0]:
        raise ValueError(f"lens {tuple(lens.shape)} vs bytes {tuple(bytes_.shape)}")
    return dev


def _dfa_scan(kind: str, bytes_: torch.Tensor, lens: torch.Tensor,
              tiles: DfaTiles, out: torch.Tensor, want_nonascii: bool):
    if tiles.kind != kind:
        raise ValueError(f"dfa_scan_{kind}: tiles of kind {tiles.kind!r}")
    if bytes_.device.type == "cpu":
        out[:, tiles.cols] = tiles.plain_scan(bytes_, lens)
        return out, (nonascii_plain(bytes_, lens) if want_nonascii else None)
    dev = _dfa_args(bytes_, lens)
    _check(out, "out", torch.bool, dev, 2)
    _check(tiles.blob, "tile blob", torch.uint8, dev, 1)
    _check(tiles.tiles, "tile directory", torch.int32, dev, 2)
    S, W = bytes_.shape
    if tuple(out.shape) != (S, tiles.width):
        raise ValueError(f"out {tuple(out.shape)}, want ({S}, {tiles.width})")
    na = torch.empty((S,), dtype=torch.bool, device=dev) if want_nonascii \
        else None
    if S == 0:
        return out, na
    # the kernels read a subject a word at a time (the lengths are
    # clamped to W)
    bytes_ = _padded_rows(bytes_, 4)
    head = (_ptr(bytes_), _ptr(lens), S, W, bytes_.shape[1], _ptr(tiles.blob),
            _ptr(tiles.tiles), tiles.n_tiles, tiles.smem_tile)
    chunk = tiles.chunk(S, W, dev)
    if kind == "fused":
        _check(tiles.pairs, "fused_pairs", torch.int32, dev, 1)
        if tiles.pairs.shape[0] != 1024 or tiles.pitch <= 0:
            raise ValueError(f"fused_pairs of {tiles.pairs.shape[0]} entries,"
                             f" pitch {tiles.pitch}")
        _call("dfa_scan_fused", dev, *head, _ptr(tiles.pairs), tiles.pitch, chunk,
              _ptr(out), out.stride(0), _ptr(na))
    else:
        _call("dfa_scan_stride1", dev, *head, chunk, _ptr(out), out.stride(0),
              _ptr(na))
    count_launch(f"dfa_scan_{kind}")
    return out, na


def dfa_scan_fused(bytes_: torch.Tensor, lens: torch.Tensor,
                   tiles: DfaTiles, out: torch.Tensor,
                   want_nonascii: bool = False):
    """K1, fused entry: the accepts of (S, W) subjects written into the
    (S, ``tiles.width``) bool plane ``out`` at the tiles' columns ->
    (``out``, (S,) bool non-ASCII flags or None)."""
    return _dfa_scan("fused", bytes_, lens, tiles, out, want_nonascii)


def dfa_scan_stride1(bytes_: torch.Tensor, lens: torch.Tensor,
                     tiles: DfaTiles, out: torch.Tensor,
                     want_nonascii: bool = False):
    """K1, stride-1 entry: as ``dfa_scan_fused``, one byte a step."""
    return _dfa_scan("stride1", bytes_, lens, tiles, out, want_nonascii)


def nonascii(bytes_: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """B4 alone, counted as ``nonascii``: (S, W) uint8, (S,) int32 ->
    (S,) bool, for a lane family no K1 launch scans (K1 gives the flag
    of the families it scans, ``want_nonascii``). The kernel reads a row
    16 bytes a lane: rows whose pitch is no multiple of 16, or whose
    base is not 16-byte aligned, are padded first."""
    if bytes_.device.type == "cpu":
        return nonascii_plain(bytes_, lens)
    dev = _dfa_args(bytes_, lens)
    S, W = bytes_.shape
    na = torch.empty((S,), dtype=torch.bool, device=dev)
    if S:
        bytes_ = _padded_rows(bytes_, 16)
        _call("dfa_nonascii", dev, _ptr(bytes_), _ptr(lens), S, W,
              bytes_.shape[1], _ptr(na))
        count_launch("nonascii")
    return na


def _padded_rows(bytes_: torch.Tensor, m: int) -> torch.Tensor:
    """Contiguous (S, W) uint8 as a kernel that reads a row ``m`` bytes
    at a time takes it: rows of a multiple of ``m`` bytes from an
    ``m``-byte aligned base, zero-padded past W where they are not (the
    bytes past W are never live). K1 reads words (``m`` = 4), the
    standalone B4 entry 16-byte vectors."""
    S, W = bytes_.shape
    if W % m or bytes_.data_ptr() % m:
        rows = bytes_.new_zeros((S, -(-W // m) * m))
        rows[:, :W] = bytes_
        return rows
    return bytes_


# ---------------------------------------------------------------------------
# K3 instance_count (csrc/instance_count.cu): replaces
# kyverno_tpu/tpu/evaluator.py InstScope.count / Inst2Scope.count (the
# f32 one-hot einsums). One level: up to 8 predicates a launch over a
# compact uint8 scope (``scope8``), bound by their bytes and the scope's.
# Two levels: bound by the bytes of pred/valid/both scope lanes.

COUNT_MAX_PREDS = 8      # kMaxPreds in csrc/instance_count.cu
COUNT_MAX_ROWS = 32 * 255  # 8-bit per-lane count fields
SCOPE_NONE = 0xFF        # scope8 of a row that counts nowhere


def scope8(scope1: torch.Tensor, valid: torch.Tensor, n_inst: int
           ) -> torch.Tensor:
    """(N, R) uint8: ``scope1`` where the row is valid and its scope lies
    in [0, I), ``SCOPE_NONE`` elsewhere (I <= 64). Built once a batch; a
    one-level count then reads 2 bytes a row."""
    if not 0 < n_inst <= 64:
        raise ValueError(f"instance_count: I={n_inst} outside (0, 64]")
    ok = valid & (scope1 >= 0) & (scope1 < n_inst)
    return torch.where(ok, scope1, SCOPE_NONE).to(torch.uint8)


def instance_count_plain(pred: torch.Tensor, scope1: torch.Tensor,
                         valid: torch.Tensor, n_inst: int,
                         scope2: Optional[torch.Tensor] = None,
                         out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(N, R) bool rows -> (N, I) int32 (or (N, I, I) with ``scope2``)
    counts of rows that are true and valid, by scope index; rows whose
    scope lies outside [0, I) count nowhere. Written into ``out`` when
    given."""
    ar = torch.arange(n_inst, device=pred.device, dtype=scope1.dtype)
    live = pred & valid
    oh1 = scope1[:, :, None] == ar[None, None, :]
    if scope2 is None:
        got = (oh1 & live[:, :, None]).sum(dim=1, dtype=torch.int32)
    else:
        oh2 = scope2[:, :, None] == ar[None, None, :]
        both = (oh1[:, :, :, None] & oh2[:, :, None, :]) \
            & live[:, :, None, None]
        got = both.sum(dim=1, dtype=torch.int32)
    return got if out is None else out.copy_(got)


def _wants(preds: Sequence[torch.Tensor], want) -> List[str]:
    wants = [want] * len(preds) if isinstance(want, str) else list(want)
    if len(wants) != len(preds) or any(w not in ("count", "any")
                                       for w in wants):
        raise ValueError(f"want {want!r}: 'count' or 'any' per predicate")
    return wants


def instance_count_outs(N: int, n_inst: int, wants: Sequence[str],
                        device) -> List[torch.Tensor]:
    """The (N, I) outputs of one ``instance_count_many`` launch: one
    buffer per dtype (int32 counts, bool anys), a slice of it per
    predicate."""
    n_any = list(wants).count("any")
    bufs = {"count": iter(torch.empty((len(wants) - n_any, N, n_inst),
                                      dtype=torch.int32, device=device)),
            "any": iter(torch.empty((n_any, N, n_inst), dtype=torch.bool,
                                    device=device))}
    return [next(bufs[w]) for w in wants]


def _count_outs(outs: Optional[Sequence[torch.Tensor]], N: int, n_inst: int,
                wants: Sequence[str], device) -> List[torch.Tensor]:
    if outs is None:
        return instance_count_outs(N, n_inst, wants, device)
    if len(outs) != len(wants):
        raise ValueError(f"instance_count: {len(outs)} outputs for "
                         f"{len(wants)} predicates")
    for o, w in zip(outs, wants):
        dt = torch.bool if w == "any" else torch.int32
        if o.dtype != dt or tuple(o.shape) != (N, n_inst) \
                or not o.is_contiguous() or o.device != device:
            raise ValueError(f"instance_count: an output {tuple(o.shape)} "
                             f"{o.dtype} on {o.device}; want a contiguous "
                             f"({N}, {n_inst}) {dt} on {device}")
    return list(outs)


def instance_count_many_plain(preds: Sequence[torch.Tensor],
                              scope: torch.Tensor, n_inst: int,
                              want="count",
                              out: Optional[Sequence[torch.Tensor]] = None
                              ) -> List[torch.Tensor]:
    """Each (N, R) (or broadcastable) bool predicate over the (N, R)
    uint8 ``scope8`` -> (N, I) int32 counts, or (N, I) bool "count > 0"
    where ``want`` (one word, or one per predicate) is "any"; written
    into ``out`` (one tensor a predicate) when given."""
    ar = torch.arange(n_inst, device=scope.device, dtype=torch.uint8)
    oh = scope[:, :, None] == ar[None, None, :]
    wants = _wants(preds, want)
    got = []
    for p, w in zip(preds, wants):
        hit = oh & p.expand(scope.shape)[:, :, None]
        got.append(hit.any(dim=1) if w == "any"
                   else hit.sum(dim=1, dtype=torch.int32))
    if out is None:
        return got
    outs = _count_outs(out, scope.shape[0], n_inst, wants, scope.device)
    return [o.copy_(g) for o, g in zip(outs, got)]


def instance_count_many(preds: Sequence[torch.Tensor], scope: torch.Tensor,
                        n_inst: int, want="count",
                        out: Optional[Sequence[torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """K3, one level: up to 8 (N, R) bool predicates on one ``scope8``
    in one launch -> one (N, I) int32 (or bool for "any") per predicate,
    written into ``out`` when given (``instance_count_outs``). A
    predicate's rows must be contiguous; its row stride may be 0 (a
    (1, R) predicate expanded over the batch, read without a copy)."""
    if scope.device.type == "cpu":
        return instance_count_many_plain(preds, scope, n_inst, want, out)
    dev = scope.device
    wants = _wants(preds, want)
    _check(scope, "scope8", torch.uint8, dev, 2)
    N, R = scope.shape
    if not 0 < len(preds) <= COUNT_MAX_PREDS:
        raise ValueError(f"instance_count_many: {len(preds)} predicates "
                         f"(1..{COUNT_MAX_PREDS})")
    if not 0 < n_inst <= 64:
        raise ValueError(f"instance_count: I={n_inst} outside (0, 64]")
    if not 0 < R <= COUNT_MAX_ROWS:
        raise ValueError(f"instance_count: R={R} outside (0, {COUNT_MAX_ROWS}]")
    for p in preds:
        if p.dtype != torch.bool or p.device != dev or tuple(p.shape) != (N, R):
            raise ValueError(f"predicate {tuple(p.shape)} {p.dtype} on "
                             f"{p.device}: want ({N}, {R}) bool on {dev}")
        if R > 1 and p.stride(1) != 1:
            raise ValueError(f"predicate strides {p.stride()}: rows must be "
                             f"contiguous")
    k = len(preds)
    outs = _count_outs(out, N, n_inst, wants, dev)
    if N:
        args = (ctypes.c_longlong * (3 * k))(
            *[p.data_ptr() for p in preds], *[p.stride(0) for p in preds],
            *[o.data_ptr() for o in outs])
        any_mask = sum(1 << q for q, w in enumerate(wants) if w == "any")
        _call("instance_count_many", dev, ctypes.cast(args, _P), k, any_mask,
              _ptr(scope), N, R, n_inst)
        count_launch("instance_count")
    return outs


def instance_count(pred: torch.Tensor, scope1: torch.Tensor,
                   valid: torch.Tensor, n_inst: int) -> torch.Tensor:
    """K3, one level, one predicate: (N, R) -> (N, I) int32 (``scope8``
    built here; the evaluator builds it once a batch)."""
    if pred.device.type == "cpu":
        return instance_count_plain(pred, scope1, valid, n_inst)
    return instance_count_many([pred], scope8(scope1, valid, n_inst),
                               n_inst)[0]


def instance_count2(pred: torch.Tensor, scope1: torch.Tensor,
                    scope2: torch.Tensor, valid: torch.Tensor,
                    n_inst: int, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """K3, two levels: (N, R) -> (N, I, I) int32 (into ``out`` when
    given)."""
    if pred.device.type == "cpu":
        return instance_count_plain(pred, scope1, valid, n_inst, scope2,
                                    out)
    dev = pred.device
    _check(pred, "pred", torch.bool, dev, 2)
    _check(valid, "valid", torch.bool, dev, 2)
    _check(scope1, "scope1", torch.int32, dev, 2)
    _check(scope2, "scope2", torch.int32, dev, 2)
    shapes = {tuple(t.shape) for t in (pred, valid, scope1, scope2)}
    if len(shapes) != 1:
        raise ValueError(f"instance_count2: mismatched shapes {shapes}")
    if not 0 < n_inst <= 64:
        raise ValueError(f"instance_count: I={n_inst} outside (0, 64]")
    N, R = pred.shape
    if out is None:
        out = torch.empty((N, n_inst, n_inst), dtype=torch.int32, device=dev)
    _check(out, "out", torch.int32, dev, 3)
    if tuple(out.shape) != (N, n_inst, n_inst):
        raise ValueError(f"instance_count2: out {tuple(out.shape)}, want "
                         f"({N}, {n_inst}, {n_inst})")
    if N:
        _call("instance_count2", dev, _ptr(pred), _ptr(scope1), _ptr(scope2),
              _ptr(valid), N, R, n_inst, _ptr(out))
        count_launch("instance_count2")
    return out


# ---------------------------------------------------------------------------
# K4 verdict_counts (csrc/verdict_counts.cu): replaces the counts of
# kyverno_tpu/tpu/evaluator.py build_program.run. Bound by reading the
# table once.

VERDICT_COUNTS_THREADS = 512   # a block of one rule, at most
VERDICT_COUNTS_CLUSTER_THREADS = 128  # a block of a cluster, at least
VERDICT_COUNTS_MAX_CLUSTER = 8  # the portable cluster size
VERDICT_COUNTS_LOADS = 4        # kLoads: 16-byte loads in flight a thread


def verdict_counts_plan(N: int, aligned: bool = True
                        ) -> Tuple[int, int, bool]:
    """How K4 runs on a (rules, N) table: (C, threads, vector). Each
    thread takes ``VERDICT_COUNTS_LOADS`` vectors of 4 cells (one round
    of loads in flight). A row that a block of at most 512 threads
    covers so (N <= 8,192) is one block's; a longer row goes to a
    cluster of C blocks (a power of two, at most 8) of 128 threads or
    more: C = 8 at N = 16,384. At N = 8,192 one block of 512 threads a
    rule beats every cluster of the same threads on an H100 (the
    cluster's barrier costs more than the SMs it adds; ``profile_ab.py``
    sweeps the plans). ``vector`` is the 16-byte form, taken when
    N % 4 == 0 and the tensors are ``aligned`` (the table 16-byte, the
    uint8 output 4-byte), else a cell a thread a step."""
    if N < 1:
        raise ValueError(f"verdict_counts_plan: N={N}")
    per_thread = 4 * VERDICT_COUNTS_LOADS
    vector = bool(aligned and N % 4 == 0)
    if N <= VERDICT_COUNTS_THREADS * per_thread:
        return 1, 32 * -(-N // (32 * per_thread)), vector
    C = 1
    while C < VERDICT_COUNTS_MAX_CLUSTER and \
            C * VERDICT_COUNTS_CLUSTER_THREADS * per_thread < N:
        C *= 2
    threads = 32 * -(-N // (32 * per_thread * C))
    return C, min(VERDICT_COUNTS_THREADS, threads), vector


def verdict_counts_plain(table: torch.Tensor) -> torch.Tensor:
    """(rules, N) int32 -> (rules, 7) int32 class histogram."""
    ar = torch.arange(NUM_VERDICT_CLASSES, device=table.device,
                      dtype=table.dtype)
    return (table[:, :, None] == ar).sum(dim=1, dtype=torch.int32)


def _verdict_counts(table: torch.Tensor, out8: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """Launch K4 (a cluster of blocks a rule) into new counts."""
    rules, N = table.shape
    out = torch.empty((rules, NUM_VERDICT_CLASSES), dtype=torch.int32,
                      device=table.device)
    if rules and N:
        aligned = table.data_ptr() % 16 == 0 and (
            out8 is None or out8.data_ptr() % 4 == 0)
        C, threads, vector = verdict_counts_plan(N, aligned)
        _call("verdict_counts", table.device, _ptr(table), rules, N, _ptr(out), _ptr(out8),
              C, threads, int(vector))
    elif rules:
        out.zero_()
    return out


def verdict_counts(table: torch.Tensor) -> torch.Tensor:
    """K4: (rules, N) int32 -> (rules, 7) int32."""
    if table.device.type == "cpu":
        return verdict_counts_plain(table)
    _check(table, "table", torch.int32, table.device, 2)
    out = _verdict_counts(table, None)
    if table.numel():
        count_launch("verdict_counts")
    return out


def verdict_counts_u8_plain(table: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rules, N) int32 -> ((rules, N) uint8 table, (rules, 7) int32
    counts taken on the int32 table)."""
    return table.to(torch.uint8), verdict_counts_plain(table)


def verdict_counts_u8(table: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 with its uint8 output: the background scan's step writes the
    uint8 verdict table in the same pass as the counts."""
    if table.device.type == "cpu":
        return verdict_counts_u8_plain(table)
    _check(table, "table", torch.int32, table.device, 2)
    out8 = torch.empty(tuple(table.shape), dtype=torch.uint8,
                       device=table.device)
    out = _verdict_counts(table, out8)
    if table.numel():
        count_launch("verdict_counts_u8")
    return out8, out


# ---------------------------------------------------------------------------
# K5 vocab_gather (csrc/vocab_gather.cu): replaces
# kyverno_tpu/tpu/evaluator.py LaneView.__getitem__, the vocabulary
# gathers (jnp.take). Bound by the bytes of the index table and the
# dense cells written; the vocabularies stay in L2.

VOCAB_GATHER_MAX_LANES = 40  # kMaxLanes in csrc/vocab_gather.cu

# jnp.take's fill for an index outside [-V, V), by the lane's dtype in
# the encoded batch (a bit pattern of the element's size)
TAKE_FILL = {np.dtype(np.uint8): 0xFF, np.dtype(np.uint32): 0xFFFFFFFF,
             np.dtype(np.int32): 0x80000000,
             np.dtype(np.float32): 0x7FC00000}


def _index_plain(idx: torch.Tensor) -> torch.Tensor:
    """A uint8 / uint16 / int32 index table as int64 values; uint16 is
    widened through its int16 bits (no ordering op on uint16)."""
    if idx.dtype == torch.uint16:
        return idx.view(torch.int16).to(torch.int64) & 0xFFFF
    return idx.to(torch.int64)


def _take_index(idx: torch.Tensor, V: int):
    """jnp.take's index rule: [-V, 0) wraps, outside [-V, V) fills.
    -> (safe int64 index, in-range mask)."""
    j = _index_plain(idx)
    j = torch.where(j < 0, j + V, j)
    ok = (j >= 0) & (j < V)
    return torch.where(ok, j, torch.zeros_like(j)), ok


def _fill_value(dtype: torch.dtype, bits: int, device) -> torch.Tensor:
    """A 0-dim tensor of ``dtype`` holding the bit pattern ``bits``."""
    if dtype.itemsize == 1:
        return torch.full((), bits & 0xFF, dtype=torch.uint8,
                          device=device).view(dtype)
    v = int(bits) & 0xFFFFFFFF
    v = v - (1 << 32) if v >= (1 << 31) else v
    return torch.full((), v, dtype=torch.int32, device=device).view(dtype)


def vocab_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                       fill: int) -> torch.Tensor:
    """(V,) lane by (n, Rb) index -> (n, Rb): ``jnp.take(src, idx)``."""
    V = src.shape[0]
    safe, ok = _take_index(idx, V)
    got = src[safe] if V else torch.zeros(idx.shape, dtype=src.dtype,
                                          device=src.device)
    return torch.where(ok, got, _fill_value(src.dtype, fill, src.device))


def vocab_gather_rows_plain(svocab: Optional[torch.Tensor],
                            slen: Optional[torch.Tensor],
                            idx: torch.Tensor):
    """(Sv, W) uint8 rows and (Sv,) int32 lengths by (n, K) index ->
    ((n, K, W) uint8 or None, (n, K) int32 or None)."""
    V = (svocab if svocab is not None else slen).shape[0]
    safe, ok = _take_index(idx, V)
    rows = lens = None
    if svocab is not None:
        rows = torch.where(ok[..., None], svocab[safe],
                           _fill_value(torch.uint8, 0xFF, svocab.device))
    if slen is not None:
        lens = torch.where(ok, slen[safe],
                           _fill_value(torch.int32, 0x80000000, slen.device))
    return rows, lens


def _index_width(idx: torch.Tensor) -> int:
    widths = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
    if idx.dtype not in widths:
        raise TypeError(f"index dtype {idx.dtype}, want uint8, uint16 "
                        f"or int32")
    return widths[idx.dtype]


VOCAB_GATHER_THREADS = 256  # kThreads: vectors a chunk (a block's step)
# cells a thread owns a lane, by element size: one 16-byte store
VOCAB_GATHER_VEC = {1: 16, 4: 4}


class VocabPlan:
    """K5's launch plan over a tile's lanes (csrc/vocab_gather.cu).

    ``order``: the lanes in launch order, the ``n1`` 1-byte lanes first,
    then the 4-byte lanes, each group in its given order. ``chunks1`` /
    ``chunks4``: the chunks of ``VOCAB_GATHER_THREADS`` vectors of
    ``VOCAB_GATHER_VEC[elem]`` cells that cover a lane of each group (0
    for an empty group). A lane's last vector, when the cell count is no
    multiple of the vector, is loaded and stored a cell at a time."""

    def __init__(self, elems: Sequence[int], cells: int):
        n = len(elems)
        if not 0 < n <= VOCAB_GATHER_MAX_LANES:
            raise ValueError(f"vocab_gather: {n} lanes "
                             f"(1..{VOCAB_GATHER_MAX_LANES})")
        if any(e not in VOCAB_GATHER_VEC for e in elems):
            raise ValueError(f"vocab_gather: element sizes {sorted(set(elems))}"
                             f", want 1 or 4")
        self.order = [i for e in VOCAB_GATHER_VEC
                      for i, x in enumerate(elems) if x == e]
        self.n1 = list(elems).count(1)

        def chunks(e, lanes):
            vecs = -(-cells // VOCAB_GATHER_VEC[e])
            return max(1, -(-vecs // VOCAB_GATHER_THREADS)) if lanes else 0

        self.chunks1 = chunks(1, self.n1)
        self.chunks4 = chunks(4, n - self.n1)


def vocab_gather(srcs: List[torch.Tensor], idx: torch.Tensor,
                 fills: List[int]) -> List[torch.Tensor]:
    """K5, many lanes in one launch: each (V,) lane (1- or 4-byte
    elements) gathered by the (n, Rb) index table -> (n, Rb) each."""
    if idx.device.type == "cpu":
        return [vocab_gather_plain(s, idx, f) for s, f in zip(srcs, fills)]
    dev = idx.device
    if len(srcs) != len(fills):
        raise ValueError(f"vocab_gather: {len(srcs)} lanes, {len(fills)} "
                         f"fills")
    width = _index_width(idx)
    _check(idx, "row_idx", idx.dtype, dev)
    V = srcs[0].shape[0] if srcs else 0
    outs = []
    for s in srcs:
        _check(s, "vocab lane", s.dtype, dev, 1)
        if s.shape[0] != V or s.element_size() not in VOCAB_GATHER_VEC:
            raise ValueError(f"vocab lane {tuple(s.shape)} {s.dtype}: want "
                             f"({V},) with 1- or 4-byte elements")
        outs.append(torch.empty(tuple(idx.shape), dtype=s.dtype, device=dev))
    cells = idx.numel()
    plan = VocabPlan([s.element_size() for s in srcs], cells)
    if cells:
        n, o = len(srcs), plan.order
        src_a = (ctypes.c_void_p * n)(*[srcs[i].data_ptr() for i in o])
        dst_a = (ctypes.c_void_p * n)(*[outs[i].data_ptr() for i in o])
        fill_a = (ctypes.c_uint32 * n)(*[int(fills[i]) & 0xFFFFFFFF
                                         for i in o])
        _call("vocab_gather", dev, ctypes.cast(src_a, _P), ctypes.cast(dst_a, _P),
              ctypes.cast(fill_a, _P), n, plan.n1, plan.chunks1, plan.chunks4,
              _ptr(idx), width, cells, V)
        count_launch("vocab_gather")
    return outs


def vocab_gather_rows(svocab: Optional[torch.Tensor],
                      slen: Optional[torch.Tensor], idx: torch.Tensor):
    """K5, pool rows: ``pool_svocab[pool_sidx]`` (n, K, W) uint8 and
    ``pool_slen[pool_sidx]`` (n, K) int32 in one launch (either source
    may be None, and its output is then None)."""
    if idx.device.type == "cpu":
        return vocab_gather_rows_plain(svocab, slen, idx)
    dev = idx.device
    if svocab is None and slen is None:
        raise ValueError("vocab_gather_rows: no source")
    width = _index_width(idx)
    _check(idx, "pool_sidx", idx.dtype, dev)
    rows = lens = None
    V, W = -1, 0
    if svocab is not None:
        _check(svocab, "pool_svocab", torch.uint8, dev, 2)
        V, W = svocab.shape
        rows = torch.empty(tuple(idx.shape) + (W,), dtype=torch.uint8,
                           device=dev)
    if slen is not None:
        _check(slen, "pool_slen", torch.int32, dev, 1)
        if V >= 0 and slen.shape[0] != V:
            raise ValueError(f"pool_slen {tuple(slen.shape)} vs pool_svocab "
                             f"{tuple(svocab.shape)}")
        V = slen.shape[0]
        lens = torch.empty(tuple(idx.shape), dtype=torch.int32, device=dev)
    cells = idx.numel()
    if cells and (rows is None or W):
        _call("vocab_gather_rows", dev, _ptr(svocab), _ptr(slen), _ptr(idx), width,
              cells, V, W, _ptr(rows), _ptr(lens))
        count_launch("vocab_gather_rows")
    return rows, lens


# ---------------------------------------------------------------------------
# K6 hash_match (csrc/hash_match.cu): replaces
# kyverno_tpu/tpu/evaluator.py Ctx._mask / heq / hset. Bound by the
# bytes of the two hash lanes (and valid) read and the mask written.


def hash_consts(pairs: Sequence[Tuple[int, int]],
                device: torch.device) -> torch.Tensor:
    """The (k, 2) int32 constant table of K6 and its twin, on
    ``device``. A CUDA table is copied from pinned memory without
    waiting, so a caller that keeps it (the evaluator keeps one per
    compiled program and constant set) makes a step that never syncs."""
    t = torch.tensor([[int(h), int(l)] for h, l in pairs],
                     dtype=torch.int32).reshape(-1, 2)
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def hash_match_plain(hi: torch.Tensor, lo: torch.Tensor,
                     consts: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, R) int32 hash lanes, (k, 2) int32 (hi, lo) constants on the
    same device -> (n, R) bool: OR over the constants of the pair's
    equality, AND ``valid``."""
    out = torch.zeros(tuple(hi.shape), dtype=torch.bool, device=hi.device)
    for q in range(consts.shape[0]):
        out |= (hi == consts[q, 0]) & (lo == consts[q, 1])
    if valid is not None:
        out = out & valid
    return out


def hash_match(hi: torch.Tensor, lo: torch.Tensor, consts: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: one launch for heq (one pair), hset (any number of pairs;
    none gives all false) and _mask (one pair AND valid)."""
    if hi.device.type == "cpu":
        return hash_match_plain(hi, lo, consts, valid)
    dev = hi.device
    _check(hi, "hi", torch.int32, dev)
    _check(lo, "lo", torch.int32, dev)
    _check(consts, "consts", torch.int32, dev, 2)
    if hi.shape != lo.shape:
        raise ValueError(f"hi {tuple(hi.shape)} vs lo {tuple(lo.shape)}")
    if consts.shape[1] != 2:
        raise ValueError(f"consts {tuple(consts.shape)}: want (k, 2)")
    if valid is not None:
        _check(valid, "valid", torch.bool, dev)
        if valid.shape != hi.shape:
            raise ValueError(f"valid {tuple(valid.shape)} vs {tuple(hi.shape)}")
    out = torch.empty(tuple(hi.shape), dtype=torch.bool, device=dev)
    cells = hi.numel()
    if cells:
        _call("hash_match", dev, _ptr(hi), _ptr(lo), _ptr(valid), cells,
              _ptr(consts), consts.shape[0], _ptr(out))
        count_launch("hash_match")
    return out


# ---------------------------------------------------------------------------
# K7 pool_rows (csrc/pool_rows.cu): replaces
# kyverno_tpu/tpu/evaluator.py Ctx._rows_from_pool. Bound by the bytes
# of the slot lane read and the row mask written.


def pool_rows_plain(plane: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(n, K) bool plane, (n, R) int32 slot -> (n, R) bool:
    ``plane[n, clip(slot, 0, K - 1)] & (slot >= 0)``."""
    N = slot.shape[0]
    safe = torch.clamp(slot, 0, plane.shape[1] - 1).to(torch.int64)
    got = torch.gather(plane, 1, safe.reshape(N, -1)).reshape(slot.shape)
    return got & (slot >= 0)


POOL_ROWS_MAX_WORDS = 8  # kMaxWords in csrc/pool_rows.cu: K <= 256


def pool_rows_words(K: int) -> int:
    """The 32-bit masks of a plane row K7 holds in registers (1, 2, 4 or
    8, the fewest that cover K), or 0 when K is too wide and the kernel
    reads the plane in global memory."""
    if K > 32 * POOL_ROWS_MAX_WORDS:
        return 0
    w = 1
    while 32 * w < K:
        w *= 2
    return w


def _pool_rows_vec(slot: torch.Tensor) -> bool:
    """16-byte slot loads (4 rows a lane) and 4-byte stores: R a
    multiple of 4 and the slot lane 16-byte aligned."""
    return slot.shape[1] % 4 == 0 and slot.data_ptr() % 16 == 0


def pool_rows_form(plane: torch.Tensor, slot: torch.Tensor) -> str:
    """How K7 runs on these inputs: where the plane row lives, and how
    the slots are read."""
    w = pool_rows_words(plane.shape[1])
    where = f"{w} mask words in registers" if w else "plane read in global"
    loads = "4 slots a load" if _pool_rows_vec(slot) else "1 slot a load"
    return f"{where}, {loads}"


def pool_rows(plane: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """K7: the plane may have any strides (a column of the bank's
    accepts); the slot lane is contiguous."""
    if plane.device.type == "cpu":
        return pool_rows_plain(plane, slot)
    dev = plane.device
    if plane.dtype != torch.bool or plane.ndim != 2 or plane.device != dev:
        raise TypeError(f"plane {tuple(plane.shape)} {plane.dtype}: want "
                        f"(n, K) bool")
    _check(slot, "slot", torch.int32, dev, 2)
    N, R = slot.shape
    K = plane.shape[1]
    if plane.shape[0] != N or K < 1:
        raise ValueError(f"plane {tuple(plane.shape)} vs slot {tuple(slot.shape)}")
    out = torch.empty((N, R), dtype=torch.bool, device=dev)
    if N * R:
        _call("pool_rows", dev, _ptr(plane), plane.stride(0), plane.stride(1), K,
              _ptr(slot), N, R, pool_rows_words(K), int(_pool_rows_vec(slot)),
              _ptr(out))
        count_launch("pool_rows")
    return out


# ---------------------------------------------------------------------------
# K8 first_true_take (csrc/first_true_take.cu): replaces the argmax /
# take_along_axis pair of kyverno_tpu/tpu/evaluator.py
# _eval_wildcard_anchor. Bound by the bytes of the two masks.

FIRST_TRUE_TAKE_MAX_R = 512  # 32 lanes of 16 rows: a warp a resource


def first_true_take_form(R: int, aligned: bool = True) -> int:
    """How K8 reads an (N, R) accept mask: the lanes that own a
    resource in the segment form (a 16-byte load a lane; R / 16 rounded
    up to a power of two), taken when R % 16 == 0, R <= 512 and the
    mask is 16-byte ``aligned``; else 0, the warp walk (a warp a
    resource, 32 rows a step)."""
    if R < 1:
        raise ValueError(f"first_true_take_form: R={R}")
    if not aligned or R % 16 or R > FIRST_TRUE_TAKE_MAX_R:
        return 0
    lanes = 1
    while 16 * lanes < R:
        lanes *= 2
    return lanes


def first_true_take_plain(accept: torch.Tensor, pred: torch.Tensor,
                          out: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
    """(n, R) bool, (n, R) bool -> (has (n,), val_ok (n,)): any true
    row, and ``pred`` at the first true row (row 0 when none); written
    into ``out`` when given."""
    has = accept.any(dim=-1)
    # argmax returns the first maximum (bool cast to uint8)
    idx = accept.to(torch.uint8).argmax(dim=-1)
    val_ok = torch.gather(pred, -1, idx[:, None])[:, 0]
    if out is None:
        return has, val_ok
    return out[0].copy_(has), out[1].copy_(val_ok)


def first_true_take(accept: torch.Tensor, pred: torch.Tensor,
                    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """K8 (into ``out``, two (n,) bool tensors, when given), in the form
    ``first_true_take_form`` picks."""
    if accept.device.type == "cpu":
        return first_true_take_plain(accept, pred, out)
    dev = accept.device
    _check(accept, "accept", torch.bool, dev, 2)
    _check(pred, "pred", torch.bool, dev, 2)
    if accept.shape != pred.shape or accept.shape[1] < 1:
        raise ValueError(f"accept {tuple(accept.shape)} vs pred "
                         f"{tuple(pred.shape)}")
    N, R = accept.shape
    has, val_ok = out if out is not None else (
        torch.empty((N,), dtype=torch.bool, device=dev),
        torch.empty((N,), dtype=torch.bool, device=dev))
    for t in (has, val_ok):
        _check(t, "out", torch.bool, dev, 1)
        if t.shape[0] != N:
            raise ValueError(f"first_true_take: out {tuple(t.shape)}, want "
                             f"({N},)")
    if N:
        lanes = first_true_take_form(R, accept.data_ptr() % 16 == 0)
        _call("first_true_take", dev, _ptr(accept), _ptr(pred), N, R, lanes,
              _ptr(has), _ptr(val_ok))
        count_launch("first_true_take")
    return has, val_ok


# ---------------------------------------------------------------------------
# K9 glob_nfa (csrc/glob_nfa.cu): replaces kyverno_tpu/tpu/evaluator.py
# glob_match, the per-pattern glob NFA of the globs outside the DFA bank,
# for a whole pack of patterns in one launch. Bound by the bytes each
# (subject, pattern) pair reads (up to its length, or until no state is
# left), the lengths, the subjects, the packed tables and the output.

GLOB_TABLE_ROWS = 257  # a row of positions per byte value, then the '*' row
GLOB_MAX_WORDS = 32


def glob_chars(pattern: str) -> List[str]:
    """The pattern's characters with runs of '*' collapsed (the
    reference's first step). Characters are taken one by one, as the
    reference does: a literal matches the byte ``ord(char) & 0xFF``."""
    chars: List[str] = []
    for c in pattern:
        if c == "*" and chars and chars[-1] == "*":
            continue
        chars.append(c)
    return chars


def glob_words(pattern: str) -> int:
    """64-bit words of K9's state for ``pattern``: m + 1 bits, rounded
    up to a power of two."""
    need = (len(glob_chars(pattern)) + 64) // 64
    nw = 1
    while nw < need:
        nw *= 2
    return nw


def _glob_rows(pattern: str, nw: int) -> np.ndarray:
    """(257, nw) uint64: bit j of row c (c < 256) is set when position j
    (1..m) consumes byte c (a literal equal to c, or '?' when c != 0);
    row 256 holds the '*' positions."""
    tab = np.zeros((GLOB_TABLE_ROWS, nw), dtype=np.uint64)
    for j, pc in enumerate(glob_chars(pattern), start=1):
        word, bit = divmod(j, 64)
        b = np.uint64(1) << np.uint64(bit)
        if pc == "*":
            tab[256, word] |= b
        elif pc == "?":
            tab[1:256, word] |= b
        else:
            tab[ord(pc) & 0xFF, word] |= b
    return tab


def glob_table(pattern: str, device) -> torch.Tensor:
    """One pattern's full (257, NW) table (``_glob_rows`` as int64) on
    ``device``: what a pack's class rows are gathered from."""
    t = torch.from_numpy(_glob_rows(pattern, glob_words(pattern)).view(np.int64))
    return t if torch.device(device).type == "cpu" else t.to(device)


class GlobPack:
    """K9's packed tables for globs of one state-word count.

    The byte-class map sends each byte to a class: one per literal byte
    the pack's patterns use (``ord(c) & 0xFF``, NUL included), NUL when
    no literal is NUL, and one "no literal" class for the other bytes
    (left out when there are none). Each pattern's table is then its
    257-row table gathered at one byte of each class, then the '*' row:
    (P, C + 1, NW) uint64 words. Device copies are kept per device."""

    def __init__(self, patterns: Sequence[str], nw: Optional[int] = None):
        if not patterns:
            raise ValueError("GlobPack: no pattern")
        self.patterns = list(patterns)
        self.nw = nw or max(glob_words(p) for p in self.patterns)
        if any(glob_words(p) > self.nw for p in self.patterns):
            raise ValueError(f"GlobPack: a pattern needs more than "
                             f"{self.nw} state words")
        lits = {ord(c) & 0xFF for p in self.patterns for c in glob_chars(p)
                if c not in "*?"}
        other = [b for b in range(1, 256) if b not in lits]
        reps = other[:1] + [0] + sorted(lits - {0})
        self.cmap = np.zeros(256, dtype=np.uint8)
        for k, b in enumerate(reps):
            self.cmap[b] = k
        rows = np.array(reps + [256])
        self.tables = np.stack([_glob_rows(p, self.nw)[rows]
                                for p in self.patterns])
        self.ms = np.array([len(glob_chars(p)) for p in self.patterns],
                           dtype=np.int32)
        self._on: Dict[str, Tuple[torch.Tensor, ...]] = {}

    @property
    def classes(self) -> int:
        """Table rows a pattern has: its byte classes and the '*' row."""
        return self.tables.shape[1]

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(cmap uint8, tables int64, ms int32) on ``device``; a CUDA
        copy is made once, from pinned memory without waiting."""
        key = str(device)
        if key not in self._on:
            host = (torch.from_numpy(self.cmap),
                    torch.from_numpy(self.tables.view(np.int64)),
                    torch.from_numpy(self.ms))
            if torch.device(device).type != "cpu":
                host = tuple(t.pin_memory().to(device, non_blocking=True)
                             for t in host)
            self._on[key] = host
        return self._on[key]


def glob_packs(patterns: Sequence[str]) -> List[GlobPack]:
    """One pack per state-word count, patterns in their order."""
    groups: Dict[int, List[str]] = {}
    for p in patterns:
        groups.setdefault(glob_words(p), []).append(p)
    return [GlobPack(ps, nw) for nw, ps in sorted(groups.items())]


def _glob_closure(dp: torch.Tensor, star: torch.Tensor) -> torch.Tensor:
    """Epsilon moves over '*' on (..., m + 1) bool state columns: a '*'
    at position j lets dp[j - 1] flow into dp[j]. One pass equals the
    reference's column-by-column loop because runs of '*' are collapsed
    (no two '*' positions are adjacent)."""
    out = dp.clone()
    out[..., 1:] |= dp[..., :-1] & star
    return out


def glob_nfa_plain(pattern: str, bytes_: torch.Tensor, lens: torch.Tensor,
                   with_steps: bool = False):
    """(..., B) uint8 subjects, (...) int32 lengths -> (...) bool: the
    reference's DP step by step, one byte per step over m + 1 state
    columns, the answer read where the step equals ``lens`` (so a length
    outside [0, B] gives False). With ``with_steps`` also the (...)
    int32 count of bytes the kernel reads for each subject (up to its
    length while any state is left; none when the length is outside
    [0, B])."""
    chars = glob_chars(pattern)
    m = len(chars)
    dev = bytes_.device
    lead = tuple(bytes_.shape[:-1])
    B = bytes_.shape[-1]
    # the per-position columns (a literal's byte, '?', '*'), made on
    # the host and copied from pinned memory (a CUDA graph can hold it)
    cols = torch.tensor([[(ord(c) & 0xFF) if c not in "*?" else -1,
                          c == "?", c == "*"] for c in chars],
                        dtype=torch.int16).reshape(-1, 3)
    if dev.type != "cpu":
        cols = cols.pin_memory().to(dev, non_blocking=True)
    lit, isq, star = cols[:, 0], cols[:, 1] != 0, cols[:, 2] != 0
    lens = lens.to(torch.int32)
    dp = torch.zeros(lead + (m + 1,), dtype=torch.bool, device=dev)
    dp[..., 0] = True
    dp = _glob_closure(dp, star)
    acc = dp[..., m] & (lens == 0)
    steps = torch.zeros(lead, dtype=torch.int32, device=dev)
    in_range = (lens >= 0) & (lens <= B)
    for w in range(B):
        c = bytes_[..., w].to(torch.int16)
        steps += (in_range & (w < lens) & dp.any(dim=-1)).to(torch.int32)
        hit = (c[..., None] == lit) | (isq & (c != 0)[..., None])
        new = torch.zeros_like(dp)
        new[..., 1:] = torch.where(star, dp[..., 1:], dp[..., :-1] & hit)
        dp = _glob_closure(new, star)
        acc |= dp[..., m] & (lens == w + 1)
    return (acc, steps) if with_steps else acc


def glob_nfa_pack_plain(pack: GlobPack, bytes_: torch.Tensor,
                        lens: torch.Tensor) -> torch.Tensor:
    """(P, ...) bool: ``glob_nfa_plain`` of each of the pack's patterns."""
    return torch.stack([glob_nfa_plain(p, bytes_, lens)
                        for p in pack.patterns])


def glob_nfa_pack(pack: GlobPack, bytes_: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """K9, one launch for a pack: (..., B) uint8 subjects (contiguous),
    (...) int32 lengths -> (P, ...) bool, row p the answers of pattern
    p. Raises for a pack of more than ``GLOB_MAX_WORDS`` state words or
    one whose tables do not fit the kernel's shared memory."""
    if bytes_.device.type == "cpu":
        return glob_nfa_pack_plain(pack, bytes_, lens)
    dev = bytes_.device
    _check(bytes_, "bytes", torch.uint8, dev)
    _check(lens, "lens", torch.int32, dev)
    lead = tuple(bytes_.shape[:-1])
    if bytes_.ndim < 1 or tuple(lens.shape) != lead:
        raise ValueError(f"lens {tuple(lens.shape)} vs bytes "
                         f"{tuple(bytes_.shape)}")
    if pack.nw > GLOB_MAX_WORDS:
        raise ValueError(f"glob pack of {pack.nw} state words: K9 holds at "
                         f"most {64 * GLOB_MAX_WORDS - 1} positions")
    cmap, tables, ms = pack.on(dev)
    P = len(pack.patterns)
    out = torch.empty((P,) + lead, dtype=torch.bool, device=dev)
    S = lens.numel()
    if S:
        _call("glob_nfa_pack", dev, _ptr(bytes_), _ptr(lens), S, bytes_.shape[-1],
              _ptr(cmap), _ptr(tables), _ptr(ms), P, pack.classes, pack.nw,
              _ptr(out))
        count_launch("glob_nfa")
    return out


def glob_nfa(pattern: str, bytes_: torch.Tensor,
             lens: torch.Tensor) -> torch.Tensor:
    """K9 for one pattern (a pack of one): (..., B) uint8 subjects,
    (...) int32 lengths -> (...) bool. A pattern with more non-'*'
    characters than B bytes cannot accept any length in [0, B]: it gives
    all False without a launch."""
    if bytes_.device.type == "cpu":
        return glob_nfa_plain(pattern, bytes_, lens)
    if sum(1 for c in glob_chars(pattern) if c != "*") > bytes_.shape[-1]:
        return torch.zeros(tuple(bytes_.shape[:-1]), dtype=torch.bool,
                           device=bytes_.device)
    if glob_words(pattern) > GLOB_MAX_WORDS:
        raise ValueError(f"glob of {len(glob_chars(pattern))} positions over "
                         f"{bytes_.shape[-1]}-byte subjects: K9 holds at "
                         f"most {64 * GLOB_MAX_WORDS - 1}")
    return glob_nfa_pack(_single_pack(pattern), bytes_, lens)[0]


@functools.lru_cache(maxsize=4096)
def _single_pack(pattern: str) -> GlobPack:
    """A pattern's pack of one, made once: its device tables are copied
    once, so a CUDA graph can replay a program that runs it."""
    return GlobPack([pattern])


# ---------------------------------------------------------------------------
# K10 meta_any (csrc/meta_any.cu): replaces the names / namespaces loops
# of kyverno_tpu/tpu/evaluator.py _eval_condition_block (1618-1631), the
# OR over a filter's entries of a glob accept or a hash equality. Bound
# by the bytes of the plane cells it reads.

META_ANY_MAX_PLANES = 72  # kMaxPlanes in csrc/meta_any.cu
# resources a block may serve (a power of two up to one of its 256
# threads each, kThreads in csrc/meta_any.cu)
META_ANY_TILES = (8, 16, 32, 64, 128, 256)
# blocks a launch should have at least: two for each of the H100's 132 SMs
META_ANY_MIN_BLOCKS = 264
_MA_HEAD = 8  # words of the derived table's header


class MetaAnyTable:
    """K10's entries for one filter list, built once per compiled
    program: ``families`` ("name",) for ``names``, ("name", "ns") for
    ``namespaces``; ``slots``, the planes the entries read, each a key
    the evaluator resolves a batch ("bank", family), ("nfa", family,
    pack) or ("unpacked", family), with ``entry_major`` True where a
    plane's rows are entries ((P, N)) and False where they are resources
    ((N, K)); ``ent``, the (E, 4) int32 table {slot or -1, column/row or
    hash hi, hash lo, self} of every (entry, family), the name family's
    ``ent[:off[0]]`` then the namespace family's ``ent[off[0]:off[1]]``,
    each sorted by (slot, column); ``na``, per family, whether its
    non-ASCII mask joins the confirm; ``unpacked``, per family, the
    globs outside its K9 packs (their stacked accepts are that slot's
    rows). ``confirms`` is False when no entry can need a confirm.

    ``tab`` is the kernel's form of the same entries (``_derive``), an
    int32 array made once per program: a header {bank runs, pack runs,
    runs offset, rows offset, then each family's hash offset and count};
    one run a resource-major (bank) slot {slot, family | has-self << 8,
    columns, byte offset of the accept mask's column 0}, whose accept
    and self column masks (bytes of 0xff or 0; each 16 zero bytes, the
    columns padded to 16, 32 zero bytes) replace its entries; one run an
    entry-major slot {slot, family, first, count} over ``rows`` (row |
    self << 31); and each family's literals as (hi, lo, self, 0) sorted
    by (hi, lo), for a binary search. ``need[s]``: the columns (bank) or
    rows a plane of slot s must have."""

    def __init__(self, families: Tuple[str, ...], slots: List[Tuple],
                 entry_major: List[bool], ent: np.ndarray,
                 off: Tuple[int, int], na: Tuple[bool, ...],
                 unpacked: Dict[str, List[str]]):
        if len(slots) > META_ANY_MAX_PLANES:
            raise ValueError(f"meta_any: {len(slots)} planes, at most "
                             f"{META_ANY_MAX_PLANES}")
        self.families, self.slots, self.entry_major = families, slots, \
            entry_major
        self.ent = np.ascontiguousarray(ent, dtype=np.int32).reshape(-1, 4)
        self.off, self.na, self.unpacked = off, na, unpacked
        self.confirms = bool(any(na) or (self.ent[:, 3] != 0).any())
        self.tab, self.need = self._derive()
        self._on: Dict[str, torch.Tensor] = {}
        self._plain: Dict[str, list] = {}

    def _derive(self) -> Tuple[np.ndarray, Dict[int, int]]:
        bounds = (0,) + tuple(self.off)
        bank, packs, rows, hashes = [], [], [], []
        masks: List[np.ndarray] = []
        need: Dict[int, int] = {}
        mask_bytes = 0
        for f in range(len(self.families)):
            fr = self.ent[bounds[f]:bounds[f + 1]]
            for sl in sorted(set(fr[:, 0].tolist()) - {-1}):
                sel = fr[fr[:, 0] == sl]
                idx, own = sel[:, 1].astype(np.int64), sel[:, 3] != 0
                need[sl] = max(need.get(sl, 0), int(idx.max()) + 1)
                if self.entry_major[sl]:
                    packs.append((sl, f, len(rows), len(sel)))
                    rows.extend((idx | (own.astype(np.int64) << 31))
                                .tolist())
                    continue
                ncols = int(idx.max()) + 1
                pad = -(-ncols // 16) * 16
                m = np.zeros((2 if own.any() else 1, 16 + pad + 32),
                             np.uint8)
                m[0, 16 + idx] = 0xFF
                if own.any():
                    m[1, 16 + idx[own]] = 0xFF
                bank.append([sl, f | (int(own.any()) << 8), ncols,
                             mask_bytes + 16])
                masks.append(m.reshape(-1))
                mask_bytes += m.size
            lits: Dict[Tuple[int, int], int] = {}
            for _, hi, lo, own in fr[fr[:, 0] == -1].tolist():
                lits[(hi, lo)] = lits.get((hi, lo), 0) | int(own != 0)
            hashes.append([(hi, lo, own, 0) for (hi, lo), own in
                           sorted(lits.items())])

        def pad4(n):
            return -(-n // 4) * 4

        runs = _MA_HEAD
        rows_at = runs + 4 * (len(bank) + len(packs))
        at = pad4(rows_at + len(rows))
        head = [len(bank), len(packs), runs, rows_at, 0, 0, 0, 0]
        for f, h in enumerate(hashes):
            head[4 + 2 * f], head[5 + 2 * f] = at, len(h)
            at += 4 * len(h)
        for b in bank:
            b[3] += 4 * at
        words = np.zeros(at + mask_bytes // 4, dtype=np.int64)
        words[:_MA_HEAD] = head
        flat = [v for r in bank + packs for v in r]
        words[runs:runs + len(flat)] = flat
        words[rows_at:rows_at + len(rows)] = rows
        for f, h in enumerate(hashes):
            if h:
                words[head[4 + 2 * f]:head[4 + 2 * f] + 4 * len(h)] = \
                    np.asarray(h, np.int64).reshape(-1)
        tab = (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        if masks:
            tab[at:] = np.concatenate(masks).view(np.int32)
        return tab, need

    def on(self, device) -> torch.Tensor:
        """The kernel's table (``tab``) on ``device``; a CUDA copy is
        made once, from pinned memory without waiting."""
        key = str(device)
        if key not in self._on:
            t = torch.from_numpy(self.tab)
            if torch.device(device).type != "cpu":
                t = t.pin_memory().to(device, non_blocking=True)
            self._on[key] = t
        return self._on[key]

    def plain_index(self, device) -> list:
        """Per family: [(slot, columns, self)] and the hash entries'
        (hi, lo, self), as index tensors on ``device`` (the twin's)."""
        key = str(device)
        if key not in self._plain:
            out = []
            bounds = (0,) + tuple(self.off)
            for f in range(len(self.families)):
                rows = self.ent[bounds[f]:bounds[f + 1]]

                def t(a, dtype):
                    return torch.as_tensor(np.ascontiguousarray(a),
                                           dtype=dtype, device=device)

                by_slot = [(s, t(rows[rows[:, 0] == s, 1], torch.int64),
                            t(rows[rows[:, 0] == s, 3] != 0, torch.bool))
                           for s in sorted(set(rows[:, 0].tolist()) - {-1})]
                h = rows[rows[:, 0] == -1]
                out.append((by_slot, (t(h[:, 1], torch.int32),
                                      t(h[:, 2], torch.int32),
                                      t(h[:, 3] != 0, torch.bool))))
            self._plain[key] = out
        return self._plain[key]


def _meta_any_args(table: MetaAnyTable, planes: Sequence[torch.Tensor],
                   hashes: Sequence[torch.Tensor]):
    F = len(table.families)
    if len(planes) != len(table.slots):
        raise ValueError(f"meta_any: {len(planes)} planes for "
                         f"{len(table.slots)} slots")
    if len(hashes) != F:
        raise ValueError(f"meta_any: {len(hashes)} hash lanes for {F} "
                         f"families")
    N = hashes[0].shape[0]
    for p, em in zip(planes, table.entry_major):
        if p.dtype != torch.bool or p.ndim != 2 \
                or p.shape[1 if em else 0] != N:
            raise ValueError(f"meta_any: plane {tuple(p.shape)} {p.dtype} "
                             f"for {N} resources")
    return N


def meta_any_plain(table: MetaAnyTable, planes: Sequence[torch.Tensor],
                   hashes: Sequence[torch.Tensor],
                   is_ns: Optional[torch.Tensor] = None,
                   na: Sequence[Optional[torch.Tensor]] = ()
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) bool hit and confirm of a filter list: each family's entries
    gathered from their planes and hash lanes into one (N, E_f) matrix,
    and ``any`` over it. ``hashes`` holds each family's (N, 2) int32
    hash lane, ``is_ns`` the (N,) bool Namespace-kind mask (namespaces),
    ``na`` each family's (N,) bool non-ASCII mask or None."""
    N = _meta_any_args(table, planes, hashes)
    dev = hashes[0].device
    hits, conf = [], torch.zeros((N,), dtype=torch.bool, device=dev)
    for f, (by_slot, (hi, lo, hself)) in enumerate(table.plain_index(dev)):
        h = hashes[f]
        accs = [(h[:, :1] == hi) & (h[:, 1:] == lo)]
        selfs = [hself]
        for s, cols, sself in by_slot:
            p = planes[s]
            accs.append(p[cols].T if table.entry_major[s] else p[:, cols])
            selfs.append(sself)
        acc = torch.cat(accs, dim=1)
        hits.append(acc.any(dim=1))
        conf = conf | (acc & torch.cat(selfs)).any(dim=1)
        if f < len(na) and na[f] is not None:
            conf = conf | na[f]
    hit = hits[0] if is_ns is None else torch.where(is_ns, hits[0], hits[1])
    return hit, conf


def meta_any_tile(N: int) -> int:
    """Resources a K10 block serves over N: the most (the fewer times
    the table is staged) that still give ``META_ANY_MIN_BLOCKS``
    blocks, else the fewest."""
    for R in reversed(META_ANY_TILES):
        if -(-N // R) >= META_ANY_MIN_BLOCKS:
            return R
    return META_ANY_TILES[0]


def meta_any(table: MetaAnyTable, planes: Sequence[torch.Tensor],
             hashes: Sequence[torch.Tensor],
             is_ns: Optional[torch.Tensor] = None,
             na: Sequence[Optional[torch.Tensor]] = (),
             tile: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: one launch for a filter list -> (N,) bool (hit, confirm), as
    ``meta_any_plain``. Planes may have any strides. A block serves
    ``meta_any_tile(N)`` resources unless ``tile`` names one of
    ``META_ANY_TILES``. On the CPU the plain twin runs; on a CUDA
    tensor the kernel launches or this raises."""
    if hashes[0].device.type == "cpu":
        return meta_any_plain(table, planes, hashes, is_ns, na)
    N = _meta_any_args(table, planes, hashes)
    R = meta_any_tile(N) if tile is None else tile
    if R not in META_ANY_TILES:
        raise ValueError(f"meta_any: tile {R}, want one of {META_ANY_TILES}")
    for sl, n_need in table.need.items():
        em = table.entry_major[sl]
        if planes[sl].shape[0 if em else 1] < n_need:
            raise ValueError(f"meta_any: plane {sl} {tuple(planes[sl].shape)}"
                             f" has fewer than {n_need} "
                             f"{'rows' if em else 'columns'}")
    dev = hashes[0].device
    for f, h in enumerate(hashes):
        _check(h, f"hash lane {f}", torch.int32, dev, 2)
        if tuple(h.shape) != (N, 2):
            raise ValueError(f"hash lane {tuple(h.shape)}, want ({N}, 2)")
    for p in planes:
        if p.device != dev:
            raise ValueError(f"plane on {p.device}, want {dev}")
    F = len(table.families)
    if (is_ns is None) != (F == 1):
        raise ValueError("meta_any: is_ns goes with the two families of "
                         "namespaces, and only with them")
    if is_ns is not None:
        _check(is_ns, "is_ns", torch.bool, dev, 1)
    nas = [na[f] if f < len(na) else None for f in range(2)]
    for m in nas:
        if m is not None:
            _check(m, "nonascii", torch.bool, dev, 1)
            if m.shape[0] != N:
                raise ValueError(f"nonascii {tuple(m.shape)} for {N}")
    tab = table.on(dev)
    hit = torch.empty((N,), dtype=torch.bool, device=dev)
    conf = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        k = len(planes)
        args = (ctypes.c_longlong * max(4 * k, 1))(
            *[p.data_ptr() for p in planes],
            *[p.stride(1 if em else 0)
              for p, em in zip(planes, table.entry_major)],
            *[p.stride(0 if em else 1)
              for p, em in zip(planes, table.entry_major)],
            *[int(not em and p.stride(1) == 1)
              for p, em in zip(planes, table.entry_major)])
        _call("meta_any", dev, _ptr(tab), int(tab.numel()), ctypes.cast(args, _P),
              k, _ptr(hashes[0]), _ptr(hashes[1]) if F > 1 else None,
              _ptr(is_ns), _ptr(nas[0]), _ptr(nas[1]), N, R, _ptr(hit),
              _ptr(conf))
        count_launch("meta_any")
    return hit, conf


# ---------------------------------------------------------------------------
# K11 class_fold (csrc/class_fold.cu): a rule's class logic, recorded on
# a tape by the evaluator (tpu/fold.py) and run as one launch a rule —
# the where chains, class compares, ANDs/ORs of reductions, first-non-
# pass folds and any-over-instance reductions that kyverno_tpu/tpu/
# evaluator.py's eval_rule (1886) and the node folds it calls unroll at
# trace time and XLA fuses. Bound: bytes (each input read once, the
# outputs written once).

CLASS_FOLD_MAX_IO = 128      # kMaxIO in csrc/class_fold.cu
CLASS_FOLD_MAX_SMEM = 232448  # kMaxSmem: 227 KB of shared memory a block
CLASS_FOLD_MAX_WARPS = 4      # kMaxWarps: warps a block
# lanes a resource (G) the kernel takes; each lane holds ``fold_ipl``
# instances of an (N, I) value
CLASS_FOLD_LANES = (1, 2, 4, 8, 16, 32)
# the card the lane choice fills: the H100's SMs, and the resident warps
# an SM should hold for the interpreter's shared-memory and global-load
# latencies to overlap (chip_smoke.py sweeps G to check the choice)
CLASS_FOLD_SMS = 132
CLASS_FOLD_WARPS_PER_SM = 8
# warps an SM holds by registers (csrc/class_fold.cu: up to 128 a thread)
CLASS_FOLD_REG_WARPS = 16
# opcodes (tpu/fold.py) the plain twin reads
(_F_LOAD, _F_CONST, _F_NOT, _F_AND, _F_OR, _F_EQC, _F_NEC, _F_EQ, _F_WHERE,
 _F_FNP, _F_ANY, _F_ALL, _F_EXPAND, _F_SCAN, _F_SCANX, _F_STORE,
 _F_LOADJ) = range(17)


class FoldCode:
    """One compiled K11 segment (``tpu/fold.py:compile_tape``): ``rows``,
    the (n, 4) int32 instructions {op | kind << 8 | dst << 16, a, b, c}
    (csrc/class_fold.cu lists them; a load group's header is followed by
    one row per value it loads, {kind, slot, descriptor, element
    bytes}; LOADJ and STORE carry their element bytes too);
    ``n_uniform`` the words of a resource's N values and ``n_lane`` the
    lane units of its NI / NIJ values (an NI value one, an NIJ value J;
    shared memory a warp keeps, ``fold_smem``); ``n_ext`` the
    descriptors it reads and ``n_out`` the ones it writes (after them);
    ``widths``, the element bytes the rows give each descriptor;
    ``nested``, whether it holds NIJ values. Built once per program and
    tape."""

    def __init__(self, rows: np.ndarray, n_uniform: int, n_lane: int,
                 n_ext: int, n_out: int):
        self.rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1, 4)
        self.n_uniform, self.n_lane = n_uniform, n_lane
        self.n_ext, self.n_out = n_ext, n_out
        self.instrs = [tuple(r) for r in self.rows.tolist()]
        self.widths: Dict[int, int] = {}
        self.nested = False
        pc = 0
        while pc < len(self.instrs):
            x, a, b, c = self.instrs[pc]
            op, f = x & 0xFF, x >> 16
            self.nested |= (x >> 8) & 0xFF == 2
            pc += 1
            if op == _F_LOAD:
                for _, _, d, w in self.instrs[pc:pc + f]:
                    self.widths[d] = w
                pc += f
            elif op == _F_LOADJ:
                self.widths[a] = b
            elif op == _F_STORE:
                self.widths[b] = c
        self._on: Dict[str, torch.Tensor] = {}
        self._pinned: List[torch.Tensor] = []

    def on(self, device) -> torch.Tensor:
        """The rows on ``device``: a CUDA copy is made once, from pinned
        memory kept with the code, without waiting."""
        key = str(device)
        if key not in self._on:
            t = torch.from_numpy(self.rows)
            if torch.device(device).type != "cpu":
                pinned = t.pin_memory()
                self._pinned.append(pinned)
                t = pinned.to(device, non_blocking=True)
            self._on[key] = t
        return self._on[key]


def fold_ipl(I: int, G: int) -> int:
    """Instances a lane holds with G lanes a resource: ceil(I / G)
    rounded up to a power of two (the kernel's template argument);
    lane g holds instances g * ipl .. g * ipl + ipl - 1, those >= I
    being padding."""
    return 1 << (max(1, -(-I // G)) - 1).bit_length()


def fold_smem(code: FoldCode, G: int, I: int) -> int:
    """Shared memory a warp keeps at G lanes a resource: a word a lane
    for each N value (each lane its copy), and ipl words a lane for each
    lane unit."""
    return 4 * 32 * (code.n_uniform + fold_ipl(I, G) * code.n_lane)


def fold_legal(code: FoldCode, I: int) -> List[int]:
    """The lane counts K11 can run ``code`` with at I instances: G no
    wider than I rounded up to a power of two, and a warp's values
    within a block's shared memory."""
    top = 1 << (I - 1).bit_length()
    return [G for G in CLASS_FOLD_LANES
            if G <= top and fold_smem(code, G, I) <= CLASS_FOLD_MAX_SMEM]


def fold_lanes(code: FoldCode, N: int, I: int) -> int:
    """The lanes a resource (G) K11 runs ``code`` with over N resources
    of I instances: a pure function of the code's value kinds and
    shared memory, N and I (a CUDA-graph capture and its replays
    agree). A tape of N values alone runs a resource a lane; a tape with
    NIJ values an instance a lane (the widest legal G: its J words a
    lane per value fill shared memory, so fewer instances a lane keep
    more warps resident; measured fastest on an H100, PERF.md);
    otherwise the fewest lanes (the most instances a lane, so the fewest
    decodes an element) that keep ``CLASS_FOLD_WARPS_PER_SM`` warps
    resident on every SM (as registers and shared memory allow), else
    the most resident warps."""
    legal = fold_legal(code, I)
    if not legal:
        raise ValueError(f"class_fold: {fold_smem(code, 32, I)} bytes of "
                         "values a warp at best, more shared memory than a "
                         "block has")
    if code.n_lane == 0:
        return legal[0]
    if code.nested:
        return legal[-1]
    want = CLASS_FOLD_SMS * CLASS_FOLD_WARPS_PER_SM
    best = None
    for G in legal:
        warps = -(-N * G // 32)
        per_sm = min(CLASS_FOLD_REG_WARPS,
                     CLASS_FOLD_MAX_SMEM // fold_smem(code, G, I))
        resident = min(warps, CLASS_FOLD_SMS * max(1, per_sm))
        if resident >= want:
            return G
        if best is None or resident > best[0]:
            best = (resident, G)
    return best[1]


def fold_block(code: FoldCode, N: int, I: int, G: int) -> int:
    """Warps a block: up to ``CLASS_FOLD_MAX_WARPS`` while the block's
    shared memory fits and the grid still has a block for every SM."""
    warps = -(-N * G // 32)
    smem = fold_smem(code, G, I)
    for w in (CLASS_FOLD_MAX_WARPS, 2, 1):
        if w * smem <= CLASS_FOLD_MAX_SMEM and -(-warps // w) >= \
                CLASS_FOLD_SMS:
            return w
    return 1


def _fold_vec(t: torch.Tensor, ipl: int) -> bool:
    """Whether a lane may read its ipl instances of ``t`` as vectors:
    instances adjacent and every lane's run aligned to the vector."""
    w = t.element_size()
    vb = (16 if ipl >= 4 else 8 if ipl == 2 else 0) if w == 4 else \
        (16 if ipl >= 16 else 4 if ipl >= 4 else 0)
    if t.ndim != 2 or vb == 0 or t.stride(1) != 1:
        return False
    return t.data_ptr() % vb == 0 and (t.stride(0) * w) % vb == 0


def _fold_ios(code: FoldCode, ios: Sequence[torch.Tensor], N: int, I: int,
              J: int) -> None:
    if len(ios) != code.n_ext + code.n_out:
        raise ValueError(f"class_fold: {len(ios)} tensors for "
                         f"{code.n_ext} + {code.n_out} descriptors")
    shapes = ((N,), (N, I), (N, I, J))
    for d, t in enumerate(ios):
        if t.dtype not in (torch.bool, torch.uint8, torch.int32):
            raise TypeError(f"class_fold: dtype {t.dtype}")
        if t.ndim not in (1, 2, 3) or tuple(t.shape) != shapes[t.ndim - 1]:
            raise ValueError(f"class_fold: shape {tuple(t.shape)} is no "
                             f"class shape of ({N}, {I}, {J})")
        if code.widths.get(d, t.element_size()) != t.element_size():
            raise TypeError(f"class_fold: descriptor {d} is {t.dtype}; the "
                            f"code reads {code.widths[d]}-byte elements")
    for t in ios[code.n_ext:]:
        if t.dtype == torch.uint8:
            raise TypeError("class_fold: outputs are bool or int32")


def class_fold_plain(code: FoldCode, ios: Sequence[torch.Tensor], N: int,
                     I: int, J: int) -> None:
    """K11's plain twin: the segment's instructions, one torch operation
    each, over int32 values of shape (N,), (N, I) or (N, I, J); writes
    the output descriptors in place."""
    _fold_ios(code, ios, N, I, J)
    shapes = ((N,), (N, I), (N, I, J))
    # a value by (N slot or lane slot, word): N slots and lane slots are
    # two spaces, as in the kernel's shared memory
    env: Dict[Tuple[bool, int], torch.Tensor] = {}
    dev = ios[code.n_ext].device if code.n_out else ios[0].device
    i32 = torch.int32

    def nz(x):
        return x != 0

    rows, pc = code.instrs, 0
    while pc < len(rows):
        x, a, b, c = rows[pc]
        pc += 1
        op, kind, f = x & 0xFF, (x >> 8) & 0xFF, x >> 16
        src = kind + 1 if op in (_F_ANY, _F_ALL) else \
            (0 if op == _F_EXPAND else kind)

        def get(u):
            return env[(src == 0, u)]

        def put(v):
            env[(kind == 0, f)] = v

        if op == _F_LOAD:
            for k2, slot, d, _ in rows[pc:pc + f]:
                env[(k2 == 0, slot)] = ios[d].to(i32)
            pc += f
        elif op == _F_LOADJ:
            put(ios[a].to(i32))
        elif op == _F_CONST:
            put(torch.full(shapes[kind], a, dtype=i32, device=dev))
        elif op == _F_NOT:
            put((get(a) == 0).to(i32))
        elif op == _F_AND:
            put((nz(get(a)) & nz(get(b))).to(i32))
        elif op == _F_OR:
            put((nz(get(a)) | nz(get(b))).to(i32))
        elif op == _F_EQC:
            put((get(a) == b).to(i32))
        elif op == _F_NEC:
            put((get(a) != b).to(i32))
        elif op == _F_EQ:
            put((get(a) == get(b)).to(i32))
        elif op == _F_WHERE:
            put(torch.where(nz(get(a)), get(b), get(c)))
        elif op == _F_FNP:
            put(torch.where(nz(get(a)), get(a), get(b)))
        elif op == _F_ANY:
            put(nz(get(a)).any(dim=-1).to(i32))
        elif op == _F_ALL:
            put(nz(get(a)).all(dim=-1).to(i32))
        elif op == _F_EXPAND:
            put(get(a)[:, None].expand(N, I))
        elif op in (_F_SCAN, _F_SCANX):
            v = nz(get(a)).to(i32)
            s = torch.cumsum(v, dim=-1, dtype=i32)
            put(((s - v if op == _F_SCANX else s) > 0).to(i32))
        elif op == _F_STORE:
            out, v = ios[b], get(a)
            out.copy_(nz(v) if out.dtype == torch.bool else v)
        else:
            raise ValueError(f"class_fold: opcode {op}")


def class_fold(code: FoldCode, ios: Sequence[torch.Tensor], N: int, I: int,
               J: int, lanes: Optional[int] = None) -> None:
    """K11: one launch runs a compiled segment over all N resources (G
    lanes a resource, ``fold_ipl(I, G)`` instances a lane, J in the
    thread), reading its input descriptors by pointer and strides and
    writing its outputs in place, as ``class_fold_plain``. I <= 32. G
    is ``fold_lanes``'s choice unless ``lanes`` names one of
    ``fold_legal``'s. On the CPU the plain twin runs; on a CUDA tensor
    the kernel launches or this raises."""
    dev = ios[code.n_ext].device if code.n_out else ios[0].device
    if dev.type == "cpu":
        return class_fold_plain(code, ios, N, I, J)
    _fold_ios(code, ios, N, I, J)
    for t in ios:
        if t.device != dev:
            raise ValueError(f"class_fold: a tensor on {t.device}, want {dev}")
    if not 1 <= I <= 32:
        raise ValueError(f"class_fold: I = {I}; a warp holds at most 32 "
                         "instances")
    if len(ios) > CLASS_FOLD_MAX_IO:
        raise ValueError(f"class_fold: {len(ios)} descriptors, at most "
                         f"{CLASS_FOLD_MAX_IO}")
    G = fold_lanes(code, N, I) if lanes is None else lanes
    if G not in fold_legal(code, I):
        raise ValueError(f"class_fold: {G} lanes a resource; legal at I = "
                         f"{I}: {fold_legal(code, I)}")
    if N == 0 or not len(code.rows):
        return
    # 32-bit strides and in-row offsets; the resource's offset is one
    # 32 x 32 -> 64-bit product in the kernel
    strides = [list(t.stride()) + [0] * (3 - t.ndim) for t in ios]
    lim = 1 << 31
    if N >= lim or any(abs(s[0]) >= lim or I * abs(s[1]) + J * abs(s[2])
                       >= lim for s in strides):
        raise ValueError("class_fold: a stride or in-row offset past 32 bits")
    ipl = fold_ipl(I, G)
    k = len(ios)
    io = (ctypes.c_longlong * (5 * k))(
        *[t.data_ptr() for t in ios], *[s[0] for s in strides],
        *[s[1] for s in strides], *[s[2] for s in strides],
        *[int(_fold_vec(t, ipl)) for t in ios])
    _call("class_fold", dev, _ptr(code.on(dev)), len(code.rows), code.n_uniform,
          code.n_lane, ctypes.cast(io, _P), k, N, I, J,
          G.bit_length() - 1, ipl.bit_length() - 1,
          fold_block(code, N, I, G))
    count_launch("class_fold")


# ---------------------------------------------------------------------------
# K12 row_fold (csrc/row_fold.cu): a rule's row-plane logic, recorded on a
# tape by the evaluator (tpu/rowfold.py) and run as one launch a flush —
# the lane compares, 64-bit hash equalities (B6's heq / hset), typed
# masks, the ANDs/ORs/wheres of the leaf and condition predicates and
# the reductions over rows that kyverno_tpu/tpu/evaluator.py (222-246,
# 437-443, 480-612, 1142-1226) traces and XLA fuses. Bound: bytes (each
# lane read once, each output written once).

ROW_FOLD_MAX_IO = 128         # kMaxIO in csrc/row_fold.cu
ROW_FOLD_MAX_SMEM = 232448    # kMaxSmem: 227 KB of shared memory a block
ROW_FOLD_MAX_WARPS = 8        # kMaxWarps: warps a block
ROW_FOLD_BATCH = 4            # kBatch: uint8 lanes a batch reads together
ROW_FOLD_STAGES = 2           # kStages: stages of a block's ring
# how an input's slab is staged (csrc/row_fold.cu, Kind): one bulk copy
# of a tile's adjacent rows, cp.async of each resource's rows (any other
# resource stride), one bulk copy of a broadcast row a block
RF_SLAB, RF_ROWS, RF_BCAST = range(3)
# instructions (csrc/row_fold.cu lists them): a lane group, a hash
# group, the logic and the outputs, and a batch of uint8 lane groups
(RF_LANE, RF_HASH, RF_CONST, RF_NOT, RF_AND, RF_OR, RF_WHERE, RF_ANY,
 RF_COUNT, RF_STORE, RF_BATCH) = range(11)
# a lane group's compares
RF_NZ, RF_EQ, RF_NE, RF_GT, RF_LT = range(5)
# element types of an input lane: uint8 (and bool), int32, float32
RF_U8, RF_I32, RF_F32 = range(3)
_RF_DTYPES = {RF_U8: (torch.uint8, torch.bool), RF_I32: (torch.int32,),
              RF_F32: (torch.float32,)}


class RowCode:
    """One compiled K12 launch (``tpu/rowfold.py:compile_rows``):
    ``rows``, the (n, 4) int32 instructions {op | f << 8, a, b, c}
    (csrc/row_fold.cu lists them); ``n_slots`` the value slots a
    resource keeps (a word a lane each, W words for R > 1,024);
    ``in_types`` the element type of each input descriptor (RF_U8,
    RF_I32, RF_F32) and ``out_ops`` the output each later descriptor
    receives (RF_ANY: bool (N,), RF_COUNT: int32 (N,), RF_STORE: bool
    (N, R)); ``units``, the fill units of its load instructions (K12
    stages a tile's lanes one unit at a time: a BATCH's lanes, a LANE's,
    each lane of a HASH), each the instruction's position ORed with the
    HASH lane's part (1 hi, 2 lo) shifted by 24, and ``unit_lanes``, the
    descriptors each stages in the order their slabs lie in a stage.
    Built once per program and flush."""

    def __init__(self, rows: np.ndarray, n_slots: int,
                 in_types: Sequence[int], out_ops: Sequence[int]):
        self.rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1, 4)
        self.n_slots = n_slots
        self.in_types = tuple(in_types)
        self.out_ops = tuple(out_ops)
        self.n_in, self.n_out = len(self.in_types), len(self.out_ops)
        self.instrs = [tuple(r) for r in self.rows.tolist()]
        self._on: Dict[str, torch.Tensor] = {}
        self._pinned: List[torch.Tensor] = []
        self._check_lanes()

    def _check_lanes(self) -> None:
        """A LANE group reads a 4-byte lane (int32 or float32) and a BATCH
        reads uint8 lanes: the kernel has no other lane path. Lists the
        fill units (``units``, ``unit_lanes``)."""
        pc, rows = 0, self.instrs
        self.units: List[int] = []
        self.unit_lanes: List[Tuple[int, ...]] = []
        while pc < len(rows):
            x, a, b, c = rows[pc]
            op = x & 0xFF
            at = pc
            pc += 1
            if op == RF_LANE:
                if b not in (RF_I32, RF_F32) or self.in_types[a] != b:
                    raise ValueError(f"row_fold: a LANE group of type {b} "
                                     f"over input {a}; LANE reads int32 or "
                                     "float32 lanes, BATCH uint8 ones")
                self.units.append(at)
                self.unit_lanes.append((a,))
                pc += c
            elif op == RF_HASH:
                self.units += [at | 1 << 24, at | 2 << 24]
                self.unit_lanes += [(a,), (b,)]
                pc += c
            elif op == RF_BATCH:
                step = tuple(d for d, _, _, _ in rows[pc:pc + (x >> 8)])
                for d in step:
                    if self.in_types[d] != RF_U8:
                        raise ValueError(f"row_fold: a BATCH reads input {d}"
                                         " of a 4-byte type")
                self.units.append(at)
                self.unit_lanes.append(step)
                pc += (x >> 8) + a

    def on(self, device) -> torch.Tensor:
        """The rows, then the load table (``units``, four an int4 row),
        on ``device`` (a CUDA copy made once, from pinned memory kept
        with the code, without waiting)."""
        key = str(device)
        if key not in self._on:
            units = np.zeros((-(-len(self.units) // 4), 4), np.int32)
            units.reshape(-1)[:len(self.units)] = self.units
            t = torch.from_numpy(np.concatenate([self.rows, units]))
            if torch.device(device).type != "cpu":
                pinned = t.pin_memory()
                self._pinned.append(pinned)
                t = pinned.to(device, non_blocking=True)
            self._on[key] = t
        return self._on[key]


def row_lanes(R: int) -> int:
    """Lanes a resource (G): ceil(R / 32) rounded up to a power of two,
    at most 32; a lane holds 32 adjacent rows in each value word, so a
    warp serves 32 / G resources (R > 1,024 takes several words)."""
    return min(32, 1 << (max(1, -(-R // 32)) - 1).bit_length())


def row_words(R: int) -> int:
    """Words a value takes a lane."""
    return max(1, -(-R // (32 * row_lanes(R))))


def _row_ios(code: RowCode, ios: Sequence[torch.Tensor], N: int,
             R: int) -> None:
    if len(ios) != code.n_in + code.n_out:
        raise ValueError(f"row_fold: {len(ios)} tensors for {code.n_in} + "
                         f"{code.n_out} descriptors")
    for d, t in enumerate(ios):
        if d < code.n_in:
            if t.dtype not in _RF_DTYPES[code.in_types[d]]:
                raise TypeError(f"row_fold: input {d} is {t.dtype}; the "
                                f"code reads {_RF_DTYPES[code.in_types[d]]}")
            ok = t.ndim == 2 and t.shape[0] in (1, N) and t.shape[1] == R
            if ok and R > 1 and t.stride(1) != 1:
                raise ValueError(f"row_fold: input {d} has row stride "
                                 f"{t.stride(1)}; rows must be adjacent")
        else:
            op = code.out_ops[d - code.n_in]
            want = (torch.int32 if op == RF_COUNT else torch.bool,
                    (N, R) if op == RF_STORE else (N,))
            if t.dtype != want[0]:
                raise TypeError(f"row_fold: output {d} is {t.dtype}, want "
                                f"{want[0]}")
            ok = tuple(t.shape) == want[1] and (op != RF_STORE or R <= 1
                                                or t.stride(1) == 1)
        if not ok:
            raise ValueError(f"row_fold: descriptor {d} of shape "
                             f"{tuple(t.shape)} strides {tuple(t.stride())} "
                             f"at (N, R) = ({N}, {R})")


def row_fold_plain(code: RowCode, ios: Sequence[torch.Tensor], N: int,
                   R: int) -> None:
    """K12's plain twin: the code's instructions, one torch operation
    each, over bool (N, R) planes; writes the output descriptors in
    place."""
    _row_ios(code, ios, N, R)
    env: Dict[int, torch.Tensor] = {}
    dev = ios[0].device if ios else torch.device("cpu")
    f32 = torch.float32

    def f(bits: int) -> torch.Tensor:
        return torch.from_numpy(np.asarray([bits], np.int32).view(
            np.float32)).to(dev).reshape(())

    def cmp(y, cop: int, k):
        if cop == RF_NZ:
            return y != 0
        if cop == RF_EQ:
            return y == k
        if cop == RF_NE:
            return y != k
        if cop == RF_GT:
            return y > k
        if cop == RF_LT:
            return y < k
        raise ValueError(f"row_fold: compare {cop}")

    rows, pc = code.instrs, 0
    while pc < len(rows):
        x, a, b, c = rows[pc]
        op, dst = x & 0xFF, x >> 8
        pc += 1
        if op == RF_BATCH:
            # dst lanes, then their compares in lane order
            q = pc + dst
            for d, m, _, _ in rows[pc:pc + dst]:
                v = ios[d].expand(N, R).to(torch.int32)
                for e in rows[q:q + m]:
                    env[e[0] >> 8] = cmp(v, e[0] & 0xFF, e[1])
                q += m
            pc = q
        elif op == RF_LANE:  # int32 or float32
            v = ios[a].expand(N, R)
            for e in rows[pc:pc + c]:
                cop, s = e[0] & 0xFF, e[0] >> 8
                if b == RF_F32:
                    env[s] = cmp(v * f(e[2]).to(f32), cop, f(e[1]))
                else:
                    env[s] = cmp(v, cop, e[1])
            pc += c
        elif op == RF_HASH:
            hi, lo = ios[a].expand(N, R), ios[b].expand(N, R)
            q, end = pc, pc + c
            while q < end:
                k, s = rows[q][0], rows[q][1]
                flat = [w for r4 in rows[q + 1:q + 1 + (k + 1) // 2]
                        for w in r4]
                acc = torch.zeros((N, R), dtype=torch.bool, device=dev)
                for j in range(k):
                    acc |= (hi == flat[2 * j]) & (lo == flat[2 * j + 1])
                env[s] = acc
                q += 1 + (k + 1) // 2
            pc = end
        elif op == RF_CONST:
            env[dst] = torch.full((N, R), bool(a), dtype=torch.bool,
                                  device=dev)
        elif op == RF_NOT:
            env[dst] = ~env[a]
        elif op == RF_AND:
            env[dst] = env[a] & env[b]
        elif op == RF_OR:
            env[dst] = env[a] | env[b]
        elif op == RF_WHERE:
            env[dst] = torch.where(env[a], env[b], env[c])
        elif op == RF_ANY:
            ios[b].copy_(env[a].any(dim=-1))
        elif op == RF_COUNT:
            ios[b].copy_(env[a].sum(dim=-1, dtype=torch.int32))
        elif op == RF_STORE:
            ios[b].copy_(env[a])
        else:
            raise ValueError(f"row_fold: opcode {op}")


def _row_stride(t: torch.Tensor) -> int:
    """The elements between resources the kernel steps: 0 for a (1, R)
    row, which every resource reads, whatever its own stride."""
    return 0 if t.shape[0] == 1 else t.stride(0)


def _row_vec(t: torch.Tensor) -> bool:
    """Whether a STORE output's 32 adjacent rows may be written as
    16-byte vectors: the resource's row 0 aligned to 16 bytes."""
    return t.data_ptr() % 16 == 0 \
        and (_row_stride(t) * t.element_size()) % 16 == 0


def row_fold(code: RowCode, ios: Sequence[torch.Tensor], N: int,
             R: int, warps: Optional[int] = None,
             grid: Optional[int] = None) -> None:
    """K12: one launch runs a compiled flush over all N resources
    (``row_lanes(R)`` lanes a resource, 32 rows a lane in each of
    ``row_words(R)`` words), a persistent grid of blocks that stage each
    tile's lanes in shared memory one fill unit at a time
    (``row_fold_plan``; ``warps`` and ``grid`` override its choice), reading its input descriptors by pointer and resource
    stride and writing its outputs in place, as
    ``row_fold_plain``. On the CPU the plain twin runs; on a CUDA tensor
    the kernel launches or this raises."""
    dev = ios[0].device
    if dev.type == "cpu":
        return row_fold_plain(code, ios, N, R)
    _row_ios(code, ios, N, R)
    for t in ios:
        if t.device != dev:
            raise ValueError(f"row_fold: a tensor on {t.device}, want {dev}")
    if len(ios) > ROW_FOLD_MAX_IO:
        raise ValueError(f"row_fold: {len(ios)} descriptors, at most "
                         f"{ROW_FOLD_MAX_IO}")
    if N == 0 or not len(code.rows):
        return
    plan = row_fold_plan(code, ios, N, R, warps, grid)
    k, pad = len(ios), [0] * (len(ios) - code.n_in)
    io = (ctypes.c_longlong * (6 * k))(
        *[t.data_ptr() for t in ios], *[_row_stride(t) for t in ios],
        *[t.element_size() for t in ios], *plan["kinds"], *pad,
        *plan["boffs"], *pad, *[int(_row_vec(t)) for t in ios])
    args = (ctypes.c_longlong * 11)(
        plan["warps"], plan["T"], plan["grid"], *plan["layout"],
        plan["smem"], len(code.units), int(plan["rows"] > 0))
    _call("row_fold", dev, _ptr(code.on(dev)), len(code.rows), code.n_slots,
          ctypes.cast(io, _P), k, code.n_in, N, R,
          row_lanes(R).bit_length() - 1, ctypes.cast(args, _P))
    count_launch("row_fold")


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def _a128(x: int) -> int:
    return -(-x // 128) * 128


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _row_layout(code: RowCode, ins: Sequence[torch.Tensor], R: int,
                T: int, warps: int, staged: bool):
    """A block's shared memory at T resources a tile (csrc/row_fold.cu's
    Layout): the mbarriers, the code and its load table (when
    ``staged``), the broadcast rows, a ring of two stages each holding
    the largest fill unit's slabs, the warps' value slots.
    Returns (kinds, broadcast offsets, [code, bcast, stage, stage bytes,
    vals], bytes in all)."""
    kinds, boffs, slab = [], [], []
    bcast = 0
    for t in ins:
        es, sn = t.element_size(), _row_stride(t)
        kind = RF_BCAST if sn == 0 else RF_SLAB if sn == R else RF_ROWS
        kinds.append(kind)
        boffs.append(bcast)
        if kind == RF_BCAST:
            bcast += _a16(R * es) + 16
        slab.append(0 if kind == RF_BCAST else
                    T * (_a16(R * es) + 16) if kind == RF_ROWS else
                    _a16(T * R * es) + 16)
    stage = max((sum(slab[d] for d in unit) for unit in code.unit_lanes),
                default=0)
    code_bytes = 16 * (len(code.rows) + -(-len(code.units) // 4))
    bars = 8 * ROW_FOLD_STAGES
    at_code = bars if staged else -1
    at_bcast = _a16(bars + (code_bytes if staged else 0))
    at_stage = _a128(at_bcast + bcast)
    stage_bytes = _a128(stage)
    at_vals = at_stage + ROW_FOLD_STAGES * stage_bytes
    smem = at_vals + warps * 4 * 32 * row_words(R) * code.n_slots
    return kinds, boffs, [at_code, at_bcast, at_stage, stage_bytes,
                          at_vals], smem


@functools.lru_cache(maxsize=4096)
def _row_resident(index: int, threads: int, smem: int) -> int:
    """The blocks of ``threads`` threads and ``smem`` bytes an SM of CUDA
    device ``index`` holds (the card's own count; ``index`` must be the
    current device)."""
    out = ctypes.c_int(0)
    _call("row_fold_occupancy", torch.device("cuda", index), threads, smem,
          ctypes.byref(out))
    return out.value


def row_fold_plan(code: RowCode, ios: Sequence[torch.Tensor], N: int,
                  R: int, warps: Optional[int] = None,
                  grid: Optional[int] = None,
                  sms: Optional[int] = None) -> Dict[str, Any]:
    """How ``row_fold`` launches ``code`` over ``ios`` at (N, R): warps a
    block (T = warps x 32 / G resources a tile), the shared-memory
    layout (``_row_layout``; the code staged when it fits), the grid
    (persistent: min(tiles, SMs x the blocks an SM holds, by the card's
    count, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the
    inputs' staging kinds. Without ``warps``, the most warps (up to 8)
    that fit in shared memory and still give every SM a tile (else one
    warp): on an H100, in ``chip_smoke.py``'s sweep over the dense
    program's slowest launches, 8 warps read fastest (a larger tile
    shares its copies, decode and barriers among more resources).
    ``grid`` overrides the grid (the GPU tests force the persistent loop
    with it). Off a CUDA device ``sms`` is given, and the grid, the
    blocks an SM holds and the tiles a block are None: such a plan is
    not launched."""
    per = 32 // row_lanes(R)
    ins = list(ios[:code.n_in])
    dev = ios[0].device if ios else torch.device("cpu")
    index = None
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
    if sms is None:
        if index is None:
            raise ValueError("row_fold_plan: give the SMs off a CUDA device")
        sms = _sm_count(index)
    fits = []
    for w in ([warps] if warps else (1, 2, 4, 8)):
        if not 1 <= w <= ROW_FOLD_MAX_WARPS:
            raise ValueError(f"row_fold: {w} warps a block")
        for staged in (True, False):
            lay = _row_layout(code, ins, R, w * per, w, staged)
            if lay[-1] <= ROW_FOLD_MAX_SMEM:
                fits.append((w, staged, lay))
                break
    if not fits:
        raise ValueError(f"row_fold: the fill units of {len(ins)} lanes at "
                         f"R = {R} and {code.n_slots} value slots do not "
                         "fit in shared memory")
    w, staged, lay = next((f for f in reversed(fits)
                           if -(-N // (f[0] * per)) >= sms), fits[0])
    kinds, boffs, layout, smem = lay
    tiles = max(1, -(-N // (w * per)))
    resident = blocks = rounds = None
    if dev.type == "cuda":
        resident = _row_resident(index, 32 * w, smem)
        blocks = max(1, min(grid or sms * resident, tiles))
        rounds = -(-tiles // blocks)
    return {"warps": w, "T": w * per, "tiles": tiles, "grid": blocks,
            "rounds": rounds,
            "units": len(code.units), "stage_bytes": layout[3],
            "smem": smem, "resident": resident, "n_slots": code.n_slots,
            "code_staged": staged, "slab": kinds.count(RF_SLAB),
            "rows": kinds.count(RF_ROWS), "bcast": kinds.count(RF_BCAST),
            "kinds": kinds, "boffs": boffs, "layout": layout}
