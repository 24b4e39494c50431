"""Hand-written CUDA kernels of the port, their loader, and their plain
PyTorch twins.

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
- adds one to ``LAUNCHES[<name>]`` for each kernel launch, and nowhere
  else.

The ``*_plain`` functions repeat each kernel's arithmetic in PyTorch;
the CPU tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import torch

NUM_VERDICT_CLASSES = 7

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "build", "kernels")
SOURCES = ("dfa_scan", "instance_count", "verdict_counts")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counts per kernel entry (see module docstring)
LAUNCHES: Dict[str, int] = {
    "dfa_scan_fused": 0,
    "dfa_scan_stride1": 0,
    "instance_count": 0,
    "instance_count2": 0,
    "verdict_counts": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "dfa_scan_fused": ("dfa_scan",
                       [_P, _P, _L, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P]),
    "dfa_scan_stride1": ("dfa_scan",
                         [_P, _P, _L, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P]),
    "instance_count": ("instance_count", [_P, _P, _P, _P, _L, _I, _I, _P, _P]),
    "verdict_counts": ("verdict_counts", [_P, _I, _L, _P, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
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
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        for fn, (src, argtypes) in _SIGNATURES.items():
            f = getattr(_libs[src], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _fns[fn] = f
        return {n: _libs[n]._name for n in SOURCES}


def _call(fn: str, *args) -> None:
    if fn not in _fns:
        build_all()
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fns[fn](*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError {rc}")


def _check(t: torch.Tensor, name: str, dtype, device, ndim: Optional[int] = None
           ) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: {t.ndim} dims, want {ndim}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K1 dfa_scan (csrc/dfa_scan.cu): replaces kyverno_tpu/tpu/dfa.py
# _scan_fused, _scan_stride1 and nonascii_mask, plus bank_match's accept
# lookup. Bound by gather latency (one dependent table read per pair or
# byte); the bytes moved are the lengths, the live bytes of each subject
# (up to min(len, W)) and the output.


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


def dfa_scan_fused(bytes_: torch.Tensor, lens: torch.Tensor,
                   trans: torch.Tensor, pairs: torch.Tensor,
                   starts: torch.Tensor, accept: torch.Tensor, pitch: int,
                   chain: int, want_nonascii: bool = False):
    """K1, fused entry: (S, W) subjects -> ((S, K) bool accepts,
    (S,) bool non-ASCII flags or None)."""
    if bytes_.device.type == "cpu":
        acc = dfa_scan_fused_plain(bytes_, lens, trans, pairs, starts,
                                   accept, pitch, chain)
        return acc, (nonascii_plain(bytes_, lens) if want_nonascii else None)
    dev = _dfa_args(bytes_, lens)
    _check(trans, "fused_trans", torch.int32, dev, 1)
    _check(pairs, "fused_pairs", torch.int32, dev, 1)
    _check(starts, "fused_start", torch.int32, dev, 1)
    _check(accept, "fused_accept", torch.uint8, dev, 1)
    if pairs.shape[0] != 1024:
        raise ValueError(f"fused_pairs has {pairs.shape[0]} entries, want 1024")
    if chain not in (1, 2) or pitch <= 0:
        raise ValueError(f"chain {chain}, pitch {pitch}")
    S, W = bytes_.shape
    K = starts.shape[0]
    out = torch.empty((S, K), dtype=torch.bool, device=dev)
    na = torch.empty((S,), dtype=torch.bool, device=dev) if want_nonascii else None
    if S * max(K, 1) and (K or want_nonascii):
        _call("dfa_scan_fused", _ptr(bytes_), _ptr(lens), S, W, _ptr(trans),
              _ptr(pairs), _ptr(starts), _ptr(accept), K, pitch, _ptr(out),
              _ptr(na))
        LAUNCHES["dfa_scan_fused"] += 1
    return out, na


def dfa_scan_stride1(bytes_: torch.Tensor, lens: torch.Tensor,
                     trans: torch.Tensor, n_classes: int,
                     class_map: torch.Tensor, starts: torch.Tensor,
                     accept: torch.Tensor, want_nonascii: bool = False):
    """K1, stride-1 entry: (S, W) subjects -> ((S, K) bool accepts,
    (S,) bool non-ASCII flags or None). ``trans`` is the bank's uint16
    table widened to int32 and flattened; ``class_map`` is (K, 256)."""
    if bytes_.device.type == "cpu":
        acc = dfa_scan_stride1_plain(bytes_, lens, trans, n_classes,
                                     class_map, starts, accept)
        return acc, (nonascii_plain(bytes_, lens) if want_nonascii else None)
    dev = _dfa_args(bytes_, lens)
    K = starts.shape[0]
    if K:
        _check(trans, "trans", torch.int32, dev, 1)
        _check(class_map, "class_map", torch.uint8, dev, 2)
        _check(starts, "start", torch.int32, dev, 1)
        _check(accept, "accept", torch.uint8, dev, 1)
        if tuple(class_map.shape) != (K, 256):
            raise ValueError(f"class_map {tuple(class_map.shape)}, want ({K}, 256)")
    S, W = bytes_.shape
    out = torch.empty((S, K), dtype=torch.bool, device=dev)
    na = torch.empty((S,), dtype=torch.bool, device=dev) if want_nonascii else None
    if S * max(K, 1) and (K or want_nonascii):
        _call("dfa_scan_stride1", _ptr(bytes_), _ptr(lens), S, W,
              _ptr(trans if K else None), n_classes,
              _ptr(class_map if K else None), _ptr(starts if K else None),
              _ptr(accept if K else None), K, _ptr(out), _ptr(na))
        LAUNCHES["dfa_scan_stride1"] += 1
    return out, na


def nonascii(bytes_: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """K1's non-ASCII output alone (the stride-1 entry with no
    patterns): (S, W) uint8, (S,) int32 -> (S,) bool."""
    if bytes_.device.type == "cpu":
        return nonascii_plain(bytes_, lens)
    empty = torch.empty((0,), dtype=torch.int32, device=bytes_.device)
    return dfa_scan_stride1(bytes_, lens, empty, 1, empty, empty, empty,
                            want_nonascii=True)[1]


# ---------------------------------------------------------------------------
# K3 instance_count (csrc/instance_count.cu): replaces
# kyverno_tpu/tpu/evaluator.py InstScope.count / Inst2Scope.count (the
# f32 one-hot einsums). Bound by the bytes of pred/valid/scope lanes.


def instance_count_plain(pred: torch.Tensor, scope1: torch.Tensor,
                         valid: torch.Tensor, n_inst: int,
                         scope2: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(N, R) bool rows -> (N, I) int32 (or (N, I, I) with ``scope2``)
    counts of rows that are true and valid, by scope index; rows whose
    scope lies outside [0, I) count nowhere."""
    ar = torch.arange(n_inst, device=pred.device, dtype=scope1.dtype)
    live = pred & valid
    oh1 = scope1[:, :, None] == ar[None, None, :]
    if scope2 is None:
        return (oh1 & live[:, :, None]).sum(dim=1, dtype=torch.int32)
    oh2 = scope2[:, :, None] == ar[None, None, :]
    both = (oh1[:, :, :, None] & oh2[:, :, None, :]) & live[:, :, None, None]
    return both.sum(dim=1, dtype=torch.int32)


def _instance_count(pred, scope1, valid, n_inst, scope2, name):
    if pred.device.type == "cpu":
        return instance_count_plain(pred, scope1, valid, n_inst, scope2)
    dev = pred.device
    _check(pred, "pred", torch.bool, dev, 2)
    _check(valid, "valid", torch.bool, dev, 2)
    _check(scope1, "scope1", torch.int32, dev, 2)
    shapes = {tuple(pred.shape), tuple(valid.shape), tuple(scope1.shape)}
    if scope2 is not None:
        _check(scope2, "scope2", torch.int32, dev, 2)
        shapes.add(tuple(scope2.shape))
    if len(shapes) != 1:
        raise ValueError(f"instance_count: mismatched shapes {shapes}")
    if not 0 < n_inst <= 64:
        raise ValueError(f"instance_count: I={n_inst} outside (0, 64]")
    N, R = pred.shape
    cells = (n_inst,) if scope2 is None else (n_inst, n_inst)
    out = torch.empty((N,) + cells, dtype=torch.int32, device=dev)
    if N:
        _call("instance_count", _ptr(pred), _ptr(scope1), _ptr(scope2),
              _ptr(valid), N, R, n_inst, _ptr(out))
        LAUNCHES[name] += 1
    return out


def instance_count(pred: torch.Tensor, scope1: torch.Tensor,
                   valid: torch.Tensor, n_inst: int) -> torch.Tensor:
    """K3, one level: (N, R) -> (N, I) int32."""
    return _instance_count(pred, scope1, valid, n_inst, None,
                           "instance_count")


def instance_count2(pred: torch.Tensor, scope1: torch.Tensor,
                    scope2: torch.Tensor, valid: torch.Tensor,
                    n_inst: int) -> torch.Tensor:
    """K3, two levels: (N, R) -> (N, I, I) int32."""
    return _instance_count(pred, scope1, valid, n_inst, scope2,
                           "instance_count2")


# ---------------------------------------------------------------------------
# K4 verdict_counts (csrc/verdict_counts.cu): replaces the counts of
# kyverno_tpu/tpu/evaluator.py build_program.run. Bound by reading the
# table once.


def verdict_counts_plain(table: torch.Tensor) -> torch.Tensor:
    """(rules, N) int32 -> (rules, 7) int32 class histogram."""
    ar = torch.arange(NUM_VERDICT_CLASSES, device=table.device,
                      dtype=table.dtype)
    return (table[:, :, None] == ar).sum(dim=1, dtype=torch.int32)


def verdict_counts(table: torch.Tensor) -> torch.Tensor:
    """K4: (rules, N) int32 -> (rules, 7) int32."""
    if table.device.type == "cpu":
        return verdict_counts_plain(table)
    _check(table, "table", torch.int32, table.device, 2)
    rules, N = table.shape
    out = torch.empty((rules, NUM_VERDICT_CLASSES), dtype=torch.int32,
                      device=table.device)
    if rules and N:
        _call("verdict_counts", _ptr(table), rules, N, _ptr(out))
        LAUNCHES["verdict_counts"] += 1
    elif rules:
        out.zero_()
    return out
