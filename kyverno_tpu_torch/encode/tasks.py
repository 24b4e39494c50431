# Copied from kyverno_tpu/encode/tasks.py (the docstring names torch
# where it named JAX).
"""Worker-side encode task implementations — pure NumPy/stdlib.

These functions execute INSIDE encoder-pool worker processes
(encode/worker.py), so they may only touch the host side of the tpu
package: flatten, metadata, hashing, cache (row trimming). Importing
anything that pulls torch here would load the device runtime into every
spawned worker — tpu/__init__.py imports nothing, so this module can
import ``tpu.flatten`` without it.

A *profile* is the per-compiled-set encode configuration shipped to a
worker once (and re-shipped after a restart): encode caps, compiled
byte-path sets, metadata config, the lane keys the device program
actually reads, and the mesh pad multiple. Tasks then carry only the
chunk-varying parts (resources, operations, ns labels, the current
shape buckets), so the steady-state IPC cost is the chunk itself.

Two task kinds:

- ``vocab`` — the scan feed: pad to the mesh multiple, vocabulary-
  encode rows + metadata, grow the shape buckets monotonically, build
  the transfer-ready host lane dict (filtered to the used keys). This
  is everything ShardedScanner.encode does, relocated into the worker.
- ``rows`` — the admission feed: dense row encode, trimmed to
  per-resource entries in exactly the EncodeRowCache form, so pooled
  results warm the shared cache and warm rows never re-enter the pool.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..tpu.cache import extract_rows
from ..tpu.flatten import (EncodeConfig, encode_resources,
                           encode_resources_vocab)
from ..tpu.metadata import MetaConfig, encode_metadata

KIND_VOCAB = "vocab"
KIND_ROWS = "rows"


class Profile:
    """Decoded per-policy-set encode configuration (one per worker,
    cached by profile id; see EncoderPool.register_profile)."""

    __slots__ = ("encode_cfg", "byte_paths", "key_byte_paths", "meta_cfg",
                 "meta_need", "used_keys", "pad_multiple", "ns_labels")

    def __init__(self, spec: Dict[str, Any]):
        self.encode_cfg = EncodeConfig(*spec["encode_cfg"])
        self.byte_paths = frozenset(spec.get("byte_paths") or ())
        self.key_byte_paths = frozenset(spec.get("key_byte_paths") or ())
        meta = spec.get("meta_cfg")
        self.meta_cfg = MetaConfig(**meta) if meta else None
        need = spec.get("meta_need")
        self.meta_need = set(need) if need is not None else None
        used = spec.get("used_keys")
        self.used_keys = set(used) if used is not None else None
        self.pad_multiple = int(spec.get("pad_multiple") or 1)
        # scan-scoped: ns labels are invariant across a scan's chunks,
        # so they ship once per worker with the profile, never per task
        self.ns_labels = spec.get("ns_labels")


def profile_spec(encode_cfg: EncodeConfig, byte_paths=None,
                 key_byte_paths=None, meta_cfg: Optional[MetaConfig] = None,
                 meta_need=None, used_keys=None, pad_multiple: int = 1,
                 ns_labels=None) -> Dict[str, Any]:
    """The pickleable profile form (plain ints/lists/dicts only)."""
    out = {"ns_labels": ns_labels} if ns_labels else {}
    out.update(_base_spec(encode_cfg, byte_paths, key_byte_paths, meta_cfg,
                          meta_need, used_keys, pad_multiple))
    return out


def _base_spec(encode_cfg, byte_paths, key_byte_paths, meta_cfg, meta_need,
               used_keys, pad_multiple) -> Dict[str, Any]:
    return {
        "encode_cfg": (encode_cfg.max_rows, encode_cfg.max_instances,
                       encode_cfg.byte_pool_slots,
                       encode_cfg.byte_pool_width),
        "byte_paths": sorted(byte_paths or ()),
        "key_byte_paths": sorted(key_byte_paths or ()),
        "meta_cfg": ({k: getattr(meta_cfg, k) for k in
                      ("name_bytes", "max_labels", "max_groups", "max_roles",
                       "label_key_bytes", "label_value_bytes")}
                     if meta_cfg is not None else None),
        "meta_need": sorted(meta_need) if meta_need is not None else None,
        "used_keys": sorted(used_keys) if used_keys is not None else None,
        "pad_multiple": int(pad_multiple),
    }


def encode_vocab_host(resources, ns_labels, operations, encode_cfg,
                      byte_paths, key_byte_paths, meta_cfg, meta_need,
                      used_keys, pad_multiple, buckets, encoder=None):
    """THE vocab-form encode body — pad to the mesh multiple,
    vocab-encode rows + metadata, grow the shape buckets (monotone
    doubling so shapes converge and XLA programs are reused), build
    the transfer-ready host dict filtered to the used lanes. Shared by
    ShardedScanner.encode (in-process) and run_vocab (pool workers):
    one implementation, so the two paths cannot drift and the
    bit-identity contract survives future encode changes."""
    n = len(resources)
    d = max(pad_multiple, 1)
    # batch-axis bucket: powers of two (floor 16, the engine's
    # MIN_BUCKET rationale) so arbitrary chunk sizes reuse at most
    # ~log2 jitted programs. Without this every distinct ragged-tail
    # size — e.g. each incremental scan tick's dirty count — is a new
    # N shape and a full XLA recompile (~tens of seconds and hundreds
    # of MB of program cache per tick on an endurance soak). Pads are
    # empty resources excluded from the returned ``n``, exactly like
    # the mesh-multiple pads below.
    b = 16
    while b < n:
        b *= 2
    padded = ((b + d - 1) // d) * d
    res = list(resources) + [{} for _ in range(padded - n)]
    ops = (list(operations) + [""] * (padded - n)) if operations else None
    # ``encoder`` is the row-encoder seam: ShardedScanner routes its
    # module-level encode_resources_vocab through here so callers (and
    # tests) that patch it still intercept every in-process encode
    vb = (encoder or encode_resources_vocab)(res, encode_cfg, byte_paths,
                                             key_byte_paths)
    meta = encode_metadata(res, ns_labels, ops, cfg=meta_cfg, need=meta_need)
    vbucket, sbucket, rbucket = buckets or (1024, 256, 64)
    while vbucket < vb.vocab_size:
        vbucket *= 2
    while sbucket < len(vb.strs):
        sbucket *= 2
    max_rows = encode_cfg.max_rows
    rbucket = min(rbucket, max_rows)
    while (rbucket < int(vb.n_rows.max(initial=0)) and rbucket < max_rows):
        rbucket = min(rbucket * 2, max_rows)
    host = vb.to_host(meta, vbucket, sbucket, rbucket)
    if used_keys is not None:
        host = {k: v for k, v in host.items() if k in used_keys}
    return host, n, (vbucket, sbucket, rbucket)


def run_vocab(profile: Profile, payload: Dict[str, Any]) -> Dict[str, Any]:
    """The scan-feed task: the shared encode body against this
    profile. ``ns_labels`` rides the PROFILE (one ship per worker per
    scan), with a payload override for callers without one."""
    host, n, buckets = encode_vocab_host(
        payload["resources"],
        payload.get("ns_labels") or profile.ns_labels,
        payload.get("operations"),
        profile.encode_cfg, profile.byte_paths, profile.key_byte_paths,
        profile.meta_cfg, profile.meta_need, profile.used_keys,
        profile.pad_multiple, payload.get("buckets"))
    return {"host": host, "n": n, "buckets": buckets}


def run_rows(profile: Profile, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Dense row encode for the admission feed, returned as trimmed
    per-resource entries (tpu/cache.py extract_rows form)."""
    resources = payload["resources"]
    batch = encode_resources(resources, profile.encode_cfg,
                             profile.byte_paths, profile.key_byte_paths)
    rows: List[Any] = [extract_rows(batch, i) for i in range(len(resources))]
    return {"rows": rows, "n": len(resources)}


_RUNNERS = {KIND_VOCAB: run_vocab, KIND_ROWS: run_rows}


def run(kind: str, profile: Profile, payload: Dict[str, Any]) -> Dict[str, Any]:
    try:
        fn = _RUNNERS[kind]
    except KeyError:
        raise ValueError(f"unknown encode task kind {kind!r}") from None
    return fn(profile, payload)
