# Copied verbatim from kyverno_tpu/tpu/metadata.py.
"""Match/exclude feature encoding — one fixed-shape record per resource.

Encodes everything MatchesResourceDescription (pkg/engine/utils/match.go:168)
reads: GVK, name (or generateName), namespace, labels, annotations, the
namespace's labels (for namespaceSelector), the admission operation, and
the requesting user (roles / clusterRoles / username / groups).

Strings that match programs may glob (names, namespaces) are carried as
padded byte tensors; exact comparisons use hash lanes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..engine.match import RequestInfo
from ..utils import kube
from .hashing import hash_str, split32

OP_CODES = {"": 0, "CREATE": 1, "UPDATE": 2, "DELETE": 3, "CONNECT": 4}

NAME_BYTES = 64
MAX_LABELS = 24
MAX_GROUPS = 8
MAX_ROLES = 16


class MetaConfig:
    def __init__(
        self,
        name_bytes: int = NAME_BYTES,
        max_labels: int = MAX_LABELS,
        max_groups: int = MAX_GROUPS,
        max_roles: int = MAX_ROLES,
        label_key_bytes: int = 320,  # max valid key: 253 prefix + / + 63
        label_value_bytes: int = 64,
    ):
        self.name_bytes = name_bytes
        self.max_labels = max_labels
        self.max_groups = max_groups
        self.max_roles = max_roles
        # byte lanes for wildcard matchLabels (glob NFA operands);
        # lane pruning drops them when no selector needs globs, and
        # un-pruned (dense) paths only fill them when the compiled
        # policy set declares a wildcard selector
        self.label_key_bytes = label_key_bytes
        self.label_value_bytes = label_value_bytes
        self.label_bytes_enabled = False


def _h2(s: str, tag: str) -> tuple:
    return split32(hash_str(s, tag=tag))


class MetaBatch:
    def __init__(self, n: int, cfg: MetaConfig, label_bytes: bool = False):
        self.cfg = cfg
        nb = cfg.name_bytes
        # width-0 byte lanes when no compiled selector globs: the
        # program never reads them, and the dense path must not ship
        # N x 24 x 384 guaranteed zeros over H2D every scan
        kw = cfg.label_key_bytes if label_bytes else 0
        vw = cfg.label_value_bytes if label_bytes else 0
        self.labels_kb = np.zeros((n, cfg.max_labels, kw), dtype=np.uint8)
        self.labels_kb_len = np.zeros((n, cfg.max_labels), dtype=np.int32)
        self.labels_vb = np.zeros((n, cfg.max_labels, vw), dtype=np.uint8)
        self.labels_vb_len = np.zeros((n, cfg.max_labels), dtype=np.int32)
        u32 = lambda *shape: np.zeros((n,) + shape, dtype=np.uint32)  # noqa: E731
        self.group_h = u32(2)
        self.version_h = u32(2)
        self.kind_h = u32(2)
        self.name_bytes = np.zeros((n, nb), dtype=np.uint8)
        self.name_len = np.zeros((n,), dtype=np.int32)
        self.name_h = u32(2)
        self.ns_bytes = np.zeros((n, nb), dtype=np.uint8)
        self.ns_len = np.zeros((n,), dtype=np.int32)
        self.ns_h = u32(2)
        self.labels_kh = u32(cfg.max_labels, 2)
        self.labels_vh = u32(cfg.max_labels, 2)
        self.labels_n = np.zeros((n,), dtype=np.int32)
        self.ann_kh = u32(cfg.max_labels, 2)
        self.ann_vh = u32(cfg.max_labels, 2)
        self.ann_n = np.zeros((n,), dtype=np.int32)
        self.nsl_kh = u32(cfg.max_labels, 2)
        self.nsl_vh = u32(cfg.max_labels, 2)
        self.nsl_n = np.zeros((n,), dtype=np.int32)
        self.op_code = np.zeros((n,), dtype=np.int32)
        self.user_h = u32(2)
        self.user_bytes = np.zeros((n, nb), dtype=np.uint8)
        self.user_len = np.zeros((n,), dtype=np.int32)
        self.groups_h = u32(cfg.max_groups, 2)
        self.groups_n = np.zeros((n,), dtype=np.int32)
        self.roles_h = u32(cfg.max_roles, 2)
        self.roles_n = np.zeros((n,), dtype=np.int32)
        self.croles_h = u32(cfg.max_roles, 2)
        self.croles_n = np.zeros((n,), dtype=np.int32)
        self.admission_empty = np.ones((n,), dtype=np.uint8)
        self.fallback = np.zeros((n,), dtype=np.uint8)
        self.is_namespace_kind = np.zeros((n,), dtype=np.uint8)

    def arrays(self) -> Dict[str, np.ndarray]:
        return {k: v for k, v in self.__dict__.items() if isinstance(v, np.ndarray)}


def _put_bytes(dst: np.ndarray, lens: np.ndarray, i: int, s: str) -> bool:
    data = s.encode("utf-8")
    if len(data) > dst.shape[1]:
        return False
    dst[i, : len(data)] = np.frombuffer(data, dtype=np.uint8)
    lens[i] = len(data)
    return True


def _put_pairs(kh: np.ndarray, vh: np.ndarray, count: np.ndarray, i: int,
               pairs: Dict[str, str], ktag: str, vtag: str) -> bool:
    items = list((pairs or {}).items())
    if len(items) > kh.shape[1]:
        return False
    for j, (k, v) in enumerate(items):
        kh[i, j] = _h2(str(k), ktag)
        vh[i, j] = _h2(str(v), vtag)
    count[i] = len(items)
    return True


def encode_metadata(
    resources: Sequence[Dict[str, Any]],
    namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
    operations: Optional[Sequence[str]] = None,
    admission_infos: Optional[Sequence[Optional[RequestInfo]]] = None,
    cfg: Optional[MetaConfig] = None,
    need: Optional[set] = None,
) -> MetaBatch:
    """namespace_labels: namespace name -> labels map (cluster snapshot).
    operations: per-resource admission operation ("" for background).

    ``need``: lane names the consuming device program actually reads
    (ShardedScanner's recording trace) — lanes outside it skip their
    per-resource encode work. Sound because an unread lane can affect
    neither verdicts nor the fallback decisions any reader observes."""
    cfg = cfg or MetaConfig()
    ns_labels = namespace_labels or {}
    want_label_bytes = (("labels_kb" in need or "labels_vb" in need)
                        if need is not None else cfg.label_bytes_enabled)
    if want_label_bytes:
        from ..engine.selector import (SelectorError, _validate_label_key,
                                       _validate_label_value)
    batch = MetaBatch(len(resources), cfg, label_bytes=want_label_bytes)
    b = batch

    def want(*lanes: str) -> bool:
        return need is None or any(l in need for l in lanes)

    w_name_b = want("name_bytes", "name_len")
    w_ns_b = want("ns_bytes", "ns_len")
    w_labels = want("labels_kh", "labels_vh", "labels_n")
    w_ann = want("ann_kh", "ann_vh", "ann_n")
    w_nsl = want("nsl_kh", "nsl_vh", "nsl_n")
    w_user = want("user_h", "user_bytes", "user_len", "groups_h", "groups_n",
                  "roles_h", "roles_n", "croles_h", "croles_n",
                  "admission_empty")
    for i, res in enumerate(resources):
        ok = True
        group, version, kind = kube.gvk_from_resource(res)
        b.group_h[i] = _h2(group, "g")
        b.version_h[i] = _h2(version, "v")
        b.kind_h[i] = _h2(kind, "K")
        b.is_namespace_kind[i] = 1 if kind == "Namespace" else 0
        name = kube.get_name(res) or kube.get_generate_name(res)
        if w_name_b:
            ok &= _put_bytes(b.name_bytes, b.name_len, i, name)
        b.name_h[i] = _h2(name, "m")
        # Namespace resources compare their *name* for namespaces lists
        # (match.go:18-31); the match program picks via is_namespace_kind
        ns = kube.get_namespace(res)
        if w_ns_b:
            ok &= _put_bytes(b.ns_bytes, b.ns_len, i, ns)
        b.ns_h[i] = _h2(ns, "N")
        if w_labels:
            labels = kube.get_labels(res)
            ok &= _put_pairs(b.labels_kh, b.labels_vh, b.labels_n, i,
                             labels, "lk", "lv")
        if w_labels and want_label_bytes:
            for j, (lk, lv) in enumerate((labels or {}).items()):
                if j >= cfg.max_labels:
                    break
                ks, vs = str(lk), str(lv)
                kd = ks.encode("utf-8")
                vd = vs.encode("utf-8")
                # syntactically invalid label keys/values make the
                # scalar engine's wildcard expansion ERROR the
                # selector ("failed to parse selector") — such
                # resources must resolve on host, not glob-match
                try:
                    _validate_label_key(ks)
                    _validate_label_value(vs)
                except SelectorError:
                    ok = False
                    continue
                if (len(kd) > cfg.label_key_bytes
                        or len(vd) > cfg.label_value_bytes):
                    ok = False
                    continue
                b.labels_kb[i, j, : len(kd)] = np.frombuffer(kd, dtype=np.uint8)
                b.labels_kb_len[i, j] = len(kd)
                b.labels_vb[i, j, : len(vd)] = np.frombuffer(vd, dtype=np.uint8)
                b.labels_vb_len[i, j] = len(vd)
        if w_ann:
            ok &= _put_pairs(b.ann_kh, b.ann_vh, b.ann_n, i,
                             kube.get_annotations(res), "ak", "av")
        if w_nsl:
            nsl = ns_labels.get(kube.get_name(res) if kind == "Namespace" else ns, {})
            ok &= _put_pairs(b.nsl_kh, b.nsl_vh, b.nsl_n, i, nsl, "lk", "lv")
        op = (operations[i] if operations else "") or ""
        b.op_code[i] = OP_CODES.get(op, 0)
        info = admission_infos[i] if admission_infos else None
        if w_user and info is not None and not info.is_empty():
            b.admission_empty[i] = 0
            b.user_h[i] = _h2(info.username, "u")
            ok &= _put_bytes(b.user_bytes, b.user_len, i, info.username)
            for arr_h, arr_n, items, tag in (
                (b.groups_h, b.groups_n, info.groups, "u"),
                (b.roles_h, b.roles_n, info.roles, "r"),
                (b.croles_h, b.croles_n, info.cluster_roles, "r"),
            ):
                if len(items) > arr_h.shape[1]:
                    ok = False
                    continue
                for j, it in enumerate(items):
                    arr_h[i, j] = _h2(it, tag)
                arr_n[i] = len(items)
        b.fallback[i] = 0 if ok else 1
    return batch
