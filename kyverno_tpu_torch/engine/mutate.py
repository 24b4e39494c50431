# Copied verbatim from kyverno_tpu/engine/mutate.py.
"""Mutation patch engines.

Host-side re-implementation of pkg/engine/mutate/patch:

- ``patchStrategicMerge`` — Kyverno's anchor-aware strategic merge
  overlay (strategicMergePatch.go + strategicPreprocessing.go):
  condition anchors gate subtrees, ``+(key)`` adds only when absent,
  lists of maps merge per-element (by ``name`` merge key when both
  sides carry it, mirroring kyaml's schema-driven merge for
  containers/env/ports/volumes).
- ``patchesJson6902`` — RFC 6902 JSON patch (add/remove/replace/
  copy/move/test) over JSON-pointer paths (patchJSON6902.go).

Mutation is host-plane by design: it is structural, low-QPS relative
to validate, and its output feeds the admission response — see
SURVEY.md §7 step 7.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Tuple

from . import anchor as anchorpkg
from . import pattern as patternpkg


class PatchError(Exception):
    pass


# ---------------------------------------------------------------------------
# strategic merge with anchors


def strategic_merge(resource: Any, overlay: Any) -> Any:
    """Apply a Kyverno strategic-merge overlay to a resource; returns
    the patched copy (resource untouched)."""
    resource = copy.deepcopy(resource)
    ok, patched = _merge_element(resource, overlay)
    return patched if ok else resource


def _conditions_met(resource: Any, overlay_map: Dict[str, Any]) -> bool:
    """Check all condition anchors in this overlay map level against
    the resource (strategicPreprocessing.go condition walking)."""
    if not isinstance(resource, dict):
        return False
    for key, value in overlay_map.items():
        a = anchorpkg.parse(key)
        if anchorpkg.is_condition(a):
            if a.key not in resource:
                return False
            if not _check_condition(resource[a.key], value):
                return False
    return True


def _check_condition(resource_value: Any, pattern_value: Any) -> bool:
    if isinstance(pattern_value, dict):
        if not isinstance(resource_value, dict):
            return False
        for k, v in pattern_value.items():
            a = anchorpkg.parse(k)
            key = a.key if a is not None else k
            if key not in resource_value:
                return False
            if not _check_condition(resource_value[key], v):
                return False
        return True
    if isinstance(pattern_value, list):
        if not isinstance(resource_value, list):
            return False
        if pattern_value and isinstance(pattern_value[0], dict):
            return any(_check_condition(rv, pattern_value[0]) for rv in resource_value)
        return True
    return patternpkg.validate(resource_value, pattern_value)


def _merge_element(resource: Any, overlay: Any) -> Tuple[bool, Any]:
    """Returns (applied, merged)."""
    if isinstance(overlay, dict):
        if not isinstance(resource, dict):
            return True, _strip_anchors(overlay)
        if not _conditions_met(resource, overlay):
            return False, resource
        out = dict(resource)
        for key, value in overlay.items():
            a = anchorpkg.parse(key)
            if anchorpkg.is_condition(a):
                # conditions already checked; the anchored value may
                # still carry nested mutations alongside the condition
                ok, merged = _merge_element(out.get(a.key), value)
                if ok:
                    out[a.key] = merged
                continue
            if anchorpkg.is_add_if_not_present(a):
                if a.key not in out:
                    out[a.key] = _strip_anchors(value)
                continue
            if a is not None:
                # other anchors are validation-only; ignore in mutation
                continue
            ok, merged = _merge_element(out.get(key), value)
            if ok:
                out[key] = merged
        return True, out
    if isinstance(overlay, list):
        return _merge_list(resource, overlay)
    return True, overlay


def _merge_list(resource: Any, overlay: List[Any]) -> Tuple[bool, Any]:
    if not isinstance(resource, list):
        return True, _strip_anchors(overlay)
    if not overlay:
        return True, resource
    if isinstance(overlay[0], dict):
        out = [copy.deepcopy(x) for x in resource]
        for pat in overlay:
            if not isinstance(pat, dict):
                continue
            merge_key_val = pat.get("name")
            has_anchor = any(anchorpkg.parse(k) is not None for k in pat)
            if merge_key_val is not None and not has_anchor:
                # merge-by-name: patch the matching element or append
                for i, element in enumerate(out):
                    if isinstance(element, dict) and element.get("name") == merge_key_val:
                        ok, merged = _merge_element(element, pat)
                        if ok:
                            out[i] = merged
                        break
                else:
                    out.append(_strip_anchors(pat))
            else:
                # anchored (or keyless) element pattern: apply to every
                # element whose conditions match
                applied_any = False
                for i, element in enumerate(out):
                    ok, merged = _merge_element(element, pat)
                    if ok:
                        out[i] = merged
                        applied_any = True
                if not applied_any and not has_anchor:
                    out.append(_strip_anchors(pat))
        return True, out
    # scalar overlay list replaces
    return True, overlay


def _strip_anchors(value: Any) -> Any:
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            a = anchorpkg.parse(k)
            if anchorpkg.is_condition(a) or anchorpkg.is_negation(a) or anchorpkg.is_existence(a) or anchorpkg.is_equality(a):
                continue
            key = a.key if anchorpkg.is_add_if_not_present(a) else k
            out[key] = _strip_anchors(v)
        return out
    if isinstance(value, list):
        return [_strip_anchors(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# RFC 6902 JSON patch


def _pointer_segments(pointer: str) -> List[str]:
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise PatchError(f"invalid JSON pointer {pointer!r}")
    return [seg.replace("~1", "/").replace("~0", "~") for seg in pointer.split("/")[1:]]


def _resolve_parent(doc: Any, segments: List[str],
                    ensure: bool = False) -> Tuple[Any, str]:
    node = doc
    for i, seg in enumerate(segments[:-1]):
        if isinstance(node, dict):
            if seg not in node:
                if not ensure:
                    raise PatchError(f"path not found: {seg}")
                # create the missing container: a list when the NEXT
                # segment is an index / "-", else a map
                nxt = segments[i + 1]
                node[seg] = [] if (nxt == "-" or nxt.lstrip("-").isdigit()) else {}
            node = node[seg]
        elif isinstance(node, list):
            try:
                node = node[int(seg)]
            except (ValueError, IndexError):
                raise PatchError(f"bad array index {seg}")
        else:
            raise PatchError(f"cannot traverse into {type(node).__name__}")
    return node, segments[-1] if segments else ""


def _get_at(doc: Any, pointer: str) -> Any:
    segments = _pointer_segments(pointer)
    node = doc
    for seg in segments:
        if isinstance(node, dict):
            if seg not in node:
                raise PatchError(f"path not found: {pointer}")
            node = node[seg]
        elif isinstance(node, list):
            try:
                node = node[int(seg)]
            except (ValueError, IndexError):
                raise PatchError(f"bad array index in {pointer}")
        else:
            raise PatchError(f"cannot traverse {pointer}")
    return node


def apply_json6902(resource: Dict[str, Any], patches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Apply an RFC 6902 patch list; returns patched copy."""
    doc = copy.deepcopy(resource)
    for p in patches:
        op = p.get("op")
        path = p.get("path", "")
        segments = _pointer_segments(path)
        if op in ("add", "replace", "test"):
            value = p.get("value")
        if op == "add":
            if not segments:
                doc = value
                continue
            # EnsurePathExistsOnAdd (patchJSON6902.go:25): the engine
            # applies adds with missing intermediate containers created
            # on the way (maps for name segments, lists for indices)
            parent, last = _resolve_parent(doc, segments, ensure=True)
            if isinstance(parent, list):
                if last == "-":
                    parent.append(value)
                else:
                    try:
                        idx = int(last)
                    except ValueError:
                        raise PatchError(f"bad array index {last}")
                    if idx < 0:  # SupportNegativeIndices
                        idx += len(parent) + 1
                    if not 0 <= idx <= len(parent):
                        # list.insert would silently clamp; the
                        # reference engine rejects out-of-bounds adds
                        raise PatchError(f"index {last} out of bounds")
                    parent.insert(idx, value)
            elif isinstance(parent, dict):
                parent[last] = value
            else:
                raise PatchError(f"cannot add into {type(parent).__name__}")
        elif op == "remove":
            # AllowMissingPathOnRemove: absent paths are a no-op
            try:
                parent, last = _resolve_parent(doc, segments)
            except PatchError:
                continue
            if isinstance(parent, list):
                try:
                    del parent[int(last)]
                except ValueError:
                    raise PatchError(f"bad array index {last}")
                except IndexError:
                    continue
            elif isinstance(parent, dict):
                if last not in parent:
                    continue
                del parent[last]
        elif op == "replace":
            if not segments:
                doc = value
                continue
            parent, last = _resolve_parent(doc, segments)
            if isinstance(parent, list):
                try:
                    parent[int(last)] = value
                except (ValueError, IndexError):
                    raise PatchError(f"bad array index {last}")
            elif isinstance(parent, dict):
                parent[last] = value
        elif op == "copy":
            value = copy.deepcopy(_get_at(doc, p.get("from", "")))
            doc = apply_json6902(doc, [{"op": "add", "path": path, "value": value}])
        elif op == "move":
            value = copy.deepcopy(_get_at(doc, p.get("from", "")))
            doc = apply_json6902(doc, [{"op": "remove", "path": p.get("from", "")}])
            doc = apply_json6902(doc, [{"op": "add", "path": path, "value": value}])
        elif op == "test":
            if _get_at(doc, path) != value:
                raise PatchError(f"test failed at {path}")
        else:
            raise PatchError(f"unknown op {op!r}")
    return doc


def load_json6902(patch: Any) -> List[Dict[str, Any]]:
    """patchesJson6902 may be a YAML/JSON string or a list."""
    if isinstance(patch, str):
        import yaml

        loaded = yaml.safe_load(patch)
        if not isinstance(loaded, list):
            raise PatchError("patchesJson6902 must be a list of operations")
        return loaded
    if isinstance(patch, list):
        return patch
    raise PatchError("patchesJson6902 must be a list or string")
