# Copied verbatim from kyverno_tpu/utils/jsonpatch.py.
"""RFC 6902 JSON Patch generation (original -> patched diff).

The admission mutate response carries a JSONPatch; this mirrors the
reference's patch generation (pkg/utils/jsonutils / engine mutate
response assembly) with a minimal structural diff.
"""

from __future__ import annotations

from typing import Any, Dict, List


def _escape(seg: str) -> str:
    return seg.replace("~", "~0").replace("/", "~1")


def diff(original: Any, patched: Any, path: str = "") -> List[Dict[str, Any]]:
    if original == patched:
        return []
    if isinstance(original, dict) and isinstance(patched, dict):
        ops: List[Dict[str, Any]] = []
        for k in original:
            p = f"{path}/{_escape(str(k))}"
            if k not in patched:
                ops.append({"op": "remove", "path": p})
            else:
                ops.extend(diff(original[k], patched[k], p))
        for k in patched:
            if k not in original:
                ops.append({"op": "add", "path": f"{path}/{_escape(str(k))}",
                            "value": patched[k]})
        return ops
    if isinstance(original, list) and isinstance(patched, list):
        ops = []
        common = min(len(original), len(patched))
        for i in range(common):
            ops.extend(diff(original[i], patched[i], f"{path}/{i}"))
        # removals back-to-front keep indices stable
        for i in range(len(original) - 1, common - 1, -1):
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        for i in range(common, len(patched)):
            ops.append({"op": "add", "path": f"{path}/-", "value": patched[i]})
        return ops
    return [{"op": "replace", "path": path or "", "value": patched}]
