"""Carry a compiled DFA bank across from the JAX package.

For this system the "parameters" of the device program are the
compiled pattern tables. ``bank_from_numpy`` rebuilds the port's
``DfaBank`` from the numpy arrays of a finalized
``kyverno_tpu.tpu.dfa.DfaBank`` (passed as a plain dict, so this module
imports nothing of the JAX package), so the port can be run on exactly
the reference's tables, independent of its own copy of the DFA
compiler. ``bank_to_numpy`` is the inverse view of a port bank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from .dfa import DfaBank

ARRAYS = ("trans", "accept", "start", "class_map", "strides", "fused_trans",
          "fused_pairs", "fused_start", "fused_accept")


@dataclass
class PatternFlags:
    """What the device program reads of one compiled pattern."""

    pattern: str
    kind: str
    exact: bool
    confirm_nonascii: bool


def bank_to_numpy(bank: Any) -> Dict[str, Any]:
    """The arrays and per-pattern flags of a finalized bank (either
    package's) as a plain dict — the input of ``bank_from_numpy``."""
    out: Dict[str, Any] = {k: getattr(bank, k) for k in ARRAYS}
    out["fused_pitch"] = int(bank.fused_pitch)
    out["families"] = {f: list(ids) for f, ids in bank.families.items()}
    out["glob_ids"] = dict(bank.glob_ids)
    out["re2_ids"] = dict(bank.re2_ids)
    out["budget"] = bank.budget
    out["ceiling"] = bank.ceiling
    out["patterns"] = [
        {"pattern": p.pattern, "kind": p.kind, "exact": bool(p.exact),
         "confirm_nonascii": bool(p.confirm_nonascii)}
        for p in bank.patterns]
    return out


def bank_from_numpy(arrays: Dict[str, Any]) -> DfaBank:
    """A port ``DfaBank`` holding exactly ``arrays``' tables."""
    bank = DfaBank(arrays.get("budget"), arrays.get("ceiling"))
    for k in ARRAYS:
        v = arrays.get(k)
        setattr(bank, k, None if v is None else np.array(v, copy=True))
    bank.fused_pitch = int(arrays.get("fused_pitch") or 0)
    bank.families = {f: sorted(int(i) for i in ids)
                     for f, ids in arrays["families"].items()}
    bank.glob_ids = {str(k): int(v) for k, v in arrays["glob_ids"].items()}
    bank.re2_ids = {str(k): int(v) for k, v in arrays["re2_ids"].items()}
    pats: List[PatternFlags] = [PatternFlags(**p) for p in arrays["patterns"]]
    bank.patterns = pats
    bank.exact = np.array([p.exact for p in pats] or [True], dtype=bool)
    bank.confirm_nonascii = np.array([p.confirm_nonascii for p in pats]
                                     or [False], dtype=bool)
    return bank
