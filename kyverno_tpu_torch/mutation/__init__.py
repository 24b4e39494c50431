# Copied from kyverno_tpu/mutation/__init__.py.
"""Device-triaged batched mutation.

The mutate workload's batched front door:

- ``triage.py`` — compile a mutate rule's match/exclude/preconditions
  into a *needs-mutation* predicate (a validate ``deny: {}`` shell)
  through the existing IR compiler, so triage evaluates as a device
  cross-product over encoded columnar rows. Most admissions are
  triage-negative and never touch the host patcher.
- ``lowering.py`` — lower constant add/replace strategic-merge
  overlays into precomputed ``PatchTemplate``s stamped per
  triage-positive row, bit-identical to ``engine/mutate.py`` (the
  scalar oracle), plus the read/write-path analysis that demotes
  chain-dependent rules to host triage.
- ``coordinator.py`` — per-resource application: templates where
  lowerable, the scalar patcher everywhere else, chaining the patched
  resource across policies exactly like ``Engine.mutate``.

Degradation ladder: device triage -> host patcher -> per-rule ERROR.
"""

from .lowering import (PatchTemplate, lower_mutate_rule, paths_conflict,
                       rule_read_paths, rule_write_paths)
from .triage import synthetic_triage_policy, triage_rule

__all__ = [
    "PatchTemplate",
    "lower_mutate_rule",
    "paths_conflict",
    "rule_read_paths",
    "rule_write_paths",
    "synthetic_triage_policy",
    "triage_rule",
]
