"""Engine self-analysis for the port, the correctness tooling the
engine applies to itself (copies of ``kyverno_tpu/devtools/``):

- ``lint``: the static pass over the port's source (``lintcore`` and
  its five checks), surfaced as ``python -m kyverno_tpu_torch lint``.
  It is aimed at the port: the encode worker's import closure must load
  neither torch nor JAX, the port's dispatch modules (``kernels.py``,
  ``tpu/graphs.py``) are hot, and its deliberate exceptions live in the
  port's own ``devtools/lint_baseline.json``.
- ``sanitizer``: the dynamic lock-order sanitizer, armed via
  ``KYVERNO_TPU_SANITIZE=1``.

Everything here is import-light on purpose: the linter must run in a
bare interpreter and the sanitizer must be installable before any
engine module creates a lock.
"""
