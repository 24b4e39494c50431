# Copied verbatim from kyverno_tpu/cli/__init__.py.
"""kubectl-kyverno-equivalent CLI (cmd/cli/kubectl-kyverno)."""
