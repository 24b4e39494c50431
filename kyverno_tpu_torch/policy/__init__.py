# Copied verbatim from kyverno_tpu/policy/__init__.py.
"""Policy lifecycle services: autogen, loading, cache, validation."""
