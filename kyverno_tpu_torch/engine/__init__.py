# Copied verbatim from kyverno_tpu/engine/__init__.py.
