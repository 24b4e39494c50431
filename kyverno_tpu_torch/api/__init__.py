# Copied verbatim from kyverno_tpu/api/__init__.py.
