# Copied verbatim from kyverno_tpu/utils/__init__.py.
