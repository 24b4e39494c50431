"""Engine self-analysis for the port: the dynamic lock-order sanitizer
(a copy of ``kyverno_tpu/devtools/sanitizer.py``). The static lint
checks are not ported yet."""
