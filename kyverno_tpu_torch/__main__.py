# Copied verbatim from kyverno_tpu/__main__.py.
"""`python -m kyverno_tpu_torch` — alias for `python -m kyverno_tpu_torch.cli`."""

import sys

from .cli.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
