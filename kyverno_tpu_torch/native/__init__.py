# Adapted from kyverno_tpu/native/__init__.py: the library is built into build/native/.
"""Native (C) components, compiled lazily with the system toolchain.

The resource encoder is the scan pipeline's serial host bottleneck, so
its hot walk lives in fastencode.c (see that file's header for the
parity contract with the Python walk). The extension is built with
``gcc`` at first use into ``build/native/fastencode-<source hash>.so``
at the root of the checkout (never into the package). Build failures or
KYVERNO_TPU_NATIVE=0 degrade silently to the Python encoder: it is host
code and gives the same lanes (up to vocabulary row order).

``load()`` memoizes its first answer for the whole process."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "native")

_mod = None
_tried = False


def library_path() -> str:
    """Where the extension for the current source lives."""
    with open(os.path.join(_HERE, "fastencode.c"), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"fastencode-{tag}.so")


def load() -> Optional[object]:
    """Compile (if missing) and import the _fastencode extension; None
    when it cannot be built or KYVERNO_TPU_NATIVE=0."""
    global _mod, _tried
    if _tried:
        return _mod
    _tried = True
    if os.environ.get("KYVERNO_TPU_NATIVE", "1") == "0":
        return None
    src = os.path.join(_HERE, "fastencode.c")
    try:
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            inc = sysconfig.get_paths()["include"]
            cc = os.environ.get("CC", "gcc")
            tmp = so + f".tmp{os.getpid()}"
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", f"-I{inc}", src, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic: concurrent builders race safely
        spec = importlib.util.spec_from_file_location("_fastencode", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        _mod = mod
    except Exception:
        _mod = None
    return _mod
