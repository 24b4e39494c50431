# Copied from kyverno_tpu/encode/worker.py (its handshake also reports
# torch).
"""Encoder-pool worker — a freshly spawned interpreter per worker.

Launched by the supervisor as ``python -m kyverno_tpu_torch.encode.worker``
(a subprocess spawn, never a fork: a forked child of a CUDA parent
cannot use CUDA and holds copies of the parent's device handles, and
re-importing the parent's ``__main__`` — what multiprocessing's spawn
does — would drag the full serving stack into every encoder). A worker
imports ONLY the host-side encode modules; the ``ready`` handshake
reports whether torch (or JAX) leaked in so the pool's tests can assert
the feed stays a pure NumPy/stdlib process.

Protocol (pickle frames over stdin/stdout):

  parent -> worker:
    ("init", {"faults": spec-string, "hb_interval": seconds})
    ("profile", profile_id, profile-spec dict)
    ("task", task_id, profile_id, kind, payload)
    ("stop",)
  worker -> parent:
    ("ready", {"pid": ..., "torch_loaded": bool, "jax_loaded": bool})
    ("hb", monotonic-ts)          every hb_interval, from a side thread
    ("ok", task_id, result, encode_seconds)
    ("err", task_id, "ExcType: message")

The heartbeat thread runs through GIL switches during an encode, so a
busy worker still heartbeats; only a truly wedged process (C-level
loop, page-thrash, SIGSTOP) goes silent — exactly the condition the
supervisor's deadline/heartbeat reaper is for. Real stdout is dup'd
for the pickle stream and ``sys.stdout`` repointed at /dev/null, so a
stray ``print`` in library code can never corrupt the framing. A send
failure (parent died without cleanup) exits the worker immediately —
workers never outlive their supervisor.

Chaos: the ``encode.worker`` fault site fires here, around the encode,
with the chunk's resources as the match payload — ``raise`` reports a
per-chunk error, ``delay`` simulates a hang (the supervisor's deadline
kills it), ``crash`` is ``os._exit`` mid-chunk (the OOM-kill stand-in
the poison-bisect ladder is tested against).
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import threading
import time


def main() -> None:
    out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    # repoint FD 1 itself at /dev/null (not just sys.stdout): C-level
    # writes — a BLAS banner, a libc warning — would otherwise
    # interleave with the pickle frames and get this worker killed as
    # corrupt
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 1)
    os.close(devnull)
    sys.stdout = open(os.devnull, "w")
    inp = sys.stdin.buffer
    wlock = threading.Lock()

    def send(msg) -> None:
        try:
            with wlock:
                pickle.dump(msg, out, protocol=pickle.HIGHEST_PROTOCOL)
                out.flush()
        except Exception:
            os._exit(0)  # parent gone: do not linger as an orphan

    # host-side encode modules only — the ready message tells the
    # supervisor whether that contract held
    from ..resilience.faults import SITE_ENCODE_WORKER, global_faults
    from . import tasks

    send(("ready", {"pid": os.getpid(),
                    "torch_loaded": "torch" in sys.modules,
                    "jax_loaded": "jax" in sys.modules}))

    hb_interval = [0.25]
    stop = threading.Event()

    def heartbeat() -> None:
        while not stop.wait(hb_interval[0]):
            send(("hb", time.monotonic()))

    threading.Thread(target=heartbeat, daemon=True,
                     name="encode-hb").start()

    profiles = {}
    while True:
        try:
            msg = pickle.load(inp)
        except Exception:
            return  # EOF / closed pipe: supervisor is gone or stopping
        op = msg[0]
        if op == "stop":
            return
        if op == "init":
            opts = msg[1]
            hb_interval[0] = float(opts.get("hb_interval") or 0.25)
            spec = opts.get("faults") or ""
            try:
                global_faults.disarm()
                global_faults.arm_from_string(spec)
            except Exception:
                pass  # a bad spec must not kill the worker silently
            continue
        if op == "profile":
            _, pid, spec = msg
            profiles[pid] = tasks.Profile(spec)
            continue
        if op == "unprofile":
            profiles.pop(msg[1], None)
            continue
        if op == "task":
            _, task_id, pid, kind, payload = msg
            t0 = time.perf_counter()
            try:
                profile = profiles[pid]
                global_faults.fire(
                    SITE_ENCODE_WORKER,
                    payload=lambda: json.dumps(
                        payload.get("resources", []), default=str))
                result = tasks.run(kind, profile, payload)
                send(("ok", task_id, result, time.perf_counter() - t0))
            except BaseException as e:  # noqa: BLE001 — report, keep serving
                send(("err", task_id, f"{type(e).__name__}: {e}"))
            continue
        # unknown op: protocol skew — fail loudly via stderr-less exit
        return


if __name__ == "__main__":
    main()
