"""The compiled program as one CUDA graph per shape bucket — the port's
counterpart of ``jax.jit``'s per-shape executable cache
(kyverno_tpu/tpu/evaluator.py:build_program.run, compiled once per input
shape by XLA).

Eagerly, one run of a policy set's program issues tens of thousands of
small PyTorch operations and kernel launches (``evaluator.py``), and the
host's time to issue them, not the card's, sets the run's time.
``GraphedProgram(run)`` records the run once per shape bucket — the lane
dict's (name, shape, dtype) tuple — and replays the recording:

1. The first call with a key runs the program eagerly and remembers the
   key, so a bucket that comes once costs one eager run and nothing
   more. That run also builds or loads everything the program keeps:
   the kernel libraries and their shared-memory opt-ins, K1's tiles,
   K6's constant tables, K9's packs and K10's entry tables.
2. The second call with the key captures a run over static input
   buffers into a ``torch.cuda.CUDAGraph`` (nothing runs on the card
   while it records), then answers as every later call does.
3. Every later call with the key copies its lanes into the static
   inputs, replays the graph and returns clones of its outputs, all on
   the current stream, so up to ``scan_stream``'s three tiles in flight
   each keep their own outputs.

A capture that fails (a host sync inside the program, a kernel that
does not launch) raises ``kernels.KernelError``: the guarded dispatch
ladder passes it to the caller rather than answering all-HOST.

Several threads drive one engine when it serves admission (the
flusher, hedged and shed scans on the submitting threads, the
lifecycle worker warming the next policy-set version), so a capture
must not be broken by another thread's device work. In CUDA's default
("global") capture mode, a call that might synchronize — a pinned-buffer
allocation's event query, a readback — made by ANY thread while one
thread records invalidates that recording (``profile_capture.py``
reproduces it). Captures here use the "thread_local" mode: only the
capturing thread's own calls can break its recording, and the other
threads' copies, eager runs, replays and readbacks go on meanwhile. One
capture runs at a time (``_CAPTURE_LOCK``): entering a capture
synchronizes the device and empties the allocators' caches, which
must not happen under another thread's recording.

A replay runs no Python, so the counters the program keeps —
``kernels.LAUNCHES`` and the program's ``stats`` — would miss it. The
capture run counts its launches into a dict of its own thread's
(``kernels.counting_into``) and takes back its ``stats`` increments
(the program's lock keeps other calls of the program out meanwhile);
both are added again at every replay: each call counts what the card
runs for it, the same as an eager run.

Each graph holds a private memory pool as large as one eager run's peak,
so a program keeps at most ``MAX_GRAPHS`` of them, evicting the one used
least recently. ``TorchEngine`` pads batches to powers of two and
``ShardedScanner``'s vocabulary and row buckets only grow, so a workload
uses few keys.

The eager program stays reachable as ``.run``. ``graphed(run, device,
plain)`` is the one place that decides what is graphed: only a CUDA
device's program, and never the plain-twin program.
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import kernels

# live graphs per program: each holds a private memory pool
MAX_GRAPHS = 4
# CUDA stream-capture mode of every capture (see the module docstring)
CAPTURE_MODE = "thread_local"
# one capture at a time, process-wide
_CAPTURE_LOCK = threading.Lock()


def _clone(out):
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


class _Graph:
    """One captured run: its graph, static inputs and outputs, and the
    counter increments one replay stands for."""

    def __init__(self, graph, inputs: Dict[str, torch.Tensor], outputs,
                 launches: Dict[str, int], stats: Dict[str, int]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.stats = stats

    def load(self, lanes: Dict[str, torch.Tensor]) -> None:
        for k, t in self.inputs.items():
            t.copy_(lanes[k])


class GraphedProgram:
    """A compiled program (``evaluator.build_program``'s ``run``)
    replayed as one CUDA graph per lane-shape bucket (see the module
    docstring). ``captures`` counts graphs recorded, ``replays`` calls
    answered by a replay; ``key_counts`` splits the calls by key into
    eager runs, captures and replays."""

    def __init__(self, run: Callable):
        self.run = run
        self.stats: Optional[Dict[str, int]] = getattr(run, "stats", None)
        self.captures = 0
        self.replays = 0
        self.key_counts: Dict[Tuple, Dict[str, int]] = {}
        self._seen: set = set()
        self._graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()
        # a graph's static inputs and outputs serve one call at a time
        self._lock = threading.Lock()

    @staticmethod
    def key(lanes: Dict[str, torch.Tensor]) -> Tuple:
        return tuple((k, tuple(t.shape), t.dtype) for k, t in lanes.items())

    @property
    def live_graphs(self) -> int:
        return len(self._graphs)

    def __call__(self, lanes: Dict[str, torch.Tensor]):
        devs = {t.device for t in lanes.values()}
        if len(devs) != 1 or next(iter(devs)).type != "cuda":
            raise ValueError(f"GraphedProgram: lanes on {sorted(map(str, devs))}"
                             f"; only CUDA lanes are graphed (call .run)")
        dev = next(iter(devs))
        if dev.index != torch.cuda.current_device():
            # a capture and a replay run on the current device's stream
            raise kernels.KernelError(
                f"GraphedProgram: lanes on {dev}, the current device is "
                f"cuda:{torch.cuda.current_device()}")
        key = self.key(lanes)
        with self._lock:
            n = self.key_counts.setdefault(
                key, {"eager": 0, "captures": 0, "replays": 0})
            g = self._graphs.get(key)
            if g is None:
                if key not in self._seen:
                    self._seen.add(key)
                    n["eager"] += 1
                    return self.run(lanes)
                g = self._capture(key, dev, lanes)
                n["captures"] += 1
            self._graphs.move_to_end(key)
            g.load(lanes)
            g.graph.replay()
            self.replays += 1
            n["replays"] += 1
            for k, v in g.launches.items():
                kernels.count_launch(k, v)
            if self.stats is not None:
                for k, v in g.stats.items():
                    self.stats[k] += v
            return _clone(g.outputs)

    def _capture(self, key: Tuple, dev: torch.device,
                 lanes: Dict[str, torch.Tensor]) -> _Graph:
        """Record the key's graph over static inputs (the key's first
        eager run has built what the program keeps)."""
        while len(self._graphs) >= MAX_GRAPHS:
            _, old = self._graphs.popitem(last=False)
            old.graph.reset()
        inputs = {k: torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
                  for k, t in lanes.items()}
        launches: Dict[str, int] = {}
        stats0 = dict(self.stats) if self.stats is not None else {}
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection while the graph records, a precaution:
        # the program's tapes make thousands of objects, and an object
        # freed mid-capture (a pinned host buffer) might call CUDA and
        # invalidate the capture (``torch.cuda.graph`` collects once, at
        # its start); a cause not reproduced (PERF.md). The collector is
        # the process's: other threads run without it meanwhile
        with _CAPTURE_LOCK:
            gc_was = gc.isenabled()
            gc.disable()
            try:
                with kernels.counting_into(launches), \
                        torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
                    outputs = self.run(inputs)
            except Exception as e:
                raise kernels.KernelError(
                    f"CUDA graph capture failed: {type(e).__name__}: {e}") from e
            finally:
                if gc_was:
                    gc.enable()
                # the capture ran nothing on the card: its launches
                # (counted apart) and its stats are added at each
                # replay instead
                stats: Dict[str, Any] = {}
                if self.stats is not None:
                    stats = {k: v - stats0[k] for k, v in self.stats.items()
                             if v != stats0[k]}
                    self.stats.update(stats0)
        g = _Graph(graph, inputs, outputs, launches, stats)
        self._graphs[key] = g
        self.captures += 1
        return g


def graphed(run: Callable, device, plain: bool = False) -> Callable:
    """``run`` itself, or for a CUDA ``device`` (and not the ``plain``
    program) its ``GraphedProgram``: one per (run, device), kept on
    ``run``."""
    if plain or device is None or torch.device(device).type != "cuda":
        return run
    by_device = run.__dict__.setdefault("graphed", {})
    dev = str(torch.device(device))
    if dev not in by_device:
        by_device[dev] = GraphedProgram(run)
    return by_device[dev]
