# Copied from kyverno_tpu/encode/__init__.py.
"""Supervised multiprocess encode pool — the scalable device feed.

``EncoderPool`` (pool.py) supervises N freshly spawned worker
processes (worker.py, pure NumPy/stdlib — no torch, no JAX) that flatten
resource chunks into lane rows (tasks.py), with the full robustness
ladder: crash/hang detection, capped-backoff restarts, retry-once,
poison-resource bisection into the encode-failure quarantine, and an
``encode_pool`` circuit breaker that bypasses to in-process encode.

Wired under tpu/pipeline.py (scan feed), TorchEngine._encode_rows (the
admission/serving feed, results warming the shared EncodeRowCache),
and $KYVERNO_TPU_ENCODE_WORKERS (0 keeps the single-process path
byte-for-byte). The package imports no torch: a worker spawned from
it stays a host process.
"""

from .pool import (ENV_WORKERS, EncoderPool, PoolBypassed, PoolConfig,
                   PoolInfraError, WorkerEncodeError, configure_pool,
                   get_pool, pool_state, shutdown_pool)
from .tasks import KIND_ROWS, KIND_VOCAB, profile_spec

__all__ = [
    "ENV_WORKERS", "EncoderPool", "PoolBypassed", "PoolConfig",
    "PoolInfraError", "WorkerEncodeError", "configure_pool", "get_pool",
    "pool_state", "shutdown_pool", "KIND_ROWS", "KIND_VOCAB",
    "profile_spec",
]
