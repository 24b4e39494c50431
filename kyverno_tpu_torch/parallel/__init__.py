"""The tiled background scan over one CUDA device."""

from .sharding import ShardedScanner

__all__ = ["ShardedScanner"]
