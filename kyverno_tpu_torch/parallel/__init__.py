"""Device-mesh parallelism for the scan engine (one process's devices)."""

from .sharding import Mesh, ShardedScanner, make_mesh, make_mesh_2d

__all__ = ["Mesh", "ShardedScanner", "make_mesh", "make_mesh_2d"]
