"""Device-mesh parallelism for the scan engine (one process's devices, or
a (hosts, per_host) mesh across the processes of torch.distributed)."""

from .sharding import Mesh, ShardedScanner, make_mesh, make_mesh_2d

__all__ = ["Mesh", "ShardedScanner", "make_mesh", "make_mesh_2d"]
