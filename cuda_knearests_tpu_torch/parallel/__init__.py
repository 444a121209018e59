"""The multi-GPU sharded path: z-slabs over a list of devices
(:mod:`.sharded`) and the multi-process group it can span
(:mod:`.distributed`)."""

from . import distributed, sharded
from .distributed import init_distributed, z_mesh
from .sharded import ShardedKnnProblem, Slab, load_sharded, save_sharded

__all__ = ["sharded", "distributed", "ShardedKnnProblem", "Slab",
           "save_sharded", "load_sharded", "init_distributed", "z_mesh"]
