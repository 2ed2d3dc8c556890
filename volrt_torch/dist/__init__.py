"""Sharded execution over ``torch.distributed`` (the counterpart of
``volrt/dist``): ray-row data parallelism (``render.py``) and Z-slab volume
sharding (``volume_sharded.py``) over a process group (``mesh.py``), one
rank a process. ``volrt``'s JAX sharding specs (``tiles_sharding``,
``rows_sharding``, ``replicated``) have no torch role."""
from volrt_torch.dist.mesh import Mesh, init_distributed, make_mesh  # noqa: F401
