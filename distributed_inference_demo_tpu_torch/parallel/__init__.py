"""Parallelism on ``torch.distributed``: meshes of rank processes
(``mesh.py``, rank 0 drives), the sharding rules (``sharding.py``),
tensor parallelism (``tensor.py``), expert parallelism (``expert.py``)
and sequence parallelism (``sequence.py`` ring attention, ``ulysses.py``).
The pipeline (``pipeline.py``) is a later slice (ROADMAP A10)."""

from .mesh import MeshConfig, local_mesh, local_sp_mesh, local_tp_mesh
from .sharding import shard_params

__all__ = ["MeshConfig", "local_mesh", "local_sp_mesh", "local_tp_mesh",
           "shard_params"]
