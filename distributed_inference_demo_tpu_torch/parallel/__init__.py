"""Parallelism on ``torch.distributed``: meshes of rank processes
(``mesh.py``, rank 0 drives), the sharding rules (``sharding.py``),
tensor parallelism (``tensor.py``), expert parallelism (``expert.py``),
sequence parallelism (``sequence.py`` ring attention, ``ulysses.py``)
and pipeline parallelism (``pipeline.py``: the circular pipeline's
decode, its loss and the dp x pp x tp train step)."""

from .mesh import MeshConfig, local_mesh, local_sp_mesh, local_tp_mesh
from .pipeline import (make_pipeline_generate_fn, make_pipeline_train_step,
                       pipeline_apply)
from .sharding import shard_params

__all__ = ["MeshConfig", "local_mesh", "local_sp_mesh", "local_tp_mesh",
           "make_pipeline_generate_fn", "make_pipeline_train_step",
           "pipeline_apply", "shard_params"]
