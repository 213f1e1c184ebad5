"""Device-mesh parallelism (counterpart of ``obs_rvc_tpu.parallel``):

- **data** parallelism: concurrent streams split along a ``data`` axis, each
  row of the mesh stepping its own group of them;
- **tensor** parallelism: ContentVec's attention heads and FFN hidden width
  split along a ``model`` axis, megatron style;
- the exact retrieval table split by rows along ``model``
  (``retrieval.index.sharded_knn_blend``).

:mod:`mesh` builds the grid of devices, :mod:`sharding` places weights,
state and controls on it, :mod:`distributed` spans processes with
``torch.distributed``, and :mod:`dryrun` drives both mesh shapes at
production widths.
"""

from obs_rvc_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec
from obs_rvc_tpu_torch.parallel.sharding import param_partition_spec, shard_controls, shard_params, shard_state

__all__ = [
    "make_mesh",
    "parse_mesh_spec",
    "shard_params",
    "shard_state",
    "shard_controls",
    "param_partition_spec",
]
