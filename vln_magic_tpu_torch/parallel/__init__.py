"""dp x mp meshes on ``torch.distributed`` (port of
``vln_magic_tpu/parallel``)."""

from .mesh import Mesh, init_distributed, make_mesh
from .sharding import (batch_spec, full_state_dict, param_spec, replicate,
                       shard_batch, shard_params, shard_pytree_batch)
