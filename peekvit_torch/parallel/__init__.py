"""Multi-process parallelism over ``torch.distributed`` (counterpart of
peekvit_tpu/parallel): the (data, model) mesh, data parallelism in
``data``, tensor-parallel serving in ``tp_serving`` and sequence-parallel
training in ``sequence``."""

from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from peekvit_torch.parallel.sequence import (
    sequence_parallel_vit_block,
    sequence_parallel_vit_forward,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "sequence_parallel_vit_block",
           "sequence_parallel_vit_forward"]
