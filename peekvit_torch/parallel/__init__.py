"""Multi-process parallelism over ``torch.distributed`` (counterpart of
peekvit_tpu/parallel): the (data, model) or (data, stage) mesh, data
parallelism in ``data``, tensor-parallel serving in ``tp_serving``,
sequence-parallel training in ``sequence``, the GPipe pipeline in
``pipeline`` and the gated ResidualViT's parallel forwards in
``residual``."""

from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, make_mesh
from peekvit_torch.parallel.pipeline import pipeline_forward, stack_stage_params
from peekvit_torch.parallel.sequence import (
    sequence_parallel_vit_block,
    sequence_parallel_vit_forward,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "STAGE_AXIS", "Mesh", "make_mesh", "pipeline_forward",
           "sequence_parallel_vit_block", "sequence_parallel_vit_forward", "stack_stage_params"]
