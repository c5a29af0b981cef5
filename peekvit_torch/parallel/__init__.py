"""Multi-process parallelism over ``torch.distributed`` (counterpart of
peekvit_tpu/parallel): the (data, model) mesh, and tensor-parallel serving
in ``tp_serving``."""

from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh"]
