from visiontransformer_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    param_placements,
    replicated,
)

__all__ = ["batch_sharding", "create_mesh", "param_placements", "replicated"]
