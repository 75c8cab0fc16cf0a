from accel_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_,
    batch_rows,
    mesh_from_cfg,
    replicated,
    shard_batch,
)
