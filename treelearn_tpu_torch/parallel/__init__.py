"""Data parallelism on torch.distributed (port of treelearn_tpu/parallel)."""

from .mesh import (  # noqa: F401
    DPGroup,
    all_reduce_sum_,
    init_dp,
    make_dp_inference_step,
    make_dp_train_step,
    make_mesh,
    shard_batch_arrays,
)
