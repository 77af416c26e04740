"""Data parallel over ``torch.distributed`` (``pctd_tpu/parallel``)."""
from pctd_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_batch,
    replicate,
    make_parallel_train_step,
    make_parallel_eval_step,
)
