"""Data-parallel training over processes (``torch.distributed``).

The counterpart of the JAX package's ``parallel/``: there, one SPMD
program over a ``(data, model)`` device mesh with the batch sharded over
``data`` and XLA inserting the gradient psum; here, one process a rank,
each running the model (and the K2/K3 kernels) on its rows of the global
batch, the batch-norm moments and the loss denominators summed over the
ranks, and the gradients summed after the backward, so that a step equals
the single-device step on the global batch.
"""

from multilingual_text_to_speech_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_gradients,
    all_sum,
    replicate,
    total,
)
from multilingual_text_to_speech_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
    shard_seeds,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_seeds", "replicate",
           "init_distributed", "all_sum", "total", "all_reduce_gradients",
           "all_gather_rows"]
