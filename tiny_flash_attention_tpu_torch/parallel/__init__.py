"""Parallel layer of the port: the train step on one card and on a (data,
model) mesh with its checkpoints, and the tensor-parallel inference
forward (train.py), tensor- and data-parallel serving (serve.py), the mesh
and head-parallel attention (sharded.py), context-parallel attention
(ring.py), their collectives (comm.py), the launcher of a world of ranks
on one host (world.py) and the multi-host init and hybrid mesh
(multihost.py)."""

from tiny_flash_attention_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    make_hybrid_mesh,
)
from tiny_flash_attention_tpu_torch.parallel.sharded import (  # noqa: F401
    make_mesh,
    sharded_flash_attention,
)
from tiny_flash_attention_tpu_torch.parallel.train import (  # noqa: F401
    make_sharded_model_cfg,
    make_train_step,
    sharded_attention,
)
