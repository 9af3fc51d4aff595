"""Parallel layer of the port: the single-card train step and the tensor-
parallel inference forward (train.py), tensor- and data-parallel serving
(serve.py), the mesh and head-parallel attention (sharded.py),
context-parallel attention (ring.py), their collectives (comm.py) and the
launcher of a world of ranks (world.py)."""

from tiny_flash_attention_tpu_torch.parallel.sharded import (  # noqa: F401
    make_mesh,
    sharded_flash_attention,
)
