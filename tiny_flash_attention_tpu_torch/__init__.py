"""tiny-flash-attention-tpu, ported to PyTorch and CUDA on an NVIDIA H100.

The JAX package `tiny_flash_attention_tpu` stays the reference; this package
does its work in PyTorch, and each Pallas TPU kernel it has ported is a CUDA
C++ kernel written for Hopper (sm_90a) under `csrc/`, built at first use by
`_build.py`. Every kernel wrapper keeps a plain PyTorch version beside it: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.

Layer map (counterparts in the JAX package):
  ops.reference    -- the oracle ladder: naive, safe, online, the FA1 and
                      FA2 references, mha_reference (ops/reference.py)
  ops.flash        -- flash_attention forward (window, segment ids,
                      segment_starts) -> csrc/flash_fwd.cu
  ops.flash_v1     -- the FA1 loop-order forward -> csrc/flash_v1.cu
  ops.flash_rowloop -- row-loop forward with jagged lengths -> the jagged
                      mode of csrc/flash_fwd.cu
  ops.flash_bwd    -- flash_attention backward -> csrc/flash_bwd.cu
  ops.paged        -- decode over separate K/V page arrays (bf16, int8) ->
                      csrc/paged_decode_separate.cu
  ops.paged_fused  -- fused pages (bf16, int8): decode attention and its
                      ring mode -> csrc/paged_decode.cu, token append ->
                      csrc/page_append.cu
  ops.flash_quant  -- flash_attention_quantized: the forward over int8/fp8
                      K/V with per-token scales -> csrc/flash_fwd_quant.cu
                      (B1's kernels with quantized operands)
  ops.quant        -- int8/fp8 quantizers, QuantizedTensor, quantized_matmul
  ops.quant_matmul -- weight-only quantized matmul -> csrc/quant_matmul.cu
  ops.configs      -- the kernels' tile sizes; FlashConfig, the run-time
                      choices every flash entry takes as `config=`
                      (default_config: today's)
  models           -- GQA decoder (optionally sliding-window) and its loss,
                      paged KV cache, inference paths (batched, packed,
                      jagged prefill), engine (with the windowed ring
                      cache), the bidirectional encoder
  parallel         -- the single-card train step and its checkpoints;
                      the mesh and head-sharded flash (sharded.py),
                      ring, zigzag ring, Ulysses and all-gather attention
                      (ring.py) on torch.distributed, their collectives
                      (comm.py) and a launcher of ranks (world.py)
  utils            -- tolerances, device choice, CUDA-event timing and
                      run_benchmark, profiling and the roofline, the
                      autotuner of FlashConfig on the card (autotune.py,
                      a JSON cache of winners)
  cpu              -- the native C++/OpenMP CPU oracle (cpp/attn.cpp, built
                      at first use into build/cpu/, bound with ctypes) on
                      CPU tensors
"""

__version__ = "0.1.0"

from tiny_flash_attention_tpu_torch.ops.reference import (  # noqa: E402
    attention_naive,
    attention_safe,
    attention_online,
    flash_attention_v1_ref,
    flash_attention_v2_ref,
    mha_reference,
)
from tiny_flash_attention_tpu_torch.ops.configs import (  # noqa: E402
    FlashConfig)
from tiny_flash_attention_tpu_torch.ops.flash import (  # noqa: E402
    flash_attention)
from tiny_flash_attention_tpu_torch.ops.flash_v1 import (  # noqa: E402
    flash_attention_v1)
from tiny_flash_attention_tpu_torch.ops.flash_quant import (  # noqa: E402
    flash_attention_quantized)
