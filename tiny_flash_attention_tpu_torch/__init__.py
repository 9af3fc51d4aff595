"""tiny-flash-attention-tpu, ported to PyTorch and CUDA on an NVIDIA H100.

The JAX package `tiny_flash_attention_tpu` stays the reference; this package
does its work in PyTorch, and each Pallas TPU kernel it has ported is a CUDA
C++ kernel written for Hopper (sm_90a) under `csrc/`, built at first use by
`_build.py`. Every kernel wrapper keeps a plain PyTorch version beside it: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.

Layer map (counterparts in the JAX package):
  ops.reference    -- mha_reference oracle (ops/reference.py)
  ops.flash        -- flash_attention forward (segment ids, segment_starts)
                      -> csrc/flash_fwd.cu
  ops.flash_rowloop -- row-loop forward with jagged lengths -> the jagged
                      mode of csrc/flash_fwd.cu
  ops.flash_bwd    -- flash_attention backward -> csrc/flash_bwd.cu
  ops.paged_fused  -- fused pages (bf16, int8): decode attention ->
                      csrc/paged_decode.cu, token append -> csrc/page_append.cu
  ops.quant        -- int8/fp8 quantizers, QuantizedTensor, quantized_matmul
  ops.quant_matmul -- weight-only quantized matmul -> csrc/quant_matmul.cu
  ops.configs      -- the kernels' tile sizes
  models           -- GQA decoder and its loss, paged KV cache, inference
                      paths (batched, packed, jagged prefill), engine, the
                      bidirectional encoder
  parallel         -- the single-card train step and its checkpoints
  utils            -- tolerances, device choice, CUDA-event timing
"""

__version__ = "0.1.0"
