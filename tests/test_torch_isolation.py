"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the card unless the caller asks for the CPU, and the
plain versions taken on the CPU never count as kernel launches."""

import ast
import dataclasses
import pathlib
import types

import pytest
import torch

from tiny_flash_attention_tpu_torch import _build, cpu
from tiny_flash_attention_tpu_torch.models import encoder as TE
from tiny_flash_attention_tpu_torch.models import transformer as TT
from tiny_flash_attention_tpu_torch.models.engine import (
    InferenceEngine, Request)
from tiny_flash_attention_tpu_torch.models.kv_cache import PagedKVCache
from tiny_flash_attention_tpu_torch.ops.flash import flash_attention
from tiny_flash_attention_tpu_torch.ops.flash_bwd import flash_attention_bwd
from tiny_flash_attention_tpu_torch.ops.flash_quant import (
    flash_attention_quantized)
from tiny_flash_attention_tpu_torch.ops.flash_rowloop import (
    flash_attention_rowloop)
from tiny_flash_attention_tpu_torch.ops.flash_v1 import flash_attention_v1
from tiny_flash_attention_tpu_torch.ops.paged import paged_decode_attention
from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    fused_page_append, fused_paged_decode_attention)
from tiny_flash_attention_tpu_torch.ops.quant import quantize_kv
from tiny_flash_attention_tpu_torch.ops.quant_matmul import (
    quantized_matmul_cuda)
from tiny_flash_attention_tpu_torch.parallel.multihost import (
    initialize_multihost)
from tiny_flash_attention_tpu_torch.parallel.serve import (
    ShardedInferenceEngine, make_sharded_decode_loop)
from tiny_flash_attention_tpu_torch.parallel.train import make_train_step
from tiny_flash_attention_tpu_torch.utils.autotune import (
    autotune_flash_config)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tiny_flash_attention_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tiny_flash_attention_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_every_module_is_checked():
    """The import check covers every module of the port, the CPU oracle
    and the autotuner among them."""
    names = {str(p.relative_to(PORT)) for p in _port_files()[:-1]}
    assert {"cpu.py", "utils/autotune.py", "utils/benchmarking.py",
            "ops/configs.py"} <= names


def test_kernel_sources_are_found():
    assert _build.sources() == ["flash_bwd", "flash_fwd", "flash_fwd_quant",
                                "flash_v1", "page_append", "paged_decode",
                                "paged_decode_f32",
                                "paged_decode_f32_wide",
                                "paged_decode_separate",
                                "paged_decode_separate_f32_wide",
                                "paged_decode_separate_wide",
                                "paged_decode_separate_widths",
                                "paged_decode_wide",
                                "paged_decode_widths",
                                "paged_decode_widths_f32", "quant_matmul"]


SMALL = TT.ModelConfig(vocab_size=64, d_model=64, n_layers=1, n_q_heads=2,
                       n_kv_heads=1, d_head=64, d_ff=128,
                       dtype=torch.float32)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(SMALL, gen)
    for fmt in ("bf16", "int8"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedKVCache.create(n_layers=1, n_kv_heads=1, num_pages=4,
                                page_size=16, d_head=64, max_seqs=2,
                                pages_per_seq=2, fmt=fmt)
    params = TT.init_params(SMALL, gen, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(SMALL, params, num_pages=4, page_size=16,
                        max_seqs=2, pages_per_seq=2)
    InferenceEngine(SMALL, params, num_pages=4, page_size=16, max_seqs=2,
                    pages_per_seq=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(SMALL, TT.quantize_params(params), num_pages=4,
                        page_size=16, max_seqs=2, pages_per_seq=2,
                        kv_format="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(SMALL)
    make_train_step(SMALL, device="cpu")
    # the sharded entries resolve their device before they touch the mesh
    mesh = types.SimpleNamespace(device_type="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sharded_decode_loop(SMALL, mesh, page_size=16, n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedInferenceEngine(SMALL, params, mesh, num_pages=4,
                               page_size=16, max_seqs=2, pages_per_seq=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(SMALL, mesh)
    # a configured multi-host init takes the card (NCCL) unless asked
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost("127.0.0.1:1", 1, 0, timeout_s=1)


def test_quantized_flash_runs_where_its_tensors_lie():
    """flash_attention_quantized takes the plain version for CPU tensors
    only: a tensor on another device that is not CUDA raises."""
    q = torch.zeros((1, 2, 8, 64))
    k, v = quantize_kv(q, q, "int8")
    assert flash_attention_quantized(q, k, v, causal=True).shape == q.shape
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_quantized(q.to("meta"), k, v, causal=True)


def test_cpu_calls_launch_no_kernel():
    counters = [flash_attention, flash_attention_bwd,
                flash_attention_rowloop, fused_paged_decode_attention,
                fused_page_append, quantized_matmul_cuda, flash_attention_v1,
                paged_decode_attention, flash_attention_quantized]
    extra = [(fused_paged_decode_attention, "int8_launches"),
             (fused_paged_decode_attention, "ring_launches"),
             (fused_paged_decode_attention, "width_launches"),
             (paged_decode_attention, "width_launches"),
             (fused_page_append, "width_launches"),
             (flash_attention, "window_launches"),
             (flash_attention_quantized, "int8_launches"),
             (flash_attention_quantized, "fp8_launches")]
    for fn in counters:
        fn.launches = 0
    for fn, name in extra:
        setattr(fn, name, 0)
    params = TT.init_params(SMALL, torch.Generator().manual_seed(0),
                            device="cpu")
    for p, fmt in ((params, "bf16"), (TT.quantize_params(params), "int8")):
        eng = InferenceEngine(SMALL, p, num_pages=8, page_size=16,
                              max_seqs=2, pages_per_seq=4, kv_format=fmt,
                              device="cpu")
        out = eng.generate([list(range(5)), list(range(20))],
                           max_new_tokens=5, chunk=2)
        assert [len(o) for o in out] == [5, 5]
    for admit in ("add_requests_packed", "add_requests_jagged"):
        eng = InferenceEngine(SMALL, params, num_pages=8, page_size=16,
                              max_seqs=2, pages_per_seq=4, device="cpu")
        getattr(eng, admit)([Request(list(range(5)), 3),
                             Request(list(range(20)), 3)])
        eng.steps(2)
    # the windowed model: windowed prefill, ring decode past the capacity
    windowed = dataclasses.replace(SMALL, attn_window=16)
    eng = InferenceEngine(windowed, params, num_pages=8, page_size=16,
                          max_seqs=2, pages_per_seq=3, device="cpu")
    out = eng.generate([list(range(5)), list(range(30))], max_new_tokens=30,
                       chunk=8)
    assert [len(o) for o in out] == [30, 30]
    TE.embed_texts(SMALL, params, torch.zeros((2, 24), dtype=torch.int32),
                   torch.tensor([24, 9]))
    x = torch.zeros((1, 2, 8, 64))
    flash_attention_v1(x, x, x, causal=True)
    paged_decode_attention(x[:, :, 0], x, x, torch.ones(1, dtype=torch.int32),
                           torch.zeros((1, 1), dtype=torch.int32))
    for fmt in ("int8", "fp8"):
        kq, vq = quantize_kv(x, x, fmt)
        flash_attention_quantized(x, kq, vq, causal=True, window=4,
                                  return_lse=True)
    q = torch.zeros((1, 2, 8, 64), requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    step, init = make_train_step(SMALL, device="cpu")
    step(*init(params), torch.randint(0, 64, (2, 16)))
    # the autotuner and the native oracle on CPU tensors
    autotune_flash_config(x, x, x, rounds=1)
    cpu.flash_attn(x, x, x, causal=True)
    assert [fn.launches for fn in counters] == [0] * len(counters)
    assert [getattr(fn, name) for fn, name in extra] == [0] * len(extra)

