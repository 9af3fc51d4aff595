"""Sharded serving: tensor- and data-parallel continuous batching on a
(data, model) mesh of torch.distributed ranks.

Port of tiny_flash_attention_tpu/parallel/serve.py. JAX runs the decode loop
under `shard_map` from one process; here every rank of a world
(parallel/world.py) runs the loop on its own shard:

  * MODEL axis (tensor parallel): a rank holds its contiguous block of q
    heads and the kv heads they read (GQA co-location,
    parallel/train.py::param_specs), so attention is local: the decode (B4)
    and the append (B5) run unchanged on its kv heads' pages. The two
    collectives of a layer are all-reduces over the model axis, after the
    attention output projection and after the MLP's down projection
    (parallel/train.py::row_parallel_add, JAX's psums and rounding points).
  * DATA axis: slots and page ids split into contiguous groups
    (PagedKVCache `n_groups`); a rank holds its group's page block alone
    and runs its group's rows of the batch. Page ids in the table stay
    global and are localized on the rank. The sampled tokens are gathered
    over the data axis, so every rank returns the whole stream.
  * Sampling: every rank draws the single-card loop's full (slots, vocab)
    table of uniforms from the same generator state and takes its global
    rows (models/inference.py::sample_tokens_rowwise), so every rank's
    stream is the single-card engine's.

The host state (allocator, page table, lengths, requests, generator) is
global and the same on every rank; only the params and the page tensors
are local.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.models.engine import InferenceEngine
from tiny_flash_attention_tpu_torch.models.inference import (
    _decode_core, _prefill, prefill_forward_jagged, prefill_forward_packed,
    sample_tokens_rowwise)
from tiny_flash_attention_tpu_torch.models.kv_cache import (
    PagedKVCache, local_page_ids)
from tiny_flash_attention_tpu_torch.parallel import comm
from tiny_flash_attention_tpu_torch.parallel.train import (
    _local_cfg, _mesh_device, _Place, row_parallel_add, shard_params)


def _local_inputs(place: _Place, pages, tokens, positions, page_table,
                  local: bool):
    """This data group's rows of the global batch, its table's global page
    ids localized into the group's page block (`local`: there is a data
    axis; the cache's writes map them the same way)."""
    b = tokens.shape[0] // place.dp
    rows = slice(place.group * b, (place.group + 1) * b)
    table = page_table[rows]
    if local:
        table = local_page_ids(table, place.group, pages[0].shape[1])
    return tokens[rows], positions[rows], table, rows


def _step(cfg_local, place, params, pages, tokens, positions, table, *,
          page_size, fmt):
    logits, _ = _decode_core(
        cfg_local, params, pages, tokens, positions, table,
        page_size=page_size, fmt=fmt,
        add=functools.partial(row_parallel_add, group=place.model_group))
    return logits


def sharded_decode_step(cfg: T.ModelConfig, mesh: DeviceMesh, params: dict,
                        pages: list, tokens: torch.Tensor,
                        positions: torch.Tensor, page_table: torch.Tensor, *,
                        page_size: int, fmt: str = "bf16",
                        model_axis: str = "model",
                        data_axis: Optional[str] = None) -> torch.Tensor:
    """One step of the sharded decode loop: the logits (B / dp, V) f32 of
    this rank's data group's rows, the same on every rank of its model
    group; each layer's new row appended into `pages` in place. Arguments
    as make_sharded_decode_loop's decode."""
    place = _Place.of(mesh, model_axis, data_axis)
    tokens, positions, table, _ = _local_inputs(
        place, pages, tokens, positions, page_table, data_axis is not None)
    return _step(_local_cfg(cfg, place.tp), place, params, pages, tokens,
                 positions, table, page_size=page_size, fmt=fmt)


def make_sharded_decode_loop(cfg: T.ModelConfig, mesh: DeviceMesh, *,
                             page_size: int, fmt: str = "bf16", n_steps: int,
                             greedy: bool = True, model_axis: str = "model",
                             data_axis: Optional[str] = None, device=None):
    """Returns decode(params, pages, tokens, positions, page_table, temps,
    generator) -> (pages, sampled (n_steps, B) int32), run on every rank.

    params: this rank's shard_params. pages: per layer, this rank's
    (hkv / tp, num_pages / dp, rows, d), fresh contiguous tensors, updated
    in place. tokens/positions/temps (B,) and page_table (B, width) are
    global, the same on every rank, with global page ids; the rank runs
    its data group's B / dp rows. The generator's state is the same on
    every rank. Runs on `device` (default the card), which must be of the
    mesh's device type.
    """
    _mesh_device(mesh, device)
    place = _Place.of(mesh, model_axis, data_axis)
    cfg_local = _local_cfg(cfg, place.tp)

    def decode(params, pages, tokens, positions, page_table, temps,
               generator):
        n_slots = tokens.shape[0]
        tokens, positions, table, rows = _local_inputs(
            place, pages, tokens, positions, page_table,
            data_axis is not None)
        temps = temps[rows]
        row_ids = torch.arange(rows.start, rows.stop, device=tokens.device)
        sampled = []
        for _ in range(n_steps):
            logits = _step(cfg_local, place, params, pages, tokens,
                           positions, table, page_size=page_size, fmt=fmt)
            if greedy:
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                tokens = sample_tokens_rowwise(logits, generator, temps,
                                               row_ids, n_slots=n_slots)
            positions = positions + 1
            sampled.append(tokens)
        sampled = torch.stack(sampled)
        if place.data_group is not None:
            # the host loop needs the whole stream on every rank
            sampled = comm.all_gather(sampled, place.data_group, 1)
        return pages, sampled

    return decode


class ShardedInferenceEngine(InferenceEngine):
    """The continuous-batching engine on a (data, model) mesh: tensor
    parallel over `model_axis`, data parallel over `data_axis` (a page
    pool of its own for each data group, one host loop on every rank).

    params: the FULL params, the same on every rank; the engine keeps this
    rank's shard_params. Admission, the allocator, bucketing and EOS are
    InferenceEngine's, run alike on every rank. Prefill is tensor
    parallel (spmd_forward's rounding points, B1 on the local heads) in
    every admission mode: batched, packed (B1 with segment ids and the
    pack's `segment_tiles`) and jagged (B11's runtime lengths). Every rank
    prefills every admitted prompt, so the first tokens agree with no
    gather, and writes its kv heads into the pages of its own data group
    only. Decode chunks run make_sharded_decode_loop. With dp > 1 the
    cache gets n_groups = dp and each group's first page is its scratch
    page, never allocated. Quantized weights raise ValueError, as JAX's
    param_specs does.
    """

    def __init__(self, cfg: T.ModelConfig, params: dict, mesh: DeviceMesh, *,
                 model_axis: str = "model", data_axis: Optional[str] = None,
                 device=None, **kw):
        device = _mesh_device(mesh, device)
        self.mesh, self.model_axis, self.data_axis = mesh, model_axis, \
            data_axis
        self.place = _Place.of(mesh, model_axis, data_axis)
        self.cfg_local = _local_cfg(cfg, self.place.tp)
        self._loops = {}
        super().__init__(cfg, shard_params(params, mesh, cfg,
                                           model_axis=model_axis),
                         device=device, **kw)
        if self.place.dp > 1:
            self.cache.free_pages = [p for p in self.cache.free_pages
                                     if p % self.cache.pages_per_group]

    def _make_cache(self, **geometry) -> PagedKVCache:
        dp = self.place.dp
        return PagedKVCache.create(
            n_layers=self.cfg.n_layers,
            n_kv_heads=self.cfg_local.n_kv_heads, d_head=self.cfg.d_head,
            dtype=self.cfg.dtype, device=self.device, n_groups=dp,
            held_group=self.place.group if dp > 1 else None, **geometry)

    def _row_add(self):
        return functools.partial(row_parallel_add,
                                 group=self.place.model_group)

    def _prefill(self, toks: torch.Tensor):
        positions = torch.arange(toks.shape[1], dtype=torch.int32,
                                 device=toks.device)
        cfg = self.cfg_local
        return _prefill(cfg, self.params, toks, positions,
                        lambda q, k, v: T._attention(cfg, q, k, v,
                                                     causal=True),
                        self._row_add())

    def _prefill_packed(self, toks, segs, positions, offsets):
        return prefill_forward_packed(self.cfg_local, self.params, toks,
                                      segs, positions,
                                      segment_starts=offsets,
                                      add=self._row_add())

    def _prefill_jagged(self, toks, lengths):
        return prefill_forward_jagged(self.cfg_local, self.params, toks,
                                      lengths, add=self._row_add())

    def _loop(self, n: int, width: int, greedy: bool):
        key = (n, width, greedy)
        if key not in self._loops:
            self._loops[key] = make_sharded_decode_loop(
                self.cfg, self.mesh, page_size=self.page_size,
                fmt=self.kv_format, n_steps=n, greedy=greedy,
                model_axis=self.model_axis, data_axis=self.data_axis,
                device=self.device)
        return self._loops[key]

    def _run(self, positions, page_table, n: int, greedy: bool):
        self.cache.pages, sampled = self._loop(
            n, page_table.shape[1], greedy)(
            self.params, self.cache.pages, self._tensor(self.last_token),
            positions, page_table, self._tensor(self.temps), self.generator)
        return sampled

    def _decode_chunk(self, positions, page_table, n) -> torch.Tensor:
        return self._run(positions, page_table, n,
                         bool(np.all(self.temps == 0.0)))

    def _decode_one(self, positions, page_table) -> torch.Tensor:
        # the single-card step draws its uniforms whatever the temperatures
        return self._run(positions, page_table, 1, False)[0]
