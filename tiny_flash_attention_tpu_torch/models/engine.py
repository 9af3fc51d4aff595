"""Continuous-batching inference engine.

Port of tiny_flash_attention_tpu/models/engine.py (batched, packed and
jagged admission, per-token and chunked decode, slot and page lifecycle).
Requests are admitted into free cache slots with one prefill: a padded
batch (`add_requests`), one packed row with segment ids (`add_requests_
packed`) or a padded batch with runtime lengths (`add_requests_jagged`);
the last two cost ~sum(L_i^2)/2 of attention where the first costs
B * L_max^2 / 2. Every decode step advances ALL slots in one fixed-shape
pass (inactive slots decode at position 0 against the reserved scratch page
0 and are ignored), and finished sequences free their pages. The JAX
engine's key splits become draws from one `torch.Generator`. A
sliding-window model (`ModelConfig(attn_window=w)`) gets the ring cache:
each slot holds its full table width of pages, whose capacity
pages_per_seq * page_size must cover w + 2 pages, and generation runs past
that capacity while the decode attends the last w tokens (batched
admission only).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tiny_flash_attention_tpu_torch.models import transformer as T
from tiny_flash_attention_tpu_torch.models.inference import (
    decode_loop, decode_step, prefill_forward_batched, prefill_forward_jagged,
    prefill_forward_packed, sample_tokens)
from tiny_flash_attention_tpu_torch.models.kv_cache import PagedKVCache
from tiny_flash_attention_tpu_torch.utils.device import resolve_device


def pad_prompts(prompts: List[List[int]], page_size: int) -> np.ndarray:
    """(B, L_pad) int32: each prompt right-padded with 0 to the longest
    one's page multiple."""
    L_pad = -(-max(map(len, prompts)) // page_size) * page_size
    toks = np.zeros((len(prompts), L_pad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks


def pack_prompts(prompts: List[List[int]], page_size: int,
                 bucket: str = "page"):
    """Prompts packed into one row, each padded to its own page multiple
    ("page") or to the next power-of-two number of pages ("pow2", which
    bounds the distinct segment lengths). Returns (tokens (1, T), segment
    ids (1, T) from 1, positions (T,) restarting at each prompt, offsets)."""
    if bucket not in ("page", "pow2"):
        raise ValueError(f"pack_bucket {bucket!r}")
    lpads = []
    for p in prompts:
        lpad = -(-len(p) // page_size) * page_size
        if bucket == "pow2":
            lpad = page_size * (1 << max(0, (lpad // page_size - 1)
                                         .bit_length()))
        lpads.append(lpad)
    offs = np.concatenate([[0], np.cumsum(lpads)[:-1]]).astype(int)
    total = sum(lpads)
    toks = np.zeros((1, total), np.int32)
    segs = np.zeros((1, total), np.int32)
    positions = np.zeros((total,), np.int32)
    for i, (p, o, lpad) in enumerate(zip(prompts, offs, lpads)):
        toks[0, o:o + len(p)] = p
        segs[0, o:o + lpad] = i + 1
        positions[o:o + lpad] = np.arange(lpad)
    return toks, segs, positions, [int(o) for o in offs]


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_token: Optional[int] = None
    # filled by the engine
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class InferenceEngine:
    def __init__(self, cfg: T.ModelConfig, params: dict, *,
                 num_pages: int = 512, page_size: int = 128,
                 max_seqs: int = 8, pages_per_seq: int = 32,
                 kv_format: str = "bf16", seed: int = 0, device=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.cache = self._make_cache(
            num_pages=num_pages, page_size=page_size, max_seqs=max_seqs,
            pages_per_seq=pages_per_seq, fmt=kv_format)
        # page 0 is the scratch page inactive slots read/write; never allocate
        self.cache.free_pages = [p for p in self.cache.free_pages if p != 0]
        self.page_size = page_size
        self.kv_format = kv_format
        self.requests: Dict[int, Request] = {}
        self.last_token = np.zeros((max_seqs,), np.int32)
        self.temps = np.zeros((max_seqs,), np.float32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # --- what the sharded engine (parallel/serve.py) replaces ---------------

    def _make_cache(self, **geometry) -> PagedKVCache:
        return PagedKVCache.create(
            n_layers=self.cfg.n_layers, n_kv_heads=self.cfg.n_kv_heads,
            d_head=self.cfg.d_head, dtype=self.cfg.dtype, device=self.device,
            **geometry)

    def _prefill(self, toks: torch.Tensor):
        """(logits, k_layers, v_layers) of a padded prompt batch."""
        return prefill_forward_batched(self.cfg, self.params, toks)

    def _prefill_packed(self, toks: torch.Tensor, segs: torch.Tensor,
                        positions: torch.Tensor, offsets: tuple):
        """(logits, k_layers, v_layers) of prompts packed into one row."""
        return prefill_forward_packed(self.cfg, self.params, toks, segs,
                                      positions, segment_starts=offsets)

    def _prefill_jagged(self, toks: torch.Tensor, lengths: torch.Tensor):
        """(logits, k_layers, v_layers) of a padded batch with runtime
        lengths."""
        return prefill_forward_jagged(self.cfg, self.params, toks, lengths)

    def _decode_one(self, positions, page_table) -> torch.Tensor:
        """One decode step of every slot; returns the sampled (B,)."""
        logits, self.cache.pages = decode_step(
            self.cfg, self.params, self.cache.pages,
            self._tensor(self.last_token), positions, page_table,
            page_size=self.page_size, fmt=self.kv_format)
        return sample_tokens(logits, self.generator,
                             self._tensor(self.temps))

    # --- admission -------------------------------------------------------

    def add_request(self, req: Request) -> int:
        return self.add_requests([req])[0]

    def add_requests(self, reqs: List[Request]) -> List[int]:
        """Admits several requests with ONE batched prefill.

        Prompts pad to the longest request's page-multiple bucket; right
        padding is harmless under the causal mask and cache writes slice
        by true length. A windowed model's slots are rings of the full
        table width; a prompt must fit the ring.
        """
        if self.cfg.attn_window is not None:
            cap = self.cache.pages_per_seq * self.page_size
            if self.cfg.attn_window + 2 * self.page_size > cap:
                raise ValueError(
                    f"ring capacity {cap} (pages_per_seq * page_size) must "
                    f"cover the window {self.cfg.attn_window} + 2 pages")
            for req in reqs:
                if len(req.prompt) > cap:
                    raise ValueError(f"prompt ({len(req.prompt)} tokens) "
                                     f"exceeds the ring capacity {cap}")
        slots = self._alloc(reqs)
        toks = pad_prompts([r.prompt for r in reqs], self.page_size)
        rows, last, temps = self._sample_rows(
            np.arange(len(reqs)), [len(r.prompt) - 1 for r in reqs], reqs)
        logits, ks, vs = self._prefill(self._tensor(toks))
        first = sample_tokens(logits[rows, last], self.generator, temps)
        self._admitted(slots, reqs, first.cpu().numpy(),
                       [(ks[:, i], vs[:, i]) for i in range(len(reqs))])
        return slots

    def add_requests_packed(self, reqs: List[Request],
                            pack_bucket: str = "page") -> List[int]:
        """Admits several requests with ONE PACKED prefill.

        Prompts pad to their own page multiple (`pack_bucket="page"`) or to
        a power-of-two number of pages ("pow2") and concatenate into one
        row; the flash kernel gets segment ids plus the static pack offsets,
        which prune each q tile's kv range to its segment, so admission
        costs sum(L_i^2)/2 of attention. The cache writes are page-exact
        whatever the bucket: pow2's padding pages never reach a slot's page
        list.
        """
        self._no_window("packed")
        ps = self.page_size
        toks, segs, positions, offs = pack_prompts(
            [r.prompt for r in reqs], ps, pack_bucket)
        slots = self._alloc(reqs)
        rows, last, temps = self._sample_rows(
            np.zeros(len(reqs), np.int64),
            [o + len(r.prompt) - 1 for o, r in zip(offs, reqs)], reqs)
        logits, ks, vs = self._prefill_packed(
            self._tensor(toks), self._tensor(segs), self._tensor(positions),
            tuple(offs))
        first = sample_tokens(logits[rows, last], self.generator, temps)
        kv = []
        for o, req in zip(offs, reqs):
            lp = -(-len(req.prompt) // ps) * ps
            kv.append((ks[:, 0, :, o:o + lp], vs[:, 0, :, o:o + lp]))
        self._admitted(slots, reqs, first.cpu().numpy(), kv)
        return slots

    def add_requests_jagged(self, reqs: List[Request]) -> List[int]:
        """Admits a heterogeneous batch through the row-loop kernel.

        Prompts pad to the longest one's page bucket, as in add_requests,
        but attention clamps to each request's runtime length (~sum(L_i^2)/2,
        as packed admission), with one shape per (B, L_pad) bucket.
        """
        self._no_window("jagged")
        ps = self.page_size
        toks = pad_prompts([r.prompt for r in reqs], ps)
        slots = self._alloc(reqs)
        rows, last, temps = self._sample_rows(
            np.arange(len(reqs)), [len(r.prompt) - 1 for r in reqs], reqs)
        lens = self._tensor(np.asarray([len(r.prompt) for r in reqs],
                                       np.int32))
        logits, ks, vs = self._prefill_jagged(self._tensor(toks), lens)
        first = sample_tokens(logits[rows, last], self.generator, temps)
        kv = []
        for i, req in enumerate(reqs):
            lp = -(-len(req.prompt) // ps) * ps
            kv.append((ks[:, i, :, :lp], vs[:, i, :, :lp]))
        self._admitted(slots, reqs, first.cpu().numpy(), kv)
        return slots

    def _no_window(self, mode: str) -> None:
        if self.cfg.attn_window is not None:
            raise ValueError(f"{mode} admission + windowed ring cache: use "
                             "add_requests")

    def _alloc(self, reqs: List[Request]) -> List[int]:
        slots = []
        for req in reqs:
            slot = self.cache.alloc_slot(
                self.cache.pages_per_seq * self.page_size
                if self.cfg.attn_window is not None
                else len(req.prompt) + req.max_new_tokens)
            req.slot = slot
            self.requests[slot] = req
            slots.append(slot)
        return slots

    def _sample_rows(self, rows, last, reqs: List[Request]):
        """The logits rows the first tokens are sampled from and the
        requests' temperatures, on the device before the prefill runs."""
        return (self._tensor(np.asarray(rows, np.int64)),
                self._tensor(np.asarray(last, np.int64)),
                self._tensor(np.asarray([r.temperature for r in reqs],
                                        np.float32)))

    def _admitted(self, slots, reqs, first_toks, kv) -> None:
        """Writes each request's K/V (n_layers, hkv, L_pad, d) into its
        slot and records its first token."""
        for slot, req, tok, (k, v) in zip(slots, reqs, first_toks, kv):
            self.cache.write_prefill(slot, k, v)
            self.cache.lengths[slot] = len(req.prompt)
            self.temps[slot] = req.temperature
            self._record(slot, int(tok))

    # --- decode ------------------------------------------------------------

    def step(self) -> Dict[int, int]:
        """Advances every active slot one token; returns {slot: token}."""
        active = [s for s, r in self.requests.items() if not r.done]
        if not active:
            return {}
        lengths = self.cache.lengths.copy()
        # inactive slots decode against the scratch page at position 0
        positions = self._tensor(np.where(lengths > 0, lengths, 0)
                                 .astype(np.int32))
        page_table, _ = self.cache.device_views()
        sampled = self._decode_one(positions, page_table).cpu().numpy()

        out = {}
        for slot in active:
            self.cache.lengths[slot] += 1
            tok = int(sampled[slot])
            out[slot] = tok
            self._record(slot, tok)
        return out

    def steps(self, n: int) -> Dict[int, List[int]]:
        """Advances every active slot n tokens, syncing with the host once.

        Sequences that hit EOS mid-chunk stop being recorded, but their
        cache rows still advance (chunked-decode overrun; grow_slot
        reserves for it). Windowed slots hold their whole ring already:
        they neither grow nor take a narrower table. Returns {slot:
        [tokens...]} actually recorded.
        """
        active = [s for s, r in self.requests.items() if not r.done]
        if not active or n <= 0:
            return {}
        windowed = self.cfg.attn_window is not None
        if not windowed:
            # clamp to table capacity: a request whose prompt +
            # max_new_tokens fills its page_table row is not grown past it;
            # the decode write wraps overrun rows onto the slot's own pages
            cap = self.cache.pages_per_seq * self.page_size
            for slot in active:
                self.cache.grow_slot(
                    slot, min(int(self.cache.lengths[slot]) + n, cap))

        lengths = self.cache.lengths.copy()
        positions = self._tensor(np.where(lengths > 0, lengths, 0)
                                 .astype(np.int32))
        page_table, _ = self.cache.device_views()
        if not windowed:
            # power-of-two bucket of the live table width: the decode
            # kernel walks only the pages below each length, but the plain
            # path and the table copy scale with the width. A column slice
            # is a view. A ring needs its whole width (true wrap).
            need = int(np.max(np.where(lengths > 0, lengths, 0))) + n
            pages_needed = -(-need // self.page_size)
            bucket = 1 << max(0, (pages_needed - 1)).bit_length()
            if bucket < self.cache.pages_per_seq:
                page_table = page_table[:, :bucket]
        sampled = self._decode_chunk(positions, page_table, n).cpu().numpy()

        out: Dict[int, List[int]] = {s: [] for s in active}
        for slot in active:
            self.cache.lengths[slot] += n
            req = self.requests[slot]
            for t in range(n):
                if req.done:
                    break
                tok = int(sampled[t, slot])
                out[slot].append(tok)
                self._record(slot, tok)
        return out

    def _decode_chunk(self, positions, page_table, n) -> torch.Tensor:
        """Runs one decode chunk; returns sampled (n, B) on the device."""
        self.cache.pages, sampled, _ = decode_loop(
            self.cfg, self.params, self.cache.pages,
            self._tensor(self.last_token), positions, page_table,
            self._tensor(self.temps), self.generator,
            page_size=self.page_size, fmt=self.kv_format, n_steps=n,
            greedy=bool(np.all(self.temps == 0.0)))
        return sampled

    def _record(self, slot: int, tok: int) -> None:
        req = self.requests[slot]
        req.generated.append(tok)
        self.last_token[slot] = tok
        if (req.eos_token is not None and tok == req.eos_token) or \
                len(req.generated) >= req.max_new_tokens:
            req.done = True

    def collect_finished(self) -> List[Request]:
        done = [r for r in self.requests.values() if r.done]
        for r in done:
            self.cache.free_slot(r.slot)
            del self.requests[r.slot]
            self.temps[r.slot] = 0.0   # keep the greedy fast path available
        return done

    def generate(self, prompts: List[List[int]], max_new_tokens: int,
                 temperature: float = 0.0,
                 chunk: int = 32) -> List[List[int]]:
        """Batch API over the continuous-batching loop; decodes in chunks
        of steps(n) (chunk=1 is the per-token loop)."""
        reqs = [Request(p, max_new_tokens, temperature) for p in prompts]
        pending = list(reqs)
        while pending or self.requests:
            batch = []
            while pending and \
                    np.count_nonzero(self.cache.lengths == 0) > len(batch) \
                    and len(self.cache.free_pages) >= \
                    (len(batch) + 1) * self.cache.pages_per_seq:
                batch.append(pending.pop(0))
            if batch:
                self.add_requests(batch)
            if not self.requests:
                break
            rem = [r.max_new_tokens - len(r.generated)
                   for r in self.requests.values() if not r.done]
            if not rem:
                self.collect_finished()
                continue
            # max(rem) keeps long requests on the chunked path at the cost
            # of overrun pages for short ones; when the remaining lengths
            # have mostly converged, min(rem) avoids overrun steps
            lo, hi = min(rem), max(rem)
            n = max(1, min(chunk, lo if lo * 2 >= hi else hi))
            if n == 1:
                self.step()
            else:
                self.steps(n)
            self.collect_finished()
        return [r.generated for r in reqs]
