"""Paged KV cache: host-side page allocator + in-place device writes.

Port of tiny_flash_attention_tpu/models/kv_cache.py. Pages are stored per
layer in the fused format of ops/paged_fused.py, (hkv, num_pages, rows,
d), byte-identical to the JAX pages for the same inputs: fmt="bf16" pages
hold the model dtype in 2ps rows; fmt="int8" pages hold the int8 payload
and the bit-packed per-token f32 scales in 2ps + 2 * scale_rows_per_side(
ps, d) rows, quantized on write. The allocator (free list, slot table,
lengths) lives on the host. Where the JAX helpers donate the pages buffer
and return a new one, the writes here update the page tensors in place.

Data-parallel page groups (`n_groups`, JAX's :44-49, :91-145): slots and
page ids split into n_groups contiguous blocks, and a slot takes pages of
its own group only. JAX shards one global page array over its devices; a
rank of the port's sharded engine (parallel/serve.py) holds its block
alone (`held_group`): fresh page tensors of num_pages // n_groups pages,
addressed by global id minus the block's first. The host state is global
and the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tiny_flash_attention_tpu_torch.ops.paged_fused import (
    fused_page_append, page_rows, quantize_kv_page_int8)
from tiny_flash_attention_tpu_torch.utils.device import resolve_device

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16", torch.int8: "int8"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def local_page_ids(page_ids: torch.Tensor, group: int,
                   pages_per_group: int) -> torch.Tensor:
    """Global page ids -> indices into data group `group`'s block of
    pages_per_group pages (JAX's serve.py:70-79). The clip keeps freed and
    idle table entries (global 0) on the group's own scratch page, its
    block's first, never in another group's range."""
    return torch.clamp(page_ids - group * pages_per_group, 0,
                       pages_per_group - 1)


@dataclasses.dataclass
class PagedKVCache:
    pages: List[torch.Tensor]       # per layer: (hkv, num_pages, 2ps, d)
    page_table: np.ndarray          # (max_seqs, pages_per_seq) int32, host
    lengths: np.ndarray             # (max_seqs,) int32, host
    free_pages: list                # host free list of page ids
    page_size: int
    fmt: str                        # "bf16" | "int8"
    alloc_counts: np.ndarray = None  # (max_seqs,) pages held per slot
    # slots [g*S/n, (g+1)*S/n) and page ids [g*P/n, (g+1)*P/n) form group
    # g; 1 = the ordinary global pool
    n_groups: int = 1
    num_pages: int = None           # the pool's page count, every group's
    # None: the page tensors hold the whole pool; g: group g's block only
    held_group: Optional[int] = None

    def __post_init__(self):
        if self.num_pages is None:
            self.num_pages = self.pages[0].shape[1]

    # --- construction ---------------------------------------------------

    @classmethod
    def create(cls, *, n_layers: int, n_kv_heads: int, num_pages: int,
               page_size: int, d_head: int, max_seqs: int,
               pages_per_seq: int, fmt: str = "bf16",
               dtype: torch.dtype = torch.bfloat16, device=None,
               n_groups: int = 1,
               held_group: Optional[int] = None) -> "PagedKVCache":
        """held_group=g: the page tensors hold group g's block of
        num_pages // n_groups pages only (a data-parallel rank's)."""
        rows = page_rows(page_size, d_head, fmt)
        pdtype = torch.int8 if fmt == "int8" else dtype
        device = resolve_device(device)
        if num_pages % n_groups or max_seqs % n_groups:
            raise ValueError(f"{num_pages} pages and {max_seqs} slots do not "
                             f"split into {n_groups} groups")
        if held_group is not None and not 0 <= held_group < n_groups:
            raise ValueError(f"group {held_group} of {n_groups}")
        held = num_pages if held_group is None else num_pages // n_groups
        pages = [torch.zeros((n_kv_heads, held, rows, d_head),
                             dtype=pdtype, device=device)
                 for _ in range(n_layers)]
        return cls(
            pages=pages,
            page_table=np.zeros((max_seqs, pages_per_seq), np.int32),
            lengths=np.zeros((max_seqs,), np.int32),
            free_pages=list(range(num_pages - 1, -1, -1)),
            page_size=page_size,
            fmt=fmt,
            alloc_counts=np.zeros((max_seqs,), np.int32),
            n_groups=n_groups,
            num_pages=num_pages,
            held_group=held_group,
        )

    @property
    def max_seqs(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pages[0].device

    @property
    def pages_per_group(self) -> int:
        return self.num_pages // self.n_groups

    # --- host-side allocator ---------------------------------------------

    def group_of_slot(self, slot: int) -> int:
        return slot // (self.max_seqs // self.n_groups)

    def _group_free(self, group: int) -> List[int]:
        """Indices into free_pages of the ids in `group`'s range."""
        lo = group * self.pages_per_group
        hi = lo + self.pages_per_group
        return [i for i, p in enumerate(self.free_pages) if lo <= p < hi]

    def _pop_pages(self, group: int, n: int) -> List[int]:
        """n page ids of `group`, the last free ones first (JAX's n calls
        of `_pop_page(group)`), in one pass over the free list; a single
        pool pops from its end."""
        if self.n_groups == 1:
            if len(self.free_pages) < n:
                raise RuntimeError("cache out of pages")
            cut = len(self.free_pages) - n
            taken = self.free_pages[cut:][::-1]
            del self.free_pages[cut:]
            return taken
        idx = self._group_free(group)
        if len(idx) < n:
            raise RuntimeError(f"cache out of pages in data group {group}")
        drop = set(idx[len(idx) - n:])
        taken = [self.free_pages[i] for i in sorted(drop, reverse=True)]
        self.free_pages[:] = [p for i, p in enumerate(self.free_pages)
                              if i not in drop]
        return taken

    def alloc_slot(self, n_tokens_upper_bound: int) -> int:
        """Reserves a free sequence slot + enough pages for the bound.

        The slot is marked reserved at once (lengths = -1, overwritten by
        the first real write), so several allocations in a row get
        distinct slots. With n_groups > 1 it takes the first free slot
        whose group still has enough pages.
        """
        free_slots = np.where(self.lengths == 0)[0]
        if not free_slots.size:
            raise RuntimeError("no free sequence slots")
        n_pages = -(-n_tokens_upper_bound // self.page_size)
        if n_pages > self.pages_per_seq:
            raise ValueError(f"{n_tokens_upper_bound} tokens need {n_pages} "
                             f"pages > pages_per_seq {self.pages_per_seq}")
        if self.n_groups == 1:
            slot = int(free_slots[0])
        else:
            free = np.bincount(
                np.asarray(self.free_pages, np.int64) // self.pages_per_group,
                minlength=self.n_groups)
            slot = next((int(s) for s in free_slots
                         if free[self.group_of_slot(int(s))] >= n_pages),
                        None)
            if slot is None:
                raise RuntimeError("cache out of pages in every data group")
        self.page_table[slot, :n_pages] = self._pop_pages(
            self.group_of_slot(slot), n_pages)
        self.alloc_counts[slot] = n_pages
        self.lengths[slot] = -1
        return slot

    def grow_slot(self, slot: int, n_tokens: int) -> None:
        """Ensures the slot holds pages covering n_tokens (tracked with
        alloc_counts: page id 0 is a valid id)."""
        have = int(self.alloc_counts[slot])
        need = -(-n_tokens // self.page_size)
        if need > have:
            self.page_table[slot, have:need] = self._pop_pages(
                self.group_of_slot(slot), need - have)
            self.alloc_counts[slot] = need

    def free_slot(self, slot: int) -> None:
        """Returns what the slot ALLOCATED (lengths may run past it after a
        chunked-decode overrun)."""
        for i in range(int(self.alloc_counts[slot])):
            self.free_pages.append(int(self.page_table[slot, i]))
            self.page_table[slot, i] = 0
        self.alloc_counts[slot] = 0
        self.lengths[slot] = 0

    # --- device writes (in place) ------------------------------------------

    def _held(self, slots: np.ndarray) -> np.ndarray:
        """The slots whose pages these page tensors hold."""
        if self.held_group is None:
            return slots
        return slots[self.group_of_slot(slots) == self.held_group]

    def local_ids(self, ids) -> torch.Tensor:
        """Global page ids -> int32 indices into these page tensors (the
        held group's block: local_page_ids)."""
        ids = torch.as_tensor(ids, dtype=torch.int32, device=self.device)
        if self.held_group is None:
            return ids
        return local_page_ids(ids, self.held_group, self.pages_per_group)

    def write_prefill(self, slot: int, k_layers: torch.Tensor,
                      v_layers: torch.Tensor) -> None:
        """Writes a prompt's KV into the slot's pages.

        k_layers, v_layers: (n_layers, hkv, L, d); L is a page_size multiple
        (rows past the true length are garbage that length masking hides).
        A slot of a group these page tensors do not hold writes nothing.
        """
        hkv, L, d = k_layers.shape[1:]
        if L % self.page_size:
            raise ValueError(f"L {L} is not a multiple of the page size")
        if not self._held(np.asarray([slot])).size:
            return
        n = L // self.page_size
        page_ids = self.local_ids(self.page_table[slot, :n]).long()
        for li, pages in enumerate(self.pages):
            kp = k_layers[li].reshape(hkv, n, self.page_size, d)
            vp = v_layers[li].reshape(hkv, n, self.page_size, d)
            if self.fmt == "int8":
                fused = quantize_kv_page_int8(kp, vp)
            else:
                fused = torch.cat([kp, vp], dim=-2).to(pages.dtype)
            pages[:, page_ids] = fused

    def append_tokens(self, slots: np.ndarray, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
        """Appends one token per slot (the decode-step write).

        slots: (B,) host ints; k_new/v_new: (n_layers, hkv, B, d). Writes at
        the CURRENT lengths (a reserved slot's -1 counts as 0), then
        advances them. Each layer's write is one `fused_page_append` (the
        kernel on the card, quantizing for int8 pages); a rank holding one
        group's block writes that group's slots only.
        """
        slots = np.asarray(slots)
        pos_host = np.maximum(self.lengths[slots], 0)
        held = self._held(slots)
        if held.size < slots.size:
            cols = torch.as_tensor(np.flatnonzero(np.isin(slots, held)),
                                   device=self.device)
            k_new, v_new = k_new[:, :, cols], v_new[:, :, cols]
        pos = np.maximum(self.lengths[held], 0)
        page_ids = self.local_ids(self.page_table[
            held, (pos // self.page_size) % self.pages_per_seq])
        rows = torch.as_tensor((pos % self.page_size).astype(np.int32),
                               device=self.device)
        for li, pages in enumerate(self.pages):
            fused_page_append(pages, k_new[li].transpose(0, 1),
                              v_new[li].transpose(0, 1), page_ids, rows,
                              page_size=self.page_size)
        self.lengths[slots] = pos_host + 1

    def device_views(self):
        """(page_table, lengths) as int32 tensors on the cache's device."""
        return (torch.as_tensor(self.page_table, device=self.device),
                torch.as_tensor(self.lengths, device=self.device))

    # --- checkpoint / resume ----------------------------------------------

    def save(self, path: str) -> None:
        """Serializes the full cache state to an .npz file in the JAX
        package's layout (pages as uint8 views beside their dtype name), so
        either package can load what the other saved."""
        if self.held_group is not None:
            raise ValueError("these page tensors hold one data group's "
                             "block, not the pool")
        arrays = {f"pages_{i}": p.detach().cpu().contiguous()
                  .view(torch.uint8).numpy()
                  for i, p in enumerate(self.pages)}
        np.savez(
            path,
            page_table=self.page_table,
            lengths=self.lengths,
            alloc_counts=self.alloc_counts,
            free_pages=np.asarray(self.free_pages, np.int32),
            meta=np.asarray([self.page_size, len(self.pages), self.n_groups],
                            np.int32),
            fmt=np.asarray(self.fmt),
            pages_dtype=np.asarray(_DTYPE_NAMES[self.pages[0].dtype]),
            **arrays,
        )

    @classmethod
    def load(cls, path: str, device=None) -> "PagedKVCache":
        """Restores a cache saved with `save` (by either package)."""
        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            meta = [int(x) for x in z["meta"]]
            page_size, n_layers = meta[0], meta[1]
            fmt = str(z["fmt"])
            if fmt not in ("bf16", "int8"):
                raise ValueError(f"KV format {fmt!r}")
            dtype = _DTYPES[str(z["pages_dtype"])]
            pages = [torch.from_numpy(np.ascontiguousarray(z[f"pages_{i}"]))
                     .view(dtype).to(device, copy=True)
                     for i in range(n_layers)]
            return cls(
                pages=pages,
                page_table=z["page_table"].copy(),
                lengths=z["lengths"].copy(),
                free_pages=[int(p) for p in z["free_pages"]],
                page_size=page_size,
                fmt=fmt,
                alloc_counts=z["alloc_counts"].copy(),
                n_groups=meta[2] if len(meta) > 2 else 1,
            )
