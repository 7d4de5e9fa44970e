"""Paged KV cache — the buffer-pool abstraction applied to serving HBM.

Port of the JAX package's ``core/kvcache.py``. Pangea's thesis is that one
manager should own *all* memory; on the serving path the contested memory is
device memory holding KV pages. The pool is one preallocated device tensor
``kv[L, P, page, 2, KH, D]`` managed with the same locality-set machinery as
the host buffer pool:

* each sequence is a locality set of KV pages (write-back, random-read →
  LRU within the set, Table-3 spilling cost 5.0);
* Eq. 1 orders sequences for eviction: finished sequences (lifetime-ended)
  first, then cold sequences (stale ``t_r``);
* evicted pages are copied device→host into a numpy slab and restored on
  demand, in place.

The host side stays numpy (``HostSlabStore``), so a tiered store can slot in
without the cache knowing. The pool is fp32 or bf16 (the configs'
``kv_cache_dtype``). An fp32 pool moves its slabs as ``np.float32``; numpy
has no bfloat16 of its own, so a bf16 pool moves its slabs as the same bytes
viewed as ``np.uint16`` (``host_array`` rounds values into those bits).

The device half (attention over the page pool) is ``kernels/paged_attention``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .attributes import (AttributeSet, CurrentOperation, DurabilityType,
                         ReadingPattern, WritingPattern)
from .locality_set import LocalitySet, Page
from .paging import PagingSystem

# torch pool dtype -> numpy dtype of the host slab (same bytes)
_HOST_DTYPE = {torch.float32: np.dtype(np.float32),
               torch.bfloat16: np.dtype(np.uint16)}
# a dtype's name (numpy's, ml_dtypes' bfloat16 or a string) -> pool dtype
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kv_attrs() -> AttributeSet:
    return AttributeSet(
        durability=DurabilityType.WRITE_BACK,
        writing=WritingPattern.RANDOM_MUTABLE_WRITE,
        reading=ReadingPattern.RANDOM_READ,
    )


def pool_dtype(dtype) -> torch.dtype:
    """A torch dtype for the pool from a torch dtype, a numpy dtype or a
    name (``np.float32``, ``"bfloat16"``, ``torch.bfloat16``, ml_dtypes'
    bfloat16 by its name ...); raises ``TypeError`` on any but the two."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        try:
            name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        except TypeError:
            name = None
        out = _TORCH_DTYPE.get(name)
    if out not in _HOST_DTYPE:
        raise TypeError(f"unsupported KV pool dtype {dtype!r}: the pool is "
                        f"float32 or bfloat16")
    return out


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype of a pool's host slabs (``np.uint16`` bits for
    bf16)."""
    return _HOST_DTYPE[pool_dtype(dtype)]


def host_array(values: np.ndarray, dtype) -> np.ndarray:
    """``values`` (float) as fp32, rounded by torch's cast (the pool's own)
    into the pool dtype's host form: ``np.float32``, or for bf16 the bits as
    ``np.uint16``."""
    v = torch.from_numpy(np.array(values, np.float32))        # a copy
    return tensor_to_host(v.to(pool_dtype(dtype)))


def host_to_tensor(a: np.ndarray, dtype) -> torch.Tensor:
    """A CPU tensor of the pool dtype over the host array's memory (a bf16
    pool's ``np.uint16`` bits viewed as bfloat16; no copy when ``a`` is
    C-contiguous and writable)."""
    a = np.require(a, requirements=["C", "W"])     # copies if needed
    if pool_dtype(dtype) == torch.bfloat16 and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor of a pool dtype, in its host form."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class HBMExhaustedError(MemoryError):
    pass


class HostSlabStore:
    """Level-2 host store for offloaded KV page slabs (numpy arrays).

    * ``put(pid, slab)``   — offload accepted this slab (may raise to refuse);
    * ``take(pid)``        — remove + return the slab for restore (None if the
      page was never offloaded);
    * ``peek(pid)``        — read without removing;
    * ``discard(pid)``     — the sequence finished; drop any copy.
    """

    def __init__(self) -> None:
        self._slabs: Dict[int, np.ndarray] = {}

    def put(self, page_id: int, slab: np.ndarray) -> None:
        self._slabs[page_id] = slab

    def take(self, page_id: int) -> Optional[np.ndarray]:
        return self._slabs.pop(page_id, None)

    def peek(self, page_id: int) -> Optional[np.ndarray]:
        return self._slabs.get(page_id)

    def discard(self, page_id: int) -> None:
        self._slabs.pop(page_id, None)

    def __contains__(self, page_id: int) -> bool:
        return page_id in self._slabs

    def __len__(self) -> int:
        return len(self._slabs)


@dataclass
class SeqState:
    seq_id: int
    length: int = 0                    # tokens written
    page_ids: List[int] = field(default_factory=list)  # logical pages, in order


class PagedKVCache:
    """Page-granular KV storage for one model (all layers share page geometry).

    Physical layout (device): ``kv[L, P, page_size, 2, kv_heads, head_dim]``
    where P = hbm_pages. Logical pages beyond P live in the host store.
    ``block_table(seq)`` yields physical slots for the attention kernel.
    """

    def __init__(self, num_layers: int, hbm_pages: int, page_size: int,
                 kv_heads: int, head_dim: int, dtype=np.float32,
                 host_store: Optional[HostSlabStore] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.hbm_pages = hbm_pages
        self.page_size = page_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = pool_dtype(dtype)
        self.host_dtype = _HOST_DTYPE[self.dtype]
        self.kv = torch.zeros(
            (num_layers, hbm_pages, page_size, 2, kv_heads, head_dim),
            dtype=self.dtype, device=self.device)
        self._free_slots: List[int] = list(range(hbm_pages))[::-1]
        self.paging = PagingSystem()
        self.clock = 1
        self._seqs: Dict[int, SeqState] = {}
        self._sets: Dict[int, LocalitySet] = {}
        self._pages: Dict[int, Page] = {}
        self.host_store = host_store if host_store is not None else HostSlabStore()
        self._next_page_id = 0
        self.stats = {"offloads": 0, "fetches": 0, "offload_bytes": 0}

    @property
    def slab_shape(self):
        return (self.num_layers, self.page_size, 2, self.kv_heads,
                self.head_dim)

    @property
    def slab_nbytes(self) -> int:
        """Bytes of one logical page's slab across all layers."""
        return int(np.prod(self.slab_shape)) * self.host_dtype.itemsize

    # -- host <-> device slab conversion ----------------------------------------
    def _slab_to_host(self, slot: int) -> np.ndarray:
        """A host copy of one slot's slab (never a view of the pool), in
        memory numpy owns: host stores hand slabs to other threads, which
        then never free torch storage."""
        slab = np.empty(self.slab_shape, self.host_dtype)
        self._slab_to_tensor(slab).copy_(self.kv[:, slot])
        return slab

    def _slab_to_tensor(self, slab: Union[np.ndarray, torch.Tensor]
                        ) -> torch.Tensor:
        if isinstance(slab, torch.Tensor):
            return slab
        return host_to_tensor(slab, self.dtype)

    # -- sequence lifecycle -----------------------------------------------------
    def start_sequence(self, seq_id: int) -> SeqState:
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already active")
        st = SeqState(seq_id)
        ls = LocalitySet(f"seq{seq_id}", self.page_size, kv_attrs())
        self.clock += 1
        self.paging.register(ls, self.clock)
        ls.set_operation(CurrentOperation.READ_AND_WRITE, self.clock)
        self._seqs[seq_id] = st
        self._sets[seq_id] = ls
        return st

    def finish_sequence(self, seq_id: int) -> None:
        """Lifetime over: its pages are reclaimed eagerly (paper §3.1)."""
        st = self._seqs.pop(seq_id)
        ls = self._sets.pop(seq_id)
        self.clock += 1
        ls.end_lifetime(self.clock)
        for pid in st.page_ids:
            page = self._pages.pop(pid)
            if page.offset is not None:
                self._free_slots.append(page.offset)
            self.host_store.discard(pid)
        self.paging.unregister(ls.name)

    # -- page management ----------------------------------------------------------
    def _evict_one(self) -> None:
        picked = self.paging.pick_victims(self.clock)
        if picked is None:
            raise HBMExhaustedError("all KV pages pinned (every sequence active)")
        ls, victims = picked
        for vp in victims:
            self._offload(vp)

    def _offload(self, page: Page) -> None:
        if page.offset is None:
            raise ValueError(f"page {page.page_id} is not resident")
        slab = self._slab_to_host(page.offset)        # device -> host
        self.host_store.put(page.page_id, slab)
        self.stats["offloads"] += 1
        self.stats["offload_bytes"] += slab.nbytes
        self._free_slots.append(page.offset)
        page.offset = None

    def _restore(self, page: Page, ls: LocalitySet) -> int:
        slot = self._alloc_slot(exclude_set=ls.name)
        try:
            slab = self.host_store.take(page.page_id)
        except BaseException:
            # a tiered store may fail mid-fetch; the slot goes back so the
            # cache stays consistent for the retry
            self._free_slots.append(slot)
            raise
        if slab is not None:
            # in place: the host slab is copied into the pool's slot
            self.kv[:, slot].copy_(self._slab_to_tensor(slab))
            self.stats["fetches"] += 1
        page.offset = slot
        return slot

    def _alloc_slot(self, exclude_set: Optional[str] = None) -> int:
        # ``exclude_set`` is ignored, as in the reference: a restore can
        # evict a page that another block table of the same batch points at
        while not self._free_slots:
            self._evict_one()
        return self._free_slots.pop()

    def append_page(self, seq_id: int) -> Page:
        """Allocate the next logical page for a sequence."""
        st = self._seqs[seq_id]
        ls = self._sets[seq_id]
        self.clock += 1
        slot = self._alloc_slot()
        page = Page(page_id=self._next_page_id, set_name=ls.name,
                    size=self.page_size, offset=slot, pin_count=0, dirty=True,
                    last_access=self.clock)
        self._next_page_id += 1
        ls.pages[page.page_id] = page
        self._pages[page.page_id] = page
        st.page_ids.append(page.page_id)
        return page

    def ensure_capacity(self, seq_id: int, new_tokens: int = 1) -> None:
        st = self._seqs[seq_id]
        needed_pages = -(-(st.length + new_tokens) // self.page_size)
        while len(st.page_ids) < needed_pages:
            self.append_page(seq_id)

    def block_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Physical slots for the attention kernel; restores any offloaded
        page of this sequence (decode reads the whole sequence)."""
        st = self._seqs[seq_id]
        ls = self._sets[seq_id]
        self.clock += 1
        ls.set_operation(CurrentOperation.READ_AND_WRITE, self.clock)
        table = np.full(max_pages, -1, dtype=np.int32)
        for i, pid in enumerate(st.page_ids[:max_pages]):
            page = self._pages[pid]
            if page.offset is None:
                self._restore(page, ls)
            page.last_access = self.clock
            table[i] = page.offset
        return table

    def advance(self, seq_id: int, tokens: int = 1) -> None:
        self._seqs[seq_id].length += tokens

    # -- byte-exact page access ---------------------------------------------------
    def write_page(self, seq_id: int, page_index: int,
                   slab: Union[np.ndarray, torch.Tensor]) -> None:
        """Overwrite one logical page's slab ([L, page, 2, KH, D]); restores
        the page to the pool first if it was offloaded. The slab is a numpy
        array (cast to the pool dtype; ``np.uint16`` bits for a bf16 pool) or
        a tensor on any device."""
        st = self._seqs[seq_id]
        ls = self._sets[seq_id]
        page = self._pages[st.page_ids[page_index]]
        self.clock += 1
        if page.offset is None:
            self._restore(page, ls)
        page.last_access = self.clock
        page.dirty = True
        # in place: the slab is copied into the pool's slot
        self.kv[:, page.offset].copy_(self._slab_to_tensor(slab))

    def read_page(self, seq_id: int, page_index: int) -> np.ndarray:
        """Byte-exact host slab of one logical page, wherever it lives:
        resident pages read from the pool, offloaded ones from the host store
        (without pulling them back in)."""
        st = self._seqs[seq_id]
        page = self._pages[st.page_ids[page_index]]
        if page.offset is not None:
            return self._slab_to_host(page.offset)
        slab = self.host_store.peek(page.page_id)
        if slab is None:   # offloaded before any write: an all-zero page
            return np.zeros(self.slab_shape, dtype=self.host_dtype)
        return np.asarray(slab)

    def sequence_slabs(self, seq_id: int) -> List[np.ndarray]:
        """All of a sequence's page slabs in logical order."""
        return [self.read_page(seq_id, i)
                for i in range(len(self._seqs[seq_id].page_ids))]

    def seq_length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def num_pages(self, seq_id: int) -> int:
        return len(self._seqs[seq_id].page_ids)

    # -- introspection --------------------------------------------------------------
    def resident_pages(self) -> int:
        return self.hbm_pages - len(self._free_slots)

    def active_sequences(self) -> List[int]:
        return list(self._seqs)
