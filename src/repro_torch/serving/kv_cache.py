"""Block-table KV-cache management (port of ``repro.serving.kv_cache``).

The device side is one pair of page pools ``{"k", "v"}`` shaped
``(n_attn, num_blocks, block_size, K, hd)``, one entry per attention
application (every layer of a dense model; one per period of zamba2's
hybrid, whose mamba layers keep slot state instead): every application
uses the same block ids, so one block grants one ``block_size``-token
slice of KV capacity across the whole model. Quantized pools
(``kv_dtype`` "int8" or "fp8", ``models.quant``) add fp32 ``{"k_scale",
"v_scale"}`` pools shaped ``(n_attn, num_blocks, block_size, K, 1)``. The
host side is
``BlockManager``, a refcounted allocator with per-request block tables
and a content-hash index for prefix caching; the same algorithm as the
JAX package's, so the same operations give the same tables, refcounts and
hashes (the port's tests drive both with one random walk).

Block 0 is the *trash block*: idle decode slots and chunk padding rows
write there, and nothing ever reads it.

Not ported yet: the host swap tier and the cross-replica
``SharedPrefixIndex`` (ROADMAP.md queue 1 items 7 and 11).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import MAMBA, ModelConfig
from repro_torch.models import quant
from repro_torch.models.transformer import period_structure

TRASH_BLOCK = 0

_HASH_SEED = b"repro-paged-kv-v1"


def extend_chain_hashes(chain: list[bytes], tokens,
                        block_size: int) -> list[bytes]:
    """Extend ``chain`` in place with hashes for every *full* block of
    ``tokens`` not yet covered (the chain only grows)."""
    h = chain[-1] if chain else hashlib.sha256(_HASH_SEED).digest()
    for i in range(len(chain), len(tokens) // block_size):
        blk = np.asarray(tokens[i * block_size:(i + 1) * block_size],
                         np.int32).tobytes()
        h = hashlib.sha256(h + blk).digest()
        chain.append(h)
    return chain


def chain_block_hashes(tokens, block_size: int) -> list[bytes]:
    """Chained sha256 content hashes for every *full* block of ``tokens``:
    ``h_i`` covers tokens ``[0, (i+1) * block_size)``."""
    return extend_chain_hashes([], tokens, block_size)


def attn_layer_stacks(cfg: ModelConfig) -> list[str]:
    """Names of the JAX package's layer stacks that hold attention KV."""
    kinds, _ = period_structure(cfg)
    out = [f"sub{i}" for i, k in enumerate(kinds) if k != MAMBA]
    if cfg.shared_attn_period:
        out.append("shared")
    return out


def mamba_layer_stacks(cfg: ModelConfig) -> list[str]:
    """Names of the JAX package's layer stacks holding per-slot SSM state."""
    kinds, _ = period_structure(cfg)
    return [f"sub{i}" for i, k in enumerate(kinds) if k == MAMBA]


def n_attn_applications(cfg: ModelConfig) -> int:
    """Attention applications per forward pass: periods x attention
    stacks, the leading axis of the page pools."""
    return period_structure(cfg)[1] * len(attn_layer_stacks(cfg))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda", kv_dtype: str = "bf16"):
    """Zero page pools for every attention application in ``kv_dtype``; a
    quantized dtype adds zero fp32 per-row scale pools."""
    shape = (n_attn_applications(cfg), num_blocks, block_size,
             cfg.num_kv_heads, cfg.head_dim)
    dtype = quant.KV_DTYPES[kv_dtype]
    # zero bytes are zeros in every pool dtype (fp8 included)
    cache = {name: torch.zeros(shape, dtype=torch.uint8,
                               device=device).view(dtype)
             if dtype.itemsize == 1 else
             torch.zeros(shape, dtype=dtype, device=device)
             for name in ("k", "v")}
    if quant.is_quantized(kv_dtype):
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1] + (1,),
                                      dtype=torch.float32, device=device)
    return cache


def block_bytes(cfg: ModelConfig, block_size: int, dtype_bytes: int = 2,
                kv_dtype: str = "bf16") -> int:
    """Device bytes one block id costs across every attention application's
    k+v pools; a quantized ``kv_dtype`` narrows the elements and adds the
    fp32 per-row scales (4 bytes per (token, kv head) row)."""
    row_bytes = cfg.head_dim * dtype_bytes
    if quant.is_quantized(kv_dtype):
        row_bytes = cfg.head_dim * quant.kv_dtype_bytes(kv_dtype) + 4
    return (2 * n_attn_applications(cfg) * block_size * cfg.num_kv_heads
            * row_bytes)


@dataclass
class CacheStats:
    num_blocks: int          # allocatable blocks (excludes the trash block)
    blocks_in_use: int       # distinct blocks with refcount > 0
    num_tables: int
    shared_blocks: int = 0   # blocks with refcount >= 2
    cached_free: int = 0     # free blocks still holding a registered hash

    @property
    def utilization(self) -> float:
        return self.blocks_in_use / max(self.num_blocks, 1)


class BlockManager:
    """Refcounted free-list allocator over page-pool rows + block tables.

    Pure host-side bookkeeping: pages are preallocated, allocation only
    decides which pool rows a request's tokens occupy. ``cow`` returns the
    page copy the *caller* must perform.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2 or block_size < 1:
            raise ValueError(f"num_blocks={num_blocks} must be >= 2 and "
                             f"block_size={block_size} >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently freed (cache-warm) blocks are reused first
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._tables: dict[int, list[int]] = {}
        self._ref: dict[int, int] = {}        # block -> refcount (> 0 only)
        self._hash_of: dict[int, bytes] = {}  # block -> content hash
        self._block_of: dict[bytes, int] = {}  # content hash -> block

    # -- queries ----------------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def stats(self) -> CacheStats:
        return CacheStats(
            num_blocks=self.num_blocks - 1,
            blocks_in_use=len(self._ref),
            num_tables=len(self._tables),
            shared_blocks=sum(1 for r in self._ref.values() if r >= 2),
            cached_free=sum(1 for b in self._free if b in self._hash_of))

    # -- prefix-cache index -----------------------------------------------

    def register(self, block: int, h: bytes) -> None:
        """Publish a *full* block's content hash. First writer wins."""
        assert block != TRASH_BLOCK
        if h in self._block_of or block in self._hash_of:
            return
        self._hash_of[block] = h
        self._block_of[h] = block

    def match(self, hashes: list[bytes]) -> list[int]:
        """Longest prefix of ``hashes`` resolving to cached blocks."""
        out = []
        for h in hashes:
            b = self._block_of.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def deregister(self, block: int) -> None:
        """Withdraw a block from the prefix cache before rewriting it in
        place (a full-prompt hit's final block adopted with refcount 1)."""
        h = self._hash_of.pop(block, None)
        if h is not None:
            del self._block_of[h]

    def _pop_free(self) -> int:
        """Take a free block for new content: prefer the newest free block
        with no cached hash; else evict the least recently freed cached
        one."""
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i] not in self._hash_of:
                return self._free.pop(i)
        b = self._free.pop(0)
        self.deregister(b)           # its content is about to be rewritten
        return b

    # -- mutations --------------------------------------------------------

    def allocate(self, rid: int, n_tokens: int) -> list[int]:
        """Fresh table covering n_tokens. KeyError on double-alloc,
        MemoryError when the pool can't cover it."""
        if rid in self._tables:
            raise KeyError(f"request {rid} already has a table")
        n = self.blocks_for(n_tokens)
        if n > self.num_free:
            raise MemoryError(f"need {n} blocks, have {self.num_free}")
        self._tables[rid] = t = []
        for _ in range(n):
            b = self._pop_free()
            self._ref[b] = 1
            t.append(b)
        return self.table(rid)

    def adopt(self, rid: int, blocks: list[int]) -> list[int]:
        """Start rid's table from already-populated cached blocks,
        refcounting each and reviving any that sit in the free list."""
        if rid in self._tables:
            raise KeyError(f"request {rid} already has a table")
        t = []
        for b in blocks:
            assert b != TRASH_BLOCK
            if self._ref.get(b, 0) == 0:
                self._free.remove(b)          # revive a cached free block
            self._ref[b] = self._ref.get(b, 0) + 1
            t.append(b)
        self._tables[rid] = t
        return self.table(rid)

    def ensure(self, rid: int, n_tokens: int) -> bool:
        """Grow rid's table to cover n_tokens. False (no change) on OOM."""
        t = self._tables[rid]
        need = self.blocks_for(n_tokens) - len(t)
        if need <= 0:
            return True
        if need > self.num_free:
            return False
        for _ in range(need):
            b = self._pop_free()
            self._ref[b] = 1
            t.append(b)
        return True

    def cow(self, rid: int, idx: int) -> int | None:
        """Make table slot ``idx`` exclusively owned before a write: shared
        -> swap in a fresh block and return its id (the caller copies the
        old block's pages into it); exclusive -> None."""
        t = self._tables[rid]
        old = t[idx]
        if self._ref[old] <= 1:
            return None
        if not self._free:
            raise MemoryError("copy-on-write needs a free block")
        new = self._pop_free()
        self._ref[old] -= 1
        self._ref[new] = 1
        t[idx] = new
        return new

    def _drop(self, b: int) -> None:
        self._ref[b] -= 1
        if self._ref[b] == 0:
            del self._ref[b]
            self._free.append(b)

    def truncate(self, rid: int, n_tokens: int) -> list[int]:
        """Rewind rid's table to cover only ``n_tokens``, freeing the tail
        (the speculative rollback of the lookahead a verify step reserved
        past the accepted tokens). Dropped blocks follow ``free``: refcount
        down, content hash kept while on the free list. Returns the freed
        block ids, newest first."""
        t = self._tables[rid]
        keep = self.blocks_for(max(n_tokens, 0))
        dropped = []
        while len(t) > keep:
            b = t.pop()
            self._drop(b)
            dropped.append(b)
        return dropped

    def free(self, rid: int) -> None:
        """Drop rid's references. Freed blocks keep their content hash
        while on the free list, so they stay matchable until reused."""
        for b in self._tables.pop(rid):
            self._drop(b)

    def check(self) -> None:
        """Invariants: refcounts == table references, free list exact,
        hash index consistent, no trash block anywhere."""
        counts: dict[int, int] = {}
        for rid, t in self._tables.items():
            assert len(set(t)) == len(t), f"table {rid} repeats a block"
            for b in t:
                assert b != TRASH_BLOCK, (rid, t)
                counts[b] = counts.get(b, 0) + 1
        assert counts == self._ref, "refcounts drifted from table refs"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list duplicates"
        assert not (free_set & set(self._ref)), "free list overlaps tables"
        assert len(self._ref) + len(self._free) == self.num_blocks - 1
        for b, h in self._hash_of.items():
            assert b != TRASH_BLOCK
            assert self._block_of.get(h) == b, "hash maps disagree"
        assert len(self._block_of) == len(self._hash_of)
