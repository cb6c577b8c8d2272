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

Two host tiers sit behind the device pools, both in units of one block's
pages across every paged pool (scales included):

* the **swap tier** (``num_host_blocks``): a swap-preempted request's
  table moves to host slots it owns until it swaps back in or is
  aborted; its hashed slots also serve other requests' prefix hits
  (``match_host`` / ``host_copy_in``);
* the **shared prefix index** (:class:`SharedPrefixIndex`), one per
  process, shared by every data-parallel replica's ``BlockManager``:
  replicas publish hashed blocks into its host pool and adopt each
  other's, so a prefix is prefilled once per fleet.

The payloads themselves live in pinned host tensors the engine owns
(swap tier) or the index owns (shared pool); this module keeps only the
bookkeeping, and the engine performs the copies it returns.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import MAMBA, ModelConfig
from repro_torch.models import quant
from repro_torch.models.transformer import layer_counts, period_structure
from repro_torch.spmd.sharding import kv_heads_per_rank

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
    """Attention applications per forward pass (periods x attention
    stacks), the leading axis of the page pools."""
    return layer_counts(cfg)[0]


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda", kv_dtype: str = "bf16", tp: int = 1):
    """Zero page pools for every attention application in ``kv_dtype``; a
    quantized dtype adds zero fp32 per-row scale pools. With ``tp`` > 1:
    one tensor-parallel rank's, K / tp kv heads."""
    shape = (n_attn_applications(cfg), num_blocks, block_size,
             kv_heads_per_rank(cfg.num_kv_heads, tp), cfg.head_dim)
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
                tp: int = 1, kv_dtype: str = "bf16") -> int:
    """Device bytes one block id costs across every attention application's
    k+v pools; a quantized ``kv_dtype`` narrows the elements and adds the
    fp32 per-row scales (4 bytes per (token, kv head) row). ``tp`` > 1
    gives one tensor-parallel rank's cost: it holds K / tp kv heads of
    every page (tp must divide K)."""
    row_bytes = cfg.head_dim * dtype_bytes
    if quant.is_quantized(kv_dtype):
        row_bytes = cfg.head_dim * quant.kv_dtype_bytes(kv_dtype) + 4
    return (2 * n_attn_applications(cfg) * block_size
            * kv_heads_per_rank(cfg.num_kv_heads, tp) * row_bytes)


class SharedPrefixIndex:
    """Process-global content-hash index and host payload pool shared by
    every replica's :class:`BlockManager`.

    Block ids mean nothing outside their replica, so sharing a prefix
    across replicas needs a payload medium: a pool of host slots (one
    slot = one block's pages across every paged pool, as the swap tier
    lays them out) and a ``hash -> slot`` map. Replicas **publish**: the
    engine reserves a slot for a newly registered full block, copies its
    pages into the slot, waits for the copy, and commits the hash. Any
    replica's admission then **adopts**: ``acquire`` resolves the longest
    committed prefix to (slot, hash) pairs, ``BlockManager.host_copy_in``
    allocates fresh device blocks, and the engine copies the payload in.

    Every mutator takes ``self._lock`` (replicas step on their own
    threads):

    * a **reserved** slot (publish in flight) is invisible to ``acquire``
      and immune to eviction until ``commit`` or ``abandon``;
    * an **acquired** slot is pinned until ``release`` (after the
      adopter's copy has landed), so no payload is evicted or rewritten
      under a pending copy;
    * a ``reserve`` on a full pool evicts the least recently used
      unpinned committed slot; ``acquire`` refreshes recency.

    The lock protects bookkeeping, not output equality: adopted KV is a
    pure function of the token prefix, so a racing miss recomputes the
    same bytes.
    """

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} must be >= 1")
        self.num_slots = num_slots
        self._lock = threading.Lock()
        self._free = list(range(num_slots - 1, -1, -1))
        self._slot_of: dict[bytes, int] = {}   # hash -> committed slot
        self._hash_of: dict[int, bytes] = {}   # committed slot -> hash
        self._reserved: set[int] = set()       # publish in flight
        self._pins: dict[int, int] = {}        # slot -> acquire count
        self._order: list[int] = []            # committed slots, LRU first
        # the payload pool, one host tensor per paged pool (attach_pool;
        # allocated once, by the first replica's engine)
        self.pool: list[torch.Tensor] = []
        self._pool_key = None
        self.published_blocks = 0
        self.adopted_blocks = 0
        self.evicted_blocks = 0

    # -- payload pool ------------------------------------------------------

    def attach_pool(self, leaf_shapes, pin: bool = False) -> None:
        """Allocate the shared host pool: one ``(num_slots,) + shape``
        tensor per ``(shape, dtype)`` of ``leaf_shapes`` (a paged pool's
        shape without its per-replica block axis, so replicas with pools
        of different sizes still share), pinned when ``pin``. The first
        replica allocates; later ones must present the same layout."""
        key = tuple((tuple(shape), str(dtype)) for shape, dtype in leaf_shapes)
        with self._lock:
            if self._pool_key is not None:
                if key != self._pool_key:
                    raise ValueError(
                        "shared prefix pool layout mismatch across "
                        f"replicas: {key} != {self._pool_key}")
                return
            self._pool_key = key
            self.pool = [torch.zeros((self.num_slots,) + tuple(shape),
                                     dtype=dtype, pin_memory=pin)
                         for shape, dtype in leaf_shapes]

    # -- publish (writer side) ---------------------------------------------

    def contains(self, h: bytes) -> bool:
        with self._lock:
            return h in self._slot_of

    def reserve(self, h: bytes) -> int | None:
        """Claim a slot for publishing ``h``; None when the hash is already
        committed or no slot can be freed (all pinned or reserved). The
        caller copies the payload in, then ``commit``s."""
        with self._lock:
            if h in self._slot_of:
                return None
            if not self._free:
                victim = next((s for s in self._order
                               if not self._pins.get(s)), None)
                if victim is None:
                    return None
                self._evict_locked(victim)
            s = self._free.pop()
            self._reserved.add(s)
            return s

    def commit(self, slot: int, h: bytes) -> None:
        with self._lock:
            assert slot in self._reserved, slot
            self._reserved.discard(slot)
            if h in self._slot_of:
                # two replicas raced the same hash through reserve: the
                # first commit wins, the loser's copy is dropped
                self._free.append(slot)
                return
            self._slot_of[h] = slot
            self._hash_of[slot] = h
            self._order.append(slot)
            self.published_blocks += 1

    def abandon(self, slot: int) -> None:
        """Return a reserved slot unused (publish aborted)."""
        with self._lock:
            assert slot in self._reserved, slot
            self._reserved.discard(slot)
            self._free.append(slot)

    def _evict_locked(self, slot: int) -> None:
        self._order.remove(slot)
        h = self._hash_of.pop(slot)
        del self._slot_of[h]
        self._free.append(slot)
        self.evicted_blocks += 1

    # -- adopt (reader side) -----------------------------------------------

    def acquire(self, hashes: list[bytes],
                limit: int | None = None) -> list[tuple[int, bytes]]:
        """Longest prefix of ``hashes`` resolving to committed slots, each
        pinned against eviction until ``release``; ``limit`` caps the match
        (the adopter's free-block budget)."""
        out: list[tuple[int, bytes]] = []
        with self._lock:
            for h in hashes if limit is None else hashes[:max(limit, 0)]:
                s = self._slot_of.get(h)
                if s is None:
                    break
                self._pins[s] = self._pins.get(s, 0) + 1
                self._order.remove(s)          # refresh recency (MRU)
                self._order.append(s)
                out.append((s, h))
            self.adopted_blocks += len(out)
        return out

    def release(self, slots: list[int]) -> None:
        """Unpin after the adopter's copies have landed."""
        with self._lock:
            for s in slots:
                n = self._pins[s] - 1
                if n:
                    self._pins[s] = n
                else:
                    del self._pins[s]

    # -- audit -------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"slots": self.num_slots,
                    "committed": len(self._slot_of),
                    "pinned": len(self._pins),
                    "published_blocks": self.published_blocks,
                    "adopted_blocks": self.adopted_blocks,
                    "evicted_blocks": self.evicted_blocks}

    def check(self) -> None:
        """Invariants: the slots partition exactly, the maps agree, and
        pins sit only on committed (payload-bearing) slots."""
        with self._lock:
            committed = set(self._hash_of)
            free = set(self._free)
            assert len(free) == len(self._free), "free list duplicates"
            assert not (free & committed), "free slot holds a hash"
            assert not (free & self._reserved), "free slot is reserved"
            assert not (self._reserved & committed), "reserved committed"
            assert len(free) + len(committed) + len(self._reserved) \
                == self.num_slots, "slots lost"
            assert sorted(self._order) == sorted(committed), "order drift"
            for h, s in self._slot_of.items():
                assert self._hash_of.get(s) == h, "hash maps disagree"
            assert len(self._slot_of) == len(self._hash_of)
            for s, n in self._pins.items():
                assert n > 0, (s, n)
                assert s in committed, f"pin on a payload-less slot {s}"


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

    def __init__(self, num_blocks: int, block_size: int,
                 num_host_blocks: int = 0,
                 shared_index: SharedPrefixIndex | None = None):
        if num_blocks < 2 or block_size < 1:
            raise ValueError(f"num_blocks={num_blocks} must be >= 2 and "
                             f"block_size={block_size} >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # cross-replica prefix sharing: registered hashes queue for
        # publication into the process-global index (the engine drains the
        # queue and copies the payloads at step boundaries)
        self.shared = shared_index
        self._publish_q: list[tuple[int, bytes]] = []
        # LIFO free list: recently freed (cache-warm) blocks are reused first
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._tables: dict[int, list[int]] = {}
        self._ref: dict[int, int] = {}        # block -> refcount (> 0 only)
        self._hash_of: dict[int, bytes] = {}  # block -> content hash
        self._block_of: dict[bytes, int] = {}  # content hash -> block
        # host tier (swap preemption): a swapped request owns its slots
        # exclusively until swap_in or swap_discard
        self.num_host_blocks = num_host_blocks
        self._host_free = list(range(num_host_blocks - 1, -1, -1))
        self._swapped: dict[int, list[int]] = {}      # rid -> host slots
        self._host_hash_of: dict[int, bytes] = {}     # slot -> content hash
        self._host_block_of: dict[bytes, int] = {}    # content hash -> slot

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
        """Publish a *full* block's content hash. First writer wins. With a
        shared index the block also queues for cross-replica publication."""
        assert block != TRASH_BLOCK
        if h in self._block_of or block in self._hash_of:
            return
        self._hash_of[block] = h
        self._block_of[h] = block
        if self.shared is not None and not self.shared.contains(h):
            self._publish_q.append((block, h))

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

    def drain_publishable(self) -> list[tuple[int, bytes]]:
        """The queued (block, hash) registrations still current: the block
        still carries that hash, so its pages hold exactly the hashed
        content. Stale entries (deregistered for an in-place write, or
        evicted and rewritten since) are dropped. Clears the queue."""
        out = [(b, h) for b, h in self._publish_q
               if self._hash_of.get(b) == h]
        self._publish_q.clear()
        return out

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

    # -- host tier (swap preemption) ---------------------------------------

    def is_swapped(self, rid: int) -> bool:
        return rid in self._swapped

    @property
    def num_host_free(self) -> int:
        return len(self._host_free)

    def can_swap_out(self, rid: int) -> bool:
        return len(self._tables.get(rid, ())) <= len(self._host_free)

    def swap_out(self, rid: int) -> list[tuple[int, int]]:
        """Move rid's table to host slots. Returns the (device_block,
        host_slot) copies the caller must perform on the *pre-step* pool,
        before anything can rewrite a freed block. Device blocks follow
        ``free`` (hash kept while free), so a quick swap-in revives them
        without a copy; hashed blocks also enter the host index, so other
        requests' admissions can prefix-hit swapped content."""
        t = self._tables.pop(rid)
        pairs, slots = [], []
        for b in t:
            s = self._host_free.pop()
            pairs.append((b, s))
            slots.append(s)
            h = self._hash_of.get(b)
            if h is not None and h not in self._host_block_of:
                self._host_hash_of[s] = h
                self._host_block_of[h] = s
            self._drop(b)
        self._swapped[rid] = slots
        return pairs

    def can_swap_in(self, rid: int) -> bool:
        # at worst every slot needs a fresh device block; hashed slots
        # whose device twin survived on the free list revive for free
        return len(self._swapped.get(rid, ())) <= self.num_free

    def _drop_host_hash(self, s: int) -> bytes | None:
        h = self._host_hash_of.pop(s, None)
        if h is not None and self._host_block_of.get(h) == s:
            del self._host_block_of[h]
        return h

    def swap_in(self, rid: int) -> tuple[list[int], list[tuple[int, int]]]:
        """Rebuild rid's device table from its host slots. Returns (table,
        the (host_slot, device_block) copies the caller must perform before
        the step reads them). A hashed slot whose device twin still sits on
        the free list (pages are never written while free) revives it in
        place, with no copy."""
        if rid in self._tables:
            raise KeyError(f"request {rid} already has a table")
        pairs, t = [], []
        for s in self._swapped.pop(rid):
            h = self._drop_host_hash(s)
            b = self._block_of.get(h) if h is not None else None
            if b is not None:                 # device twin survived: revive
                if self._ref.get(b, 0) == 0:
                    self._free.remove(b)
                self._ref[b] = self._ref.get(b, 0) + 1
            else:
                b = self._pop_free()
                self._ref[b] = 1
                pairs.append((s, b))
                if h is not None:
                    self.register(b, h)
            t.append(b)
            self._host_free.append(s)
        self._tables[rid] = t
        return self.table(rid), pairs

    def swap_discard(self, rid: int) -> None:
        """Drop a swapped-out request's host slots without copying them
        back (abort while swapped); their host hashes go with them."""
        for s in self._swapped.pop(rid):
            self._drop_host_hash(s)
            self._host_free.append(s)

    def match_host(self, hashes: list[bytes]) -> list[int]:
        """Longest prefix of ``hashes`` resolving to *host* slots: admission
        extends a device prefix hit with swapped-out content, copied back
        instead of recomputed."""
        out = []
        for h in hashes:
            s = self._host_block_of.get(h)
            if s is None:
                break
            out.append(s)
        return out

    def host_copy_in(self, rid: int, slots: list[int],
                     hashes: list[bytes]) -> tuple[list[int],
                                                   list[tuple[int, int]]]:
        """A non-destructive host prefix hit: copy ``slots`` (still owned
        by their swapped-out request, or shared-index slots) into fresh
        device blocks appended to rid's table (created if absent:
        admission adopts the device hits first, then extends them here),
        registering ``hashes`` on the new blocks. Returns (table, the
        (host_slot, device_block) copies)."""
        if len(slots) > self.num_free:
            raise MemoryError(
                f"need {len(slots)} blocks, have {self.num_free}")
        t = self._tables.setdefault(rid, [])
        pairs = []
        for s, h in zip(slots, hashes):
            b = self._pop_free()
            self._ref[b] = 1
            t.append(b)
            pairs.append((s, b))
            self.register(b, h)
        return self.table(rid), pairs

    def check(self) -> None:
        """Invariants: refcounts == table references, free list exact,
        hash index consistent, no trash block anywhere; host slots owned
        once, the host free list exact, host hashes only on owned slots."""
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
        owned = [s for slots in self._swapped.values() for s in slots]
        assert len(set(owned)) == len(owned), "host slot double-owned"
        host_free = set(self._host_free)
        assert len(host_free) == len(self._host_free), "host free dups"
        assert not (host_free & set(owned)), "host free overlaps swapped"
        assert len(owned) + len(self._host_free) == self.num_host_blocks
        for s, h in self._host_hash_of.items():
            assert s not in host_free, "hashed host slot is free"
            assert self._host_block_of.get(h) == s, "host hash disagree"
        assert len(self._host_block_of) == len(self._host_hash_of)
