"""Per-slot state caches (port of ``repro.serving.cache``).

Besides paged KV (``kv_cache.BlockManager``: growing, block-granular,
shareable), the engine manages **slot state**: constant-size per-request
state, a Mamba block's (conv_tail, ssm_state), or an encoder-decoder's
cross-attention K/V. One slot per running request; nothing grows, nothing
is shared, and there is no block horizon. :class:`SlotStateCache` is the
host half, pure bookkeeping of which slot belongs to which request: the
scheduler binds a slot at admission and frees it on preemption and
retirement. The device half (``init_slot_state``, ``init_encoder_cache``)
is one tensor pair with a slot axis, which the runner reads and writes in
place. :class:`EncoderCache` is the same bookkeeping for state that only
the admission-time encode pass writes.

Invariants ``check()`` enforces (the port's tests drive it and the JAX
package's cache with one random walk): the rid->slot and slot->rid maps
are mutually inverse, every bound slot is in range, and a slot is held by
at most one request for its whole residence.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.config import MAMBA, ModelConfig
from repro_torch.spmd.sharding import kv_heads_per_rank

__all__ = ["SlotStateCache", "SlotCacheStats", "EncoderCache",
           "init_slot_state", "init_encoder_cache", "slot_state_bytes",
           "encoder_cache_bytes"]


@dataclass
class SlotCacheStats:
    n_slots: int
    in_use: int


class SlotStateCache:
    """Host-side allocator for constant-size per-slot device state.

    Each running request owns exactly one slot for its whole residence;
    preemption and retirement free the slot, and a preempted request's
    recompute starts from zeroed state (the runner zeroes the slot row on
    a fresh chunk, so a previous occupant's state is never read)."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        self.n_slots = n_slots
        self._slot_of: dict[int, int] = {}      # rid -> slot
        self._rid_of: dict[int, int] = {}       # slot -> rid

    # -- queries ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        return self.n_slots - len(self._rid_of)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if s not in self._rid_of]

    def slot(self, rid: int) -> int:
        return self._slot_of[rid]

    def stats(self) -> SlotCacheStats:
        return SlotCacheStats(n_slots=self.n_slots,
                              in_use=len(self._rid_of))

    # -- mutations --------------------------------------------------------

    def allocate(self, rid: int, slot: int | None = None) -> int:
        """Bind ``rid`` to ``slot`` (or the lowest free slot). Raises
        KeyError on double-allocation, MemoryError when no slot is free or
        the requested slot is taken."""
        if rid in self._slot_of:
            raise KeyError(f"request {rid} already holds a slot")
        if slot is None:
            free = self.free_slots()
            if not free:
                raise MemoryError("no free slots")
            slot = free[0]
        else:
            if not 0 <= slot < self.n_slots:
                raise ValueError(f"slot {slot} out of range")
            if slot in self._rid_of:
                raise MemoryError(
                    f"slot {slot} is held by request {self._rid_of[slot]}")
        self._slot_of[rid] = slot
        self._rid_of[slot] = rid
        return slot

    def free(self, rid: int) -> int:
        """Release rid's slot (retire or preempt). Returns the slot."""
        slot = self._slot_of.pop(rid)
        del self._rid_of[slot]
        return slot

    def check(self) -> None:
        """Invariants: the rid<->slot maps are a bijection within range."""
        assert len(self._slot_of) == len(self._rid_of)
        for rid, slot in self._slot_of.items():
            assert 0 <= slot < self.n_slots, (rid, slot)
            assert self._rid_of.get(slot) == rid, "slot maps disagree"


class EncoderCache(SlotStateCache):
    """Per-slot *read-only* encoder state (cross-attention K/V).

    The slot discipline of :class:`SlotStateCache`; only the encode pass
    at admission writes a slot's row, never a step, so the row is fixed
    for the bound request's whole residence (a preempted request is
    encoded again when it returns)."""


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(mamba layers, conv-tail width, per-slot ssm state elements)."""
    s = cfg.ssm
    n_mamba = sum(1 for k in cfg.layer_kinds() if k == MAMBA)
    width = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.state_dim
    return n_mamba, width, s.n_heads(cfg.d_model) * s.head_dim * s.state_dim


def init_slot_state(cfg: ModelConfig, n_slots: int, device="cuda",
                    dtype=torch.bfloat16):
    """Zero per-slot Mamba state for every mamba layer, in layer order:
    ``{"conv": (n_mamba, n_slots, K-1, d_inner + 2 G N) dtype,
    "ssm": (n_mamba, n_slots, nh, hp, N) fp32}``."""
    s = cfg.ssm
    n_mamba, width, _ = _mamba_dims(cfg)
    return {"conv": torch.zeros((n_mamba, n_slots, s.conv_kernel - 1, width),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((n_mamba, n_slots, s.n_heads(cfg.d_model),
                                s.head_dim, s.state_dim),
                               dtype=torch.float32, device=device)}


def slot_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Device bytes of one slot's Mamba state across every mamba layer."""
    if cfg.ssm is None:
        return 0
    n_mamba, width, h_elems = _mamba_dims(cfg)
    tail = (cfg.ssm.conv_kernel - 1) * width * dtype_bytes
    return n_mamba * (tail + h_elems * 4)


def init_encoder_cache(cfg: ModelConfig, n_slots: int, device="cuda",
                       dtype=torch.bfloat16, tp: int = 1):
    """Zero per-slot cross-attention K/V: {"xk", "xv"} each (L, n_slots,
    T_enc, K, hd), the layout of ``encdec.encode_cross_kv``; K / tp kv
    heads on a tensor-parallel rank."""
    shape = (cfg.num_layers, n_slots, cfg.encoder_seq_len,
             kv_heads_per_rank(cfg.num_kv_heads, tp), cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("xk", "xv")}


def encoder_cache_bytes(cfg: ModelConfig, dtype_bytes: int = 2,
                        tp: int = 1) -> int:
    """Device bytes of one slot's cross-attention K/V (on one of ``tp``
    tensor-parallel ranks)."""
    if not cfg.encoder_layers:
        return 0
    return (2 * cfg.num_layers * cfg.encoder_seq_len
            * kv_heads_per_rank(cfg.num_kv_heads, tp) * cfg.head_dim
            * dtype_bytes)
