"""Model runners for the serving engine (port of ``repro.serving.runners``).

A runner owns what is family-specific about serving one model: the device
cache it needs and the budgeted step body (the prefill chunk or the packed
chunks, then the wide decode batch, then the greedy tokens). The step has
exactly two shapes: with and without the chunk row. Decode always runs
``max_batch`` wide (idle slots are masked with ctx_len 0 and write into
the trash block); the chunk row always runs ``chunk_width`` wide, holding
one chunk or, with ``prefill_pack`` S > 1, up to S packed chunks. Logit
and token rows B .. B + S - 1 are the chunks' last-token rows.

The body reads only device tensors at fixed shapes and never the host,
so the engine can capture it as a CUDA graph (``serving.graphs``). Rows
with a temperature are drawn after it (``sampling.draw_rows``), from its
logits.

Runners:

* :class:`TransformerRunner`: dense decoders, everything paged KV.
* :class:`SSMRunner`: pure Mamba2, slot state only (no blocks, no
  horizon).
* :class:`HybridRunner`: zamba2, slot state for the mamba layers and paged
  KV for the shared attention block, one block table per sequence.

Invariants the slot-state runners keep: a chunk that starts a
(re)computed sequence reads zeroed slot state, never a previous
occupant's; a chunk's new state goes back to its own slot only; an idle
decode slot keeps its state (decode writes back active rows only). The
chunk's slot and freshness are device values (``c_slot``, ``c_start ==
0``), as in the JAX package's runner.

``make_runner`` refuses the other families and speculative decoding,
naming the ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch.config import MAMBA, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.embedding import head_table
from repro_torch.serving.cache import init_slot_state
from repro_torch.serving.kv_cache import init_paged_cache

__all__ = ["ModelRunner", "TransformerRunner", "SSMRunner", "HybridRunner",
           "make_runner"]


class ModelRunner:
    """Family-agnostic interface the engine programs against."""

    needs_blocks: bool = False        # paged KV pools + block tables
    needs_slots: bool = False         # constant-size per-slot SSM state
    supports_prefix_caching: bool = False
    # can run multi-chunk (ragged packed-prefill) plans in one flat row
    supports_packed_prefill: bool = False
    chunk_quantum: int = 1            # chunk lengths must be multiples
                                      # (except a prompt's final chunk)

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.head = None

    def bind(self, params):
        """Keep one fp32 copy of the logits table: ``decode_logits`` is a
        true fp32 product, and casting the table on every step would move
        three times its bf16 bytes."""
        self.head = head_table(params["embed"], self.cfg).float()

    def init_cache(self, num_blocks: int, block_size: int, max_batch: int,
                   device, kv_dtype: str = "bf16"):
        raise NotImplementedError

    def step(self, params, cache, a, *, has_chunk: bool):
        """The budgeted step body over the engine's step inputs ``a``
        (device tensors at fixed shapes). Returns (logits (B + S, V_pad)
        fp32, greedy tokens (B + S,) int32), both on the device."""
        raise NotImplementedError

    @staticmethod
    def _chunk_batch(a):
        return {"tokens": a["c_tok"], "q_start": a["c_start"],
                "q_lens": a["c_len"], "block_tables": a["c_table"],
                "ctx_lens": a["c_start"] + a["c_len"]}

    @staticmethod
    def _ragged_batch(a):
        """Packed multi-chunk prefill batch (``prefill_pack > 1``): one
        flat (1, C) token row carrying several sequences' chunks, each
        owning flat positions [starts[s], ends[s])."""
        return {"tokens": a["c_tok"], "positions": a["c_pos"],
                "starts": a["c_starts"], "ends": a["c_ends"],
                "row_seq": a["c_seq"], "block_tables": a["c_tables"],
                "ctx_lens": a["c_ctx"]}

    @staticmethod
    def _decode_batch(a):
        ctx_lens = torch.where(a["d_active"], a["d_pos"] + 1, 0)
        return {"token": a["d_tok"][:, None], "pos": a["d_pos"],
                "block_tables": a["d_tables"],
                "ctx_lens": ctx_lens.to(torch.int32)}

    @staticmethod
    def _outputs(logits_d, logits_c, a):
        """(logits (B + S, V_pad), greedy tokens (B + S,) int32); an absent
        chunk's rows are zeros."""
        if logits_c is None:
            # rows B.. are sized for the engine's prefill_pack
            n_extra = a["c_starts"].shape[0] if "c_starts" in a else 1
            logits_c = logits_d.new_zeros((n_extra,) + logits_d.shape[1:])
        logits = torch.cat([logits_d, logits_c], dim=0)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)


class TransformerRunner(ModelRunner):
    """Dense decoder-only attention models: everything is paged KV, and
    prefix caching applies (KV depends only on the token prefix)."""

    needs_blocks = True
    supports_prefix_caching = True
    supports_packed_prefill = True

    def init_cache(self, num_blocks, block_size, max_batch, device,
                   kv_dtype="bf16"):
        return init_paged_cache(self.cfg, num_blocks, block_size, device,
                                kv_dtype)

    def step(self, params, cache, a, *, has_chunk):
        logits_c = None
        if has_chunk and "c_starts" in a:
            logits_c, _ = transformer.prefill_chunk_ragged(
                params, cache, self._ragged_batch(a), self.cfg, self.head)
        elif has_chunk:
            logits_c, _ = transformer.prefill_chunk_paged(
                params, cache, self._chunk_batch(a), self.cfg, self.head)
        logits_d, _ = transformer.decode_step_paged(
            params, cache, self._decode_batch(a), self.cfg, self.head)
        return self._outputs(logits_d, logits_c, a)


class SSMRunner(ModelRunner):
    """Pure Mamba2: constant-size slot state, no blocks, no horizon.
    Prefix caching is off: a cached block id cannot stand in for the
    recurrent state that produced it. Packed prefill is off: the flat
    layout carries no per-sequence chunk state."""

    needs_slots = True

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        # serving chunk boundaries land on SSD chunk boundaries, so chunked
        # prefill is bit-identical to a monolithic one
        self.chunk_quantum = cfg.ssm.chunk_size

    def init_cache(self, num_blocks, block_size, max_batch, device,
                   kv_dtype="bf16"):
        if kv_dtype != "bf16":
            raise ValueError(
                f"kv_dtype={kv_dtype}: SSM/hybrid runners keep bf16 pools "
                "(slot state has no quantized form)")
        cache = (init_paged_cache(self.cfg, num_blocks, block_size, device)
                 if self.needs_blocks else {})
        cache.update(init_slot_state(self.cfg, max_batch, device))
        return cache

    def step(self, params, cache, a, *, has_chunk):
        logits_c = None
        if has_chunk:
            # the chunk's slot-state rows, gathered by the device index
            # c_slot; the first chunk after (re)admission (c_start == 0)
            # starts from zeros, never from a previous occupant's state;
            # the new state goes back to that slot only
            slot = a["c_slot"].long()
            fresh = (a["c_start"] == 0).reshape(())
            chunk_cache = dict(cache)
            for key in ("conv", "ssm"):
                st = cache[key].index_select(1, slot)
                chunk_cache[key] = torch.where(fresh, torch.zeros_like(st),
                                               st)
            logits_c, _ = transformer.prefill_chunk_paged(
                params, chunk_cache, self._chunk_batch(a), self.cfg,
                self.head)
            for key in ("conv", "ssm"):
                cache[key].index_copy_(1, slot, chunk_cache[key])
        # every slot is computed; idle slots (ctx_len 0) keep their state
        logits_d, _ = transformer.decode_step_paged(
            params, cache, self._decode_batch(a), self.cfg, self.head)
        return self._outputs(logits_d, logits_c, a)


class HybridRunner(SSMRunner):
    """zamba2: mamba layers carry slot state, the shared attention block
    reads and writes paged KV through one block table per sequence. A
    preempted request recomputes from zeroed slot state."""

    needs_blocks = True


def make_runner(cfg: ModelConfig, *, draft_cfg: ModelConfig | None = None,
                num_speculative_tokens: int = 0) -> ModelRunner:
    """Family dispatch; raises NotImplementedError naming the missing slice
    for everything but dense, SSM and hybrid decoders."""
    if draft_cfg is not None or num_speculative_tokens:
        raise NotImplementedError(
            "speculative decoding is not ported yet (ROADMAP.md queue 1 "
            "item 8)")
    why = transformer.unported(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why} are not ported yet")
    if cfg.ssm is not None:
        if cfg.shared_attn_period or any(k != MAMBA
                                         for k in cfg.block_pattern):
            return HybridRunner(cfg)
        return SSMRunner(cfg)
    return TransformerRunner(cfg)
