"""Model runners for the serving engine (port of ``repro.serving.runners``).

A runner owns what is family-specific about serving one model: the device
cache it needs and the budgeted step body (the prefill chunk or the packed
chunks, then the wide decode batch, then the step's tokens). The step has
two shapes: with and without the chunk row. Decode always runs
``max_batch`` wide (idle slots are masked with ctx_len 0 and write into
the trash block); the chunk row always runs ``chunk_width`` wide, holding
one chunk or, with ``prefill_pack`` S > 1, up to S packed chunks. Logit
and token rows B .. B + S - 1 are the chunks' last-token rows.

Beside the shape, a step has a static sampling mode (``SAMPLING_MODES``):
``"greedy"`` (the argmax of every row, no random numbers), ``"plain"``
(greedy, temperature and top-k rows, drawn in the body from jax's
streams) or ``"full"`` (the whole pipeline: penalties, top-p, min-p and
logprobs). The engine picks the mode on the host from the scheduled
requests, as the JAX engine picks between its plain and full-sampling
executables.

The body reads only device tensors at fixed shapes and never the host,
so the engine can capture each (shape, mode) as a CUDA graph
(``serving.graphs``). It returns a dict of device tensors: ``"logits"``,
``"tokens"`` and, in full mode, the logprob arrays ``"chosen"``,
``"top_lp"`` and ``"top_ids"``.

Runners:

* :class:`TransformerRunner`: dense and mixture-of-experts decoders,
  everything paged KV.
* :class:`SSMRunner`: pure Mamba2, slot state only (no blocks, no
  horizon).
* :class:`HybridRunner`: zamba2, slot state for the mamba layers and paged
  KV for the shared attention block, one block table per sequence.
* :class:`EncDecRunner`: whisper, paged decoder self-KV and per-slot
  read-only cross K/V, written by an encode pass at admission.
* :class:`SpeculativeRunner`: draft-and-verify speculative decoding over
  two dense decoders, one block table indexing a target and a draft pool
  set.

Invariants the slot-state runners keep: a chunk that starts a
(re)computed sequence reads zeroed slot state, never a previous
occupant's; a chunk's new state goes back to its own slot only; an idle
decode slot keeps its state (decode writes back active rows only). The
chunk's slot and freshness are device values (``c_slot``, ``c_start ==
0``), as in the JAX package's runner.

``make_runner`` refuses what the reference refuses: a modality frontend
that needs per-request position streams (qwen2-vl's vision: its static
path serves it) and a speculative pair with a non-transformer target or
draft, or a vocabulary mismatch.
"""

from __future__ import annotations

import torch

from repro_torch.config import MAMBA, ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import local_kv_heads
from repro_torch.models.embedding import head_table
from repro_torch.serving.cache import init_encoder_cache, init_slot_state
from repro_torch.serving.kv_cache import init_paged_cache
from repro_torch.serving.sampling import (SP_KEYS, greedy_verify, one_hot,
                                          propose_tokens,
                                          propose_tokens_full, sample_tokens,
                                          sample_tokens_full,
                                          speculative_verify,
                                          speculative_verify_full)

__all__ = ["ModelRunner", "TransformerRunner", "SSMRunner", "HybridRunner",
           "EncDecRunner", "SpeculativeRunner", "SAMPLING_MODES",
           "make_runner", "sample_rows"]

SAMPLING_MODES = ("greedy", "plain", "full")


def sample_rows(logits, a, sampling: str, max_logprobs: int, lo: int = 0):
    """The tokens of (N, V_pad) logit rows whose sampling inputs are rows
    lo .. lo + N - 1 of the step inputs ``a``, in ``sampling`` mode: a
    dict with ``"tokens"`` (N,) int32 and, in full mode, the logprob
    arrays."""
    if sampling == "greedy":
        return {"tokens": torch.argmax(logits, dim=-1).to(torch.int32)}
    hi = lo + logits.shape[0]
    if sampling == "plain":
        return {"tokens": sample_tokens(
            logits, *(a[k][lo:hi] for k in ("temps", "top_ks", "seeds",
                                             "rids", "counters")))}
    toks, lp = sample_tokens_full(logits, {k: a[k][lo:hi] for k in SP_KEYS},
                                  max_logprobs=max_logprobs)
    return {"tokens": toks, **lp}


class ModelRunner:
    """Family-agnostic interface the engine programs against."""

    needs_blocks: bool = False        # paged KV pools + block tables
    needs_slots: bool = False         # constant-size per-slot SSM state
    needs_encoder: bool = False       # read-only per-slot cross K/V
    supports_prefix_caching: bool = False
    # can run multi-chunk (ragged packed-prefill) plans in one flat row
    supports_packed_prefill: bool = False
    chunk_quantum: int = 1            # chunk lengths must be multiples
                                      # (except a prompt's final chunk)
    spec_tokens: int = 0              # draft tokens per slot per step

    def __init__(self, cfg: ModelConfig, max_logprobs: int = 8):
        self.cfg = cfg
        self.max_logprobs = max_logprobs  # top-L logprob columns of the
        self.head = None                  # full path (the engine's knob)

    def bind(self, params):
        """Keep one fp32 copy of the logits table: ``decode_logits`` is a
        true fp32 product, and casting the table on every step would move
        three times its bf16 bytes. With sharded weights the table is the
        rank's vocab shard, and so is the copy."""
        self.head = head_table(params["embed"], self.cfg).float()

    def init_cache(self, num_blocks: int, block_size: int, max_batch: int,
                   device, kv_dtype: str = "bf16", tp: int = 1):
        """The device cache; with ``tp`` > 1 one tensor-parallel rank's:
        K / tp kv heads of every pool and of the cross K/V, slot state
        whole."""
        raise NotImplementedError

    def pool_sets(self, cache) -> list[dict]:
        """The cache's page-pool sets indexed by the block tables."""
        return [cache]

    def step(self, params, cache, a, *, has_chunk: bool,
             sampling: str = "greedy"):
        """The budgeted step body over the engine's step inputs ``a``
        (device tensors at fixed shapes) in a static ``sampling`` mode.
        Returns {"logits": (B + S, V_pad) fp32, "tokens": (B + S,) int32}
        and, in full mode, "chosen" (B + S,), "top_lp" and "top_ids"
        (B + S, L), all on the device."""
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
    def _n_chunk_rows(a) -> int:
        """Rows B.. of the step: the engine's prefill_pack."""
        return a["c_starts"].shape[0] if "c_starts" in a else 1

    def _outputs(self, logits_d, logits_c, a, sampling):
        """The step's outputs over (B + S, V_pad) logits; an absent
        chunk's rows are zeros."""
        if logits_c is None:
            logits_c = logits_d.new_zeros((self._n_chunk_rows(a),)
                                          + logits_d.shape[1:])
        logits = torch.cat([logits_d, logits_c], dim=0)
        return {"logits": logits,
                **sample_rows(logits, a, sampling, self.max_logprobs)}


class TransformerRunner(ModelRunner):
    """Dense and mixture-of-experts decoders: everything is paged KV, and
    prefix caching applies (KV depends only on the token prefix; a MoE
    layer's capacity drops depend on the step's batch, so at the default
    capacity a prefix hit need not reproduce the cold run's tokens, as in
    the reference)."""

    needs_blocks = True
    supports_prefix_caching = True
    supports_packed_prefill = True

    def init_cache(self, num_blocks, block_size, max_batch, device,
                   kv_dtype="bf16", tp=1):
        return init_paged_cache(self.cfg, num_blocks, block_size, device,
                                kv_dtype, tp)

    def step(self, params, cache, a, *, has_chunk, sampling="greedy"):
        logits_c = None
        if has_chunk and "c_starts" in a:
            logits_c, _ = transformer.prefill_chunk_ragged(
                params, cache, self._ragged_batch(a), self.cfg, self.head)
        elif has_chunk:
            logits_c, _ = transformer.prefill_chunk_paged(
                params, cache, self._chunk_batch(a), self.cfg, self.head)
        logits_d, _ = transformer.decode_step_paged(
            params, cache, self._decode_batch(a), self.cfg, self.head)
        return self._outputs(logits_d, logits_c, a, sampling)


class SSMRunner(ModelRunner):
    """Pure Mamba2: constant-size slot state, no blocks, no horizon.
    Prefix caching is off: a cached block id cannot stand in for the
    recurrent state that produced it. Packed prefill is off: the flat
    layout carries no per-sequence chunk state."""

    needs_slots = True

    def __init__(self, cfg: ModelConfig, max_logprobs: int = 8):
        super().__init__(cfg, max_logprobs)
        # serving chunk boundaries land on SSD chunk boundaries, so chunked
        # prefill is bit-identical to a monolithic one
        self.chunk_quantum = cfg.ssm.chunk_size

    def init_cache(self, num_blocks, block_size, max_batch, device,
                   kv_dtype="bf16", tp=1):
        if kv_dtype != "bf16":
            raise ValueError(
                f"kv_dtype={kv_dtype}: SSM/hybrid runners keep bf16 pools "
                "(slot state has no quantized form)")
        cache = (init_paged_cache(self.cfg, num_blocks, block_size, device,
                                  tp=tp)
                 if self.needs_blocks else {})
        cache.update(init_slot_state(self.cfg, max_batch, device))
        return cache

    def step(self, params, cache, a, *, has_chunk, sampling="greedy"):
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
        return self._outputs(logits_d, logits_c, a, sampling)


class HybridRunner(SSMRunner):
    """zamba2: mamba layers carry slot state, the shared attention block
    reads and writes paged KV through one block table per sequence. A
    preempted request recomputes from zeroed slot state."""

    needs_blocks = True


class EncDecRunner(ModelRunner):
    """whisper: paged decoder self-KV and read-only per-slot cross K/V,
    written by ``encode`` at admission. bf16 pools only (the cross K/V is
    per slot, not paged); prefix caching is off (the decoder KV depends on
    the request's encoder output, so equal token prefixes do not give
    equal KV), and so is packed prefill (the chunk selects its slot's
    cross row). The chunk reads its slot's cross row by the device index
    ``c_slot``; decode reads every slot's row."""

    needs_blocks = True
    needs_encoder = True

    def init_cache(self, num_blocks, block_size, max_batch, device,
                   kv_dtype="bf16", tp=1):
        if kv_dtype != "bf16":
            raise ValueError(
                f"kv_dtype={kv_dtype}: the enc-dec runner keeps bf16 pools "
                "(cross K/V is per-slot, not paged)")
        return {"self": init_paged_cache(self.cfg, num_blocks, block_size,
                                         device, tp=tp),
                "cross": init_encoder_cache(self.cfg, max_batch, device,
                                            tp=tp)}

    def pool_sets(self, cache):
        return [cache["self"]]

    def encode(self, params, cache, slot: int, frames) -> None:
        """The admission pass: the request's cross K/V (frames (T_enc,
        d_model) in the activation dtype) into row ``slot`` of the
        encoder cache, in place (the captured graphs hold its address);
        with tensor parallelism, this rank's kv heads of it."""
        kv = encdec.encode_cross_kv(params, frames[None], self.cfg)
        for name in ("xk", "xv"):
            xkv = cache["cross"][name]
            xkv[:, slot] = local_kv_heads(kv[name][:, 0], xkv.shape[-2])

    def step(self, params, cache, a, *, has_chunk, sampling="greedy"):
        logits_c = None
        if has_chunk:
            slot = a["c_slot"].long()
            cross = {n: t.index_select(1, slot)
                     for n, t in cache["cross"].items()}
            logits_c, _ = encdec.prefill_chunk_paged(
                params, {"self": cache["self"], "cross": cross},
                self._chunk_batch(a), self.cfg, self.head)
        logits_d, _ = encdec.decode_step_paged(
            params, cache, self._decode_batch(a), self.cfg, self.head)
        return self._outputs(logits_d, logits_c, a, sampling)


class SpeculativeRunner(ModelRunner):
    """Draft-and-verify speculative decoding over two dense decoders.

    A draft model proposes ``spec_tokens`` (k) tokens per slot and step;
    the target scores all k + 1 positions in one widened chunk pass
    (``prefill_chunk_paged(all_logits=True)``, the chunk kernel at C =
    k + 1); ``sampling.speculative_verify{,_full}`` accepts the longest
    agreeing prefix by rejection sampling, which preserves the target
    distribution (greedy is plain greedy).

    Draft and target KV cover the same positions (the draft writes every
    token it is fed, the verify pass writes the same k + 1 positions in
    the target's pools, chunks run through both models), so the cache is
    ``{"tgt": pools, "dft": pools}`` under one block table per request:
    one ``BlockManager``, prefix caching, copy-on-write and preemption
    cover the pair at once. Per step the draft runs k + 1 decodes (the
    last writes the final proposal's KV, so the draft never trails), the
    target one (B, k + 1) verify, and the engine rolls the rejected
    lookahead back with ``BlockManager.truncate``. ``params`` is
    ``{"tgt": ..., "dft": ...}``.

    The step's outputs: "tokens" (B, k + 1) and "n_acc" (B,) of the
    decode rows, "c_tokens" (S,) of the chunk rows and, in full mode,
    "chosen" (B, k + 1), "top_lp" / "top_ids" (B, k + 1, L) and the chunk
    rows' "c_chosen", "c_top_lp", "c_top_ids"; "logits" holds the verify
    rows (B (k + 1), V_pad) and then the chunk rows."""

    needs_blocks = True
    supports_prefix_caching = True
    supports_packed_prefill = True

    def __init__(self, cfg: ModelConfig, draft_cfg: ModelConfig,
                 spec_tokens: int, max_logprobs: int = 8):
        super().__init__(cfg, max_logprobs)
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens={spec_tokens} must be >= 0")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: draft proposals must be target ids")
        self.draft_cfg = draft_cfg
        self.spec_tokens = spec_tokens
        self.draft_head = None

    def bind(self, params):
        """fp32 logits tables of both models; a draft sharing the target's
        table shares its fp32 copy too."""
        tgt = head_table(params["tgt"]["embed"], self.cfg)
        dft = head_table(params["dft"]["embed"], self.draft_cfg)
        self.head = tgt.float()
        self.draft_head = self.head if dft is tgt else dft.float()

    def init_cache(self, num_blocks, block_size, max_batch, device,
                   kv_dtype="bf16", tp=1):
        return {"tgt": init_paged_cache(self.cfg, num_blocks, block_size,
                                        device, kv_dtype, tp),
                "dft": init_paged_cache(self.draft_cfg, num_blocks,
                                        block_size, device, kv_dtype, tp)}

    def pool_sets(self, cache):
        return [cache["tgt"], cache["dft"]]

    def _chunk(self, params, cache, a):
        """The chunk row through both models (the draft's KV must mirror
        the target's positions); the target's logits."""
        if "c_starts" in a:
            fn, batch = transformer.prefill_chunk_ragged, \
                self._ragged_batch(a)
        else:
            fn, batch = transformer.prefill_chunk_paged, self._chunk_batch(a)
        logits_c, _ = fn(params["tgt"], cache["tgt"], batch, self.cfg,
                         self.head)
        fn(params["dft"], cache["dft"], batch, self.draft_cfg,
           self.draft_head)
        return logits_c

    def step(self, params, cache, a, *, has_chunk, sampling="greedy"):
        k = self.spec_tokens
        B = a["d_tok"].shape[0]
        full = sampling == "full"
        logits_c = self._chunk(params, cache, a) if has_chunk else None
        active, pos = a["d_active"], a["d_pos"]
        cnts = a["counters"][:B]
        plain = [a[n][:B] for n in ("temps", "top_ks", "seeds", "rids")]
        sp_d = {n: a[n][:B] for n in SP_KEYS} if full else None
        # committed counts plus each proposal's one-hot, so proposal i
        # and verify row i see the same penalty counts
        oc = a["ocounts"][:B] if full else None
        # draft: k proposals, k + 1 KV writes (the last backs the final
        # proposal, so the draft cache mirrors the target's)
        toks, dlogits = [a["d_tok"]], []
        for i in range(k + 1 if k else 0):
            db = {"token": toks[-1][:, None], "pos": pos + i,
                  "block_tables": a["d_tables"],
                  "ctx_lens": torch.where(active, pos + i + 1, 0).to(
                      torch.int32)}
            lg, _ = transformer.decode_step_paged(
                params["dft"], cache["dft"], db, self.draft_cfg,
                self.draft_head)
            if i == k:
                break
            dlogits.append(lg)
            if sampling == "greedy":
                nt = torch.argmax(lg, dim=-1).to(torch.int32)
            elif sampling == "plain":
                nt = propose_tokens(lg, plain[0], plain[1], plain[2],
                                    plain[3], cnts + i)
            else:
                nt = propose_tokens_full(
                    lg, dict(sp_d, ocounts=oc, counters=cnts + i))
                oc = oc + one_hot(nt, lg.shape[-1])
            toks.append(nt)
        # verify: one widened target pass over the k + 1 positions
        verify = torch.stack(toks, dim=1)                        # (B, k+1)
        vb = {"tokens": verify, "q_start": pos,
              "q_lens": torch.where(active, k + 1, 0).to(torch.int32),
              "block_tables": a["d_tables"],
              "ctx_lens": torch.where(active, pos + k + 1, 0).to(
                  torch.int32)}
        tlogits, _ = transformer.prefill_chunk_paged(
            params["tgt"], cache["tgt"], vb, self.cfg, self.head,
            all_logits=True)
        V = tlogits.shape[-1]
        dl = (torch.stack(dlogits, dim=1) if dlogits
              else tlogits.new_zeros((B, 0, V)))
        out = {}
        if sampling == "greedy":
            out["tokens"], out["n_acc"] = greedy_verify(verify[:, 1:],
                                                        tlogits)
        elif sampling == "plain":
            out["tokens"], out["n_acc"] = speculative_verify(
                verify[:, 1:], dl, tlogits, *plain, cnts)
        else:
            out["tokens"], out["n_acc"], lp = speculative_verify_full(
                verify[:, 1:], dl, tlogits, sp_d,
                max_logprobs=self.max_logprobs)
            out.update(lp)
        S = self._n_chunk_rows(a)
        if logits_c is None:
            logits_c = tlogits.new_zeros((S, V))
        c = sample_rows(logits_c, a, sampling, self.max_logprobs, lo=B)
        out.update({"c_" + n: v for n, v in c.items()})
        out["logits"] = torch.cat([tlogits.reshape(-1, V), logits_c])
        return out


def make_runner(cfg: ModelConfig, *, draft_cfg: ModelConfig | None = None,
                num_speculative_tokens: int = 0,
                max_logprobs: int = 8) -> ModelRunner:
    """Family dispatch. Raises the reference's ValueError for a vision
    frontend (it needs per-request position streams). A draft config (or
    k > 0, which drafts with the target's config) gives a
    :class:`SpeculativeRunner`; target and draft must both be paged
    transformers (ValueError otherwise, as in the reference)."""
    if cfg.frontend == "vision":
        raise ValueError(
            f"no serving runner for {cfg.name}: modality frontends need "
            "per-request position streams")
    if num_speculative_tokens and draft_cfg is None:
        draft_cfg = cfg
    if draft_cfg is not None:
        base, draft = make_runner(cfg), make_runner(draft_cfg)
        if type(base) is not TransformerRunner \
                or type(draft) is not TransformerRunner:
            raise ValueError(
                "speculative decoding needs paged-transformer target and "
                f"draft, got {type(base).__name__} target / "
                f"{type(draft).__name__} draft")
        return SpeculativeRunner(cfg, draft_cfg, num_speculative_tokens,
                                 max_logprobs)
    if cfg.encoder_layers:
        return EncDecRunner(cfg, max_logprobs)
    if cfg.ssm is not None:
        if cfg.shared_attn_period or any(k != MAMBA
                                         for k in cfg.block_pattern):
            return HybridRunner(cfg, max_logprobs)
        return SSMRunner(cfg, max_logprobs)
    return TransformerRunner(cfg, max_logprobs)
