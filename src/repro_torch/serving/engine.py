"""Continuous-batching inference engine (port of
``repro.serving.engine`` for dense, MoE, SSM and hybrid decoders and the
encoder-decoder).

One ``InferenceEngine`` owns the model parameters, a runner, the device
cache, the host caches the runner needs (a ``BlockManager`` for paged KV,
a ``SlotStateCache`` for Mamba state, an ``EncoderCache`` for the cross
K/V), the per-slot sampling state (a ``SamplingBuffer``) and a
``Scheduler``. Every iteration is one budgeted step:

    plan = scheduler.schedule()      # decodes (1 token each) + chunks
    the encode passes of the step's enc-dec admissions (eager: each
        writes its slot's cross K/V row in place)
    apply COW page copies
    pick the step's sampling mode on the host: "greedy" (every scheduled
        request greedy), "plain" (temperature / top-k) or "full" (some
        request needs penalties, top-p, min-p or logprobs)
    fill the step inputs: fixed-shape device buffers, written through one
        pinned host staging area and uploaded in one copy (the full
        path's parameter rows and (B + S, V_pad) count rows in a second
        area, allocated at the first full step)
    host copies: the swap-outs' device -> host gather first (on the
        pre-step pools), then the swap-ins and shared-index adoptions
        into the pools (before the COW copies, which may read them)
    runner step body: the chunk (if any; with prefill_pack S > 1, up to S
        chunks packed into one flat row), then the max_batch-wide decode
        batch, then the tokens, drawn in the body from jax's threefry
        streams (``serving.prng``)
    one device-to-host copy of the step's tokens (and logprobs); append
        them; retire on EOS / stop sequence / max_new; publish the content
        hashes of newly full blocks (with a shared index, also their pages)

On a card the step body runs as a CUDA graph per (shape, mode), each
captured at its first step (``serving.graphs``), as the JAX engine runs
its two plain executables and compiles its full-sampling ones lazily.
``cuda_graphs=False`` runs the same body eagerly on the card (for A/B
runs and tests); the CPU always runs it eagerly.

With speculative decoding (``num_speculative_tokens`` = k, a draft config
or the target's own) the decode half is the draft-and-verify step of
``runners.SpeculativeRunner``; the host appends each slot's accepted
prefix and the corrected (or bonus) token, then rewinds the rejected
lookahead blocks with ``BlockManager.truncate``.

Time is measured in engine steps; request arrivals are given in the same
unit, so runs are deterministic. Everything runs on ``device`` ("cuda"
unless the caller asks for "cpu"); there is no fallback between the two.

KV pools are bf16, int8 or fp8 (``kv_dtype``; the narrow ones with fp32
per-row scales, dequantized inside the attention kernels); SSM, hybrid
and enc-dec runners keep bf16 pools (fp32 Mamba state; bf16 cross K/V).

On a card the engine runs its steps, copies and captures on a stream of
its own (``self.stream``) under the process-wide ``graphs.DEVICE_LOCK``,
so several engines (the data-parallel replicas of ``serving.router``,
each stepped by its own thread) share one card one step at a time.

The host tiers (``swap_space_bytes``; a cross-replica ``shared_index``)
move whole blocks between the pools and pinned host tensors allocated
here, once: 1-byte pools through their ``uint8`` view. The copies write
the pools in place, so the captured graphs, which hold the pools'
addresses, read what was copied. ``abort`` cancels a request between
steps.

Tensor parallelism (``mesh``, a ``launch.mesh.make_host_mesh`` mesh whose
"model" axis has tp > 1 ranks; one engine a rank): every rank holds K /
tp kv heads of each page pool (and of whisper's cross K/V) and attends
its own heads. Host state (block tables, refcounts, hashes, the
scheduler) is global and identical on every rank: rank 0 of the group
owns submissions and aborts (``run()``, the async driver, ``abort``), and
each ``step()`` first broadcasts what it received since the last step,
its drain flag, its clock and its swap cost model's rates; the other
ranks run ``follow()``, which replays them and steps, until rank 0's
``close()``. The group is the "model" axis (each data replica drives its
own), or the whole mesh where a MoE block sums or splits over "data"
too (a MoE model on a data axis).

What a mesh computes (docs/torch-serving-mesh.md):
- Weights whole on every rank (``shard_params=False``, the default): a
  rank gathers its heads exactly before ``out_proj`` (``models.
  attention``), so a dense model's every contraction runs whole, in one
  device's order: its outputs are the tp = 1 engine's bits. A MoE block
  runs the reference's mode for the mesh (``models.moe``: "ep_psum" at
  decode, "ep_a2a" on chunks tp divides, "tp", grok-1's ``f2d``), each
  rank taking its experts or d_ff columns from the whole leaves: its sums
  run in another order, and under "ep_a2a" each rank's capacity is its
  own (other assignments drop), so a MoE engine on a mesh is
  argmax-close to tp = 1, not bitwise, as in the reference.
- Sharded weights (``shard_params=True``; dense and MoE decoders, the
  speculative draft under the same rules): each rank holds its cut of
  every weight (``spmd.sharding.serving_layouts``): query and kv heads,
  ff, vocab rows of the table and head over "model", the MoE leaves in
  the cut their block's mode reads. The attention and MLP outputs are
  partial sums over "model", the logits rows each rank's vocab shard,
  gathered exactly. The sums reorder, so the outputs are argmax-close to
  tp = 1 (the reference's "only argmax-close"). The weights are cut as
  they are drawn (``init_model``'s ``place``), one layer at a time, so no
  rank ever holds the whole model; given ``params`` are cut on the same
  rule. The SSM, hybrid, encoder-decoder and VLM families are refused
  (ROADMAP.md queue 1 item 12), as is ``pcfg.fsdp``.
``stats`` gains each rank's ``weight_bytes`` and the MoE block's calls by
mode (``moe_modes``).
Under ``debug_invariants`` the ranks compare a digest of every step plan.
The tensor-parallel engine runs eagerly, and refuses CUDA graphs and a
shared index (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import time
from collections import deque

import numpy as np
import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models import quant
from repro_torch.models.api import init_model
from repro_torch.models.transformer import PAGE_POOLS
from repro_torch.serving.cache import (EncoderCache, SlotStateCache,
                                      encoder_cache_bytes, slot_state_bytes)
from repro_torch.serving.graphs import DEVICE_LOCK, CompiledSteps
from repro_torch.serving.kv_cache import TRASH_BLOCK, BlockManager, block_bytes
from repro_torch.serving.runners import make_runner
from repro_torch.serving.sampling import SamplingBuffer
from repro_torch.serving.scheduler import (Request, SamplingParams, Scheduler,
                                           StepPlan, SwapCostModel)
from repro_torch.serving.stats import Histogram, SECONDS_BUCKETS, STEP_BUCKETS
from repro_torch.spmd import collectives
from repro_torch.spmd import sharding as shd

__all__ = ["InferenceEngine", "Request", "SamplingParams"]

# oldest completed per-request latency records are dropped past this; every
# retirement is first aggregated into the fixed-size histograms
LATENCY_RECORD_CAP = 4096


def pack_ragged(rows: list[np.ndarray], width: int,
                max_seqs: int) -> tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
    """Pack variable-length rows back to back into the flat ragged layout:
    ``(tok (width,), seq (width,), starts (S,), ends (S,))``, row i owning
    flat positions ``[starts[i], ends[i])`` and ``seq`` holding each flat
    position's owner. Pad positions keep owner 0 but fall outside every
    ``[start, end)``, so ownership masks reject them."""
    if len(rows) > max_seqs or sum(len(r) for r in rows) > width:
        raise ValueError(f"{len(rows)} rows of {sum(len(r) for r in rows)} "
                         f"tokens do not fit {max_seqs} x {width}")
    tok = np.zeros(width, np.int32)
    seq = np.zeros(width, np.int32)
    starts = np.zeros(max_seqs, np.int32)
    ends = np.zeros(max_seqs, np.int32)
    off = 0
    for i, r in enumerate(rows):
        n = len(r)
        tok[off:off + n] = r
        seq[off:off + n] = i
        starts[i], ends[i] = off, off + n
        off += n
    return tok, seq, starts, ends


def unpack_ragged(tok: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                  n_rows: int) -> list[np.ndarray]:
    """Inverse of :func:`pack_ragged` for the first ``n_rows`` rows."""
    return [np.asarray(tok[starts[i]:ends[i]]).copy()
            for i in range(n_rows)]


def step_input_shapes(B: int, C: int, nb: int, S: int) -> dict:
    """{name: (shape, dtype)} of one engine's step inputs: max_batch B,
    chunk width C, block-table width nb, prefill_pack S. Rows 0..B-1 of
    the sampling inputs are the decode slots, B.. the chunks."""
    i32 = torch.int32
    shapes = {"d_tok": ((B,), i32), "d_pos": ((B,), i32),
              "d_tables": ((B, nb), i32), "d_active": ((B,), torch.bool),
              "c_tok": ((1, C), i32)}
    if S == 1:
        shapes.update({"c_start": ((1,), i32), "c_len": ((1,), i32),
                       "c_table": ((1, nb), i32), "c_slot": ((1,), i32)})
    else:
        # flat ragged layout: chunk ci owns rows [c_starts[ci], c_ends[ci])
        # of the (1, C) token row; pad rows are owned by nobody, so their
        # KV lands in the trash block and their logits are discarded
        shapes.update({"c_pos": ((1, C), i32), "c_seq": ((C,), i32),
                       "c_starts": ((S,), i32), "c_ends": ((S,), i32),
                       "c_ctx": ((S,), i32), "c_tables": ((S, nb), i32)})
    # the plain path's sampling rows, int32 as the reference fills them
    shapes["temps"] = ((B + S,), torch.float32)
    for name in ("top_ks", "seeds", "rids", "counters"):
        shapes[name] = ((B + S,), i32)
    return shapes


def full_input_shapes(N: int, V: int) -> dict:
    """The full path's extra step inputs over N = B + S rows of V_pad
    columns: parameter rows and the count state."""
    f32 = torch.float32
    shapes = {name: ((N,), f32) for name in ("top_ps", "min_ps", "rep_pens",
                                              "pres_pens", "freq_pens")}
    shapes.update({"pmask": ((N, V), torch.bool),
                   "ocounts": ((N, V), torch.int32)})
    return shapes


# inputs whose default is not zero: block tables point at the trash block,
# the full path's multiplicative parameters are the identity
INPUT_DEFAULTS = {"d_tables": TRASH_BLOCK, "c_table": TRASH_BLOCK,
                  "c_tables": TRASH_BLOCK, "top_ps": 1.0, "rep_pens": 1.0}


def _i32(x: int) -> int:
    """An int wrapped into int32, as the reference's int32 inputs hold
    it (a seed of 2^31 or more turns negative)."""
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


class StepInputs:
    """A step's inputs in fixed-shape buffers, allocated once: per area,
    one host staging area (pinned for a card) and one device buffer of the
    same bytes, each input a view of both (``host``: numpy arrays,
    ``dev``: tensors, one dict over every area). ``reset`` sets an area's
    inputs to their defaults, the caller writes the host views, ``upload``
    copies the area to the device in one transfer on the current stream.
    The device tensors keep their addresses for the engine's life, as a
    captured graph needs. Area 0 is the step's own inputs; ``add`` appends
    another (the full path's, at its first step)."""

    def __init__(self, shapes: dict, device):
        self.device = torch.device(device)
        self.host, self.dev = {}, {}
        self.areas = []                   # (host bytes, device bytes, names)
        self.add(shapes)

    def add(self, shapes: dict) -> int:
        """Allocate an area for ``shapes``; returns its index."""
        offsets, total = {}, 0
        for name, (shape, dtype) in shapes.items():
            offsets[name] = total
            nbytes = int(np.prod(shape)) * dtype.itemsize
            total += -(-nbytes // 16) * 16        # 16-byte aligned views
        pin = self.device.type == "cuda"
        host_bytes = torch.zeros(total, dtype=torch.uint8, pin_memory=pin)
        dev_bytes = torch.zeros(total, dtype=torch.uint8, device=self.device)
        host_np = host_bytes.numpy()
        for name, (shape, dtype) in shapes.items():
            lo = offsets[name]
            hi = lo + int(np.prod(shape)) * dtype.itemsize
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            self.host[name] = host_np[lo:hi].view(np_dtype).reshape(shape)
            self.dev[name] = dev_bytes[lo:hi].view(dtype).view(shape)
        self.areas.append((host_bytes, dev_bytes, tuple(shapes)))
        return len(self.areas) - 1

    def reset(self, area: int = 0) -> None:
        """Every input of ``area`` to its default: zeros, block tables the
        trash block (a decode slot inactive, no chunk), identity sampling
        parameters."""
        host_bytes, _, names = self.areas[area]
        host_bytes.zero_()
        for name in names:
            if name in INPUT_DEFAULTS:
                self.host[name][...] = INPUT_DEFAULTS[name]

    def null_step(self) -> None:
        """Inputs that change no state but the trash block's, uploaded:
        no decode slot active, an empty chunk that does not start its
        sequence (so a slot-state chunk keeps its row as it is)."""
        for area in range(len(self.areas)):
            self.reset(area)
            if area:
                self.upload(area)
        if "c_start" in self.host:
            self.host["c_start"][0] = 1
        self.upload()

    def upload(self, area: int = 0) -> None:
        """Host staging -> device buffer, asynchronously on the current
        stream (the engine synchronizes at the end of every step, before
        the host writes the staging area again)."""
        host_bytes, dev_bytes, _ = self.areas[area]
        dev_bytes.copy_(host_bytes, non_blocking=True)


def _mode(reqs) -> str:
    """The step's sampling mode over its scheduled requests: "full" when
    one needs the pipeline, else "plain" when one has a temperature, else
    "greedy"."""
    if any(r.sampling.needs_pipeline for r in reqs):
        return "full"
    if any(r.sampling.temperature > 0 for r in reqs):
        return "plain"
    return "greedy"


def _replay_name(key) -> str:
    has_chunk, mode = key
    name = "chunk" if has_chunk else "decode"
    return name if mode == "greedy" else f"{name}/{mode}"


def _refuse_tp(what: str):
    raise NotImplementedError(
        f"{what} is not ported for tensor-parallel serving yet (ROADMAP.md "
        "queue 1 item 12)")


class _LoggedScheduler(Scheduler):
    """Rank 0's scheduler under tensor parallelism: it records every
    submission and abort in ``log``, which the next step broadcasts to
    the group's other ranks."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.log = []

    def add(self, req: Request) -> None:
        super().add(req)
        self.log.append(("add", req))

    def abort(self, rid: int) -> bool:
        ok = super().abort(rid)
        self.log.append(("abort", rid))
        return ok


def plan_digest(plan: StepPlan) -> str:
    """A digest of what a step plan does: requests by rid, slots, chunk
    lengths, block copies and moves."""
    rows = (plan.spec_tokens, plan.admitted,
            [(s, r.rid) for s, r in plan.decodes],
            [(s, r.rid, n) for s, r, n in plan.chunks], plan.copies,
            plan.swap_outs, plan.swap_ins, plan.shared_ins,
            [(s, r.rid) for s, r in plan.encodes])
    return hashlib.sha256(repr(rows).encode()).hexdigest()


def _runs(pairs):
    """Split (a, b) index pairs into maximal runs consecutive in both:
    [(a0, b0, n), ...], a run covering (a0 + j, b0 + j) for j < n: one
    copy of n contiguous rows."""
    out = []
    for a, b in pairs:
        if out:
            a0, b0, n = out[-1]
            if a == a0 + n and b == b0 + n:
                out[-1] = (a0, b0, n + 1)
                continue
        out.append((a, b, 1))
    return out


def weight_bytes(tree) -> int:
    """Bytes of every tensor leaf of a parameter tree."""
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(weight_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


# families whose weights a serving mesh can shard (shard_params=True)
SHARDED_FAMILIES = ("dense", "moe")


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 pcfg: ParallelConfig | None = None,
                 max_batch: int = 8, block_size: int = 16,
                 max_len: int = 128, num_blocks: int | None = None,
                 max_num_batched_tokens: int | None = None,
                 enable_prefix_caching: bool = True,
                 debug_invariants: bool = False, seed: int = 0, params=None,
                 prefill_pack: int = 1, kv_dtype: str = "bf16",
                 draft_cfg: ModelConfig | None = None,
                 num_speculative_tokens: int = 0, draft_params=None,
                 max_logprobs: int = 8, max_stop_len: int = 8,
                 swap_space_bytes: int = 0, swap_policy: str = "auto",
                 shared_index=None, mesh=None, shard_params: bool = False,
                 cuda_graphs: bool | None = None):
        self.pcfg = pcfg or ParallelConfig(remat="none")
        # tensor parallelism over the mesh's "model" axis: pools and the
        # cross K/V shard by kv head, slot state stays whole, weights too
        # unless shard_params
        self.tp = shd.serving_tp(mesh)
        dp = shd.mesh_shape(mesh).get("data", 1)
        # as in the reference, shard_params needs a "model" axis
        self.shard_params = bool(shard_params) and self.tp > 1
        if self.shard_params:
            for c in (cfg, draft_cfg):
                if c is not None and c.family not in SHARDED_FAMILIES:
                    _refuse_tp(f"shard_params=True for {c.name} (the "
                               f"{c.family} family; sharded weights serve "
                               "the dense and MoE decoders)")
            if self.pcfg.fsdp:
                _refuse_tp("shard_params=True with pcfg.fsdp (weights "
                           "sharded over \"data\")")
        moe = any(c is not None and c.moe is not None
                  for c in (cfg, draft_cfg))
        # the whole mesh steps together where a MoE block sums or splits
        # over "data"; else each "model" group on its own
        lockstep = moe and dp > 1
        meshed = self.tp > 1 or lockstep
        if meshed and cuda_graphs:
            _refuse_tp("cuda_graphs=True (collectives under CUDA graphs)")
        if meshed and shared_index is not None:
            _refuse_tp("shared_index (a router over tensor-parallel "
                       "engines)")
        self.serve_mesh = collectives.ServeMesh(
            mesh, f2d=self.pcfg.expert_ff_2d) if meshed else None
        if kv_dtype not in quant.KV_DTYPES:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} not in {sorted(quant.KV_DTYPES)}")
        if num_speculative_tokens and draft_cfg is None:
            draft_cfg = cfg          # self-speculation (a fresh draft unless
            #                          draft_params shares the weights)
        self.draft_cfg = draft_cfg
        self.runner = make_runner(                  # raises if unsupported
            cfg, draft_cfg=draft_cfg,
            num_speculative_tokens=num_speculative_tokens,
            max_logprobs=max_logprobs)
        if self.tp > 1 and self.runner.needs_blocks:
            # pools shard by whole kv heads (target and draft alike): fail
            # here, not in a step
            shd.kv_heads_per_rank(cfg.num_kv_heads, self.tp)
            if draft_cfg is not None:
                shd.kv_heads_per_rank(draft_cfg.num_kv_heads, self.tp)
        sm = self.serve_mesh
        self.group = (None if sm is None else sm.both if lockstep
                      else sm.model)
        spec = self.runner.spec_tokens
        self.cfg = cfg
        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        if cuda_graphs is None:
            cuda_graphs = on_card and sm is None
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True on {self.device}: CUDA "
                             "graphs need a CUDA device")
        self.block_size = block_size
        self.max_len = max_len
        # block-table rows widened past max_len by the speculative
        # lookahead: a verify step writes up to spec positions past the
        # context, even for a request that retires before using them
        self.max_blocks_per_seq = -(-max_len // block_size) \
            + -(-spec // block_size)
        if num_blocks is None:
            # every slot can reach max_len (+ lookahead); +1 trash block
            num_blocks = max_batch * self.max_blocks_per_seq + 1
        if max_num_batched_tokens is None:
            max_num_batched_tokens = max_batch * (1 + spec) + 2 * block_size
        self.max_num_batched_tokens = max_num_batched_tokens
        # fixed chunk width: a full decode batch plus a full chunk stay in
        # the budget, and no chunk is longer than max_len
        self.chunk_width = min(
            max_num_batched_tokens - max_batch * (1 + spec), max_len)
        # packed prefill: several prompts' chunks share one flat row per
        # step, for runners that have a ragged prefill path
        if not self.runner.supports_packed_prefill:
            prefill_pack = 1
        self.prefill_pack = max(1, prefill_pack)
        self.kv_dtype = kv_dtype
        # host tiers, sized in device blocks: one block id costs its pages
        # in every pool set (a speculative engine's draft pools too). Only
        # pure paged runners qualify: slot state has no block-swap form.
        self._dev_block_bytes = 0
        if self.runner.needs_blocks:
            self._dev_block_bytes = block_bytes(cfg, block_size, tp=self.tp,
                                                kv_dtype=kv_dtype)
            if draft_cfg is not None:
                self._dev_block_bytes += block_bytes(draft_cfg, block_size,
                                                     tp=self.tp,
                                                     kv_dtype=kv_dtype)
        swap_capable = (self.runner.needs_blocks
                        and not self.runner.needs_slots
                        and not self.runner.needs_encoder)
        if swap_space_bytes and not swap_capable:
            raise ValueError(
                "swap_space_bytes requires a pure paged-KV runner (slot "
                "state and encoder caches have no block-swap form)")
        if shared_index is not None and not swap_capable:
            raise ValueError(
                "shared_index (cross-replica prefix sharing) requires a "
                "pure paged-KV runner — the transfer unit is a hashed "
                "block, which slot-state and encoder caches don't have")
        if shared_index is not None and not enable_prefix_caching:
            raise ValueError(
                "shared_index requires enable_prefix_caching=True: the "
                "shared unit is the content-hashed block")
        if swap_policy not in ("auto", "always", "never"):
            raise ValueError(f"swap_policy={swap_policy!r} not in "
                             "('auto', 'always', 'never')")
        self.shared_index = shared_index
        num_host_blocks = (swap_space_bytes // self._dev_block_bytes
                           if swap_space_bytes and self._dev_block_bytes
                           else 0)
        self._swap_cost = (SwapCostModel(block_bytes=self._dev_block_bytes,
                                         policy=swap_policy)
                           if num_host_blocks > 0 else None)
        # host caches: blocks for paged KV, slots for Mamba state
        self.bm = (BlockManager(num_blocks, block_size,
                                num_host_blocks=num_host_blocks,
                                shared_index=shared_index)
                   if self.runner.needs_blocks else None)
        self.slot_cache = (SlotStateCache(max_batch)
                           if self.runner.needs_slots else None)
        self.encoder_cache = (EncoderCache(max_batch)
                              if self.runner.needs_encoder else None)
        # prefix caching needs KV that is a pure function of the token
        # prefix: only the paged transformer qualifies
        enable_prefix_caching = (enable_prefix_caching
                                 and self.runner.supports_prefix_caching)
        # the full path's per-slot state, V_pad columns wide (the logit
        # rows' width; ids past the vocabulary are never counted)
        self.samp_buf = SamplingBuffer(max_batch, cfg.vocab_size,
                                       width=cfg.padded_vocab_size,
                                       max_stop_len=max_stop_len,
                                       max_logprobs=max_logprobs)
        # rank 0 of a tensor-parallel group logs what its scheduler gets
        sched_cls = (_LoggedScheduler
                     if self.group is not None and self.group.rank == 0
                     else Scheduler)
        self.sched = sched_cls(self.bm, max_batch, self.max_blocks_per_seq,
                               max_num_batched_tokens, self.chunk_width,
                               enable_prefix_caching=enable_prefix_caching,
                               chunk_quantum=self.runner.chunk_quantum,
                               slot_cache=self.slot_cache,
                               max_context=-(-max_len // block_size)
                               * block_size, prefill_pack=self.prefill_pack,
                               spec_tokens=spec,
                               sampling_buffer=self.samp_buf,
                               swap_cost=self._swap_cost,
                               encoder_cache=self.encoder_cache)
        self.max_batch = max_batch
        self.debug_invariants = debug_invariants
        params = self._weights(cfg, params, seed, mesh)
        if draft_cfg is not None:
            draft_params = self._weights(draft_cfg, draft_params, seed + 1,
                                         mesh)
            params = {"tgt": params, "dft": draft_params}
        self.params = params
        self.runner.bind(self.params)
        self.cache = self.runner.init_cache(num_blocks, block_size,
                                            max_batch, self.device, kv_dtype,
                                            tp=self.tp)
        # the paged pools as the host copies see them, in a fixed order:
        # 1-byte pools as uint8 (index_copy_ has no fp8 form)
        self._paged = ([t.view(torch.uint8) if t.element_size() == 1 else t
                        for pools in self.runner.pool_sets(self.cache)
                        for name in PAGE_POOLS if name in pools
                        for t in (pools[name],)]
                       if self.runner.needs_blocks else [])
        # the swap tier's host pool: one pinned tensor per paged pool,
        # slot-major (a slot holds one block of every layer, contiguous)
        self._host_pool = [torch.zeros((num_host_blocks, p.shape[0])
                                       + p.shape[2:], dtype=p.dtype,
                                       pin_memory=on_card)
                           for p in self._paged] if num_host_blocks else []
        self._host_block_nbytes = sum(
            p[:, 0].numel() * p.element_size() for p in self._paged)
        if shared_index is not None:
            shared_index.attach_pool(
                [((p.shape[0],) + p.shape[2:], p.dtype) for p in self._paged],
                pin=on_card)
        self.inputs = StepInputs(step_input_shapes(
            max_batch, self.chunk_width, self.max_blocks_per_seq,
            self.prefill_pack), self.device)
        self._full_area = None         # the full path's inputs, lazily
        self._host_out = {}            # pinned host copies of the outputs
        # the runner's step body on the step inputs: runner_body(has_chunk=,
        # sampling=) -> {"logits", "tokens", ...} (runners.ModelRunner.step)
        self.runner_body = functools.partial(
            self.runner.step, self.params, self.cache, self.inputs.dev)
        self.graphs = (CompiledSteps(self.runner_body, self.inputs.null_step,
                                     self.device) if cuda_graphs else None)
        self.stream = torch.cuda.Stream(self.device) if on_card else None
        if on_card:
            # the parameters, pools and inputs were written on the
            # caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        kv_mib = 0.0
        if self.runner.needs_blocks:
            kv_mib = num_blocks * self._dev_block_bytes
            kv_mib /= 2 ** 20
        slot_mib = (max_batch * slot_state_bytes(cfg) / 2 ** 20
                    if self.runner.needs_slots else 0.0)
        enc_mib = (max_batch * encoder_cache_bytes(cfg, tp=self.tp) / 2 ** 20
                   if self.runner.needs_encoder else 0.0)
        self.stats = {"steps": 0, "prefill_chunks": 0, "preemptions": 0,
                      "tokens": 0, "prefill_tokens": 0,
                      "quantum_dropped_tokens": 0,
                      "cache_hit_tokens": 0, "cow_copies": 0,
                      "requests": 0, "requests_done": 0,
                      "spec_decodes": 0, "spec_emitted": 0,
                      "stop_hits": 0, "full_sampling_steps": 0,
                      "peak_block_utilization": 0.0, "peak_blocks_in_use": 0,
                      "aborts": 0, "swap_preemptions": 0, "swap_ins": 0,
                      "host_hit_blocks": 0, "shared_hit_blocks": 0,
                      "shared_published_blocks": 0,
                      "swapped_out_blocks": 0, "swapped_in_blocks": 0,
                      "swapped_out_bytes": 0, "swapped_in_bytes": 0,
                      "swap_space_mib": round(num_host_blocks
                                              * self._dev_block_bytes
                                              / 2 ** 20, 3),
                      # device -> host and host -> device copy time of the
                      # swap tier, seconds (CUDA events on a card)
                      "swap_d2h_s": 0.0, "swap_h2d_s": 0.0,
                      # admission-time encoder passes (enc-dec runners)
                      "encodes": 0,
                      "latency": {},
                      # the JAX package's total: page pools + slot state
                      # + the encoder cache
                      "kv_cache_mib": round(kv_mib + slot_mib + enc_mib, 3),
                      "slot_state_mib": round(slot_mib, 3),
                      "kv_dtype": kv_dtype,
                      "graph_captures": 0,
                      # tensor parallelism: the degree, and the mesh
                      # groups' collectives (spmd.collectives.ModelGroup.
                      # stats; "staged": through pinned host memory under
                      # gloo)
                      "tp": self.tp, "tp_gathers": 0, "tp_gather_bytes": 0,
                      "tp_staged_copies": 0, "tp_staged_bytes": 0,
                      "tp_reduces": 0, "tp_reduce_bytes": 0,
                      "tp_all_to_alls": 0,
                      # this rank's weights (the fp32 head copy aside)
                      "shard_params": self.shard_params,
                      "weight_bytes": weight_bytes(self.params),
                      # the MoE block's calls by mode (models.moe)
                      "moe_modes": {},
                      # by (shape, mode): "decode", "chunk" (greedy),
                      # "decode/plain", "chunk/full", ...
                      "graph_replays": {"chunk": 0, "decode": 0}}
        self.step_count = 0           # virtual clock: one step() = one tick
        self.hist = {"ttft_seconds": Histogram(SECONDS_BUCKETS),
                     "e2e_seconds": Histogram(SECONDS_BUCKETS),
                     "ttft_steps": Histogram(STEP_BUCKETS),
                     "e2e_steps": Histogram(STEP_BUCKETS)}
        # streaming hooks: on_token(req, tok, logprobs) after every
        # appended token, on_finish(req) after the request has retired
        self.on_token = None
        self.on_finish = None

    def _weights(self, cfg: ModelConfig, params, seed: int, mesh):
        """One model's weights on the device: ``params``, or drawn from
        ``seed``; with ``shard_params``, this rank's cut of every leaf,
        each part cut as soon as it is drawn (or from the given whole
        leaves)."""
        if not self.shard_params:
            return (init_model(cfg, seed, self.device) if params is None
                    else params)
        sm = self.serve_mesh
        layouts = shd.serving_layouts(cfg, self.pcfg, mesh)
        coords = {"data": sm.data.rank, "model": sm.model.rank}
        sizes = shd.mesh_shape(mesh)

        def place(tree, path):
            lay = layouts
            for key in path:
                lay = lay[key]
            return shd.cut_tree(tree, lay, coords, sizes)

        if params is None:
            return init_model(cfg, seed, self.device, place=place)
        return shd.cut_tree(params, layouts, coords, sizes)

    # -- derived stats -----------------------------------------------------

    @property
    def cache_hit_rate(self) -> float:
        """Prefill KV served from the prefix cache: hits / (hits +
        prefill tokens computed); 0.0 before any prefill."""
        hits = self.stats["cache_hit_tokens"]
        denom = hits + self.stats["prefill_tokens"]
        return hits / denom if denom else 0.0

    @property
    def preemption_rate(self) -> float:
        n = self.stats["requests"]
        return self.stats["preemptions"] / n if n else 0.0

    @property
    def mean_accept_len(self) -> float:
        """Tokens emitted per speculative decode slot-step (1.0: no draft
        token survived; 1 + k is the cap); 0.0 before any."""
        n = self.stats["spec_decodes"]
        return self.stats["spec_emitted"] / n if n else 0.0

    # -- device helpers ----------------------------------------------------

    def _copy_block(self, src: int, dst: int) -> None:
        """The device half of a copy-on-write: pool row src -> dst in every
        layer's pools (k, v and, when quantized, their scales) of every
        pool set (a speculative engine's target and draft), in place."""
        for pools in self.runner.pool_sets(self.cache):
            for name in PAGE_POOLS:
                if name in pools:
                    pool = pools[name]
                    pool[:, dst] = pool[:, src]

    @contextlib.contextmanager
    def _on_stream(self):
        """On a card: the process-wide device lock, and the engine's own
        stream as the current one, after the caller's current stream (what
        the caller wrote before is visible)."""
        if self.stream is None:
            yield
            return
        with DEVICE_LOCK:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                yield

    def _mark(self):
        """A time mark on the engine's stream: a CUDA event on a card (the
        device's clock), the host's clock otherwise."""
        if self.stream is None:
            return time.monotonic()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    @staticmethod
    def _seconds(start, end) -> float:
        """Seconds between two marks, waiting for the second on a card."""
        if isinstance(start, float):
            return end - start
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def _sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def _index(self, ids) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.long, device=self.device)

    def _gather_to(self, blocks: list[int], pool: list, slots: list[int]):
        """Device -> host: block rows ``blocks`` of every paged pool into
        rows ``slots`` of the host ``pool`` (one tensor per paged pool),
        on the engine's stream: one gather a pool, then one copy per run
        of consecutive slots. Asynchronous on a card (pinned pools)."""
        idx = self._index(blocks)
        runs = _runs(list(zip(range(len(slots)), slots)))
        for p, hp in zip(self._paged, pool):
            g = p.transpose(0, 1).index_select(0, idx)    # (n, NP, ...)
            for i0, s0, n in runs:
                hp[s0:s0 + n].copy_(g[i0:i0 + n], non_blocking=True)

    def _scatter_from(self, pool: list, pairs) -> None:
        """Host -> device: for each (slot, block) of ``pairs``, row
        ``slot`` of the host ``pool`` into block row ``block`` of every
        paged pool, in place (the captured graphs hold the pools)."""
        slots = [s for s, _ in pairs]
        idx = self._index([b for _, b in pairs])
        runs = _runs(list(zip(slots, range(len(slots)))))
        for p, hp in zip(self._paged, pool):
            buf = torch.empty((len(pairs),) + tuple(hp.shape[1:]),
                              dtype=hp.dtype, device=self.device)
            for s0, i0, n in runs:
                buf[i0:i0 + n].copy_(hp[s0:s0 + n], non_blocking=True)
            p.transpose(0, 1).index_copy_(0, idx, buf)

    def _issue_swap_out(self, pairs):
        """Issue the device -> host copies of this step's swap-outs, on the
        pre-step pools. Returns the token ``_drain_swap_out`` completes."""
        start = self._mark()
        self._gather_to([b for b, _ in pairs], self._host_pool,
                        [s for _, s in pairs])
        return start, self._mark(), len(pairs)

    def _drain_swap_out(self, token) -> None:
        """Wait for a swap-out's copies; count them and feed their time to
        the cost model. The copies are on the engine's stream, ahead of
        anything that reads their host slots or rewrites their blocks."""
        start, end, n = token
        secs = self._seconds(start, end)
        nbytes = n * self._host_block_nbytes
        self.stats["swapped_out_blocks"] += n
        self.stats["swapped_out_bytes"] += nbytes
        self.stats["swap_d2h_s"] += secs
        self._swap_cost.observe_swap(nbytes, secs)

    def _swap_in(self, pairs) -> None:
        """Host -> device: swapped-in and host-hit slots into freshly
        allocated blocks, before the COW copies (which may read them) and
        the step."""
        start = self._mark()
        self._scatter_from(self._host_pool, pairs)
        self.stats["swap_h2d_s"] += self._seconds(start, self._mark())
        self.stats["swapped_in_blocks"] += len(pairs)
        self.stats["swapped_in_bytes"] += len(pairs) * self._host_block_nbytes

    def _shared_in(self, pairs) -> None:
        """Host -> device: shared-index slots (blocks another replica
        published) into freshly allocated blocks, as ``_swap_in`` does. The
        slots were pinned at admission; they are released once the copies
        have landed, so no publish can rewrite them under a pending copy."""
        self._scatter_from(self.shared_index.pool, pairs)
        self._sync()
        self.shared_index.release([s for s, _ in pairs])

    def _flush_shared_publish(self) -> None:
        """Publish this replica's newly hash-registered blocks into the
        shared index: copy their pages into reserved pool slots, wait for
        the copies, then commit the hashes (a hash committed before its
        payload landed would hand another replica stale bytes). Runs at
        step boundaries and when a request retires, before its stream
        ends: a request submitted after a producer's stream closed finds
        every block the producer registered, on any replica."""
        if self.shared_index is None or self.bm is None:
            return
        shared = self.shared_index
        blocks, slots, hashes = [], [], []
        for b, h in self.bm.drain_publishable():
            s = shared.reserve(h)
            if s is None:
                continue     # raced with another replica, or pool pinned full
            blocks.append(b)
            slots.append(s)
            hashes.append(h)
        if not blocks:
            return
        self._gather_to(blocks, shared.pool, slots)
        self._sync()
        for s, h in zip(slots, hashes):
            shared.commit(s, h)
        self.stats["shared_published_blocks"] += len(blocks)

    def abort(self, rid: int) -> bool:
        """Cancel a request between steps (a client disconnect): its cache
        resources are released at once (blocks hash-retained, host slots
        discarded) and it produces no further tokens. False, a no-op, for
        an unknown or retired rid."""
        ok = self.sched.abort(rid)
        if ok:
            self.stats["aborts"] = self.sched.n_aborts
        return ok

    def _run_encodes(self, plan: StepPlan) -> None:
        """The admission-time encode passes: each new enc-dec request's
        cross K/V into its slot row (zero frames when it has none), before
        any step reads the row. Eager, on the engine's stream."""
        for slot, req in plan.encodes:
            frames = req.frames
            if frames is None:
                frames = np.zeros((self.cfg.encoder_seq_len,
                                   self.cfg.d_model), np.float32)
            frames = torch.as_tensor(np.asarray(frames, np.float32)).to(
                self.device, torch.bfloat16)
            self.runner.encode(self.params, self.cache, slot, frames)
            self.stats["encodes"] += 1

    def _full_inputs(self) -> None:
        """Allocate the full path's input area at its first step (before
        its graphs are captured: they read its buffers)."""
        if self._full_area is None:
            self._full_area = self.inputs.add(full_input_shapes(
                self.max_batch + self.prefill_pack,
                self.cfg.padded_vocab_size))

    def _build_arrays(self, plan: StepPlan, mode: str = "greedy") -> None:
        """Fill the step inputs (``self.inputs``) for ``plan`` and upload
        them: rows 0..B-1 of the sampling inputs are the decode slots,
        B.. the chunks; in full mode also the full path's area."""
        B, S = self.max_batch, self.prefill_pack
        full = mode == "full"
        self.inputs.reset()
        if full:
            self.inputs.reset(self._full_area)
        a = self.inputs.host

        def fill_samp(i, req):
            sp = req.sampling
            a["temps"][i] = sp.temperature
            a["top_ks"][i] = sp.top_k
            a["seeds"][i] = _i32(sp.seed)
            a["rids"][i] = _i32(req.rid)
            a["counters"][i] = len(req.out)
            if full:
                a["top_ps"][i] = sp.top_p
                a["min_ps"][i] = sp.min_p
                a["rep_pens"][i] = sp.repetition_penalty
                a["pres_pens"][i] = sp.presence_penalty
                a["freq_pens"][i] = sp.frequency_penalty
                a["pmask"][i], a["ocounts"][i] = self.samp_buf.row(req.rid)

        for slot, req in plan.decodes:
            a["d_active"][slot] = True
            a["d_tok"][slot] = req.out[-1]
            a["d_pos"][slot] = req.context_len - 1  # write position of out[-1]
            if self.bm is not None:
                row = self.bm.table(req.rid)
                a["d_tables"][slot, :len(row)] = row
            fill_samp(slot, req)
        if S == 1 and plan.chunk is not None:
            slot, req, n = plan.chunk
            toks = req.prefill_tokens()
            a["c_tok"][0, :n] = toks[req.num_computed:req.num_computed + n]
            a["c_start"][0] = req.num_computed     # 0: the chunk is fresh
            a["c_len"][0] = n
            a["c_slot"][0] = slot
            if self.bm is not None:
                row = self.bm.table(req.rid)
                a["c_table"][0, :len(row)] = row
            fill_samp(B, req)
        elif plan.chunks:
            tok_rows, pos_rows = [], []
            for ci, (slot, req, n) in enumerate(plan.chunks):
                lo = req.num_computed
                tok_rows.append(req.prefill_tokens()[lo:lo + n])
                pos_rows.append(np.arange(lo, lo + n, dtype=np.int32))
                a["c_ctx"][ci] = lo + n
                row = self.bm.table(req.rid)
                a["c_tables"][ci, :len(row)] = row
                fill_samp(B + ci, req)
            C = self.chunk_width
            tok, seq, starts, ends = pack_ragged(tok_rows, C, S)
            a["c_tok"][0] = tok
            a["c_pos"][0] = pack_ragged(pos_rows, C, S)[0]
            a["c_seq"][...], a["c_starts"][...], a["c_ends"][...] = \
                seq, starts, ends
        self.inputs.upload()
        if full:
            self.inputs.upload(self._full_area)

    def capture_graphs(self, shapes=(True, False), mode: str = "greedy"):
        """Capture the step graphs of ``shapes`` (has_chunk values) in
        sampling ``mode`` that have none yet: a server's start-up, instead
        of each graph's first step. Nothing to do without graphs."""
        for has_chunk in shapes:
            key = (has_chunk, mode)
            if self.graphs is not None and key not in self.graphs:
                with self._on_stream():
                    if mode == "full":
                        self._full_inputs()
                    self.graphs.capture(key)
                self.stats["graph_captures"] += 1

    def _forward(self, has_chunk: bool, mode: str = "greedy") -> dict:
        """The step body on the filled inputs: a replay of the (shape,
        mode) graph, or the eager body without graphs."""
        if self.graphs is None:
            return self.runner_body(has_chunk=has_chunk, sampling=mode)
        key = (has_chunk, mode)
        rep = self.stats["graph_replays"]
        rep[_replay_name(key)] = rep.get(_replay_name(key), 0) + 1
        return self.graphs.replay(key)

    def _fetch(self, out: dict, names) -> dict:
        """Device -> host of the step outputs ``names``: one asynchronous
        copy each into pinned buffers, one synchronize; numpy views."""
        host = {}
        for name in names:
            t = out[name]
            buf = self._host_out.get(name)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=self.device.type == "cuda")
                self._host_out[name] = buf
            buf.copy_(t, non_blocking=True)
            host[name] = buf.numpy()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def _run_step(self, plan: StepPlan) -> dict:
        """One step of ``plan`` on the device: its mode, inputs, the body
        (captured first if its (shape, mode) has no graph yet), one copy
        of the outputs the host reads. Returns them as numpy arrays."""
        has_chunk = bool(plan.chunks)
        mode = _mode([r for _, r in plan.decodes]
                     + [r for _, r, _ in plan.chunks])
        if mode == "full":
            self.stats["full_sampling_steps"] += 1
            self._full_inputs()
        self.capture_graphs((has_chunk,), mode)
        self._build_arrays(plan, mode)
        out = self._forward(has_chunk, mode)
        names = ["tokens"]
        if self.draft_cfg is not None:               # speculative
            names += ["n_acc", "c_tokens"]
        if mode == "full":
            lp = [n for n in out if n.endswith(("chosen", "top_lp",
                                                "top_ids"))]
            names += lp
        return self._fetch(out, names)

    # -- host-side step ----------------------------------------------------

    def _lat(self, rid: int) -> dict:
        return self.stats["latency"].setdefault(rid, {})

    def _note_arrival(self, req: Request) -> None:
        self.stats["requests"] += 1
        self._lat(req.rid).update(arrival_step=self.step_count,
                                  arrival_wall=time.monotonic())

    def _observe_latency(self, rec: dict) -> None:
        if "arrival_step" not in rec:        # driven without _note_arrival
            return
        self.hist["ttft_steps"].observe(
            rec["first_token_step"] - rec["arrival_step"])
        self.hist["e2e_steps"].observe(
            rec["done_step"] - rec["arrival_step"])
        self.hist["ttft_seconds"].observe(
            rec["first_token_wall"] - rec["arrival_wall"])
        self.hist["e2e_seconds"].observe(
            rec["done_wall"] - rec["arrival_wall"])

    @staticmethod
    def _req_logprobs(req: Request, lp, idx):
        """One emitted token's logprobs for ``on_token``:
        {"token_logprob": float, "top": [(id, logprob), ...]} trimmed to
        the request's ``logprobs``, or None when it asked for none (or the
        step ran without the full path). ``lp`` maps "chosen", "top_lp"
        and "top_ids" to host arrays; ``idx`` indexes their rows."""
        n = req.sampling.logprobs
        if lp is None or n <= 0:
            return None
        return {"token_logprob": float(lp["chosen"][idx]),
                "top": [(int(t), float(v))
                        for t, v in zip(lp["top_ids"][idx][:n],
                                        lp["top_lp"][idx][:n])]}

    def _append_token(self, slot: int, req: Request, tok: int,
                      logprobs=None) -> None:
        req.out.append(tok)
        self.samp_buf.commit(req.rid, tok)
        self.stats["tokens"] += 1
        rec = self._lat(req.rid)
        if "first_token_step" not in rec:
            rec.update(first_token_step=self.step_count,
                       first_token_wall=time.monotonic())
        self.sched.note_progress(req)
        if (req.sampling.stop and not req.stop_hit
                and len(req.out) >= req.min_new
                and self.samp_buf.check_stop(req.rid, req.sampling.stop)
                is not None):
            req.stop_hit = True
            self.stats["stop_hits"] += 1
        if self.on_token is not None:
            self.on_token(req, tok, logprobs)
        if req.done:
            rec.update(done_step=self.step_count, done_wall=time.monotonic())
            self._observe_latency(rec)
            self.stats["requests_done"] += 1
            lat = self.stats["latency"]
            if len(lat) > LATENCY_RECORD_CAP:
                # evict oldest *completed* records only
                for rid in list(lat):
                    if "done_step" in lat[rid]:
                        del lat[rid]
                        if len(lat) <= LATENCY_RECORD_CAP:
                            break
            # the stream-close publish barrier: before anyone can see this
            # request finished, every full block it registered is in the
            # shared index
            self._flush_shared_publish()
            self.sched.retire(slot)
            if self.on_finish is not None:
                self.on_finish(req)

    @staticmethod
    def _lp(out: dict, prefix: str = ""):
        """The logprob arrays of ``out`` under ``prefix``, or None."""
        if prefix + "chosen" not in out:
            return None
        return {n: out[prefix + n] for n in ("chosen", "top_lp", "top_ids")}

    @torch.no_grad()
    def step(self) -> bool:
        """One engine iteration. Returns True when any work ran. On rank 0
        of a tensor-parallel group it first sends the other ranks what
        they need to take the same step."""
        if self.group is not None:
            if self.group.rank != 0:
                raise RuntimeError("step() on a following rank: call "
                                   "follow(); rank 0 drives the group")
            self.group.broadcast(self._step_message())
        return self._group_step()

    def _group_step(self) -> bool:
        with self._on_stream(), collectives.use(self.serve_mesh):
            ran = self._step()
        if self.serve_mesh is not None:
            for k, v in self.serve_mesh.stats.items():
                self.stats[f"tp_{k}"] = v
            self.stats["moe_modes"] = dict(self.serve_mesh.moe_modes)
        return ran

    def _step_message(self) -> dict:
        """What rank 0 received since its last step (submissions, aborts),
        its scheduler's drain flag, its clock and its swap cost model's
        rates."""
        log, self.sched.log = self.sched.log, []
        cost = self._swap_cost
        return {"log": log, "draining": self.sched.draining,
                "clock": self.step_count,
                "cost": None if cost is None
                else (cost.bytes_per_s, cost.prefill_tok_s)}

    @torch.no_grad()
    def follow(self) -> dict[int, np.ndarray]:
        """A following rank of a tensor-parallel group: take every step
        rank 0 takes, with its submissions, aborts, clock and swap rates,
        until rank 0's ``close()``. Returns {rid: generated token array}
        of the requests it followed, as ``run`` does."""
        if self.group is None or self.group.rank == 0:
            raise RuntimeError("follow() is for the ranks after 0 of a "
                               "tensor-parallel group")
        followed = []
        while True:
            msg = self.group.broadcast()
            if msg is None:
                return {r.rid: np.asarray(r.out, np.int32) for r in followed}
            # rank 0 accepted every logged submission: replay them before
            # taking its drain flag
            self.sched.draining = False
            for what, arg in msg["log"]:
                if what == "add":
                    self.sched.add(arg)
                    self._note_arrival(arg)
                    followed.append(arg)
                else:
                    self.abort(arg)
            self.sched.draining = msg["draining"]
            self.step_count = msg["clock"]
            if msg["cost"] is not None:
                self._swap_cost.bytes_per_s, self._swap_cost.prefill_tok_s \
                    = msg["cost"]
            self._group_step()

    def close(self) -> None:
        """Rank 0 of a tensor-parallel group: release the other ranks
        from ``follow()``. A no-op without tensor parallelism."""
        if self.group is not None and self.group.rank == 0:
            self.group.broadcast(None)

    def _step(self) -> bool:
        plan = self.sched.schedule()
        sched = self.sched
        self.stats.update(preemptions=sched.n_preemptions,
                          swap_preemptions=sched.n_swap_preemptions,
                          swap_ins=sched.n_swap_ins,
                          host_hit_blocks=sched.host_hit_blocks,
                          shared_hit_blocks=sched.shared_hit_blocks)
        self.stats["cache_hit_tokens"] = self.sched.cache_hit_tokens
        self.stats["quantum_dropped_tokens"] = \
            self.sched.quantum_dropped_tokens
        if self.bm is not None:
            st = self.bm.stats()
            self.stats["peak_block_utilization"] = max(
                self.stats["peak_block_utilization"], st.utilization)
            self.stats["peak_blocks_in_use"] = max(
                self.stats["peak_blocks_in_use"], st.blocks_in_use)
        if self.debug_invariants:
            self._check_invariants(plan)
            if self.group is not None:
                digests = self.group.all_gather_object(plan_digest(plan))
                if len(set(digests)) != 1:
                    raise RuntimeError(
                        f"step {self.step_count}: tensor-parallel ranks "
                        f"planned different steps: {digests}")
        # host copies, all on the engine's stream in this order: the
        # swap-outs' gather first, on the pre-step pools (before anything
        # can rewrite a freed block); then swap-ins and shared adoptions,
        # before the COW copies (a block copied in this step can already
        # be a COW source); then the encodes; then the step
        d2h = self._issue_swap_out(plan.swap_outs) if plan.swap_outs \
            else None
        if plan.swap_ins:
            self._swap_in(plan.swap_ins)
        if plan.shared_ins:
            self._shared_in(plan.shared_ins)
        self._run_encodes(plan)
        for src, dst in plan.copies:
            self.stats["cow_copies"] += 1
            self._copy_block(src, dst)
        if plan.scheduled_tokens == 0:
            # no compute, but an admission (e.g. a full prefix-cache hit
            # that is immediately decode-ready) is still progress
            if d2h is not None:
                self._drain_swap_out(d2h)
            self._flush_shared_publish()
            if plan.admitted:
                self.step_count += 1
            return plan.admitted > 0
        t_step = time.monotonic()
        out = self._run_step(plan)
        if d2h is not None:
            self._drain_swap_out(d2h)
        B = self.max_batch
        if "n_acc" in out:
            toks, n_acc = out["tokens"], out["n_acc"]
            chunk_toks, lp_d = out["c_tokens"], self._lp(out)
            chunk_lp = self._lp(out, "c_")
            for slot, req in plan.decodes:
                self.stats["spec_decodes"] += 1
                # the accepted draft prefix and the corrected (or bonus)
                # token, cut short by retirement
                for i in range(int(n_acc[slot]) + 1):
                    req.num_computed += 1
                    self.stats["spec_emitted"] += 1
                    self._append_token(slot, req, int(toks[slot, i]),
                                       self._req_logprobs(req, lp_d,
                                                          (slot, i)))
                    if req.done:
                        break
                if self.sched.running.get(slot) is req:
                    # roll back the lookahead blocks of the rejected tail
                    # (both models' pools: they share the block table)
                    self.bm.truncate(req.rid, req.context_len)
        else:
            toks, lp = out["tokens"], self._lp(out)
            chunk_toks = toks[B:]
            chunk_lp = (None if lp is None
                        else {n: v[B:] for n, v in lp.items()})
            for slot, req in plan.decodes:
                req.num_computed += 1
                self._append_token(slot, req, int(toks[slot]),
                                   self._req_logprobs(req, lp, slot))
        for ci, (slot, req, n) in enumerate(plan.chunks):
            req.num_computed += n
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
            if req.num_computed == req.context_len:
                self._append_token(slot, req, int(chunk_toks[ci]),
                                   self._req_logprobs(req, chunk_lp, ci))
            else:
                self.sched.note_progress(req)
        if self._swap_cost is not None and plan.chunks:
            # the step's outputs were fetched: this wall time covers its
            # device work, the recompute rate the cost model weighs
            self._swap_cost.observe_prefill(sum(n for _, _, n in plan.chunks),
                                            time.monotonic() - t_step)
        self._flush_shared_publish()
        self.stats["steps"] += 1
        self.step_count += 1
        if self.debug_invariants and self.bm is not None:
            self.bm.check()
            if self.shared_index is not None:
                self.shared_index.check()
        return True

    def _check_invariants(self, plan: StepPlan) -> None:
        if self.slot_cache is not None:
            self.slot_cache.check()
            for slot, req in self.sched.running.items():
                assert self.slot_cache.slot(req.rid) == slot, (req.rid, slot)
        if self.encoder_cache is not None:
            self.encoder_cache.check()
            for slot, req in self.sched.running.items():
                assert self.encoder_cache.slot(req.rid) == slot, (req.rid,
                                                                  slot)
        assert plan.scheduled_tokens <= self.max_num_batched_tokens
        if self.bm is None:
            return
        self.bm.check()
        bs = self.block_size
        for slot, req in self.sched.running.items():
            t = self.bm.table(req.rid)
            assert len(t) <= self.max_blocks_per_seq, (req.rid, len(t))
            assert len(t) * bs >= req.num_computed, \
                f"request {req.rid}: table does not cover computed KV"
        for _, req, n in plan.chunks:
            t = self.bm.table(req.rid)
            assert len(t) * bs >= req.num_computed + n
            # COW guarantee: the chunk writes only exclusively-owned blocks
            lo, hi = req.num_computed // bs, (req.num_computed + n - 1) // bs
            for j in range(lo, hi + 1):
                assert self.bm.refcount(t[j]) == 1, \
                    f"chunk would write shared block {t[j]}"
        for slot, req in plan.decodes:
            t = self.bm.table(req.rid)
            # the decode (or the verify row) writes positions
            # context_len - 1 .. context_len - 1 + spec: exclusively owned
            for p in range(req.context_len - 1,
                           req.context_len + plan.spec_tokens):
                assert self.bm.refcount(t[p // bs]) == 1, \
                    f"decode would write shared block {t[p // bs]}"

    def run(self, requests: list[Request],
            arrival_steps: list[int] | None = None) -> dict[int, np.ndarray]:
        """Serve ``requests`` to completion. ``arrival_steps[i]`` is the
        engine step at which request i becomes visible (default: all at
        step 0). Returns {rid: generated token array}; wall time and
        throughput land in ``self.stats``."""
        if arrival_steps is None:
            arrival_steps = [0] * len(requests)
        for r in requests:
            self.sched.validate(r)         # fail fast, not at arrival time
        pending = deque(sorted(zip(arrival_steps, range(len(requests))),
                               key=lambda t: t[0]))
        t0 = time.time()
        tok0 = self.stats["tokens"]
        while pending or self.sched.has_work:
            while pending and pending[0][0] <= self.step_count:
                req = requests[pending.popleft()[1]]
                self.sched.add(req)
                self._note_arrival(req)
            if not self.sched.has_work and pending:
                self.step_count = pending[0][0]      # idle: jump the clock
                continue
            if not self.step():
                state = (self.bm.stats() if self.bm is not None
                         else self.slot_cache.stats())
                raise RuntimeError(
                    "engine stuck: scheduler made no progress with work "
                    f"pending — {state}")
        dt = time.time() - t0
        self.stats["wall_s"] = round(dt, 3)
        self.stats["tok_s"] = round((self.stats["tokens"] - tok0)
                                    / max(dt, 1e-9), 1)
        if self.stats["spec_decodes"]:
            self.stats["mean_accept_len"] = round(self.mean_accept_len, 3)
        return {r.rid: np.asarray(r.out, np.int32) for r in requests}
