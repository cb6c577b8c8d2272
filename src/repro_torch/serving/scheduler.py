"""Token-budget continuous-batching scheduler (port of
``repro.serving.scheduler``).

Every engine step hands out up to ``max_num_batched_tokens`` of work in one
:class:`StepPlan`: **1 token** for every decode-ready running request, and
the leftover budget funds up to ``prefill_pack`` **prefill chunks** (the
requests streaming their prompts in, or freshly admitted ones), which
share that budget and one ``chunk_width`` of rows; with
``prefill_pack > 1`` the engine runs them as one packed (ragged) batch.
Admission shares full cached blocks through the ``BlockManager`` prefix
cache; a whole-prompt hit recomputes its last token behind a copy-on-write
of the final shared block. When the pool runs dry the newest request is
preempted and recomputed later (vLLM's recompute strategy), so greedy
outputs are preemption-invariant. Runners with slot state (SSM, hybrid)
get a ``slot_cache`` bound at admission and freed on preemption and
retirement; a pure SSM runner has no block manager at all (``bm=None``):
no block horizon, no preemption pressure, no prefix cache, admission
limited by slots only. ``chunk_quantum`` rounds non-final chunks down to
a multiple (SSM runners: the SSD chunk size, so chunked prefill groups
the scan as a monolithic one does).

With speculative decoding (``spec_tokens`` = k > 0) each decode slot
costs ``1 + k`` budget tokens (the verify row) and its block horizon is
ensured at ``context_len + 1 + k``; the engine rolls the rejected tail
back with ``BlockManager.truncate`` after the step. A preemption victim's
recompute chunk stops one token short of its stream, so that the verify
step emits the final token again with the uninterrupted run's window
alignment (temperature streams replay).

A ``sampling_buffer`` (``sampling.SamplingBuffer``) validates each
request's sampling parameters and is bound and released beside the slot
cache.

With a host tier (the block manager's ``num_host_blocks`` and a
``SwapCostModel``) a preemption victim may be *swapped* instead: its
blocks move to host slots (the plan's ``swap_outs``), its progress
survives, and it returns from the front of the queue by ``swap_ins``
rather than a recompute chunk. Admission extends a device prefix hit with
host-resident blocks of swapped requests and, with a shared index, with
blocks another replica published (``shared_ins``). ``abort`` cancels a
request wherever it lives; ``drain`` refuses new submissions; an
``on_admit(slot, req)`` hook sees every waiting -> running move.

Pure host logic: the same requests give the same plans as the JAX
package's scheduler (the port's tests compare them step by step).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.kv_cache import BlockManager, extend_chain_hashes

_RID = itertools.count()


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling surface. Every default is an exact identity:
    a request at the defaults draws the same tokens on the plain path
    (greedy, temperature, top-k) and the full pipeline. ``stop`` holds
    token-id sequences (tuples, so the dataclass stays hashable), matched
    on the host against the request's most recent tokens."""

    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => no truncation
    seed: int = 0
    top_p: float = 1.0             # 1.0 => no nucleus truncation
    min_p: float = 0.0             # 0 => no min-p truncation
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logprobs: int = 0              # top-N logprobs per token (0 = off)
    stop: tuple = ()               # stop sequences: tuples of token ids

    def __post_init__(self):
        object.__setattr__(self, "stop", tuple(tuple(int(t) for t in s)
                                               for s in self.stop))

    @property
    def needs_pipeline(self) -> bool:
        """True when sampling needs the full pipeline (penalties, top-p,
        min-p, logprobs). Stop sequences and min_new are host checks and
        do not force it."""
        return (self.top_p < 1.0 or self.min_p > 0.0
                or self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.logprobs > 0)


@dataclass
class SwapCostModel:
    """Swap-or-recompute for one preemption victim.

    Swapping moves ``2 * n_blocks * block_bytes`` over the device <-> host
    link (out now, back later); recomputing replays ``num_computed``
    prefill tokens through the model. Both rates start at conservative
    defaults and follow the engine's measurements (EMA). ``policy``
    "always" / "never" fixes the choice (byte-identity tests); "auto"
    decides from the rates, so which victim swaps depends on the machine.
    """

    block_bytes: int                 # device bytes one block id costs
    policy: str = "auto"             # "always" | "never" | "auto"
    bytes_per_s: float = 4.0e9       # d2h + h2d bandwidth EMA
    prefill_tok_s: float = 2.0e4     # recompute throughput EMA
    ema_alpha: float = 0.2

    def prefer_swap(self, n_blocks: int, n_recompute_tokens: int) -> bool:
        if self.policy == "always":
            return True
        if self.policy == "never":
            return False
        move_s = 2.0 * n_blocks * self.block_bytes \
            / max(self.bytes_per_s, 1.0)
        recompute_s = n_recompute_tokens / max(self.prefill_tok_s, 1.0)
        return move_s < recompute_s

    def observe_swap(self, nbytes: int, seconds: float) -> None:
        if nbytes > 0 and seconds > 0:
            self.bytes_per_s += self.ema_alpha * (nbytes / seconds
                                                  - self.bytes_per_s)

    def observe_prefill(self, n_tokens: int, seconds: float) -> None:
        if n_tokens > 0 and seconds > 0:
            self.prefill_tok_s += self.ema_alpha * (n_tokens / seconds
                                                    - self.prefill_tok_s)


@dataclass
class Request:
    prompt: np.ndarray                      # (prompt_len,) int32
    max_new: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_id: int | None = None
    # EOS and stop sequences are ignored until min_new tokens exist
    min_new: int = 0
    # set by the engine when a stop sequence matched the output's tail;
    # host state on the request, so it survives preemption like ``out``
    stop_hit: bool = False
    rid: int = field(default_factory=lambda: next(_RID))
    out: list[int] = field(default_factory=list)
    num_computed: int = 0                   # prefill_tokens() with KV cached
    n_published: int = 0                    # full blocks hash-registered
    n_preempted: int = 0
    hash_chain: list = field(default_factory=list, repr=False)

    @property
    def done(self) -> bool:
        if len(self.out) >= self.max_new:
            return True
        if len(self.out) < self.min_new:
            return False
        if self.stop_hit:
            return True
        return bool(self.out) and self.eos_id is not None \
            and self.out[-1] == self.eos_id

    def prefill_tokens(self) -> np.ndarray:
        """Prompt plus already-generated tokens (recompute after preempt)."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)])

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.out)

    @property
    def decode_ready(self) -> bool:
        """Exactly one token left to compute and a sampled token to feed."""
        return bool(self.out) and self.num_computed == self.context_len - 1


@dataclass
class StepPlan:
    """One step's worth of work, within the token budget."""
    decodes: list[tuple[int, Request]]            # slot -> 1 token each
    # prefill chunks (slot, req, n) funded by the leftover budget; more
    # than one only with prefill_pack > 1 (run as one packed batch)
    chunks: list[tuple[int, Request, int]]
    copies: list[tuple[int, int]]                 # device page copies (COW)
    admitted: int = 0                             # waiting -> running joins
    # speculative lookahead: each decode costs 1 + spec_tokens positions
    spec_tokens: int = 0
    # host copies around the step: swap_outs are (device_block, host_slot)
    # copies of *pre-step* pool content (issued before anything can
    # rewrite a freed block); swap_ins are (host_slot, device_block)
    # copies that land before the step and before COW copies (which may
    # read them); shared_ins are (shared_index_slot, device_block) copies
    # out of the SharedPrefixIndex pool, with the swap_ins' contract
    swap_outs: list[tuple[int, int]] = field(default_factory=list)
    swap_ins: list[tuple[int, int]] = field(default_factory=list)
    shared_ins: list[tuple[int, int]] = field(default_factory=list)

    @property
    def chunk(self) -> tuple[int, Request, int] | None:
        """The single chunk of an unpacked (prefill_pack=1) plan."""
        return self.chunks[0] if self.chunks else None

    @property
    def scheduled_tokens(self) -> int:
        return (len(self.decodes) * (1 + self.spec_tokens)
                + sum(c[2] for c in self.chunks))


class Scheduler:
    """Token-budget scheduler over a paged KV cache (``bm``), slot state
    (``slot_cache``), or both.

    ``chunk_quantum`` quantizes non-final prefill chunks down to a
    multiple. Rounding only ever drops tokens from the *last* chunk of a
    step (earlier chunks' remainders roll into the next chunk's budget);
    the dropped count is kept in ``quantum_dropped_tokens``."""

    def __init__(self, bm: BlockManager | None, max_batch: int,
                 max_blocks_per_seq: int, max_num_batched_tokens: int,
                 chunk_width: int, *, enable_prefix_caching: bool = True,
                 chunk_quantum: int = 1, slot_cache=None,
                 max_context: int | None = None, prefill_pack: int = 1,
                 spec_tokens: int = 0, sampling_buffer=None,
                 swap_cost: SwapCostModel | None = None):
        if max_num_batched_tokens <= max_batch * (1 + spec_tokens):
            raise ValueError(
                f"max_num_batched_tokens={max_num_batched_tokens} must "
                f"exceed max_batch={max_batch} x (1 + spec_tokens="
                f"{spec_tokens}) (each decode slot costs a 1 + k wide "
                "verify row; a prefill chunk needs leftover budget)")
        if chunk_width < chunk_quantum:
            raise ValueError(
                f"chunk_width={chunk_width} below chunk_quantum="
                f"{chunk_quantum}: no non-final chunk could ever run")
        if prefill_pack < 1:
            raise ValueError(f"prefill_pack={prefill_pack} must be >= 1")
        self.prefill_pack = prefill_pack
        self.bm = bm
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_num_batched_tokens = max_num_batched_tokens
        self.chunk_width = chunk_width
        self.chunk_quantum = chunk_quantum
        self.slot_cache = slot_cache
        self.spec_tokens = spec_tokens
        # per-slot sampling state, bound at admission like the slot cache
        self.sampling_buffer = sampling_buffer
        if max_context is None and bm is not None:
            max_context = max_blocks_per_seq * bm.block_size
        self.max_context = max_context           # None: no horizon (slots)
        self.enable_prefix_caching = enable_prefix_caching and bm is not None
        # swap preemption: only with a cost model AND a host tier
        self.swap_cost = swap_cost
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}      # slot -> request
        self._join_order: list[int] = []           # slots, oldest first
        self.n_preemptions = 0
        self.n_swap_preemptions = 0
        self.n_swap_ins = 0
        self.n_aborts = 0
        self.host_hit_blocks = 0
        self.shared_hit_blocks = 0
        self.cache_hit_tokens = 0
        self.quantum_dropped_tokens = 0
        # copy pairs gathered while the current plan is built
        self._pending_swap_outs: list[tuple[int, int]] = []
        self._pending_swap_ins: list[tuple[int, int]] = []
        self._pending_shared_ins: list[tuple[int, int]] = []
        # graceful drain: in-flight work finishes, submissions are refused
        self.draining = False
        # front-end hook: on_admit(slot, req) at every waiting -> running
        # move (preemption re-admissions included)
        self.on_admit = None

    # -- queries ----------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def _swap_enabled(self) -> bool:
        return (self.swap_cost is not None and self.bm is not None
                and self.bm.num_host_blocks > 0)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.max_batch) if s not in self.running]

    # -- submission -------------------------------------------------------

    def validate(self, req: Request) -> None:
        """Reject at submission sampling parameters no path serves (the
        sampling buffer's checks) and a horizon past the block-table
        capacity. Slot state is constant-size: without blocks there is no
        horizon."""
        if self.sampling_buffer is not None:
            self.sampling_buffer.validate(req)
        if self.bm is None:
            return
        horizon = len(req.prompt) + req.max_new
        if horizon > self.max_context:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {horizon} tokens "
                f"exceeds max_len capacity {self.max_context}")

    def add(self, req: Request) -> None:
        if self.draining:
            raise RuntimeError(
                f"scheduler is draining: request {req.rid} refused "
                "(in-flight work finishes; no new admissions)")
        self.validate(req)
        self.waiting.append(req)

    def drain(self) -> None:
        """Refuse new requests; everything already submitted still runs to
        retirement. Idempotent."""
        self.draining = True

    # -- the budgeted step ------------------------------------------------

    def schedule(self) -> StepPlan:
        """Decode capacity first (preempting the newest requests when the
        pool runs dry), then spend the leftover budget on up to
        ``prefill_pack`` prefill chunks: in-flight prefills first, then
        newly admitted requests. All chunks of a step share one leftover
        budget and one ``chunk_width``, so packing never starves decodes
        harder than the single-chunk policy."""
        copies: list[tuple[int, int]] = []
        self._pending_swap_outs = []
        self._pending_swap_ins = []
        self._pending_shared_ins = []
        self._ensure_decode_capacity()
        decodes = [(s, r) for s, r in sorted(self.running.items())
                   if r.decode_ready]
        budget_left = self.max_num_batched_tokens \
            - len(decodes) * (1 + self.spec_tokens)

        admitted = 0
        pres = [(s, r) for s, r in sorted(self.running.items())
                if not r.decode_ready]
        while (len(pres) < self.prefill_pack and budget_left > 0
               and self.waiting and len(self.running) < self.max_batch):
            head = self.waiting[0]
            if (self.bm is not None and self.bm.is_swapped(head.rid)
                    and not self.bm.can_swap_in(head.rid)):
                break           # FCFS: wait for device blocks to free up
            slot, req = self._admit_one(copies)
            admitted += 1
            if not req.decode_ready:   # else: full cache hit minus one —
                pres.append((slot, req))  # it joins the decode batch next
        chunks: list[tuple[int, Request, int]] = []
        width_left = self.chunk_width
        pending_q_loss = 0
        for slot, req in pres:
            if budget_left <= 0 or width_left <= 0:
                break
            remaining = req.context_len - req.num_computed
            if self.spec_tokens and req.out:
                # a speculative recompute stops one token short: the verify
                # step emits the final token again, so the rejection-
                # sampling windows stay aligned with the uninterrupted run
                remaining -= 1
            want = min(budget_left, width_left, remaining)
            n = self._quantize(want, remaining)
            # a remainder below one quantum rolls into the next chunk's
            # budget; the step's last chunk has no next one, so its
            # remainder is counted, not silently lost
            pending_q_loss = want - n
            if n > 0:
                n = self._quantize(self._fit_chunk(req, n), remaining)
            if n > 0:
                chunks.append((slot, req, n))
                budget_left -= n
                width_left -= n
        self.quantum_dropped_tokens += pending_q_loss
        plan = StepPlan(decodes=decodes, chunks=chunks, copies=copies,
                        admitted=admitted, spec_tokens=self.spec_tokens,
                        swap_outs=self._pending_swap_outs,
                        swap_ins=self._pending_swap_ins,
                        shared_ins=self._pending_shared_ins)
        self._pending_swap_outs = []
        self._pending_swap_ins = []
        self._pending_shared_ins = []
        return plan

    def _quantize(self, n: int, remaining: int) -> int:
        """Round a non-final chunk down to the chunk quantum. A prompt's
        final chunk is exempt: SSD padding is an exact identity step."""
        if self.chunk_quantum > 1 and n < remaining:
            return n // self.chunk_quantum * self.chunk_quantum
        return n

    def _ensure_decode_capacity(self) -> None:
        """Every decode-ready request must own blocks for context_len + 1
        plus the ``spec_tokens`` lookahead positions the verify row may
        write; preempt the newest requests until the survivors fit. Slot
        state is constant-size: without blocks decode never runs out."""
        if self.bm is None:
            return
        for slot in list(self._join_order):             # oldest first
            req = self.running.get(slot)
            if req is None or not req.decode_ready:
                continue
            horizon = req.context_len + 1 + self.spec_tokens
            while not self.bm.ensure(req.rid, horizon):
                victim_slot = self._pick_victim()       # newest running
                if victim_slot == slot and len(self.running) == 1 and \
                        self.bm.blocks_for(horizon) \
                        > self.bm.num_blocks - 1:
                    raise MemoryError(
                        f"block pool too small for request {req.rid} "
                        f"at {horizon} tokens")
                self._preempt(victim_slot)
                if victim_slot == slot:
                    break        # self-preempted: back to waiting, move on

    def _fit_chunk(self, req: Request, n: int) -> int:
        """Reserve blocks for the next ``n`` prefill tokens, shrinking the
        chunk to what the pool can cover. Admission never preempts."""
        if self.bm is None:
            return n                     # slot state: nothing to reserve
        avail = (len(self.bm.table(req.rid)) + self.bm.num_free) \
            * self.bm.block_size - req.num_computed
        n = min(n, avail)
        if n <= 0:
            if len(self.running) == 1:
                raise MemoryError(
                    f"block pool too small for request {req.rid} "
                    f"at {req.num_computed + 1} tokens")
            return 0
        ok = self.bm.ensure(req.rid, req.num_computed + n)
        assert ok, "ensure failed after availability check"
        return n

    def _admit_one(self, copies: list[tuple[int, int]]) -> \
            tuple[int, Request]:
        """FCFS admission with prefix-cache sharing: the new table starts
        as the matched cached blocks, extended by host-resident blocks of
        swapped requests and then by blocks another replica published
        (both copied in, not recomputed); fresh blocks arrive chunk by
        chunk. A swap-preempted victim returns by swap-in, with no
        recompute chunk at all. The request's slot-state row (if any) is
        bound to its slot."""
        req = self.waiting.popleft()
        if self.bm is None:
            return self._bind_slot(req)
        if self.bm.is_swapped(req.rid):
            # its KV rows come back from the host tier byte for byte and
            # num_computed survived (hashed blocks whose device twin is
            # still cached revive without a copy)
            _, pairs = self.bm.swap_in(req.rid)
            self._pending_swap_ins.extend(pairs)
            self.n_swap_ins += 1
            return self._bind_slot(req)
        bs = self.bm.block_size
        total = req.context_len
        hits: list[int] = []
        hashes: list = []
        if self.enable_prefix_caching:
            hashes = extend_chain_hashes(req.hash_chain,
                                         req.prefill_tokens(), bs)
            hits = self.bm.match(hashes)

        def avail(extra=0):
            # free blocks left once adoption revives the cached-free hits
            n_revived = sum(1 for b in hits if self.bm.refcount(b) == 0)
            return max(0, self.bm.num_free - n_revived - extra)

        host_ext: list[int] = []
        if hashes and self._swap_enabled:
            hh = self.bm.match_host(hashes)
            if len(hh) > len(hits):
                host_ext = hh[len(hits):len(hits) + avail()]
        shared_pairs: list[tuple[int, bytes]] = []
        n_local = len(hits) + len(host_ext)
        if hashes and self.bm.shared is not None and n_local < len(hashes):
            shared_pairs = self.bm.shared.acquire(
                hashes[n_local:], limit=avail(len(host_ext)))
        n_cached = (n_local + len(shared_pairs)) * bs
        cow_idx = None
        if n_cached > total - 1:
            # Whole stream cached: recompute the last token for its logits.
            # Its KV write lands inside the final shared block — COW it, or
            # drop that hit when no spare block remains after adoption
            # revives the matched cached-free blocks. A final block copied
            # from a host tier is fresh (refcount 1): always writable in
            # place after the deregister below.
            n_cached = total - 1
            cow_idx = n_cached // bs
            if (not host_ext and not shared_pairs
                    and self.bm.refcount(hits[-1]) >= 1 and avail() < 1):
                hits = hits[:-1]
                n_cached = len(hits) * bs
                cow_idx = None
        self.bm.adopt(req.rid, hits)
        if host_ext:
            _, pairs = self.bm.host_copy_in(
                req.rid, host_ext,
                hashes[len(hits):len(hits) + len(host_ext)])
            self._pending_swap_ins.extend(pairs)
            self.host_hit_blocks += len(host_ext)
        if shared_pairs:
            # the same path, sourced from the shared pool; its slots stay
            # pinned until the engine's copies have landed (it releases)
            _, pairs = self.bm.host_copy_in(
                req.rid, [s for s, _ in shared_pairs],
                [h for _, h in shared_pairs])
            self._pending_shared_ins.extend(pairs)
            self.shared_hit_blocks += len(shared_pairs)
        req.num_computed = n_cached
        req.n_published = len(hits) + len(host_ext) + len(shared_pairs)
        self.cache_hit_tokens += n_cached
        if cow_idx is not None:
            src = self.bm.table(req.rid)[cow_idx]
            dst = self.bm.cow(req.rid, cow_idx)
            if dst is not None:
                copies.append((src, dst))
            else:
                # refcount was 1 (a revived cached block, or a fresh host
                # copy): the recompute writes its last position in place,
                # so pull it from the index first (a concurrent admission
                # must not adopt a block with a pending write); it
                # re-registers after the write
                self.bm.deregister(src)
                req.n_published = cow_idx
        return self._bind_slot(req)

    def _bind_slot(self, req: Request) -> tuple[int, Request]:
        slot = self.free_slots()[0]
        self.running[slot] = req
        self._join_order.append(slot)
        if self.sampling_buffer is not None:
            self.sampling_buffer.bind(req, slot)
        if self.slot_cache is not None:
            self.slot_cache.allocate(req.rid, slot)
        if self.on_admit is not None:
            self.on_admit(slot, req)
        return slot, req

    # -- progress / bookkeeping -------------------------------------------

    def note_progress(self, req: Request) -> None:
        """Publish content hashes for every block req has fully computed."""
        if not self.enable_prefix_caching:
            return
        bs = self.bm.block_size
        n_full = req.num_computed // bs
        if n_full <= req.n_published:
            return
        table = self.bm.table(req.rid)
        hashes = extend_chain_hashes(req.hash_chain,
                                     req.prefill_tokens(), bs)
        for j in range(req.n_published, n_full):
            self.bm.register(table[j], hashes[j])
        req.n_published = n_full

    def _pick_victim(self) -> int | None:
        for slot in reversed(self._join_order):         # newest first
            if slot in self.running:
                return slot
        return None

    def _release(self, req: Request, blocks: bool = True) -> None:
        """Release everything a running request holds: its block table
        (unless ``blocks`` is off: a swap-out moved it to the host), its
        slot-state row and its sampling row."""
        if blocks and self.bm is not None:
            self.bm.free(req.rid)
        if self.slot_cache is not None:
            self.slot_cache.free(req.rid)
        if self.sampling_buffer is not None:
            self.sampling_buffer.free(req.rid)

    def _preempt(self, slot: int) -> Request:
        """Evict one running request. With a host tier the cost model picks
        swap (its KV moves to host slots and ``num_computed`` survives) or
        recompute (blocks freed hash-retained; the prompt + generated
        tokens replay on re-admission) per victim."""
        req = self.running.pop(slot)
        self._join_order.remove(slot)
        if (self._swap_enabled and req.num_computed > 0
                and self.bm.can_swap_out(req.rid)
                and self.swap_cost.prefer_swap(
                    len(self.bm.table(req.rid)), req.num_computed)):
            self._pending_swap_outs.extend(self.bm.swap_out(req.rid))
            self._release(req, blocks=False)
            self.n_swap_preemptions += 1
        else:
            self._release(req)
            req.num_computed = 0
            req.n_published = 0
        req.n_preempted += 1
        self.n_preemptions += 1
        self.waiting.appendleft(req)
        return req

    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it lives: waiting (dropping any
        host-swapped KV) or running (released as at retirement: blocks
        freed hash-retained, slot and sampling rows freed). False for an
        unknown rid (already retired or never submitted), a no-op."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                del self.waiting[i]
                if self.bm is not None and self.bm.is_swapped(rid):
                    self.bm.swap_discard(rid)
                self.n_aborts += 1
                return True
        for slot, r in list(self.running.items()):
            if r.rid == rid:
                self.retire(slot)
                self.n_aborts += 1
                return True
        return False

    def retire(self, slot: int) -> Request:
        req = self.running.pop(slot)
        self._join_order.remove(slot)
        self._release(req)
        return req
