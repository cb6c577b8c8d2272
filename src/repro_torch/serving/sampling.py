"""Per-request token sampling (port of ``repro.serving.sampling``).

Temperature 0 is exact greedy: the argmax of the fp32 logits, no random
numbers. Otherwise a row is transformed and one token is drawn with
``jax.random.categorical`` under the reference's own key::

    key = fold_in(fold_in(PRNGKey(seed), rid), counter)

counter being the tokens the request has generated so far, computed with
``serving.prng``, which reproduces jax's threefry bits. A request's
stream is a pure function of (seed, rid, step), the same under any batch
composition, slot, preemption-recompute and device, and equal to the
JAX engine's: the port draws the reference's tokens, up to a near-tie
where ``log`` rounds its last bit otherwise.

Speculative decoding adds three streams per (seed, rid, counter), each a
tag folded last onto the base key: ``_DRAFT`` (the draft's proposal),
``_ACCEPT`` (the accept/reject uniform) and ``_RESID`` (the residual
sample on rejection). With K = 0 draft tokens the verify step consumes
the plain stream, so it is ``sample_tokens``.

Two paths share the streams, as in the reference:

* the **plain path** (``sample_tokens``, ``propose_tokens``,
  ``speculative_verify``): greedy, temperature and top-k; the transform
  is ``prep_logits``;
* the **full path** (``sample_tokens_full``, ``propose_tokens_full``,
  ``speculative_verify_full``) adds repetition, presence and frequency
  penalties over per-row token counts, top-p and min-p (one shared sort
  with top-k) and per-token logprobs. Every full-path transform is a
  bitwise identity at its default, so a plain request drawn through the
  full path gets the plain path's tokens.

Every function here is tensor operations over device inputs (rows
(N, V), per-row parameters (N,)), with no host read, so the serving
engine runs it inside its step body and captures it in the step's CUDA
graph. :class:`SamplingBuffer` is the host-side per-slot state of the
full path (prompt masks, output counts, stop rings), rebuilt from a
request's own (prompt, out) at every bind.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving import prng

NEG = -1.0e30

# stream tags folded into the per-(seed, rid, counter) base key
_DRAFT = 1
_ACCEPT = 2
_RESID = 3

# the full path's per-row inputs: parameter vectors (N,) and the dense
# count state pmask (N, V) bool and ocounts (N, V) int32
SP_KEYS = ("temps", "top_ks", "top_ps", "min_ps", "rep_pens", "pres_pens",
           "freq_pens", "seeds", "rids", "counters", "pmask", "ocounts")


def _rows(x, dtype, device):
    """A per-row parameter (tensor, array or sequence) as a tensor."""
    if isinstance(x, (list, tuple, np.ndarray)):
        x = np.array(x)                   # a writable copy for torch
    return torch.as_tensor(x, device=device).to(dtype)


def base_key(seeds, rids, counters, tag=None):
    """The keys of (seed, rid, counter) rows: fold_in(fold_in(PRNGKey(
    seed), rid), counter), then the tag (an int) when given."""
    k = prng.fold_in(prng.fold_in(prng.key(seeds), rids), counters)
    return k if tag is None else prng.fold_in(k, tag)


def _kth_largest(srt, k):
    """srt: rows sorted ascending; k: (N,) ints -> (N, 1) the k-th
    largest value of each row (k clipped to [1, V])."""
    V = srt.shape[-1]
    idx = (V - k.clamp(1, V)).long()
    return torch.gather(srt, -1, idx.expand(srt.shape[:-1])[..., None])


def prep_logits(lg, t, k):
    """Temperature-scale + top-k-truncate (N, V) fp32 rows (or one (V,)
    row) with per-row t and k (0 disables truncation): the reference's
    ``_prep_logits``, bit for bit. The transform every plain path shares,
    so draft proposals (q) and target verification (p) see one
    distribution."""
    t = _rows(t, torch.float32, lg.device)
    k = _rows(k, torch.int32, lg.device)
    lg = lg / torch.clamp_min(t, 1e-6)[..., None]
    kth = _kth_largest(torch.sort(lg, dim=-1).values, k)
    return torch.where((k[..., None] > 0) & (lg < kth), NEG, lg)


def _draw(logits, trans, temps, key):
    """Greedy rows take the argmax of ``logits``; the rest a categorical
    draw from ``trans`` under their keys."""
    greedy = torch.argmax(logits, dim=-1)
    sampled = prng.categorical(key, trans)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


def _sample_stream(logits, temps, top_ks, seeds, rids, counters, tag=None):
    """One greedy / temperature / top-k pass over (N, V) rows. Key
    derivation, in this order: PRNGKey(seed), rid, counter, then the tag
    when given. Greedy rows consume no randomness (their key is derived
    and never used), so mixing greedy and sampled rows moves no one's
    stream."""
    dev = logits.device
    temps = _rows(temps, torch.float32, dev)
    key = base_key(_rows(seeds, torch.int64, dev), _rows(rids, torch.int64,
                                                         dev),
                   _rows(counters, torch.int64, dev), tag)
    return _draw(logits, prep_logits(logits, temps, top_ks), temps, key)


def sample_tokens(logits, temps, top_ks, seeds, rids, counters):
    """logits: (N, V) fp32; temps, top_ks, seeds, rids, counters: (N,)
    (top_k 0 disables truncation). Returns (N,) int32 on logits'
    device."""
    return _sample_stream(logits, temps, top_ks, seeds, rids, counters)


def propose_tokens(logits, temps, top_ks, seeds, rids, counters):
    """Draft proposals: ``sample_tokens`` on the ``_DRAFT`` stream, so a
    proposal never consumes the randomness the verify step uses at the
    same counter."""
    return _sample_stream(logits, temps, top_ks, seeds, rids, counters,
                          tag=_DRAFT)


def _flat(x, n):
    """(B, ...) -> (B * n, ...): each row repeated n times in place."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:]).reshape(
        x.shape[0] * n, *x.shape[1:])


def _accept_and_fill(d_toks, p_lg, q_lg, t_arg, greedy, keys_at):
    """The rejection-sampling core shared by both verifiers, over (B, K)
    proposals: p_lg (B, K + 1, V) and q_lg (B, K, V) transformed rows,
    t_arg (B, K + 1) the target argmaxes, greedy (B,) rows at t <= 0 and
    ``keys_at(i, tag)`` the (B, 2) keys at counter c0 + i. Returns
    (tokens (B, K + 1) int32, n_accept (B,) int32)."""
    B, K1, V = p_lg.shape
    K = K1 - 1
    p = torch.softmax(p_lg, dim=-1)
    q = torch.softmax(q_lg, dim=-1)
    acc_keys = torch.stack([keys_at(i, _ACCEPT) for i in range(K)], dim=1)
    u = prng.uniform(acc_keys, 1)[..., 0]                      # (B, K)
    d = d_toks.long()[..., None]
    p_d = torch.gather(p[:, :K], -1, d)[..., 0]
    q_d = torch.gather(q, -1, d)[..., 0]
    acc_temp = u < p_d / torch.clamp_min(q_d, 1e-37)
    acc = torch.where(greedy[:, None], d_toks == t_arg[:, :K], acc_temp)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    # a residual sample at every possible rejection point (only the
    # n_acc-th is used); p where p <= q pointwise (rejection impossible)
    resid = torch.clamp_min(p[:, :K] - q, 0.0)
    r_lg = torch.where(resid.sum(-1, keepdim=True) > 0,
                       torch.log(torch.clamp_min(resid, 1e-37)), p_lg[:, :K])
    res_keys = torch.stack([keys_at(i, _RESID) for i in range(K)], dim=1)
    r_toks = prng.categorical(res_keys, r_lg)
    # the bonus token when all K are accepted: the plain stream at c0 + K
    fresh = prng.categorical(keys_at(K, None), p_lg[:, K])
    pos = torch.arange(K, device=p_lg.device)
    out_temp = torch.cat([torch.where(pos < n_acc[:, None], d_toks.long(),
                                      r_toks), fresh[:, None]], dim=1)
    out = torch.where(greedy[:, None], t_arg, out_temp)
    return out.to(torch.int32), n_acc.to(torch.int32)


def _keys_at(seeds, rids, c0):
    def at(i, tag):
        return base_key(seeds, rids, c0 + i, tag)
    return at


def speculative_verify(draft_tokens, draft_logits, target_logits,
                       temps, top_ks, seeds, rids, counters):
    """Accept/reject K draft tokens against K + 1 target rows.

    draft_tokens: (B, K) proposals from :func:`propose_tokens`;
    draft_logits: (B, K, V) the logits they came from; target_logits:
    (B, K + 1, V), row i the target's distribution at counter
    ``counters + i``. Returns (tokens (B, K + 1) int32, n_accept (B,)
    int32): row b's new tokens are ``tokens[b, :n_accept[b] + 1]``.

    Temperature 0 accepts while the draft token is the target argmax and
    emits the target argmaxes (greedy speculation is plain greedy).
    Otherwise standard rejection sampling: accept draft token d at
    position i with probability min(1, p_i(d) / q_i(d)); at the first
    rejection emit a sample of the residual max(p_i - q_i, 0); after K
    acceptances a bonus sample of p_K on the plain stream, which makes
    K = 0 :func:`sample_tokens`."""
    B, K1, V = target_logits.shape
    K = K1 - 1
    dev = target_logits.device
    temps = _rows(temps, torch.float32, dev)
    top_ks = _rows(top_ks, torch.int32, dev)
    seeds, rids, c0 = (_rows(x, torch.int64, dev)
                       for x in (seeds, rids, counters))
    greedy = temps <= 0.0
    t_arg = torch.argmax(target_logits, dim=-1)
    p_lg = prep_logits(target_logits.reshape(B * K1, V), _flat(temps, K1),
                       _flat(top_ks, K1)).reshape(B, K1, V)
    keys_at = _keys_at(seeds, rids, c0)
    if K == 0:
        fresh = prng.categorical(keys_at(0, None), p_lg[:, 0])
        out = torch.where(greedy[:, None], t_arg, fresh[:, None])
        return out.to(torch.int32), torch.zeros(B, dtype=torch.int32,
                                                device=dev)
    q_lg = prep_logits(draft_logits.reshape(B * K, V), _flat(temps, K),
                       _flat(top_ks, K)).reshape(B, K, V)
    return _accept_and_fill(draft_tokens, p_lg, q_lg, t_arg, greedy, keys_at)


def greedy_verify(draft_tokens, target_logits):
    """``speculative_verify`` of rows that are all greedy, without the
    draws: accept while the draft token is the target argmax; the tokens
    are the target argmaxes."""
    t_arg = torch.argmax(target_logits, dim=-1).to(torch.int32)
    K = draft_tokens.shape[1]
    acc = (draft_tokens == t_arg[:, :K]).to(torch.int32)
    return t_arg, torch.cumprod(acc, dim=1).sum(dim=1).to(torch.int32)


# -- full sampling path: penalties + top-p/min-p/top-k + logprobs ----------


def _penalize(lg, pmask, ocounts, rep, pres, freq):
    """Repetition / presence / frequency penalties on (N, V) rows with
    (N,) parameters (vLLM semantics): repetition divides positive logits
    (multiplies negative ones) of every token in the prompt or the output
    so far; frequency subtracts ``freq * count``; presence subtracts
    ``pres`` once per distinct output token. At the defaults (1, 0, 0)
    every op is a bitwise identity."""
    seen = pmask | (ocounts > 0)
    rep = rep[:, None]
    lg = torch.where(seen, torch.where(lg > 0, lg / rep, lg * rep), lg)
    return (lg - freq[:, None] * ocounts.to(lg.dtype)
            - pres[:, None] * (ocounts > 0).to(lg.dtype))


def _truncate(lg, k, top_p, min_p):
    """Top-k + top-p + min-p truncation of temperature-scaled (N, V) rows
    with (N,) parameters. One shared sort serves all three: the k-th
    largest, the descending cumulative mass for top-p (a rank is kept when
    the mass before it is below top_p, so one survives) and the row max
    for min-p's threshold max + log(min_p). The gates k > 0, top_p < 1 and
    min_p > 0 empty each mask at its default, so the defaults give the
    plain ``prep_logits`` bits. A row masked everywhere keeps its
    argmax."""
    V = lg.shape[-1]
    srt = torch.sort(lg, dim=-1).values
    mask = (k[:, None] > 0) & (lg < _kth_largest(srt, k))
    desc = torch.flip(srt, dims=(-1,))
    probs = torch.softmax(desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs     # mass ahead of rank i
    n_keep = torch.clamp_min((before < top_p[:, None]).sum(-1), 1)
    cut = torch.gather(desc, -1, (n_keep - 1)[:, None])
    mask |= (top_p[:, None] < 1.0) & (lg < cut)
    mask |= (min_p[:, None] > 0.0) & (lg < srt[:, -1:]
                                      + torch.log(min_p)[:, None])
    out = torch.where(mask, NEG, lg)
    cols = torch.arange(V, device=lg.device)
    only_max = torch.where(cols == torch.argmax(lg, -1, keepdim=True), lg,
                           NEG)
    return torch.where(mask.all(-1, keepdim=True), only_max, out)


def _prep_logits_full(lg, pmask, ocounts, t, k, top_p, min_p, rep, pres,
                      freq):
    """Full-path analogue of :func:`prep_logits` over (N, V) rows:
    penalties, the same temperature scale, then the shared-sort
    truncation. At the default penalties, top-p and min-p this is
    ``prep_logits(lg, t, k)`` bit for bit."""
    pen = _penalize(lg, pmask, ocounts, rep, pres, freq)
    return _truncate(pen / torch.clamp_min(t, 1e-6)[:, None], k, top_p,
                     min_p)


def _row_logprobs(pen, t, tok, n_top: int):
    """Logprobs reported per emitted token: log-softmax of the penalized,
    pre-truncation rows (N, V), sampled rows scaled by their temperature,
    greedy rows unscaled. Returns (chosen (N,), top_lp (N, n_top),
    top_ids (N, n_top) int32)."""
    scale = torch.where(t > 0.0, torch.clamp_min(t, 1e-6), 1.0)
    logp = torch.log_softmax(pen / scale[:, None], dim=-1)
    top_lp, top_ids = torch.topk(logp, n_top, dim=-1)
    chosen = torch.gather(logp, -1, tok.long()[:, None])[:, 0]
    return chosen, top_lp, top_ids.to(torch.int32)


def _sp_rows(sp, dev):
    """The full path's inputs as tensors of the reference's dtypes."""
    f32 = ("temps", "top_ps", "min_ps", "rep_pens", "pres_pens",
           "freq_pens")
    out = {k: _rows(sp[k], torch.float32, dev) for k in f32}
    out.update({k: _rows(sp[k], torch.int64, dev)
                for k in ("seeds", "rids", "counters")})
    out["top_ks"] = _rows(sp["top_ks"], torch.int32, dev)
    out["pmask"] = _rows(sp["pmask"], torch.bool, dev)
    out["ocounts"] = _rows(sp["ocounts"], torch.int32, dev)
    return out


def _sample_stream_full(logits, sp, tag=None, max_logprobs=8):
    """Full-pipeline counterpart of :func:`_sample_stream` over (N, V)
    rows: the same keys (greedy rows consume none) and draw, a richer
    transform. Greedy rows take the argmax of the transformed row (the
    raw argmax at the defaults, penalty-aware otherwise). Returns
    (tokens (N,) int32, {"chosen": (N,), "top_lp": (N, L), "top_ids":
    (N, L)}) with L = min(max_logprobs, V)."""
    sp = _sp_rows(sp, logits.device)
    L = min(max_logprobs, logits.shape[-1])
    t = sp["temps"]
    pen = _penalize(logits, sp["pmask"], sp["ocounts"], sp["rep_pens"],
                    sp["pres_pens"], sp["freq_pens"])
    trunc = _truncate(pen / torch.clamp_min(t, 1e-6)[:, None], sp["top_ks"],
                      sp["top_ps"], sp["min_ps"])
    key = base_key(sp["seeds"], sp["rids"], sp["counters"], tag)
    tok = _draw(trunc, trunc, t, key)
    chosen, top_lp, top_ids = _row_logprobs(pen, t, tok, L)
    return tok, {"chosen": chosen, "top_lp": top_lp, "top_ids": top_ids}


def sample_tokens_full(logits, sp, *, max_logprobs=8):
    """Full-pipeline sampling over (N, V) rows. ``sp`` holds the
    :data:`SP_KEYS` inputs: (N,) parameters, ``pmask`` (N, V) bool and
    ``ocounts`` (N, V) int32. Returns (tokens, logprobs); see
    :func:`_sample_stream_full`."""
    return _sample_stream_full(logits, sp, max_logprobs=max_logprobs)


def propose_tokens_full(logits, sp):
    """Full-pipeline draft proposals (``_DRAFT`` stream). The caller's
    ``ocounts`` already count every earlier proposal of this speculative
    window, so proposal i and verify row i see the same counts."""
    return _sample_stream_full(logits, sp, tag=_DRAFT)[0]


def one_hot(tokens, V: int, dtype=torch.int32):
    """(N,) ids -> (N, V) one-hot rows (a comparison, no host check)."""
    cols = torch.arange(V, device=tokens.device)
    return (tokens.long()[..., None] == cols).to(dtype)


def speculative_verify_full(draft_tokens, draft_logits, target_logits, sp,
                            *, max_logprobs=8):
    """Full-pipeline accept/reject: :func:`speculative_verify`'s protocol
    and streams with p and q both from the full transform, so rejection
    sampling preserves the transformed target distribution. Verify row i
    (and the bonus row K) counts ``ocounts`` plus the one-hots of the
    draft tokens before i, as :func:`propose_tokens_full` did for
    proposal i. Greedy rows accept while the draft token is the argmax of
    the transformed target row. Returns (tokens (B, K + 1), n_accept
    (B,), {"chosen": (B, K + 1), "top_lp": (B, K + 1, L), "top_ids":
    (B, K + 1, L)})."""
    B, K1, V = target_logits.shape
    K = K1 - 1
    dev = target_logits.device
    sp = _sp_rows(sp, dev)
    L = min(max_logprobs, V)
    oc = sp["ocounts"][:, None]
    counts = torch.cat([oc, oc + torch.cumsum(one_hot(draft_tokens, V),
                                              dim=1)], dim=1)
    t = sp["temps"]
    par = {n: sp[n] for n in ("top_ks", "top_ps", "min_ps", "rep_pens",
                              "pres_pens", "freq_pens")}
    par["temps"] = t

    def transform(lg, cnt, n):
        """(B, n, V) rows with counts cnt -> (penalized, transformed)."""
        f = {k: _flat(v, n) for k, v in par.items()}
        pen = _penalize(lg.reshape(B * n, V), _flat(sp["pmask"], n),
                        cnt.reshape(B * n, V), f["rep_pens"], f["pres_pens"],
                        f["freq_pens"])
        tr = _truncate(pen / torch.clamp_min(f["temps"], 1e-6)[:, None],
                       f["top_ks"], f["top_ps"], f["min_ps"])
        return pen, tr.reshape(B, n, V)

    pen, p_lg = transform(target_logits, counts, K1)
    t_arg = torch.argmax(p_lg, dim=-1)
    greedy = t <= 0.0
    keys_at = _keys_at(sp["seeds"], sp["rids"], sp["counters"])
    if K == 0:
        fresh = prng.categorical(keys_at(0, None), p_lg[:, 0])
        out = torch.where(greedy[:, None], t_arg,
                          fresh[:, None]).to(torch.int32)
        n_acc = torch.zeros(B, dtype=torch.int32, device=dev)
    else:
        _, q_lg = transform(draft_logits, counts[:, :K], K)
        out, n_acc = _accept_and_fill(draft_tokens, p_lg, q_lg, t_arg,
                                      greedy, keys_at)
    chosen, top_lp, top_ids = _row_logprobs(pen, _flat(t, K1),
                                            out.reshape(-1), L)
    return out, n_acc, {"chosen": chosen.reshape(B, K1),
                        "top_lp": top_lp.reshape(B, K1, L),
                        "top_ids": top_ids.reshape(B, K1, L)}


class SamplingBuffer:
    """Host-side dense per-slot state of the full path: one row per batch
    slot with the request's prompt-presence mask, its generated-token
    counts and a ring of its most recent tokens for stop matching. Rows
    are bound at admission (``bind``), updated as tokens are accepted
    (``commit``) and released at retirement or preemption (``free``).

    ``bind`` rebuilds a row from the request's own (prompt, out), and only
    accepted tokens are committed, so preemption-recompute and the
    speculative rollback land in the state of the uninterrupted run with
    no rewind path.

    Rows are ``width`` columns (the model's padded vocabulary, the width
    of its logit rows); ids at or past ``vocab_size`` are never counted,
    so the padding columns stay unseen."""

    def __init__(self, max_batch: int, vocab_size: int, *,
                 width: int | None = None, max_stop_len: int = 8,
                 max_logprobs: int = 8):
        self.max_batch = max_batch
        self.vocab_size = vocab_size
        self.width = vocab_size if width is None else width
        self.max_stop_len = max_stop_len
        self.max_logprobs = max_logprobs
        self.pmask = np.zeros((max_batch, self.width), bool)
        self.ocounts = np.zeros((max_batch, self.width), np.int32)
        self.rings = np.zeros((max_batch, max_stop_len), np.int32)
        self.ring_len = np.zeros(max_batch, np.int32)
        self._slot_of: dict[int, int] = {}

    def validate(self, req) -> None:
        """Refuse, by name, a request whose parameters no path serves."""
        sp = req.sampling
        if not 0.0 < sp.top_p <= 1.0:
            raise ValueError(f"request {req.rid}: top_p={sp.top_p} "
                             "must be in (0, 1]")
        if not 0.0 <= sp.min_p <= 1.0:
            raise ValueError(f"request {req.rid}: min_p={sp.min_p} "
                             "must be in [0, 1]")
        if sp.repetition_penalty <= 0.0:
            raise ValueError(
                f"request {req.rid}: repetition_penalty="
                f"{sp.repetition_penalty} must be > 0")
        if sp.logprobs < 0 or sp.logprobs > self.max_logprobs:
            raise ValueError(
                f"request {req.rid}: logprobs={sp.logprobs} must be in "
                f"[0, max_logprobs={self.max_logprobs}] (raise the "
                "engine's max_logprobs knob for more)")
        for s in sp.stop:
            if not s or len(s) > self.max_stop_len:
                raise ValueError(
                    f"request {req.rid}: stop sequence length {len(s)} "
                    f"must be in [1, max_stop_len={self.max_stop_len}]")
        if req.min_new > req.max_new:
            raise ValueError(
                f"request {req.rid}: min_new={req.min_new} exceeds "
                f"max_new={req.max_new}")

    def bind(self, req, slot: int) -> None:
        """(Re)bind a request's row, rebuilt from its (prompt, out)."""
        self._slot_of[req.rid] = slot
        self.pmask[slot] = False
        ids = np.asarray(req.prompt, np.int64)
        self.pmask[slot][ids[(ids >= 0) & (ids < self.vocab_size)]] = True
        self.ocounts[slot] = 0
        if req.out:
            out = np.asarray(req.out, np.int64)
            np.add.at(self.ocounts[slot],
                      out[(out >= 0) & (out < self.vocab_size)], 1)
        tail = req.out[-self.max_stop_len:]
        self.rings[slot] = 0
        self.rings[slot, :len(tail)] = tail
        self.ring_len[slot] = len(tail)

    def free(self, rid: int) -> None:
        """Release a request's row; an unknown rid is a no-op."""
        slot = self._slot_of.pop(rid, None)
        if slot is None:
            return
        self.pmask[slot] = False
        self.ocounts[slot] = 0
        self.rings[slot] = 0
        self.ring_len[slot] = 0

    def commit(self, rid: int, tok: int) -> None:
        """Account one accepted token: bump its count, push the ring."""
        slot = self._slot_of[rid]
        if 0 <= tok < self.vocab_size:
            self.ocounts[slot, tok] += 1
        n = int(self.ring_len[slot])
        if n < self.max_stop_len:
            self.rings[slot, n] = tok
            self.ring_len[slot] = n + 1
        else:
            self.rings[slot, :-1] = self.rings[slot, 1:]
            self.rings[slot, -1] = tok

    def check_stop(self, rid: int, stops) -> tuple | None:
        """The first stop sequence matching the ring's tail, or None."""
        slot = self._slot_of[rid]
        n = int(self.ring_len[slot])
        for s in stops:
            m = len(s)
            if m <= n and list(self.rings[slot, n - m:n]) == list(s):
                return tuple(s)
        return None

    def row(self, rid: int) -> tuple:
        """(pmask_row, ocounts_row) views of one bound request."""
        slot = self._slot_of[rid]
        return self.pmask[slot], self.ocounts[slot]
