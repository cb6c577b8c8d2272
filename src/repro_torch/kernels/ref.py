"""Plain PyTorch oracles (port of ``repro.kernels.ref``): naive, exact,
densifying, and the step-by-step SSD recurrence ``ssd_ref``.
``paged_attention_ref`` is also the plain decode path the port runs on
the CPU, as the JAX package's ``ops.paged_attention`` does off the TPU.
Same op order as the JAX oracles: fp32 logits, masked softmax with
the all-masked guard, normalize in fp32, cast to the value dtype, then
multiply by V (``docs/kernels.md`` §The rounding convention). Quantized
pools (``k_scale``/``v_scale``: fp32 (num_blocks, block_size, K, 1)
per-row scales) dequantize right after the gather, through bf16 as the
kernels do in-tile."""

from __future__ import annotations

import torch

from repro_torch.models.quant import dequantize_kv, take_rows

NEG_INF = -1.0e30


def _softcap(logits, cap):
    return logits if cap is None else cap * torch.tanh(logits / cap)


def causal_mask(Sq, Skv, window, q_offset, device):
    """(Sq, Skv) bool: query row i, at absolute position q_offset + i, sees
    keys at or before its position (and only the last ``window`` of
    them with a window)."""
    d = (q_offset + torch.arange(Sq, device=device))[:, None] \
        - torch.arange(Skv, device=device)[None, :]
    ok = d >= 0
    if window is not None:
        ok &= d < window
    return ok


def _masked_logits(q, k, causal, window, cap, scale, q_offset):
    """fp32 logits (B, Sq, G, K, Skv), g-major (head h -> kv head h % K):
    scaled, softcapped, masked to NEG_INF."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, H // K, K, hd).float()
    logits = torch.einsum("bqgkh,bskh->bqgks", qg, k.float()) * scale
    logits = _softcap(logits, cap)
    if causal:
        ok = causal_mask(Sq, Skv, window, q_offset, q.device)
        logits = torch.where(ok[None, :, None, None, :], logits, NEG_INF)
    return logits


def attention_ref(q, k, v, *, causal=True, window=None, cap=None, scale=None,
                  q_offset=0):
    """Naive full-materialization attention. q: (B,Sq,H,hd); k/v: (B,Skv,K,hd)."""
    p = torch.softmax(_masked_logits(q, k, causal, window, cap, scale,
                                     q_offset), dim=-1)
    o = torch.einsum("bqgks,bskh->bqgkh", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def _gather_pages(pages, scale, block_tables):
    """(num_blocks, bs, K, hd) gathered through (B, nb) -> (B, nb*bs, K,
    hd); a quantized pool (``scale`` given) dequantizes after the gather."""
    B = block_tables.shape[0]
    _, _, K, hd = pages.shape
    bt = block_tables.long()
    g = take_rows(pages, bt).reshape(B, -1, K, hd)
    if scale is not None:
        g = dequantize_kv(g, scale[bt].reshape(B, -1, K, 1))
    return g


def paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                        window=None, cap=None, scale=None, k_scale=None,
                        v_scale=None):
    """Paged decode attention oracle.

    q: (B, H, hd); pages: (num_blocks, block_size, K, hd); block_tables:
    (B, nb) int32; ctx_lens: (B,) int32 (0 => zero output).
    """
    B, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = _gather_pages(k_pages, k_scale, block_tables)
    v = _gather_pages(v_pages, v_scale, block_tables)
    S = k.shape[1]
    qg = q.reshape(B, G, K, hd)
    logits = torch.einsum("bgkh,bskh->bgks", qg.float(), k.float()) * scale
    logits = _softcap(logits, cap)
    k_pos = torch.arange(S, device=q.device)
    ctx = ctx_lens.long()
    ok = k_pos[None, :] < ctx[:, None]                         # (B, S)
    if window is not None:
        ok &= k_pos[None, :] > ctx[:, None] - 1 - window
    ok = ok[:, None, None, :]
    logits = torch.where(ok, logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - mx), 0.0)  # ctx=0 rows -> all zero
    sm = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    p = (p / sm).to(v.dtype)
    o = torch.einsum("bgks,bskh->bgkh", p.float(), v.float())
    return o.reshape(B, H, hd).to(q.dtype)



def paged_attention_partial_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                                block_mask, *, window=None, cap=None,
                                scale=None, k_scale=None, v_scale=None):
    """Partial-softmax paged decode oracle for pool-sharded serving (the
    decode kernel's plain version with ``block_mask`` / ``return_lse``).

    ``paged_attention_ref``'s math, op for op, with keys also masked where
    their table entry's ``block_mask`` (B, nb) is zero (a shard attends
    only the pages it holds); returns ``(o, lse)``: o (B, H, hd) fp32, the
    locally normalized output, and lse (B, H) fp32, the log-sum-exp of the
    attended keys. A row that attended nothing has o = 0 and lse <= -1e30
    (zero weight in the stitch). With a full mask, o equals
    ``paged_attention_ref``'s before its cast to q's dtype, bit for bit.
    """
    B, H, hd = q.shape
    bs, K = k_pages.shape[1], k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = _gather_pages(k_pages, k_scale, block_tables)
    v = _gather_pages(v_pages, v_scale, block_tables)
    S = k.shape[1]
    qg = q.reshape(B, G, K, hd)
    logits = torch.einsum("bgkh,bskh->bgks", qg.float(), k.float()) * scale
    logits = _softcap(logits, cap)
    k_pos = torch.arange(S, device=q.device)
    ctx = ctx_lens.long()
    ok = k_pos[None, :] < ctx[:, None]                         # (B, S)
    if window is not None:
        ok &= k_pos[None, :] > ctx[:, None] - 1 - window
    ok &= (block_mask != 0).repeat_interleave(bs, dim=1)      # shard-local
    ok = ok[:, None, None, :]
    logits = torch.where(ok, logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - mx), 0.0)
    sm = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    lse = mx + torch.log(sm)
    p = (p / sm).to(v.dtype)
    o = torch.einsum("bgks,bskh->bgkh", p.float(), v.float())
    return o.reshape(B, H, hd), lse.reshape(B, H)


def paged_shard_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                              n_shards, *, window=None, cap=None,
                              scale=None, k_scale=None, v_scale=None):
    """LSE-stitch oracle for pool-sharded paged decode: ``n_shards``
    shards each hold a disjoint part of a sequence's pages (table entry j
    belongs to shard ``j % n_shards``), each computes its partial with
    ``paged_attention_partial_ref``, and the partials are stitched, each
    weighted by its share of the global softmax mass:

        m = max_i lse_i
        o = sum_i o_i exp(lse_i - m) / sum_i exp(lse_i - m)

    Agrees with ``paged_attention_ref`` for every n_shards. Returns (B, H,
    hd) in q's dtype; raises ValueError for n_shards < 1."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    B, nb = block_tables.shape
    entry = torch.arange(nb, device=block_tables.device)[None, :]
    parts = [paged_attention_partial_ref(
        q, k_pages, v_pages, block_tables, ctx_lens,
        (entry % n_shards == s).expand(B, nb).to(torch.int32),
        window=window, cap=cap, scale=scale, k_scale=k_scale,
        v_scale=v_scale) for s in range(n_shards)]
    os = torch.stack([o for o, _ in parts])            # (S, B, H, hd)
    lses = torch.stack([lse for _, lse in parts])      # (S, B, H)
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    den = torch.clamp(w.sum(dim=0), min=1e-37)
    out = (os * w[..., None]).sum(dim=0) / den[..., None]
    return out.to(q.dtype)

def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                                q_lens, *, window=None, cap=None, scale=None,
                                k_scale=None, v_scale=None):
    """Multi-query (chunked-prefill) paged attention oracle.

    q: (B, C, H, hd) — row i of sequence b is the query at absolute
    position ``ctx_lens[b] - q_lens[b] + i`` and attends causally to keys
    ``[0, position]`` through the block table. Rows at i >= q_lens[b] are
    padding and produce zeros. q_lens == 1 reduces to the decode oracle.
    """
    B, C, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = _gather_pages(k_pages, k_scale, block_tables)
    v = _gather_pages(v_pages, v_scale, block_tables)
    S = k.shape[1]
    qg = q.reshape(B, C, G, K, hd)
    logits = torch.einsum("bcgkh,bskh->bcgks", qg.float(), k.float()) * scale
    logits = _softcap(logits, cap)
    dev = q.device
    q_pos = (ctx_lens - q_lens).long()[:, None] + torch.arange(C, device=dev)
    k_pos = torch.arange(S, device=dev)
    ok = k_pos[None, None] <= q_pos[..., None]                      # causal
    if window is not None:
        ok &= k_pos[None, None] > q_pos[..., None] - window
    ok &= (torch.arange(C, device=dev)[None] < q_lens.long()[:, None])[..., None]
    ok = ok[:, :, None, None, :]
    logits = torch.where(ok, logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - mx), 0.0)
    sm = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    p = (p / sm).to(v.dtype)
    o = torch.einsum("bcgks,bskh->bcgkh", p.float(), v.float())
    return o.reshape(B, C, H, hd).to(q.dtype)



def paged_prefill_attention_partial_ref(q, k_pages, v_pages, block_tables,
                                        ctx_lens, q_lens, block_mask, *,
                                        window=None, cap=None, scale=None,
                                        k_scale=None, v_scale=None):
    """The chunk kernel's plain version with ``block_mask`` /
    ``return_lse``: ``paged_prefill_attention_ref``'s math with keys also
    masked where their table entry's ``block_mask`` (B, nb) is zero.
    Returns ``(o, lse)``: o (B, C, H, hd) fp32, lse (B, C, H) fp32; rows
    that attended nothing (padding rows, a masked-out context) have o = 0
    and lse <= -1e30. With q_lens == 1 and C == 1 it is
    ``paged_attention_partial_ref``'s row."""
    B, C, H, hd = q.shape
    bs, K = k_pages.shape[1], k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = _gather_pages(k_pages, k_scale, block_tables)
    v = _gather_pages(v_pages, v_scale, block_tables)
    S = k.shape[1]
    qg = q.reshape(B, C, G, K, hd)
    logits = torch.einsum("bcgkh,bskh->bcgks", qg.float(), k.float()) * scale
    logits = _softcap(logits, cap)
    dev = q.device
    q_pos = (ctx_lens - q_lens).long()[:, None] + torch.arange(C, device=dev)
    k_pos = torch.arange(S, device=dev)
    ok = k_pos[None, None] <= q_pos[..., None]                      # causal
    if window is not None:
        ok &= k_pos[None, None] > q_pos[..., None] - window
    ok &= (torch.arange(C, device=dev)[None] < q_lens.long()[:, None])[..., None]
    ok &= (block_mask != 0).repeat_interleave(bs, dim=1)[:, None]  # shard
    ok = ok[:, :, None, None, :]
    logits = torch.where(ok, logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - mx), 0.0)
    sm = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    lse = mx + torch.log(sm)
    p = (p / sm).to(v.dtype)
    o = torch.einsum("bcgks,bskh->bcgkh", p.float(), v.float())
    return o.reshape(B, C, H, hd), lse.reshape(B, C, H)

def ragged_paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                       ctx_lens, starts, ends, row_seq, *,
                                       window=None, cap=None, scale=None,
                                       k_scale=None, v_scale=None):
    """Packed (ragged) multi-sequence chunked-prefill oracle.

    q: (T, H, hd), the chunks of up to S sequences packed into one flat
    row batch; sequence s owns flat rows [starts[s], ends[s]) and row_seq
    maps each flat row to its owner. Flat row t (owned by s) is the query
    at absolute position ``ctx_lens[s] - (ends[s] - starts[s]) + (t -
    starts[s])`` and attends causally to sequence s's keys through
    block_tables[s] (the chunk's own KV already scattered). Rows owned by
    no sequence produce zeros. S == 1 with starts = [0] reduces to
    ``paged_prefill_attention_ref`` with B == 1.
    """
    T, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    S = starts.shape[0]
    scale = hd ** -0.5 if scale is None else scale
    k = _gather_pages(k_pages, k_scale, block_tables)     # (S, E, K, hd)
    v = _gather_pages(v_pages, v_scale, block_tables)
    E = k.shape[1]
    qg = q.reshape(T, G, K, hd)
    logits = torch.einsum("tgkh,sekh->tgkse", qg.float(), k.float()) * scale
    logits = _softcap(logits, cap)
    dev = q.device
    t = torch.arange(T, device=dev)
    st, en, rs = starts.long(), ends.long(), row_seq.long()
    own = (t[:, None] >= st[None]) & (t[:, None] < en[None]) \
        & (rs[:, None] == torch.arange(S, device=dev)[None])      # (T, S)
    q_pos = (ctx_lens.long() - (en - st))[rs] + (t - st[rs])
    k_pos = torch.arange(E, device=dev)
    ok = own[:, :, None] & (k_pos[None, None] <= q_pos[:, None, None])
    if window is not None:
        ok &= k_pos[None, None] > q_pos[:, None, None] - window
    ok = ok[:, None, None]                                 # (T, 1, 1, S, E)
    logits = torch.where(ok, logits, NEG_INF)
    # one softmax over the flattened (sequence, key) axes: exactly one
    # sequence is unmasked per row, so this is that sequence's softmax
    flat = logits.reshape(T, G, K, S * E)
    okf = ok.reshape(T, 1, 1, S * E)
    mx = flat.amax(dim=-1, keepdim=True)
    p = torch.where(okf, torch.exp(flat - mx), 0.0)    # unowned rows -> 0
    sm = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    p = (p / sm).to(v.dtype)
    o = torch.einsum("tgkf,fkh->tgkh", p.float(),
                     v.reshape(S * E, K, hd).float())
    return o.reshape(T, H, hd).to(q.dtype)


def ssd_ref(x, dt, A, B, C, h0=None):
    """Exact SSD recurrence, one step at a time.

    x: (b, S, nh, hp); dt: (b, S, nh); A: (nh,); B, C: (b, S, G, N).
    Returns (y (b, S, nh, hp) in x's dtype, h_last (b, nh, hp, N) fp32).
    """
    b, S, nh, hp = x.shape
    N = B.shape[3]
    rep = nh // B.shape[2]
    x32, dt32 = x.float(), dt.float()
    Bh = B.repeat_interleave(rep, dim=2).float()          # (b,S,nh,N)
    Ch = C.repeat_interleave(rep, dim=2).float()
    h = (torch.zeros((b, nh, hp, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dec = torch.exp(dt32[:, t] * A)                   # (b,nh)
        h = h * dec[..., None, None] + torch.einsum(
            "bh,bhs,bhp->bhps", dt32[:, t], Bh[:, t], x32[:, t])
        ys.append(torch.einsum("bhs,bhps->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=None, cap=None,
                              scale=None, q_offset=0):
    """Plain version of the flash kernel's forward: returns (o in q's
    dtype, lse (B, Sq, H) fp32). fp32 logits, softcap, masked to NEG_INF,
    lse = logsumexp of the masked logits, o = exp(logits - lse) @ v in
    fp32 (``repro.kernels.flash_attention._fwd_kernel`` untiled)."""
    logits = _masked_logits(q, k, causal, window, cap, scale, q_offset)
    lse = torch.logsumexp(logits, dim=-1)                 # (B, Sq, G, K)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bqgks,bskh->bqgkh", p, v.float())
    return o.reshape(q.shape).to(q.dtype), lse.reshape(q.shape[:3])


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True,
                              window=None, cap=None, scale=None, q_offset=0,
                              block_q=None):
    """Gradients (dq, dk, dv) of the flash forward from its residuals: a
    line-for-line port of ``repro.kernels.flash_attention._bwd_ref``, run
    over blocks of ``block_q`` query rows so that each fp32 (B, block_q, G,
    K, Skv) intermediate stays near 256 MB (one block at small shapes,
    which is ``_bwd_ref`` exactly). dk and dv sum over the blocks in fp32,
    which changes only the order of their sums."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    if block_q is None:
        block_q = max(1, (64 << 20) // max(1, B * H * Skv))
    k32, v32 = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for lo in range(0, Sq, block_q):
        hi = min(Sq, lo + block_q)
        n = hi - lo
        q32 = q[:, lo:hi].float().reshape(B, n, G, K, hd)
        do32 = do[:, lo:hi].float().reshape(B, n, G, K, hd)
        o32 = o[:, lo:hi].float().reshape(B, n, G, K, hd)
        lse_g = lse[:, lo:hi].reshape(B, n, G, K)
        u = torch.einsum("bqgkh,bskh->bqgks", q32, k32) * scale
        if cap is not None:
            z = cap * torch.tanh(u / cap)
            dz_du = 1.0 - torch.square(z / cap)
        else:
            z, dz_du = u, None
        if causal:
            ok = causal_mask(n, Skv, window, q_offset + lo, q.device)
            z = torch.where(ok[None, :, None, None, :], z, NEG_INF)
        p = torch.exp(z - lse_g[..., None])
        dv += torch.einsum("bqgks,bqgkh->bskh", p, do32)
        dp = torch.einsum("bqgkh,bskh->bqgks", do32, v32)
        delta = torch.sum(do32 * o32, dim=-1)                # (B,n,G,K)
        ds = p * (dp - delta[..., None])
        if dz_du is not None:
            ds = ds * dz_du
        ds = ds * scale
        dqs.append(torch.einsum("bqgks,bskh->bqgkh", ds, k32))
        dk += torch.einsum("bqgks,bqgkh->bskh", ds, q32)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def sampled_softmax_loss_ref(x, table, labels, sampled_ids, *, cap=None):
    """Sampled softmax (paper §4.2/§6.4): per-token loss over the true
    class and a shared set of sampled false classes, accidental hits
    (sampled id == label) masked out; mean over the T tokens, fp32.
    x: (T, d); table: (V, d); labels: (T,); sampled_ids: (n,)."""
    x32 = x.float()
    w_true = table[labels.long()].float()                 # (T, d)
    w_samp = table[sampled_ids.long()].float()            # (n, d)
    logit_true = torch.sum(x32 * w_true, dim=-1)          # (T,)
    logit_samp = x32 @ w_samp.T                           # (T, n)
    logit_true = _softcap(logit_true, cap)
    logit_samp = _softcap(logit_samp, cap)
    hit = sampled_ids.long()[None, :] == labels.long()[:, None]
    logit_samp = torch.where(hit, NEG_INF, logit_samp)
    allz = torch.cat([logit_true[:, None], logit_samp], dim=1)
    lse = torch.logsumexp(allz, dim=1)
    return torch.mean(lse - logit_true)
