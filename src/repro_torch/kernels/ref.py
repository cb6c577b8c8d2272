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


def attention_ref(q, k, v, *, causal=True, window=None, cap=None, scale=None,
                  q_offset=0):
    """Naive full-materialization attention. q: (B,Sq,H,hd); k/v: (B,Skv,K,hd)."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, G, K, hd).float()      # g-major: head h -> kv h % K
    logits = torch.einsum("bqgkh,bskh->bqgks", qg, k.float()) * scale
    logits = _softcap(logits, cap)
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        kp = torch.arange(Skv, device=q.device)
        d = qp[:, None] - kp[None, :]
        ok = d >= 0
        if window is not None:
            ok &= d < window
        logits = torch.where(ok[None, :, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bqgks,bskh->bqgkh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


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
