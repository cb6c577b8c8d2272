"""Plain PyTorch oracles (port of ``repro.kernels.ref``): naive, exact,
densifying. ``paged_attention_ref`` is also the plain decode path the port
runs on the CPU, as the JAX package's ``ops.paged_attention`` does off the
TPU. Same op order as the JAX oracles: fp32 logits, masked softmax with
the all-masked guard, normalize in fp32, cast to the value dtype, then
multiply by V (``docs/kernels.md`` §The rounding convention)."""

from __future__ import annotations

import torch

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


def _dense_pages(pages, block_tables):
    """(num_blocks, bs, K, hd) gathered through (B, nb) -> (B, nb*bs, K, hd)."""
    B = block_tables.shape[0]
    _, _, K, hd = pages.shape
    return pages[block_tables.long()].reshape(B, -1, K, hd)


def paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                        window=None, cap=None, scale=None):
    """Paged decode attention oracle.

    q: (B, H, hd); pages: (num_blocks, block_size, K, hd); block_tables:
    (B, nb) int32; ctx_lens: (B,) int32 (0 => zero output).
    """
    B, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    k = _dense_pages(k_pages, block_tables)
    v = _dense_pages(v_pages, block_tables)
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
                                q_lens, *, window=None, cap=None, scale=None):
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
    k = _dense_pages(k_pages, block_tables)
    v = _dense_pages(v_pages, block_tables)
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
