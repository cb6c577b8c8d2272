"""Mamba2 (SSD, state-space duality) blocks: port of ``repro.models.ssm``.

The chunked SSD scan of arXiv:2405.21060: inside a chunk the recurrence is
a masked attention-like quadratic form, across chunks a small (heads,
head_dim, state) state is carried. ``ssd_chunked`` is the plain PyTorch
version; ``kernels.ops.ssd`` sends CUDA tensors to the hand-written kernel
(``csrc/ssd.cu``) and CPU tensors here, as the JAX package's ops run its
XLA path off the TPU. The decode recurrence and the causal conv stay plain
PyTorch on both devices, as they are plain jnp in the JAX package.

The op order is the JAX package's wherever it rounds in bf16: the chunk
conv is a per-tap bf16 multiply-add loop, the decode conv one einsum over
the window (two different roundings, kept apart), projections cast their
weights to the activation dtype, the gated norm runs in fp32.

Shapes (per block):
  x_in   (B, S, d_model)
  z, x   (B, S, d_inner)        d_inner = expand * d_model
  B, C   (B, S, G, N)           G = n_groups
  dt     (B, S, nh)             nh = d_inner / head_dim
  state  (B, nh, hp, N)         hp = ssm head_dim
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SSMConfig


def rms_norm_fp32(x, scale, eps: float = 1e-6):
    """Bare RMS norm (the gated SSM norm): fp32 inside, x's dtype out."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(dt)


def _causal_conv(x, w, left=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); ``left`` is the K-1
    rows of pre-sequence context (zeros when None: a fresh sequence).
    y_t = sum_k w[k] * x[t-K+1+k], one bf16 multiply-add per tap."""
    K, S = w.shape[0], x.shape[1]
    if left is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([left.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for k in range(K):
        y = y + w[k] * xp[:, k:k + S]
    return y


def segsum(log_a):
    """out[..., i, j] = sum_{j < m <= i} log_a[..., m] for i >= j, -inf
    above the diagonal. log_a: (..., T)."""
    T = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan (the plain version of the ``ssd`` kernel).

    x: (b, S, nh, hp); dt: (b, S, nh); A: (nh,) negative; B, C: (b, S, G,
    N); S a multiple of ``chunk``. Returns y (b, S, nh, hp) in x's dtype
    and the final state (b, nh, hp, N) fp32. fp32 inside."""
    b, S, nh, hp = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = nh // G
    dtype = x.dtype
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")

    xc = x.reshape(b, nc, chunk, nh, hp)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bh = B.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A                                        # (b,nc,Q,nh) log decay
    dA_cum = torch.cumsum(dA, dim=2)                    # within-chunk cumsum

    # intra-chunk (quadratic) term
    Lmask = segsum(dA.permute(0, 1, 3, 2))              # (b,nc,nh,Q,Q)
    CB = torch.einsum("bnqhs,bnkhs->bnhqk", Ch, Bh)
    scores = CB * torch.exp(Lmask)
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", scores, xdt)

    # chunk states + inter-chunk recurrence (two-operand products only: a
    # three-operand einsum picks its contraction order from the shapes, so
    # the number of chunks would change the rounding)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bnqhs,bnqhp->bnhps",
                          (decay_to_end * dtc)[..., None] * Bh,
                          xc)                            # (b,nc,nh,hp,N)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])         # (b,nc,nh)
    h = (torch.zeros((b, nh, hp, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_ins = []
    for n in range(nc):                                  # emit h_in per chunk
        h_ins.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_ins = torch.stack(h_ins, dim=1)                    # (b,nc,nh,hp,N)

    # inter-chunk output: y_i += exp(dA_cum_i) * C_i . h_in
    y_inter = torch.einsum("bnqhs,bnhps->bnqhp",
                           torch.exp(dA_cum)[..., None] * Ch, h_ins)
    y = (y_intra + y_inter).reshape(b, S, nh, hp)
    return y.to(dtype), h


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrence. x: (b, nh, hp); dt: (b, nh); B, C: (b, G,
    N); state: (b, nh, hp, N) fp32. Returns (y in x's dtype, new_state)."""
    rep = x.shape[1] // B.shape[1]
    x32, dt32 = x.float(), dt.float()
    Bh = B.repeat_interleave(rep, dim=1).float()         # (b,nh,N)
    Ch = C.repeat_interleave(rep, dim=1).float()
    dec = torch.exp(dt32 * A)                            # (b,nh)
    new_state = (state * dec[..., None, None]
                 + torch.einsum("bh,bhs,bhp->bhps", dt32, Bh, x32))
    y = torch.einsum("bhs,bhps->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------


def _split_proj(params, x):
    w = {k: params[k].to(x.dtype) for k in ("wz", "wx", "wbc", "wdt")}
    return x @ w["wz"], x @ w["wx"], x @ w["wbc"], x @ w["wdt"]


def _gates(params, dt):
    """softplus(dt + dt_bias) and A = -exp(A_log), fp32."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["A_log"].float())


def _scan(params, xh, dt, A, Bmat, Cmat, s: SSMConfig, h0):
    """The SSD scan over a chunk-padded sequence, then the D skip. dt=0
    padding is an exact identity step (decay exp(0) = 1, contribution
    dt*B*x = 0), so the state is untouched by it."""
    from repro_torch.kernels import ops
    S = xh.shape[1]
    pad = (-S) % s.chunk_size
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
    else:
        xh_p = xh
    y, h_last = ops.ssd(xh_p, dt, A, Bmat, Cmat, chunk=s.chunk_size, h0=h0)
    y = y[:, :S]
    return y + params["D"].float()[None, None, :, None] * xh, h_last


def _out(params, y, z, x_dtype):
    """Gated fp32 RMS norm, then the output projection."""
    y = rms_norm_fp32(y * F.silu(z.float()), params["norm_scale"])
    return y.to(x_dtype) @ params["w_out"].to(x_dtype)


def mamba_block(params, x, cfg: ModelConfig, state=None):
    """Full-sequence Mamba2 block. Returns (y, (conv_tail, ssm_state)) for
    decode continuation."""
    s: SSMConfig = cfg.ssm
    B_, S, d = x.shape
    di, nh, gn = s.d_inner(d), s.n_heads(d), s.n_groups * s.state_dim

    z, xi, bc, dt = _split_proj(params, x)
    conv_in_x, conv_in_bc = xi, bc
    xi = F.silu(_causal_conv(xi, params["conv_x"].to(x.dtype)))
    bc = F.silu(_causal_conv(bc, params["conv_bc"].to(x.dtype)))
    Bmat = bc[..., :gn].reshape(B_, S, s.n_groups, s.state_dim)
    Cmat = bc[..., gn:].reshape(B_, S, s.n_groups, s.state_dim)
    dt, A = _gates(params, dt)
    xh = xi.reshape(B_, S, nh, s.head_dim)
    y, h_last = _scan(params, xh, dt, A, Bmat, Cmat, s,
                      None if state is None else state[1])
    out = _out(params, y.reshape(B_, S, di), z, x.dtype)
    conv_tail = torch.cat([conv_in_x, conv_in_bc],
                          dim=-1)[:, -(s.conv_kernel - 1):, :]
    return out, (conv_tail, h_last)


def mamba_chunk(params, x, cfg: ModelConfig, state, q_lens):
    """One serving prefill chunk with explicit state continuation.

    x: (B, C, d), a right-padded chunk of the prompt; q_lens: (B,) valid
    tokens per row; state = (conv_tail (B, K-1, di+2gn), ssm_state (B, nh,
    hp, N)) from the previous chunk (zeros for a fresh sequence, which
    reproduces ``mamba_block``'s zero conv padding and zero h0 exactly).
    Returns (y (B, C, d), new_state).

    Padding rows are identity steps: dt is 0 past q_lens, so the carried
    state is bitwise untouched. When every chunk boundary falls on a
    multiple of ``cfg.ssm.chunk_size`` (the scheduler's chunk quantum; the
    final chunk is exempt), the SSD chunk grouping is a monolithic
    prefill's, so chunked and monolithic prefill agree bit for bit.
    """
    s: SSMConfig = cfg.ssm
    B_, C, d = x.shape
    di, nh, gn = s.d_inner(d), s.n_heads(d), s.n_groups * s.state_dim
    conv_tail, h0 = state

    z, xi, bc, dt = _split_proj(params, x)
    conv_in = torch.cat([xi, bc], dim=-1)                 # (B,C,di+2gn)
    xi = F.silu(_causal_conv(xi, params["conv_x"].to(x.dtype),
                             left=conv_tail[..., :di]))
    bc = F.silu(_causal_conv(bc, params["conv_bc"].to(x.dtype),
                             left=conv_tail[..., di:]))
    Bmat = bc[..., :gn].reshape(B_, C, s.n_groups, s.state_dim)
    Cmat = bc[..., gn:].reshape(B_, C, s.n_groups, s.state_dim)
    dt, A = _gates(params, dt)
    valid = torch.arange(C, device=x.device)[None] < q_lens[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)           # padding: identity
    xh = xi.reshape(B_, C, nh, s.head_dim)
    y, h_new = _scan(params, xh, dt, A, Bmat, Cmat, s, h0.float())
    out = _out(params, y.reshape(B_, C, di), z, x.dtype)
    # new conv tail: the last K-1 conv inputs ending at each row's q_len
    # (a row with q_len 0 keeps its previous tail)
    full_in = torch.cat([conv_tail.to(conv_in.dtype), conv_in], dim=1)
    idx = q_lens.long()[:, None] + torch.arange(s.conv_kernel - 1,
                                                device=x.device)
    new_tail = full_in[torch.arange(B_, device=x.device)[:, None], idx]
    return out, (new_tail, h_new)


def mamba_decode(params, x, cfg: ModelConfig, state):
    """Single-token decode. x: (B, 1, d); state = (conv_tail (B, K-1,
    di+2gn), ssm_state (B, nh, hp, N)). Returns (y (B, 1, d), new_state)."""
    s: SSMConfig = cfg.ssm
    B_, _, d = x.shape
    di, nh, gn = s.d_inner(d), s.n_heads(d), s.n_groups * s.state_dim
    conv_tail, h = state

    z, xi, bc, dt = _split_proj(params, x)
    conv_new = torch.cat([xi, bc], dim=-1)                # (B,1,di+2gn)
    window = torch.cat([conv_tail, conv_new], dim=1)      # (B,K,di+2gn)
    w_full = torch.cat([params["conv_x"].to(x.dtype),
                        params["conv_bc"].to(x.dtype)], dim=-1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w_full))
    xi1, bc1 = conv_out[..., :di], conv_out[..., di:]
    Bmat = bc1[..., :gn].reshape(B_, s.n_groups, s.state_dim)
    Cmat = bc1[..., gn:].reshape(B_, s.n_groups, s.state_dim)
    dt1, A = _gates(params, dt[:, 0])
    xh = xi1.reshape(B_, nh, s.head_dim)
    y, h_new = ssd_decode_step(h, xh, dt1, A, Bmat, Cmat)
    y = y + params["D"].float()[None, :, None] * xh
    y = rms_norm_fp32(y.reshape(B_, di) * F.silu(z[:, 0].float()),
                      params["norm_scale"])
    out = y.to(x.dtype) @ params["w_out"].to(x.dtype)
    return out[:, None, :], (window[:, 1:, :], h_new)
