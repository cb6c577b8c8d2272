"""Mixture-of-experts block (port of ``repro.models.moe``, one device).

On one device the JAX package's ``moe_block`` picks mode "tp" (the mesh's
model axis is 1), where every expert is local and the combine's psum is
the identity: ``_moe_local`` is then the routing, the fixed expert
capacity, the dispatch, the expert FFN and the combine, which is what
this module computes. The expert-parallel modes (all-to-all, psum) and
grok-1's serving layout over both mesh axes need several devices
(ROADMAP.md queue 1 item 12). The load-balance loss the reference returns
beside the output (``_aux_loss``, from the routing) is only read in
training: ``moe_block(..., with_aux=True)`` returns it, and the serving
paths leave it out.

Capacity. Each call routes its T tokens (idle decode slots and chunk
padding rows included, as in the reference) to ``experts_per_token`` (k)
experts each, and each expert takes at most ``C = max(8, ceil(T k / E *
capacity_factor))`` of them. An assignment's position in its expert is
its rank in the token-major order of the (T, k) assignments, so the last
tokens are dropped first; a dropped assignment adds nothing.

The body has fixed shapes and never reads the host, so the serving
engine captures it in its CUDA graphs. The dispatch writes each kept
assignment into its own (expert, position) row, which no other
assignment shares; every dropped one writes zeros into one spare row that
is never read. So the result does not depend on the order of the writes,
and a graph replays it bit for bit. The three expert products are batched
matrix products over all E experts' C rows, empty or not, as the
reference's einsums are: a decode step reads every expert's weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def capacity(cfg: ModelConfig, T: int) -> int:
    """Rows per expert for a call routing T tokens."""
    mo = cfg.moe
    return max(8, int(math.ceil(T * mo.experts_per_token / mo.num_experts
                                * mo.capacity_factor)))


def _route(x, router, k: int):
    """x (T, d), router (d, E) in x's dtype -> (weights (T, k) fp32, idx
    (T, k) int64, probs (T, E) fp32). fp32 logits of the exact products;
    the top k by a stable descending sort, so that among equal
    probabilities the lower expert id wins, as ``jax.lax.top_k`` picks."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return w, idx, probs


def _one_hot(idx, E: int):
    """(..., ) int -> (..., E) int32, by comparison (no host read)."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).to(
        torch.int32)


def _aux_loss(probs, idx, E: int):
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    hits = _one_hot(idx, E).float().sum(dim=1)                    # (T, E)
    f = hits.mean(dim=0) / max(idx.shape[-1], 1)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def _positions_in_expert(idx, E: int):
    """idx (T, k) -> each assignment's rank within its expert (T, k), in
    the token-major order of the flattened assignments."""
    flat = idx.reshape(-1)
    oh = _one_hot(flat, E)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    return torch.gather(pos, 1, flat[:, None])[:, 0].reshape(idx.shape)


def _expert_ffn(disp, w_gate, w_in, w_out, act):
    """disp (E, C, d); weights (E, d, f) / (E, f, d) -> (E, C, d)."""
    g = act(torch.bmm(disp, w_gate))
    h = g * torch.bmm(disp, w_in)
    return torch.bmm(h, w_out)


def moe_local(x, params, cfg: ModelConfig, with_aux: bool = False):
    """The block on T flat tokens, every expert local. x (T, d) -> y (T,
    d) in x's dtype, and with ``with_aux`` the load-balance loss (fp32
    scalar) beside it."""
    mo = cfg.moe
    E, k = mo.num_experts, mo.experts_per_token
    T, d = x.shape
    C = capacity(cfg, T)
    act = _ACT["gelu" if cfg.mlp_activation == "gelu_mlp"
               else cfg.mlp_activation]

    w, idx, probs = _route(x, params["router"].to(x.dtype), k)
    pos = _positions_in_expert(idx, E)
    keep = pos < C
    # kept assignments to their own rows of the flat (E C + 1, d)
    # dispatch; dropped ones (zero rows) to the spare row E C
    dest = torch.where(keep, idx * C + pos, E * C).reshape(-1)
    xk = x[:, None, :].expand(T, k, d).reshape(T * k, d)
    contrib = torch.where(keep.reshape(-1, 1), xk, 0)
    disp = x.new_zeros((E * C + 1, d)).index_copy_(0, dest, contrib)
    comb = _expert_ffn(disp[:E * C].view(E, C, d),
                       params["w_gate"].to(x.dtype),
                       params["w_in"].to(x.dtype),
                       params["w_out"].to(x.dtype), act)
    lpos = pos.clamp(max=C - 1)
    got = comb.view(E * C, d)[(idx * C + lpos).reshape(-1)].view(T, k, d)
    wk = torch.where(keep, w, 0.0).to(x.dtype)
    # the weighted sum of each token's k rows: exact products, fp32 sums
    y = (got.float() * wk.float()[..., None]).sum(dim=1).to(x.dtype)
    return (y, _aux_loss(probs, idx, E)) if with_aux else y


def moe_block(params, x, cfg: ModelConfig, with_aux: bool = False):
    """x (B, S, d) -> y (B, S, d): the output of the JAX package's
    ``moe_block`` on a one-device mesh (mode "tp"); with ``with_aux``,
    (y, aux) as there."""
    B, S, d = x.shape
    out = moe_local(x.reshape(B * S, d), params, cfg, with_aux)
    if with_aux:
        return out[0].reshape(B, S, d), out[1]
    return out.reshape(B, S, d)
