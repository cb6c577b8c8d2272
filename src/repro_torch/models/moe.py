"""Mixture-of-experts block (port of ``repro.models.moe``).

``moe_block`` picks the JAX package's mode from the serving mesh
(``spmd.collectives.serving``), the expert count E and the call's
sequence length S, as its ``moe_block`` picks it from the mesh (tp the
"model" axis' size):

- "tp" without a mesh, or where tp does not divide E (or E < tp): every
  expert on every rank, with a 1 / tp slice of the expert d_ff where tp
  > 1; the partial combine is summed over "model".
- "ep_a2a" where tp divides E and S: each rank routes its S / tp slice
  of the sequence, with a capacity from its own T = B S / tp rows; the
  (E, C, d) dispatch goes through an all-to-all to the ranks owning the
  experts (E / tp each), their (E / tp, tp C, d) rows through the FFN,
  back through a second all-to-all, the combine, and an exact gather of
  the slices along S.
- "ep_psum" where tp divides E but not S (every decode step): every rank
  routes all T rows, with the capacity of the whole T, and computes its
  E / tp experts' rows only; each token's contributions are summed over
  "model" in fp32 and rounded once.
- "f2d" (grok-1's serving layout, ``ParallelConfig.expert_ff_2d``, which
  the engine puts in its ``ServeMesh``): mode "tp" with the expert d_ff
  over both axes, (data, model), tokens whole on every rank, the combine
  summed over the whole mesh.

Without ``f2d`` a data axis splits the batch rows where it divides B,
as the reference's ``shard_map`` in_specs do (each data shard routes its
rows with their own capacity), and the rows are gathered back. Under
"ep_a2a" (and a data split) the capacity is a shard's, so a mesh
changes which assignments drop: at the default capacity factor its
output is not one device's (docs/torch-serving-mesh.md). The other modes
drop what one device drops and differ only in the order of their sums.

Weights may be whole on every rank (``shard_params=False``): each rank
then takes its experts or d_ff columns from the whole leaves, as the
reference's in_specs cut them. Or they hold the rank's shard already
(``spmd.sharding.serving_layouts``: experts cut for "ep_*", d_ff for
"tp" and ``f2d``), and are used as they are.

The load-balance loss the reference returns beside the output
(``_aux_loss``, from the routing) is only read in training:
``moe_block(..., with_aux=True)`` returns it (a shard's mean over the
ranks that routed other rows), and the serving paths leave it out.

Capacity. Each call routes its T tokens (idle decode slots and chunk
padding rows included, as in the reference) to ``experts_per_token`` (k)
experts each, and each expert takes at most ``C = max(8, ceil(T k / E *
capacity_factor))`` of them. An assignment's position in its expert is
its rank in the token-major order of the (T, k) assignments, so the last
tokens are dropped first; a dropped assignment adds nothing.

The body has fixed shapes and never reads the host, so the serving
engine captures it in its CUDA graphs (one device). The dispatch writes
each kept assignment into its own (expert, position) row, which no other
assignment shares; every dropped one (and, under "ep_psum", every other
rank's) writes zeros into one spare row that is never read. So the
result does not depend on the order of the writes, and a graph replays
it bit for bit. The three expert products are batched matrix products
over all of a rank's experts' C rows, empty or not, as the reference's
einsums are: a decode step reads every expert's weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.spmd import collectives

_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}

# a diagnostic hook: when set, each call hands it, on every rank, the
# (n, k) expert ids and keep mask of the n rows that rank routed, their
# indices among the call's rows in (B, S) order ((n,) int64), the call's
# row count B S and the rows' (n, E) fp32 router probabilities; eager
# runs only (its reader goes to the host; ``models.moe_replay``)
route_tap = None


def capacity(cfg: ModelConfig, T: int) -> int:
    """Rows per expert for a call routing T tokens."""
    mo = cfg.moe
    return max(8, int(math.ceil(T * mo.experts_per_token / mo.num_experts
                                * mo.capacity_factor)))


def block_mode(cfg: ModelConfig, S: int, tp: int, f2d: bool = False) -> str:
    """The reference's mode for a call of sequence length S on a "model"
    axis of tp ranks (``f2d``: grok-1's serving layout, always "tp")."""
    E = cfg.moe.num_experts
    ep = (not f2d) and E >= tp and E % max(tp, 1) == 0
    if not ep or tp == 1:
        return "tp"
    return "ep_a2a" if S % tp == 0 else "ep_psum"


def expert_cut(cfg: ModelConfig, tp: int, f2d: bool = False) -> str:
    """How a rank's shard of the expert leaves is cut for the modes its
    calls run: "experts" ("ep_*": E / tp experts, whole d_ff), "ff" (a
    slice of the d_ff, over "model", or over both axes with ``f2d``)."""
    return "ff" if block_mode(cfg, tp, tp, f2d) == "tp" else "experts"


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


def _dispatch(x, eidx, pos, sel, n: int, C: int):
    """The (n, C, d) dispatch of x's rows (T, d): assignment (t, j) with
    ``sel`` to row ``pos`` of expert ``eidx`` (0 <= eidx < n), the others
    (zero rows) to a spare row past the n C that is never read."""
    T, k = eidx.shape
    d = x.shape[-1]
    dest = torch.where(sel, eidx * C + pos, n * C).reshape(-1)
    xk = x[:, None, :].expand(T, k, d).reshape(T * k, d)
    contrib = torch.where(sel.reshape(-1, 1), xk, 0)
    disp = x.new_zeros((n * C + 1, d)).index_copy_(0, dest, contrib)
    return disp[:n * C].view(n, C, d)


def _combine(comb, eidx, pos, sel, w, out_dtype):
    """Each token's weighted sum of its selected assignments' rows of
    ``comb`` (n, C, d): exact products, fp32 sums, in ``out_dtype``."""
    n, C, d = comb.shape
    T, k = eidx.shape
    at = eidx.clamp(0, n - 1) * C + pos.clamp(max=C - 1)
    got = comb.reshape(n * C, d)[at.reshape(-1)].view(T, k, d)
    wk = torch.where(sel, w, 0.0).to(comb.dtype)
    return (got.float() * wk.float()[..., None]).sum(dim=1).to(out_dtype)


def _act(cfg: ModelConfig):
    return _ACT["gelu" if cfg.mlp_activation == "gelu_mlp"
                else cfg.mlp_activation]


def _weights(params, x_dtype, cut: str, index: int, n: int,
             cfg: ModelConfig):
    """(w_gate, w_in, w_out) in x's dtype: this rank's ``index``-th of
    ``n`` shards along ``cut`` ("experts" or "ff"), taken from whole
    leaves or, where the leaves hold it already, as they are."""
    E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    wg, wi, wo = params["w_gate"], params["w_in"], params["w_out"]
    held = (wg.shape[0], wg.shape[-1])
    if n > 1 and held == (E, f):
        if cut == "experts":
            m = E // n
            wg, wi, wo = (t.narrow(0, index * m, m) for t in (wg, wi, wo))
        else:
            m = f // n
            wg, wi = (t.narrow(2, index * m, m) for t in (wg, wi))
            wo = wo.narrow(1, index * m, m)
    elif held != ((E // n, f) if cut == "experts" else (E, f // n)):
        raise ValueError(
            f"expert leaves {tuple(wg.shape)} are neither whole (E {E}, "
            f"d_ff {f}) nor the {cut} shard of {n} that the block's mode "
            "reads")
    return tuple(t.to(x_dtype) for t in (wg, wi, wo))


def _routed(x, params, cfg: ModelConfig, C: int):
    """(w, idx, probs, pos, keep) of x's rows (T, d) at capacity C."""
    mo = cfg.moe
    w, idx, probs = _route(x, params["router"].to(x.dtype),
                           mo.experts_per_token)
    pos = _positions_in_expert(idx, mo.num_experts)
    return w, idx, probs, pos, pos < C


def moe_local(x, params, cfg: ModelConfig, with_aux: bool = False):
    """The block on T flat tokens, every expert local. x (T, d) -> y (T,
    d) in x's dtype, and with ``with_aux`` the load-balance loss (fp32
    scalar) beside it."""
    E = cfg.moe.num_experts
    C = capacity(cfg, x.shape[0])
    w, idx, probs, pos, keep = _routed(x, params, cfg, C)
    if route_tap is not None:
        route_tap(idx, keep, torch.arange(x.shape[0], device=x.device),
                  x.shape[0], probs)
    disp = _dispatch(x, idx, pos, keep, E, C)
    comb = _expert_ffn(disp, *_weights(params, x.dtype, "ff", 0, 1, cfg),
                       _act(cfg))
    y = _combine(comb, idx, pos, keep, w, x.dtype)
    return (y, _aux_loss(probs, idx, E)) if with_aux else y


def _mesh_local(x, params, cfg: ModelConfig, mode: str, sm, f2d: bool,
                row0: int = 0, n_rows: int = 0):
    """One rank's part of the block on its rows x (B, S, d) of the
    serving mesh ``sm`` (rows ``row0`` on of the call's ``n_rows``): (y
    (B, S, d), aux of its routing)."""
    mo = cfg.moe
    E = mo.num_experts
    B, S, d = x.shape
    grp = sm.model
    act = _act(cfg)
    if mode == "ep_a2a":
        tp, r = grp.size, grp.rank
        S_l = S // tp
        xs = x[:, r * S_l:(r + 1) * S_l].reshape(B * S_l, d)
        C = capacity(cfg, B * S_l)
        w, idx, probs, pos, keep = _routed(xs, params, cfg, C)
        if route_tap is not None:
            rows = torch.arange(row0, row0 + B * S,
                                device=x.device).view(B, S)
            route_tap(idx, keep, rows[:, r * S_l:(r + 1) * S_l].flatten(),
                      n_rows, probs)
        E_l = E // tp
        disp = _dispatch(xs, idx, pos, keep, E, C)
        rcv = grp.all_to_all(disp.view(tp, E_l, C, d))
        rows = rcv.transpose(0, 1).reshape(E_l, tp * C, d)
        out = _expert_ffn(rows, *_weights(params, x.dtype, "experts", r, tp,
                                          cfg), act)
        back = out.view(E_l, tp, C, d).transpose(0, 1)
        comb = grp.all_to_all(back).reshape(E, C, d)
        y = _combine(comb, idx, pos, keep, w, x.dtype)
        return grp.gather(y.view(B, S_l, d), 1), _aux_loss(probs, idx, E)
    xt = x.reshape(B * S, d)
    C = capacity(cfg, B * S)
    w, idx, probs, pos, keep = _routed(xt, params, cfg, C)
    if route_tap is not None:
        route_tap(idx, keep, torch.arange(row0, row0 + B * S,
                                          device=x.device), n_rows, probs)
    if mode == "ep_psum":
        tp, r = grp.size, grp.rank
        E_l = E // tp
        lidx = idx - r * E_l
        local = (lidx >= 0) & (lidx < E_l) & keep
        disp = _dispatch(xt, lidx.clamp(0, E_l - 1), pos, local, E_l, C)
        comb = _expert_ffn(disp, *_weights(params, x.dtype, "experts", r,
                                           tp, cfg), act)
        # the rank's share of each token in fp32, summed over the group and
        # rounded once
        y = _combine(comb, lidx, pos, local, w, torch.float32)
        y = grp.all_reduce(y, dtype=x.dtype)
    else:
        fg = sm.both if f2d else grp
        disp = _dispatch(xt, idx, pos, keep, E, C)
        comb = _expert_ffn(disp, *_weights(params, x.dtype, "ff", fg.rank,
                                           fg.size, cfg), act)
        comb = fg.all_reduce(comb)
        y = _combine(comb, idx, pos, keep, w, x.dtype)
    return y.view(B, S, d), _aux_loss(probs, idx, E)


def moe_block(params, x, cfg: ModelConfig, with_aux: bool = False):
    """x (B, S, d) -> y (B, S, d): the JAX package's ``moe_block`` on the
    current serving mesh (module docstring; one device without one; its
    ``f2d`` the reference's ctx "moe_f2d"); with ``with_aux``, (y, aux)
    as there."""
    B, S, d = x.shape
    sm = collectives.serving()
    if sm is None or (sm.both.size == 1):
        out = moe_local(x.reshape(B * S, d), params, cfg, with_aux)
        if with_aux:
            return out[0].reshape(B, S, d), out[1]
        return out.reshape(B, S, d)
    f2d = sm.f2d
    mode = block_mode(cfg, S, sm.model.size, f2d)
    sm.moe_modes["f2d" if f2d else mode] += 1
    dp = sm.data
    split = (not f2d) and dp.size > 1 and B % dp.size == 0
    b0 = dp.rank * (B // dp.size) if split else 0
    xb = x.narrow(0, b0, B // dp.size) if split else x
    y, aux = _mesh_local(xb, params, cfg, mode, sm, f2d, b0 * S, B * S)
    if split:
        y = dp.gather(y, 0)
    if not with_aux:
        return y
    if mode != "ep_psum" and not f2d and sm.model.size > 1:
        aux = sm.model.all_reduce(aux, mean=True)
    if split:
        aux = dp.all_reduce(aux, mean=True)
    return y, aux
