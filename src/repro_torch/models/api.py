"""Model parameters: seeded initialisation and conversion from the JAX
package's parameter tree.

``init_model`` draws on the target device from a ``torch.Generator`` with
the JAX package's distributions (``repro.models.modules.dense_init`` and
the ``init_*`` functions): truncated normal on [-2, 2] scaled by
``1/sqrt(fan_in)``, ``wo`` by ``1/sqrt(H*hd)``, the embedding table by
0.02, the mamba conv weights by 0.5, norm and qk-norm scales and ``D``
at 1, LayerNorm biases and ``dt_bias`` at 0, ``A_log = log(linspace(1,
16, nh))``. The numbers differ from ``jax.random``'s; tests that compare
the two packages convert the JAX tree with ``params_from_jax`` instead.
Each leaf is drawn in fp32 and stored in its dtype at once, an expert
leaf ``(E, d, f)`` one expert at a time (its fan-in is E, the JAX
package's ``shape[0]`` rule), so a model's fp32 draw never exists whole.

The static path's entry points (``prefill_fn``, ``decode_fn``,
``init_cache``) and ``generate_static``, the static server's greedy loop
over them, and the training loss ``loss_fn`` serve every decoder (dense,
MoE, M-RoPE, Mamba2 and the hybrid: ``models.transformer``) and the
encoder-decoder (``models.encdec``), dispatched on the config.
``batch_shapes`` and ``make_batch`` give the synthetic batches of the
JAX package's smoke tests.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config import MAMBA, ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _trunc_normal(shape, scale, gen, device):
    """scale * N(0, 1) truncated to [-2, 2], by inverse-CDF sampling (the
    method of ``jax.random.truncated_normal``). fp32."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.erfinv(lo + u * (hi - lo)) * math.sqrt(2.0)
    return x.clamp_(-2.0, 2.0).mul_(scale)


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=None,
               place=None):
    """Random parameters for a dense, MoE, M-RoPE, SSM or hybrid decoder
    or an encoder-decoder, drawn on ``device`` in fp32 and stored in
    ``dtype``: ``cfg.dtype`` by default (every leaf, as the serving
    engines cast the whole tree), or ``torch.float32`` for the training
    masters (the draw itself). ``place(subtree, path)``, where given, is
    applied to each top-level part as soon as it is drawn (the embedding,
    each layer, each final norm, the shared block; path ("embed",),
    ("layers", i), ...) and its result kept instead: a sharded engine
    cuts each part to its rank's shard there, so the whole model never
    exists at once. The draws, and so the numbers, are the same."""
    dt = _DTYPES[cfg.dtype] if dtype is None else dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    V = cfg.padded_vocab_size

    def dense(shape, scale=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return _trunc_normal(shape, scale, gen, device).to(dt)

    def experts(shape):
        """An (E, ...) expert leaf, fan-in E, one expert's fp32 draw at a
        time."""
        out = torch.empty(shape, dtype=dt, device=device)
        for e in range(shape[0]):
            out[e] = _trunc_normal(shape[1:], 1.0 / math.sqrt(shape[0]), gen,
                                   device)
        return out

    def norm():
        p = {"scale": torch.ones(d, dtype=dt, device=device)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(d, dtype=dt, device=device)
        return p

    def put(tree, *path):
        return tree if place is None else place(tree, path)

    embed = {"table": dense((V, d), scale=0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = dense((V, d))
    embed = put(embed, "embed")
    if cfg.mlp_activation == "gelu_mlp":
        def mlp():
            return {"w_in": dense((d, f)), "w_out": dense((f, d))}
    else:
        def mlp():
            return {"w_gate": dense((d, f)), "w_in": dense((d, f)),
                    "w_out": dense((f, d))}
    def attention():
        p = {"wq": dense((d, H, hd)), "wk": dense((d, K, hd)),
             "wv": dense((d, K, hd)),
             "wo": dense((H, hd, d), 1.0 / math.sqrt(H * hd))}
        if cfg.qk_norm:
            p["q_norm"] = torch.ones(hd, dtype=dt, device=device)
            p["k_norm"] = torch.ones(hd, dtype=dt, device=device)
        return p

    def moe():
        E, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        return {"router": dense((d, E)), "w_gate": experts((E, d, fe)),
                "w_in": experts((E, d, fe)), "w_out": experts((E, fe, d))}

    def attn_block(shared=False):
        p = {"norm": norm(), "attn": attention(), "norm2": norm()}
        if cfg.moe is not None and not shared:
            p["moe"] = moe()
        else:
            p["mlp"] = mlp()
        if cfg.post_block_norm and not shared:
            p["post_norm"], p["post_norm2"] = norm(), norm()
        return p

    if is_encdec(cfg):
        def dec_block():
            return {"norm": norm(), "attn": attention(), "xnorm": norm(),
                    "xattn": attention(), "norm2": norm(), "mlp": mlp()}
        return {"embed": embed,
                "encoder": [put(attn_block(), "encoder", i)
                            for i in range(cfg.encoder_layers)],
                "decoder": [put(dec_block(), "decoder", i)
                            for i in range(cfg.num_layers)],
                "enc_final_norm": put(norm(), "enc_final_norm"),
                "final_norm": put(norm(), "final_norm")}

    def mamba_block():
        s = cfg.ssm
        di, nh = s.d_inner(d), s.n_heads(d)
        gn = s.n_groups * s.state_dim

        def const(x):
            return x.to(dtype=dt, device=device)

        a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))
        return {"norm": norm(), "mamba": {
            "wz": dense((d, di)), "wx": dense((d, di)),
            "wbc": dense((d, 2 * gn)), "wdt": dense((d, nh)),
            "conv_x": dense((s.conv_kernel, di), 0.5),
            "conv_bc": dense((s.conv_kernel, 2 * gn), 0.5),
            "dt_bias": const(torch.zeros(nh)), "A_log": const(a_log),
            "D": const(torch.ones(nh)), "norm_scale": const(torch.ones(di)),
            "w_out": dense((di, d))}}

    layers = [put(mamba_block() if kind == MAMBA else attn_block(),
                  "layers", i) for i, kind in enumerate(cfg.layer_kinds())]
    params = {"embed": embed, "layers": layers,
              "final_norm": put(norm(), "final_norm")}
    if cfg.shared_attn_period:
        params["shared"] = put(attn_block(shared=True), "shared")
    return params


def _layout_tree(cfg: ModelConfig, leaf):
    """``init_model``'s tree with ``leaf(shape, logical axes)`` at every
    leaf: the logical axes of the JAX package's ``init_*`` functions
    (``repro.models.modules`` conventions), without the "layers" axis its
    stacks add (the port's layers are a list)."""
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    V = cfg.padded_vocab_size

    def norm():
        p = {"scale": leaf((d,), ("embed",))}
        if cfg.norm == "layernorm":
            p["bias"] = leaf((d,), ("embed",))
        return p

    embed = {"table": leaf((V, d), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        embed["head"] = leaf((V, d), ("vocab", "embed"))

    def mlp():
        p = {"w_in": leaf((d, f), ("embed", "ff")),
             "w_out": leaf((f, d), ("ff", "embed"))}
        if cfg.mlp_activation != "gelu_mlp":
            p = {"w_gate": leaf((d, f), ("embed", "ff")), **p}
        return p

    def attention():
        p = {"wq": leaf((d, H, hd), ("embed", "heads", "head_dim")),
             "wk": leaf((d, K, hd), ("embed", "kv_heads", "head_dim")),
             "wv": leaf((d, K, hd), ("embed", "kv_heads", "head_dim")),
             "wo": leaf((H, hd, d), ("heads", "head_dim", "embed"))}
        if cfg.qk_norm:
            p["q_norm"] = leaf((hd,), ("head_dim",))
            p["k_norm"] = leaf((hd,), ("head_dim",))
        return p

    def moe():
        E, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        ex = ("experts", "expert_embed", "expert_ff")
        return {"router": leaf((d, E), ("embed", None)),
                "w_gate": leaf((E, d, fe), ex), "w_in": leaf((E, d, fe), ex),
                "w_out": leaf((E, fe, d),
                              ("experts", "expert_ff", "expert_embed"))}

    def attn_block(shared=False):
        p = {"norm": norm(), "attn": attention(), "norm2": norm()}
        if cfg.moe is not None and not shared:
            p["moe"] = moe()
        else:
            p["mlp"] = mlp()
        if cfg.post_block_norm and not shared:
            p["post_norm"], p["post_norm2"] = norm(), norm()
        return p

    if is_encdec(cfg):
        def dec_block():
            return {"norm": norm(), "attn": attention(), "xnorm": norm(),
                    "xattn": attention(), "norm2": norm(), "mlp": mlp()}
        return {"embed": embed,
                "encoder": [attn_block() for _ in range(cfg.encoder_layers)],
                "decoder": [dec_block() for _ in range(cfg.num_layers)],
                "enc_final_norm": norm(), "final_norm": norm()}

    def mamba_block():
        s = cfg.ssm
        di, nh = s.d_inner(d), s.n_heads(d)
        gn = s.n_groups * s.state_dim
        return {"norm": norm(), "mamba": {
            "wz": leaf((d, di), ("embed", "ssm_inner")),
            "wx": leaf((d, di), ("embed", "ssm_inner")),
            "wbc": leaf((d, 2 * gn), ("embed", None)),
            "wdt": leaf((d, nh), ("embed", "ssm_heads")),
            "conv_x": leaf((s.conv_kernel, di), (None, "ssm_inner")),
            "conv_bc": leaf((s.conv_kernel, 2 * gn), (None, None)),
            "dt_bias": leaf((nh,), ("ssm_heads",)),
            "A_log": leaf((nh,), ("ssm_heads",)),
            "D": leaf((nh,), ("ssm_heads",)),
            "norm_scale": leaf((di,), ("ssm_inner",)),
            "w_out": leaf((di, d), ("ssm_inner", "embed"))}}

    layers = [mamba_block() if kind == MAMBA else attn_block()
              for kind in cfg.layer_kinds()]
    params = {"embed": embed, "layers": layers, "final_norm": norm()}
    if cfg.shared_attn_period:
        params["shared"] = attn_block(shared=True)
    return params


def param_specs(cfg: ModelConfig):
    """The logical axes of every leaf of ``init_model``'s tree (the
    counterpart of the specs that the JAX package's ``init_model``
    returns beside its params; per layer, without the leading "layers"
    axis)."""
    return _layout_tree(cfg, lambda shape, axes: tuple(axes))


def param_shapes(cfg: ModelConfig):
    """The shape of every leaf of ``init_model``'s tree, nothing
    allocated."""
    return _layout_tree(cfg, lambda shape, axes: tuple(shape))


def loss_fn(params, batch, cfg: ModelConfig, pcfg, sampled_ids=None):
    """Training loss and metrics {"ce", "aux"}: ``encdec.forward_loss``
    for the encoder-decoder (its batch carries ``frames``; no sampled
    softmax there, as in the JAX package), ``transformer.forward_loss``
    for every decoder."""
    if is_encdec(cfg):
        return encdec.forward_loss(params, batch, cfg, pcfg)
    return transformer.forward_loss(params, batch, cfg, pcfg, sampled_ids)


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """name -> (shape, dtype) of every model input but the cache: tokens
    [and labels] for "train" and "prefill" shapes, with frames (B, T_enc,
    d) bf16 for the audio frontend and positions (3, B, S) for the vision
    frontend; token (B, 1) and pos (B,) for "decode"."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        d = {"tokens": ((B, S), i32)}
        if shape.kind == "train":
            d["labels"] = ((B, S), i32)
        if cfg.frontend == "audio":
            d["frames"] = ((B, cfg.encoder_seq_len, cfg.d_model),
                           torch.bfloat16)
        if cfg.frontend == "vision":
            d["positions"] = ((3, B, S), i32)
        return d
    return {"token": ((B, 1), i32), "pos": ((B,), i32)}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda") -> dict:
    """A synthetic batch of ``batch_shapes``, drawn on the host with the
    JAX package's numpy draws in its order (the same values, byte for
    byte), then placed on ``device``: token ids uniform in [0, vocab),
    frames N(0, 1) rounded to fp32 then bf16, positions 0 .. S-1 on all
    three planes, pos S - 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dt) in batch_shapes(cfg, shape).items():
        if name == "pos":
            t = torch.full(shp, shape.seq_len - 1, dtype=dt)
        elif name == "positions":
            t = torch.arange(shp[2], dtype=dt)[None, None].expand(shp)
        elif dt == torch.int32:
            t = torch.from_numpy(rng.integers(0, cfg.vocab_size, shp)
                                 .astype(np.int32))
        else:
            t = torch.from_numpy(rng.normal(0, 1, shp).astype(np.float32)
                                 ).to(dt)
        out[name] = t.to(device)
    return out


def _static(cfg: ModelConfig):
    return encdec if is_encdec(cfg) else transformer


def prefill_fn(params, batch, cfg: ModelConfig, head=None, max_len=None):
    """The static path's prefill (``transformer.prefill``, or
    ``encdec.prefill``, whose batch carries ``frames``): (cache of
    ``max_len`` self positions (default the prompts' S), greedy next token
    (B,))."""
    return _static(cfg).prefill(params, batch, cfg, head, max_len)


def decode_fn(params, cache, batch, cfg: ModelConfig, head=None):
    """The static path's decode step (``transformer.decode_step`` or
    ``encdec.decode_step``): (greedy next token (B,), cache)."""
    return _static(cfg).decode_step(params, cache, batch, cfg, head)


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda"):
    """Zero static cache for B sequences of S positions."""
    return _static(cfg).init_cache(cfg, B, S, device)


def generate_static(params, tokens, cfg: ModelConfig, max_new: int,
                    max_len: int | None = None, head=None, frames=None,
                    positions=None):
    """Greedy tokens of the static path, as the JAX package's static
    server makes them (``tests/helpers.StaticServerOracle``): one
    ``prefill_fn`` over equal-length prompts tokens (B, S) into caches of
    ``max_len`` positions (default S + max_new), then max_new - 1
    ``decode_fn`` steps. An encoder-decoder takes ``frames`` (B, T_enc,
    d_model) (zeros when None, as the oracle feeds them); an M-RoPE model
    may take ``positions`` (3, B, S), and its decode steps then continue
    at S on all three planes, as the oracle's do. Returns (B, max_new)
    int32."""
    B, S = tokens.shape
    max_len = S + max_new if max_len is None else max_len
    batch = {"tokens": tokens}
    if is_encdec(cfg):
        if frames is None:
            frames = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model),
                                 device=tokens.device)
        batch["frames"] = frames
    if positions is not None:
        batch["positions"] = positions
    cache, tok = prefill_fn(params, batch, cfg, head, max_len)
    outs = [tok]
    pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    for _ in range(max_new - 1):
        tok, cache = decode_fn(params, cache, {"token": tok[:, None],
                                               "pos": pos}, cfg, head)
        outs.append(tok)
        pos = pos + 1
    return torch.stack(outs, dim=1)


def _to_torch(a, device):
    a = np.array(a)                         # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """Convert the JAX package's parameter tree (numpy arrays, as from
    ``repro.models.api.init_model``: fp32 masters, or cast to bf16) into
    the port's layout, each leaf keeping its dtype. An optimizer slot tree
    mirrors the parameters and converts the same way.
    The JAX package stacks layers by period: ``blocks/sub{i}`` holds kind
    ``i`` of every period along a leading NP axis, so layer ``p * P + i``
    is ``sub{i}[p]`` (P kinds per period). The leaves are split per layer
    in that order (gemma2's ("local", "attn") period: even layers from
    ``sub0``, odd ones from ``sub1``); the hybrid's unstacked ``shared``
    block is carried as it is; einsum layouts are kept (a MoE layer's
    ``moe`` leaves too). An encoder-decoder's ``encoder`` and ``decoder``
    stacks split into per-layer lists."""

    def conv(t, index=None):
        if isinstance(t, dict):
            return {k: conv(v, index) for k, v in t.items()}
        return _to_torch(t if index is None else np.asarray(t)[index], device)

    if is_encdec(cfg):
        return {"embed": conv(tree["embed"]),
                "encoder": [conv(tree["encoder"], i)
                            for i in range(cfg.encoder_layers)],
                "decoder": [conv(tree["decoder"], i)
                            for i in range(cfg.num_layers)],
                "enc_final_norm": conv(tree["enc_final_norm"]),
                "final_norm": conv(tree["final_norm"])}
    P = len(tree["blocks"])

    params = {"embed": conv(tree["embed"]),
              "layers": [conv(tree["blocks"][f"sub{layer % P}"], layer // P)
                         for layer in range(cfg.num_layers)],
              "final_norm": conv(tree["final_norm"])}
    if "shared" in tree:
        params["shared"] = conv(tree["shared"])
    return params


def params_to(params, device):
    """A copy of ``params`` on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)
