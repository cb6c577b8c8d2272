"""Model parameters: seeded initialisation and conversion from the JAX
package's parameter tree.

``init_model`` draws on the target device from a ``torch.Generator`` with
the JAX package's distributions (``repro.models.modules.dense_init`` and
the ``init_*`` functions): truncated normal on [-2, 2] scaled by
``1/sqrt(fan_in)``, ``wo`` by ``1/sqrt(H*hd)``, the embedding table by
0.02, norm scales at 1. The numbers differ from ``jax.random``'s; tests
that compare the two packages convert the JAX tree with
``params_from_jax`` instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _trunc_normal(shape, scale, gen, device):
    """scale * N(0, 1) truncated to [-2, 2], by inverse-CDF sampling (the
    method of ``jax.random.truncated_normal``). fp32."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.erfinv(lo + u * (hi - lo)) * math.sqrt(2.0)
    return x.clamp_(-2.0, 2.0).mul_(scale)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters for a dense decoder, drawn on ``device`` in fp32
    and stored in ``cfg.dtype``."""
    dt = _DTYPES[cfg.dtype]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    V = cfg.padded_vocab_size

    def dense(shape, scale=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return _trunc_normal(shape, scale, gen, device).to(dt)

    def norm():
        return {"scale": torch.ones(d, dtype=dt, device=device)}

    embed = {"table": dense((V, d), scale=0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = dense((V, d))
    if cfg.mlp_activation == "gelu_mlp":
        def mlp():
            return {"w_in": dense((d, f)), "w_out": dense((f, d))}
    else:
        def mlp():
            return {"w_gate": dense((d, f)), "w_in": dense((d, f)),
                    "w_out": dense((f, d))}
    layers = [{"norm": norm(),
               "attn": {"wq": dense((d, H, hd)), "wk": dense((d, K, hd)),
                        "wv": dense((d, K, hd)),
                        "wo": dense((H, hd, d), 1.0 / math.sqrt(H * hd))},
               "norm2": norm(),
               "mlp": mlp()} for _ in range(cfg.num_layers)]
    return {"embed": embed, "layers": layers, "final_norm": norm()}


def _to_torch(a, device):
    a = np.array(a)                         # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """Convert the JAX package's parameter tree (numpy arrays, as from
    ``repro.models.api.init_model`` cast to bf16) into the port's layout:
    the stacked ``blocks/sub0`` leaves are split per layer; einsum layouts
    are kept as they are. Dense single-kind decoders only."""
    if set(tree["blocks"]) != {"sub0"}:
        raise NotImplementedError(
            f"blocks {sorted(tree['blocks'])}: only single-kind dense stacks "
            "are ported (ROADMAP.md queue 1 item 3)")

    def conv(t, layer=None):
        if isinstance(t, dict):
            return {k: conv(v, layer) for k, v in t.items()}
        return _to_torch(t if layer is None else np.asarray(t)[layer], device)

    stack = tree["blocks"]["sub0"]
    return {"embed": conv(tree["embed"]),
            "layers": [conv(stack, i) for i in range(cfg.num_layers)],
            "final_norm": conv(tree["final_norm"])}


def params_to(params, device):
    """A copy of ``params`` on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)
