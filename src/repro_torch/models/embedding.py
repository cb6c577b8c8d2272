"""Token embedding, logits and the training losses (port of
``repro.models.embedding``). Single device: the JAX package's vocab-sharded
Part/Gather/Stitch collapses to one clamped gather, its vocab-parallel
logits to one fp32 product, and the losses' pmax/psum/pmean stitches to
their one-shard values."""

from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import softcap

NEG = -1.0e30


def head_table(params, cfg: ModelConfig):
    return params["table"] if cfg.tie_embeddings else params["head"]


def embed(table, tokens, cfg: ModelConfig):
    """tokens: (B, S) int -> (B, S, d) in the activation dtype, times
    sqrt(d) with ``cfg.embedding_scale``. As in the JAX package, ids are
    clamped into [0, V_pad) for the gather and rows of out-of-range ids
    come out zero."""
    V = table.shape[0]
    ids = tokens.clamp(0, V - 1).to(torch.int32)
    ok = (tokens >= 0) & (tokens < V)
    out = torch.where(ok[..., None], ops.embedding_gather(table, ids), 0)
    out = out.to(torch.bfloat16 if cfg.dtype == "bfloat16"
                 else torch.float32)
    if cfg.embedding_scale:
        # sqrt(d) rounded to the activation dtype before the multiply, as
        # the JAX package's jnp.asarray(sqrt(d), out.dtype): gemma2's
        # sqrt(4608) = 67.88 is 68.0 in bf16
        out = out * torch.tensor(math.sqrt(cfg.d_model),
                                 dtype=out.dtype).item()
    return out


def decode_logits(x, table, cfg: ModelConfig):
    """x: (B, 1, d) -> (B, V_pad) fp32 logits, vocab-padding columns set to
    NEG. A true fp32 product: pass an fp32 ``table`` to skip the per-call
    cast (the serving runner keeps one fp32 copy of the head)."""
    logits = x[:, 0].float() @ table.float().T
    logits = softcap(logits, cfg.final_logit_softcap)
    col_ok = torch.arange(table.shape[0], device=x.device) < cfg.vocab_size
    return torch.where(col_ok[None, :], logits, NEG)


def decode_logits_argmax(x, table, cfg: ModelConfig):
    """Greedy next token. x: (B, 1, d) -> (B,) int32."""
    return decode_logits(x, table, cfg).argmax(dim=-1).to(torch.int32)


def lm_loss(x, table, labels, cfg: ModelConfig, chunk: int = 4096):
    """Mean token cross-entropy (port of ``lm_loss`` with ``_xent_local``).
    x: (B, S, d); labels: (B, S). Tokens are taken ``chunk`` at a time (all
    at once when the count is not a multiple), so the live logits are one
    (chunk, V_pad) fp32 block. Vocab-padding columns are masked to NEG;
    the row max is detached (the LSE is exact for any shift).

    The logits are an fp32 product of fp32 casts of x and the table (in
    the activations' dtype first, as the JAX package casts it). The JAX
    package multiplies the bf16 operands with fp32 accumulation
    (``preferred_element_type``); the bf16 products are exact in fp32, so
    the fp32 product is the same sum, where a bf16 ``matmul`` would round
    every logit to bf16. On the card this needs TF32 off for fp32
    products (the PyTorch default)."""
    B, S, d = x.shape
    T = B * S
    V = table.shape[0]
    ck = chunk if T % chunk == 0 else T
    xt = x.reshape(T, d)
    lab = labels.reshape(T).long()
    t32 = table.to(x.dtype).float()
    col_ok = torch.arange(V, device=x.device) < cfg.vocab_size
    ok = (lab >= 0) & (lab < V)
    rows = []
    for lo in range(0, T, ck):
        logits = xt[lo:lo + ck].float() @ t32.T
        logits = softcap(logits, cfg.final_logit_softcap)
        logits = torch.where(col_ok[None, :], logits, NEG)
        mx = logits.amax(dim=-1).detach()
        lb = lab[lo:lo + ck]
        tl = torch.gather(logits, 1, lb.clamp(0, V - 1)[:, None])[:, 0]
        tl = torch.where(ok[lo:lo + ck], tl, 0.0)
        se = torch.exp(logits - mx[:, None]).sum(dim=-1)
        rows.append(torch.log(se) + mx - tl)
    return torch.cat(rows).mean()


def sampled_softmax_loss(x, table, labels, sampled_ids, cfg: ModelConfig):
    """Paper §4.2/§6.4: softmax over {true class} and n sampled classes
    (port of the model's ``sampled_softmax_loss``, plain tensor code as in
    the JAX package; ``kernels.ops.sampled_softmax_loss`` is the
    forward-only kernel). x: (B, S, d); labels: (B, S); sampled_ids: (n,).
    Rows of out-of-range ids are zero, as after the JAX package's
    Part/Gather/Stitch."""
    B, S, d = x.shape
    T = B * S
    V = table.shape[0]
    cap = cfg.final_logit_softcap
    xt = x.reshape(T, d).float()
    lab = labels.reshape(T).long()
    sids = sampled_ids.long()
    t32 = table.float()

    def rows(ids):
        ok = (ids >= 0) & (ids < V)
        return torch.where(ok[:, None], t32[ids.clamp(0, V - 1)], 0.0)

    lt = softcap(torch.sum(xt * rows(lab), dim=-1), cap)
    ls = softcap(xt @ rows(sids).T, cap)
    ls = torch.where(sids[None, :] == lab[:, None], NEG, ls)
    mx = torch.maximum(lt, ls.amax(dim=-1))
    lse = mx + torch.log(torch.exp(lt - mx)
                         + torch.exp(ls - mx[:, None]).sum(dim=-1))
    return (lse - lt).mean()
