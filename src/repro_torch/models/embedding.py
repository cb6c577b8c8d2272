"""Token embedding, logits and the training losses (port of
``repro.models.embedding``).

In training under a sharding "model" group (``spmd.collectives.
tp_group``) whose vocab shard the table holds (V_pad / tp rows, rank r
the rows from r * V_pad / tp), ``embed`` and ``lm_loss`` are the JAX
package's vocab-parallel forms: Part/Gather/Stitch (the local rows
through the gather kernel, out-of-shard ids zeroed, the sum over
"model"), and the chunked cross-entropy partials (max, sum-exp, true
logit) stitched by a detached max and two sums over "model". The mean
over "data" is the train step's (``spmd.steps``: each data rank's loss
is the mean of its rows; the step averages the gradients and the loss
over "data", the gradient of the JAX package's ``pmean``). With the
whole table the Part/Gather/Stitch collapses to one clamped gather, the
logits to one fp32 product, and the stitches to their one-shard values.

Serving reads the same shards where the engine shards its weights
(``shard_params=True``; ``shard_group`` then finds the serving mesh's
"model" group): ``embed`` is the same vocab-parallel lookup, bit for bit
the whole table's (one nonzero term a row), and ``decode_logits``
multiplies the rank's V_pad / tp head rows and gathers the fp32 logits
exactly into whole V_pad rows, which is what sampling reads."""

from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import softcap
from repro_torch.spmd import collectives

NEG = -1.0e30


def head_table(params, cfg: ModelConfig):
    return params["table"] if cfg.tie_embeddings else params["head"]


def vocab_shard(table, cfg: ModelConfig):
    """(model group, first row's vocab id) of a rank's vocab shard of the
    table, or (None, 0) for a whole table."""
    grp = collectives.shard_group(table.shape[0], cfg.padded_vocab_size,
                                  "a table's vocab rows")
    return (None, 0) if grp is None else (grp, grp.rank * table.shape[0])


def embed(table, tokens, cfg: ModelConfig):
    """tokens: (B, S) int -> (B, S, d) in the activation dtype, times
    sqrt(d) with ``cfg.embedding_scale``. As in the JAX package, ids are
    clamped into [0, V_pad) for the gather (a vocab shard's into its own
    rows) and rows of out-of-range ids come out zero; a shard's rows are
    summed over "model" (one nonzero term each)."""
    V = table.shape[0]
    grp, off = vocab_shard(table, cfg)
    loc = tokens - off if off else tokens
    ids = loc.clamp(0, V - 1).to(torch.int32)
    ok = (loc >= 0) & (loc < V)
    out = torch.where(ok[..., None], ops.embedding_gather(table, ids), 0)
    out = collectives.reduce_from(out, grp)
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
    cast (the serving runner keeps one fp32 copy of the head). A vocab
    shard's logits are gathered over its group into whole rows."""
    grp, off = vocab_shard(table, cfg)
    logits = x[:, 0].float() @ table.float().T
    logits = softcap(logits, cfg.final_logit_softcap)
    col_ok = torch.arange(off, off + table.shape[0],
                          device=x.device) < cfg.vocab_size
    logits = torch.where(col_ok[None, :], logits, NEG)
    return logits if grp is None else grp.gather(logits, -1)


def decode_logits_argmax(x, table, cfg: ModelConfig):
    """Greedy next token. x: (B, 1, d) -> (B,) int32."""
    return decode_logits(x, table, cfg).argmax(dim=-1).to(torch.int32)


def lm_loss(x, table, labels, cfg: ModelConfig, chunk: int = 4096):
    """Mean token cross-entropy (port of ``lm_loss`` with ``_xent_local``).
    x: (B, S, d); labels: (B, S). Tokens are taken ``chunk`` at a time (all
    at once when the count is not a multiple), so the live logits are one
    (chunk, V_pad) fp32 block (V_pad / tp for a vocab shard). Vocab-padding
    columns are masked to NEG; the row max is detached (the LSE is exact
    for any shift). A shard's (max, sum-exp, true logit) partials are
    stitched over "model": the detached max of the maxima, the rescaled
    sums and the true logits summed (x enters through ``copy_to``, so its
    gradient sums every shard's part).

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
    grp, off = vocab_shard(table, cfg)
    ck = chunk if T % chunk == 0 else T
    xt = collectives.copy_to(x, grp).reshape(T, d)
    lab = labels.reshape(T).long() - off
    t32 = table.to(x.dtype).float()
    col_ok = torch.arange(off, off + V, device=x.device) < cfg.vocab_size
    ok = (lab >= 0) & (lab < V)
    mxs, ses, tls = [], [], []
    for lo in range(0, T, ck):
        logits = xt[lo:lo + ck].float() @ t32.T
        logits = softcap(logits, cfg.final_logit_softcap)
        logits = torch.where(col_ok[None, :], logits, NEG)
        mx = logits.amax(dim=-1).detach()
        lb = lab[lo:lo + ck]
        tl = torch.gather(logits, 1, lb.clamp(0, V - 1)[:, None])[:, 0]
        tls.append(torch.where(ok[lo:lo + ck], tl, 0.0))
        ses.append(torch.exp(logits - mx[:, None]).sum(dim=-1))
        mxs.append(mx)
    mx, se, tl = torch.cat(mxs), torch.cat(ses), torch.cat(tls)
    if grp is not None:
        gmx = grp.gather(mx[None], 0).amax(dim=0)
        se = collectives.reduce_from(se * torch.exp(mx - gmx), grp)
        tl = collectives.reduce_from(tl, grp)
        mx = gmx
    return (torch.log(se) + mx - tl).mean()


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
    grp, off = vocab_shard(table, cfg)
    cap = cfg.final_logit_softcap
    xt = x.reshape(T, d).float()
    lab = labels.reshape(T).long()
    sids = sampled_ids.long()
    t32 = table.float()

    def rows(ids):
        loc = ids - off
        ok = (loc >= 0) & (loc < V)
        return collectives.reduce_from(
            torch.where(ok[:, None], t32[loc.clamp(0, V - 1)], 0.0), grp)

    lt = softcap(torch.sum(xt * rows(lab), dim=-1), cap)
    ls = softcap(xt @ rows(sids).T, cap)
    ls = torch.where(sids[None, :] == lab[:, None], NEG, ls)
    mx = torch.maximum(lt, ls.amax(dim=-1))
    lse = mx + torch.log(torch.exp(lt - mx)
                         + torch.exp(ls - mx[:, None]).sum(dim=-1))
    return (lse - lt).mean()
