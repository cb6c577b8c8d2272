"""The port's full sampling pipeline (penalties, top-p, min-p, logprobs,
stop sequences, min_new) on the CPU, held against the JAX package.

Ops, against ``repro.serving.sampling`` and the numpy oracle of
``tests/test_sampling.py`` (copied here): penalties exactly; the
truncation keep-mask over the reference's grid; every default a bitwise
identity (the full path draws the plain path's tokens); greedy rows
penalty-aware; logprobs of the penalized distribution; the draws token
for token on the reference's streams; chi-square and TV agreement of many
draws with the oracle distribution; the speculative verifiers preserving
the transformed target distribution, K = 0 being ``sample_tokens``; the
``SamplingBuffer``.

Engines at smoke size: the port's temperature, top-k and mixed
full-pipeline streams equal the JAX engine's token for token (glm4_9b,
mamba2_370m, zamba2_2p7b), except after a first difference at a near-tie
of the drawn scores; up to that difference, logprobs (the chosen token's
and the top list's, ids wherever values stand apart) within the logits'
bf16 tolerance scaled as the repetition penalty scales logits.
Inside the port: replay across preemption, greedy traffic never runs a
full step, plain rows of a full step keep their tokens, stop sequences
retire requests, min_new defers EOS and stop, and a vocabulary that is
not a multiple of 256 keeps its padding columns unseen."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import sampling as R
from repro.serving.scheduler import SamplingParams as JaxSamplingParams
from repro_torch.config import get_config
from repro_torch.models import transformer
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving import prng
from repro_torch.serving import sampling as P
from repro_torch.serving.runners import make_runner
import torch_cpu  # noqa: F401  (one torch thread)

BF16_TOL = 1e-2
RNG = np.random.default_rng(0)


# -- numpy oracle (tests/test_sampling.py's) ---------------------------------


def _softmax(x):
    x = np.asarray(x, np.float32)
    e = np.exp(x - x.max())
    return e / e.sum()


def ref_penalize(lg, pmask, ocounts, rep, pres, freq):
    lg = np.asarray(lg, np.float32).copy()
    seen = np.asarray(pmask, bool) | (np.asarray(ocounts) > 0)
    rep = np.float32(rep)
    lg[seen] = np.where(lg[seen] > 0, lg[seen] / rep, lg[seen] * rep)
    lg = lg - np.float32(freq) * np.asarray(ocounts, np.float32)
    lg = lg - np.float32(pres) * (np.asarray(ocounts) > 0).astype(np.float32)
    return lg


def ref_keep_mask(lg, k, top_p, min_p):
    lg = np.asarray(lg, np.float32)
    V = lg.shape[-1]
    srt = np.sort(lg)
    keep = np.ones(V, bool)
    if k > 0:
        keep &= ~(lg < srt[V - min(max(k, 1), V)])
    if top_p < 1.0:
        desc = srt[::-1]
        probs = _softmax(desc)
        before = np.cumsum(probs) - probs
        n_keep = max(int((before < np.float32(top_p)).sum()), 1)
        keep &= ~(lg < desc[n_keep - 1])
    if min_p > 0.0:
        keep &= ~(lg < srt[-1] + np.log(np.float32(min_p)))
    if not keep.any():
        keep = np.zeros(V, bool)
        keep[int(np.argmax(lg))] = True
    return keep


def ref_full_probs(lg, pmask, ocounts, t, k, top_p, min_p, rep, pres, freq):
    pen = ref_penalize(lg, pmask, ocounts, rep, pres, freq)
    scaled = pen / max(np.float32(t), np.float32(1e-6))
    keep = ref_keep_mask(scaled, k, top_p, min_p)
    probs = np.where(keep, _softmax(np.where(keep, scaled, P.NEG)), 0.0)
    return probs / probs.sum()


def make_sp(n, V, **over):
    """Default full-path inputs for n rows (numpy); override per test."""
    sp = {"temps": np.ones(n, np.float32), "top_ks": np.zeros(n, np.int32),
          "top_ps": np.ones(n, np.float32), "min_ps": np.zeros(n, np.float32),
          "rep_pens": np.ones(n, np.float32),
          "pres_pens": np.zeros(n, np.float32),
          "freq_pens": np.zeros(n, np.float32),
          "seeds": np.zeros(n, np.int32),
          "rids": np.arange(n, dtype=np.int32),
          "counters": np.zeros(n, np.int32),
          "pmask": np.zeros((n, V), bool),
          "ocounts": np.zeros((n, V), np.int32)}
    for k, v in over.items():
        sp[k] = np.broadcast_to(np.asarray(v, sp[k].dtype), sp[k].shape)
    assert set(sp) == set(P.SP_KEYS) == set(R.SP_KEYS)
    return sp


def _j(sp):
    return {k: jnp.asarray(v) for k, v in sp.items()}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- ops against the reference ----------------------------------------------

TRUNC_GRID = [(k, tp, mp)
              for k in (0, 1, 3, 32)
              for tp in (1.0, 0.75, 0.4)
              for mp in (0.0, 0.05, 0.3)]


@pytest.mark.parametrize("k,top_p,min_p", TRUNC_GRID)
def test_truncation_mask_matches_reference(k, top_p, min_p):
    V = 32
    lg = np.random.default_rng(k * 100 + int(top_p * 10) + int(min_p * 100)) \
        .normal(0, 2, (8, V)).astype(np.float32)
    out = P._truncate(_t(lg), torch.full((8,), k, dtype=torch.int32),
                      torch.full((8,), top_p), torch.full((8,), min_p))
    for row in range(8):
        ref = np.asarray(R._truncate(jnp.asarray(lg[row]), jnp.int32(k),
                                     jnp.float32(top_p), jnp.float32(min_p)))
        keep = ref_keep_mask(lg[row], k, top_p, min_p)
        np.testing.assert_array_equal(out[row].numpy() != P.NEG, ref != P.NEG)
        np.testing.assert_array_equal(out[row].numpy() != P.NEG, keep)
        np.testing.assert_array_equal(out[row].numpy()[keep], lg[row][keep])


def test_truncation_corners():
    """min_p above 1 masks everything: the fallback keeps the argmax; the
    tightest legal settings keep exactly the argmax."""
    lg = _t(RNG.normal(0, 2, (6, 24)).astype(np.float32))
    for k, tp, mp in ((0, 1.0, 2.0), (1, 1e-9, 1.0)):
        out = P._truncate(lg, torch.full((6,), k, dtype=torch.int32),
                          torch.full((6,), tp), torch.full((6,), mp))
        keep = out != P.NEG
        assert (keep.sum(-1) == 1).all()
        assert torch.equal(keep.int().argmax(-1), lg.argmax(-1))
        assert torch.equal(out[keep], lg[keep])


def test_penalties_match_reference_exactly():
    V = 32
    lg = RNG.normal(0, 2, V).astype(np.float32)
    pmask = RNG.random(V) < 0.3
    oc = RNG.integers(0, 4, V).astype(np.int32)
    for rep, pres, freq in [(1.0, 0.0, 0.0), (1.7, 0.0, 0.0),
                            (0.8, 0.5, 0.0), (1.3, 0.2, 0.4)]:
        got = P._penalize(_t(lg[None]), _t(pmask[None]), _t(oc[None]),
                          torch.tensor([rep]), torch.tensor([pres]),
                          torch.tensor([freq]))[0].numpy()
        want = np.asarray(R._penalize(
            jnp.asarray(lg), jnp.asarray(pmask), jnp.asarray(oc),
            jnp.float32(rep), jnp.float32(pres), jnp.float32(freq)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref_penalize(lg, pmask, oc, rep,
                                                        pres, freq))
        if (rep, pres, freq) == (1.0, 0.0, 0.0):
            np.testing.assert_array_equal(got, lg)


def test_full_prep_defaults_bitwise_plain():
    """At default penalties, top-p and min-p the full transform is the
    plain one bit for bit, with non-trivial count state; both equal the
    reference's."""
    V = 48
    lg = RNG.normal(0, 2, (3, V)).astype(np.float32)
    pmask = RNG.random((3, V)) < 0.3
    oc = RNG.integers(0, 3, (3, V)).astype(np.int32)
    t = torch.tensor([1.0, 0.7, 1.5])
    k = torch.tensor([0, 8, V], dtype=torch.int32)
    plain = P.prep_logits(_t(lg), t, k)
    full = P._prep_logits_full(_t(lg), _t(pmask), _t(oc), t, k,
                               torch.ones(3), torch.zeros(3), torch.ones(3),
                               torch.zeros(3), torch.zeros(3))
    assert torch.equal(plain, full)
    for i in range(3):
        want = R._prep_logits(jnp.asarray(lg[i]), jnp.float32(t[i]),
                              jnp.int32(k[i]))
        np.testing.assert_array_equal(plain[i].numpy(), np.asarray(want))


def _plain_rows(B, V):
    return dict(temps=RNG.choice([0.0, 0.7, 1.0, 1.4], B).astype(np.float32),
                top_ks=RNG.choice([0, 4, V], B).astype(np.int32),
                seeds=RNG.integers(-3, 5, B).astype(np.int32),
                rids=RNG.integers(0, 1000, B).astype(np.int32),
                counters=RNG.integers(0, 30, B).astype(np.int32))


def test_sample_tokens_full_defaults_match_plain_tokens():
    """Same streams, identity transform: the full path at default
    parameters draws the plain path's tokens, greedy rows included, and
    both draw the reference's."""
    B, V = 16, 64
    logits = RNG.normal(0, 2, (B, V)).astype(np.float32)
    pr = _plain_rows(B, V)
    order = ("temps", "top_ks", "seeds", "rids", "counters")
    plain = P.sample_tokens(_t(logits), *(pr[k] for k in order))
    full, lp = P.sample_tokens_full(_t(logits), make_sp(B, V, **pr))
    assert torch.equal(plain, full) and lp["top_lp"].shape == (B, 8)
    want = R.sample_tokens(jnp.asarray(logits),
                           *(jnp.asarray(pr[k]) for k in order))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))


def test_full_draws_match_reference():
    """Mixed parameters on the reference's streams: the tokens are the
    reference's, the logprobs within 1e-5."""
    B, V = 24, 96
    logits = RNG.normal(0, 2, (B, V)).astype(np.float32)
    sp = make_sp(B, V, **_plain_rows(B, V))
    sp.update(top_ps=RNG.choice([1.0, 0.8, 0.5], B).astype(np.float32),
              min_ps=RNG.choice([0.0, 0.05], B).astype(np.float32),
              rep_pens=RNG.choice([1.0, 1.3, 0.8], B).astype(np.float32),
              pres_pens=RNG.choice([0.0, 0.4], B).astype(np.float32),
              freq_pens=RNG.choice([0.0, 0.3], B).astype(np.float32),
              pmask=RNG.random((B, V)) < 0.1,
              ocounts=RNG.integers(0, 3, (B, V)).astype(np.int32))
    toks, lp = P.sample_tokens_full(_t(logits), sp, max_logprobs=5)
    jt, jlp = R.sample_tokens_full(jnp.asarray(logits), _j(sp),
                                   max_logprobs=5)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(lp["chosen"].numpy(), np.asarray(jlp["chosen"]),
                               atol=1e-5)
    np.testing.assert_allclose(lp["top_lp"].numpy(), np.asarray(jlp["top_lp"]),
                               atol=1e-5)
    # ids compared where the values differ (equal values may be ordered
    # otherwise by torch.topk and lax.top_k)
    distinct = np.diff(lp["top_lp"].numpy(), axis=-1) < -1e-6
    ids, jids = lp["top_ids"].numpy(), np.asarray(jlp["top_ids"])
    assert (ids[:, 0] == jids[:, 0]).all()
    assert (ids[:, 1:][distinct] == jids[:, 1:][distinct]).all()
    dft = P.propose_tokens_full(_t(logits), sp)
    np.testing.assert_array_equal(
        dft.numpy(), np.asarray(R.propose_tokens_full(jnp.asarray(logits),
                                                      _j(sp))))


def test_greedy_is_penalty_aware():
    V = 16
    lg = np.zeros(V, np.float32)
    lg[3], lg[7] = 4.0, 3.0
    oc = np.zeros((1, V), np.int32)
    oc[0, 3] = 1
    sp = make_sp(1, V, temps=0.0, rep_pens=10.0, ocounts=oc)
    tok, _ = P.sample_tokens_full(_t(lg[None]), sp)
    assert int(tok[0]) == 7


def test_logprobs_match_penalized_distribution():
    """Logprobs are the log-softmax of the penalized, pre-truncation
    logits: sampled rows at their temperature, greedy rows unscaled;
    top-L sorted descending, the true top-L."""
    V = 20
    lg = RNG.normal(0, 2, V).astype(np.float32)
    oc = np.zeros((1, V), np.int32)
    oc[0, 2] = 3
    for t in (0.0, 0.8):
        sp = make_sp(1, V, temps=t, rep_pens=1.5, freq_pens=0.2,
                     ocounts=oc, top_ps=0.6)
        tok, lp = P.sample_tokens_full(_t(lg[None]), sp, max_logprobs=5)
        pen = ref_penalize(lg, np.zeros(V, bool), oc[0], 1.5, 0.0, 0.2)
        want = pen / np.float32(t if t > 0 else 1.0)
        want = want - (np.max(want) + np.log(np.exp(want - np.max(want))
                                             .sum()))
        np.testing.assert_allclose(float(lp["chosen"][0]),
                                   want[int(tok[0])], rtol=1e-5)
        ids = lp["top_ids"][0].numpy()
        np.testing.assert_allclose(lp["top_lp"][0].numpy(), want[ids],
                                   rtol=1e-5)
        assert set(ids) == set(np.argsort(want)[::-1][:5])


def _check_dist(obs_freq, want, n):
    tv = 0.5 * np.abs(obs_freq - want).sum()
    assert tv < 0.03, f"TV distance {tv:.4f}"
    support = want > 1e-9
    exp = want[support] * n
    chi2 = ((obs_freq[support] * n - exp) ** 2 / exp).sum()
    df = int(support.sum()) - 1
    assert chi2 < df + 5 * np.sqrt(2 * df) + 10, f"chi2 {chi2:.1f} / {df}"
    assert obs_freq[~support].sum() == 0.0


DIST_CASES = [dict(), dict(top_ps=0.7), dict(min_ps=0.2),
              dict(top_ks=5, top_ps=0.8),
              dict(top_ps=0.85, min_ps=0.05, top_ks=9),
              dict(rep_pens=1.6, freq_pens=0.3, pres_pens=0.4),
              dict(top_ps=0.75, rep_pens=1.4)]


def _state(V):
    pmask = np.zeros(V, bool)
    pmask[[0, 4]] = True
    oc = np.zeros(V, np.int32)
    oc[1], oc[4] = 1, 2
    return pmask, oc


@pytest.mark.parametrize("over", DIST_CASES, ids=str)
def test_sampled_distribution_matches_oracle(over):
    V, N, t = 12, 4000, 0.9
    lg = np.random.default_rng(7).normal(0, 1.5, V).astype(np.float32)
    pmask, oc = _state(V)
    sp = make_sp(N, V, temps=t, pmask=pmask, ocounts=oc, **over)
    toks, _ = P.sample_tokens_full(_t(np.broadcast_to(lg, (N, V))), sp)
    obs = np.bincount(toks.numpy(), minlength=V) / N
    want = ref_full_probs(
        lg, pmask, oc, t, int(over.get("top_ks", 0)),
        float(over.get("top_ps", 1.0)), float(over.get("min_ps", 0.0)),
        float(over.get("rep_pens", 1.0)), float(over.get("pres_pens", 0.0)),
        float(over.get("freq_pens", 0.0)))
    _check_dist(obs, want, N)


SPEC_CASES = [dict(), dict(top_ps=0.8), dict(top_ps=0.8, rep_pens=1.4),
              dict(min_ps=0.1, freq_pens=0.3)]
P_LG = np.asarray([0.0, 1.0, -1.0, 0.5, 0.2, -0.4, 1.3, -2.0], np.float32)
Q_LG = np.asarray([2.0, -2.0, 0.0, 0.0, -1.0, 1.0, -0.5, 0.5], np.float32)


@pytest.mark.parametrize("over", SPEC_CASES, ids=str)
@pytest.mark.parametrize("K", [1, 2])
def test_speculative_verify_full_preserves_target_distribution(over, K):
    """Rejection sampling leaves the first emitted token distributed as
    the transformed target, with a miscalibrated draft; proposals follow
    the transformed draft."""
    V, N = 8, 4000
    pmask = np.zeros(V, bool)
    pmask[0] = True
    oc0 = np.zeros(V, np.int32)
    oc0[6] = 1
    sp = make_sp(N, V, pmask=pmask, ocounts=oc0, **over)
    q_rows = _t(np.broadcast_to(Q_LG, (N, V)))
    oc = _t(sp["ocounts"])
    drafts = []
    for i in range(K):
        nt = P.propose_tokens_full(q_rows, dict(sp, ocounts=oc,
                                                counters=sp["counters"] + i))
        drafts.append(nt)
        oc = oc + P.one_hot(nt, V)
    out, n_acc, lp = P.speculative_verify_full(
        torch.stack(drafts, 1), q_rows[:, None].expand(N, K, V),
        _t(np.broadcast_to(P_LG, (N, K + 1, V))), sp)
    args = (pmask, oc0, 1.0, 0, float(over.get("top_ps", 1.0)),
            float(over.get("min_ps", 0.0)), float(over.get("rep_pens", 1.0)),
            0.0, float(over.get("freq_pens", 0.0)))
    _check_dist(np.bincount(out[:, 0].numpy(), minlength=V) / N,
                ref_full_probs(P_LG, *args), N)
    got_q = np.bincount(drafts[0].numpy(), minlength=V) / N
    assert 0.5 * np.abs(got_q - ref_full_probs(Q_LG, *args)).sum() < 0.03
    assert lp["chosen"].shape == (N, K + 1) and n_acc.max() <= K


@pytest.mark.parametrize("K", [1, 2])
def test_speculative_verify_preserves_target_distribution(K):
    """The plain verifier with temperature and top-k: the first emitted
    token follows the target's transformed distribution."""
    V, N, t, k = 8, 4000, 0.9, 6
    temps, top_ks = np.full(N, t, np.float32), np.full(N, k, np.int32)
    seeds, rids = np.zeros(N, np.int32), np.arange(N, dtype=np.int32)
    q_rows = _t(np.broadcast_to(Q_LG, (N, V)))
    drafts = [P.propose_tokens(q_rows, temps, top_ks, seeds, rids,
                               np.full(N, i, np.int32)) for i in range(K)]
    out, _ = P.speculative_verify(
        torch.stack(drafts, 1), q_rows[:, None].expand(N, K, V),
        _t(np.broadcast_to(P_LG, (N, K + 1, V))), temps, top_ks, seeds, rids,
        np.zeros(N, np.int32))
    want = ref_full_probs(P_LG, np.zeros(V, bool), np.zeros(V, np.int32), t,
                          k, 1.0, 0.0, 1.0, 0.0, 0.0)
    _check_dist(np.bincount(out[:, 0].numpy(), minlength=V) / N, want, N)


def test_speculative_verifiers_match_reference():
    """Both verifiers, mixed greedy and sampled rows: tokens and accept
    counts equal the reference's, the full one at its defaults equals the
    plain one, and K = 0 is ``sample_tokens``."""
    B, K, V = 8, 2, 16
    d_toks = RNG.integers(0, V, (B, K)).astype(np.int32)
    d_lg = RNG.normal(0, 1, (B, K, V)).astype(np.float32)
    t_lg = RNG.normal(0, 1, (B, K + 1, V)).astype(np.float32)
    pr = dict(temps=RNG.choice([0.0, 0.8, 1.2], B).astype(np.float32),
              top_ks=RNG.choice([0, 6], B).astype(np.int32),
              seeds=np.zeros(B, np.int32), rids=np.arange(B, dtype=np.int32),
              counters=RNG.integers(0, 9, B).astype(np.int32))
    order = ("temps", "top_ks", "seeds", "rids", "counters")
    out, acc = P.speculative_verify(_t(d_toks), _t(d_lg), _t(t_lg),
                                    *(pr[k] for k in order))
    jout, jacc = R.speculative_verify(
        *(jnp.asarray(x) for x in (d_toks, d_lg, t_lg)),
        *(jnp.asarray(pr[k]) for k in order))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    fout, facc, _ = P.speculative_verify_full(_t(d_toks), _t(d_lg),
                                              _t(t_lg), make_sp(B, V, **pr))
    assert torch.equal(fout, out) and torch.equal(facc, acc)
    # K = 0: the verify step is sample_tokens on the plain stream
    out0, acc0 = P.speculative_verify(
        _t(d_toks[:, :0]), _t(d_lg[:, :0]), _t(t_lg[:, :1]),
        *(pr[k] for k in order))
    want = P.sample_tokens(_t(t_lg[:, 0]), *(pr[k] for k in order))
    assert torch.equal(out0[:, 0], want) and not acc0.any()
    f0, _, _ = P.speculative_verify_full(_t(d_toks[:, :0]), _t(d_lg[:, :0]),
                                         _t(t_lg[:, :1]), make_sp(B, V, **pr))
    assert torch.equal(f0[:, 0], want)
    # greedy rows: accept while the draft is the target argmax
    g_toks, g_acc = P.greedy_verify(_t(d_toks), _t(t_lg))
    greedy = pr["temps"] == 0
    assert torch.equal(g_toks[greedy], out[greedy])
    assert torch.equal(g_acc[greedy], acc[greedy])


# -- SamplingBuffer ----------------------------------------------------------


class _Req:
    def __init__(self, rid, prompt, out=(), **kw):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.out = list(out)
        self.max_new = kw.get("max_new", 16)
        self.min_new = kw.get("min_new", 0)
        self.sampling = kw.get("sampling", SamplingParams())


def test_sampling_buffer_bind_commit_ring():
    buf = P.SamplingBuffer(4, 16, max_stop_len=3)
    buf.bind(_Req(5, [1, 2, 2, 15]), 2)
    pm, oc = buf.row(5)
    assert pm[[1, 2, 15]].all() and pm.sum() == 3 and oc.sum() == 0
    for tok in (7, 7, 3, 9):
        buf.commit(5, tok)
    pm, oc = buf.row(5)
    assert oc[7] == 2 and oc[3] == 1 and oc[9] == 1
    assert buf.check_stop(5, [(7, 3, 9)]) == (7, 3, 9)
    assert buf.check_stop(5, [(9,)]) == (9,)
    assert buf.check_stop(5, [(7, 7)]) is None          # shifted out
    assert buf.check_stop(5, [(3, 9, 1)]) is None
    buf.free(5)
    assert buf.pmask[2].sum() == 0 and buf.ocounts[2].sum() == 0
    buf.free(5)                                         # double free: no-op


def test_sampling_buffer_rebind_replays_state():
    """Rebinding from (prompt, out) gives the incrementally committed
    state exactly, in another slot."""
    buf = P.SamplingBuffer(2, 32, max_stop_len=4)
    req = _Req(1, [3, 9, 9])
    buf.bind(req, 0)
    for t in [4, 9, 4, 31, 2, 4]:
        buf.commit(1, t)
        req.out.append(t)
    pm0, oc0 = (a.copy() for a in buf.row(1))
    ring0 = buf.rings[0].copy()
    buf.free(1)
    buf.bind(req, 1)
    pm1, oc1 = buf.row(1)
    np.testing.assert_array_equal(pm0, pm1)
    np.testing.assert_array_equal(oc0, oc1)
    np.testing.assert_array_equal(ring0, buf.rings[1])


def test_sampling_buffer_padded_width():
    """Rows are V_pad wide; ids at or past the vocabulary are never
    counted, so the padding columns stay unseen."""
    buf = P.SamplingBuffer(2, 250, width=256)
    buf.bind(_Req(3, [1, 249, 250, 255]), 1)
    for t in (249, 252):
        buf.commit(3, t)
    pm, oc = buf.row(3)
    assert pm.shape == oc.shape == (256,)
    assert pm[[1, 249]].all() and not pm[250:].any()
    assert oc[249] == 1 and not oc[250:].any()
    assert buf.check_stop(3, [(249, 252)]) == (249, 252)


def test_sampling_buffer_validate():
    buf = P.SamplingBuffer(2, 16, max_stop_len=2, max_logprobs=4)
    buf.validate(_Req(0, [1], sampling=SamplingParams(
        top_p=0.5, min_p=0.1, repetition_penalty=1.2, logprobs=4,
        stop=((1, 2),))))
    for bad, msg in ((dict(top_p=0.0), "top_p"), (dict(min_p=1.5), "min_p"),
                     (dict(repetition_penalty=0.0), "repetition"),
                     (dict(logprobs=5), "logprobs"),
                     (dict(stop=((1, 2, 3),)), "stop")):
        with pytest.raises(ValueError, match=msg):
            buf.validate(_Req(0, [1], sampling=SamplingParams(**bad)))
    with pytest.raises(ValueError, match="min_new"):
        buf.validate(_Req(0, [1], min_new=20, max_new=8))


def test_needs_pipeline_flags():
    assert not SamplingParams().needs_pipeline
    assert not SamplingParams(temperature=1.0, top_k=5,
                              stop=((3,),)).needs_pipeline
    for kw in (dict(top_p=0.9), dict(min_p=0.1),
               dict(repetition_penalty=1.1), dict(presence_penalty=0.1),
               dict(frequency_penalty=0.1), dict(logprobs=1)):
        assert SamplingParams(**kw).needs_pipeline, kw
        assert JaxSamplingParams(**kw).needs_pipeline, kw
    assert SamplingParams(stop=[[1, 2]]).stop == ((1, 2),)


# -- engines ----------------------------------------------------------------

ARCHS = ("glm4_9b", "mamba2_370m", "zamba2_2p7b")
ENGINE = dict(max_batch=2, block_size=16, max_len=96,
              max_num_batched_tokens=2 + 16)
MIXED = [dict(temperature=0.8, top_k=20, seed=5), dict(),
         dict(temperature=0.7, top_p=0.9, min_p=0.05, seed=2),
         dict(temperature=1.0, repetition_penalty=1.2, presence_penalty=0.3,
              frequency_penalty=0.2, logprobs=3, seed=9),
         dict(repetition_penalty=1.3, logprobs=2)]


@pytest.fixture(scope="module")
def models():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        cfg = jax_get_config(arch, smoke=True)
        with jax.set_mesh(mesh):
            pf, _ = japi.init_model(cfg, jax.random.key(0))
            tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                                pf)
        tcfg = get_config(arch, smoke=True)
        out[arch] = (cfg, mesh, tree, tcfg, params_from_jax(tree, tcfg, "cpu"))
    return out


def _prompts(vocab, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _port_run(tcfg, params, prompts, sps, max_new=10, arrivals=None,
              rid0=700, **kw):
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          debug_invariants=True, **{**ENGINE, **kw})
    reqs = [Request(p.copy(), max_new=max_new, sampling=SamplingParams(**s),
                    rid=rid0 + i)
            for i, (p, s) in enumerate(zip(prompts, sps))]
    lps = {}
    eng.on_token = lambda r, t, lp: lps.setdefault(r.rid, []).append(lp)
    outs = eng.run(reqs, arrival_steps=arrivals)
    return eng, reqs, [outs[r.rid].tolist() for r in reqs], lps


def _last_logits(params, cfg, tokens):
    """The port's (V_pad,) fp32 logits after ``tokens``, one monolithic
    chunk from fresh state."""
    n, bs = len(tokens), 16
    nb = -(-n // bs)
    cache = make_runner(cfg).init_cache(nb + 1, bs, 1, "cpu")

    def i32(x):
        return torch.tensor(x, dtype=torch.int32)

    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = transformer.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0]


def _penalty_tol(sp):
    """The logits' bf16 tolerance scaled as ``sp``'s repetition penalty
    scales a seen token's logit (the near-tie rule's scaling; for a
    logprob, a logit less the row's log-sum-exp)."""
    return BF16_TOL * max(sp.repetition_penalty, 1 / sp.repetition_penalty)


def _assert_logprobs_close(ours, ref, tol, chosen=True):
    """One token's logprobs against the reference's: the chosen token's
    within ``tol`` (where both chose one token); the top lists rank by
    rank within ``tol``, with equal
    ids at every rank whose reference value stands more than ``tol``
    apart from its listed neighbours' (``torch.topk`` and ``lax.top_k``
    may order near-equal values either way; the last rank's lower
    neighbour is not listed)."""
    assert not chosen or abs(ours["token_logprob"] - ref["token_logprob"]) \
        < tol, (ours["token_logprob"], ref["token_logprob"])
    top, rtop = ours["top"], ref["top"]
    assert len(top) == len(rtop)
    vals = [v for _, v in rtop]
    for p, ((i, v), (ri, rv)) in enumerate(zip(top, rtop)):
        assert abs(v - rv) < tol, (p, top, rtop)
        tied = p == len(vals) - 1 or any(
            abs(vals[q] - rv) < tol for q in (p - 1, p + 1)
            if 0 <= q < len(vals))
        assert i == ri or tied, (p, top, rtop)
    ref_lp = dict(rtop)
    assert all(abs(v - ref_lp[i]) < tol for i, v in top if i in ref_lp), \
        (top, rtop)


def _assert_same_or_near_tie(params, cfg, req, ours, ref):
    """Equal streams, or a first difference where the port's top-2 drawn
    scores (transformed logits plus the step's noise; the transform alone
    for a greedy row) are within the bf16 tolerance, scaled as the
    transform scales logits."""
    if ours == ref:
        return
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    sp = req.sampling
    lg = _last_logits(params, cfg, np.concatenate([req.prompt, ours[:i]]))
    V = lg.shape[-1]
    pm = np.zeros((1, V), bool)
    pm[0, req.prompt] = True
    oc = np.zeros((1, V), np.int32)
    np.add.at(oc[0], np.asarray(ours[:i], np.int64), 1)
    score = P._prep_logits_full(
        lg[None], _t(pm), _t(oc), torch.tensor([sp.temperature]),
        torch.tensor([sp.top_k], dtype=torch.int32), torch.tensor([sp.top_p]),
        torch.tensor([sp.min_p]), torch.tensor([sp.repetition_penalty]),
        torch.tensor([sp.presence_penalty]),
        torch.tensor([sp.frequency_penalty]))[0]
    if sp.temperature > 0:
        key = P.base_key(torch.tensor(sp.seed), torch.tensor(req.rid),
                         torch.tensor(i))
        score = score + prng.gumbel(key, V)
    top2 = torch.topk(score, 2)
    # the transform divides by max(t, 1e-6): greedy rows by 1e-6 too
    tol = _penalty_tol(sp) / max(sp.temperature, 1e-6)
    margin = float(top2.values[0] - top2.values[1])
    assert set(top2.indices.tolist()) == {ours[i], ref[i]}, (i, top2)
    assert margin < tol, f"request {req.rid} step {i}: margin {margin:.4g}"


@pytest.mark.parametrize("seed", [11, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(models, arch, seed):
    """Temperature, top-k and full-pipeline requests in one batch with a
    greedy one, chunked prefill and staggered arrivals: token for token
    with the JAX engine (near-tie rule), logprobs up to a stream's first
    difference within the penalty-scaled bf16 tolerance, the same number
    of full-path steps. Two prompt sets (``seed``)."""
    cfg, mesh, tree, tcfg, params = models[arch]
    prompts = _prompts(cfg.vocab_size, (40, 20, 33, 25, 30), seed)
    arrivals = [0, 0, 2, 3, 5]
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     **ENGINE)
    jreqs = [JaxRequest(p.copy(), max_new=10,
                        sampling=JaxSamplingParams(**s), rid=700 + i)
             for i, (p, s) in enumerate(zip(prompts, MIXED))]
    jlp = {}
    jeng.on_token = lambda r, t, lp: jlp.setdefault(r.rid, []).append(lp)
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng, reqs, outs, lps = _port_run(tcfg, params, prompts, MIXED,
                                     arrivals=arrivals)
    same = True
    for r, ours in zip(reqs, outs):
        ref = jouts[r.rid].tolist()
        assert len(ours) == 10
        _assert_same_or_near_tie(params, tcfg, r, ours, ref)
        same &= ours == ref
        if r.sampling.logprobs:
            n = next((j for j, (a, b) in enumerate(zip(ours, ref)) if a != b),
                     len(ours))
            assert len(lps[r.rid]) == len(jlp[r.rid]) == 10
            # step n (the first difference) still samples one distribution
            for j, (a, b) in enumerate(zip(lps[r.rid][:n + 1],
                                           jlp[r.rid][:n + 1])):
                assert len(a["top"]) == r.sampling.logprobs
                _assert_logprobs_close(a, b, _penalty_tol(r.sampling),
                                       chosen=j < n)
    if same:
        assert eng.stats["full_sampling_steps"] == \
            jeng.stats["full_sampling_steps"] > 0


def test_greedy_runs_no_full_step_and_plain_rows_keep_their_tokens(models):
    """Pure greedy and temperature traffic never runs a full step (nor
    allocates its inputs); adding a logprobs request forces full steps,
    and the other requests' tokens stay byte-identical."""
    _, _, _, tcfg, params = models["glm4_9b"]
    prompts = _prompts(tcfg.vocab_size, (30, 24, 20))
    sps = [dict(), dict(temperature=0.8, top_k=20, seed=3),
           dict(temperature=1.2, seed=4)]
    eng, _, plain, _ = _port_run(tcfg, params, prompts, sps, max_new=8,
                                 max_batch=4)
    assert eng.stats["full_sampling_steps"] == 0 and eng._full_area is None
    eng, _, mixed, lps = _port_run(
        tcfg, params, prompts + _prompts(tcfg.vocab_size, (22,), 5),
        sps + [dict(logprobs=2)], max_new=8, max_batch=4)
    assert eng.stats["full_sampling_steps"] > 0
    assert mixed[:3] == plain
    assert all(lp is None for r in (700, 701, 702) for lp in lps[r])
    assert all(len(lp["top"]) == 2 for lp in lps[703])


@pytest.mark.parametrize("sps", [
    [dict(temperature=0.9, top_k=30, seed=1), dict(temperature=0.7, seed=2)],
    [dict(temperature=0.9, top_p=0.8, repetition_penalty=1.3, seed=1),
     dict(frequency_penalty=0.5, presence_penalty=0.2, logprobs=1)]],
    ids=["plain", "full"])
def test_sampled_replay_across_preemption(models, sps):
    """A pool too small for both requests preempts one; its recompute
    replays the same tokens as an uninterrupted run (keys are (seed, rid,
    counter); the count state is rebuilt from (prompt, out))."""
    _, _, _, tcfg, params = models["glm4_9b"]
    prompts = _prompts(tcfg.vocab_size, (40, 40), 3)
    eng, _, tight, _ = _port_run(tcfg, params, prompts, sps, max_new=20,
                                 num_blocks=6)
    assert eng.stats["preemptions"] >= 1
    _, _, free, _ = _port_run(tcfg, params, prompts, sps, max_new=20)
    assert tight == free


def test_stop_sequences_and_min_new(models):
    """A stop sequence taken from a greedy run's own output retires the
    request when it appears (after min_new); min_new defers both the stop
    and EOS."""
    _, _, _, tcfg, params = models["glm4_9b"]
    prompt = _prompts(tcfg.vocab_size, (30,))
    _, _, (base,), _ = _port_run(tcfg, params, prompt, [dict()], max_new=12)
    stop = tuple(base[3:5])
    first = next(i for i in range(1, len(base))
                 if tuple(base[i - 1:i + 1]) == stop)
    eng, (req,), (out,), _ = _port_run(tcfg, params, prompt,
                                       [dict(stop=(stop,))], max_new=12)
    assert out == base[:first + 1] and req.stop_hit
    assert eng.stats["stop_hits"] == 1 and eng.stats["requests_done"] == 1
    assert eng.stats["full_sampling_steps"] == 0     # stop: a host check
    # min_new past the stop's position: the stop is deferred (it does not
    # recur in the stream) and EOS at base[1] is too
    eng = InferenceEngine(tcfg, device="cpu", params=params, **ENGINE)
    reqs = [Request(prompt[0].copy(), max_new=12, min_new=first + 2,
                    eos_id=base[1], sampling=SamplingParams(stop=(stop,)))]
    out = eng.run(reqs)[reqs[0].rid].tolist()
    assert out == base[:len(out)] and len(out) >= first + 2
    # it retired at max_new, or at an EOS or stop past min_new
    assert len(out) == 12 or out[-1] == base[1] or reqs[0].stop_hit


def test_vocab_not_a_multiple_of_256(models):
    """A 250-token vocabulary (logit rows padded to 256): the plain
    streams equal the JAX engine's (its noise covers the padded row), and
    the full path, whose count rows are V_pad wide, never draws a padding
    column and draws the plain tokens at its defaults."""
    cfg, mesh, _, _, _ = models["glm4_9b"]
    cfg = dataclasses.replace(cfg, vocab_size=250)
    tcfg = dataclasses.replace(get_config("glm4_9b", smoke=True),
                               vocab_size=250)
    assert cfg.padded_vocab_size == tcfg.padded_vocab_size == 256
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(cfg, jax.random.key(1))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    params = params_from_jax(tree, tcfg, "cpu")
    prompts = _prompts(250, (30, 21), 2)
    sps = [dict(temperature=1.5, seed=1), dict(temperature=1.1, top_k=50,
                                               seed=2)]
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     **ENGINE)
    jreqs = [JaxRequest(p.copy(), max_new=10,
                        sampling=JaxSamplingParams(**s), rid=700 + i)
             for i, (p, s) in enumerate(zip(prompts, sps))]
    jouts = jeng.run(jreqs)
    _, reqs, plain, _ = _port_run(tcfg, params, prompts, sps)
    for r, ours in zip(reqs, plain):
        _assert_same_or_near_tie(params, tcfg, r, ours,
                                 jouts[r.rid].tolist())
    eng, _, full, _ = _port_run(tcfg, params, prompts + prompts[:1],
                                sps + [dict(temperature=2.0, top_p=0.99,
                                            repetition_penalty=0.5,
                                            logprobs=1, seed=3)])
    assert eng.samp_buf.pmask.shape[1] == 256
    assert full[:2] == plain
    assert max(max(o) for o in full) < 250
