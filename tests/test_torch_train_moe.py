"""Training of the mixture-of-experts decoders (qwen3_moe_30b_a3b, grok1_314b) in the port against the JAX package at smoke
size (``torch_train_cases``): the loss and one AdamW step (remat full,
two microbatches), and qwen3_moe's fp32 masters after an SGD step, each
leaf against its own update (the router's included). The load-balance loss
(aux, summed over the MoE layers) enters the loss at MOE_AUX_COEF and is
held beside ce."""

import pytest

from torch_train_cases import (cases as make_cases, check_loss_fn,
                               check_sgd_masters, check_train_step)
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["qwen3_moe_30b_a3b", "grok1_314b"]


@pytest.fixture(scope="module")
def cases():
    out = make_cases(ARCHS, ("bfloat16",))
    out[ARCHS[0], "float32"] = out[ARCHS[0], "bfloat16"].at("float32")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(cases, arch):
    check_loss_fn(cases[arch, "bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(cases, arch):
    check_train_step(cases[arch, "bfloat16"])


def test_sgd_masters_match_jax(cases):
    check_sgd_masters(cases[ARCHS[0], "float32"])
