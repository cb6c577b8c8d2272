"""Training of the dense family in the port against the JAX package at
smoke size (``torch_train_cases``): every arch's loss, and one AdamW
step (remat full, two microbatches) of starcoder2_3b (LayerNorm, ungated
MLP), gemma2_27b (windows, softcaps, post-block norms) and qwen3_32b
(qk-norm). glm4_9b's steps, its SGD masters and sampled softmax are
``test_torch_train.py``'s."""

import pytest

from torch_train_cases import (cases as make_cases, check_loss_fn,
                               check_train_step)
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["glm4_9b", "starcoder2_3b", "gemma2_27b", "qwen3_32b"]


@pytest.fixture(scope="module")
def cases():
    return make_cases(ARCHS, ("bfloat16",))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(cases, arch):
    check_loss_fn(cases[arch, "bfloat16"])


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_train_step_matches_jax(cases, arch):
    check_train_step(cases[arch, "bfloat16"])
