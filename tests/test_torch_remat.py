"""``remat`` in the port's training forward (``models.remat``): "none",
"full" and "dots" (the JAX package's ``dots_with_no_batch_dims_saveable``)
give the same loss and the same gradients, bit for bit, for Mamba2, the
hybrid, MoE and the encoder-decoder at smoke size (the dense decoder's
dots step against the JAX package's: ``test_torch_train.py``). A ``TorchDispatchMode`` counting ``aten.mm`` in the backward
shows what each mode keeps: "dots" recomputes no 2-D product (its
backward runs as many as "none"'s), "full" recomputes every layer's. The
encoder-decoder checkpoints its layer bodies with no policy under "dots"
too, as the JAX package's ``encdec`` does, so there "dots" runs "full"'s
products."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import ParallelConfig, ShapeConfig, get_config
from repro_torch.models import api
from repro_torch.optim import optimizers as topt
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["mamba2_370m", "zamba2_2p7b", "qwen3_moe_30b_a3b",
         "whisper_large_v3"]
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in MM
        return func(*args, **(kwargs or {}))


def _loss_and_grads(arch, remat):
    cfg = get_config(arch, smoke=True)
    params = topt.tree_map(lambda t: t.requires_grad_(),
                           api.init_model(cfg, 0, "cpu"))
    batch = api.make_batch(cfg, ShapeConfig("t", 16, 2, "train"), 0, "cpu")
    loss, metr = api.loss_fn(params, batch, cfg, ParallelConfig(remat=remat))
    count = CountMM()
    leaves = topt.tree_leaves(params)
    with count:
        grads = torch.autograd.grad(loss, leaves)
    return loss, metr, grads, count.n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_agree_and_dots_saves_the_products(arch):
    runs = {m: _loss_and_grads(arch, m) for m in ("none", "full", "dots")}
    loss, metr, grads, n_none = runs["none"]
    for mode in ("full", "dots"):
        l2, m2, g2, _ = runs[mode]
        assert torch.equal(l2, loss) and torch.equal(m2["aux"], metr["aux"])
        assert all(torch.equal(a, b) for a, b in zip(g2, grads)), mode
    n_full, n_dots = runs["full"][3], runs["dots"][3]
    assert n_full > n_none, (n_full, n_none)
    assert n_dots == (n_full if api.is_encdec(get_config(arch)) else n_none)


def test_unknown_remat_mode_is_refused():
    cfg = get_config("glm4_9b", smoke=True)
    batch = api.make_batch(cfg, ShapeConfig("t", 8, 2, "train"), 0, "cpu")
    with pytest.raises(ValueError, match="remat='some'"):
        api.loss_fn(api.init_model(cfg, 0, "cpu"), batch, cfg,
                    ParallelConfig(remat="some"))
