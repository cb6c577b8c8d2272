"""Torch on one CPU thread for the port's tests.

The port's CPU tests run smoke-size models: thousands of small tensor ops,
where torch's intra-op threads cost more than they give (the speculative
preemption test takes 3.5 s on one thread and 7.5 s on eight, alone on an
8-core host), and under the suite's six pytest-xdist workers eight threads
each oversubscribe the cores several times over. One thread also keeps a
test's bits independent of the host's core count. Every CPU
``test_torch_*`` module imports this one, so the setting holds whichever of them a process
collects first; the JAX package's tests do not use torch."""

import torch

torch.set_num_threads(1)
