"""repro_torch: the PyTorch/CUDA port of the ``repro`` JAX package.

It imports torch and never jax, and nothing of ``repro``; only its tests
import both packages, to hold the port against the reference. Slices land
in the order of ROADMAP.md; this one serves dense GQA decoders (glm4_9b)
through the continuous-batching engine with hand-written CUDA kernels for
paged attention and the embedding gather.
"""
