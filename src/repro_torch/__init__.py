"""repro_torch: the PyTorch/CUDA port of the ``repro`` JAX package.

It imports torch and never jax, and nothing of ``repro``; only its tests
import both packages, to hold the port against the reference. Slices land
in the order of ROADMAP.md; so far the continuous-batching engine serves
dense GQA decoders (glm4_9b), pure Mamba2 (mamba2_370m) and zamba2's
hybrid (zamba2_2p7b), with hand-written CUDA kernels for paged attention,
the embedding gather and the chunked SSD scan.
"""
