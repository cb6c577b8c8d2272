"""repro_torch: the PyTorch/CUDA port of the ``repro`` JAX package.

It imports torch and never jax, and nothing of ``repro``; only its tests
import both packages, to hold the port against the reference. Slices land
in the order of ROADMAP.md; the continuous-batching engine serves every
architecture the JAX package's engine serves (dense GQA decoders,
mixture-of-experts decoders, pure Mamba2, zamba2's hybrid and whisper's
encoder-decoder; qwen2_vl through the static path), with hand-written
CUDA kernels for paged and flash attention, the embedding gather, the
chunked SSD scan and the sampled-softmax loss.
"""
