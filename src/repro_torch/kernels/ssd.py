"""Mamba2 chunked SSD scan: the hand-written CUDA kernel's wrapper.

Port of ``repro.kernels.ssd.ssd`` (a Pallas TPU kernel with the chunk axis
as a sequential grid dimension and the state in VMEM scratch). The kernel
is ``csrc/ssd.cu``; its plain version is ``models.ssm.ssd_chunked``, which
``kernels.ops.ssd`` runs for CPU tensors. The two agree to the fp32
summation order (y in bf16 to 1e-2 of each row's norm), not bit for bit.
Inside the kernel every sum has one fixed order, so a launch over 2Q rows
equals two launches of Q with the state carried, and dt = 0 rows leave
the state and the other rows' y unchanged, bit for bit.

``ssd.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK = 256
_VP, _INT = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.load("ssd")
    lib.ssd_scan.argtypes = [_VP] * 8 + [_INT] * 7 + [_VP]
    lib.ssd_scan.restype = _INT
    return lib


def _check(x, dt, A, B, C, chunk, h0):
    """Raise ValueError on anything the kernel does not take: shapes and
    dtypes first, then devices, contiguity and alignment."""
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 (b, S, nh, hp), got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, S, nh, hp = x.shape
    if B.dim() != 4 or B.shape[:2] != (b, S) or B.shape != C.shape \
            or B.dtype != torch.bfloat16 or C.dtype != torch.bfloat16:
        raise ValueError(f"B and C must be bf16 ({b}, {S}, G, N), got "
                         f"{B.dtype} {tuple(B.shape)} / {C.dtype} "
                         f"{tuple(C.shape)}")
    G, N = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, S, nh) or dt.dtype != torch.float32:
        raise ValueError(f"dt must be float32 {(b, S, nh)}, got {dt.dtype} "
                         f"{tuple(dt.shape)}")
    if tuple(A.shape) != (nh,) or A.dtype != torch.float32:
        raise ValueError(f"A must be float32 ({nh},), got {A.dtype} "
                         f"{tuple(A.shape)}")
    if h0 is not None and (tuple(h0.shape) != (b, nh, hp, N)
                           or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be float32 {(b, nh, hp, N)}, got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if hp % 16 or N % 8 or G < 1 or nh % G:
        raise ValueError(f"head_dim {hp} must be a multiple of 16, state "
                         f"{N} of 8, and groups {G} must divide heads {nh}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S={S}")
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "h0": h0}
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (a CUDA "
                             f"device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("B and C must be 16-byte aligned (the kernel reads "
                         "their rows in 16-byte vectors)")
    return b, S, nh, hp, G, N


def ssd(x, dt, A, B, C, *, chunk, h0=None):
    """CUDA SSD scan. x (b, S, nh, hp) bf16; dt (b, S, nh) fp32; A (nh,)
    fp32; B, C (b, S, G, N) bf16; h0 (b, nh, hp, N) fp32 or None (zeros);
    S a multiple of ``chunk``. Returns (y (b, S, nh, hp) bf16, h_last (b,
    nh, hp, N) fp32)."""
    b, S, nh, hp, G, N = _check(x, dt, A, B, C, chunk, h0)
    y = torch.empty_like(x)
    h_last = torch.empty((b, nh, hp, N), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), b, S, nh, hp, G, N, chunk,
            build.current_stream(x))
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    ssd.launches += 1
    return y, h_last


ssd.launches = 0
