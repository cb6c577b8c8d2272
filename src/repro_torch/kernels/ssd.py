"""Mamba2 chunked SSD scan: the hand-written CUDA kernel's wrapper.

Port of ``repro.kernels.ssd.ssd`` (a Pallas TPU kernel with the chunk axis
as a sequential grid dimension and the state in VMEM scratch). The kernel
is ``csrc/ssd.cu`` (mma.sync tensor-core products, two launches per
chunk); its plain version is ``models.ssm.ssd_chunked``, which
``kernels.ops.ssd`` runs for CPU tensors. The two agree to the fp32
summation order and the kernel's bf16 hi + lo operand parts (y in bf16 to
1e-2 of each row's norm, h_last to 1e-3), not bit for bit. Inside the
kernel every sum has one fixed order, so a launch over 2Q rows equals two
launches of Q with the state carried, and dt = 0 rows leave the state and
the other rows' y unchanged, bit for bit.

B and C may be strided views (slices of the conv output): the kernel takes
their batch and row strides; each group's N values must be dense.

``SSD`` is the scan under autograd, which training runs: the kernel
forward, and a backward that recomputes the plain ``ssd_chunked`` from the
saved inputs and differentiates it. The JAX package has no SSD backward
kernel either: off the TPU it differentiates the plain scan.

``ssd.launches`` counts the calls that launch the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK = 256
MAX_STATE = 256
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    return build.load("ssd", {"ssd_scan": (
        [_VP] * 5 + [_LL] * 4 + [_VP] * 5 + [_INT] * 7 + [_VP], _INT)})


def _check_bc_layout(name, t, N):
    """B and C: each group's N values dense, batch and row strides 16-byte
    multiples (where the dimension has more than one entry)."""
    b, S, G, _ = t.shape
    if t.stride(3) != 1 or (G > 1 and t.stride(2) != N):
        raise ValueError(f"{name} must have dense (G, N) rows: strides "
                         f"{t.stride()}")
    for dim, size in ((0, b), (1, S)):
        if size > 1 and t.stride(dim) % 8:
            raise ValueError(f"{name}'s batch and row strides must be "
                             f"multiples of 8 elements (16 bytes), got "
                             f"{t.stride()}")


def _check(x, dt, A, B, C, chunk, h0):
    """Raise ValueError on anything the kernel does not take: shapes and
    dtypes first, then layouts, devices and alignment."""
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
    if hp % 16 or N % 8 or N > MAX_STATE or G < 1 or nh % G:
        raise ValueError(f"head_dim {hp} must be a multiple of 16, state "
                         f"{N} a multiple of 8 up to {MAX_STATE}, and "
                         f"groups {G} must divide heads {nh}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S={S}")
    _check_bc_layout("B", B, N)
    _check_bc_layout("C", C, N)
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "h0": h0}
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (a CUDA "
                             f"device), got {t.device}")
        if name not in ("B", "C") and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("B and C must be 16-byte aligned (the kernel reads "
                         "their rows in 16-byte vectors)")
    return b, S, nh, hp, G, N


def ssd(x, dt, A, B, C, *, chunk, h0=None):
    """CUDA SSD scan. x (b, S, nh, hp) bf16; dt (b, S, nh) fp32; A (nh,)
    fp32; B, C (b, S, G, N) bf16, strided as ``_check_bc_layout`` allows;
    h0 (b, nh, hp, N) fp32 or None (zeros); S a multiple of ``chunk``.
    Returns (y (b, S, nh, hp) bf16, h_last (b, nh, hp, N) fp32)."""
    b, S, nh, hp, G, N = _check(x, dt, A, B, C, chunk, h0)
    dev = x.device
    y = torch.empty_like(x)
    h_last = torch.empty((b, nh, hp, N), dtype=torch.float32, device=dev)
    qt = -(-chunk // 64) * 64
    cb = torch.empty((b, G, qt, qt), dtype=torch.float32, device=dev)
    h_tmp = torch.empty_like(h_last) if S > chunk else None
    with build.on_device(x):
        rc = _lib().ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if h_tmp is None else h_tmp.data_ptr(),
            cb.data_ptr(), b, S, nh, hp, G, N, chunk,
            build.current_stream(x))
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    ssd.launches += 1
    return y, h_last


ssd.launches = 0


class SSD(torch.autograd.Function):
    """(y, h_last) = the scan of (x, dt, A, B, C, h0) through the kernel;
    gradients by autograd through the plain ``ssd_chunked`` recomputed
    from the saved inputs. ``None`` for an input that needs none (h0 may
    be None)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        y, h_last = ssd(x, dt, A, B, C, chunk=chunk, h0=h0)
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh):
        from repro_torch.models.ssm import ssd_chunked
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, needs)]
            y, h_last = ssd_chunked(*ins[:5], chunk=ctx.chunk, h0=ins[5])
            outs = [(o, g) for o, g in ((y, dy), (h_last, dh))
                    if g is not None]
            wrt = [t for t, n in zip(ins, needs) if n and t is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wrt, [g for _, g in outs],
                allow_unused=True) if outs and wrt else ())
        out = [next(grads) if n and t is not None else None
               for t, n in zip(ins, needs)]
        return (*out, None)
