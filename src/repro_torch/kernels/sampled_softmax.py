"""Fused sampled-softmax loss: the hand-written CUDA kernel's wrapper.

Port of ``repro.kernels.sampled_softmax.sampled_softmax_loss`` (a Pallas
TPU kernel over 256-row tiles; forward only, no VJP). The true-class and
sampled rows come from the port's gather kernel, as on the TPU they come
from the Pallas gather. The kernel is ``csrc/sampled_softmax.cu``; its
plain version is ``ref.sampled_softmax_loss_ref``, which
``kernels.ops.sampled_softmax_loss`` runs for CPU tensors. No model path
calls either, in this package or in the JAX package: the models' sampled
softmax (``models.embedding.sampled_softmax_loss``) is plain tensor code.

``sampled_softmax_loss.launches`` counts the kernel's launches (one per
call, which runs its three passes). ``plan`` is the launch plan of its
GEMM launch, a pure function of (T, n, the SM count).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels import embedding as emb

ROWS, COLS, STEP = 128, 256, 64   # block rows, column tile, d per step
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the GEMM launch splits T rows and n sampled columns: row_tiles
    blocks of 128 rows for each of nsplit ranges of `per` 256-column tiles
    (the last range may hold fewer)."""
    row_tiles: int
    n_tiles: int
    per: int
    nsplit: int

    def ranges(self) -> list[tuple[int, int]]:
        """Each range's column tiles [first, end), in the order its
        partials merge."""
        return [(s * self.per, min(self.n_tiles, (s + 1) * self.per))
                for s in range(self.nsplit)]

    def blocks(self) -> list[tuple[int, int]]:
        """(row tile, range) of each block in launch order: row tiles are
        the grid's fast axis, so the blocks resident together share a
        range and walk its tiles in step."""
        return [(rt, s) for s in range(self.nsplit)
                for rt in range(self.row_tiles)]


def plan(T: int, n: int, sms: int) -> Plan:
    """Split the column tiles into ranges until there is about one block
    per SM (no second wave: row_tiles x nsplit <= max(sms, row_tiles))."""
    row_tiles, n_tiles = -(-T // ROWS), -(-n // COLS)
    per = -(-n_tiles // min(n_tiles, max(1, sms // row_tiles)))
    return Plan(row_tiles, n_tiles, per, -(-n_tiles // per))


def _lib():
    lib = build.load("sampled_softmax")
    lib.sampled_softmax_loss.argtypes = [_VP] * 9 + [_INT] * 5 + [_F, _VP]
    lib.sampled_softmax_loss.restype = _INT
    return lib


def _check(x, table, labels, sampled_ids):
    if x.dim() != 2 or table.dim() != 2 or x.shape[1] != table.shape[1]:
        raise ValueError(f"sampled_softmax_loss: x (T, d) and table (V, d) "
                         f"expected, got {tuple(x.shape)}, "
                         f"{tuple(table.shape)}")
    T, d = x.shape
    if T < 1 or labels.shape != (T,) or sampled_ids.dim() != 1 \
            or sampled_ids.shape[0] < 1:
        raise ValueError(f"sampled_softmax_loss: T >= 1 rows, labels "
                         f"({T},) and sampled_ids (n,) with n >= 1 "
                         f"expected, got {tuple(labels.shape)}, "
                         f"{tuple(sampled_ids.shape)}")
    if x.dtype != torch.bfloat16 or table.dtype != torch.bfloat16:
        raise ValueError(f"sampled_softmax_loss: the kernel takes bf16 x "
                         f"and table, got {x.dtype}, {table.dtype}")
    if d % STEP:
        raise ValueError(f"sampled_softmax_loss: d must be a multiple of "
                         f"{STEP}, got {d}")
    for name, t in (("x", x), ("table", table), ("labels", labels),
                    ("sampled_ids", sampled_ids)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"sampled_softmax_loss: {name} must be on "
                             f"{x.device} (a CUDA device), got {t.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("sampled_softmax_loss: x must be contiguous and "
                         "16-byte aligned")


def sampled_softmax_loss(x, table, labels, sampled_ids, *, cap=None):
    """CUDA sampled-softmax loss. x (T, d) bf16, d a multiple of 64; table
    (V, d) bf16; labels (T,), sampled_ids (n,) integer ids into the table.
    Returns the mean loss over T, an fp32 scalar tensor. Two calls on the
    same inputs and card return the same bits."""
    _check(x, table, labels, sampled_ids)
    T, d = x.shape
    n = sampled_ids.shape[0]
    labels = labels.to(torch.int32).contiguous()
    sids = sampled_ids.to(torch.int32).contiguous()
    w_true = emb.gather(table, labels)                     # (T, d)
    w_samp = emb.gather(table, sids)                       # (n, d)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = plan(T, n, sms)
    f32 = dict(dtype=torch.float32, device=x.device)
    m_part = torch.empty((T, p.nsplit), **f32)
    l_part = torch.empty((T, p.nsplit), **f32)
    row_loss = torch.empty((T,), **f32)
    out = torch.empty((1,), **f32)
    with torch.cuda.device(x.device):
        rc = _lib().sampled_softmax_loss(
            x.data_ptr(), w_true.data_ptr(), labels.data_ptr(),
            w_samp.data_ptr(), sids.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), row_loss.data_ptr(), out.data_ptr(), T, d, n,
            p.per, p.nsplit, 0.0 if cap is None else float(cap),
            build.current_stream(x))
    if rc != 0:
        raise RuntimeError("sampled_softmax_loss: the tensor maps could not "
                           "be built" if rc == -1 else
                           f"sampled_softmax_loss launch failed: cudaError "
                           f"{rc}")
    sampled_softmax_loss.launches += 1
    return out[0]


sampled_softmax_loss.launches = 0
