"""The PDQ filter stage and its CUDA kernel (counterpart of the JAX
package's ``ops/pdq_pallas.py``).

``pdq_filter_batch`` maps planar frames [B, 3, 512, 512] uint8 to the
decimated buffer [B, 64, 64] float32: integer luma, the two Jarosz box
reps and the gather at (8i+4, 8j+4). On CUDA tensors it launches the
hand-written kernel ``csrc/pdq_filter.cu``, which evaluates rep 2 only at
the decimation sites; on CPU tensors it runs ``pdq_filter_batch_plain``,
the full-pass form, which ``pdq_math`` (step 2) declares bit-identical to
the restricted one. ``pdq_hash_batch_fused`` adds the PyTorch tail
(quality, DCT, median threshold, packing).
"""

from __future__ import annotations

import ctypes

import torch

from ..models import pdq as mpdq
from ..vpdq import pdq_math as pm

N = pm.FRAME_DIM  # 512
B64 = pm.BUF_DIM  # 64

#: kernel launches by wrapper name: each wrapper adds one where it launches
#: its kernel (a run reads them to show its path went through the kernel)
LAUNCHES = {"pdq_filter": 0}


def pdq_filter_batch_plain(frames_planar_u8: torch.Tensor) -> torch.Tensor:
    """[B, 3, 512, 512] uint8 -> [B, 64, 64] f32, the full-pass form in
    plain PyTorch."""
    return mpdq._filter_and_decimate(mpdq._luma(frames_planar_u8.permute(0, 2, 3, 1)))


def _check_frames(frames: torch.Tensor) -> None:
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {frames.dtype}")
    if frames.ndim != 4 or tuple(frames.shape[1:]) != (3, N, N):
        raise ValueError(f"frames must be [B, 3, {N}, {N}], got {list(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")


def pdq_filter_batch(frames_planar_u8: torch.Tensor) -> torch.Tensor:
    """[B, 3, 512, 512] uint8 (planar rgb) -> [B, 64, 64] f32.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    ``pdq_filter_batch_plain``. ``LAUNCHES["pdq_filter"]`` counts the
    kernel launches.
    """
    _check_frames(frames_planar_u8)
    if frames_planar_u8.device.type == "cpu":
        return pdq_filter_batch_plain(frames_planar_u8)
    if frames_planar_u8.data_ptr() % 16:
        raise ValueError("frames must be 16-byte aligned")
    batch = frames_planar_u8.shape[0]
    out = torch.empty((batch, B64, B64), dtype=torch.float32, device=frames_planar_u8.device)
    if batch == 0:
        return out
    from . import _build

    recips = mpdq._constants(frames_planar_u8.device)[0]  # box_recips(512)
    _build.check_same_device(out, frames=frames_planar_u8, recips=recips)
    lib = _build.load_library("pdq_filter")
    with torch.cuda.device(frames_planar_u8.device):
        stream = torch.cuda.current_stream(frames_planar_u8.device).cuda_stream
        err = lib.hvd_pdq_filter(
            frames_planar_u8.data_ptr(), recips.data_ptr(), out.data_ptr(), batch, stream
        )
    if err != 0:
        msg = ctypes.string_at(lib.hvd_cuda_error_string(err)).decode()
        raise RuntimeError(f"pdq_filter launch failed: CUDA error {err} ({msg})")
    LAUNCHES["pdq_filter"] += 1
    return out


def pdq_hash_batch_fused(frames_planar_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full PDQ hash with the filter kernel.

    Args:
      frames_planar_u8: [B, 3, 512, 512] uint8 (planar rgb).

    Returns:
      (words [B, 16] int32, quality [B] int32), identical to
      ``models.pdq.pdq_hash_batch`` on the same frames.
    """
    buf64 = pdq_filter_batch(frames_planar_u8)
    return mpdq._threshold_pack(mpdq._dct16(buf64)), mpdq._quality(buf64)
