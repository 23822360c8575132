"""The 24-bit fixed-point QMC stream pipeline of the serving layer (numpy),
and the base-2 radical inverse of the data mixture.

counter -> bit-reversed 24-bit radical inverse -> Cranley-Patterson
rotation as an integer add mod 2^24 -> exact float32. Every step is exact
integer arithmetic plus one exact int->float conversion, so these points are
bit-identical to the JAX package's. A copy of the subset the port needs.
"""
from __future__ import annotations

import numpy as np
import torch

QMC_BITS = 24                  # fixed-point resolution of the stream points
QMC_SCALE = np.float32(2.0 ** -QMC_BITS)
_QMC_MASK = np.uint32((1 << QMC_BITS) - 1)


def reverse_bits32_np(i: np.ndarray) -> np.ndarray:
    """Bit-reverse uint32 values (numpy)."""
    b = np.asarray(i, np.uint32).copy()
    b = ((b & np.uint32(0x55555555)) << np.uint32(1)) | ((b & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    b = ((b & np.uint32(0x33333333)) << np.uint32(2)) | ((b & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    b = ((b & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((b & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    b = ((b & np.uint32(0x00FF00FF)) << np.uint32(8)) | ((b & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return (b << np.uint32(16)) | (b >> np.uint32(16))


def qmc_bits24_np(counter: np.ndarray, offset_bits: np.ndarray) -> np.ndarray:
    """Counter -> rotated 24-bit stream point (integer form).

    ``reverse_bits32 >> 8`` is the base-2 radical inverse in units of
    2^-24; the rotation is an integer add mod 2^24."""
    rev = reverse_bits32_np(counter) >> np.uint32(32 - QMC_BITS)
    return (rev + np.asarray(offset_bits, np.uint32)) & _QMC_MASK


def qmc_point_np(counter: np.ndarray, offset_bits: np.ndarray) -> np.ndarray:
    """Rotated stream point as exact float32 in [0, 1)."""
    return qmc_bits24_np(counter, offset_bits).astype(np.float32) * QMC_SCALE


def qmc_offset_bits_np(offsets01) -> np.ndarray:
    """Quantize [0,1) rotation offsets to the stream's 24-bit grid."""
    bits = (np.asarray(offsets01, np.float64) * (1 << QMC_BITS)).astype(np.uint32)
    return np.minimum(bits, _QMC_MASK)


# Tensor twins. PyTorch has no uint32 arithmetic to speak of: the device
# stream state holds 32-bit values as int32 bit views (the form the drain
# kernel reads), and these functions widen either int32 bits or int64 values
# to int64 masked to 32 bits, so the points equal the numpy pipeline's.
_M32 = 0xFFFFFFFF


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse 32-bit values (int32 bits or int64 values) -> int64."""
    b = x.to(torch.int64) & _M32
    for mask, shift in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4),
                        (0x00FF00FF, 8), (0x0000FFFF, 16)):
        b = ((b & mask) << shift) | ((b >> shift) & mask)
    return b


def qmc_bits24(counter: torch.Tensor, offset_bits: torch.Tensor) -> torch.Tensor:
    """Counter -> rotated 24-bit stream point (integer form, int64)."""
    rev = reverse_bits32(counter) >> (32 - QMC_BITS)
    return (rev + (offset_bits.to(torch.int64) & _M32)) & int(_QMC_MASK)


def qmc_point(counter: torch.Tensor, offset_bits: torch.Tensor) -> torch.Tensor:
    """Rotated stream point as exact float32 in [0, 1)."""
    return qmc_bits24(counter, offset_bits).to(torch.float32) * float(QMC_SCALE)


def radical_inverse_base2(i: np.ndarray) -> np.ndarray:
    """Van der Corput sequence in base 2 via 32-bit reversal, float64 on the
    2^-24 grid (exact in float32)."""
    b = reverse_bits32_np(np.asarray(i, np.uint32))
    return (b >> np.uint32(8)).astype(np.float64) * (1.0 / (1 << 24))
