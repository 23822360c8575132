"""Float bit-pattern utilities underlying radix-tree distance computations.

For IEEE-754 floats in ``[0, 1)`` the order of values equals the order of
their bit patterns read as unsigned integers, so the XOR of two patterns has
its most significant set bit at the level of the implicit radix tree at
which the two values part ways (Binder & Keller 2019, Sec. 3.1).

PyTorch supports few operations on ``uint32`` (no shifts, compares or
maxima on the CPU), so the port carries 32-bit patterns and distances as
``int64`` holding the zero-extended unsigned value.
"""
from __future__ import annotations

import numpy as np
import torch

# "Maximum distance" across guide-cell boundaries and outside the data range.
# Any XOR of two non-negative finite float32 patterns is <= 0x7fffffff, so
# this is strictly larger than every real distance.
DIST_SENTINEL = 0xFFFFFFFF

_MASK32 = 0xFFFFFFFF


def float_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit pattern of float32 ``x`` as zero-extended int64."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK32


def bits_to_float(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_to_bits` (low 32 bits of ``b`` as float32)."""
    low = b.to(torch.int64) & _MASK32
    return torch.where(low >= 2**31, low - 2**32, low).to(torch.int32).view(
        torch.float32
    )


def xor_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Radix-tree distance of two float32 values in [0, 1) (as int64)."""
    return float_to_bits(a) ^ float_to_bits(b)


def np_float_to_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def np_xor_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np_float_to_bits(a) ^ np_float_to_bits(b)


def msb_index(x: np.ndarray) -> np.ndarray:
    """Index of the most significant set bit (numpy, for analysis/tests)."""
    x = np.asarray(x, np.uint32)
    out = np.full(x.shape, -1, np.int32)
    v = x.copy()
    for shift in (16, 8, 4, 2, 1):
        ge = v >= np.uint32(1 << shift)
        out = np.where(ge, out + shift, out)
        v = np.where(ge, v >> np.uint32(shift), v)
    return np.where(x > 0, out + 1, -1)  # -1 for x == 0
