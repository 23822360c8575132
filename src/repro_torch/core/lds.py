"""Low-discrepancy sequences (Hammersley, Halton, Sobol', van der Corput)
and the 24-bit fixed-point QMC streams of the serving layer (numpy, with
tensor twins of the stream points).

The paper's QMC experiments (Figs. 1, 7-9) warp these sequences through the
monotone inverse CDF. The serving streams run counter -> bit-reversed 24-bit
radical inverse (and, for 2-D streams, Sobol' dimension 1 on the same grid)
-> Cranley-Patterson rotation as an integer add mod 2^24 -> exact float32.
Every step is exact integer arithmetic plus one exact int->float
conversion, so these points are bit-identical to the JAX package's. A copy
of that module's numpy code.
"""
from __future__ import annotations

import numpy as np
import torch

_PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53], np.int64
)

# Sobol' direction numbers (Joe & Kuo, new-joe-kuo-6) for dimensions 1..16.
# Dim 0 is van der Corput in base 2. Entries: (s, a, m_i ...). A dimension
# past the table raises: recycling a polynomial would make two columns
# identical.
_SOBOL_POLY = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
]

SOBOL_MAX_DIMS = len(_SOBOL_POLY) + 1  # + dim 0 (van der Corput)

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


def _sobol2_v24() -> np.ndarray:
    """Sobol' dimension-1 direction numbers on the 24-bit stream grid."""
    return (_sobol_directions(1) >> np.uint64(32 - QMC_BITS)).astype(np.uint32)


def sobol2_bits24_np(counter: np.ndarray) -> np.ndarray:
    """Counter -> unrotated Sobol' dim-1 point in units of 2^-24: the XOR of
    the direction numbers of the counter's set bits. With the van der
    Corput u-dimension of :func:`qmc_bits24_np` (= Sobol' dim 0) it forms
    the 2-D Sobol' pair of the spatial serving streams."""
    c = np.asarray(counter, np.uint32)
    v = _sobol2_v24()
    x = np.zeros(c.shape, np.uint32)
    for k in range(32):
        bit = (c >> np.uint32(k)) & np.uint32(1)
        x ^= bit * v[k]
    return x & _QMC_MASK


def qmc2_bits24_np(counter: np.ndarray, offset_u: np.ndarray, offset_v: np.ndarray):
    """Counter -> rotated 2-D stream point (integer form): u the base-2
    radical inverse, v Sobol' dim 1, each with its own rotation mod 2^24."""
    u = qmc_bits24_np(counter, offset_u)
    v = (sobol2_bits24_np(counter) + np.asarray(offset_v, np.uint32)) & _QMC_MASK
    return u, v


def qmc2_point_np(counter: np.ndarray, offset_u: np.ndarray, offset_v: np.ndarray):
    """Rotated 2-D stream point as exact float32 pairs in [0, 1)^2."""
    u, v = qmc2_bits24_np(counter, offset_u, offset_v)
    return u.astype(np.float32) * QMC_SCALE, v.astype(np.float32) * QMC_SCALE


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


# Sobol' dim 1 by bytes: the XOR over a counter's set bits is linear, so it
# is the XOR of four 256-entry tables, one a byte of the counter.
def _sobol2_byte_tables() -> np.ndarray:
    v = _sobol2_v24().astype(np.int64)
    b = np.arange(256, dtype=np.int64)
    out = np.zeros((4, 256), np.int64)
    for k in range(32):
        out[k // 8] ^= ((b >> (k % 8)) & 1) * v[k]
    return out


_SOBOL2_TABLES: dict[torch.device, torch.Tensor] = {}


def _sobol2_tables(device: torch.device) -> torch.Tensor:
    """The (4, 256) byte tables on ``device``, copied there once, so a
    drain's stream points make no host-to-device copy."""
    t = _SOBOL2_TABLES.get(device)
    if t is None:
        t = _SOBOL2_TABLES[device] = torch.as_tensor(_sobol2_byte_tables(), device=device)
    return t


def sobol2_bits24(counter: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`sobol2_bits24_np` (int32 bits or int64 values
    in, int64 out): the XOR of four byte-table lookups, equal to the bit
    loop by linearity."""
    c = counter.to(torch.int64) & _M32
    t = _sobol2_tables(counter.device)
    x = t[0][c & 0xFF]
    for k in range(1, 4):
        x = x ^ t[k][(c >> (8 * k)) & 0xFF]
    return x & int(_QMC_MASK)


def qmc2_bits24(counter: torch.Tensor, offset_u: torch.Tensor, offset_v: torch.Tensor):
    """Tensor twin of :func:`qmc2_bits24_np` (int64 values out)."""
    u = qmc_bits24(counter, offset_u)
    v = (sobol2_bits24(counter) + (offset_v.to(torch.int64) & _M32)) & int(_QMC_MASK)
    return u, v


def qmc2_point(counter: torch.Tensor, offset_u: torch.Tensor, offset_v: torch.Tensor):
    """Tensor twin of :func:`qmc2_point_np` (exact float32 in [0, 1)^2)."""
    u, v = qmc2_bits24(counter, offset_u, offset_v)
    scale = float(QMC_SCALE)
    return u.to(torch.float32) * scale, v.to(torch.float32) * scale


def radical_inverse_base2(i: np.ndarray) -> np.ndarray:
    """Van der Corput sequence in base 2 via 32-bit reversal, float64 on the
    2^-24 grid (exact in float32)."""
    b = reverse_bits32_np(np.asarray(i, np.uint32))
    return (b >> np.uint32(8)).astype(np.float64) * (1.0 / (1 << 24))


def radical_inverse(i: np.ndarray, base: int) -> np.ndarray:
    """Van der Corput sequence in arbitrary integer base."""
    if base == 2:
        return radical_inverse_base2(i)
    i = np.asarray(i, np.int64).copy()
    inv = np.zeros(i.shape, np.float64)
    f = 1.0 / base
    while np.any(i > 0):
        inv += f * (i % base)
        i //= base
        f /= base
    return inv


def hammersley(n: int, dims: int = 2) -> np.ndarray:
    """The n-point Hammersley set in [0,1)^dims (first component = i/n)."""
    idx = np.arange(n, dtype=np.int64)
    cols = [idx.astype(np.float64) / n]
    for d in range(dims - 1):
        cols.append(radical_inverse(idx, int(_PRIMES[d])))
    return np.stack(cols, axis=-1)


def halton(n: int, dims: int = 2, start: int = 0) -> np.ndarray:
    idx = np.arange(start, start + n, dtype=np.int64)
    cols = [radical_inverse(idx, int(_PRIMES[d])) for d in range(dims)]
    return np.stack(cols, axis=-1)


def _sobol_directions(dim: int, bits: int = 32) -> np.ndarray:
    """Direction numbers v_k (as uint32 scaled by 2^32) for one dimension."""
    if dim == 0:
        return np.array([1 << (31 - k) for k in range(bits)], np.uint64)
    if dim - 1 >= len(_SOBOL_POLY):
        raise ValueError(
            f"sobol direction-number table covers dims <= {SOBOL_MAX_DIMS} "
            f"(got dimension index {dim}); recycling polynomials would make "
            f"dimensions {dim} and {((dim - 1) % len(_SOBOL_POLY)) + 1} "
            "identical"
        )
    s, a, m = _SOBOL_POLY[dim - 1]
    m = list(m)
    v = np.zeros(bits, np.uint64)
    for k in range(s):
        v[k] = np.uint64(m[k]) << np.uint64(31 - k)
    for k in range(s, bits):
        vk = v[k - s] ^ (v[k - s] >> np.uint64(s))
        for j in range(1, s):
            if (a >> (s - 1 - j)) & 1:
                vk ^= v[k - j]
        v[k] = vk
    return v


def sobol(n: int, dims: int = 2, scramble_seed: int | None = None) -> np.ndarray:
    """First n points of the Sobol' sequence (graycode order), with an
    optional digital shift (XOR scramble) per dimension. Up to
    ``SOBOL_MAX_DIMS`` dimensions; past that the table raises."""
    out = np.zeros((n, dims), np.float64)
    rng = np.random.default_rng(scramble_seed) if scramble_seed is not None else None
    idx = np.arange(n, dtype=np.uint64)
    gray = idx ^ (idx >> np.uint64(1))
    for d in range(dims):
        v = _sobol_directions(d)
        x = np.zeros(n, np.uint64)
        g = gray.copy()
        for k in range(32):
            bit = (g >> np.uint64(k)) & np.uint64(1)
            x ^= bit * v[k]
        if rng is not None:
            x ^= np.uint64(rng.integers(0, 1 << 32, dtype=np.uint64))
        out[:, d] = (x >> np.uint64(8)).astype(np.float64) * (1.0 / (1 << 24))
    return out


def uniform(n: int, dims: int = 2, seed: int = 0) -> np.ndarray:
    """Plain pseudo-random points: the MC baseline for QMC comparisons."""
    return np.random.default_rng(seed).random((n, dims))
