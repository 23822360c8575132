"""Flash attention (online softmax over key tiles) for the eval forward.

``flash_attention(q, k, v, causal)`` computes what the JAX package's Pallas
kernel computes: scores of queries scaled by ``1/sqrt(hd)`` against keys in
float32, keys past ``Sk`` and (when causal) keys after the query masked, a
running max/sum/accumulator in float32, the output ``acc / max(l, 1e-30)``
cast to q's dtype. Query head ``h`` reads key head ``h // (H / KV)`` in
place (GQA without copying K/V). For CUDA tensors it launches the
hand-written kernel ``csrc/flash_attention.cu``: bfloat16 inputs run on the
tensor cores (wgmma, TMA loads; the scale is applied after the product and
the softmax weights are rounded to bf16 before the product with V, as the
JAX einsum path rounds them), float32 inputs on the tensor cores too (wgmma
on TF32), each product as three TF32 products (operands split into TF32 hi
and lo parts, lo.hi' + hi.lo' + hi.hi' summed in float32: ~22 bits, where
TF32 alone would miss the float32 tolerance). For CPU tensors it runs the plain
version :func:`repro_torch.kernels.ref.ref_flash_attention` (materialized
scores). The two sum in other orders, so they agree to a tolerance, not
bit for bit.

There is no backward: the reference cannot differentiate its kernel either
(``jax.grad`` through the Pallas call raises), so an input that requires
grad is refused (ROADMAP B10).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .ref import ref_flash_attention

# head dims the kernel takes: 32, 64 and 128 have tiles of their own, 112
# runs the 128 tile over zero-filled columns
HEAD_DIMS = (32, 64, 112, 128)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) strides in elements; the head dim is dense."""
    return t.stride(0), t.stride(1), t.stride(2)


def _tma_ready(t: torch.Tensor) -> bool:
    """A bf16 (B, S, heads, hd) tensor that TMA reads in place: a 16-byte
    aligned base, a dense head dim, and (batch, sequence, head) strides that
    are positive multiples of 8 elements (16 bytes) wherever the size is
    above 1."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(t.stride(i) > 0 and t.stride(i) % 8 == 0
                    for i in range(3) if t.shape[i] > 1))


def kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list[torch.Tensor]:
    """The tensors the kernel reads. float32: each as it is if its head dim
    is dense, else a contiguous copy. bfloat16: each as it is if TMA can read
    it (:func:`_tma_ready`), else an explicit contiguous copy in fresh,
    aligned memory (``clone``, since ``contiguous()`` returns a misaligned
    but contiguous view unchanged). Strided views such as the transposes of
    (B, heads, S, hd) tensors are read in place."""
    if q.dtype == torch.bfloat16:
        return [t if _tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
                for t in (q, k, v)]
    return [t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd), all float32 or all bfloat16,
    ``H % KV == 0``, ``hd`` in ``HEAD_DIMS`` (32, 64, 112, 128) -> (B, Sq,
    H, hd) in q's dtype; the scale is ``1/sqrt(hd)``.
    Causal masking is top-left aligned: query ``i`` sees keys ``0..i``.
    On the card, a bf16 input that TMA cannot read in place (misaligned
    base or strides) is copied first (:func:`kernel_inputs`)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if KV == 0 or H % KV or Sk == 0:
        raise ValueError(f"flash_attention: need Sk > 0 and H ({H}) a multiple of KV ({KV})")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must all be float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share a device")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward: the JAX reference cannot differentiate its "
            "Pallas kernel either (ROADMAP B10); train with attn_impl='einsum', or run "
            "the flash forward under torch.no_grad()")
    if not q.is_cuda:
        return ref_flash_attention(q, k, v, causal)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    q, k, v = kernel_inputs(q, k, v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B * Sq * H == 0:
        return out
    err = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, hd, *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        int(causal), int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd),
        _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
