"""The grouped drain kernels' launch plumbing (``csrc/lanes.cuh``): the
per-group descriptor table and the checks of the per-lane arrays.

One launch of ``forest_sample_batched`` or ``alias_sample_batched`` serves
up to ``GROUP_CAP`` (method, size class) groups: lane ``q`` belongs to local
group ``gid[q] - g0`` when that lies in the launch's range, descends row
``row[q]`` of that group's stack and has its result clipped to ``hi[q]``.
More groups take more launches, each with the next ``GROUP_CAP`` groups and
its own ``g0``. The table travels by value in the launch's parameters, so it
is packed from the live stacks on every call: a class's stacks move when it
grows or is restored.
"""
from __future__ import annotations

import numpy as np
import torch

GROUP_CAP = 32  # RT_GROUP_CAP: 32 records of 64 B in the 4 KB of parameters

# RtGroup: six base pointers (forest: cdf, table, left, right, cell_first,
# fallback; alias: q, alias), rows B, leaves n, guide cells m (alias: n).
GROUP = np.dtype([("ptr", "<u8", (6,)), ("B", "<i4"), ("n", "<i4"), ("m", "<i4"),
                  ("pad", "<i4")])
assert GROUP.itemsize == 64


def chunks(n_groups: int) -> range:
    """First group of each launch."""
    return range(0, n_groups, GROUP_CAP)


def pack(stacks, dims) -> tuple[np.ndarray, int, int]:
    """The launch's descriptor records for ``stacks`` (sequences of
    tensors) with ``dims`` (B, n, m) each, and the bits of the in-tile sort
    key: ``flat_bits`` hold a flat cell offset ``row * m + cell`` of any of
    the groups, the bits above them the local group; ``end_bit`` is the
    key's width, with the all-ones key left for lanes that do not descend."""
    if not 1 <= len(stacks) <= GROUP_CAP:
        raise ValueError(f"a launch takes 1..{GROUP_CAP} groups, got {len(stacks)}")
    desc = np.zeros(len(stacks), GROUP)
    for i, (stack, (B, n, m)) in enumerate(zip(stacks, dims)):
        desc["ptr"][i, :len(stack)] = [t.data_ptr() for t in stack]
        desc["B"][i], desc["n"][i], desc["m"][i] = B, n, m
    flat_bits = max(int(B * m - 1).bit_length() for B, _n, m in dims)
    end_bit = flat_bits + len(stacks).bit_length()
    if end_bit > 64:
        raise ValueError(f"sort key of {end_bit} bits: the stacks are too large")
    return desc, flat_bits, end_bit


def check_lanes(name: str, device, Q: int, **lanes) -> None:
    """Each named lane array (None where absent): 1-D contiguous int32, or
    float32 where its name starts with ``xi``, ``Q`` long, on ``device``."""
    for lname, t in lanes.items():
        if t is None:
            continue
        dtype = torch.float32 if lname.startswith("xi") else torch.int32
        if t.dim() != 1 or t.shape[0] != Q or t.dtype != dtype:
            raise ValueError(f"{name}: {lname} must be 1-D {dtype} of length {Q}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {lname} is on {t.device}, the stacks on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {lname} must be contiguous")
