"""Device meshes of the port (functions, not constants: importing this
module touches no process group)."""
from __future__ import annotations

import math

from repro_torch.device import resolve

# The production cluster: DGX H100 nodes of 8 GPUs, NVLink (NVSwitch) all to
# all inside a node, one 400 Gb/s NDR InfiniBand port a GPU between nodes.
GPUS_PER_NODE = 8
PRODUCTION_SHAPES = {False: (32, GPUS_PER_NODE), True: (2, 32, GPUS_PER_NODE)}


def _axes(ndim: int) -> tuple[str, ...]:
    return ("pod", "data", "model") if ndim == 3 else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device="cuda", mesh_shape=None):
    """The H100 production mesh over the default process group.

    Single pod: ``(data=32, model=8)`` = 256 GPUs, 32 DGX H100 nodes.
    Multi-pod: ``(pod=2, data=32, model=8)`` = 512 GPUs. The ``model`` axis
    spans one node's NVLink domain of 8 GPUs (450 GB/s a direction a GPU,
    NVIDIA H100 datasheet); ``data`` and ``pod`` cross nodes over
    InfiniBand (one 400 Gb/s NDR port, 50 GB/s, a GPU: the DGX H100
    topology). The GPU counts equal the JAX package's 256 and 512 TPU v5e
    chips, so the two packages' dry-run records line up cell by cell.

    The default process group must have the mesh's world size: ``nccl`` on
    a real cluster, the ``fake`` backend in a dry run (``launch.dryrun``),
    which needs no card: a fake group's mesh only names ``device``'s type.
    ``mesh_shape`` replaces the dims (2 dims ``("data", "model")``, 3 dims
    with ``"pod"`` first), so a test builds the same cell at ``(4, 2)``.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(mesh_shape) if mesh_shape is not None else PRODUCTION_SHAPES[multi_pod]
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh shape {shape}: 2 dims (data, model) or 3 (pod, data, model)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs a world of {math.prod(shape)} ranks, not {world}")
    kind = torch.device(device).type if dist.get_backend() == "fake" else resolve(device).type
    return DeviceMesh(kind, torch.arange(world).view(shape), mesh_dim_names=_axes(len(shape)))


def make_host_mesh(n: int = 1, model: int = 1, device="cuda"):
    """A ``(n // model, model)`` ``DeviceMesh`` with dims ``("data",
    "model")`` over the default process group, which must be initialized
    with world size ``n`` (``nccl`` for the card, ``gloo`` with
    ``device="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(device)
    if n % model:
        raise ValueError(f"{n} devices do not split into model groups of {model}")
    return init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model"))
