"""Device meshes of the port (functions, not constants: importing this
module touches no process group)."""
from __future__ import annotations

from repro_torch.device import resolve


def make_host_mesh(n: int = 1, model: int = 1, device="cuda"):
    """A ``(n // model, model)`` ``DeviceMesh`` with dims ``("data",
    "model")`` over the default process group, which must be initialized
    with world size ``n`` (``nccl`` for the card, ``gloo`` with
    ``device="cpu"``). The JAX package's ``make_production_mesh`` (a TPU
    v5e-256 topology) has no H100 counterpart yet (ROADMAP A6)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(device)
    if n % model:
        raise ValueError(f"{n} devices do not split into model groups of {model}")
    return init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model"))
