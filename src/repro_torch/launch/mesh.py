"""Production mesh builders (``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (never a module-level constant), so
importing this module touches no process group: each builder calls
``init_device_mesh`` over the default group, which the caller has
initialized (``torchrun``, ``launch/ranks.py``, or the fake group of the
dry-run).

Mesh topology (256 ranks a pod):
  single pod : (data=16, model=16)            — 256 ranks
  two pods   : (pod=2, data=16, model=16)     — 512 ranks; the 'pod' axis
               carries only data parallelism (the batch is split over
               pod x data, pod-major)

``device_type`` is the mesh's device kind: ``"cuda"`` on the cards,
``"cpu"`` for host ranks and for the dry-run's meta tensors.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["make_production_mesh", "make_flat_mesh", "make_mesh"]


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (its size must be the product of ``shape``, as ``jax.make_mesh``
    requires of the devices)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_flat_mesh(n: Optional[int] = None, axis: str = "data", device_type: str = "cuda"):
    """1-axis mesh over the first n ranks (all of them by default)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n or world
    if n == world:
        return make_mesh((n,), (axis,), device_type)
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))
