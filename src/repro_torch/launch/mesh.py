"""Production mesh construction over a fake process group.

The production deployment is a 16x16 ("data", "model") grid of 256
devices, or two of them, 2x16x16 ("pod", "data", "model"), 512 devices.
The dry run builds these meshes in one process: :func:`init_fake_world`
starts torch's fake process group (every collective returns at once,
moving nothing) and the meshes are ``DeviceMesh``\\ es of device type
``"cpu"`` over its ranks, whose tensors the dry run keeps on ``meta``.
Both production meshes live in one world of 512 ranks, as the reference
forces 512 host devices for both (``--xla_force_host_platform_device_count``,
the call's counterpart).  Nothing starts at import: a process may import
this module and never start a world.
"""

from __future__ import annotations

import math
from typing import Sequence

#: ranks of the fake world the production meshes share
PRODUCTION_WORLD = 512


def init_fake_world(n: int) -> None:
    """Start a fake process group of ``n`` ranks (this process is rank 0),
    once per process.  A second call with the same ``n`` does nothing; a
    process group of another size already up raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        size = dist.get_world_size()
        if size != n:
            raise RuntimeError(
                f"a process group of {size} ranks is already up; this mesh "
                f"needs {n} (one fake world per process)")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def make_slice_mesh(ranks: Sequence[int], shape: tuple[int, ...],
                    axes: tuple[str, ...] = ("data", "model")):
    """A ``shape`` mesh named ``axes`` over ``ranks`` (row-major), which
    must include rank 0.  With no world up, one of ``max(ranks) + 1``
    ranks is started."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(ranks)
    if math.prod(shape) != len(ranks) or 0 not in ranks:
        raise ValueError(f"mesh {shape} over ranks {ranks[:4]}...: needs "
                         f"{math.prod(shape)} ranks including rank 0")
    if not dist.is_initialized():
        init_fake_world(max(ranks) + 1)
    if max(ranks) >= dist.get_world_size():
        raise ValueError(f"rank {max(ranks)} is outside the world of "
                         f"{dist.get_world_size()}")
    return DeviceMesh("cpu", torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world(PRODUCTION_WORLD)
    return make_slice_mesh(range(math.prod(shape)), shape, axes)
