"""Process groups of the distributed solver (twin of
``openmg_tpu/parallel/mesh.py``).

One rank a process, one device a rank.  The JAX package partitions grid
axis 0 over the devices of a ``jax.sharding.Mesh`` and moves planes with
``lax.ppermute``; here the mesh is a ``torch.distributed`` group whose
ranks, in order, own the slabs of axis 0, and planes move by point-to-point
sends (:mod:`openmg_tpu_torch.parallel.halo`).

* :func:`initialize_distributed` wraps ``init_process_group``: the address,
  world size and rank come from the arguments or from the environment
  ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``); the backend is NCCL for a rank on its own card and gloo
  on the CPU or where ranks share a card.
* :func:`make_mesh` is the 1D mesh over the first ``n`` ranks (the world
  group when ``n`` is all of them).
* :func:`make_mesh_2d` is the ``(host, chip)`` mesh: rank ``r`` sits at
  ``(r // chips, r % chips)``, host-major, so the partition axis runs over
  both axes in the order the JAX package linearises its axis-name tuple;
  its ``host`` and ``chip`` sub-groups are built for collectives along one
  axis.

The JAX package's relay workarounds (its re-initialisation wording checks)
belong to its own runtime and are not copied.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "initialize_distributed",
    "default_backend",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the solver's mesh.

    ``group``: the process group of the partition axis (None: the world
    group); ``ranks``: its global ranks in partition order; ``index``: this
    rank's place on the axis (-1 outside the mesh); ``shape`` and
    ``axis_names``: the mesh's layout; ``sub_groups``: per axis name, this
    rank's group along that axis (2D meshes only)."""

    group: object
    ranks: tuple
    index: int
    shape: tuple
    axis_names: tuple
    sub_groups: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)


def default_backend(device) -> str:
    """NCCL for a rank on a card of its own, gloo otherwise."""
    device = torch.device(device)
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(
    init_method=None, rank=None, world_size=None, backend=None, device=None,
    **kwargs,
) -> None:
    """Join the process group: one call a process, before any collective.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``, as ``torchrun`` sets them; a lone process without them
    gets a file store in a fresh temporary directory); ``rank`` and
    ``world_size`` to ``RANK`` and ``WORLD_SIZE`` (a lone process: 0 and
    1); ``backend`` to :func:`default_backend` of ``device`` (the CPU when
    None: the caller names a card).  A rank on a card makes it its current
    device.  A second call is a no-op."""
    if dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if backend is None:
        backend = default_backend(device if device is not None else "cpu")
    if init_method is None:
        init_method = "env://"
        if world_size == 1 and "MASTER_ADDR" not in os.environ:
            import tempfile

            init_method = "file://" + os.path.join(tempfile.mkdtemp(), "store")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        **kwargs,
    )


def _group_of(ranks):
    """A group of ``ranks`` (the world group when it is all of them).  Every
    rank of the world must make the same calls (``new_group`` is
    collective)."""
    world = dist.get_world_size()
    if tuple(ranks) == tuple(range(world)):
        return None
    return dist.new_group(list(ranks))


def make_mesh(n_devices=None, axis_name: str = "x") -> Mesh:
    """1D mesh over the first ``n_devices`` ranks (default: all)."""
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} ranks, the world has {world}")
    ranks = tuple(range(n))
    me = dist.get_rank()
    return Mesh(
        group=_group_of(ranks), ranks=ranks,
        index=ranks.index(me) if me in ranks else -1,
        shape=(n,), axis_names=(axis_name,),
    )


def make_mesh_2d(shape, axis_names=("host", "chip")) -> Mesh:
    """``(n_hosts, chips_per_host)`` mesh over the first ``H*C`` ranks,
    host-major: the partition axis is the linear rank, and each rank also
    gets its ``host`` group (the ranks of its host) and ``chip`` group (the
    ranks at its chip index across hosts)."""
    H, C = (int(s) for s in shape)
    n = H * C
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"requested {n} ranks, the world has {world}")
    ranks = tuple(range(n))
    me = dist.get_rank()
    subs = {}
    # every rank takes part in every new_group call, in the same order
    for h in range(H):
        g = dist.new_group([h * C + c for c in range(C)])
        if me in ranks and me // C == h:
            subs[axis_names[0]] = g
    for c in range(C):
        g = dist.new_group([h * C + c for h in range(H)])
        if me in ranks and me % C == c:
            subs[axis_names[1]] = g
    return Mesh(
        group=_group_of(ranks), ranks=ranks,
        index=ranks.index(me) if me in ranks else -1,
        shape=(H, C), axis_names=tuple(axis_names), sub_groups=subs,
    )
