"""Shard meshes for the multi-shard layer: the port's jax.sharding.Mesh.

The JAX package shards over a device mesh and lets XLA insert the
collectives around each ``shard_map`` body. Here a shard body is written
once as a function of its shard's tensors, and a mesh says which shards
this process runs and how their results meet:

  - :class:`LocalMesh`: every shard in this process, on one device (the
    card, or the CPU when asked), as slices of one tensor; a gather stacks
    the shards' results and a sum adds them in shard order. It is the
    counterpart of the JAX package's virtual-CPU ``cpu_mesh``, and the way
    one card runs a sharded layout.
  - :class:`DistMesh`: one shard a process of a ``torch.distributed``
    group, whose collectives carry the results: NCCL for tensors on the
    card, gloo for CPU tensors, never one in place of the other.

Either mesh has one or two named axes: the row (or list) axis, and for
query data parallelism a second one. The callers hand every mesh the whole
(global) tensors; a shard takes its slice.
"""
from __future__ import annotations

import math

import torch

from ..utils.device import resolve_device

DATA_AXIS = "data"  # rows / inverted lists sharded over this axis


def _device(device) -> torch.device:
    """resolve_device, with the card's index made explicit (cuda:N), so a
    mesh's device equals its tensors'."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _axes(shape, axes) -> tuple[tuple, tuple]:
    shape = (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(shape) != len(axes) or len(shape) not in (1, 2) \
            or len(set(axes)) != len(axes) or min(shape) < 1:
        raise ValueError(f"a mesh takes 1 or 2 named axes of size >= 1, got "
                         f"shape {shape}, axes {axes}")
    return shape, axes


class _Mesh:
    """What both meshes share: named axes, slices and the shard order."""

    axes: tuple
    shape: dict
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def shard_slices(self, n: int, axis: str) -> list:
        """The slice of n rows (or lists, or queries) that each shard of
        ``axis`` holds, in shard order; n must divide by the axis size."""
        s = self.shape[axis]
        if n % s:
            raise ValueError(f"{n} does not divide over the {s} shards of "
                             f"axis {axis!r}; pad it with masked rows")
        per = n // s
        return [slice(i * per, (i + 1) * per) for i in range(s)]


class LocalMesh(_Mesh):
    """S shards (or an S x Q grid of them) in this process, on one device
    (None: the card; the CPU only when asked). A shard's tensors are views
    of the callers' tensors, so no shard copies the corpus."""

    is_local = True
    rank = 0

    def __init__(self, shape=1, axes=(DATA_AXIS,), device=None):
        shape, axes = _axes(shape, axes)
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        self.device = _device(device)

    def shards(self, axis: str) -> range:
        """The shards of ``axis`` this process runs: all of them."""
        return range(self.shape[axis])

    def all_gather(self, parts: list, axis: str) -> torch.Tensor:
        """Each shard's tensor, in shard order, stacked: [S, ...]."""
        if len(parts) != self.shape[axis]:
            raise ValueError(f"{len(parts)} parts for the "
                             f"{self.shape[axis]} shards of {axis!r}")
        return torch.stack(list(parts))

    def all_reduce_sum(self, parts: list, axis: str) -> torch.Tensor:
        """The shards' tensors summed in shard order."""
        if len(parts) != self.shape[axis]:
            raise ValueError(f"{len(parts)} parts for the "
                             f"{self.shape[axis]} shards of {axis!r}")
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total

    def barrier(self) -> None:
        return None


class DistMesh(_Mesh):
    """One shard a rank of a ``torch.distributed`` process group (None: the
    default group), ranks laid out row-major over ``shape`` (None: one axis
    of the world size). ``device`` None means this rank's card, which takes
    a NCCL group; ``device="cpu"`` takes a gloo group. Any other pairing
    raises."""

    is_local = False

    def __init__(self, group=None, axes=(DATA_AXIS,), shape=None,
                 device=None):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("DistMesh needs an initialised process group")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        world = dist.get_world_size(self.group)
        shape, axes = _axes(world if shape is None else shape, axes)
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} does not fit the group's "
                             f"{world} ranks")
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        backend = str(dist.get_backend(self.group)).lower()
        self.device = _device(device)
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend != want:
            raise RuntimeError(
                f"a DistMesh on {self.device.type} takes a {want} group, "
                f"this one is {backend}")
        self.rank = dist.get_rank(self.group)
        ranks = [dist.get_global_rank(self.group, r) if self.group
                 is not dist.group.WORLD else r for r in range(world)]
        # this rank's coordinates, and for each axis the group of the ranks
        # that share the other coordinates (every rank creates every group,
        # in the same order)
        coords = []
        rem = self.rank
        for s in reversed(shape):
            coords.append(rem % s)
            rem //= s
        self.coords = dict(zip(axes, reversed(coords)))
        self._groups = {}
        if len(axes) == 1:
            self._groups[axes[0]] = self.group
        else:
            a, b = shape
            for i, axis in enumerate(axes):
                for other in range(b if i == 0 else a):
                    members = [ranks[r * b + other] if i == 0
                               else ranks[other * b + r]
                               for r in range(shape[i])]
                    g = dist.new_group(members, backend=backend)
                    if ranks[self.rank] in members:
                        self._groups[axis] = g

    def shards(self, axis: str) -> list:
        """The shard of ``axis`` this rank runs."""
        return [self.coords[axis]]

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise RuntimeError(f"a DistMesh on {self.device} got a tensor on "
                               f"{t.device}")

    def all_gather(self, parts: list, axis: str) -> torch.Tensor:
        """Every rank's shard of ``axis``, in shard order: [S, ...]."""
        (t,) = parts
        self._check(t)
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.shape[axis])]
        self._dist.all_gather(out, t, group=self._groups[axis])
        return torch.stack(out)

    def all_reduce_sum(self, parts: list, axis: str) -> torch.Tensor:
        """The ranks' shards of ``axis`` summed."""
        (t,) = parts
        self._check(t)
        total = t.clone()
        self._dist.all_reduce(total, group=self._groups[axis])
        return total

    def barrier(self) -> None:
        self._dist.barrier(group=self.group)


def cpu_mesh(n_devices: int, axis: str = DATA_AXIS) -> LocalMesh:
    """n shards on the CPU (tests / dry runs), the JAX package's virtual
    CPU mesh."""
    return LocalMesh(n_devices, (axis,), device="cpu")


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
              device=None):
    """Inside an initialised process group, a :class:`DistMesh` over it
    (``n_devices`` None or the world size); otherwise a
    :class:`LocalMesh` of ``n_devices`` (None: 1) shards on ``device``
    (None: the card). Unlike the JAX package's make_mesh it never falls
    back to the CPU: without a card and without ``device="cpu"`` it
    raises."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        mesh = DistMesh(axes=(axis,), device=device)
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"make_mesh({n_devices}) inside a group of "
                             f"{mesh.size} ranks")
        return mesh
    return LocalMesh(n_devices or 1, (axis,), device=device)
