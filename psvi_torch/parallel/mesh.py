"""The ('trial', 'data', 'mc') mesh over processes, and what each rank takes.

Counterpart of ``psvi_tpu/parallel/mesh.py``. JAX places one program on a
mesh of devices and lets XLA insert the collectives; here there is one
process per device (``torchrun``, or ``distributed.spawn``), the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks with
the dimension names ``("trial", "data", "mc")``, and each axis has its own
process group (a process in no group gets a one-rank mesh that needs none):

- ``trial``: independent trials; each rank runs its slice of them
  (``parallel/trials.py``), and nothing crosses the axis inside a step;
- ``data``: the rows of a minibatch; the data term ``N/|B|·Σ nll`` is a SUM
  all-reduce over the axis;
- ``mc``: the MC samples; the IW softmax over S and every sum over samples
  are all-reduces over the axis.

A sharding helper of the JAX package returns a ``NamedSharding``; its
counterpart here returns a :class:`Sharding`, whose ``take`` gives the
rank's slice of a leading axis. :class:`AxisShard` carries one axis's
group into the objectives (``ops/elbo.py``): a SUM all-reduce that
autograd differentiates (its backward is itself: the adjoint of summing
every rank's copy is summing every rank's cotangent, and it is
differentiable again, so a hypergradient can pass it twice), a MAX that
is not differentiated, and the mean of a gradient over the axis. A
gradient of a loss that holds such a sum is, on each rank, the gradient of
the sum of every rank's copy of the loss; its mean over the axis is the
gradient of the loss (the data-parallel rule), whatever the order of
differentiation.

Every function that builds a mesh or a group must be called by every rank
of the world, in the same order, as ``torch.distributed`` requires.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from psvi_torch.utils.tree import tree_leaves, tree_unflatten

AXES = ("trial", "data", "mc")


class OneRankMesh:
    """The mesh of a process that is in no process group: every axis of size
    1, this rank 0 on each, no group. Nothing issues a collective on an axis
    of size 1, so it needs none, and the process stays free to join a group
    later."""

    mesh_dim_names = AXES

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None


def make_mesh(trial: int = 1, data: int = 1, mc: int = 1, devices=None):
    """A ('trial', 'data', 'mc') ``DeviceMesh`` over the first trial·data·mc
    ranks of ``devices`` (the world's ranks by default). Without an
    initialised process group, a mesh of one rank is a :class:`OneRankMesh`
    (no address, port or environment variable needed)."""
    need = trial * data * mc
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(f"mesh ({trial}x{data}x{mc}) needs {need} devices, have 1")
        return OneRankMesh()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if need > len(ranks):
        raise ValueError(f"mesh ({trial}x{data}x{mc}) needs {need} devices, have {len(ranks)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks[:need]).reshape(trial, data, mc),
                      mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


class Sharding(NamedTuple):
    """A leading axis split over a mesh axis (``axis=None``: replicated)."""

    mesh: Any
    axis: Optional[str]

    def take(self, x):
        """This rank's slice of ``x``'s leading axis (``x`` itself when
        replicated); the axis must divide it."""
        if self.axis is None or x.dim() == 0:
            return x
        n = axis_size(self.mesh, self.axis)
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not divide over the mesh "
                             f"axis {self.axis!r} of size {n}")
        k = x.shape[0] // n
        r = axis_rank(self.mesh, self.axis)
        return x[r * k:(r + 1) * k]


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def batch_sharding(mesh, ndim: int, axis: str = "data") -> Sharding:
    """The leading (batch) dimension of an (B, ...) array over ``axis``."""
    return Sharding(mesh, axis)


def trial_sharding(mesh, ndim: int) -> Sharding:
    return Sharding(mesh, "trial")


def shard_pytree_leading(tree, mesh, axis: str = "trial"):
    """Every leaf's leading axis split over ``axis``: this rank's slices."""
    take = Sharding(mesh, axis).take
    return tree_unflatten(tree, [take(x) for x in tree_leaves(tree)])


class _AllSum(torch.autograd.Function):
    """SUM all-reduce whose backward is itself (and so differentiable)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g, ctx.group), None


class AxisShard:
    """One mesh axis as the objectives see it: its size, this rank's
    coordinate and the collectives over its group."""

    def __init__(self, mesh, axis: str):
        self.axis = axis
        self.size = axis_size(mesh, axis)
        self.rank = axis_rank(mesh, axis)
        self.group = mesh.get_group(axis)

    def take(self, x):
        """This rank's slice of the leading axis (rows or samples)."""
        k = x.shape[0] // self.size
        return x[self.rank * k:(self.rank + 1) * k]

    def sum(self, x):
        """Σ over the axis, differentiable to any order."""
        return _AllSum.apply(x, self.group) if self.size > 1 else x

    def max(self, x):
        """max over the axis, not differentiated."""
        y = x.detach().clone()
        if self.size > 1:
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def mean(self, tree):
        """A tree of gradients averaged over the axis, in one all-reduce."""
        if self.size == 1:
            return tree
        leaves = tree_leaves(tree)
        flat = self.sum(torch.cat([g.reshape(-1) for g in leaves])) / self.size
        out, i = [], 0
        for g in leaves:
            out.append(flat[i:i + g.numel()].reshape(g.shape))
            i += g.numel()
        return tree_unflatten(tree, out)
