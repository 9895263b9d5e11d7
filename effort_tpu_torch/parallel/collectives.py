"""Named-axis collectives over a DeviceMesh: the port's counterparts of the
`jax.lax` collectives that the JAX package's shard_map code calls.

The JAX package runs a mesh of devices inside one program and names an
axis in each collective (`jax.lax.psum(x, "tp")`). The port runs one
process a rank (parallel/multihost.py): a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the JAX package's axis
names, and each function here is one `torch.distributed` call on the
process group of the named axis, `mesh.get_group(axis)`, named after its
JAX counterpart:

  axis_index(mesh, axis)                      jax.lax.axis_index
  psum(x, mesh, axis)   axis a name or tuple  jax.lax.psum
  pmax(x, mesh, axis)                         jax.lax.pmax
  all_gather(x, mesh, axis, tiled=True)       jax.lax.all_gather
  all_to_all(x, mesh, axis, split_axis, concat_axis)
                                              jax.lax.all_to_all
  ppermute(x, mesh, axis, perm)               jax.lax.ppermute

Each returns a new tensor and leaves x as it was (JAX values are
immutable; torch's collectives work in place, so the helpers copy first).

Transport: on an NCCL group the tensors stay on the card; a gloo group
moves CUDA tensors through host memory itself (scripts/torch_gloo_probe.py
found that it takes them in every call used here, and that its
point-to-point calls abort the process on a CUDA tensor, which is why
ppermute is an all_to_all). Results come in the group's rank order, which
is the axis order on every mesh made here (their axes run in ascending
rank order).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axis = Union[str, Tuple[str, ...]]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on `axis` (a host int)."""
    return mesh.get_local_rank(axis)


def _groups(mesh, axis: Axis) -> list:
    """The process groups one reduction over `axis` runs on: the axis's
    group; for a tuple naming every axis of a mesh that spans the whole
    world, the world group (one call, as JAX reduces over both axes at
    once); for another tuple, each named axis's group in turn."""
    if isinstance(axis, str):
        return [mesh.get_group(axis)]
    if set(axis) == set(mesh.mesh_dim_names) \
            and mesh.size() == dist.get_world_size():
        return [dist.group.WORLD]
    return [mesh.get_group(a) for a in axis]


def _reduce(x: torch.Tensor, mesh, axis: Axis, op):
    y = x.clone()
    for g in _groups(mesh, axis):
        dist.all_reduce(y, op=op, group=g)
    return y


def psum(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The sum of x over the ranks of `axis` (a name, or a tuple of
    names)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The elementwise maximum of x over the ranks of `axis`."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axis: str,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's x in axis order: concatenated on axis 0 (tiled) or
    stacked on a new leading axis."""
    g = mesh.get_group(axis)
    n = dist.get_world_size(g)
    xc = x.contiguous()
    out = torch.empty((n * xc.shape[0],) + tuple(xc.shape[1:]),
                      dtype=xc.dtype, device=xc.device)
    dist.all_gather_into_tensor(out, xc, group=g)
    return out if tiled else out.reshape((n,) + tuple(xc.shape))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """x split into n equal chunks along split_axis, chunk i sent to rank
    i; the n chunks received, from rank 0 up, concatenated along
    concat_axis: jax.lax.all_to_all with tiled=True (split_axis shrinks
    n-fold, concat_axis grows n-fold), which is also tiled=False's result
    where split_axis = concat_axis has size n, as ep.py calls it."""
    g = mesh.get_group(axis)
    n = dist.get_world_size(g)
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    parts = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=g)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """x sent from rank src to rank dst for each (src, dst) in perm (axis
    coordinates); a rank that no pair sends to gets zeros. One
    all_to_all_single with at most one non-empty slot each way."""
    g = mesh.get_group(axis)
    n = dist.get_world_size(g)
    my = axis_index(mesh, axis)
    dst = [d for s, d in perm if s == my]
    src = [s for s, d in perm if d == my]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    flat = x.contiguous().reshape(-1)
    k = flat.numel()
    ins, outs = [0] * n, [0] * n
    if dst:
        ins[dst[0]] = k
    if src:
        outs[src[0]] = k
    got = torch.zeros(k if src else 0, dtype=flat.dtype, device=flat.device)
    dist.all_to_all_single(got, flat if dst else flat[:0],
                           output_split_sizes=outs, input_split_sizes=ins,
                           group=g)
    return got.reshape(x.shape) if src else torch.zeros_like(x)
