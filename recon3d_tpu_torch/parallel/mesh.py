"""Shard meshes and the collectives of the multi-device programs (twin of
recon3d_tpu/parallel/mesh.py).

JAX runs a multi-device program as one SPMD body under shard_map, with
lax.ppermute / psum between the devices of a `jax.sharding.Mesh`. Here a
consumer (parallel/batch.py, depth/sgm_sharded.py) is written once as a
program over the shards that this process holds, `mesh.local`: per-shard
values are {shard: tensor} dicts, and the collectives below move them
between shards. A mesh has one of two transports:

- in-process (``group=None``): all n shards live in this process, on one
  device (the counterpart of the JAX tests' 8 virtual CPU devices, and how
  a one-card machine runs a sharded program). A collective hands the
  shards' device tensors to each other; nothing goes through the host.
- a ``torch.distributed`` process group, one rank a shard: shard k is rank
  k of the group and holds one shard. ppermute and the relay hops are P2P
  (`batch_isend_irecv`), psum an `all_reduce`, the gather an `all_gather`.
  NCCL carries CUDA tensors, gloo CPU tensors; the device is the caller's.

A consumer shards one axis ("frame" or "row"). An in-process mesh may
have more axes (`make_mesh(shape=...)`, a `MeshGrid`, as JAX's 2-D
("frame", "row") layouts); a consumer then works on the 1-D view along its
axis (`axis_view`): the shards of that axis, each holding what JAX
replicates over the other axes. A process group's mesh is 1-D.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """n shards along the axis `axis_name`, on `device`. `group` is the
    torch.distributed process group (one rank a shard), or None for the
    in-process transport."""

    n: int
    axis_name: str
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    _mailbox: Dict[Tuple[int, int], torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process holds, in shard order."""
        if self.group is None:
            return tuple(range(self.n))
        return (dist.get_rank(self.group),)

    def _peer(self, shard: int) -> int:
        return dist.get_global_rank(self.group, shard)

    def _p2p(self, ops: List[dist.P2POp]) -> None:
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def ppermute(self, xs: Dict[int, torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> Dict[int, torch.Tensor]:
        """lax.ppermute: for each (src, dst) of perm, shard dst receives
        shard src's tensor. xs holds every local shard's tensor (one shape
        and type on all shards); the result holds the local shards that
        receive (JAX fills the others with zeros)."""
        if self.group is None:
            return {dst: xs[src] for src, dst in perm}
        ops, out = [], {}
        for src, dst in perm:
            if src in xs:
                ops.append(dist.P2POp(dist.isend, xs[src].contiguous(), self._peer(dst),
                                      self.group))
            if dst in xs:
                out[dst] = torch.empty(xs[dst].shape, dtype=xs[dst].dtype, device=self.device)
                ops.append(dist.P2POp(dist.irecv, out[dst], self._peer(src), self.group))
        self._p2p(ops)
        return out

    def send(self, x: torch.Tensor, src: int, dst: int) -> None:
        """One relay hop out of local shard src to shard dst."""
        if self.group is None:
            self._mailbox[(src, dst)] = x
        else:
            self._p2p([dist.P2POp(dist.isend, x.contiguous(), self._peer(dst), self.group)])

    def recv(self, src: int, dst: int, shape: Sequence[int],
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The relay hop from shard src into local shard dst (sent by
        `send`; the in-process transport needs src to have sent first)."""
        if self.group is None:
            return self._mailbox.pop((src, dst))
        buf = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        self._p2p([dist.P2POp(dist.irecv, buf, self._peer(src), self.group)])
        return buf

    def psum(self, xs: Dict[int, torch.Tensor]) -> torch.Tensor:
        """lax.psum: the sum over all shards, on every process (the local
        shards summed in shard order, then across processes)."""
        total = xs[self.local[0]]
        for k in self.local[1:]:
            total = total + xs[k]
        if self.group is not None:
            total = total.clone()
            dist.all_reduce(total, group=self.group)
        return total

    def all_gather(self, xs: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor (one shape on all shards), in shard order, on
        every process."""
        if self.group is None:
            return [xs[k] for k in range(self.n)]
        x = xs[self.local[0]]
        # gloo gathers no bool tensors: move them as bytes
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        out = [torch.empty_like(wire) for _ in range(self.n)]
        dist.all_gather(out, wire, group=self.group)
        return [o.to(torch.bool) for o in out] if x.dtype == torch.bool else out


@dataclass(frozen=True)
class MeshGrid:
    """An in-process mesh of several named axes (shape[i] shards along
    axis_names[i]) on `device`; `axis(name)` is its 1-D view along one."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    @property
    def n(self) -> int:
        """The mesh's size: the product of its shape."""
        return math.prod(self.shape)

    def axis(self, name: str) -> Mesh:
        """The in-process 1-D mesh of the shards along `name`."""
        if name not in self.axis_names:
            raise ValueError(f"the mesh's axes are {self.axis_names}, not {name!r}")
        return Mesh(self.shape[self.axis_names.index(name)], name, self.device)


def axis_view(mesh: Union[Mesh, MeshGrid], axis: str) -> Mesh:
    """The 1-D mesh a consumer sharding `axis` works on: a MeshGrid's view
    along it, or the 1-D mesh itself (which must be along `axis`)."""
    if isinstance(mesh, MeshGrid):
        return mesh.axis(axis)
    if axis != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis!r}")
    return mesh


def make_mesh(n_devices: Optional[int] = None, axis_names: Tuple[str, ...] = ("frame",),
              device="cuda", group: Optional[dist.ProcessGroup] = None,
              shape: Optional[Sequence[int]] = None) -> Union[Mesh, MeshGrid]:
    """A mesh of n_devices shards on `device` (the caller's; the card by
    default). 1-D by default: with a process group each of its ranks holds
    one shard, and n_devices is the group's size; without one, all
    n_devices shards (1 by default) live in this process. Pass shape and as
    many axis_names for an in-process MeshGrid (e.g. (2, 2) over ("frame",
    "row"))."""
    if shape is not None and len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} does not name axes {axis_names}")
    if len(axis_names) != 1:
        if shape is None:
            raise ValueError(f"shape required for multi-axis meshes (without it a mesh is "
                             f"1-D), got axes {axis_names}")
        if group is not None:
            raise ValueError("a process group's mesh is 1-D (one rank a shard along one "
                             "axis); multi-axis meshes are in-process only")
        grid = MeshGrid(tuple(int(s) for s in shape), tuple(axis_names), torch.device(device))
        if min(grid.shape) < 1 or n_devices not in (None, grid.n):
            raise ValueError(f"shape {grid.shape} does not hold {n_devices} shards")
        return grid
    if shape is not None:
        n_devices = shape[0] if n_devices is None else n_devices
        if int(shape[0]) != n_devices:
            raise ValueError(f"shape {tuple(shape)} does not hold {n_devices} shards")
    if group is not None:
        size = dist.get_world_size(group)
        if n_devices not in (None, size):
            raise ValueError(f"a process group of {size} ranks holds {size} shards, "
                             f"not {n_devices}")
        n_devices = size
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(n, axis_names[0], torch.device(device), group)


def frame_sharding(mesh: Union[Mesh, MeshGrid], size: int,
                   axis: str = "frame") -> Dict[int, slice]:
    """The leading-axis range each local shard along `axis` holds of an axis
    of `size` (jax's frame_sharding: the leading axis sharded, the rest
    replicated)."""
    mesh = axis_view(mesh, axis)
    if size % mesh.n:
        raise ValueError(f"{size} frames do not split over {mesh.n} shards")
    per = size // mesh.n
    return {k: slice(k * per, (k + 1) * per) for k in mesh.local}


def shard_frames(mesh: Union[Mesh, MeshGrid], tensors: Sequence[torch.Tensor],
                 axis: str = "frame") -> Dict[int, Tuple[torch.Tensor, ...]]:
    """Each tensor cut along its leading axis (one size for all) over the
    mesh's `axis`: {shard: the local shard's parts, on mesh.device}."""
    sizes = {t.shape[0] for t in tensors}
    if len(sizes) != 1:
        raise ValueError(f"leading axes of different sizes: {sorted(sizes)}")
    return {k: tuple(t[sl].to(mesh.device) for t in tensors)
            for k, sl in frame_sharding(mesh, sizes.pop(), axis).items()}
