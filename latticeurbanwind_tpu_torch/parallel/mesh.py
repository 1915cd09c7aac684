"""Domain decomposition of the lattice over devices: the deck's n_gpu split.

Counterpart of `latticeurbanwind_tpu/parallel/mesh.py` (`domain_mesh`,
`state_sharding`, `shard_state`).  The reference splits the lattice into
Dx x Dy x Dz subdomains, one per GPU of one host, in one process
(lbm.cpp:1067-1125); the JAX package shards its arrays over a device mesh.
Here every shard is a separate set of tensors held by one process:

  * shard i of a (Dx, Dy, Dz) split has its own box, z0 + [0, Zl), y0 +
    [0, Yl), x0 + [0, Xl), shards numbered in (z, y, x) order as the JAX
    mesh's axes ('z', 'y', 'x').  Each axis is cut as `numpy.array_split`
    cuts it: the sizes differ by at most one and the first shards take the
    extra cells (79 planes over 4 slabs: 20, 20, 20, 19), so any grid
    splits and nothing is padded.  Neighbours along an axis share the other
    two extents, so their ghost rows and halo planes keep their shapes;
  * a split axis y or x gives the shard's arrays one ghost row or lane on
    each side (the JAX package's width 1; its 16-row y ghosts exist only for
    the TPU's y tiling); z carries no ghosts: a slab's z neighbours are the
    halo planes of `parallel/halo.py`;
  * device rule (`domain_mesh`): "cuda" puts shard i on card i, "cuda:k"
    every shard on card k, "cpu" every shard on the CPU.  `run_case` takes
    "cuda" with fewer cards than shards as a single-device run
    (`run/sizing.py::effective_ngpu`), as the JAX package's does.

The multi-host path (`ensure_distributed`) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..lbm.state import LBMState, raw_bits as _bits


@dataclass(frozen=True)
class DomainMesh:
    """A (Dx, Dy, Dz) split of a (Z, Y, X) grid and each shard's device."""

    split: Tuple[int, int, int]            # deck order (Dx, Dy, Dz)
    shape: Tuple[int, int, int]            # global (Z, Y, X)
    devices: Tuple[torch.device, ...]      # per shard, (z, y, x) order

    @property
    def counts(self) -> Tuple[int, int, int]:
        """Shards along (z, y, x)."""
        dx, dy, dz = self.split
        return dz, dy, dx

    @property
    def n(self) -> int:
        return len(self.devices)

    def edges(self, axis: int) -> Tuple[int, ...]:
        """The cuts along axis 0 (z), 1 (y) or 2 (x), numpy.array_split's:
        shard k of the axis owns [edges[k], edges[k + 1])."""
        size, count = self.shape[axis], self.counts[axis]
        q, r = divmod(size, count)
        return tuple(k * q + min(k, r) for k in range(count + 1))

    def box(self, i: int) -> Tuple[int, int, int]:
        """(Zl, Yl, Xl): the cells shard i owns along each axis."""
        return tuple(self.edges(a)[c + 1] - self.edges(a)[c]
                     for a, c in enumerate(self.coords(i)))

    @property
    def ghosts(self) -> Tuple[int, int]:
        """(gy, gx): one ghost row / lane on each side of a split axis."""
        _, ny, nx = self.counts
        return int(ny > 1), int(nx > 1)

    def local_shape(self, i: int) -> Tuple[int, int, int]:
        """Shard i's ghost-extended (Z, Y, X)."""
        (zl, yl, xl), (gy, gx) = self.box(i), self.ghosts
        return zl, yl + 2 * gy, xl + 2 * gx

    def coords(self, i: int) -> Tuple[int, int, int]:
        """(zi, yi, xi) of shard i."""
        _, ny, nx = self.counts
        return i // (ny * nx), (i // nx) % ny, i % nx

    def index(self, zi: int, yi: int, xi: int) -> int:
        nz, ny, nx = self.counts
        return ((zi % nz) * ny + yi % ny) * nx + xi % nx

    def neighbour(self, i: int, axis: int, step: int) -> int:
        """The shard `step` away along axis 0 (z), 1 (y) or 2 (x), wrapping
        at the domain's edge as the single-device kernel does."""
        c = list(self.coords(i))
        c[axis] += step
        return self.index(*c)

    def origin(self, i: int) -> Tuple[int, int, int]:
        """(z0, y0, x0) of shard i's box."""
        return tuple(self.edges(a)[c] for a, c in enumerate(self.coords(i)))

    def ghost_index(self, i: int, axis: int, edge: bool = False) -> torch.Tensor:
        """Global indices along y (axis 1) or x (axis 2) of shard i's
        ghost-extended extent: the periodic neighbours in the ghosts, or with
        `edge` the box's own edge values (the FaceBC targets' padding)."""
        size, b0, bl = self.shape[axis], self.origin(i)[axis], self.box(i)[axis]
        g = self.ghosts[axis - 1]
        idx = torch.arange(b0 - g, b0 + bl + g)
        return idx.clamp(b0, b0 + bl - 1) if edge else idx % size


class ShardedState(NamedTuple):
    """A lattice state split over a mesh: each shard's ghost-extended
    `LBMState` on its device, in the mesh's shard order."""

    mesh: DomainMesh
    shards: Tuple[LBMState, ...]


def domain_mesh(split, shape, device: torch.device | str = "cuda") -> DomainMesh:
    """The mesh of the deck's [Dx, Dy, Dz] split over the (Z, Y, X) grid,
    under the device rule: "cuda" (no index) puts shard i on card i and
    needs Dx*Dy*Dz cards; "cuda:k" puts every shard on card k; "cpu" every
    shard on the CPU.  Any split of a grid with at least one cell per shard
    along each axis: a split that does not divide the grid gives shards of
    sizes one apart (`DomainMesh.edges`)."""
    dx, dy, dz = (int(v) for v in split)
    Z, Y, X = (int(v) for v in shape)
    if min(dx, dy, dz) < 1 or Z < dz or Y < dy or X < dx:
        raise ValueError(f"grid {X}x{Y}x{Z} (X x Y x Z) cannot be split "
                         f"n_gpu=[{dx}, {dy}, {dz}]: a shard needs a cell "
                         "along each axis")
    n = dx * dy * dz
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(f"n_gpu=[{dx}, {dy}, {dz}] on \"cuda\" needs {n} "
                             f"cards, {count} visible")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devices = (dev,) * n
    return DomainMesh(split=(dx, dy, dz), shape=(Z, Y, X), devices=devices)


def shard_tensor(a: torch.Tensor, mesh: DomainMesh, i: int) -> torch.Tensor:
    """Shard i's ghost-extended part of a global (..., Z, Y, X) tensor, on
    its device, its ghosts filled from the periodic neighbours."""
    z0 = mesh.origin(i)[0]
    zl = mesh.box(i)[0]
    src = _bits(a)[..., z0:z0 + zl, :, :]
    iy = mesh.ghost_index(i, 1).to(a.device)
    ix = mesh.ghost_index(i, 2).to(a.device)
    part = src.index_select(-2, iy).index_select(-1, ix)
    return part.to(mesh.devices[i]).view(a.dtype)


def shard_state(state: LBMState, mesh: DomainMesh) -> ShardedState:
    """Split a global state (on the host or one device) into the mesh's
    ghost-extended shards, each on its device."""
    shards = []
    for i in range(mesh.n):
        shards.append(LBMState(*(None if a is None else shard_tensor(a, mesh, i)
                                 for a in state)))
    return ShardedState(mesh=mesh, shards=tuple(shards))


def interior(a: torch.Tensor, mesh: DomainMesh, i: int) -> torch.Tensor:
    """The view of shard i's tensor (..., Z, Y, X) without its ghosts."""
    (_, yl, xl), (gy, gx) = mesh.box(i), mesh.ghosts
    return a[..., gy:gy + yl, gx:gx + xl]


def gather_tensors(parts, mesh: DomainMesh,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """One global (..., Z, Y, X) tensor on `device` from the shards' parts,
    their ghosts stripped."""
    first = parts[0]
    out = torch.empty((*first.shape[:-3], *mesh.shape),
                      dtype=_bits(first).dtype, device=device)
    for i, p in enumerate(parts):
        (z0, y0, x0), (zl, yl, xl) = mesh.origin(i), mesh.box(i)
        out[..., z0:z0 + zl, y0:y0 + yl, x0:x0 + xl].copy_(
            interior(_bits(p), mesh, i))
    return out.view(first.dtype)


def gather_state(sstate: ShardedState,
                 device: torch.device | str = "cpu") -> LBMState:
    """The global state on `device` (the host by default), ghosts stripped."""
    mesh = sstate.mesh
    fields = []
    for k in range(len(LBMState._fields)):
        parts = [s[k] for s in sstate.shards]
        fields.append(None if parts[0] is None
                      else gather_tensors(parts, mesh, device))
    return LBMState(*fields)


def column_reader(mesh: DomainMesh, ys: Sequence[int], xs: Sequence[int]
                  ) -> Callable[[ShardedState], np.ndarray]:
    """A function of a `ShardedState` of `mesh` giving the (3, Z, P) u
    columns at the global (ys[p], xs[p]) on the host: each column read from
    the shards that own it (one per z slab), never from a gathered field;
    one indexed readback per shard that holds a column."""
    gy, gx = mesh.ghosts
    ey, ex, ez = mesh.edges(1), mesh.edges(2), mesh.edges(0)
    # shard column (yi, xi) -> the column numbers it owns
    owners: Dict[Tuple[int, int], list] = {}
    for k, (y, x) in enumerate(zip(ys, xs)):
        yi = int(np.searchsorted(ey, y, side="right")) - 1
        xi = int(np.searchsorted(ex, x, side="right")) - 1
        owners.setdefault((yi, xi), []).append(k)
    plan = []
    for (yi, xi), ks in owners.items():
        for zi in range(mesh.counts[0]):
            i = mesh.index(zi, yi, xi)
            dev = mesh.devices[i]
            ly = torch.tensor([ys[k] - ey[yi] + gy for k in ks], device=dev)
            lx = torch.tensor([xs[k] - ex[xi] + gx for k in ks], device=dev)
            plan.append((i, slice(ez[zi], ez[zi + 1]), ks, ly, lx))

    def read(sstate: ShardedState) -> np.ndarray:
        out = np.empty((3, mesh.shape[0], len(ys)), np.float32)
        for i, zs, ks, ly, lx in plan:
            out[:, zs, ks] = sstate.shards[i].u[:, :, ly, lx].cpu().numpy()
        return out

    return read


def sync(devices) -> None:
    """Wait for every CUDA device among `devices`."""
    for dev in sorted({d for d in devices if d.type == "cuda"},
                      key=lambda d: d.index or 0):
        torch.cuda.synchronize(dev)
