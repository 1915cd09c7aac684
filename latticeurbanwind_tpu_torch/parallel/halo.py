"""Sharded stepping: the step kernel's halo mode (K8) over a (Dx, Dy, Dz) split.

Counterpart of `latticeurbanwind_tpu/parallel/halo.py::
make_sharded_pallas_runner` (the reference's pack / PCIe / unpack halo
pipeline, lbm.cpp:1864-1958).  Each shard lives on the device of
`parallel/mesh.py`'s rule, in one process or dealt over several (each
process steps the shards it holds), and every step runs, in this order
(JAX `halo.py:326-337`):

  1. the pre-step hook (the VK inlet) refreshes the FaceBC targets of the
     whole domain once in every process, from the same seeded generator,
     and each shard takes its slice of the face arrays, edge-padded over its
     ghosts (JAX `:395-417`), so every target is the single-device run's bit
     for bit and the JAX hook's shard offsets are not needed;
  2. the y / x ghosts are exchanged: x first, then y over the
     x-ghost-extended width, so the corners are right (JAX `:89-111`);
  3. the z halos are taken, after the ghosts, because the diagonal pulls
     of a slab's first and last plane read the halo plane's ghost columns:
     the 5 cz = +1 channels of the last plane of the slab below, the 5
     cz = -1 channels of the first plane of the slab above, and for a
     thermal run one g channel each.  On one device a halo is a view into
     the neighbour's DDF buffer (the kernel takes a channel stride), so no z
     plane is copied; across devices it is copied with `Tensor.copy_`, which
     orders the two devices' streams; across processes ghosts and halos go
     through the mesh's `Transport` (`parallel/comm.py`: one
     `batch_isend_irecv` per stage, NCCL between cards or gloo through the
     host), every process posting the same stages in the same order;
  4. one K8 launch per shard (`ops.stream_collide.stream_collide(...,
     halo=...)`) steps the shard into its spare buffer;
     `stream_collide.launches_halo` counts this process's launches.

At the domain's edges ghosts and halos wrap periodically, as the single-
device kernel does (JAX `_fwd` / `_bwd`).  The kernel is ghost-oblivious: a
ghost cell's output is garbage that the next exchange overwrites before
anything reads it.  Flags are exchanged once (`shard_state` fills their
ghosts; the flag planes of the halos are taken once per runner); nudge
fields are zero-padded per shard, `sponge_z` is sliced at z0, and the VK
site masks are sliced, with only the sites of the faces a shard owns.  The
whole domain's FaceBC is built from the caller's initial u (and T), as the
JAX runner's `init_u` / `init_T`: no process sees the others' shards.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List, Optional

import torch

from ..lbm.fields import update_fields
from ..lbm.state import (
    DynParams, Forcing, StepConfig, ZHalo, dyn_row, raw_bits as _bits,
)
from ..lbm.stepper import spare_buffer
from ..ops.stream_collide import FaceBC, build_face_bc, check_config, stream_collide
from .mesh import DomainMesh, ShardedState, move_between_shards

# VK site kind -> (mesh axis, which end) of the face it sits on
_SITE_FACE = {"lane0": (2, 0), "laneL": (2, -1), "row0": (1, 0),
              "rowL": (1, -1), "plane0": (0, 0), "planeL": (0, -1)}


def exchange_ghosts(bufs: List[Optional[torch.Tensor]], mesh: DomainMesh,
                    stage: str = "f") -> None:
    """Refresh the ghost lanes and rows of every shard's (..., Z, Y, X)
    buffer (None: another process's) from its neighbours' boundary cells,
    in place: x first, then y over the whole (x-ghost-extended) width, so
    corners come from the diagonal neighbour.  Each shard's last own row or
    lane sits one before its upper ghost, whatever its box."""
    gy, gx = mesh.ghosts
    b = [None if t is None else _bits(t) for t in bufs]
    for axis, on in ((2, gx), (1, gy)):
        if not on:
            continue
        end = (slice(None),) * (2 - axis)     # the rows or lanes of the axis

        def cut(i, k, end=end):
            return lambda: b[i][(Ellipsis, k) + end]

        pairs = []
        for i in range(mesh.n):
            lo, hi = mesh.neighbour(i, axis, -1), mesh.neighbour(i, axis, 1)
            pairs.append((lo, i, cut(lo, -2), cut(i, 0)))
            pairs.append((hi, i, cut(hi, 1), cut(i, -1)))
        move_between_shards(mesh, f"{stage}-{axis}", pairs)


class _Halos:
    """The z halos of every shard this process holds: views into the
    neighbours' buffers on one device, copies into buffers kept per shard
    across devices or processes.  The halo below is the lower neighbour's
    own last plane, the one above the upper neighbour's first (z carries no
    ghosts, whatever the slabs' depths); neighbours along z share their y
    and x extents, so a shard's own plane gives a halo's shape."""

    def __init__(self, mesh: DomainMesh, flags: List[Optional[torch.Tensor]]):
        self.mesh = mesh
        self.scratch = {}
        self.flb = self._take("flb", flags, lambda a: a[-1], -1)
        self.fla = self._take("fla", flags, lambda a: a[0], 1)

    def _take(self, key: str, bufs, plane, step: int) -> List[Optional[torch.Tensor]]:
        """Each held shard's halo `plane(buffer)` of its neighbour `step`
        away along z."""
        mesh = self.mesh
        out = [None] * mesh.n
        pairs = []
        for i in range(mesh.n):
            j = mesh.neighbour(i, 0, step)
            if mesh.is_local(i) and mesh.is_local(j):
                src = plane(bufs[j])
                if src.device == mesh.devices[i]:
                    out[i] = src
                    continue
            if mesh.is_local(i):
                like = plane(bufs[i])
                buf = self.scratch.get((i, key))
                if buf is None:
                    buf = self.scratch[(i, key)] = torch.empty(
                        like.shape, dtype=like.dtype, device=mesh.devices[i])
                out[i] = buf
            pairs.append((j, i, lambda j=j: _bits(plane(bufs[j])),
                          lambda i=i: _bits(out[i])))
        move_between_shards(mesh, f"halo-{key}", pairs)
        return out

    def __call__(self, cur, gcur) -> List[Optional[ZHalo]]:
        mesh = self.mesh
        gy, gx = mesh.ghosts
        fp = self._take("fp", cur, lambda a: a[9:14, -1], -1)
        fm = self._take("fm", cur, lambda a: a[14:19, 0], 1)
        gp = gm = [None] * mesh.n
        if gcur is not None:
            gp = self._take("gp", gcur, lambda a: a[5, -1], -1)
            gm = self._take("gm", gcur, lambda a: a[6, 0], 1)
        return [ZHalo(fp=fp[i], fm=fm[i], flb=self.flb[i], fla=self.fla[i],
                      gp=gp[i], gm=gm[i], gy=gy, gx=gx)
                if mesh.is_local(i) else None for i in range(mesh.n)]


def _box(a: torch.Tensor, mesh: DomainMesh, i: int, dims) -> torch.Tensor:
    """Shard i's part of a global tensor whose axis k runs along mesh axis
    dims[k] (0 z, 1 y, 2 x; None: kept whole), zero over the ghosts, on the
    shard's device."""
    box, origin, ghosts = mesh.box(i), mesh.origin(i), (0, *mesh.ghosts)
    shape, src, dst = list(a.shape), [], []
    for k, ax in enumerate(dims):
        if ax is None:
            src.append(slice(None))
            dst.append(slice(None))
            continue
        g, b0, bl = ghosts[ax], origin[ax], box[ax]
        shape[k] = bl + 2 * g
        src.append(slice(b0, b0 + bl))
        dst.append(slice(g, g + bl))
    out = torch.zeros(shape, dtype=a.dtype, device=mesh.devices[i])
    out[tuple(dst)] = a[tuple(src)].to(out.device)
    return out


def _shard_forcing(forcing: Forcing, mesh: DomainMesh, i: int) -> Forcing:
    """Shard i's forcing: the nudge fields zero over the ghosts (no nudging
    there), the sponge profile sliced at the slab's z0."""
    def part(a, dims):
        return None if a is None else _box(a, mesh, i, dims)

    return forcing._replace(
        nudge_sigma=part(forcing.nudge_sigma, (0, 1, 2)),
        nudge_face=part(forcing.nudge_face, (0, 1, 2)),
        sponge_sigma_z=part(forcing.sponge_sigma_z, (0,)))


# the mesh axes of each VK site mask's dimensions
_MASK_DIMS = {"lane0": (0, None, 1), "laneL": (0, None, 1),
              "row0": (0, None, 2), "rowL": (0, None, 2),
              "plane0": (1, 2), "planeL": (1, 2)}


def _shard_sites(spec, mesh: DomainMesh, i: int):
    """Shard i's VK site spec: the sites of the faces it owns, their masks
    cut to its box and zero over its ghosts; None when it owns none."""
    if spec is None:
        return None
    coords, counts = mesh.coords(i), mesh.counts
    sites, masks = [], {}
    for kind, field in spec["sites"]:
        axis, end = _SITE_FACE[kind]
        if coords[axis] != (0 if end == 0 else counts[axis] - 1):
            continue
        sites.append((kind, field))
        masks[field] = _box(spec["masks"][field], mesh, i, _MASK_DIMS[kind])
    return {"sites": tuple(sites), "masks": masks} if sites else None


class _FaceSlicer:
    """Every held shard's FaceBC from the domain's: per face field one
    gather of all these shards' parts at once (the flat indices of each
    one's part, kept from the build, concatenated), each part its box
    edge-padded over the ghosts, as JAX `halo.py:395-417`."""

    def __init__(self, mesh: DomainMesh, home: torch.device):
        Z, Y, X = mesh.shape
        self.mesh = mesh

        def zrows(i, size, axis):          # (Z, 3, R) face layouts
            z0, zl = mesh.origin(i)[0], mesh.box(i)[0]
            z = torch.arange(z0, z0 + zl)
            r = mesh.ghost_index(i, axis, edge=True)
            return (z[:, None, None] * 3 + torch.arange(3)[None, :, None]) \
                * size + r[None, None, :]

        def plane(i, comps):               # (3, Y, X) / (Y, X) layouts
            y = mesh.ghost_index(i, 1, edge=True)
            x = mesh.ghost_index(i, 2, edge=True)
            yx = y[:, None] * X + x[None, :]
            if not comps:
                return yx
            return torch.arange(3)[:, None, None] * (Y * X) + yx[None]

        def flat(fn):
            parts = [fn(i) for i in mesh.local]
            return (torch.cat([p.reshape(-1) for p in parts]).to(home),
                    [p.numel() for p in parts], [tuple(p.shape) for p in parts])

        self.index = {
            "y": flat(lambda i: zrows(i, Y, 1)),
            "x": flat(lambda i: zrows(i, X, 2)),
            "p": flat(lambda i: plane(i, True)),
            "t": flat(lambda i: plane(i, False)),
        }

    def __call__(self, fbc: Optional[FaceBC]) -> List[Optional[FaceBC]]:
        if fbc is None:
            return [None] * self.mesh.n
        which = {"uw": "y", "ue": "y", "us": "x", "un": "x", "ut": "p",
                 "ub": "p", "tt": "t"}
        parts = {}
        for k in FaceBC._fields:
            v = getattr(fbc, k)
            if v is None:
                parts[k] = None
                continue
            idx, sizes, shapes = self.index[which[k]]
            parts[k] = [p.view(s) for p, s in
                        zip(torch.take(v, idx).split(sizes), shapes)]
        out = [None] * self.mesh.n
        for n, i in enumerate(self.mesh.local):
            dev = self.mesh.devices[i]
            out[i] = FaceBC(**{k: None if v is None else v[n].to(dev)
                               for k, v in parts.items()})
        return out


def make_sharded_runner(config: StepConfig, forcing: Forcing,
                        mesh: DomainMesh, *, init_u: torch.Tensor,
                        init_T: Optional[torch.Tensor] = None, pre_step=None):
    """`(run, impl_name)` with `run(sstate, dyn, t0, n_steps=1) ->
    sstate`, the stepper's interface (`lbm/stepper.py::make_runner`) over a
    `ShardedState` of `mesh`: every step is the ordered exchange and one
    K8 launch per shard this process holds, as the module docstring says.
    `forcing` is the whole
    domain's, on the host or any device (each shard takes a copy of its
    part); the hook is the whole domain's, on this process's first device,
    where the FaceBC refresh runs; `impl_name` is
    "cuda-sharded" on CUDA devices (the kernels; a CUDA run never steps a
    plain version) and "plain-sharded" on the CPU.

    Like the stepper, `run` keeps two DDF buffers per shard (and two g
    buffers when thermal), swaps them after every step and returns the
    state holding the newest; the incoming shards' `fi`/`gi` become spares.
    The FaceBC of the whole domain is built from `init_u` (and `init_T`,
    required when thermal), the whole domain's initial fields on the host
    or any device, as the JAX runner's.  It is carried across calls
    (`get_fbc` / `set_fbc`; `reset` goes back to the one built from
    `init_u`).
    `run.stages(sstate, dyn, t0)` hands out one step's stages, the functions
    `run` calls in turn, to time them apart.
    """
    pre_ddf = None
    if pre_step is not None:
        pre_ddf = getattr(pre_step, "ddf", None)
        if pre_ddf is None:
            raise NotImplementedError(
                "a pre-step hook without a pure-DDF variant (.ddf) needs the "
                "JAX package's reference tier, which the port does not carry")
    vk_spec = getattr(pre_ddf, "kernel_spec", None)
    check_config(config, forcing, vk_spec)
    local = mesh.local
    home = mesh.devices[local[0]]
    thermal = config.thermal
    needs_fbc = (forcing.nudge_sigma is not None
                 or forcing.sponge_sigma_z is not None or vk_spec is not None)

    def face_bc(u, T) -> FaceBC:
        return FaceBC(*(None if v is None else v.to(home)
                        for v in build_face_bc(u, T if thermal else None)))

    if thermal and init_T is None:
        raise ValueError("a thermal runner needs the whole domain's init_T")
    fbc0 = face_bc(init_u, init_T) if needs_fbc else None
    forcings = [_shard_forcing(forcing, mesh, i) if mesh.is_local(i) else None
                for i in range(mesh.n)]
    sites = [_shard_sites(vk_spec, mesh, i) if mesh.is_local(i) else None
             for i in range(mesh.n)]
    slicer = _FaceSlicer(mesh, home)
    cell = {}

    def reset():
        cell.update(fbc=fbc0, local=None, local_of=None, spare=[None] * mesh.n,
                    gspare=[None] * mesh.n, halos=None, rows=None, rows_of=None)

    reset()

    def begin(sstate: ShardedState, dyn: DynParams, t0: int) -> SimpleNamespace:
        """A call's set-up: the carried FaceBC, the halos' flag planes
        (static: taken once), one dyn row per device and DynParams, each
        shard's buffers; returns the step context that the stages
        advance."""
        if sstate.mesh != mesh:
            raise ValueError("the state is split over another mesh")
        shards = sstate.shards
        if cell["halos"] is None:
            cell["halos"] = _Halos(mesh, [_field(s, "flags") for s in shards])
        if cell["rows_of"] is not dyn:
            cell["rows"] = {d: dyn_row(dyn, d) for d in set(mesh.local_devices)}
            cell["rows_of"] = dyn
        cur = [_field(s, "fi") for s in shards]
        gcur = [_field(s, "gi") for s in shards] if thermal else None

        def spares(bufs, kept):
            return [None if c is None else spare_buffer(c, k)
                    for c, k in zip(bufs, kept)]

        return SimpleNamespace(
            shards=shards, t=int(t0), fbc=cell["fbc"],
            aux=pre_ddf.init_aux(t0) if hasattr(pre_ddf, "init_aux") else None,
            cur=cur, spare=spares(cur, cell["spare"]), gcur=gcur,
            gspare=spares(gcur, cell["gspare"]) if thermal else [None] * mesh.n,
            zh=None)

    def refresh(ctx: SimpleNamespace) -> None:
        """Stage 1: the hook refreshes the whole domain's FaceBC for step
        ctx.t, then each shard takes its slice."""
        if pre_ddf is not None:
            ctx.fbc, ctx.aux = pre_ddf(ctx.fbc, ctx.t, ctx.aux)
        if cell["local_of"] is not ctx.fbc or cell["local"] is None:
            cell["local"], cell["local_of"] = slicer(ctx.fbc), ctx.fbc
        ctx.t += 1

    def exchange(ctx: SimpleNamespace) -> None:
        """Stages 2 and 3: the y / x ghosts, then the z halos."""
        exchange_ghosts(ctx.cur, mesh)
        if thermal:
            exchange_ghosts(ctx.gcur, mesh, "g")
        ctx.zh = cell["halos"](ctx.cur, ctx.gcur)

    def kernels(ctx: SimpleNamespace) -> None:
        """Stage 4: one K8 launch per shard into its spare buffers."""
        parts = cell["local"]
        for i in local:
            s = ctx.shards[i]
            stream_collide(ctx.cur[i], s.flags, cell["rows"][mesh.devices[i]],
                           config, forcings[i], parts[i], out=ctx.spare[i],
                           vk=sites[i], gi=ctx.gcur[i] if thermal else None,
                           gi_out=ctx.gspare[i], halo=ctx.zh[i])

    stages = (refresh, exchange, kernels)

    def run(sstate: ShardedState, dyn: DynParams, t0: int = 0,
            n_steps: int = 1) -> ShardedState:
        ctx = begin(sstate, dyn, t0)
        for _ in range(int(n_steps)):
            for stage in stages:
                stage(ctx)
            ctx.cur, ctx.spare = ctx.spare, ctx.cur
            if thermal:
                ctx.gcur, ctx.gspare = ctx.gspare, ctx.gcur
        cell.update(fbc=ctx.fbc, spare=ctx.spare, gspare=ctx.gspare)
        return sstate._replace(shards=tuple(
            None if s is None else
            s._replace(fi=ctx.cur[i], gi=ctx.gcur[i] if thermal else s.gi)
            for i, s in enumerate(sstate.shards)))

    def step_stages(sstate: ShardedState, dyn: DynParams,
                    t0: int = 0) -> SimpleNamespace:
        """`run`'s step on `sstate` taken apart, for timing: the stages
        `run` calls, `refresh`, `exchange` and `kernels`, bound to one step
        `context`.  Called once each in that order they make one step from
        its `cur` into its `spare` (and `gcur` into `gspare`), which they do
        not swap; after that each may be called again alone (the refresh
        advances its step, the others repeat on the same buffers).  A later
        `run` call may reuse those buffers."""
        ctx = begin(sstate, dyn, t0)
        # the context does not point back at its stages: no reference cycle
        # keeps its buffers alive once the caller drops them
        return SimpleNamespace(context=ctx, **{
            f.__name__: functools.partial(f, ctx) for f in stages})

    def set_fbc(fbc: Optional[FaceBC]):
        if fbc is not None:
            Z, Y, X = mesh.shape
            want = {"uw": (Z, 3, Y), "ue": (Z, 3, Y), "us": (Z, 3, X),
                    "un": (Z, 3, X), "ut": (3, Y, X), "ub": (3, Y, X)}
            for k, shp in want.items():
                if tuple(getattr(fbc, k).shape) != shp:
                    raise ValueError(f"FaceBC {k} shape {tuple(getattr(fbc, k).shape)}"
                                     f" does not match this mesh's grid (want {shp})")
            if thermal and forcing.sponge_sigma_z is not None and fbc.tt is None:
                raise ValueError("FaceBC has no thermal target 'tt' but this "
                                 "runner is thermal")
        cell.update(fbc=fbc, local=None, local_of=None)

    run.reset = reset
    run.get_fbc = lambda: cell["fbc"]
    run.set_fbc = set_fbc
    run.fields_stale = True
    run.stages = step_stages
    cuda = all(d.type == "cuda" for d in mesh.local_devices)
    return run, ("cuda-sharded" if cuda else "plain-sharded")


def _field(shard, name: str):
    return None if shard is None else getattr(shard, name)


def update_fields_sharded(sstate: ShardedState, config: StepConfig,
                          dyn: Optional[DynParams] = None) -> ShardedState:
    """`lbm.fields.update_fields` on every shard this process holds: its
    ghosts refreshed from the neighbours first (a step leaves them
    garbage), then each slab with its z halos beside it, cropped back; the
    JAX package runs the same pass on the sharded arrays."""
    mesh = sstate.mesh
    shards = sstate.shards
    cur = [_field(s, "fi") for s in shards]
    exchange_ghosts(cur, mesh)
    gcur = None
    if config.thermal:
        gcur = [_field(s, "gi") for s in shards]
        exchange_ghosts(gcur, mesh, "g")
    zh = _Halos(mesh, [_field(s, "flags") for s in shards])(cur, gcur)
    return sstate._replace(shards=tuple(
        None if s is None else update_fields(s, config, dyn, halo=h)
        for s, h in zip(shards, zh)))
