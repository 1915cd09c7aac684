"""Legacy binary VTK STRUCTURED_POINTS I/O, byte-compatible with the
reference's outputs so every downstream tool keeps working.

Format contract (reference: lbm.hpp:307-356 write_vtk, setup.cpp:2513-2683
write_avg_vtk):
  * ASCII header: `# vtk DataFile Version 3.0` / title / BINARY /
    DATASET STRUCTURED_POINTS / DIMENSIONS Nx Ny Nz / ORIGIN / SPACING /
    POINT_DATA N, then one or more fields each as
    `SCALARS <name> <type> <ncomp>` + `LOOKUP_TABLE default`.
    (Vector fields use SCALARS with 3 components, NOT the VECTORS keyword.)
  * Data: big-endian, x-fastest point order (n = x + Nx*(y + Ny*z)),
    components interleaved (AoS).
  * ORIGIN = spacing*(0.5 - N/2) per axis (+ SI origin shift).

Arrays here are numpy [z, y, x] (+ leading component axis for vectors);
`ravel()` on [z,y,x] is exactly the required x-fastest order.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_VTK_TYPES = {
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
    np.dtype(np.uint8): "unsigned_char",
    np.dtype(np.int8): "char",
    np.dtype(np.int32): "int",
    np.dtype(np.uint32): "unsigned_int",
}
_NP_TYPES = {v: k for k, v in _VTK_TYPES.items()}


def _field_block(name: str, arr: np.ndarray) -> bytes:
    """arr: (Z,Y,X) or (C,Z,Y,X) -> header + big-endian AoS payload."""
    if arr.ndim == 3:
        comp, data = 1, arr.reshape(1, -1)
    elif arr.ndim == 4:
        comp = arr.shape[0]
        data = arr.reshape(comp, -1)
    else:
        raise ValueError(f"field {name}: expected 3-D or 4-D array, got {arr.shape}")
    dt = np.dtype(arr.dtype)
    if dt not in _VTK_TYPES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    header = f"SCALARS {name} {_VTK_TYPES[dt]} {comp}\nLOOKUP_TABLE default\n".encode()
    aos = np.ascontiguousarray(data.T)           # (N, comp) interleaved
    be = aos.astype(dt.newbyteorder(">"), copy=False)
    return header + be.tobytes()


def write_structured_points(
    path: Path | str,
    fields: Dict[str, np.ndarray],
    *,
    spacing: float | Sequence[float] = 1.0,   # scalar or (sx, sy, sz)
    origin: Optional[Sequence[float]] = None,
    origin_shift: Sequence[float] = (0.0, 0.0, 0.0),
    nz_write: int = 0,
    title: Optional[str] = None,
) -> Path:
    """Write one or more fields on a common (Z, Y, X) grid.

    `nz_write` crops the top rows (the solver excludes sponge extension rows
    from outputs).  Default origin matches the reference cell-center box:
    spacing*(0.5 - N/2) + origin_shift.
    """
    path = Path(path)
    first = next(iter(fields.values()))
    Z, Y, X = first.shape[-3:]
    nz_out = nz_write if 0 < nz_write < Z else Z
    sp = np.broadcast_to(np.asarray(spacing, np.float64), (3,))  # x, y, z
    ox, oy, oz = (
        origin
        if origin is not None
        else (
            sp[0] * (0.5 - 0.5 * X) + origin_shift[0],
            sp[1] * (0.5 - 0.5 * Y) + origin_shift[1],
            sp[2] * (0.5 - 0.5 * Z) + origin_shift[2],
        )
    )
    points = X * Y * nz_out
    name = title if title is not None else f"FluidX3D {path.name}"
    header = (
        f"# vtk DataFile Version 3.0\n{name}\nBINARY\nDATASET STRUCTURED_POINTS\n"
        f"DIMENSIONS {X} {Y} {nz_out}\n"
        f"ORIGIN {ox:.6f} {oy:.6f} {oz:.6f}\n"
        f"SPACING {sp[0]:.6f} {sp[1]:.6f} {sp[2]:.6f}\n"
        f"POINT_DATA {points}\n"
    ).encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(header)
        for fname, arr in fields.items():
            arr = np.asarray(arr)
            cropped = arr[..., :nz_out, :, :]
            fh.write(_field_block(fname, cropped))
    return path


def read_structured_points(path: Path | str):
    """Parse a legacy binary STRUCTURED_POINTS file written by this module or
    the reference solver.  Returns (meta, {name: array[(C,)Z,Y,X]}).

    Equivalent of the post-tool reader (reference: vtk2nc_new.py:276).
    """
    raw = Path(path).read_bytes()
    # header lines are ASCII; scan until POINT_DATA
    pos = 0
    meta = {}
    fields: Dict[str, np.ndarray] = {}

    def next_line(p):
        nl = raw.index(b"\n", p)
        return raw[p:nl].decode("ascii", errors="replace"), nl + 1

    line, pos = next_line(pos)          # version
    meta["version"] = line
    meta["title"], pos = next_line(pos)
    fmt, pos = next_line(pos)
    if fmt.strip() != "BINARY":
        raise ValueError(f"{path}: expected BINARY, got {fmt!r}")
    ds, pos = next_line(pos)
    if "STRUCTURED_POINTS" not in ds:
        raise ValueError(f"{path}: not STRUCTURED_POINTS")
    dims = npts = None
    spacing = origin = None
    while True:
        line, pos = next_line(pos)
        tok = line.split()
        if not tok:
            continue
        key = tok[0].upper()
        if key == "DIMENSIONS":
            dims = tuple(int(v) for v in tok[1:4])
        elif key == "ORIGIN":
            origin = tuple(float(v) for v in tok[1:4])
        elif key == "SPACING":
            spacing = tuple(float(v) for v in tok[1:4])
        elif key == "POINT_DATA":
            npts = int(tok[1])
            break
    assert dims is not None and npts is not None
    X, Y, Z = dims
    meta.update(dims=dims, origin=origin, spacing=spacing, points=npts)

    while pos < len(raw):
        # skip blank bytes between sections
        while pos < len(raw) and raw[pos : pos + 1] in (b"\n", b"\r", b" "):
            pos += 1
        if pos >= len(raw):
            break
        line, pos = next_line(pos)
        tok = line.split()
        if not tok or tok[0].upper() != "SCALARS":
            break
        name = tok[1]
        dtype = _NP_TYPES[tok[2]]
        comp = int(tok[3]) if len(tok) > 3 else 1
        lut, pos = next_line(pos)  # LOOKUP_TABLE default
        nbytes = npts * comp * dtype.itemsize
        data = np.frombuffer(raw, dtype=dtype.newbyteorder(">"), count=npts * comp,
                             offset=pos)
        pos += nbytes
        arr = data.astype(dtype).reshape(Z, Y, X, comp)
        if comp == 1:
            fields[name] = arr[..., 0]
        else:
            fields[name] = np.moveaxis(arr, -1, 0)
    return meta, fields
