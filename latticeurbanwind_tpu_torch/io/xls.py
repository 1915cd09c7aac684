"""Minimal legacy Excel (.xls) reader: OLE2 compound file + BIFF8 records.

A copy of `latticeurbanwind_tpu/io/xls.py` (standard library only).  The
reference ships its wind-tunnel validation dataset as a BIFF8 workbook
(the AIJ Niigata Case E benchmark, `CaseE(Niigata).xls`: measurement
points, normalized inflow profile, and measured 2 m velocity ratios for 16
wind directions).  This module implements the minimum of the two public
file formats needed to read such data workbooks:

* the OLE2 / Compound File Binary container ([MS-CFB]): sector FAT chains
  and the directory tree, enough to extract the ``Workbook`` stream (plus
  the mini-stream for small streams);
* the BIFF8 record stream ([MS-XLS]): BOF/BOUNDSHEET to split sheets,
  SST/LABELSST for shared strings, NUMBER/RK/MULRK for numeric cells,
  FORMULA cached results, and CONTINUE handling for the SST.

Everything else (formats, styles, charts, formulas themselves) is ignored.
Cells come back as ``{(row, col): value}`` per sheet.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

Cell = Union[float, str, bool, None]

_FREE = 0xFFFFFFFF
_END = 0xFFFFFFFE


class Workbook:
    """Parsed workbook: ordered sheet names and per-sheet cell maps."""

    def __init__(self, sheet_names: List[str],
                 sheets: List[Dict[Tuple[int, int], Cell]]):
        self.sheet_names = sheet_names
        self.sheets = sheets

    def sheet(self, name: str) -> Dict[Tuple[int, int], Cell]:
        """Cells of the sheet with this (case-insensitive, prefix-tolerant)
        name.  Raises KeyError with the available names otherwise."""
        low = name.lower()
        for n, cells in zip(self.sheet_names, self.sheets):
            if n.lower() == low:
                return cells
        for n, cells in zip(self.sheet_names, self.sheets):
            if n.lower().startswith(low):
                return cells
        raise KeyError(f"no sheet {name!r}; have {self.sheet_names}")

    def rows(self, name: str) -> List[List[Cell]]:
        """Sheet as a dense row-major list of lists (None-padded)."""
        cells = self.sheet(name)
        if not cells:
            return []
        nr = max(r for r, _ in cells) + 1
        nc = max(c for _, c in cells) + 1
        out: List[List[Cell]] = [[None] * nc for _ in range(nr)]
        for (r, c), v in cells.items():
            out[r][c] = v
        return out


# ---------------------------------------------------------------------------
# OLE2 container
# ---------------------------------------------------------------------------

def _ole2_stream(data: bytes, stream_name: str) -> bytes:
    if data[:8] != b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1":
        raise ValueError("not an OLE2 compound file (bad magic)")
    sector = 1 << struct.unpack_from("<H", data, 30)[0]

    # sector id -> file offset: (sid + 1) * sector_size per [MS-CFB] — the
    # header occupies one full sector (4096-byte v4 files pad it), so the
    # common 512 + sid*512 shortcut is correct only for v3
    def off(sid: int) -> int:
        return (sid + 1) * sector
    mini_sector = 1 << struct.unpack_from("<H", data, 32)[0]
    num_fat = struct.unpack_from("<I", data, 44)[0]
    dir_start = struct.unpack_from("<I", data, 48)[0]
    mini_cutoff = struct.unpack_from("<I", data, 56)[0]
    minifat_start = struct.unpack_from("<I", data, 60)[0]
    difat_start = struct.unpack_from("<I", data, 68)[0]
    num_difat = struct.unpack_from("<I", data, 72)[0]

    per = sector // 4
    difat = list(struct.unpack_from("<109I", data, 76))
    s = difat_start
    for _ in range(num_difat):
        ents = struct.unpack_from(f"<{per}I", data, off(s))
        difat += ents[:-1]
        s = ents[-1]

    fat: List[int] = []
    for sec in difat[:num_fat]:
        if sec >= _END:
            continue
        fat += struct.unpack_from(f"<{per}I", data, off(sec))

    def read_chain(start: int) -> bytes:
        out, s, seen = [], start, set()
        while s < _END and s < len(fat) and s not in seen:
            seen.add(s)
            out.append(data[off(s): off(s) + sector])
            s = fat[s]
        return b"".join(out)

    dirdata = read_chain(dir_start)
    root_start = None
    target = None
    for i in range(len(dirdata) // 128):
        e = dirdata[i * 128: (i + 1) * 128]
        nlen = struct.unpack_from("<H", e, 64)[0]
        name = e[: max(0, nlen - 2)].decode("utf-16-le", "ignore")
        typ = e[66]
        start = struct.unpack_from("<I", e, 116)[0]
        size = struct.unpack_from("<I", e, 120)[0]
        if typ == 5:
            root_start = start
        elif typ == 2 and name == stream_name:
            target = (start, size)
    if target is None:
        raise KeyError(f"no stream {stream_name!r} in the container")
    start, size = target

    if size >= mini_cutoff:
        return read_chain(start)[:size]

    # small streams live in the root entry's mini-stream, chained by miniFAT
    mini_stream = read_chain(root_start) if root_start is not None else b""
    minifat: List[int] = []
    s = minifat_start
    while s < _END and s < len(fat):
        minifat += struct.unpack_from(f"<{per}I", data, off(s))
        s = fat[s]
    out, s = [], start
    while s < _END and s < len(minifat):
        out.append(mini_stream[s * mini_sector: (s + 1) * mini_sector])
        s = minifat[s]
    return b"".join(out)[:size]


# ---------------------------------------------------------------------------
# BIFF8 records
# ---------------------------------------------------------------------------

def _decode_rk(rk: int) -> float:
    if rk & 2:          # 30-bit signed integer
        val = float(struct.unpack("<i", struct.pack("<I", rk & 0xFFFFFFFC))[0] >> 2)
    else:               # high 30 bits of an IEEE double
        val = struct.unpack("<d", struct.pack("<Q", (rk & 0xFFFFFFFC) << 32))[0]
    return val / 100.0 if rk & 1 else val


def _records(stream: bytes):
    """Yield (record_id, body) with CONTINUE (0x003C) bodies attached as a
    list so multi-record payloads (the SST) can be reassembled."""
    pos, n = 0, len(stream)
    pending = None      # (rec, [bodies])
    while pos + 4 <= n:
        rec, ln = struct.unpack_from("<HH", stream, pos)
        body = stream[pos + 4: pos + 4 + ln]
        pos += 4 + ln
        if rec == 0x003C and pending is not None:
            pending[1].append(body)
            continue
        if pending is not None:
            yield pending[0], pending[1]
            pending = None
        pending = (rec, [body])
    if pending is not None:
        yield pending[0], pending[1]


def _parse_sst(bodies: List[bytes]) -> List[str]:
    """Shared-string table; strings may restart (with a fresh flags byte)
    at CONTINUE boundaries."""
    out: List[str] = []
    nuniq = struct.unpack_from("<I", bodies[0], 4)[0]
    bi, p = 0, 8
    while len(out) < nuniq and bi < len(bodies):
        body = bodies[bi]
        if p >= len(body):
            bi += 1
            p = 0
            continue
        if p + 3 > len(body):
            bi += 1
            p = 0
            continue
        cch, flags = struct.unpack_from("<HB", body, p)
        p += 3
        wide = flags & 1
        rich = flags & 8
        ext = flags & 4
        crun = cbext = 0
        if rich:
            crun = struct.unpack_from("<H", body, p)[0]
            p += 2
        if ext:
            cbext = struct.unpack_from("<I", body, p)[0]
            p += 4
        chars: List[str] = []
        remaining = cch
        while remaining:
            if p >= len(body):
                bi += 1
                body = bodies[bi]
                wide = body[0] & 1      # continuation re-states the encoding
                p = 1
            avail = (len(body) - p) // (2 if wide else 1)
            take = min(remaining, avail)
            seg = body[p: p + take * (2 if wide else 1)]
            chars.append(seg.decode("utf-16-le" if wide else "latin-1", "ignore"))
            p += take * (2 if wide else 1)
            remaining -= take
        out.append("".join(chars))
        skip = crun * 4 + cbext
        while skip:
            if p >= len(body):
                bi += 1
                body = bodies[bi]
                p = 0
            step = min(skip, len(body) - p)
            p += step
            skip -= step
    return out


def load_xls(path: Union[str, Path]) -> Workbook:
    """Read a BIFF8 .xls workbook into sheet-name + cell-map form."""
    data = Path(path).read_bytes()
    stream = None
    for name in ("Workbook", "Book"):
        try:
            stream = _ole2_stream(data, name)
            break
        except KeyError:
            continue
    if stream is None:
        raise ValueError(f"{path}: no Workbook/Book stream")

    # pass 1 — the workbook-globals substream: sheet directory + SST.
    # BOUNDSHEET's first field is the absolute stream offset of that sheet's
    # BOF, which is the reliable way to pair names with cell substreams
    # (chart/macro substreams interleave freely).
    sst: List[str] = []
    names: List[str] = []
    offsets: List[int] = []
    for rec, bodies in _records(stream):
        body = bodies[0]
        if rec == 0x0085:                        # BOUNDSHEET
            offsets.append(struct.unpack_from("<I", body, 0)[0])
            nl = body[6]
            opts = body[7]
            raw = body[8: 8 + nl * (2 if opts & 1 else 1)]
            names.append(raw.decode("utf-16-le" if opts & 1 else "latin-1",
                                    "ignore"))
        elif rec == 0x00FC:                      # SST (+ CONTINUEs)
            sst = _parse_sst(bodies)

    # pass 2 — each sheet substream from its recorded offset to its EOF
    sheets: List[Dict[Tuple[int, int], Cell]] = []
    for off in offsets:
        cells: Dict[Tuple[int, int], Cell] = {}
        for rec, bodies in _records(stream[off:]):
            body = bodies[0]
            if rec == 0x000A:                    # EOF of this substream
                break
            if rec == 0x0203:                    # NUMBER
                r, c = struct.unpack_from("<HH", body, 0)
                cells[(r, c)] = struct.unpack_from("<d", body, 6)[0]
            elif rec == 0x027E:                  # RK
                r, c = struct.unpack_from("<HH", body, 0)
                cells[(r, c)] = _decode_rk(
                    struct.unpack_from("<I", body, 6)[0])
            elif rec == 0x00BD:                  # MULRK
                r, c0 = struct.unpack_from("<HH", body, 0)
                for i in range((len(body) - 6) // 6):
                    rk = struct.unpack_from("<I", body, 4 + 6 * i + 2)[0]
                    cells[(r, c0 + i)] = _decode_rk(rk)
            elif rec == 0x00FD:                  # LABELSST
                r, c, _, isst = struct.unpack_from("<HHHI", body, 0)
                if isst < len(sst):
                    cells[(r, c)] = sst[isst]
            elif rec == 0x0006:                  # FORMULA cached result
                r, c = struct.unpack_from("<HH", body, 0)
                res = body[6:14]
                if res[6:8] != b"\xff\xff":      # a plain IEEE double
                    cells[(r, c)] = struct.unpack("<d", res)[0]
                elif res[0] == 1:                # cached boolean ([MS-XLS]
                    cells[(r, c)] = bool(res[2])  # Bes: 0x01=bool, 0x02=error
                # 0x00 string (value in a following STRING record, ignored)
                # and 0x02 error results are skipped
        sheets.append(cells)
    return Workbook(names, sheets)
