"""Raster figures without matplotlib: the port's one drawing helper for the
post-processing tools.

The JAX package's tools (`visluw`, `luwcutvis`, `luwseason`, `luwspectra`,
`luwtkeviz`, `luwaij`, `luwvideo`, `visdem`) draw with matplotlib, which
the card's machine does not have.  Here a figure is an (H, W, 3) float
image of a grid of panels; each panel has linear or log axes and takes
colour-mapped images (the colour scales of `run/fieldvis.py`), polylines,
markers and arrows (`run/render.py::draw_segments`).  There is no text:
the figure's and the panels' titles go into the PNG's `tEXt` chunk
(`io/png.py`), and there are no colour bars.

    fig = Figure(3, 3, panel_size(nx, ny), title="case")
    p = fig.panels[0]
    p.image(speed, scale="rainbow")          # row 0 at the bottom
    p.arrows(x, y, u, v)
    p.title = "50 m"
    fig.save("out.png")
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..run.fieldvis import colorscale_iron, colorscale_rainbow
from ..run.render import draw_segments
from .png import encode_png, write_png

MARGIN = 6                                   # pixels around each panel
BACKGROUND = (1.0, 1.0, 1.0)
FRAME = (0.35, 0.35, 0.35)
NAN_RGB = (0.85, 0.85, 0.85)


def _gray(x: np.ndarray) -> np.ndarray:
    return np.repeat(np.clip(np.asarray(x, np.float32), 0.0, 1.0)[..., None],
                     3, axis=-1)


COLOR_SCALES = {"rainbow": colorscale_rainbow, "iron": colorscale_iron,
                "gray": _gray}


def panel_size(nx: int, ny: int, longest: int = 320) -> Tuple[int, int]:
    """(width, height) in pixels of a panel showing an nx x ny grid with
    square cells, its longer side `longest` pixels."""
    s = longest / max(nx, ny, 1)
    return max(8, int(round(nx * s))), max(8, int(round(ny * s)))


def color_limits(values: np.ndarray, vmin=None, vmax=None) -> Tuple[float, float]:
    """(vmin, vmax): the finite values' range where not given."""
    finite = np.asarray(values)[np.isfinite(values)]
    lo = float(finite.min()) if vmin is None and finite.size else vmin
    hi = float(finite.max()) if vmax is None and finite.size else vmax
    lo = 0.0 if lo is None else float(lo)
    hi = lo + 1.0 if hi is None or hi <= lo else float(hi)
    return lo, hi


class Panel:
    """One plot area of a Figure: a view into its image with axis limits
    (data -> pixel, y up)."""

    def __init__(self, img: np.ndarray):
        self.img = img
        self.title = ""
        self.xlim: Tuple[float, float] = (0.0, 1.0)
        self.ylim: Tuple[float, float] = (0.0, 1.0)
        self.xlog = self.ylog = False
        self.used = False

    @property
    def shape(self) -> Tuple[int, int]:
        return self.img.shape[:2]

    def limits(self, xlim, ylim, *, xlog: bool = False,
               ylog: bool = False) -> "Panel":
        """Set the axes; a log axis takes log10 of its (positive) limits."""
        self.xlog, self.ylog = xlog, ylog
        self.xlim = tuple(float(v) for v in xlim)
        self.ylim = tuple(float(v) for v in ylim)
        return self

    def _axis(self, v, lim, log):
        v = np.asarray(v, np.float64)
        if log:
            v = np.log10(np.maximum(v, 1e-300))
            lim = tuple(np.log10(max(x, 1e-300)) for x in lim)
        span = lim[1] - lim[0]
        return (v - lim[0]) / (span if span != 0 else 1.0)

    def to_pixels(self, x, y) -> np.ndarray:
        """(M, 2) pixel positions (column, row) of data points."""
        h, w = self.shape
        fx = self._axis(x, self.xlim, self.xlog)
        fy = self._axis(y, self.ylim, self.ylog)
        return np.stack([fx * (w - 1), (1.0 - fy) * (h - 1)], axis=-1).reshape(-1, 2)

    def image(self, values: np.ndarray, *, scale: str = "rainbow",
              vmin: Optional[float] = None, vmax: Optional[float] = None,
              extent: Optional[Sequence[float]] = None) -> "Panel":
        """Colour-map a (ny, nx) array (row 0 at the bottom, as imshow's
        origin="lower") over `extent` (x0, x1, y0, y1; default the index
        range, which also becomes the axes' limits); NaN shows grey.  An
        (ny, nx, 3) array is drawn as its own RGB in [0, 1]."""
        values = np.asarray(values, np.float64)
        ny, nx = values.shape[:2]
        if extent is None:
            extent = (0.0, float(nx), 0.0, float(ny))
        x0, x1, y0, y1 = (float(v) for v in extent)
        self.limits((x0, x1), (y0, y1))
        self.used = True
        if values.size == 0:
            return self
        if values.ndim == 3:
            rgb = values
        else:
            lo, hi = color_limits(values, vmin, vmax)
            rgb = COLOR_SCALES[scale]((values - lo) / (hi - lo))
            rgb[~np.isfinite(values)] = NAN_RGB
        h, w = self.shape
        cols = np.minimum((np.arange(w) + 0.5) / w * nx, nx - 1).astype(np.int64)
        rows = np.minimum((1.0 - (np.arange(h) + 0.5) / h) * ny, ny - 1).astype(np.int64)
        self.img[:] = rgb[rows[:, None], cols[None, :]]
        return self

    def lines(self, x, y, rgb=(0.0, 0.0, 0.0), *, dashed: bool = False) -> "Panel":
        """A polyline through the points (x, y) in data units."""
        p = self.to_pixels(x, y)
        if len(p) < 2:
            return self
        a, b = p[:-1], p[1:]
        if dashed:
            a, b = a[::2], b[::2]
        ok = np.isfinite(a).all(axis=1) & np.isfinite(b).all(axis=1)
        draw_segments(self.img, a[ok], b[ok],
                      np.broadcast_to(np.asarray(rgb, np.float32), (int(ok.sum()), 3)))
        self.used = True
        return self

    def markers(self, x, y, rgb=(0.0, 0.0, 0.0), *, size: int = 2) -> "Panel":
        """Filled squares of (2 size + 1) pixels at the points; `rgb` one
        colour or one per point."""
        p = self.to_pixels(x, y)
        colors = np.broadcast_to(np.asarray(rgb, np.float32), (len(p), 3))
        ok = np.isfinite(p).all(axis=1)
        h, w = self.shape
        for (c, r), col in zip(np.round(p[ok]).astype(np.int64), colors[ok]):
            r0, r1 = max(r - size, 0), min(r + size + 1, h)
            c0, c1 = max(c - size, 0), min(c + size + 1, w)
            if r0 < r1 and c0 < c1:
                self.img[r0:r1, c0:c1] = col
        self.used = True
        return self

    def bars(self, left, right, height, rgb=(0.27, 0.38, 0.5)) -> "Panel":
        """Filled bars over [left, right] from the lower y limit up to
        `height`, in data units (linear axes)."""
        for x0, x1, top in zip(np.ravel(left), np.ravel(right), np.ravel(height)):
            p = self.to_pixels([x0, x1], [self.ylim[0], top])
            h, w = self.shape
            c0, c1 = sorted(np.clip(np.round(p[:, 0]), 0, w - 1).astype(np.int64))
            r0, r1 = sorted(np.clip(np.round(p[:, 1]), 0, h - 1).astype(np.int64))
            self.img[r0:r1 + 1, c0:c1 + 1] = rgb
        self.used = True
        return self

    def arrows(self, x, y, dx, dy, rgb=(1.0, 1.0, 1.0), *,
               length_px: Optional[float] = None) -> "Panel":
        """Arrows from the points (x, y) along (dx, dy), scaled together so
        the longest is `length_px` pixels (default: the points' spacing)."""
        a = self.to_pixels(x, y)
        d = np.stack([np.asarray(dx, np.float64).ravel(),
                      -np.asarray(dy, np.float64).ravel()], axis=-1)
        mag = np.hypot(d[:, 0], d[:, 1])
        ok = np.isfinite(a).all(axis=1) & np.isfinite(mag)
        if not ok.any() or mag[ok].max() <= 0:
            return self
        if length_px is None:
            h, w = self.shape
            length_px = max(3.0, np.sqrt(h * w / max(int(ok.sum()), 1)))
        d = d * (length_px / mag[ok].max())
        a, d = a[ok], d[ok]
        b = a + d
        # two head strokes at +-150 degrees from the shaft, a third its length
        c, s = np.cos(np.radians(150.0)), np.sin(np.radians(150.0))
        h1 = b + 0.35 * np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1]], -1)
        h2 = b + 0.35 * np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], -1)
        col = np.broadcast_to(np.asarray(rgb, np.float32), (len(a), 3))
        draw_segments(self.img, np.concatenate([a, b, b]),
                      np.concatenate([b, h1, h2]), np.concatenate([col, col, col]))
        self.used = True
        return self


class Figure:
    """rows x cols panels of `panel_wh` (width, height) pixels each."""

    def __init__(self, rows: int, cols: int, panel_wh: Tuple[int, int],
                 title: str = ""):
        pw, ph = (int(v) for v in panel_wh)
        self.title = title
        self.img = np.empty((rows * (ph + 2 * MARGIN), cols * (pw + 2 * MARGIN), 3),
                            np.float32)
        self.img[:] = BACKGROUND
        self.panels = []
        for r in range(rows):
            for c in range(cols):
                top = r * (ph + 2 * MARGIN) + MARGIN
                left = c * (pw + 2 * MARGIN) + MARGIN
                self.img[top - 1:top + ph + 1, left - 1:left + pw + 1] = FRAME
                self.img[top:top + ph, left:left + pw] = BACKGROUND
                self.panels.append(Panel(self.img[top:top + ph, left:left + pw]))

    def text(self) -> str:
        """The figure's title and each drawn panel's title, "; "-joined: what
        the PNG's title chunk holds."""
        titles = [p.title for p in self.panels if p.used and p.title]
        return "; ".join(t for t in [self.title, *titles] if t)

    def save(self, path: Path | str) -> Path:
        """Write the PNG, its title chunk holding `text()`."""
        return write_png(path, self.img, title=self.text())

    def to_png(self) -> bytes:
        """The PNG's bytes, its title chunk holding `text()`."""
        return encode_png(self.img, title=self.text())
