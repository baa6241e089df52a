# Frozen copy of the port's plain ``ofps_torch/core/motion.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Motion-field data layer (port of ``ofps_tpu.core.motion``).

``SparseFlow`` is the fixed-capacity sparse motion-vector field: padded
``(..., N, 2)`` positions and motions in [0,1]-normalized screen units plus
an ``(..., N)`` validity mask.  ``Densifier`` scatter-means it into a dense
``(..., H, W, 2)`` field: a grid of at most 1,024 cells (the detector's
14x14) accumulates by one-hot comparison sums in blocks of points, so that
the result does not depend on the order of atomic adds and a CUDA graph
replays it bit for bit; a larger grid uses ``scatter_add``.  Hole filling
(``Densifier.interpolate_empty_cells``) is the JAX package's parallel
relaxation.  The numpy plan helpers are copied verbatim from the JAX
package so both packages compute the same cell partition.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


F32_EPS = float(np.finfo(np.float32).eps)

# 6-neighborhood of the hole filling: (dx, dy) offsets.
_INTERP_NEIGHBORS = ((-1, 0), (0, -1), (-1, -1), (1, 0), (0, 1), (1, 1))
# Grids up to this many cells accumulate by one-hot sums, over blocks of
# this many points (a (..., block, cells, 3) float32 intermediate: 38.5 MB
# at 8 streams and 196 cells).
ONEHOT_MAX_CELLS = 1024
ONEHOT_BLOCK = 2048


class SparseFlow(NamedTuple):
    """``pos``/``motion``: (..., N, 2) float32; ``mask``: (..., N) float32
    validity (1.0 = real entry, 0.0 = padding)."""

    pos: torch.Tensor
    motion: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.pos.shape[-2]

    def count(self) -> torch.Tensor:
        """Valid entries per flow, (...)."""
        return torch.sum(self.mask, dim=-1)

    @classmethod
    def from_arrays(cls, pos, motion, capacity: Optional[int] = None,
                    device="cuda") -> "SparseFlow":
        """Host arrays (n, 2) padded or truncated to ``capacity`` entries
        (default n, at least 1) on ``device``."""
        cap = capacity or max(len(np.asarray(pos).reshape(-1, 2)), 1)
        rows = np.zeros((cap, 5), dtype=np.float32)
        pack_entries(pos, motion, rows)
        t = torch.from_numpy(rows).to(torch.device(device))
        return cls(t[:, 0:2], t[:, 2:4], t[:, 4])


def pack_entries(pos, motion, rows: np.ndarray) -> int:
    """Write host arrays (n, 2) into the zeroed (capacity, 5) float32 rows
    ``rows`` as (pos x, pos y, motion x, motion y, mask = 1), truncated to
    the capacity; returns the entries written."""
    pos = np.asarray(pos, dtype=np.float32).reshape(-1, 2)
    motion = np.asarray(motion, dtype=np.float32).reshape(-1, 2)
    n = min(pos.shape[0], rows.shape[0])
    rows[:n, 0:2] = pos[:n]
    rows[:n, 2:4] = motion[:n]
    rows[:n, 4] = 1.0
    return n


def flow_cell_index(pos: torch.Tensor, width: int, height: int):
    """Grid cell of a [0,1]^2 position: round half up of p * (n - 1)."""
    p = torch.clamp(pos, 0.0, 1.0)
    x = torch.floor(p[..., 0] * (width - 1) + 0.5).to(torch.int64)
    y = torch.floor(p[..., 1] * (height - 1) + 0.5).to(torch.int64)
    return x, y


class Densifier(NamedTuple):
    """Scatter-mean accumulator: ``sums`` (..., H, W, 2) weighted motion
    sums and ``counts`` (..., H, W) weights, initialized at f32 epsilon."""

    sums: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def zeros(cls, width: int, height: int, batch: Tuple[int, ...] = (),
              device="cpu") -> "Densifier":
        return cls(
            torch.zeros(batch + (height, width, 2), dtype=torch.float32, device=device),
            torch.full(batch + (height, width), F32_EPS, dtype=torch.float32, device=device),
        )

    @property
    def shape(self) -> Tuple[int, int]:
        h, w = self.counts.shape[-2:]
        return w, h

    def add_flow(self, flow: SparseFlow, weight: float = 1.0) -> "Densifier":
        """Scatter-add a sparse flow into the accumulator: one-hot sums on
        grids of at most ``ONEHOT_MAX_CELLS`` cells (deterministic, as the
        JAX package's one-hot product there), ``scatter_add`` above."""
        h, w = self.counts.shape[-2:]
        x, y = flow_cell_index(flow.pos, w, h)
        idx = (y * w + x).expand(flow.mask.shape)
        wgt = flow.mask * weight
        lead = self.counts.shape[:-2]
        if h * w <= ONEHOT_MAX_CELLS:
            vals = torch.cat([wgt[..., None], flow.motion * wgt[..., None]], dim=-1)
            acc = _onehot_sum(idx, vals.expand(idx.shape + (3,)), h * w)
            return Densifier(self.sums + acc[..., 1:].reshape(self.sums.shape),
                             self.counts + acc[..., 0].reshape(self.counts.shape))
        counts = self.counts.reshape(lead + (h * w,)).scatter_add(-1, idx, wgt)
        sums = self.sums.reshape(lead + (h * w, 2)).scatter_add(
            -2, idx[..., None].expand(idx.shape + (2,)), flow.motion * wgt[..., None]
        )
        return Densifier(sums.reshape(self.sums.shape), counts.reshape(self.counts.shape))

    def finalize(self) -> torch.Tensor:
        """Weighted mean per cell: the dense (..., H, W, 2) motion field."""
        return self.sums / self.counts[..., None]

    def interpolate_empty_cells(self) -> "Densifier":
        """Fill empty cells from filled neighbours, for an unbatched (H, W)
        accumulator: the JAX package's parallel relaxation of the
        reference's priority-queue fill.  Each round fills, in one of four
        2x2 parity colours in turn, the empty cells tied at the most filled
        6-neighbours, each with the distance-weighted mean of those
        neighbours (sums take ``scale^2 * mean`` against ``scale`` counts).
        The loop reads one flag from the device per round to decide whether
        to go on (hole filling is off the serving path)."""
        h, w = self.counts.shape[-2:]
        dev = self.counts.device
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        color_of = (ys % 2) * 2 + (xs % 2)
        sums, counts, color = self.sums, self.counts, 0
        while True:
            filled = counts > 0.1
            mean = sums / counts[..., None]
            add_sum = torch.zeros_like(sums)
            add_cnt = torch.zeros_like(counts)
            nb_count = torch.zeros_like(counts)
            for dx, dy in _INTERP_NEIGHBORS:
                scale = 1.0 - math.sqrt(dx * dx + dy * dy) * 0.5
                nb_filled = _shift2d(filled.to(sums.dtype), dx, dy)
                nb_mean = _shift2d(mean, dx, dy)
                add_sum = add_sum + (scale * scale) * nb_mean * nb_filled[..., None]
                add_cnt = add_cnt + scale * nb_filled
                nb_count = nb_count + nb_filled
            cand = ~filled & (nb_count > 0.0)
            if not bool(torch.any(~filled) & torch.any(cand)):
                break
            maxc = torch.max(torch.where(cand, nb_count, 0.0))
            gets_fill = cand & (nb_count >= maxc) & (color_of == color)
            sums = torch.where(gets_fill[..., None], sums + add_sum, sums)
            counts = torch.where(gets_fill, counts + add_cnt, counts)
            color = (color + 1) % 4
        return Densifier(sums, counts)


def _onehot_sum(idx: torch.Tensor, vals: torch.Tensor, cells: int) -> torch.Tensor:
    """(..., cells, C) sums of ``vals`` (..., N, C) by cell ``idx`` (..., N):
    one-hot comparison products summed over blocks of ``ONEHOT_BLOCK``
    points, block after block (a fixed order of reductions, no atomics)."""
    ar = torch.arange(cells, device=idx.device)
    out = torch.zeros(idx.shape[:-1] + (cells, vals.shape[-1]), dtype=vals.dtype,
                      device=vals.device)
    for s in range(0, idx.shape[-1], ONEHOT_BLOCK):
        hit = idx[..., s:s + ONEHOT_BLOCK, None] == ar  # (..., block, cells)
        out = out + (hit[..., None] * vals[..., s:s + ONEHOT_BLOCK, None, :]).sum(-3)
    return out


def _shift2d(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx] over the first two dims, zero outside."""
    h, w = a.shape[0], a.shape[1]
    out = torch.zeros_like(a)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


def densify(flow: SparseFlow, width: int, height: int) -> torch.Tensor:
    """Sparse flow (..., N) -> dense (..., H, W, 2) field by scatter-mean."""
    dens = Densifier.zeros(width, height, flow.mask.shape[:-1], flow.mask.device)
    return dens.add_flow(flow).finalize()


def field_to_sparse(field: torch.Tensor) -> SparseFlow:
    """Dense (..., H, W, 2) field -> sparse entries at pos (x/W, y/H)."""
    h, w = field.shape[-3], field.shape[-2]
    dev = field.device
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    lead = field.shape[:-3]
    pos = torch.stack([xs / w, ys / h], dim=-1).reshape(h * w, 2)
    motion = field.reshape(lead + (h * w, 2))
    return SparseFlow(
        pos.expand(lead + (h * w, 2)),
        motion,
        torch.ones(lead + (h * w,), dtype=torch.float32, device=dev),
    )


def grid_size_for(width: int, height: int, max_dim: int = 150) -> Tuple[int, int]:
    """Densified-grid size <= max_dim per side, preserving aspect
    (1920x1080 -> (150, 84)); never exceeds the source dimensions."""
    if width >= height:
        gw = min(max_dim, width)
        gh = max(1, min(height, round(height * gw / width)))
    else:
        gh = min(max_dim, height)
        gw = max(1, min(width, round(width * gh / height)))
    return gw, gh


def _axis_scatter_matrix_np(n: int, g: int):
    import numpy as np

    p = (np.arange(n) + 0.5) / n
    cell = np.floor(p * (g - 1) + 0.5).astype(np.int32)
    m = np.zeros((n, g), dtype=np.float32)
    m[np.arange(n), cell] = 1.0
    return m


def _axis_scatter_matrix(n: int, g: int, device) -> torch.Tensor:
    """(n, g) float32 one-hot map of pixel index -> grid cell on ``device``
    (round half up of the pixel centre ``(i + 0.5) / n`` times ``g - 1``)."""
    return torch.from_numpy(_axis_scatter_matrix_np(n, g)).to(device)


def grid_downsample_field(field: torch.Tensor, gw: int, gh: int) -> torch.Tensor:
    """Dense (..., H, W, 2) field -> (..., gh, gw, 2) cell-mean field, as
    ``S_y^T . field . S_x`` with the per-axis one-hot scatter matrices."""
    h, w = field.shape[-3], field.shape[-2]
    sy = _axis_scatter_matrix(h, gh, field.device)
    sx = _axis_scatter_matrix(w, gw, field.device)
    sums = torch.einsum("hg,...hwc,wk->...gkc", sy, field, sx)
    counts = sy.sum(dim=0)[:, None] * sx.sum(dim=0)[None, :]
    return sums / torch.clamp(counts, min=1.0)[..., None]


def grid_scatter_plan_np(h: int, w: int, gh: int, gw: int, border_px: int = 0):
    """Static numpy pieces of the scatter-mean densify.

    Returns ``(sy, sx, counts, idx_y, idx_x)``: per-axis one-hot scatter
    matrices (``(h, gh)`` / ``(w, gw)``, border rows/cols zeroed), the
    per-cell valid-pixel ``counts`` (``(gh, gw)``, floored at 1), and the
    nearest-valid-cell replicate gathers (None when ``border_px == 0``).
    """
    import numpy as np

    sy_np = _axis_scatter_matrix_np(h, gh)  # (H, gh)
    sx_np = _axis_scatter_matrix_np(w, gw)  # (W, gw)
    idx_y = idx_x = None
    if border_px > 0:
        m = min(border_px, (h - 1) // 2, (w - 1) // 2)

        def mask_axis(s_np, n, g):
            s_np = s_np.copy()
            s_np[:m] = 0.0
            s_np[n - m:] = 0.0
            col = s_np.sum(axis=0)  # valid pixels per grid cell
            valid = np.nonzero(col > 0)[0]
            idx = np.clip(np.arange(g), valid.min(), valid.max())
            return s_np, idx

        sy_np, idx_y = mask_axis(sy_np, h, gh)
        sx_np, idx_x = mask_axis(sx_np, w, gw)
    counts = np.maximum(
        sy_np.sum(axis=0)[:, None] * sx_np.sum(axis=0)[None, :], 1.0
    ).astype(np.float32)
    return sy_np, sx_np, counts, idx_y, idx_x


def grid_downsample_uv(
    u: torch.Tensor,
    v: torch.Tensor,
    gw: int,
    gh: int,
    norm_wh: Optional[Tuple[int, int]] = None,
    border_px: int = 0,
) -> torch.Tensor:
    """(..., H, W) flow planes -> (..., gh, gw, 2) cell-mean field.

    ``norm_wh`` converts pixels to [0,1]-normalized units by (W, H)
    division; ``border_px`` excludes the outer band from every cell mean,
    and cells wholly inside it are replicated from the nearest valid cell.
    """
    h, w = u.shape[-2], u.shape[-1]
    sy, sx, counts, idx_y, idx_x = _grid_plan_tensors(h, w, gh, gw, border_px, str(u.device))

    def ds(x):
        return sy.T @ (x.float() @ sx)

    su = ds(u) / counts
    sv = ds(v) / counts
    if norm_wh is not None:
        su = su / norm_wh[0]
        sv = sv / norm_wh[1]
    out = torch.stack([su, sv], dim=-1)
    if idx_y is not None:
        out = out.index_select(-3, idx_y)
        out = out.index_select(-2, idx_x)
    return out


@functools.lru_cache(maxsize=16)
def _grid_plan_tensors(h: int, w: int, gh: int, gw: int, border_px: int, device: str):
    """:func:`grid_scatter_plan_np` on ``device``, made once: a copy from
    pageable host memory waits for the card, so a step must not make one
    (the rows of a sharded step would run one after the other)."""
    return tuple(None if a is None else torch.from_numpy(np.asarray(a)).to(device)
                 for a in grid_scatter_plan_np(h, w, gh, gw, border_px))


def gaussian_blur(field: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur over an (H, W, C) field with reflect-101
    borders, OpenCV's defaults (``sigma = 0.3 * ((ksize - 1) * 0.5 - 1) +
    0.8`` when unset; flow-extract blurs with 11x11)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=field.device)
    k = torch.exp(-(xs**2) / (2.0 * sigma**2))
    k = k / torch.sum(k)

    def conv1d(a, axis):
        n = a.shape[axis]
        i = torch.arange(-r, n + r, device=a.device).abs()
        i = torch.where(i >= n, 2 * (n - 1) - i, i)
        ap = a.index_select(axis, i)
        out = torch.zeros_like(a)
        for j in range(ksize):
            out = out + k[j] * ap.narrow(axis, j, n)
        return out

    return conv1d(conv1d(field, 0), 1)
