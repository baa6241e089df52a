"""Motion-field data layer, serving pieces (port of ``ofps_tpu.core.motion``).

``SparseFlow`` is the fixed-capacity sparse motion-vector field: padded
``(..., N, 2)`` positions and motions in [0,1]-normalized screen units plus
an ``(..., N)`` validity mask.  The numpy plan helpers are copied verbatim
from the JAX package so both packages compute the same cell partition.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)


class SparseFlow(NamedTuple):
    """``pos``/``motion``: (..., N, 2) float32; ``mask``: (..., N) float32
    validity (1.0 = real entry, 0.0 = padding)."""

    pos: torch.Tensor
    motion: torch.Tensor
    mask: torch.Tensor


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

    def add_flow(self, flow: SparseFlow, weight: float = 1.0) -> "Densifier":
        """Scatter-add a sparse flow into the accumulator."""
        h, w = self.counts.shape[-2:]
        x, y = flow_cell_index(flow.pos, w, h)
        idx = (y * w + x).expand(flow.mask.shape)
        wgt = flow.mask * weight
        lead = self.counts.shape[:-2]
        counts = self.counts.reshape(lead + (h * w,)).scatter_add(-1, idx, wgt)
        sums = self.sums.reshape(lead + (h * w, 2)).scatter_add(
            -2, idx[..., None].expand(idx.shape + (2,)), flow.motion * wgt[..., None]
        )
        return Densifier(sums.reshape(self.sums.shape), counts.reshape(self.counts.shape))

    def finalize(self) -> torch.Tensor:
        """Weighted mean per cell: the dense (..., H, W, 2) motion field."""
        return self.sums / self.counts[..., None]


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
    sy_np, sx_np, counts_np, idx_y, idx_x = grid_scatter_plan_np(
        h, w, gh, gw, border_px
    )
    dev = u.device
    sy, sx = torch.from_numpy(sy_np).to(dev), torch.from_numpy(sx_np).to(dev)
    counts = torch.from_numpy(counts_np).to(dev)

    def ds(x):
        return sy.T @ (x.float() @ sx)

    su = ds(u) / counts
    sv = ds(v) / counts
    if norm_wh is not None:
        su = su / norm_wh[0]
        sv = sv / norm_wh[1]
    out = torch.stack([su, sv], dim=-1)
    if idx_y is not None:
        out = out.index_select(-3, torch.from_numpy(idx_y).to(dev))
        out = out.index_select(-2, torch.from_numpy(idx_x).to(dev))
    return out
