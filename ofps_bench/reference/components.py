# Frozen copy of the port's plain ``ofps_torch/ops/components.py`` (the benchmark's
# reference; it imports nothing of the port).
"""Connected components on 2D grids (port of ``ofps_tpu.ops.components``).

Up to 4,096 cells, labels come from the transitive closure of the
8-neighbour adjacency, squared ceil(log2(n)) times as float32 matrix
products: entries are 0/1 and row sums stay below 2^24, so the closure is
exact.  Larger grids, whose (n, n) adjacency would grow as n², take the
JAX package's second branch: hook to the minimum label over the 8
neighbours, then one pointer-jump gather, for a static 3*ceil(log2 n) + 4
rounds.  Both are fixed sequences of tensor operations.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_BIG = 2**30
_CLOSURE_MAX_CELLS = 4096


def _closure_labels(act: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = h * w
    idx = torch.arange(n, device=act.device)
    ys, xs = idx // w, idx % w
    neigh = ((ys[:, None] - ys[None, :]).abs() <= 1) & (
        (xs[:, None] - xs[None, :]).abs() <= 1
    )  # includes self-loops: squaring keeps shorter paths alive
    r = (neigh & act[..., :, None] & act[..., None, :]).to(torch.float32)
    for _ in range(max(1, math.ceil(math.log2(max(2, n))))):
        r = (r @ r > 0).to(torch.float32)
    return torch.where(r > 0, idx, _BIG).amin(dim=-1)


def _propagated_labels(active: torch.Tensor) -> torch.Tensor:
    """Hook + pointer jump over (..., H, W); inactive cells keep BIG."""
    h, w = active.shape[-2:]
    n = h * w
    lead = active.shape[:-2]
    idx = torch.arange(n, device=active.device).reshape(h, w)
    lab = torch.where(active, idx, _BIG)
    for _ in range(max(1, 3 * math.ceil(math.log2(n)) + 4)):
        # The 8 neighbour shifts with BIG outside the grid, as a 3x3 min.
        padded = F.pad(lab.reshape((-1, 1, h, w)).to(torch.float64),
                       (1, 1, 1, 1), value=float(_BIG))
        best = -F.max_pool2d(-padded, 3, stride=1).reshape(lead + (h, w)).to(lab.dtype)
        lab = torch.where(active, torch.minimum(lab, best), _BIG)
        # Pointer jump: labels are linear indices, so lab[lab] is one gather.
        flat = lab.reshape(lead + (n,))
        jumped = torch.gather(flat, -1, torch.where(flat < n, flat, 0)).reshape(lab.shape)
        lab = torch.where(lab < n, jumped, _BIG)
    return lab


def label_components(active: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of ``active`` (..., H, W) bool; each
    component is labelled by its smallest linear index, inactive cells get
    2**30."""
    h, w = active.shape[-2:]
    n = h * w
    if n > _CLOSURE_MAX_CELLS:
        return _propagated_labels(active)
    act = active.reshape(active.shape[:-2] + (n,))
    lab = _closure_labels(act, h, w)
    return torch.where(act, lab, _BIG).reshape(active.shape)


def largest_component(active: torch.Tensor):
    """Mask (..., H, W) bool and area (...) int of the largest 8-connected
    component of ``active``; area is 0 when nothing is active."""
    h, w = active.shape[-2:]
    n = h * w
    labels = label_components(active)
    flat = labels.reshape(labels.shape[:-2] + (n,))
    # Cells per label; inactive cells count in a spare slot n.  Integer
    # adds are exact in any order.
    counts = torch.zeros(flat.shape[:-1] + (n + 1,), dtype=torch.int64, device=flat.device)
    counts = counts.scatter_add(-1, torch.where(flat < n, flat, n), torch.ones_like(flat))[..., :n]
    best = torch.argmax(counts, dim=-1)  # first maximum
    area = torch.gather(counts, -1, best[..., None]).squeeze(-1)
    mask = (labels == best[..., None, None]) & active
    return mask, area.to(torch.int32)
