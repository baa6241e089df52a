"""Spatially sharded dense flow: column bands with a halo exchange (port of
``ofps_tpu.parallel.spatial``).

Each position of a mesh row holds a column band of the frame.  Before the
pyramid runs, every band is extended by ``halo`` real columns of each
neighbour, copied from its device.  The whole pyramid (:func:`ofps_torch.
ops.flow_pyramid.dense_flow_warm`, its kernels on CUDA) then runs per band
on the band's device, and the halo is cut off the flow and the warm carry.

Within a band the result matches the unsharded pyramid wherever the
matching footprint (flow + search + window) stays inside the halo; the
default halo is the JAX kernel's own 128-column displacement budget.  The
coarse levels see band + halo content only, so the seams may differ
slightly.

Two departures from JAX's route, both toward the unsharded pyramid:

* The frame's outer edges take no halo.  JAX's bands are slices of one
  array and must all have one width, so the first and last band take
  edge-replicated columns there; the kernels then match static filler
  where the unsharded pyramid applies its out-of-image penalty, and the
  flow differs over the coarsest level's reach ((coarse_search + win // 2)
  * 2 ** (levels - 1) px, 256 at 1080p), beyond what any consumer's border
  margin removes.  The port's bands are separate tensors, so an outer band
  is simply narrower, and its pyramid sees the frame's own edge.
* A band picks its depth and each level's refine from the whole frame's
  level sizes (``frame_shape``), not its own.  JAX's band refines a level
  with the 2-D sweep where the unsharded pyramid takes the
  axis-separable refine whenever the band's level falls under
  ``fuse_min_pixels`` and the frame's does not (at 1080p with two bands:
  the 135-row level), and then misses its own sharded-vs-unsharded gate
  (``tests/test_torch_spatial.py`` plants the case).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ofps_torch.ops.flow_pyramid import FlowParams, dense_flow_warm, effective_levels
from ofps_torch.parallel.sharding import StreamMesh

# The unsharded kernel's column-displacement budget (ofps_tpu's _COL_PAD).
DEFAULT_HALO = 128


def split_columns(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` (..., W) as len(devices) equal column bands, band c on
    ``devices[c]``."""
    n = len(devices)
    if x.shape[-1] % n:
        raise ValueError(f"width {x.shape[-1]} does not split into {n} bands")
    w = x.shape[-1] // n
    return [x[..., c * w : (c + 1) * w].to(d).contiguous() for c, d in enumerate(devices)]


def exchange_halo(bands: Sequence[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Each (..., w) band extended by ``halo`` real columns of each
    neighbour, copied to the band's device; the frame's outer edges (the
    first band's left, the last band's right) take none.  ``halo`` may not
    exceed a band's width (one neighbour hop, as JAX's ``ppermute``)."""
    if halo == 0:
        return list(bands)
    if halo > min(b.shape[-1] for b in bands):
        raise ValueError(f"halo {halo} wider than a band")
    n = len(bands)
    out = []
    for c, x in enumerate(bands):
        left = [bands[c - 1][..., -halo:].to(x.device)] if c > 0 else []
        right = [bands[c + 1][..., :halo].to(x.device)] if c < n - 1 else []
        out.append(torch.cat([*left, x, *right], dim=-1))
    return out


def _crop(x: torch.Tensor, c: int, n: int, halo: int) -> torch.Tensor:
    """Band ``c`` of ``n`` without the halo :func:`exchange_halo` gave it."""
    return x[..., (halo if c > 0 else 0) : x.shape[-1] - (halo if c < n - 1 else 0)]


def dense_flow_warm_spatial(
    i1: torch.Tensor,
    i2: torch.Tensor,
    params: FlowParams,
    warm: Optional[Tuple[torch.Tensor, torch.Tensor]],
    mesh: StreamMesh,
    halo: int = DEFAULT_HALO,
    plain: bool = False,
):
    """``dense_flow_warm`` over a (stream, space) mesh: the batch splits
    over the rows, the columns over each row's positions, one band + halo
    pyramid per position on its device (kernels on CUDA, their plain
    versions on the CPU or with ``plain=True``), no ``prev_cache``.

    ``i1``/``i2``: (B, H, W); ``warm``: half-resolution (u, v) planes or
    None (zero planes; none with a single band).  Returns ``((u, v),
    warm_next)`` at the global shapes, on the mesh's first device.  B must
    split over the rows, and W and the warm width over the positions of a
    row.
    """
    rows, nspace = mesh.shape["stream"], mesh.shape["space"]
    bsz, h, w = i1.shape
    if w % nspace or bsz % rows:
        raise ValueError(f"(B, W) = {(bsz, w)} does not split over the mesh {mesh.shape}")
    # One neighbour hop, and an even halo so the warm halo is whole.  A
    # single band needs none (JAX's route returns the unsharded pyramid).
    halo = min(halo, w // nspace) if nspace > 1 else 0
    halo -= halo % 2
    wh = halo // 2
    if warm is None and nspace > 1:
        levels = effective_levels(params, h, w)
        hw, ww = ((h + 1) // 2, (w + 1) // 2) if levels > 1 else (h, w)
        warm = tuple(torch.zeros((bsz, hw, ww), dtype=torch.float32, device=i1.device)
                     for _ in range(2))
    if warm is not None and warm[0].shape[-1] % nspace:
        raise ValueError(f"warm width {warm[0].shape[-1]} does not split into {nspace} bands")
    nb = bsz // rows
    flow_rows, warm_rows = [], []
    for r in range(rows):
        devs = mesh.devices[r]
        b = slice(r * nb, (r + 1) * nb)
        a1, a2 = (exchange_halo(split_columns(x[b], devs), halo) for x in (i1, i2))
        if warm is None:
            warm_bands = [None] * nspace
        else:
            wu, wv = (exchange_halo(split_columns(x[b], devs), wh) for x in warm)
            warm_bands = list(zip(wu, wv))
        outs = []
        for c in range(nspace):
            (u, v), (wu2, wv2), _ = dense_flow_warm(
                a1[c], a2[c], params, warm=warm_bands[c], plain=plain, frame_shape=(h, w))
            outs.append((_crop(u, c, nspace, halo), _crop(v, c, nspace, halo),
                         _crop(wu2, c, nspace, wh), _crop(wv2, c, nspace, wh)))
        dev = mesh.row_device(r)
        u, v, wu2, wv2 = (torch.cat([o[k].to(dev) for o in outs], dim=-1) for k in range(4))
        flow_rows.append((u, v))
        warm_rows.append((wu2, wv2))
    first = mesh.first_device

    def join(parts):
        return torch.cat([p.to(first) for p in parts], dim=0)

    return ((join([f[0] for f in flow_rows]), join([f[1] for f in flow_rows])),
            (join([x[0] for x in warm_rows]), join([x[1] for x in warm_rows])))
