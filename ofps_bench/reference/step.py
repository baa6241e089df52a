"""The reference of one served step, in plain PyTorch from the frozen
copies beside this file, eagerly, stream batch as the leading axis.

* :meth:`Reference.codec_step`: the packed vectors of B streams (the same
  rows ``pack_entries`` writes: valid entries first, then zeros) through
  every estimator's masked RANSAC and the detector's sparse ``detect``.
* :meth:`Reference.frames_step`: two uint8 frames of B streams and the
  warm start through the 6-level pyramid with the plain refine, guard and
  median, the grid sums of the finest level, then every estimator's dense
  RANSAC and the detector's dense ``detect_field``.

The RANSAC draws come from :meth:`Reference.draws`, which makes the same
calls, in the same order, as the served step makes on its generator.  An
estimator that carries state from step to step (libmv's ``PrevMotion``)
starts from ``states`` where a step is given them (the :class:`Consumed`
``states`` of the step before), else from its ``init()`` tiled to the
batch, as the served pipeline starts.  Estimators and detectors are found
by name (``est_base.create_estimator``, ``det_base.create_detector``).
``precision="tf32"`` lets matrix products round their inputs to TF32 (the
control); the configuration states float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple, Optional

import torch

from ofps_bench.reference import quat
from ofps_bench.reference.camera import StandardCamera
from ofps_bench.reference.det_base import create_detector
from ofps_bench.reference.est_base import create_estimator
from ofps_bench.reference.flow import (
    FlowParams,
    border_margin_px,
    build_grid_plan,
    dense_flow_warm,
    frame_cache,
    grid_fusable,
)
from ofps_bench.reference.motion import SparseFlow, field_to_sparse, grid_downsample_uv, grid_size_for


class Consumed(NamedTuple):
    delta: List[torch.Tensor]  # per estimator (B, 4)
    families: List[Optional[torch.Tensor]]  # per estimator (B, F, 4) candidates, or None
    detected: Optional[torch.Tensor]  # (B,) bool
    tr: List[torch.Tensor]  # per estimator (B, 3) translation
    states: List[Any]  # per estimator the state handed on to the next step


@contextlib.contextmanager
def precision(mode: str):
    """float32 (TF32 off), or ``tf32``: matrix products round to TF32."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    def __init__(self, config, device, mode: str = "float32"):
        self.device = torch.device(device)
        self.mode = mode
        cam = config["camera"]
        self.camera = StandardCamera.create(cam["aspect"], cam["fov_y"])
        self.ests = [create_estimator(e["name"], **e.get("properties", {}))
                     for e in config["estimators"]]
        det = config.get("detector")
        self.det = create_detector(det["name"], **det.get("properties", {})) if det else None
        self.flow_params = FlowParams()
        self.height, self.width = config["height"], config["width"]

    def draws(self, generator, batch: int, n: int, dense: bool):
        """One step's draws: each estimator's, in estimator order."""
        return [None if e.draw is None else e.draw(generator, (batch,), n, self.device, dense=dense)
                for e in self.ests]

    def device_props(self):
        """Per-frame properties as 0-d float32 tensors, as a running
        pipeline holds them."""
        def t(d):
            return {k: torch.tensor(float(v), dtype=torch.float32, device=self.device)
                    for k, v in d.items()}
        return {"estimators": tuple(t(e.dyn_defaults()) for e in self.ests),
                "detector": t(self.det.dyn_defaults()) if self.det else {}}

    def consume(self, field, draws, props=None, states=None) -> Consumed:
        dense = isinstance(field, torch.Tensor)
        sparse = field_to_sparse(field) if dense else field
        if states is None:  # every estimator's init() tiled to the streams
            lead = tuple(sparse.mask.shape[:-1])
            states = [_tiled(est.init(), lead, self.device) for est in self.ests]
        deltas, families, trs, new_states = [], [], [], []
        with precision(self.mode):
            for i, est in enumerate(self.ests):
                eprops = props["estimators"][i] if props is not None else None
                extra = {} if draws[i] is None else {"fit_idx": draws[i]}
                r, tr, st = est.estimate(states[i], sparse, self.camera, props=eprops,
                                         dense=dense, **extra)
                deltas.append(r)
                trs.append(tr)
                new_states.append(st)
                families.append(None if est.families is None else
                                est.families(sparse, self.camera, eprops, dense, draws[i]))
            detected = None
            if self.det is not None:
                dprops = props["detector"] if props is not None else None
                if dense and self.det.detect_field is not None:
                    detected = self.det.detect_field(field, props=dprops).detected
                else:
                    detected = self.det.detect(sparse, props=dprops).detected
        return Consumed(deltas, families, detected, trs, new_states)

    def codec_step(self, rows: torch.Tensor, draws, states=None) -> Consumed:
        """``rows`` (B, capacity, 5): pos x, pos y, motion x, motion y, mask."""
        flow = SparseFlow(rows[..., 0:2], rows[..., 2:4], rows[..., 4])
        return self.consume(flow, draws, states=states)

    def flow(self, prev_u8, cur_u8, warm, has_prev):
        """(grid (B, gh, gw, 2), next warm (u, v)) of one frames step."""
        prev, cur = prev_u8.to(torch.float32), cur_u8.to(torch.float32)
        h, w = cur.shape[-2:]
        p = self.flow_params
        gw, gh = grid_size_for(w, h)
        margin = border_margin_px(p, h, w)
        plan = (build_grid_plan(h, w, gh, gw, border_px=margin, device=self.device)
                if grid_fusable(p, h, w) else None)
        with precision(self.mode):
            (u, v), nxt, _ = dense_flow_warm(prev, cur, p, warm=warm,
                                             prev_cache=frame_cache(prev, p), grid_plan=plan)
            hp = has_prev[:, None, None]
            u, v = u * hp, v * hp
            nxt = tuple(x * hp for x in nxt)
            if plan is not None:
                grid = torch.stack([u / (plan.counts * w), v / (plan.counts * h)], dim=-1)
                if plan.idx_y is not None:
                    grid = grid.index_select(-3, plan.idx_y).index_select(-2, plan.idx_x)
            else:
                grid = grid_downsample_uv(u, v, gw, gh, norm_wh=(w, h), border_px=margin)
        return grid, nxt


def _tiled(x, lead, device):
    """The tensors of the nest ``x`` (tuples, named tuples) tiled to the
    leading dims ``lead``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device).expand(lead + x.shape).clone()
    fields = [_tiled(v, lead, device) for v in x]
    return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)


def angle_deg(a, b):
    """Angle (degrees, float64) between unit quaternions ``a`` and ``b``
    (..., 4), sign-blind."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    d = quat.mul(quat.conj(a), b)
    vec = torch.linalg.vector_norm(d[..., 1:], dim=-1)
    return torch.rad2deg(2.0 * torch.atan2(vec, d[..., 0].abs()))
