"""Multi-stream batched per-frame pipeline (port of
``ofps_tpu.parallel.stream``), the serving step:

    frames (B, H, W) -> dense flow (pyramid of hand kernels) -> grid sums
      -> (B, gh, gw, 2) normalized grid -> SparseFlow (B, G, 2)
         |-> every estimator (dense=True RANSAC: almeida, homography,
         |     multiview, libmv) -> pose integration
         '-> detector (static-lattice detect_field)

Rotation/position state, estimator carry and the dense-flow warm start all
travel in :class:`StreamState`; B streams form the leading batch dim.  On
CUDA the estimators and the detector replay as one CUDA graph, the
estimators' carries (libmv's :class:`PrevMotion`) passing in and out of it.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ofps_torch.core import quat
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import field_to_sparse, grid_downsample_uv, grid_size_for
from ofps_torch.detectors.base import DetectionResult, DetectorInstance
from ofps_torch.device import resolve_device
from ofps_torch.estimators.base import EstimatorInstance
from ofps_torch.kernels.flow_refine import GridPlan, build_grid_plan
from ofps_torch.ops.flow_pyramid import (
    FlowParams,
    FrameCache,
    _replicate_border_uv,
    border_margin_px,
    dense_flow_warm,
    effective_levels,
    frame_cache,
    grid_fusable,
)


class StreamState(NamedTuple):
    """Per-stream carried state for a batch of B streams."""

    prev_cache: FrameCache  # previous frame's pyramid (pyr[0] is the frame)
    warm_uv: Tuple[torch.Tensor, torch.Tensor]  # half-res (B, h, w) warm start
    has_prev: torch.Tensor  # (B,) 1.0 once a previous frame exists
    rot: Tuple[torch.Tensor, ...]  # per estimator: (B, 4) integrated rotation
    pos: Tuple[torch.Tensor, ...]  # per estimator: (B, 3) integrated position
    est: Tuple[Any, ...]  # per estimator: carried state, batched over B


class StreamOutputs(NamedTuple):
    """Per-frame outputs of one batched step."""

    flow: torch.Tensor  # (B, H, W, 2) dense flow in pixels, or (B, 0, 0, 2)
    grid: torch.Tensor  # (B, gh, gw, 2) densified normalized field
    rot: Tuple[torch.Tensor, ...]  # per estimator: (B, 4) integrated rotation
    pos: Tuple[torch.Tensor, ...]  # per estimator: (B, 3) integrated position
    delta_rot: Tuple[torch.Tensor, ...]  # per estimator: (B, 4) this frame
    delta_tr: Tuple[torch.Tensor, ...]  # per estimator: (B, 3) this frame
    detection: Optional[DetectionResult]  # batched over B, or None


class StreamPipeline:
    """A configured batched pipeline over B streams of (H, W) video on one
    ``device`` (default the CUDA card; raises where there is none).

    ``emit_dense_flow=False`` is the serving configuration: the finest level
    emits the grid sums directly and no full-resolution flow is stored.
    ``plain=True`` runs the plain PyTorch versions of the kernels (the
    reference the kernel path is checked and timed against).
    """

    def __init__(
        self,
        camera: StandardCamera,
        estimators: Sequence[EstimatorInstance] = (),
        detector: Optional[DetectorInstance] = None,
        flow_params: FlowParams = FlowParams(),
        grid_wh: Optional[Tuple[int, int]] = None,
        emit_dense_flow: bool = True,
        device="cuda",
        plain: bool = False,
    ):
        self.camera = camera
        self.estimators = tuple(estimators)
        self.detector = detector
        self.flow_params = flow_params
        self.grid_wh = grid_wh
        self.emit_dense_flow = emit_dense_flow
        self.device = resolve_device(device)
        self.plain = plain
        self._grid_plans: dict = {}
        self._graphs: dict = {}
        # Consumer runs by kind: CUDA-graph replays and eager calls.
        self.graph_replays = 0
        self.eager_runs = 0

    def _grid_plan(self, h: int, w: int) -> Optional[GridPlan]:
        """Static in-kernel densify plan of the finest level, or None when
        the dense flow is emitted or the finest level is not grid-fusable."""
        if self.emit_dense_flow or not grid_fusable(self.flow_params, h, w):
            return None
        if (h, w) not in self._grid_plans:
            gw, gh = self.grid_wh or grid_size_for(w, h)
            self._grid_plans[(h, w)] = build_grid_plan(
                h, w, gh, gw, border_px=border_margin_px(self.flow_params, h, w),
                device=self.device,
            )
        return self._grid_plans[(h, w)]

    # -- state ---------------------------------------------------------------

    def init_state(self, batch: int, height: int, width: int) -> StreamState:
        dev = self.device
        if effective_levels(self.flow_params, height, width) > 1:
            wh, ww = (height + 1) // 2, (width + 1) // 2
        else:
            wh, ww = height, width
        e = len(self.estimators)
        zeros = torch.zeros((batch, height, width), dtype=torch.float32, device=dev)
        return StreamState(
            prev_cache=frame_cache(zeros, self.flow_params),
            warm_uv=tuple(
                torch.zeros((batch, wh, ww), dtype=torch.float32, device=dev)
                for _ in range(2)
            ),
            has_prev=torch.zeros((batch,), dtype=torch.float32, device=dev),
            rot=tuple(quat.identity(device=dev).expand(batch, 4) for _ in range(e)),
            pos=tuple(torch.zeros((batch, 3), device=dev) for _ in range(e)),
            est=tuple(_broadcast_state(est.init(), batch, dev) for est in self.estimators),
        )

    def dyn_props(self):
        """Default per-frame properties: ``{"estimators": (dict, ...),
        "detector": dict}``; pass a changed copy to a step."""
        return {
            "estimators": tuple(est.dyn_defaults() for est in self.estimators),
            "detector": self.detector.dyn_defaults() if self.detector else {},
        }

    # -- consumers -----------------------------------------------------------

    def _consume(self, est_states, rot, pos, grid, draws, props=None):
        """Estimators + detector on the all-valid (B, gh, gw, 2) grid: a
        fixed sequence of device operations (random inputs come in as
        ``draws``, one per estimator, None for an estimator without them)."""
        sparse = field_to_sparse(grid)
        rots, poss, dr, dt, est_out = [], [], [], [], []
        for i, est in enumerate(self.estimators):
            eprops = props["estimators"][i] if props is not None else None
            extra = {} if draws[i] is None else {"fit_idx": draws[i]}
            r, t, st = est.estimate(
                est_states[i], sparse, self.camera, props=eprops, dense=True, **extra
            )
            poss.append(pos[i] + quat.rotate_vec(rot[i], t))
            rots.append(quat.mul(r, rot[i]))
            dr.append(r)
            dt.append(t)
            est_out.append(st)
        detection = None
        if self.detector is not None:
            dprops = props["detector"] if props is not None else None
            if self.detector.detect_field is not None:
                detection = self.detector.detect_field(grid, props=dprops)
            else:
                detection = self.detector.detect(sparse, props=dprops)
        return tuple(rots), tuple(poss), tuple(dr), tuple(dt), tuple(est_out), detection

    def _run_consumers(self, state: StreamState, grid, draws, props):
        """:meth:`_consume`, replayed as a CUDA graph on CUDA.

        Eagerly the estimators' LSQ loops and RANSAC stages are 20-31k small
        launches a step, so the step is bound by the host launching them; a
        graph replays the same kernels in one launch.  The graph is
        captured per (input shapes, props): the grid, the integrated poses,
        the draws (a tensor or a tuple of tensors per estimator) and the
        estimators' carries are its static inputs, and the new carries come
        out with the other outputs.  It runs eagerly on the CPU, and where a
        prop is not a plain number (a graph could not see it change).
        """
        key = _props_key(props)
        if self.device.type != "cuda" or key is None:
            self.eager_runs += 1
            return self._consume(state.est, state.rot, state.pos, grid, draws, props)
        tree = (tuple(state.rot), tuple(state.pos), tuple(draws), tuple(state.est))
        inputs = (grid,) + tuple(_leaves(tree))
        gkey = (tuple(tuple(x.shape) for x in inputs), key)
        if gkey not in self._graphs:

            def fn(*xs):
                rot, pos, d, est = _rebuild(tree, iter(xs[1:]))
                return self._consume(est, rot, pos, xs[0], d, props)

            self._graphs[gkey] = _CapturedCall(fn, inputs)
        self.graph_replays += 1
        return self._graphs[gkey](inputs)

    # -- steps ---------------------------------------------------------------

    def step_from_frames(
        self, state: StreamState, gray: torch.Tensor,
        generator: Optional[torch.Generator] = None, props=None, draws=None,
    ) -> Tuple[StreamState, StreamOutputs]:
        """Full step from (B, H, W) float32 frames on the pipeline's device.

        The first frame per stream (``has_prev`` 0) yields a zero flow
        field, hence identity pose deltas.  ``draws``: optional per-estimator
        random inputs in place of drawing them from ``generator``, in
        estimator order (RANSAC point indices: (B, 200, 3) for almeida,
        (B, 91, 4) for homography, (B, 218, 5) for multiview, and for libmv
        (B, 512, 7) indices with (B, 512, 7) uniforms for its chained
        field, at their defaults); parity tests inject JAX's.
        """
        if gray.device.type != self.device.type:
            raise ValueError(f"frames on {gray.device}, pipeline on {self.device}")
        h, w = gray.shape[-2], gray.shape[-1]
        plan = self._grid_plan(h, w)
        (u, v), warm, new_cache = dense_flow_warm(
            state.prev_cache.pyr[0], gray, self.flow_params, warm=state.warm_uv,
            prev_cache=state.prev_cache, grid_plan=plan, plain=self.plain,
        )
        hp = state.has_prev[:, None, None]
        u = u * hp
        v = v * hp
        warm = tuple(x * hp for x in warm)
        if plan is not None:
            # The finest level emitted the cell sums: finish the mean, the
            # normalized units and the border-cell replicate at grid size.
            grid = torch.stack([u / (plan.counts * w), v / (plan.counts * h)], dim=-1)
            if plan.idx_y is not None:
                grid = grid.index_select(-3, plan.idx_y).index_select(-2, plan.idx_x)
        else:
            gw, gh = self.grid_wh or grid_size_for(w, h)
            grid = grid_downsample_uv(
                u, v, gw, gh, norm_wh=(w, h),
                border_px=border_margin_px(self.flow_params, h, w),
            )
        if draws is None:
            n = grid.shape[-3] * grid.shape[-2]
            draws = tuple(
                None if est.draw is None
                else est.draw(generator, grid.shape[:-3], n, grid.device)
                for est in self.estimators
            )
        rot, pos, dr, dt, est, detection = self._run_consumers(state, grid, draws, props)
        new_state = StreamState(
            prev_cache=new_cache,
            warm_uv=warm,
            has_prev=torch.ones_like(state.has_prev),
            rot=rot,
            pos=pos,
            est=est,
        )
        if self.emit_dense_flow:
            ur, vr = _replicate_border_uv(u, v, border_margin_px(self.flow_params, h, w))
            flow_px = torch.stack([ur, vr], dim=-1)
        else:
            flow_px = torch.zeros((gray.shape[0], 0, 0, 2), device=gray.device)
        return new_state, StreamOutputs(
            flow=flow_px, grid=grid, rot=rot, pos=pos, delta_rot=dr,
            delta_tr=dt, detection=detection,
        )

    def scan_frames(
        self, state: StreamState, grays: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[StreamState, List[StreamOutputs]]:
        """Process (T, B, H, W) frames in order; returns the final state and
        the per-frame outputs."""
        outs = []
        for g in grays:
            state, out = self.step_from_frames(state, g, generator)
            outs.append(out)
        return state, outs


def _props_key(props):
    """Hashable form of plain-number props (None when a value is not a
    plain number, e.g. a tensor a graph could not see change)."""
    if props is None:
        return ()
    items = [tuple(sorted(d.items())) for d in props["estimators"]]
    items.append(tuple(sorted(props["detector"].items())))
    flat = [v for group in items for _, v in group]
    if not all(isinstance(v, (int, float)) for v in flat):
        return None
    return tuple(items)


def _broadcast_state(x, batch: int, device):
    """An estimator's unbatched ``init()`` carry tiled to B streams."""
    return _rebuild(x, (t.to(device).expand((batch,) + t.shape).clone() for t in _leaves(x)))


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of tuples / named tuples (None has none)."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for v in x for leaf in _leaves(v)]


def _rebuild(template, leaves):
    """``template``'s nest with its tensors taken in order from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    fields = [_rebuild(v, leaves) for v in template]
    return type(template)(*fields) if hasattr(template, "_fields") else tuple(fields)


def _clone(x):
    return _rebuild(x, (t.clone() for t in _leaves(x)))


class _CapturedCall:
    """``fn(*inputs)`` captured as a CUDA graph over static input buffers:
    a call copies its inputs in, replays, and returns clones of the outputs
    (the next replay overwrites the static ones)."""

    def __init__(self, fn, inputs):
        dev = inputs[0].device
        self.inputs = tuple(x.clone() for x in inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.inputs)  # warm-up: lazily built constants and caches
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        return _clone(self.outputs)
