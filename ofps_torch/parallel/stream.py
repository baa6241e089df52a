"""Multi-stream batched per-frame pipeline (port of
``ofps_tpu.parallel.stream``), the serving steps:

    frames (B, H, W) -> dense flow (pyramid of hand kernels) -> grid sums
      -> (B, gh, gw, 2) normalized grid -> SparseFlow (B, G, 2)
         |-> every estimator (dense=True RANSAC: almeida, homography,
         |     multiview, libmv) -> pose integration
         '-> detector (static-lattice detect_field)

    codec MVs (B, N, 2) + mask -> SparseFlow (step_from_flow)
         |-> every estimator (dense=False: masked RANSAC) -> pose integration
         '-> detector (sparse detect)

Rotation/position state, estimator carry and the dense-flow warm start all
travel in :class:`StreamState`; B streams form the leading batch dim.  On
CUDA the estimators and the detector replay as a CUDA graph
(:mod:`ofps_torch.pipeline.graphs`), carries and props among its inputs.

``shardings`` (:mod:`ofps_torch.parallel.sharding`) spreads a step over a
(stream, space) mesh: the batch splits into the mesh's rows, each row runs
the step on its own devices (its own consumers' graph), and with a space
axis the row's dense flow runs as column bands with a halo exchange
(:mod:`ofps_torch.parallel.spatial`).

Each step writes spans into the pipeline's recorder (``perf``, a
:class:`~ofps_torch.pipeline.runtime.PerfStats`): ``step`` (or
``pipeline.step`` under a caller's open span), ``flow`` (frames only,
with its CUDA-event time), ``draws``, ``consumers`` and, on CUDA,
``consumers.copy_in``, ``consumers.launch`` (the replay, with its
CUDA-event time), ``consumers.clone`` and, once per graph,
``consumers.capture`` with the captured graph's node count.  Inside the
consumers each estimator's section is a span ``consumers.est.<name>`` and
the detector's ``consumers.det.<name>``: eagerly with host times only; in
a CUDA graph their start and end are event-record nodes of the graph, so
that every replay gives each section's device time (children of
``consumers.launch``), and the capture counts each section's nodes
(``consumers.capture``'s ``nodes_by_section``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ofps_torch.core import quat
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import (
    SparseFlow,
    field_to_sparse,
    grid_downsample_uv,
    grid_size_for,
)
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
from ofps_torch.parallel.sharding import (
    RowShards,
    StreamMesh,
    StreamSharding,
    gather,
    shard_put,
)
from ofps_torch.parallel.spatial import dense_flow_warm_spatial
from ofps_torch.pipeline.graphs import GraphCache, Sections, leaves, tile
from ofps_torch.pipeline.runtime import PerfStats, set_last_perf


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


def _step_span(method):
    """``method`` inside a span of the pipeline's recorder: a root
    ``step``, or ``pipeline.step`` inside a span its caller holds open
    (``run_batch``'s step, or a sharded pipeline's for its rows)."""

    @functools.wraps(method)
    def spanned(self, *args, **kwargs):
        with self.perf.span("pipeline.step" if self.perf.depth else "step", row=self._row):
            return method(self, *args, **kwargs)

    return spanned


class StreamPipeline:
    """A configured batched pipeline over B streams of (H, W) video on one
    ``device`` (default the CUDA card; raises where there is none).

    ``emit_dense_flow=False`` is the serving configuration: the finest level
    emits the grid sums directly and no full-resolution flow is stored.
    ``plain=True`` runs the plain PyTorch versions of the kernels, the flow's
    and almeida's RANSAC's (the reference the kernel path is checked and
    timed against).

    ``shardings``: a :class:`StreamSharding` whose mesh replaces ``device``.
    The state is then a :class:`RowShards` of per-row states (from
    :meth:`init_state`), a step takes the whole batch (or a
    :class:`RowShards` of it) and returns outputs gathered on the mesh's
    first device.  The RANSAC draws are made once for the whole batch, as
    the unsharded step makes them, and then split, so a stream-only mesh
    gives the unsharded step's results.  With a space axis the flow runs
    as column bands (no grid plan: the full-resolution flow is densified)
    and the carried cache holds the raw frame only.

    ``perf``: the recorder the steps' spans go to (a new one by default);
    the rows of a sharded pipeline write into their parent's, under their
    row index.  A top-level pipeline's recorder is what
    :func:`~ofps_torch.pipeline.runtime.last_perf` returns until the next
    is built.
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
        shardings: Optional[StreamSharding] = None,
        perf: Optional[PerfStats] = None,
        _band_mesh: Optional[StreamMesh] = None,
        _row: Optional[int] = None,
    ):
        self.camera = camera
        self.estimators = tuple(estimators)
        self.detector = detector
        self.flow_params = flow_params
        self.grid_wh = grid_wh
        self.emit_dense_flow = emit_dense_flow
        self.plain = plain
        self.shard = shardings
        self._grid_plans: dict = {}
        self.graphs = GraphCache()
        self.perf = perf if perf is not None else PerfStats()
        self._row = _row
        if _row is None:
            set_last_perf(self.perf)
        # A row of a sharded pipeline: the (1, space) mesh its flow's
        # column bands run on, when the space axis is larger than 1.
        self._band_mesh = _band_mesh
        self._rows: Tuple["StreamPipeline", ...] = ()
        if shardings is None:
            self.device = resolve_device(device)
            return
        mesh = shardings.mesh
        for row in mesh.devices:
            for d in row:
                resolve_device(d)
        self.device = mesh.first_device
        self._rows = tuple(self._row_pipeline(mesh.row(r), r)
                           for r in range(mesh.shape["stream"]))

    def _row_pipeline(self, row_mesh: StreamMesh, r: int) -> "StreamPipeline":
        """The pipeline of mesh row ``r``, on the row's first device."""
        return StreamPipeline(
            self.camera, self.estimators, self.detector, self.flow_params, self.grid_wh,
            self.emit_dense_flow, device=row_mesh.first_device, plain=self.plain,
            perf=self.perf, _band_mesh=row_mesh if row_mesh.shape["space"] > 1 else None,
            _row=r,
        )

    def _grid_plan(self, h: int, w: int) -> Optional[GridPlan]:
        """Static in-kernel densify plan of the finest level, or None when
        the dense flow is emitted or the finest level is not grid-fusable."""
        if (self.emit_dense_flow or self._band_mesh is not None
                or not grid_fusable(self.flow_params, h, w)):
            return None
        if (h, w) not in self._grid_plans:
            gw, gh = self.grid_wh or grid_size_for(w, h)
            self._grid_plans[(h, w)] = build_grid_plan(
                h, w, gh, gw, border_px=border_margin_px(self.flow_params, h, w),
                device=self.device,
            )
        return self._grid_plans[(h, w)]

    # -- state ---------------------------------------------------------------

    def _make_cache(self, gray: torch.Tensor) -> FrameCache:
        """``gray``'s :class:`FrameCache` for the carry: its pyramid, or
        the frame alone where the flow runs as column bands (each band
        builds its own pyramid, as JAX's spatial route does)."""
        if self._band_mesh is not None:
            return FrameCache(pyr=(gray,))
        return frame_cache(gray, self.flow_params)

    def state_with_frame(self, state, gray: torch.Tensor):
        """``state`` as if ``gray`` (B, H, W) were the last frame processed
        (priming)."""
        if self._rows:
            return RowShards(row.state_with_frame(s, g) for row, s, g in
                             zip(self._rows, state, self._split(gray)))
        return state._replace(prev_cache=self._make_cache(gray),
                              has_prev=torch.ones_like(state.has_prev))

    def init_state(self, batch: int, height: int, width: int):
        if self._rows:
            n = len(self._rows)
            if batch % n:
                raise ValueError(f"batch {batch} does not split into {n} mesh rows")
            return RowShards(row.init_state(batch // n, height, width) for row in self._rows)
        dev = self.device
        if effective_levels(self.flow_params, height, width) > 1:
            wh, ww = (height + 1) // 2, (width + 1) // 2
        else:
            wh, ww = height, width
        e = len(self.estimators)
        zeros = torch.zeros((batch, height, width), dtype=torch.float32, device=dev)
        return StreamState(
            prev_cache=self._make_cache(zeros),
            warm_uv=tuple(
                torch.zeros((batch, wh, ww), dtype=torch.float32, device=dev)
                for _ in range(2)
            ),
            has_prev=torch.zeros((batch,), dtype=torch.float32, device=dev),
            rot=tuple(quat.identity(device=dev).expand(batch, 4) for _ in range(e)),
            pos=tuple(torch.zeros((batch, 3), device=dev) for _ in range(e)),
            est=tuple(tile(est.init(), batch, dev) for est in self.estimators),
        )

    def dyn_props(self):
        """Default per-frame properties: ``{"estimators": (dict, ...),
        "detector": dict}`` of numbers; pass a changed copy to a step.  A
        value may also be a 0-d tensor (``LivePipeline`` keeps them on the
        device, so that a change is one copy and no new graph)."""
        return {
            "estimators": tuple(est.dyn_defaults() for est in self.estimators),
            "detector": self.detector.dyn_defaults() if self.detector else {},
        }

    # -- consumers -----------------------------------------------------------

    def _consume(self, field: Union[torch.Tensor, SparseFlow], rot, pos, draws, est_states,
                 props=None, sections: Optional[Sections] = None):
        """Estimators + detector: a fixed sequence of device operations
        (random inputs come in as ``draws``, one per estimator, None for an
        estimator without them).  ``field`` is the all-valid (B, gh, gw, 2)
        grid (``dense=True`` estimators, the detector's static-lattice
        ``detect_field``) or a masked (B, N) :class:`SparseFlow` (masked
        RANSAC, the detector's sparse ``detect``).  Each estimator and the
        detector run inside a span of their own; ``sections`` times them
        inside a graph being captured."""
        dense = isinstance(field, torch.Tensor)
        sparse = field_to_sparse(field) if dense else field
        rots, poss, dr, dt, est_out = [], [], [], [], []
        for i, est in enumerate(self.estimators):
            eprops = props["estimators"][i] if props is not None else None
            extra = {} if draws[i] is None else {"fit_idx": draws[i]}
            if self.plain:
                extra["plain"] = True
            with self._section("est", est.name, sections):
                r, t, st = est.estimate(
                    est_states[i], sparse, self.camera, props=eprops, dense=dense, **extra
                )
            poss.append(pos[i] + quat.rotate_vec(rot[i], t))
            rots.append(quat.mul(r, rot[i]))
            dr.append(r)
            dt.append(t)
            est_out.append(st)
        detection = None
        if self.detector is not None:
            dprops = props["detector"] if props is not None else None
            with self._section("det", self.detector.name, sections):
                if dense and self.detector.detect_field is not None:
                    detection = self.detector.detect_field(field, props=dprops)
                else:
                    detection = self.detector.detect(sparse, props=dprops)
        return tuple(rots), tuple(poss), tuple(dr), tuple(dt), tuple(est_out), detection

    @contextlib.contextmanager
    def _section(self, kind: str, name: str, sections: Optional[Sections]):
        """The span ``consumers.<kind>.<name>`` of an estimator (``est``) or
        the detector (``det``); inside a capture also a timed section of
        the graph."""
        span = f"consumers.{kind}.{name}"
        with self.perf.span(span):
            if sections is None or not torch.cuda.is_current_stream_capturing():
                yield
            else:
                with sections.timed(span, name):
                    yield

    def _run_consumers(self, state: StreamState, field, draws, props):
        """:meth:`_consume`, replayed as a CUDA graph on CUDA (``graphs``).

        Eagerly the estimators' RANSAC stages are thousands of small
        launches a step (homography ~1,900, multiview and libmv ~5,400
        each; almeida's are three hand kernels), so the step is bound by the
        host launching them; a graph replays the same kernels in one
        launch.  The new carries come out with the other outputs.
        """
        args = (field, tuple(state.rot), tuple(state.pos), tuple(draws), tuple(state.est))
        return self.graphs.run(self._consume, args, props, self.device, self.perf)

    # Consumer runs by kind, over every mesh row: graph replays, eager calls.
    graph_replays = property(lambda self: sum(p.graphs.replays for p in self._rows or (self,)))
    eager_runs = property(lambda self: sum(p.graphs.eager_runs for p in self._rows or (self,)))

    # -- steps ---------------------------------------------------------------

    @_step_span
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
        if self._rows:
            h, w = gray[0].shape[-2:] if isinstance(gray, RowShards) else gray.shape[-2:]
            gw, gh = self.grid_wh or grid_size_for(w, h)
            return self._sharded_step("step_from_frames", state, gray, generator, props,
                                      draws, gh * gw, {})
        if gray.device.type != self.device.type:
            raise ValueError(f"frames on {gray.device}, pipeline on {self.device}")
        h, w = gray.shape[-2], gray.shape[-1]
        plan = self._grid_plan(h, w)
        perf = self.perf
        flow_span = perf.open("flow", device=self.device)
        if self._band_mesh is not None:
            (u, v), warm = dense_flow_warm_spatial(
                state.prev_cache.pyr[0], gray, self.flow_params, state.warm_uv,
                self._band_mesh, plain=self.plain,
            )
            new_cache = self._make_cache(gray)
        else:
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
        draws_span = perf.open("draws", t=perf.close(flow_span))
        if draws is None:
            n = grid.shape[-3] * grid.shape[-2]
            draws = tuple(
                None if est.draw is None
                else est.draw(generator, grid.shape[:-3], n, grid.device)
                for est in self.estimators
            )
        with perf.span("consumers", t=perf.close(draws_span)):
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

    @_step_span
    def step_from_flow(
        self, state: StreamState, sparse: SparseFlow,
        generator: Optional[torch.Generator] = None, props=None, draws=None,
    ) -> Tuple[StreamState, StreamOutputs]:
        """Step from decoder-provided motion vectors (the codec-MV / .mvec
        path): ``sparse`` is a (B, N) :class:`SparseFlow` on the pipeline's
        device whose mask marks the valid entries.  The estimators run
        masked RANSAC (``dense=False``) and the detector its sparse
        ``detect``; an all-masked stream gets identity deltas, so its pose
        holds.  ``draws``: optional per-estimator random inputs in place of
        drawing them from ``generator``, uniforms that the estimators map to
        valid points (almeida (B, 200, 3), homography (B, 91, 4), multiview
        (B, 218, 5), libmv a pair of (B, 512, 7) at their defaults); parity
        tests inject JAX's.  ``flow`` and ``grid`` come out empty,
        (B, 0, 0, 2)."""
        if self._rows:
            cap = (sparse[0] if isinstance(sparse, RowShards) else sparse).capacity
            return self._sharded_step("step_from_flow", state, sparse, generator, props,
                                      draws, cap, {"dense": False})
        if sparse.mask.device.type != self.device.type:
            raise ValueError(f"flow on {sparse.mask.device}, pipeline on {self.device}")
        lead = sparse.mask.shape[:-1]
        perf = self.perf
        draws_span = perf.open("draws")
        if draws is None:
            draws = tuple(
                None if est.draw is None
                else est.draw(generator, lead, sparse.capacity, self.device, dense=False)
                for est in self.estimators
            )
        with perf.span("consumers", t=perf.close(draws_span)):
            rot, pos, dr, dt, est, detection = self._run_consumers(state, sparse, draws, props)
        empty = torch.zeros(lead + (0, 0, 2), device=self.device)
        return state._replace(rot=rot, pos=pos, est=est), StreamOutputs(
            flow=empty, grid=empty, rot=rot, pos=pos, delta_rot=dr, delta_tr=dt,
            detection=detection,
        )

    # -- sharded steps -------------------------------------------------------

    def _split(self, x) -> RowShards:
        """``x`` split into the mesh's rows, unless it already is."""
        return x if isinstance(x, RowShards) else shard_put(x, self.shard)

    def _sharded_step(self, method: str, state: RowShards, x, generator, props, draws,
                      n: int, draw_kw: dict):
        """``method`` run by every row on its rows of ``x`` and ``state``.
        Missing draws are made for the whole batch on the first device
        (``n`` points per stream), exactly as the unsharded step makes
        them, then split.  Nothing here waits for a device, so rows on
        different cards run at once.  Returns the per-row states and the
        outputs gathered on the mesh's first device."""
        rows = self._split(x)
        if draws is None:
            lead = (sum(leaves(r)[0].shape[0] for r in rows),)
            draws = tuple(
                None if est.draw is None
                else est.draw(generator, lead, n, self.device, **draw_kw)
                for est in self.estimators
            )
        results = [getattr(row, method)(s, xr, props=props, draws=d)
                   for row, s, xr, d in zip(self._rows, state, rows, self._split(draws))]
        return (RowShards(r[0] for r in results),
                gather(RowShards(r[1] for r in results), self.shard))

    def gather_state(self, state) -> StreamState:
        """A sharded pipeline's per-row state as one :class:`StreamState`
        on the mesh's first device (the state itself when unsharded)."""
        return gather(state, self.shard) if self._rows else state

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

    def scan_flow(
        self, state: StreamState, sparse_seq: SparseFlow,
        generator: Optional[torch.Generator] = None, draws=None,
    ) -> Tuple[StreamState, List[StreamOutputs]]:
        """Process a (T, B, N) :class:`SparseFlow` sequence in order;
        returns the final state and the per-frame outputs.  ``draws``:
        optional per-frame list of :meth:`step_from_flow`'s ``draws``."""
        outs = []
        for t in range(sparse_seq.mask.shape[0]):
            flow = SparseFlow(sparse_seq.pos[t], sparse_seq.motion[t], sparse_seq.mask[t])
            state, out = self.step_from_flow(
                state, flow, generator, draws=None if draws is None else draws[t])
            outs.append(out)
        return state, outs

