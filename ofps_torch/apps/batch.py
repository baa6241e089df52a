"""Multi-stream batch runner (port of ``ofps_tpu.apps.batch``): N motion
vector streams through one batched device step.

Each input is decoded on its own host thread (one frame of lookahead,
:class:`~ofps_torch.pipeline.runtime.DecoderFeed`); per step the B frames
are packed into one pinned host buffer, padded to ``capacity`` vectors,
uploaded with one copy, and fed as a (B, capacity) :class:`SparseFlow` to
:meth:`StreamPipeline.step_from_flow`, whose estimators (masked RANSAC)
and detector replay as one CUDA graph on the card.  With ``shardings``
each mesh row has its own buffers, uploaded to the row's device, and its
own graph.

Besides its four stages, each step is a ``step`` span of the run's
:class:`~ofps_torch.pipeline.runtime.PerfStats`, opened before the decode
wait, holding ``upload.wait`` and ``upload.pack`` (:class:`FlowUploader`)
and the pipeline's own spans; ``decode.work`` beside it is the slowest
feed's parse of the step's frame, on its feed thread.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import SparseFlow, pack_entries
from ofps_torch.decoders.base import DecodedFrame, create_decoder
from ofps_torch.detectors.base import create_detector
from ofps_torch.estimators.base import create_estimator
from ofps_torch.parallel.sharding import RowShards, StreamSharding
from ofps_torch.parallel.stream import StreamPipeline
from ofps_torch.pipeline.runtime import DecoderFeed, PerfStats

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class BatchResult:
    frames: int  # batched steps executed
    streams: int
    poses_rot: List[np.ndarray]  # per estimator: (B, 4) final integrated
    poses_pos: List[np.ndarray]
    detections: Optional[np.ndarray]  # (T, B) bool, if a detector ran
    perf: PerfStats  # stages "decode", "upload" (pack + copy), "step", "fetch" (host clock)
    # (T, B) bool: stream had a live frame at step t (False once ended,
    # when drop_ended keeps the batch going).
    active: Optional[np.ndarray] = None
    estimator_names: List[str] = dataclasses.field(default_factory=list)
    # Per-frame history, recorded when GT evaluation is requested:
    # delta_rot[e][t]: (B, 4); rot_hist[e][t]: (B, 4); delta_tr[e][t]:
    # (B, 3), the step's translation.
    delta_rot: Optional[List[List[np.ndarray]]] = None
    rot_hist: Optional[List[List[np.ndarray]]] = None
    # (stream_idx, estimator_name) -> (avg_err, avg_r, avg_p, avg_y) rad.
    gt_avg_err: Optional[Dict] = None
    # (T, B) int: the valid vectors each stream fed each step (after
    # truncation to the capacity).
    vectors: Optional[np.ndarray] = None
    # How the consumers ran: CUDA-graph replays and eager calls.
    graph_replays: int = 0
    eager_runs: int = 0
    delta_tr: Optional[List[List[np.ndarray]]] = None

    def throughput_fps(self) -> float:
        """Stream-frames a second over the loop's time: the totals of the
        four stages (decode wait, upload, step enqueue, fetch) summed."""
        total = sum(s["total_ms"] for s in self.perf.summary().values()) / 1e3
        return self.frames * self.streams / total if total else 0.0

    def motion_ranges(self, stream: int):
        """Per-stream (first, last) step ranges of detected motion."""
        if self.detections is None:
            return []
        det = self.detections[:, stream]
        if self.active is not None:
            det = det & self.active[:, stream]
        out, start = [], None
        for t, d in enumerate(det):
            if d and start is None:
                start = t
            elif not d and start is not None:
                out.append((start, t - 1))
                start = None
        if start is not None:
            out.append((start, len(det) - 1))
        return out


class FlowUploader:
    """Packs B decoded frames into a pinned (B, capacity, 5) host buffer
    (``core.motion.pack_entries``: the rows of ``SparseFlow.from_arrays``,
    padded, or truncated to the capacity) and uploads it with one
    non-blocking copy.  Two buffers take turns; a buffer is refilled only
    after its last copy has finished.  Given a recorder, :meth:`pack` is two
    spans of it: ``upload.wait`` (for the buffer's last copy) and
    ``upload.pack`` (zero-fill and packing)."""

    def __init__(self, batch: int, capacity: int, device, perf: Optional[PerfStats] = None):
        self.device = torch.device(device)
        self.perf = perf
        pin = self.device.type == "cuda"
        self._bufs = [torch.zeros((batch, capacity, 5), pin_memory=pin) for _ in range(2)]
        self._done = [None, None]
        self._turn = 0

    def pack(self, frames: Sequence[Optional[DecodedFrame]]) -> np.ndarray:
        """Fill the next buffer from ``frames`` (None: an empty stream);
        returns the valid vectors per stream."""
        i = self._turn
        span = self.perf.span if self.perf is not None else _no_span
        with span("upload.wait"):
            if self._done[i] is not None:
                self._done[i].synchronize()
        with span("upload.pack"):
            host = self._bufs[i].numpy()
            host.fill(0.0)
            return np.array([0 if f is None else pack_entries(f.pos, f.motion, host[b])
                             for b, f in enumerate(frames)], np.int64)

    def upload(self) -> SparseFlow:
        """The buffer :meth:`pack` filled, on the device."""
        i = self._turn
        self._turn = 1 - i
        if self.device.type == "cuda":
            dev = self._bufs[i].to(self.device, non_blocking=True)
            self._done[i] = torch.cuda.Event()
            self._done[i].record(torch.cuda.current_stream(self.device))
        else:
            dev = self._bufs[i].clone()
        return SparseFlow(dev[..., 0:2], dev[..., 2:4], dev[..., 4])


def _no_span(name: str):
    return contextlib.nullcontext()


class _Fetch:
    """Device tensors copied to the host without blocking, and on CUDA an
    event after the step; ``get`` waits for it and returns numpy arrays."""

    def __init__(self, tensors: Sequence[torch.Tensor], device: torch.device):
        cuda = device.type == "cuda"
        self._host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            h.copy_(t, non_blocking=cuda)
            self._host.append(h)
        self._event = torch.cuda.Event() if cuda else None
        if cuda:
            self._event.record(torch.cuda.current_stream(device))

    def get(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def run_batch(
    inputs: List[str],
    estimators: Optional[List[Dict[str, Any]]] = None,
    detector: Optional[str] = "block_motion",
    camera_aspect: float = 16.0 / 9.0,
    camera_fov_y: float = 90.0,
    decoder_plugin: Optional[str] = None,
    capacity: int = 16384,
    max_frames: Optional[int] = None,
    seed: int = 0,
    ground_truths: Optional[List[Optional[str]]] = None,
    stats_csv_prefix: Optional[str] = None,
    drop_ended: bool = False,
    fetch_lag: int = 0,
    device="cuda",
    shardings: Optional[StreamSharding] = None,
) -> BatchResult:
    """Run every input stream in lockstep through one batched step on
    ``device`` (default the CUDA card; raises where there is none), or on
    the mesh of ``shardings``: the streams split over its rows in order,
    each row packed and uploaded to its own device, the results fetched
    from the mesh's first device.

    Lockstep means processing stops at the SHORTEST stream: when any input
    ends, the remaining frames of longer streams are not processed (a log
    line reports which stream ended the batch).  ``drop_ended=True`` keeps
    the batch running after individual streams end, or fail to decode: an
    ended stream feeds an empty (all-masked) flow, so its pose freezes and
    its detector goes quiet, while live streams continue until all end.

    ``ground_truths``: optional per-stream GT CSV paths (None entries skip
    a stream); per-stream, per-estimator error statistics are computed on
    the host (:mod:`ofps_torch.apps.gt`) and written to
    ``{stats_csv_prefix}s{stream}_{estimator}.csv`` when a prefix is given.

    ``fetch_lag``: results are copied to the host without blocking and
    read ``fetch_lag`` steps later, so the host decodes and enqueues the
    next steps while the device works (0: read after every step).  The
    RANSAC draws come from a generator on the device seeded with ``seed``.
    """
    ests = [
        create_estimator(e["name"], **(e.get("properties") or {}))
        for e in (estimators or [{"name": "almeida"}])
    ]
    det = create_detector(detector) if detector else None
    camera = StandardCamera.create(camera_aspect, camera_fov_y)
    perf = PerfStats()
    pipe = StreamPipeline(camera=camera, estimators=ests, detector=det, device=device,
                          shardings=shardings, perf=perf)
    dev = pipe.device
    b = len(inputs)
    state = pipe.init_state(b, 1, 1)
    generator = torch.Generator(device=dev).manual_seed(seed)
    mesh = shardings.mesh if shardings is not None else None
    row_devices = ([mesh.row_device(r) for r in range(mesh.shape["stream"])]
                   if mesh is not None else [dev])
    nb = b // len(row_devices)
    uploaders = [FlowUploader(nb, capacity, d, perf) for d in row_devices]

    feeds = [DecoderFeed(create_decoder(path, decoder_plugin)) for path in inputs]
    iters = [iter(f) for f in feeds]
    detections: List[np.ndarray] = []
    want_gt = ground_truths is not None and any(ground_truths)
    dr_hist: List[List[np.ndarray]] = [[] for _ in ests]
    rot_hist: List[List[np.ndarray]] = [[] for _ in ests]
    tr_hist: List[List[np.ndarray]] = [[] for _ in ests]
    active_hist: List[List[bool]] = []
    vectors: List[np.ndarray] = []
    frames = 0
    pending: "collections.deque" = collections.deque()

    def _drain(fetch: _Fetch):
        got = fetch.get()
        if want_gt:
            for e in range(len(ests)):
                dr_hist[e].append(got[3 * e])
                rot_hist[e].append(got[3 * e + 1])
                tr_hist[e].append(got[3 * e + 2])
        if det is not None:
            detections.append(got[-1])

    try:
        while max_frames is None or frames < max_frames:
            with perf.span("step", step=frames):
                with perf.time("decode"):
                    batch = []
                    for si, it in enumerate(iters):
                        try:
                            batch.append(next(it, None))
                        except Exception:
                            # Stream-level fault isolation under drop_ended: a
                            # failing decoder ends its stream, the batch lives
                            # on.  Strict lockstep re-raises.
                            if not drop_ended:
                                raise
                            _LOG.exception(
                                "run_batch: stream %s failed at frame %d; "
                                "dropping it (drop_ended)", inputs[si], frames
                            )
                            batch.append(None)
                            iters[si] = iter(())
                    live = [f is not None for f in batch]
                    if not all(live) and not (drop_ended and any(live)):
                        if any(live):
                            _LOG.info(
                                "run_batch: stream(s) %s ended at frame %d; longer "
                                "streams are truncated (lockstep batch; pass "
                                "drop_ended=True to continue)",
                                [inputs[i] for i, f in enumerate(batch) if f is None],
                                frames,
                            )
                        break
                    active_hist.append(live)
                # The slowest feed's parse of this step's frame, on its
                # feed thread (it overlapped the steps before).
                slow = max((f for f in batch if f is not None), key=lambda f: f.decode_time)
                perf.record("decode.work", slow.decode_start,
                            slow.decode_start + slow.decode_time)
                # The pack waits until its buffer's previous copy is done, so it
                # is the upload's cost (and the card's back-pressure), not the
                # decode's: "decode" is only the wait on the decoder feeds.
                with perf.time("upload"):
                    vectors.append(np.concatenate([
                        up.pack(batch[r * nb : (r + 1) * nb]) for r, up in enumerate(uploaders)]))
                    flows = [up.upload() for up in uploaders]
                    flow = flows[0] if mesh is None else RowShards(flows)
                with perf.time("step"):
                    state, out = pipe.step_from_flow(state, flow, generator)
                    wanted = []
                    if want_gt:
                        for e in range(len(ests)):
                            wanted += [out.delta_rot[e], out.rot[e], out.delta_tr[e]]
                    if det is not None:
                        wanted.append(out.detection.detected)
                    pending.append(_Fetch(wanted, dev))
                if len(pending) > fetch_lag:
                    with perf.time("fetch"):
                        _drain(pending.popleft())
            frames += 1
        while pending:
            with perf.time("fetch"):
                _drain(pending.popleft())
    finally:
        for f in feeds:
            f.stop()

    gt_avg = None
    if want_gt:
        from ofps_torch.apps import gt as gtmod

        gt_avg = {}
        for si, gt_path in enumerate(ground_truths):
            if not gt_path:
                continue
            truth = gtmod.load_ground_truth(gt_path)
            for e, est in enumerate(ests):
                transforms = [dr_hist[e][t][si] for t in range(frames)]
                poses = [rot_hist[e][t][si] for t in range(frames)]
                gt_avg[(si, est.name)] = gtmod.calc_avg_err(truth, transforms)
                if stats_csv_prefix:
                    gtmod.write_stats_csv(
                        f"{stats_csv_prefix}s{si}_{est.name}.csv",
                        gtmod.calc_err(truth, transforms),
                        gtmod.pose_stats(transforms, poses),
                    )

    state = pipe.gather_state(state)
    return BatchResult(
        frames=frames,
        streams=b,
        poses_rot=[r.cpu().numpy() for r in state.rot],
        poses_pos=[p.cpu().numpy() for p in state.pos],
        detections=np.stack(detections) if detections else None,
        perf=perf,
        active=np.asarray(active_hist, bool) if active_hist else None,
        estimator_names=[e.name for e in ests],
        delta_rot=dr_hist if want_gt else None,
        rot_hist=rot_hist if want_gt else None,
        gt_avg_err=gt_avg,
        vectors=np.stack(vectors) if vectors else None,
        graph_replays=pipe.graph_replays,
        eager_runs=pipe.eager_runs,
        delta_tr=tr_hist if want_gt else None,
    )
