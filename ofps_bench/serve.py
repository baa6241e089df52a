"""The two served paths a cell drives, by its configuration's ``input``.

* ``codec_mvec``: ``ofps_torch.apps.batch.run_batch`` over B streams.  The
  streams come from a decoder that the harness registers through the port's
  decoder registry, as a user's plugin would: it replays each stream's
  ``.mvec`` bank through the port's ``MvecDecoder`` (the parse is the
  program's), cycles it, and ends every stream once the window has closed.
  Each frame it hands out stamps the harness's step clock when the program
  first reads its vectors (``frame.pos``): that is the step's start, and,
  the loop being closed with ``fetch_lag`` 0, the end of the step before.
* ``frames``: ``ofps_torch.pipeline.runtime.LivePipeline.step`` over B
  streams of gray frames.  Each step's (B, H, W) uint8 frames go from pinned
  host memory to the card in one non-blocking copy and are made float32
  there; then the step, and its poses, deltas and verdicts are copied to
  pinned host memory and waited for.  The harness's clock runs from before
  the upload to after that wait.

Each returns a :class:`Served`: the window's step times, what the window
produced, and what the check needs; ``outputs["result"]`` is the program's
whole result (``run_batch``'s ``BatchResult``; the frames path's fetched
records, one a step), for the check files a configuration brings.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ofps_bench import inputs, trace

DECODER = "ofps_bench_bank"


class Served(NamedTuple):
    step_s: List[float]  # host-clock seconds of each window step
    window_s: float
    frames: int  # stream-frames whose results reached host memory in the window
    t_open: float  # perf_counter of the first timed step's start
    window: range  # step indices of the window
    perf: Dict[str, List[float]]  # per-layer host times of the steps before any trace, s
    counters: Dict[str, float]
    timeline: Optional[trace.Timeline]
    outputs: Dict[str, Any]  # what the check reads (host arrays, held tensors)
    failed: int  # window stream-frames whose poses are not finite
    traced: range  # the window steps the profiler traced

    def untraced_step_s(self) -> List[float]:
        """Host-clock seconds of the window steps before the profiler
        started (all of them where nothing was traced)."""
        pre = before_trace(self.window, self.traced)
        return [dt for t, dt in zip(self.window, self.step_s) if t in pre]

    def after_trace_step_s(self) -> List[float]:
        """Host-clock seconds of the window steps after the profiler stopped."""
        return [dt for t, dt in zip(self.window, self.step_s)
                if len(self.traced) and t > self.traced.stop]


def before_trace(window: range, traced: range) -> range:
    """The window steps before the one the profiler starts in (the whole
    window where nothing was traced).  The profiler slows the process after
    it stops too, so a traced run's host times are read from these."""
    return range(window.start, traced.start - 1) if len(traced) else window


# -- the codec path -----------------------------------------------------------


class StepClock:
    """Step starts on the harness's clock, stamped from the main thread."""

    def __init__(self, warmup: int, seconds: float, tracer=None):
        self.warmup, self.seconds = warmup, seconds
        self.takes: List[float] = []
        self.t_open: Optional[float] = None
        self.closed = False
        self.close_step: Optional[int] = None
        self.tracer = tracer

    def take(self, step: int) -> None:
        if step < len(self.takes):
            return
        now = time.perf_counter()
        self.takes.append(now)
        if step == self.warmup:
            self.t_open = now
        elif self.t_open is not None and not self.closed and now - self.t_open >= self.seconds:
            self.closed = True
            self.close_step = step
        if self.tracer is not None:
            self.tracer.at_step(step, now, self.t_open, self.closed)


class Tracer:
    """Starts the profiler at the first step past ``at`` of the window and
    stops it ``steps`` steps after the next one (or where the window
    closes), marking each step."""

    def __init__(self, seconds: float, steps: int, at: float = 0.3):
        self.seconds, self.steps, self.at = seconds, steps, at
        self.prof = None
        self.first: Optional[int] = None  # the first traced step
        self.timeline: Optional[trace.Timeline] = None
        self._done = False
        self._last: Optional[int] = None
        self._ranges = trace.StepRanges()

    def at_step(self, step: int, now: float, t_open: Optional[float], closed: bool) -> None:
        if self._done or t_open is None:
            return
        if self.prof is None:
            if now - t_open >= self.at * self.seconds and not closed:
                self.prof = trace.profiler()
                self.prof.start()
                self.first = step + 1
            return
        if step == self.first + self.steps or closed:
            self._ranges.close()
            self.prof.stop()
            self._done = True
            self._last = step
        elif step >= self.first:
            self._ranges.next()

    def traced(self) -> range:
        return range(self.first, self._last) if self._done else range(0)

    def finish(self) -> Optional[trace.Timeline]:
        """The timeline of the traced steps (None where none was traced)."""
        if self.prof is not None and not self._done:  # the streams ended first
            self._ranges.close()
            self.prof.stop()
            self._done, self._last = True, self.first
        if len(self.traced()) and self.timeline is None:
            self.timeline = trace.read_trace(self.prof)
        self.prof = None
        return self.timeline


def _stamped_frame_type():
    from ofps_torch.decoders.base import DecodedFrame

    class StampedFrame(DecodedFrame):
        """A decoded frame that stamps its step on the clock when its
        vectors are first read."""

        def __init__(self, frame, clock: StepClock, step: int):
            self._pos, self.motion, self.has_mvs, self.frame = (
                frame.pos, frame.motion, frame.has_mvs, None)
            self._clock, self._step = clock, step

        @property
        def pos(self):
            self._clock.take(self._step)
            return self._pos

    return StampedFrame


def _register_bank_decoder(clock: StepClock) -> None:
    from ofps_torch.decoders.base import register
    from ofps_torch.decoders.mvec import MvecDecoder

    stamped = _stamped_frame_type()

    class BankDecoder:
        def __init__(self, input_path: str):
            self._path = input_path
            self._mvec = MvecDecoder(input_path)
            self._step = 0

        def process_frame(self, want_frame: bool = False, skip: int = 0):
            if clock.closed:
                self._mvec.close()
                return None
            frame = self._mvec.process_frame()
            if frame is None:  # the bank's end: its first frame, an I-frame, again
                self._mvec.close()
                self._mvec = MvecDecoder(self._path)
                frame = self._mvec.process_frame()
            step, self._step = self._step, self._step + 1
            return stamped(frame, clock, step)

        def get_framerate(self):
            return None

        def get_aspect(self):
            return None

    register(DECODER)(BankDecoder)


def _write_gt(path: Path, truth: np.ndarray, fov: float) -> None:
    """The ground-truth CSV of one bank cycle (integrated rotations)."""
    acc = np.array([1.0, 0.0, 0.0, 0.0])
    lines = ["frame,fov_x,fov_y,rot_w,rot_i,rot_j,rot_k,pos_x,pos_y,pos_z"]
    for t, q in enumerate(truth):
        w1, x1, y1, z1 = q
        w2, x2, y2, z2 = acc
        acc = np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])
        lines.append(",".join(str(v) for v in [t + 1, fov, fov, *acc, 0.0, 0.0, 0.0]))
    path.write_text("\n".join(lines) + "\n")


def serve_codec(cell, seed: int, seconds: float, tracing: bool, device) -> Served:
    from ofps_torch.apps.batch import run_batch
    from ofps_torch.detectors.base import create_detector

    cfg, tr = cell.config, cell.traffic
    det = cfg.get("detector")
    if det and create_detector(det["name"], **det.get("properties", {})).params != \
            create_detector(det["name"]).params:
        raise ValueError("run_batch takes a detector by name: its properties must be the defaults")
    b = tr["streams"]
    bank = inputs.codec_bank(seed, b, cfg, tr)
    tracer = Tracer(seconds, tr["trace_steps"]) if tracing else None
    clock = StepClock(tr["warmup_steps"], seconds, tracer)
    _register_bank_decoder(clock)
    with tempfile.TemporaryDirectory(prefix="ofps_bench_") as tmp:
        paths, gts = [], []
        for s in range(b):
            paths.append(str(Path(tmp) / f"s{s}.mvec"))
            gts.append(str(Path(tmp) / f"s{s}_gt.csv"))
            inputs.write_mvec(Path(paths[-1]), bank.pos[s], bank.motion[s])
            _write_gt(Path(gts[-1]), bank.truth[s], cfg["camera"]["fov_y"])
        inputs_done = time.perf_counter()
        res = run_batch(
            paths,
            estimators=cfg["estimators"],
            detector=det["name"] if det else None,
            camera_aspect=cfg["camera"]["aspect"],
            camera_fov_y=cfg["camera"]["fov_y"],
            decoder_plugin=DECODER,
            capacity=cfg["capacity"],
            seed=seed,
            ground_truths=gts,
            fetch_lag=cfg["fetch_lag"],
            device=device,
        )
    if clock.close_step is None:
        raise RuntimeError("the window never closed: the streams ended first")
    names = [e["name"] for e in cfg["estimators"]]
    if res.estimator_names != names:
        raise RuntimeError(f"run_batch ran the estimators {res.estimator_names}; "
                           f"the configuration states {names}")
    w = range(clock.warmup, clock.close_step)
    takes = clock.takes
    step_s = [takes[t + 1] - takes[t] for t in w]
    timeline = tracer.finish() if tracer else None
    traced = tracer.traced() if tracer else range(0)
    perf = {stage: [res.perf.stages[stage][t] for t in before_trace(w, traced)]
            for stage in ("decode", "upload", "step", "fetch") if stage in res.perf.stages}
    rot = [np.stack(r) for r in res.rot_hist]  # per estimator (T, B, 4)
    delta = [np.stack(d) for d in res.delta_rot]
    failed = sum(int((~np.isfinite(r[w.start:w.stop]).all(-1)).sum()) for r in rot)
    return Served(
        step_s=step_s,
        window_s=takes[clock.close_step] - clock.t_open,
        frames=len(w) * b,
        t_open=clock.t_open,
        window=w,
        perf=perf,
        counters={"graph_replays_per_step": res.graph_replays / res.frames,
                  "eager_runs_per_step": res.eager_runs / res.frames,
                  "valid_vectors_per_step": float(res.vectors[w.start:w.stop].sum() / len(w)),
                  "gt_err_deg_mean": float(np.degrees(np.mean(
                      [v[0] for v in res.gt_avg_err.values()]))) if res.gt_avg_err else None,
                  "stamps": {"inputs": inputs_done, "first_step": takes[0],
                             "second_step": takes[1]}},
        timeline=timeline,
        outputs={"bank": bank, "rot": rot, "delta": delta, "detected": res.detections,
                 "vectors": res.vectors, "result": res},
        failed=failed,
        traced=traced,
    )


# -- the frames path ----------------------------------------------------------


def _live(cfg, batch: int, device):
    """The configuration's serving pipeline, running with its per-frame
    properties on the device."""
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.detectors.base import create_detector
    from ofps_torch.estimators.base import create_estimator
    from ofps_torch.parallel.stream import StreamPipeline
    from ofps_torch.pipeline.runtime import LivePipeline

    det = cfg.get("detector")
    pipe = StreamPipeline(
        StandardCamera.create(cfg["camera"]["aspect"], cfg["camera"]["fov_y"]),
        [create_estimator(e["name"], **e.get("properties", {})) for e in cfg["estimators"]],
        create_detector(det["name"], **det.get("properties", {})) if det else None,
        emit_dense_flow=False,
        device=device,
    )
    return LivePipeline(pipe, batch=batch, height=cfg["height"], width=cfg["width"])


class _Fetcher:
    """Pinned host copies of a step's poses, deltas and verdicts; ``fetch``
    returns a step's record: per estimator its rotation, position and delta
    (host arrays), and the verdicts."""

    def __init__(self, n_est: int, b: int, device):
        cuda = torch.device(device).type == "cuda"
        self.cuda = cuda
        mk = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, pin_memory=cuda)  # noqa: E731
        self.rot = [mk(b, 4) for _ in range(n_est)]
        self.pos = [mk(b, 3) for _ in range(n_est)]
        self.delta = [mk(b, 4) for _ in range(n_est)]
        self.det = mk(b, dt=torch.bool)

    def fetch(self, out):
        for dst, src in ((self.rot, out.rot), (self.pos, out.pos), (self.delta, out.delta_rot)):
            for d, s in zip(dst, src):
                d.copy_(s, non_blocking=self.cuda)
        if out.detection is not None:
            self.det.copy_(out.detection.detected, non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        return {"rot": [r.numpy().copy() for r in self.rot],
                "pos": [p.numpy().copy() for p in self.pos],
                "delta": [d.numpy().copy() for d in self.delta],
                "detected": self.det.numpy().copy()}


def serve_frames(cell, seed: int, seconds: float, tracing: bool, device) -> Served:
    from torch.autograd.profiler import record_function

    cfg, tr = cell.config, cell.traffic
    b, n_bank = tr["streams"], tr["bank_frames"]
    dev = torch.device(device)
    bank = inputs.frames_bank(seed, b, cfg, tr, dev)
    inputs_done = time.perf_counter()
    live = _live(cfg, b, dev)
    pipe = live.pipe
    gen = torch.Generator(device=dev).manual_seed(seed)
    fetcher = _Fetcher(len(pipe.estimators), b, dev)
    records, step_s, enq_s = [], [], []
    held: Dict[int, Dict[str, Any]] = {}
    hold: set = set()
    tracer_prof, traced = None, range(0)
    timeline = None

    ranges = trace.StepRanges()

    def step(t: int, marked: bool):
        t0 = time.perf_counter()
        if marked:
            ranges.next()
        before = live.state
        with record_function("ofps_bench.upload"):
            frame = bank[inputs.bank_index(t, n_bank)].to(dev, non_blocking=True).to(torch.float32)
        te = time.perf_counter()
        state, out = live.step(frame, gen)
        enq = time.perf_counter() - te
        with record_function("ofps_bench.fetch"):
            records.append(fetcher.fetch(out))
        t1 = time.perf_counter()
        if t in hold:
            held[t] = {"warm_in": before.warm_uv, "grid": out.grid, "warm_out": state.warm_uv}
        return t1 - t0, enq

    warm = tr["warmup_steps"]
    checks = tr["check_steps"]
    # Warm-up: the capture, then as many held steps as the window will hold,
    # so that the allocator has the blocks they take before the window.
    hold = set(range(warm + checks))
    stamps = {"inputs": inputs_done}
    for t in range(warm + checks):
        if t < 2:
            stamps[("first_step", "second_step")[t]] = time.perf_counter()
        last, _ = step(t, False)
    held = {t: v for t, v in held.items() if t < 2}  # the start: no warm, then the first flow
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    w0 = warm + checks
    # The checked window steps, drawn from the seed among the steps the
    # window is expected to reach (from the last warm-up step's time).
    expect = max(checks, int(0.8 * seconds / max(last, 1e-3)))
    rng = np.random.default_rng([seed, 7])
    hold = {w0 + int(i) for i in rng.choice(expect, size=min(checks, expect), replace=False)}
    t_open = time.perf_counter()
    t = w0
    trace_from = None
    while True:
        if tracing and tracer_prof is None and time.perf_counter() - t_open >= 0.3 * seconds:
            tracer_prof = trace.profiler()
            tracer_prof.start()
            trace_from = t + 1
        marked = trace_from is not None and trace_from <= t <= trace_from + tr["trace_steps"]
        if marked and t == trace_from + tr["trace_steps"]:
            ranges.close()
            tracer_prof.stop()
            traced = range(trace_from, t)
            trace_from = None
            marked = False
        dt, enq = step(t, marked)
        step_s.append(dt)
        enq_s.append(enq)
        t += 1
        if time.perf_counter() - t_open >= seconds:
            break
    window_s = time.perf_counter() - t_open
    if trace_from is not None:  # the window closed while tracing
        ranges.close()
        tracer_prof.stop()
        traced = range(trace_from, t) if t > trace_from else range(0)
    w = range(w0, t)
    if tracer_prof is not None and len(traced):
        timeline = trace.read_trace(tracer_prof)
    tracer_prof = None
    n_est = len(pipe.estimators)
    rot = [np.stack([r["rot"][e] for r in records]) for e in range(n_est)]  # (T, B, 4)
    delta = [np.stack([r["delta"][e] for r in records]) for e in range(n_est)]
    return Served(
        step_s=step_s,
        window_s=window_s,
        frames=len(w) * b,
        t_open=t_open,
        window=w,
        perf={"enqueue": [enq_s[i - w0] for i in before_trace(w, traced)]},
        counters={"graph_replays_per_step": pipe.graph_replays / t,
                  "eager_runs_per_step": pipe.eager_runs / t, "stamps": stamps},
        timeline=timeline,
        outputs={"bank": bank, "rot": rot, "delta": delta,
                 "detected": np.stack([r["detected"] for r in records]), "held": held,
                 "result": records},
        failed=sum(int((~np.isfinite(r[w0:t]).all(-1)).sum()) for r in rot),
        traced=traced,
    )


SERVE = {"codec_mvec": serve_codec, "frames": serve_frames}
