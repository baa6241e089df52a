"""Host-side streaming runtime (port of ``ofps_tpu.pipeline.runtime``):
decoder feed, perf stats, realtime pacing and a running pipeline with
runtime-mutable properties.

* :class:`DecoderFeed` runs a decoder on its own thread with exactly one
  frame of lookahead, as the reference's decoder thread does.
* :class:`PerfStats` keeps per-stage wall-clock times and their CSV export.
* :class:`RealtimeTimer` paces ticks at 1/framerate.
* :class:`LivePipeline` steps a ``StreamPipeline`` with its per-frame
  properties held as 0-d device tensors.
"""

from __future__ import annotations

import csv
import queue
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch

from ofps_torch.core.properties import set_properties
from ofps_torch.decoders.base import DecodedFrame, Decoder


class DecoderFeed:
    """Runs ``decoder.process_frame`` on a worker thread, 1-frame lookahead.

    Iterating yields :class:`DecodedFrame` items until end of stream.  The
    bounded queue of size 1 gives the reference's rendezvous-channel
    semantics: decode of frame N+1 overlaps consumption of frame N, never
    more.  A decoder error is raised on the consumer side.
    """

    _END = object()

    def __init__(self, decoder: Decoder, want_frames: bool = False):
        self._decoder = decoder
        self._want_frames = want_frames
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that re-checks the stop flag; False if stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                frame = self._decoder.process_frame(self._want_frames)
                dt = time.perf_counter() - t0
                if frame is None:
                    break
                if not self._put((frame, dt)):
                    return  # consumer stopped early; don't block forever
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            if not self._put(self._END):
                # Stopped: nobody is iterating, but leave the sentinel if a
                # slot is free so a racing __iter__ terminates cleanly.
                try:
                    self._q.put_nowait(self._END)
                except queue.Full:
                    pass

    def __iter__(self) -> Iterator[DecodedFrame]:
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return
            frame, decode_time = item
            frame.decode_time = decode_time  # type: ignore[attr-defined]
            yield frame

    def stop(self):
        """Stop the feed and join the worker without leaking it.

        Drains the queue in a loop (not a single get): the worker may be
        blocked on the data put *and then* on the ``_END`` put, so one drain
        is not enough.
        """
        self._stop.set()
        deadline = time.perf_counter() + 5.0
        while self._thread.is_alive() and time.perf_counter() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class PerfStats:
    """Per-stage wall-clock statistics (host clock) with the reference's
    CSV export."""

    def __init__(self):
        self.stages: Dict[str, List[float]] = {}

    @contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def add(self, stage: str, seconds: float):
        self.stages.setdefault(stage, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {total_ms, avg_ms, frames}}."""
        out = {}
        for stage, xs in self.stages.items():
            total = sum(xs)
            out[stage] = {
                "total_ms": total * 1e3,
                "avg_ms": total * 1e3 / max(len(xs), 1),
                "frames": len(xs),
            }
        return out

    def write_csv(self, path: str):
        """Per-frame times in ms, one column per stage (sorted), the
        reference's CSV layout."""
        stages = sorted(self.stages)
        rows = max((len(self.stages[s]) for s in stages), default=0)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["frame"] + stages)
            for i in range(rows):
                w.writerow(
                    [i]
                    + [
                        f"{self.stages[s][i] * 1e3:.4f}"
                        if i < len(self.stages[s])
                        else ""
                        for s in stages
                    ]
                )


class RealtimeTimer:
    """Sleeps so consecutive ticks land 1/rate apart."""

    def __init__(self, rate: Optional[float]):
        self._dt = 1.0 / rate if rate else None
        self._next = time.perf_counter()

    def tick(self):
        if self._dt is None:
            return
        self._next += self._dt
        delay = self._next - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        else:  # fell behind; resynchronize
            self._next = time.perf_counter()


class LivePipeline:
    """A running pipeline whose plugins' per-frame properties can change
    between frames.

    The continuous-valued properties (``StreamPipeline.dyn_props``) are
    kept as 0-d float32 tensors on the pipeline's device and passed to
    every step, so ``set_property`` is one device write, the next step
    sees it, and the consumers' CUDA graph is not captured again; the
    shape-affecting properties stay constructor arguments.

    >>> live = LivePipeline(pipe, batch=8, height=1, width=1, from_flow=True)
    >>> state, out = live.step(flow, generator)
    >>> live.set_property("detector", "target_motion", 0.005)
    >>> state, out = live.step(flow2, generator)     # same graph
    """

    def __init__(self, pipe, batch: int, height: int, width: int,
                 from_flow: bool = False):
        self.pipe = pipe
        dev = pipe.device
        props = pipe.dyn_props()
        self.props = {
            "estimators": tuple(_device_props(d, dev) for d in props["estimators"]),
            "detector": _device_props(props["detector"], dev),
        }
        self.state = pipe.init_state(batch, height, width)
        self._step = pipe.step_from_flow if from_flow else pipe.step_from_frames

    def _names(self):
        return [e.name for e in self.pipe.estimators]

    def set_property(self, target, name: str, value) -> bool:
        """Set a property on a running component; True when it was applied
        to the running pipeline.

        ``target``: "detector", an estimator name, or an estimator index.
        Unknown names and kind mismatches raise (``core.properties.
        set_properties``, which also clamps to the declared bounds); a known
        but static (shape-affecting) property returns False: the pipeline
        must be rebuilt for it.
        """
        if target == "detector":
            comp = self.pipe.detector
            dyn = self.props["detector"]
        else:
            idx = target if isinstance(target, int) else self._names().index(target)
            comp = self.pipe.estimators[idx]
            dyn = self.props["estimators"][idx]
        validated = set_properties(comp.name, comp.params, {name: value})
        if name not in dyn:
            return False
        dyn[name].fill_(float(getattr(validated, name)))
        return True

    def step(self, frame_or_flow, generator: Optional[torch.Generator] = None):
        self.state, out = self._step(
            self.state, frame_or_flow, generator, props=self.props
        )
        return self.state, out


def _device_props(d: dict, device) -> dict:
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device) for k, v in d.items()}
