"""Host-side streaming runtime (port of ``ofps_tpu.pipeline.runtime``):
decoder feed, perf stats, realtime pacing and a running pipeline with
runtime-mutable properties.

* :class:`DecoderFeed` runs a decoder on its own thread with exactly one
  frame of lookahead, as the reference's decoder thread does.
* :class:`PerfStats` keeps per-stage wall-clock times and their CSV export,
  and the program's spans: host times on ``time.perf_counter`` and, around
  device work, CUDA-event times; :func:`last_perf` finds the recorder of
  the newest top-level ``StreamPipeline``.
* :class:`RealtimeTimer` paces ticks at 1/framerate.
* :class:`LivePipeline` steps a ``StreamPipeline`` with its per-frame
  properties held as 0-d device tensors.
"""

from __future__ import annotations

import collections
import csv
import queue
import statistics
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Optional

import torch

from ofps_torch.core.properties import set_properties
from ofps_torch.decoders.base import DecodedFrame, Decoder
from ofps_torch.pipeline.graphs import device_props


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
                if not self._put((frame, t0, dt)):
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
            frame, start, decode_time = item
            frame.decode_start = start  # type: ignore[attr-defined]
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


class Span:
    """One timed interval of a step.

    ``step``: the index of the step it belongs to (shared by the step's
    spans); ``parent``: the span it ran inside (None at a root); ``row``:
    the mesh row of a sharded pipeline that recorded it (None outside
    one); ``start``, ``end``: ``time.perf_counter`` seconds; ``device_ms``:
    the CUDA-event time of the device work enqueued inside it, where one
    was asked for and has been read (:meth:`PerfStats.resolve`);
    ``nodes``: a graph capture's node count, ``nodes_by_section`` its
    count for each consumer's section.  As a context manager (from
    :meth:`PerfStats.span`) it closes on leaving the block.
    """

    __slots__ = ("name", "step", "parent", "row", "start", "end", "device_ms", "nodes",
                 "nodes_by_section", "_perf", "_events", "_range")

    def __init__(self, name: str, step: int, parent: Optional["Span"], row: Optional[int],
                 start: float, perf: Optional["PerfStats"] = None):
        self.name, self.step, self.parent, self.row = name, step, parent, row
        self.start = start
        self.end: Optional[float] = None
        self.device_ms: Optional[float] = None
        self.nodes: Optional[int] = None
        self.nodes_by_section: Optional[Dict[str, int]] = None
        self._perf = perf
        # (start event, end event, stream) until resolved; the stream is
        # None where the events belong to a CUDA graph, not to the pool.
        self._events = None
        self._range = None  # the profiler's record_function range, while open

    @property
    def host_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self._perf.close(self)


_now = time.perf_counter
_profiling = torch.autograd._profiler_enabled
_LAST: Optional["PerfStats"] = None


def last_perf() -> Optional["PerfStats"]:
    """The recorder of the most recently built top-level ``StreamPipeline``
    (a mesh row never registers), or None before the first."""
    return _LAST


def set_last_perf(perf: "PerfStats") -> None:
    global _LAST
    _LAST = perf


class PerfStats:
    """Per-stage wall-clock statistics (host clock) with the reference's
    CSV export, and the program's spans.

    ``stages``, :meth:`time`, :meth:`add`, :meth:`summary` and
    :meth:`write_csv` are the reference's.  ``spans`` maps a step index to
    that step's :class:`Span` records, for the newest ``max_steps`` steps.
    A span opened while none is open is a root and starts a step (the next
    index, or the one given); one opened inside another is its child, in
    the same step.  A span opened with a CUDA ``device`` also records a
    pair of timing events on the device's current stream, from a pool the
    recorder reuses; their time is read only once the end event reports
    complete (:meth:`resolve`, run as each root opens), so recording never
    waits for the device.  While the profiler runs, each span is also a
    ``record_function`` range named ``ofps_torch.<name>``.

    A CUDA graph's replay brings its own timing events, recorded by the
    graph's event-record nodes (:meth:`replayed`): they are read in the
    same way, and, since the next replay records them again, settled
    before it (:meth:`settle`); a span whose end event has not completed
    by then loses its reading and counts in ``missed``.
    """

    def __init__(self, max_steps: int = 65536):
        self.stages: Dict[str, List[float]] = {}
        self.spans: "collections.OrderedDict[int, List[Span]]" = collections.OrderedDict()
        self.max_steps = max_steps
        self._open: List[Span] = []
        self._step = -1
        self._step_spans: List[Span] = []  # the records of the open root's step
        self._pending: "collections.deque[Span]" = collections.deque()
        self._pool: Dict[int, list] = {}  # device index -> free event pairs
        self._streams: Dict[tuple, "torch.cuda.Stream"] = {}  # (index, raw handle) -> stream
        self.missed = 0  # graph spans left unread before their graph replayed again

    @property
    def depth(self) -> int:
        """The number of spans open."""
        return len(self._open)

    def open(self, name: str, t: Optional[float] = None, step: Optional[int] = None,
             device: Optional[torch.device] = None, row: Optional[int] = None) -> Span:
        """Open a span starting at ``t`` (now by default); ``step`` sets a
        root's index, ``device`` asks for its device time, ``row`` marks a
        mesh row (children inherit it).  Close it with :meth:`close`, or
        leave a ``with`` block on it."""
        stack = self._open
        if stack:
            parent = stack[-1]
            sp = Span(name, parent.step, parent, parent.row if row is None else row,
                      _now() if t is None else t, self)
            self._step_spans.append(sp)
        else:
            if self._pending:
                self.resolve()
            self._step = self._step + 1 if step is None else step
            sp = Span(name, self._step, None, row, _now() if t is None else t, self)
            self._step_spans = self._keep(sp)
        if (device is not None and device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            stream = self._stream(device)
            pool = self._pool.setdefault(stream.device_index, [])
            start, end = pool.pop() if pool else (torch.cuda.Event(enable_timing=True),
                                                  torch.cuda.Event(enable_timing=True))
            start.record(stream)
            sp._events = (start, end, stream)
        if _profiling():
            sp._range = torch.autograd.profiler.record_function("ofps_torch." + name)
            sp._range.__enter__()
        stack.append(sp)
        return sp

    span = open

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        """``device``'s current stream, its object made once per stream
        (``torch.cuda.current_stream`` costs ~5 us a call on the H100's
        host, the raw handle a fraction of that)."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        key = (index, torch._C._cuda_getCurrentRawStream(index))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(index)
        return stream

    def close(self, sp: Span, t: Optional[float] = None) -> float:
        """Close ``sp`` at ``t`` (now by default), and any span still open
        inside it at the same time; returns the end time."""
        if sp.end is not None:  # closed already, inside a span closed before it
            return sp.end
        end = _now() if t is None else t
        while True:
            top = self._open.pop()
            top.end = end
            if top._events is not None:
                top._events[1].record(top._events[2])
                self._pending.append(top)
            if top._range is not None:
                top._range.__exit__(None, None, None)
                top._range = None
            if top is sp:
                return end

    def record(self, name: str, start: float, end: float) -> Span:
        """A span timed elsewhere (on another thread): a closed root of the
        step open now, or of the last step."""
        sp = Span(name, self._step, None, None, start)
        sp.end = end
        self._keep(sp)
        return sp

    def _keep(self, sp: Span) -> List[Span]:
        """Append ``sp`` to its step's records (made, and the oldest step
        dropped past ``max_steps``, where new); returns them."""
        spans = self.spans.get(sp.step)
        if spans is None:
            spans = self.spans[sp.step] = []
            while len(self.spans) > self.max_steps:
                self.spans.popitem(last=False)
        spans.append(sp)
        return spans

    def replayed(self, parent: Span, sections) -> List[Span]:
        """Spans of a CUDA graph's timed sections, children of ``parent``
        (the closed span of the replay, whose host interval they take):
        ``sections`` holds (name, start event, end event) that each replay
        of the graph records.  Their device times are read as the pool's
        are; :meth:`settle` them before the graph replays again."""
        out = []
        for name, start, end in sections:
            sp = Span(name, parent.step, parent, parent.row, parent.start, self)
            sp.end = parent.end
            sp._events = (start, end, None)
            self._keep(sp)
            self._pending.append(sp)
            out.append(sp)
        return out

    def settle(self, spans: Iterable[Span]) -> None:
        """Read the device times of a graph's last replayed ``spans`` before
        the graph replays again and records over their events, without
        waiting: a span whose end event has not completed gets no reading
        and counts in ``missed``."""
        for sp in spans:
            if sp._events is None:
                continue
            start, end, _ = sp._events
            if end.query():
                sp.device_ms = start.elapsed_time(end)
            else:
                self.missed += 1
            sp._events = None
            self._pending.remove(sp)

    def resolve(self, wait: bool = False) -> None:
        """Read the device time of every closed span whose end event has
        completed, in the order they closed, up to the first that has not;
        ``wait`` first waits for each (for readers, never on a step)."""
        while self._pending:
            sp = self._pending[0]
            start, end, stream = sp._events
            if wait:
                end.synchronize()
            if not end.query():
                return
            sp.device_ms = start.elapsed_time(end)
            sp._events = None
            if stream is not None:
                self._pool[stream.device_index].append((start, end))
            self._pending.popleft()

    def per_step(self, name: str, steps: Optional[Iterable[int]] = None,
                 device: bool = False) -> Dict[int, float]:
        """{step: ms} of the closed spans named ``name``, summed per step,
        over ``steps`` (all kept by default): host ms, or with ``device``
        their device ms (waiting for the device; spans without one are
        left out)."""
        if device:
            self.resolve(wait=True)
        out: Dict[int, float] = {}
        for step in list(self.spans) if steps is None else steps:
            for sp in self.spans.get(step, ()):
                if sp.name == name and sp.end is not None:
                    ms = sp.device_ms if device else sp.host_ms
                    if ms is not None:
                        out[step] = out.get(step, 0.0) + ms
        return out

    def median_ms(self, name: str, steps: Optional[Iterable[int]] = None,
                  device: bool = False) -> Optional[float]:
        """The median over steps of :meth:`per_step`; None where no step
        has the span."""
        xs = self.per_step(name, steps, device)
        return statistics.median(xs.values()) if xs else None

    def span_names(self) -> List[str]:
        """The names of the kept spans, in the order first seen."""
        return list(dict.fromkeys(sp.name for spans in self.spans.values() for sp in spans))

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
        self.props = device_props(pipe.dyn_props(), pipe.device)
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
