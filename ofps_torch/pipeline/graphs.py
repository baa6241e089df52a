"""The consumers' CUDA graph (``StreamPipeline._run_consumers``): nests of
tensors, the props' device format, node counts, timed sections, captured
calls and their cache.  The span recorder comes in as an argument."""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, Optional, Tuple

import torch


def leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of tuples / named tuples (None has none)."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for v in x for leaf in leaves(v)]


def rebuild(template, xs):
    """``template``'s nest with its tensors taken in order from ``xs``."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(xs)
    fields = [rebuild(v, xs) for v in template]
    return type(template)(*fields) if hasattr(template, "_fields") else tuple(fields)


def clone(x):
    return rebuild(x, (t.clone() for t in leaves(x)))


def tile(x, batch: int, device):
    """An estimator's unbatched ``init()`` carry tiled to B streams."""
    return rebuild(x, (t.to(device).expand((batch,) + t.shape).clone() for t in leaves(x)))


def prop_tensors(props, device):
    """(names, values) of ``props``: its structure (the sorted prop names of
    each estimator, then the detector's) and its values as 0-d float32
    tensors on ``device``, in that order; ((), ()) for None, and (None,
    None) when a value is neither a number nor a 0-d tensor."""
    if props is None:
        return (), ()
    groups = (*props["estimators"], props["detector"])
    names = tuple(tuple(sorted(g)) for g in groups)
    values = []
    for g, ns in zip(groups, names):
        for n in ns:
            v = g[n]
            if isinstance(v, torch.Tensor) and v.dim() == 0:
                values.append(v.to(device, torch.float32))
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                values.append(device_scalar(float(v), str(device)))
            else:
                return None, None
    return names, tuple(values)


@functools.lru_cache(maxsize=256)
def device_scalar(value: float, device: str) -> torch.Tensor:
    """A 0-d float32 tensor of ``value`` on ``device``, made once (a graph
    replay copies from it; nothing writes to it)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def props_from(names, values):
    """The props dict of :func:`prop_tensors`' (names, values)."""
    if not names:
        return None
    it = iter(values)
    groups = [{n: next(it) for n in ns} for ns in names]
    return {"estimators": tuple(groups[:-1]), "detector": groups[-1]}


def device_props(props, device):
    """``props`` as 0-d float32 tensors of their own on ``device``, which a
    caller may write (``LivePipeline``'s)."""
    names, values = prop_tensors(props, device)
    return props_from(names, [v.clone() for v in values])


@functools.lru_cache(maxsize=1)
def _libcuda():
    """``libcuda.so.1`` with ``cuGraphGetNodes`` and ``cuStreamGetCaptureInfo_v2``."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuStreamGetCaptureInfo_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    lib.cuGraphGetNodes.restype = lib.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
    return lib


def graph_nodes(graph) -> int:
    """The node count of the ``cudaGraph_t`` handle ``graph``."""
    n = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return n.value


def capturing_nodes(stream: "torch.cuda.Stream") -> int:
    """The node count of the graph that ``stream`` is capturing, so far."""
    status, graph = ctypes.c_int(0), ctypes.c_void_p()
    rc = _libcuda().cuStreamGetCaptureInfo_v2(stream.cuda_stream, ctypes.byref(status), None,
                                              ctypes.byref(graph), None, None)
    if rc != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"cuStreamGetCaptureInfo failed with CUresult {rc}, "
                           f"capture status {status.value}")
    return graph_nodes(graph)


class Sections:
    """The timed sections of a graph under capture: for each, its span's
    name and a pair of timing events recorded into the graph as
    event-record nodes (the events are the graph's: each replay records
    them again), and by the consumer's name the nodes of the section's own
    work, counted on the graph in progress."""

    def __init__(self):
        self.events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.nodes: dict = {}  # name -> nodes, summed over sections of one name

    @contextlib.contextmanager
    def timed(self, span: str, name: str):
        stream = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True, external=True)
        end = torch.cuda.Event(enable_timing=True, external=True)
        start.record(stream)
        n0 = capturing_nodes(stream)
        yield
        n1 = capturing_nodes(stream)
        end.record(stream)
        self.events.append((span, start, end))
        self.nodes[name] = self.nodes.get(name, 0) + n1 - n0


class CapturedCall:
    """``fn(*inputs)`` captured as a CUDA graph over static input buffers:
    a call copies its inputs in, replays, and returns clones of the outputs
    (the next replay overwrites the static ones), each of the three a span
    of the recorder it is given.  ``nodes``: the captured graph's node
    count, read before it is instantiated.  ``sections``: what ``fn``
    timed while it was captured; each replay gives its sections' spans
    under the replay's, settled before the next replay."""

    def __init__(self, fn, inputs, sections: Optional[Sections] = None):
        self.sections = sections.events if sections is not None else []
        self._replayed: List = []  # the last replay's section spans
        # Capture and replay with the inputs' card current, so that the
        # side stream, the capture stream and every launch in ``fn`` belong
        # to that card.  The capture runs on the side stream: the default
        # capture stream of ``torch.cuda.graph`` is made once per process,
        # on the card current at the first capture.
        self.device = inputs[0].device
        with torch.cuda.device(self.device):
            self.inputs = tuple(x.clone() for x in inputs)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                fn(*self.inputs)  # warm-up: lazily built constants and caches
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.graph, stream=side):
                self.outputs = fn(*self.inputs)
            self.nodes = graph_nodes(self.graph.raw_cuda_graph())
            self.graph.instantiate()

    def __call__(self, inputs, perf):
        with torch.cuda.device(self.device):
            perf.settle(self._replayed)
            sp = perf.open("consumers.copy_in")
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            launch = perf.open("consumers.launch", t=perf.close(sp), device=self.device)
            self.graph.replay()
            sp = perf.open("consumers.clone", t=perf.close(launch))
            out = clone(self.outputs)
            perf.close(sp)
            self._replayed = perf.replayed(launch, self.sections)
            return out


class GraphCache:
    """The consumers' captured calls of one pipeline (a mesh row has its
    own: a mesh may repeat a card), keyed by card, input kind (the type of
    ``args[0]``), shapes and dtypes, and set of prop names, never by a
    prop's value; ``replays`` and ``eager_runs`` count how calls ran."""

    def __init__(self):
        self.calls: dict = {}
        self.replays = 0
        self.eager_runs = 0

    def run(self, fn, args: tuple, props, device, perf):
        """``fn(*args, props, sections)``, replayed as a CUDA graph on CUDA:
        the tensors of ``args`` and the props' values are its static inputs
        (a new prop value is a copy, not a new graph), captured once under
        the span ``consumers.capture`` (with ``nodes`` and
        ``nodes_by_section``).  It runs eagerly off CUDA, and where a prop
        is neither a number nor a 0-d tensor."""
        names, values = prop_tensors(props, device) if device.type == "cuda" else (None, None)
        if names is None:
            self.eager_runs += 1
            return fn(*args, props, None)
        tree = (*args, values)
        inputs = tuple(leaves(tree))
        key = (str(inputs[0].device), type(args[0]).__name__,
               tuple((tuple(x.shape), x.dtype) for x in inputs), names)
        if key not in self.calls:
            sections = Sections()

            def captured(*xs):
                *a, vals = rebuild(tree, iter(xs))
                return fn(*a, props_from(names, vals), sections)

            with perf.span("consumers.capture") as sp:
                self.calls[key] = CapturedCall(captured, inputs, sections)
                sp.nodes = self.calls[key].nodes
                sp.nodes_by_section = dict(sections.nodes)
        self.replays += 1
        return self.calls[key](inputs, perf)
