"""Mesh and placement helpers for multi-stream scaling (port of
``ofps_tpu.parallel.sharding``).

The JAX package shards global arrays over a ``jax.sharding.Mesh`` and lets
XLA insert the collectives.  PyTorch has no global array, so here a mesh is
a 2-D grid of ``torch.device``s and every placement is explicit:

* ``stream``: data parallelism over independent video streams.  A batch of
  B streams splits into one row of B / rows streams per mesh row, held on
  the row's first device (:func:`shard_put`, :func:`gather`).
* ``space``: the frame's columns inside the dense-flow pyramid, one column
  band per position of a row, joined by halo copies between the positions'
  devices (:mod:`ofps_torch.parallel.spatial`).

A device may appear more than once: ``devices=["cuda:0"] * 4`` is a (2, 2)
mesh on one card, and ``["cpu"] * 8`` a CPU mesh for tests.  JAX's
``constrain`` has no counterpart: placement replaces it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch

AXES = ("stream", "space")


class StreamMesh:
    """A (stream, space) grid of devices: ``devices[r][c]`` holds position
    (r, c).  ``rank`` and ``world_size`` are this process's place among the
    processes of a distributed run (0 and 1 alone); a mesh holds only this
    process's devices."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence[Any]], rank: int = 0, world_size: int = 1):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh needs a non-empty rectangle of devices, got {devices}")
        self.devices = rows
        self.rank = rank
        self.world_size = world_size

    @property
    def shape(self) -> dict:
        return {"stream": len(self.devices), "space": len(self.devices[0])}

    @property
    def first_device(self) -> torch.device:
        """Where :func:`gather` and a sharded pipeline's outputs land."""
        return self.devices[0][0]

    def row_device(self, r: int) -> torch.device:
        """Where row ``r``'s streams and their state live."""
        return self.devices[r][0]

    def row(self, r: int) -> "StreamMesh":
        """Row ``r`` as a (1, space) mesh."""
        return StreamMesh([self.devices[r]], self.rank, self.world_size)

    def __repr__(self) -> str:
        grid = "[" + ", ".join("[" + ", ".join(str(d) for d in row) + "]"
                               for row in self.devices) + "]"
        extra = f", rank={self.rank}/{self.world_size}" if self.world_size > 1 else ""
        return f"StreamMesh(stream={len(self.devices)}, space={len(self.devices[0])}, devices={grid}{extra})"


def make_stream_mesh(n_devices: Optional[int] = None, space: Optional[int] = None,
                     devices: Optional[Sequence[Any]] = None) -> StreamMesh:
    """A ("stream", "space") mesh over the first ``n_devices`` of
    ``devices`` (default: every visible CUDA card).

    ``space`` defaults to 2 when the device count is even and at least 4,
    else 1; the stream axis gets the rest, in device order.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices= (e.g. ['cpu'] * 8)")
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} given")
        devs = devs[:n_devices]
    n = len(devs)
    if space is None:
        space = 2 if n % 2 == 0 and n >= 4 else 1
    if space < 1 or n % space:
        raise ValueError(f"{n} devices do not split into space={space}")
    return StreamMesh([devs[i : i + space] for i in range(0, n, space)])


class StreamSharding(NamedTuple):
    """Where a sharded pipeline runs: the batch over ``mesh``'s stream
    axis, the frame's width over its space axis (a (n, 1) mesh shards the
    streams only)."""

    mesh: StreamMesh


def stream_sharding(mesh: StreamMesh) -> StreamSharding:
    """The default placement: batch over 'stream', width over 'space'."""
    return StreamSharding(mesh)


class RowShards(tuple):
    """A batch-leading tree split into the mesh's rows: item r is the tree
    of row r's streams, on ``mesh.row_device(r)``."""


def tree_map(fn, tree):
    """``fn`` on every tensor of a nest of tuples, named tuples, lists and
    dicts; other leaves (None, numbers) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def _mesh(where) -> StreamMesh:
    return where.mesh if isinstance(where, StreamSharding) else where


def shard_put(tree, where) -> RowShards:
    """Split the batch-leading tensors of ``tree`` along ``stream``: row r
    gets its B / rows streams, on its row's device.  A 0-d tensor goes to
    every row whole.  ``where``: a :class:`StreamMesh` or
    :class:`StreamSharding`."""
    mesh = _mesh(where)
    rows = mesh.shape["stream"]

    def part(r):
        def one(x):
            dev = mesh.row_device(r)
            if x.dim() == 0:
                return x.to(dev)
            if x.shape[0] % rows:
                raise ValueError(f"batch {x.shape[0]} does not split into {rows} rows")
            n = x.shape[0] // rows
            return x[r * n : (r + 1) * n].to(dev).contiguous()

        return tree_map(one, tree)

    return RowShards(part(r) for r in range(rows))


def gather(shards: RowShards, where):
    """The tree of :func:`shard_put` whole again, on the mesh's first
    device: each batch-leading tensor concatenated over the rows, a 0-d
    tensor taken from row 0."""
    mesh = _mesh(where)
    dev = mesh.first_device
    flat = [_flatten(s) for s in shards]
    joined = [
        parts[0].to(dev) if parts[0].dim() == 0
        else torch.cat([p.to(dev) for p in parts], dim=0)
        for parts in zip(*flat)
    ]
    it = iter(joined)
    return tree_map(lambda _: next(it), shards[0])


def _flatten(tree):
    out = []
    tree_map(out.append, tree)
    return out
