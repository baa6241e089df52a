"""Several processes, each feeding its own streams (port of
``ofps_tpu.parallel.distributed``).

Every process runs the same program.  ``torch.distributed`` joins them for
the few reductions across streams; the frames themselves never leave the
process that decoded them.  A process's mesh holds its own devices only,
so the ``space`` axis (the halo copies) stays inside one process, as JAX
keeps it on one host.

Recipe (every process, same program)::

    OFPS_TORCH_COORDINATOR=host0:29500 \\
    OFPS_TORCH_NUM_PROCESSES=2 \\
    OFPS_TORCH_PROCESS_ID=$RANK  python my_serving_job.py

    from ofps_torch.parallel import distributed
    distributed.maybe_initialize()          # no-op unless the env is set
    mesh = distributed.global_stream_mesh() # this process's devices
    local = distributed.host_local_batch(mesh, {"frames": my_frames})
    total = distributed.global_reduce(local_sum, "sum")

Under ``torchrun``, ``OFPS_TORCH_DIST=auto`` reads its ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` instead.  CUDA
processes join with NCCL, which takes one card per process: give each
process its card with ``CUDA_VISIBLE_DEVICES``.  CPU processes join with
gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ofps_torch.parallel.sharding import (
    RowShards,
    StreamMesh,
    _flatten,
    make_stream_mesh,
    shard_put,
)

# Seconds a rendezvous or a collective may wait for the other processes.
DEFAULT_TIMEOUT_S = 120.0


def local_devices() -> List[torch.device]:
    """This process's devices: every visible CUDA card, else the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def maybe_initialize(timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """``torch.distributed.init_process_group`` from the environment.

    Reads ``OFPS_TORCH_COORDINATOR`` (host:port), ``OFPS_TORCH_NUM_PROCESSES``
    and ``OFPS_TORCH_PROCESS_ID``; or, with ``OFPS_TORCH_DIST=auto``,
    torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``.  The backend is NCCL when this process has a CUDA card
    (made the current one) and gloo otherwise.  Returns True once the
    process group exists, False when the environment asks for a single
    process.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    coord = env.get("OFPS_TORCH_COORDINATOR")
    if coord:
        world, rank = int(env["OFPS_TORCH_NUM_PROCESSES"]), int(env["OFPS_TORCH_PROCESS_ID"])
    elif env.get("OFPS_TORCH_DIST") == "auto":
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    dev = local_devices()[0]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{coord}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_stream_mesh(space: Optional[int] = None) -> StreamMesh:
    """The ("stream", "space") mesh over this process's devices, with its
    rank and world size.  ``space`` defaults to 2 where the process has an
    even number of at least two devices: the halo copies stay inside the
    process."""
    devs = local_devices()
    if space is None:
        space = 2 if len(devs) % 2 == 0 and len(devs) >= 2 else 1
    mesh = make_stream_mesh(space=space, devices=devs)
    mesh.rank, mesh.world_size = _rank_world()
    return mesh


class HostLocalBatch(NamedTuple):
    """This process's streams placed on its mesh."""

    shards: RowShards  # the local streams split over the mesh's rows
    offset: int  # global index of the first local stream
    global_count: int  # streams over every process


def _collective_device() -> torch.device:
    """Where a collective's tensors must live: the current card under
    NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_local_batch(mesh: StreamMesh, local_tree: Any) -> HostLocalBatch:
    """Place this process's own streams (a nest of batch-leading tensors,
    its local share of the global batch) on ``mesh``, with no copy of the
    data to another process; the processes exchange only their stream
    counts, to find this one's global offset."""
    shards = shard_put(local_tree, mesh)
    n_local = sum(_flatten(s)[0].shape[0] for s in shards)
    counts = [n_local]
    if dist.is_initialized():
        mine = torch.tensor([n_local], dtype=torch.int64, device=_collective_device())
        parts = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        counts = [int(p.item()) for p in parts]
    rank, _ = _rank_world()
    return HostLocalBatch(shards, sum(counts[:rank]), sum(counts))


def global_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` reduced elementwise over every process (``op`` "sum" or
    "max"), returned on ``x``'s device; ``x`` itself alone."""
    if not dist.is_initialized():
        return x.clone()
    y = x.detach().to(_collective_device()).clone()
    dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return y.to(x.device)
