"""The port's multi-process recipe (``ofps_torch.parallel.distributed``),
as ``tests/test_multihost.py`` runs JAX's: two CPU processes join over
gloo through ``maybe_initialize``, each places its own two streams with
``host_local_batch`` (the global count is 4), and both agree on the
global sum and the largest per-stream mean.  This file is also the worker:
run as ``__main__`` it is one process of the pair.

On the card: the kernel wrappers and a consumers' graph on ``cuda:1``
while ``cuda:0`` is current (skips without two cards).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

_REPO = Path(__file__).resolve().parent.parent
_KEEP = ("PATH", "HOME", "LANG", "LC_ALL", "PYTHONHASHSEED", "TMPDIR", "LD_LIBRARY_PATH")
_ENV = ("OFPS_TORCH_COORDINATOR", "OFPS_TORCH_NUM_PROCESSES", "OFPS_TORCH_PROCESS_ID",
        "OFPS_TORCH_DIST")
LOCAL_STREAMS = 2
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker() -> int:
    """One process: the global reduction over every process's streams;
    stream i (global) carries the value i + 1."""
    sys.path.insert(0, str(_REPO))
    from ofps_torch.parallel import distributed

    if not distributed.maybe_initialize(timeout_s=TIMEOUT_S):
        print("MULTIPROC_FAIL no coordinator env", flush=True)
        return 1
    try:
        mesh = distributed.global_stream_mesh(space=1)
        rank, world = mesh.rank, mesh.world_size
        base = rank * LOCAL_STREAMS
        local = torch.stack([torch.full((4, 8), float(base + s + 1))
                             for s in range(LOCAL_STREAMS)])
        batch = distributed.host_local_batch(mesh, {"frames": local})
        assert batch.offset == base and batch.global_count == world * LOCAL_STREAMS, batch[1:]
        frames = [s["frames"] for s in batch.shards]
        total = distributed.global_reduce(sum(f.sum() for f in frames), "sum")
        maxmean = distributed.global_reduce(
            torch.stack([f.mean(dim=(1, 2)).max() for f in frames]).max(), "max")
        n = batch.global_count
        want = sum((i + 1) * 4 * 8 for i in range(n))
        assert abs(float(total) - want) < 1e-3, (float(total), want)
        assert abs(float(maxmean) - n) < 1e-3, float(maxmean)
        print(f"MULTIPROC_OK rank={rank}/{world} mesh={mesh.shape} total={float(total)}",
              flush=True)
    finally:
        distributed.shutdown()
    return 0


def test_maybe_initialize_without_env_is_single_process(monkeypatch):
    from ofps_torch.parallel import distributed

    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize() is False
    mesh = distributed.global_stream_mesh()
    assert (mesh.rank, mesh.world_size) == (0, 1)
    batch = distributed.host_local_batch(mesh, torch.zeros(3, 2))
    assert (batch.offset, batch.global_count) == (0, 3)
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(distributed.global_reduce(x, "max"), x)


def test_two_processes_agree_on_the_global_reduction(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k in _KEEP}
        env.update(PYTHONPATH=str(_REPO), CUDA_VISIBLE_DEVICES="",
                   OFPS_TORCH_COORDINATOR=f"127.0.0.1:{port}", OFPS_TORCH_NUM_PROCESSES="2",
                   OFPS_TORCH_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, __file__], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S + 60)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a worker process timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIPROC_OK" in out, f"rank {rank} rc={p.returncode}\n{out}"
    totals = {line.split("total=")[1] for out in outs for line in out.splitlines()
              if "MULTIPROC_OK" in line}
    assert totals == {str(float(sum((i + 1) * 32 for i in range(4))))}


@pytest.mark.cuda
def test_kernels_and_graph_on_the_second_card():
    """Each kernel wrapper and a consumers' graph capture with tensors on
    ``cuda:1`` while ``cuda:0`` is current: the launch, the shared-memory
    attribute and the capture must all belong to ``cuda:1``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.detectors.base import create_detector
    from ofps_torch.estimators.base import create_estimator
    from ofps_torch.kernels import flow_refine as kfr
    from ofps_torch.kernels import flow_refine_small as kfs
    from ofps_torch.kernels import warp as kwarp
    from ofps_torch.parallel import StreamPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g = torch.Generator().manual_seed(0)
    i1, i2 = (torch.randn((2, 270, 480), generator=g).mul(50).to(dev) for _ in range(2))
    u, v = (torch.randn((2, 135, 240), generator=g).to(dev) for _ in range(2))
    s1, s2, su, sv = (x[..., :67, :120].contiguous() for x in (i1, i2, u, v))
    for got, ref in (
        (kfr.flow_refine(i1, i2, u, v, 5), kfr.flow_refine_plain(i1, i2, u, v, 5)),
        (kfs.flow_refine_small(s1, s2, su, sv, 2, 5),
         kfs.flow_refine_small_plain(s1, s2, su, sv, 2, 5)),
        (kfs.guard_select(s1, s2, su, sv, sv, su, 5),
         kfs.guard_select_plain(s1, s2, su, sv, sv, su, 5)),
    ):
        for a, b in zip(got, ref):
            assert a.device == dev
            assert ((a - b).abs() > 1e-3).float().mean().item() <= 1e-3
    uu, vv = (torch.randn((2, 270, 480), generator=g).to(dev) for _ in range(2))
    torch.testing.assert_close(kwarp.warp_bilinear(i1, uu, vv), kwarp.warp_bilinear_plain(i1, uu, vv),
                               rtol=0, atol=1e-3)
    pipe = StreamPipeline(StandardCamera.create(16 / 9, 60.0), [create_estimator("almeida")],
                          create_detector("block_motion"), emit_dense_flow=False, device=dev)
    frames = torch.randn((2, 2, 1080, 1920), generator=g).mul(50).to(dev)
    st = pipe.init_state(2, 1080, 1920)
    for f in frames:
        st, out = pipe.step_from_frames(st, f, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    assert pipe.graph_replays == 2 and pipe.eager_runs == 0
    assert out.grid.device == dev and bool(torch.isfinite(out.rot[0]).all())


if __name__ == "__main__":
    sys.exit(worker())
