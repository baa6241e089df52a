"""The port's benchmark (``ofps_torch.apps.bench``, the CLI's ``bench``)
against the repository root's ``bench.py`` on the CPU.

* Flow checksum: ``build_runner`` at B=1, 96x128, 3 frames, against
  ``bench.build_runner`` on the same numpy frames, within 1e-3 px of mean
  per-pixel difference (|d checksum| / (B H W iters)); the bound allows for
  the float32 near-tie flips of the argmin (ROADMAP).
* Pipeline checksum: ``build_pipeline_runner`` (almeida + homography +
  block_motion) at B=2, 96x128, 3 steps, with the RANSAC draws of JAX's
  key chain injected.  The constant frame gives a flow near zero (the
  parabola's subpixel offsets, up to 0.017 of the width) and poses near the
  identity.  Against the same JAX steps run op by op, uncompiled (what
  ``bench.build_pipeline_runner`` scans), the checksums agree within 1e-4
  relative (8e-8 measured).  Compiled, as ``bench.build_pipeline_runner``
  runs them (or one step at a time under ``jax.jit``), XLA's rounding moves
  RANSAC's picks on that near-zero flow: the compiled checksum is 1.5e-4
  relative from the uncompiled one.  So the port is held to JAX's compiled
  runner within that spread plus 1e-4.
* ``step_checksum`` moves when any estimator's rot or pos, or the
  detector's flags, change.
* ``cli --device cpu bench`` prints one JSON line with ``bench.py``'s
  top-level keys plus ``detail``, every number finite and positive.  It
  runs in-process with the pipeline's chained steps cut to one (the
  module's ``PIPELINE_ITERS`` / ``ALL4_ITERS``; the command line keeps
  ``bench.py``'s 96 and 24): the port's serving step runs eagerly on the
  CPU at ~0.25 s a step.
* ``--profile DIR`` writes a ``torch.profiler`` trace of one timed flow
  run and skips the pipeline, as ``bench.py`` does.
* Without ``--device cpu`` on a machine with no card the bench raises.

JAX's two runners are module fixtures.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from ofps_torch.apps import bench as tbench
from ofps_torch.apps import cli
from ofps_torch.core.motion import grid_size_for
from ofps_tpu.core.camera import StandardCamera as JCam
from ofps_tpu.detectors.base import create_detector as j_det
from ofps_tpu.estimators.base import create_estimator as j_est
from ofps_tpu.ops.flow_pyramid import FlowParams as JFlowParams
from ofps_tpu.ops.robust import sample_indices as j_sample_indices
from ofps_tpu.parallel.stream import StreamPipeline as JPipe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLOW_B, FLOW_H, FLOW_W, FLOW_ITERS = 1, 96, 128, 3
FLOW_TOL_PX = 1e-3
PIPE_B, PIPE_H, PIPE_W, PIPE_ITERS = 2, 96, 128, 3
PIPE_REL_TOL = 1e-4
CPU = torch.device("cpu")
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "pipeline_1080p_fps_per_chip",
            "pipeline_all4_fps_per_chip"}


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    i1 = rng.uniform(0.0, 255.0, (b, h, w)).astype(np.float32)
    i2 = (np.roll(i1, 3, axis=-1) + rng.uniform(-2.0, 2.0, i1.shape)).astype(np.float32)
    return i1, i2


@pytest.fixture(scope="module")
def flow_frames():
    return _frames(FLOW_B, FLOW_H, FLOW_W, 0)


@pytest.fixture(scope="module")
def jax_flow_checksum(flow_frames):
    run = jbench.build_runner(FLOW_B, FLOW_H, FLOW_W, FLOW_ITERS, JFlowParams())
    return float(jax.device_get(run(*flow_frames)))


@pytest.fixture(scope="module")
def pipe_frame():
    return _frames(PIPE_B, PIPE_H, PIPE_W, 1)[0]


def _jax_keys():
    """The keys of JAX's runner: the first step takes the key itself, the
    chained steps its split into iters - 1 keys."""
    key = jax.random.PRNGKey(1)
    return key, [key, *jax.random.split(key, PIPE_ITERS - 1)]


@pytest.fixture(scope="module")
def jax_pipe_checksums(pipe_frame):
    """(JAX's compiled runner's checksum, the same steps' checksum run op
    by op)."""
    key, keys = _jax_keys()
    compiled = jbench.build_pipeline_runner(PIPE_B, PIPE_H, PIPE_W, PIPE_ITERS)
    pipe = JPipe(camera=JCam.create(PIPE_W / PIPE_H, 90.0),
                 estimators=[j_est(n) for n in tbench.SERVING],
                 detector=j_det("block_motion"), flow_params=JFlowParams(),
                 emit_dense_flow=False)
    state, steps = pipe.init_state(PIPE_B, PIPE_H, PIPE_W), 0.0
    for k in keys:
        state, out = pipe.step_from_frames(state, pipe_frame, k)
        steps += float(jbench._step_checksum(out))
    return float(jax.device_get(compiled(pipe_frame, key))), steps


def test_flow_checksum_matches_jax(flow_frames, jax_flow_checksum):
    i1, i2 = (torch.from_numpy(x) for x in flow_frames)
    got = tbench.build_runner(FLOW_B, FLOW_H, FLOW_W, FLOW_ITERS)(i1, i2).item()
    per_px = abs(got - jax_flow_checksum) / (FLOW_B * FLOW_H * FLOW_W * FLOW_ITERS)
    assert per_px <= FLOW_TOL_PX, (got, jax_flow_checksum)


def _jax_step_draws(key, n):
    """The draws of JAX's step for almeida + homography: one key per
    estimator and stream (estimator-major); almeida samples from its key's
    first split (200 x 3), homography's robust_fit from the key (91 x 4)."""
    keys = jax.random.split(key, 2 * PIPE_B)
    alm = [j_sample_indices(jax.random.split(k)[0], np.ones(n), 200, 3, dense=True)
           for k in keys[:PIPE_B]]
    hom = [j_sample_indices(k, np.ones(n), 91, 4, dense=True) for k in keys[PIPE_B:]]
    return tuple(torch.from_numpy(np.stack([np.asarray(x) for x in d])) for d in (alm, hom))


def test_pipeline_checksum_matches_jax(pipe_frame, jax_pipe_checksums):
    compiled, steps = jax_pipe_checksums
    gw, gh = grid_size_for(PIPE_W, PIPE_H)
    draws = [_jax_step_draws(k, gw * gh) for k in _jax_keys()[1]]
    run = tbench.build_pipeline_runner(PIPE_B, PIPE_H, PIPE_W, PIPE_ITERS, device=CPU)
    got = run(torch.from_numpy(pipe_frame), None, draws=draws).item()
    assert abs(got - steps) <= PIPE_REL_TOL * abs(steps), (got, steps)
    assert abs(got - compiled) <= abs(steps - compiled) + PIPE_REL_TOL * abs(compiled), (
        got, compiled, steps)
    # Rotations near the identity (1 + 0 + 0 + 0 per stream and
    # estimator), zero positions, no detection.
    assert abs(got - PIPE_ITERS * PIPE_B * 2) < 1e-2


def test_step_checksum_consumes_every_output(pipe_frame):
    run = tbench.build_pipeline_runner(PIPE_B, PIPE_H, PIPE_W, 1, device=CPU)
    pipe = run.pipe
    _, out = pipe.step_from_frames(pipe.init_state(PIPE_B, PIPE_H, PIPE_W),
                                   torch.from_numpy(pipe_frame), torch.Generator().manual_seed(1))
    base = tbench.step_checksum(out).item()

    def bumped(tensors, i):
        return tuple(t + 0.25 if j == i else t for j, t in enumerate(tensors))

    for i in range(len(out.rot)):
        assert tbench.step_checksum(out._replace(rot=bumped(out.rot, i))).item() != base
        assert tbench.step_checksum(out._replace(pos=bumped(out.pos, i))).item() != base
    flags = out.detection.detected.clone()
    flags[0] = ~flags[0]
    det = out.detection._replace(detected=flags)
    assert tbench.step_checksum(out._replace(detection=det)).item() != base


def test_cli_bench_prints_bench_py_keys(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "PIPELINE_ITERS", 1)
    monkeypatch.setattr(tbench, "ALL4_ITERS", 1)
    rc = cli.main(["--device", "cpu", "bench", "--height", "96", "--width", "128",
                   "--iters", "2", "--repeats", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert set(rec) == JAX_KEYS | {"detail"}
    assert rec["metric"] == "dense_flow_1080p_fps_per_chip" and rec["unit"] == "frames/s"
    assert set(rec["pipeline_1080p_fps_per_chip"]) == {"b1", "b4", "b8"}
    fps = [rec["value"], rec["vs_baseline"], rec["pipeline_all4_fps_per_chip"],
           *rec["pipeline_1080p_fps_per_chip"].values()]
    assert all(math.isfinite(x) and x > 0 for x in fps), rec
    d = rec["detail"]
    assert d["clock"] == "host clock" and d["device"].startswith("cpu")
    assert len(d["flow"]["ms"]) == 1 and math.isfinite(d["flow"]["checksum"][0])
    assert d["all4"]["batch"] == 8 and d["pipeline"]["b8"]["iters"] == 1


def test_bench_profile_writes_a_trace(tmp_path, capsys):
    """``--profile DIR``: one timed flow run under ``torch.profiler``, its
    trace in DIR, and no pipeline sweep (as ``bench.py``)."""
    assert tbench.main(["--height", "48", "--width", "64", "--iters", "1", "--profile",
                        str(tmp_path)], device="cpu") == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert len(rec["detail"]["flow"]["ms"]) == 1
    assert json.loads((tmp_path / "bench_trace.json").read_text())["traceEvents"]


def test_bench_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--iters", "1", "--no-pipeline"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["bench", "--iters", "1", "--no-pipeline"])
