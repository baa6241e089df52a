"""The reference agrees with the port's plain versions, of which it is a
frozen copy, at a tiny size on the CPU (same inputs, same draws)."""

import numpy as np
import pytest
import torch

from ofps_bench import check, inputs, spec
from ofps_bench.reference.step import Reference
from ofps_bench.tests import tiny
from ofps_torch.core.camera import StandardCamera
from ofps_torch.core.motion import SparseFlow
from ofps_torch.detectors.base import create_detector
from ofps_torch.estimators.base import create_estimator
from ofps_torch.parallel.stream import StreamPipeline

SEED = 2**31 + 31


def _port(cfg, **kw):
    return StreamPipeline(
        StandardCamera.create(cfg["camera"]["aspect"], cfg["camera"]["fov_y"]),
        [create_estimator(e["name"], **e["properties"]) for e in cfg["estimators"]],
        create_detector(cfg["detector"]["name"], **cfg["detector"]["properties"]),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_codec_step(root):
    cell = spec.load_cell("codec_tiny.b2", root)
    cfg = cell.config
    bank = inputs.codec_bank(SEED, 2, cfg, cell.traffic)
    ref = Reference(cfg, "cpu")
    pipe = _port(cfg)
    state = pipe.init_state(2, 1, 1)
    gen = torch.Generator().manual_seed(SEED)
    for t in range(3):
        draws = ref.draws(gen, 2, cfg["capacity"], dense=False)
        rows = check._rows(bank, t, cfg["capacity"], "cpu")
        got = ref.codec_step(rows, draws)
        state, out = pipe.step_from_flow(
            state, SparseFlow(rows[..., 0:2], rows[..., 2:4], rows[..., 4]), draws=draws)
        for a, b in zip(got.delta, out.delta_rot):
            assert torch.equal(a, b)
        assert torch.equal(got.detected, out.detection.detected)


def test_frames_step(root):
    cell = spec.load_cell("frames_tiny.b2", root)
    cfg, tr = cell.config, cell.traffic
    bank = inputs.frames_bank(SEED, 2, cfg, tr, torch.device("cpu"))
    ref = Reference(cfg, "cpu")
    pipe = _port(cfg, emit_dense_flow=False, plain=True)
    state = pipe.init_state(2, cfg["height"], cfg["width"])
    props = ref.device_props()
    gen = torch.Generator().manual_seed(SEED)
    n = 150 * 84
    for t in range(3):
        warm_in = state.warm_uv
        prev = bank[inputs.bank_index(max(t - 1, 0), tr["bank_frames"])]
        cur = bank[inputs.bank_index(t, tr["bank_frames"])]
        grid, warm = ref.flow(prev, cur, warm_in, torch.full((2,), float(t > 0)))
        draws = ref.draws(gen, 2, n, dense=True)
        got = ref.consume(grid, draws, props)
        state, out = pipe.step_from_frames(state, cur.float(), props=props, draws=draws)
        assert torch.equal(grid, out.grid)
        assert all(torch.equal(a, b) for a, b in zip(warm, state.warm_uv))
        for a, b in zip(got.delta, out.delta_rot):
            assert torch.equal(a, b)
        assert torch.equal(got.detected, out.detection.detected)
    assert float(np.abs(grid.numpy()).max()) > 0  # the pan moved the grid


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for v in x for leaf in _leaves(v)]


def test_codec_step_all_four(root):
    """The four estimators found by name, three steps with libmv's carried
    state on both sides; the port draws from its own generator, so the
    reference's draws are the served step's calls in its order."""
    name = tiny.add_cell(root, "codec_all4_tiny.b2", "codec_tiny", "codec_tiny",
                         estimators=tiny.ALL4)
    cell = spec.load_cell(name, root)
    cfg = cell.config
    bank = inputs.codec_bank(SEED, 2, cfg, cell.traffic)
    ref = Reference(cfg, "cpu")
    assert [e.name for e in ref.ests] == ["almeida", "homography", "multiview", "libmv"]
    pipe = _port(cfg)
    state = pipe.init_state(2, 1, 1)
    gen_ref = torch.Generator().manual_seed(SEED)
    gen_port = torch.Generator().manual_seed(SEED)
    states = None
    for t in range(3):
        rows = check._rows(bank, t, cfg["capacity"], "cpu")
        got = ref.codec_step(rows, ref.draws(gen_ref, 2, cfg["capacity"], dense=False), states)
        states = got.states
        state, out = pipe.step_from_flow(
            state, SparseFlow(rows[..., 0:2], rows[..., 2:4], rows[..., 4]), gen_port)
        for a, b in zip(got.delta, out.delta_rot, strict=True):
            assert torch.equal(a, b)
        for a, b in zip(got.tr, out.delta_tr, strict=True):
            assert torch.equal(a, b)
        for a, b in zip(_leaves(states), _leaves(state.est), strict=True):
            assert torch.equal(a, b)
        assert torch.equal(got.detected, out.detection.detected)
    libmv = states[3]
    assert float(libmv.has.min()) == 1.0  # the chain started and carried on
    assert float(torch.linalg.vector_norm(got.tr[3], dim=-1).min()) > 0
