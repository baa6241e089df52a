"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU at a tiny size (the harness's look
for a card skipped), with one of the faults a cell can have planted in the
program: a step that returns its state unchanged, half of the batch left
out (its outputs the other half's), an answer altered where it is produced
(a delta rotation, a detection verdict).  The cells run on one card, so no
exchange between cards can be left out."""

import math

import pytest
import torch

from ofps_bench import run, spec
from ofps_bench.tests import tiny
from ofps_torch.parallel.stream import StreamPipeline

SEED = 2**31 + 4242
STEP = {"codec_tiny.b2": "step_from_flow", "frames_tiny.b2": "step_from_frames"}
# Windows long enough for every checked step of the frames cell to come
# (they are drawn among the steps the window is expected to reach).
SECONDS = {"codec_tiny.b2": 1.0, "frames_tiny.b2": 3.0}


def _unchanged(state, new, out):
    return state, out._replace(rot=state.rot, pos=state.pos)


def _half(state, new, out):
    def copy_half(x):
        x = x.clone()
        h = x.shape[0] // 2
        x[h:] = x[: x.shape[0] - h]
        return x

    det = out.detection
    det = det._replace(detected=copy_half(det.detected)) if det is not None else None
    return new, out._replace(rot=tuple(copy_half(r) for r in out.rot),
                             delta_rot=tuple(copy_half(r) for r in out.delta_rot),
                             detection=det)


def _delta_altered(state, new, out):
    a = math.radians(0.05) / 2  # 0.05 deg about z, on estimator 0, stream 0
    q = out.delta_rot[0].clone()
    w, z = q[0, 0].clone(), q[0, 3].clone()
    q[0, 0], q[0, 3] = w * math.cos(a) - z * math.sin(a), z * math.cos(a) + w * math.sin(a)
    return new, out._replace(delta_rot=(q,) + tuple(out.delta_rot[1:]))


def _verdict_altered(state, new, out):
    det = out.detection
    flipped = det.detected.clone()
    flipped[0] = ~flipped[0]
    return new, out._replace(detection=det._replace(detected=flipped))


FAULTS = {"none": None, "unchanged": _unchanged, "half": _half,
          "delta_altered": _delta_altered, "verdict_altered": _verdict_altered}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell_name", list(STEP))
def test_a_broken_step_is_not_correct(root, monkeypatch, cell_name, fault):
    torch.manual_seed(0)
    cell = spec.load_cell(cell_name, root)
    name = STEP[cell_name]
    orig = getattr(StreamPipeline, name)
    if FAULTS[fault] is not None:
        def broken(self, state, x, *args, **kwargs):
            new, out = orig(self, state, x, *args, **kwargs)
            return FAULTS[fault](state, new, out)

        monkeypatch.setattr(StreamPipeline, name, broken)
    out = run.run_cell(cell, SEED, SECONDS[cell_name], False, "cpu", 0.0)
    assert out["correct"] is (fault == "none"), out["checks"]
    if fault == "delta_altered" and "delta_off_steps" in out["checks"]:
        # One stream wrong in every checked step fails the count of steps a
        # stream is off, whatever share of the batch that stream is.
        c = out["checks"]["delta_off_steps"]
        assert c["value"] > c["limit"], out["checks"]
