"""The inputs repeat exactly for a seed and differ across seeds."""

import numpy as np
import torch

from ofps_bench import inputs, spec
from ofps_bench.tests import tiny

SEED = 2**31 + 977  # seeds may pass 32 signed bits


def _cells(tmp_path):
    root = tiny.make_root(tmp_path)
    return spec.load_cell("codec_tiny.b2", root), spec.load_cell("frames_tiny.b2", root)


def _flat(bank):
    return np.concatenate([np.concatenate(p + m) .ravel() for p, m in zip(bank.pos, bank.motion)])


def test_codec_bank_repeats_for_a_seed(tmp_path):
    codec, _ = _cells(tmp_path)
    a = inputs.codec_bank(SEED, 2, codec.config, codec.traffic)
    b = inputs.codec_bank(SEED, 2, codec.config, codec.traffic)
    c = inputs.codec_bank(SEED + 1, 2, codec.config, codec.traffic)
    assert np.array_equal(_flat(a), _flat(b)) and np.array_equal(a.truth, b.truth)
    assert not np.array_equal(a.truth, c.truth)
    assert len(a.pos[0][0]) == 0 and all(len(p) > 0 for p in a.pos[0][1:])  # the I-frame


def test_frames_bank_repeats_for_a_seed(tmp_path):
    _, frames = _cells(tmp_path)
    cfg, tr = frames.config, frames.traffic
    a = inputs.frames_bank(SEED, 2, cfg, tr, torch.device("cpu"))
    b = inputs.frames_bank(SEED, 2, cfg, tr, torch.device("cpu"))
    c = inputs.frames_bank(SEED + 1, 2, cfg, tr, torch.device("cpu"))
    assert a.dtype == torch.uint8 and a.shape == (tr["bank_frames"], 2, cfg["height"], cfg["width"])
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_frames_bank_plays_forwards_and_back():
    order = [inputs.bank_index(t, 4) for t in range(10)]
    assert order == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    assert all(a != b for a, b in zip(order, order[1:]))  # consecutive frames always differ
