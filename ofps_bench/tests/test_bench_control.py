"""The control of ``correct``, the reference in TF32 in the program's place,
comes out not correct; the reference in float32 in its place passes.  On a
card, at a size a test run holds (TF32 exists only there)."""

import pytest
import torch

from ofps_bench import check, control, spec
from ofps_bench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["codec_tiny.b2", "frames_tiny.b2"])
def test_tf32_control_fails_and_float32_passes(card, tmp_path, cell_name):
    cell = spec.load_cell(cell_name, tiny.make_root(tmp_path))
    torch.backends.cuda.matmul.allow_tf32 = False
    limits = cell.config["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        assert not check.passed(check.judge(control.control_numbers(cell, seed, card, "tf32"),
                                            limits))
        assert check.passed(check.judge(control.control_numbers(cell, seed, card, "float32"),
                                        limits))
