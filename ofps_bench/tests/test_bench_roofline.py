"""``ofps_bench/roofline.py`` is chip_smoke.py's cost arithmetic."""

import chip_smoke
from ofps_bench import roofline


def test_constants_are_chip_smokes():
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "WARP_OPS", "DIFF_OPS", "UPSAMPLE_OPS",
                 "MEDIAN_OPS"):
        assert getattr(roofline, name) == getattr(chip_smoke, name)
    assert all(roofline.box_ops(w) == chip_smoke.box_ops(w) for w in (3, 5, 7))


def test_sweep_cost_at_the_serving_shapes():
    shapes = roofline.level_shapes(1080, 1920, 6)
    assert shapes[-1] == (33, 60)
    for b in (8, 32):
        for lvl in range(5):
            for n_cand in (5, 9, 169):
                args = (b, *shapes[lvl], *shapes[lvl + 1], n_cand, 5)
                assert roofline.sweep_cost(*args) == chip_smoke.sweep_cost(*args)
        grid = 8 * b * 84 * 150
        args = (b, 1080, 1920, 540, 960, 5, 5, grid)
        assert roofline.sweep_cost(*args) == chip_smoke.sweep_cost(*args)


def test_a_steps_launches():
    launches = roofline.serving_launches(8, 1080, 1920, (84, 150))
    assert [len(launches[k]) for k in ("refine_sep_kernel", "refine_2d_kernel",
                                       "guard_kernel")] == [4, 3, 1]
    # Level 1 takes the median of level 2's flow, as chip_smoke's
    # "median3x3_uv" case at 540x960 counts it.
    nb, ops = chip_smoke.sweep_cost(8, 540, 960, 270, 480, 5, 5)
    assert launches["refine_sep_kernel"][1] == (nb, ops + roofline.MEDIAN_OPS * 8 * 270 * 480)
    assert 0 < roofline.step_bound_ms(8, 1080, 1920, (84, 150)) < 1.0
