"""The four-estimator codec deployment through ``run_batch``, and the spans
of the consumers' sections.

* ``run_batch`` with almeida, homography, multiview and libmv and the
  ``block_motion`` detector over a tiny seeded ``.mvec`` bank, three steps
  with libmv's state carried, against the benchmark's plain reference
  (``ofps_bench/reference``, a frozen copy of the port's plain code) with
  the same draws and the reference's own carried states: every step's
  ``delta_rot`` and ``delta_tr`` bit for bit, as the reference's own test
  of the four estimators finds them on the CPU.
* The eager path's spans: one ``consumers.est.<name>`` a step for each
  estimator and one ``consumers.det.block_motion``, children of
  ``consumers``, host times only.
* On the card (``cuda``, skips without one): the sections of a captured
  all-four graph give device times on every replay that are positive and
  sum to no more than the replay's, per-section node counts that sum to
  no more than the graph's (multiview's at most 1,500, on its kernels),
  and outputs identical to a graph captured without the sections; and
  multiview's kernels are its plain version bit for bit at the codec all4
  cell's shapes.
"""

import json

import numpy as np
import pytest
import torch

from ofps_bench import check, inputs, serve, spec
from ofps_bench.reference.step import Reference
from ofps_torch.apps import batch as tbatch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 2**31 + 2026
B, STEPS = 2, 3
NAMES = ("almeida", "homography", "multiview", "libmv")


def _config():
    """The all-four codec configuration at 320x176, capacity 512."""
    cfg = json.loads((spec.ROOT / "ofps_bench/configs/codec_track_1080p.json").read_text())
    cfg.update(width=320, height=176, capacity=512,
               estimators=[{"name": n, "properties": {}} for n in NAMES])
    cfg["camera"]["aspect"] = 320 / 176
    tr = json.loads((spec.ROOT / "ofps_bench/traffic/codec_b8.json").read_text())
    tr.update(streams=B, bank_frames=4)
    return cfg, tr


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``run_batch``'s result over the bank, the bank and the configuration."""
    tmp = tmp_path_factory.mktemp("all4")
    cfg, tr = _config()
    bank = inputs.codec_bank(SEED, B, cfg, tr)
    paths, gts = [], []
    for s in range(B):
        paths.append(str(tmp / f"s{s}.mvec"))
        gts.append(tmp / f"s{s}_gt.csv")
        inputs.write_mvec(tmp / f"s{s}.mvec", bank.pos[s], bank.motion[s])
        serve._write_gt(gts[-1], bank.truth[s], cfg["camera"]["fov_y"])
    res = tbatch.run_batch(
        paths, estimators=cfg["estimators"], detector="block_motion",
        camera_aspect=cfg["camera"]["aspect"], camera_fov_y=cfg["camera"]["fov_y"],
        capacity=cfg["capacity"], max_frames=STEPS, seed=SEED,
        ground_truths=[str(g) for g in gts], device="cpu")
    return res, bank, cfg


def test_run_batch_all_four_matches_the_reference(served):
    res, bank, cfg = served
    assert res.frames == STEPS and res.estimator_names == list(NAMES)
    assert [len(h) for h in res.delta_tr] == [STEPS] * len(NAMES)
    ref = Reference(cfg, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    states = None
    for t in range(STEPS):
        rows = check._rows(bank, t, cfg["capacity"], "cpu")
        got = ref.codec_step(rows, ref.draws(gen, B, cfg["capacity"], dense=False), states)
        states = got.states
        for e in range(len(NAMES)):
            assert res.delta_tr[e][t].shape == (B, 3)
            assert res.delta_tr[e][t].dtype == np.float32
            np.testing.assert_array_equal(res.delta_rot[e][t], got.delta[e].numpy())
            np.testing.assert_array_equal(res.delta_tr[e][t], got.tr[e].numpy())
        np.testing.assert_array_equal(res.detections[t], got.detected.numpy())
    # The chain started at step 1 and carried on: libmv translates at the
    # last step, and almeida never does.
    assert float(states[3].has.min()) == 1.0
    assert float(np.linalg.norm(res.delta_tr[3][-1], axis=-1).min()) > 0
    assert not res.delta_tr[0][-1].any()


def test_eager_spans_one_per_section_a_step(served):
    res = served[0]
    for step, spans in res.perf.spans.items():
        consumers = next(sp for sp in spans if sp.name == "consumers")
        kids = [sp for sp in spans if sp.parent is consumers]
        assert [sp.name for sp in kids] == (
            [f"consumers.est.{n}" for n in NAMES] + ["consumers.det.block_motion"]), step
        for sp in kids:
            assert sp.step == step and sp.device_ms is None  # host times only
            assert consumers.start <= sp.start <= sp.end <= consumers.end
    assert res.perf.missed == 0


@pytest.mark.cuda
def test_graph_sections_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import SparseFlow
    from ofps_torch.detectors.base import create_detector
    from ofps_torch.estimators.base import create_estimator
    from ofps_torch.parallel import stream
    from ofps_torch.pipeline import graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, tr = _config()
    bank = inputs.codec_bank(SEED, B, cfg, tr)
    pipe = stream.StreamPipeline(
        StandardCamera.create(cfg["camera"]["aspect"], cfg["camera"]["fov_y"]),
        [create_estimator(n) for n in NAMES], create_detector("block_motion"), device=dev)
    perf = pipe.perf
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = pipe.init_state(B, 1, 1)
    flows = []
    for t in range(4):
        rows = check._rows(bank, t, cfg["capacity"], dev)
        flows.append(SparseFlow(rows[..., 0:2], rows[..., 2:4], rows[..., 4]))
        state, _ = pipe.step_from_flow(state, flows[-1], gen)
    torch.cuda.synchronize()
    assert pipe.graph_replays == 4 and len(pipe.graphs.calls) == 1
    sections = [f"consumers.est.{n}" for n in NAMES] + ["consumers.det.block_motion"]
    capture = next(sp for spans in perf.spans.values() for sp in spans
                   if sp.name == "consumers.capture")
    by_section = capture.nodes_by_section
    assert list(by_section) == [*NAMES, "block_motion"]
    assert all(n > 0 for n in by_section.values())
    # Two event-record nodes a section besides the sections' own work.
    assert sum(by_section.values()) + 2 * len(sections) <= capture.nodes
    # Multiview's RANSAC runs on its kernels (5,516 nodes before them at
    # B=8); its section keeps the LO rounds' sums and the pose stages.
    assert by_section["multiview"] <= 1500, by_section
    perf.resolve(wait=True)
    for step in range(4):
        spans = perf.spans[step]
        launch = next(sp for sp in spans if sp.name == "consumers.launch")
        timed = [sp for sp in spans if sp.parent is launch]
        assert [sp.name for sp in timed] == sections
        assert all(sp.device_ms is not None and sp.device_ms > 0 for sp in timed), step
        assert sum(sp.device_ms for sp in timed) <= launch.device_ms
    assert perf.missed == 0

    # The same graph captured without the sections: the same outputs, bit
    # for bit, and the event-record nodes are the only nodes between them.
    (graphed,) = pipe.graphs.calls.values()
    draws = tuple(e.draw(gen, (B,), cfg["capacity"], dev, dense=False)
                  for e in pipe.estimators)
    # ``_run_consumers``' static inputs, without props.
    tree = (flows[-1], tuple(state.rot), tuple(state.pos), draws, tuple(state.est), ())
    xs = tuple(graphs.leaves(tree))

    def consume(*ys):
        f, rot, pos, d, est, _ = graphs.rebuild(tree, iter(ys))
        return pipe._consume(f, rot, pos, d, est)

    plain = graphs.CapturedCall(consume, xs)
    assert plain.nodes + 2 * len(sections) == graphed.nodes
    a = graphs.leaves(graphed(xs, perf))
    b = graphs.leaves(plain(xs, perf))
    assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.cuda
def test_multiview_kernels_are_the_plain_version_on_the_card():
    """Multiview's RANSAC kernels at the codec all4 cell's shapes (B=8, the
    16,384-row capacity, masked, 218 hypotheses) on the benchmark's codec
    bank: the candidates, the adapted cut, the 32 finalists and the winner,
    the refit E, the LO model, the inliers and their count, and the
    estimator's rotations are the plain version's bit for bit (the kernels
    copy PyTorch's card arithmetic at these shapes); one call adds
    ``LAUNCHES`` launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import SparseFlow
    from ofps_torch.estimators import multiview as mv
    from ofps_torch.estimators.base import camera_intrinsics, create_estimator
    from ofps_torch.kernels import multiview as kmv
    from ofps_torch.ops import robust
    from ofps_torch.ops.epipolar import sampson_error
    from ofps_torch.ops.five_point import five_point_essential

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = json.loads((spec.ROOT / "ofps_bench/configs/codec_all4_1080p.json").read_text())
    tr = json.loads((spec.ROOT / "ofps_bench/traffic/codec_b8.json").read_text())
    b = tr["streams"]
    bank = inputs.codec_bank(SEED, b, cfg, tr)
    cam = StandardCamera.create(cfg["camera"]["aspect"], cfg["camera"]["fov_y"])
    est = create_estimator("multiview")
    params, h = est.params, mv.hypothesis_count(est.params)
    k, kinv = camera_intrinsics(cam, str(dev))
    thr = params.max_error / ((k[0, 0] + k[1, 1]) * 0.5)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for t in (1, 2):
        rows = check._rows(bank, t, cfg["capacity"], dev)
        flow = SparseFlow(rows[..., 0:2], rows[..., 2:4], rows[..., 4])
        x1 = mv.normalized_coords(kinv, flow.pos)
        x2 = mv.normalized_coords(kinv, flow.pos + flow.motion)
        idx = est.draw(gen, (b,), flow.mask.shape[-1], dev, dense=False)
        out = kmv._launch(x1, x2, flow.mask, thr, params, h, idx, False, None)
        ii = robust.as_indices(idx, flow.mask)
        models, valid = five_point_essential(*(
            robust._take_points(x, ii) for x in (x1, x2)),
            robust._take_points(flow.mask[..., None], ii)[..., 0])
        models = models.reshape(out["models"].shape)
        same = (out["models"] == models) | (out["models"].isnan() & models.isnan())
        assert bool(same.all())  # NaNs where the plain version has them
        valid = valid.reshape(b, -1) & torch.isfinite(models).flatten(-2).all(-1)
        assert torch.equal(out["valid"].bool(), valid)
        # The finalists: robust_fit's prescore (the adaptive cut over the
        # prescore medians, the counts, the stable top 32) on these
        # candidates.
        eidx, we = robust.eval_subset(flow.mask, params.eval_cap)
        pidx = eidx[:, :: eidx.shape[-1] // params.prescore_cap][:, :params.prescore_cap]
        errs = sampson_error(models, *(robust._take_points(x, pidx)[:, None] for x in (x1, x2)))
        wp = torch.gather(we, -1, torch.arange(params.prescore_cap, device=dev)[None].expand(b, -1)
                          * (eidx.shape[-1] // params.prescore_cap))
        med = robust.masked_median(errs, wp[:, None])
        t = thr.to(torch.float32)
        sigma_k = 2.5 * 1.4826 * (1.0 + 5.0 / (torch.clamp(torch.sum(we, dim=-1), min=6.0) - 5))
        thr2 = torch.maximum(t * t, torch.square(sigma_k) * torch.clamp(
            torch.min(torch.where(valid, med, 1e30), dim=-1).values, min=0.0))
        assert torch.equal(thr2, out["thr2"])
        pre = torch.where(valid, ((errs <= thr2[:, None, None]) & (wp[:, None] > 0.5)).sum(-1), -1)
        cand = torch.sort(pre.float(), dim=-1, descending=True, stable=True).indices[:, :32]
        assert torch.equal(cand, out["cand"])
        before = kmv.ransac.launches
        e, fit = kmv.ransac(x1, x2, flow.mask, thr, params, h, idx=idx)
        assert kmv.ransac.launches == before + kmv.LAUNCHES
        e_p, fit_p = kmv.ransac_plain(x1, x2, flow.mask, thr, params, h, idx=idx)
        assert torch.equal(e, e_p)
        for a, p in zip(fit, fit_p, strict=True):
            assert torch.equal(a, p)
        assert torch.equal(out["best"], fit_p.best)
        got, _, _ = est.estimate((), flow, cam, dense=False, fit_idx=idx)
        ref, _, _ = est.estimate((), flow, cam, dense=False, fit_idx=idx, plain=True)
        assert torch.equal(got, ref)
