"""The four-estimator codec cell's files: the cell loads, its four readers
give known answers on a hand-made recorder (and nothing where the program
records no such span or counter), and ``checks/tr_deg.py`` reads 0 on the
reference against itself and a planted fault above the cell's limit."""

import json
import shutil
import types

import numpy as np
import pytest
import torch

from ofps_bench import check, inputs, serve, spec
from ofps_bench.reference import quat
from ofps_bench.reference.step import Reference
from ofps_bench.tests import tiny
from ofps_torch.pipeline import runtime

SEED = 2**31 + 2020
CELL = "codec_all4_1080p.b8"
READERS = ("multiview_replay_ms", "libmv_replay_ms", "multiview_graph_nodes",
           "libmv_graph_nodes")


def test_the_cell_loads():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["streams"] == 8
    assert [e["name"] for e in cell.config["estimators"]] == [
        "almeida", "homography", "multiview", "libmv"]
    assert {m["name"] for m in cell.end_to_end} >= {"stream_fps", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= layer
    assert {"consumers_device_ms", "consumers_replay_ms", "consumers_graph_nodes",
            "capture_s", "device_idle_pct"} <= layer
    # The configuration is the two-estimator codec one but for its estimators,
    # names and the memory it assumes.
    two = json.loads((spec.ROOT / "ofps_bench/configs/codec_track_1080p.json").read_text())
    four = dict(cell.config)
    assert four.pop("assumed").items() > two.pop("assumed").items()
    for key in ("name", "source", "why", "estimators"):
        four.pop(key)
        two.pop(key, None)
    limits = four.pop("limits")
    assert limits.items() >= two.pop("limits").items()
    assert four == two


class _Event:
    """A timing event of a replayed graph: complete or not, its time from
    the section's start event."""

    def __init__(self, ms=0.0, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms


def _perf():
    """Steps 0-19: a consumers' launch whose replay times multiview's and
    libmv's sections (device ms 3 t and 4 t; libmv's end event still
    running at step 13 when the graph replays again), and captures at
    steps 0 and 12 counting the sections' nodes."""
    perf = runtime.PerfStats()
    for t in range(20):
        with perf.span("step", t=10.0 * t, step=t):
            launch = perf.open("consumers.launch", t=10.0 * t + 1.0)
            perf.close(launch, t=10.0 * t + 2.0)
            spans = perf.replayed(launch, [
                ("consumers.est.multiview", _Event(), _Event(3.0 * t)),
                ("consumers.est.libmv", _Event(), _Event(4.0 * t, done=t != 13))])
            perf.settle(spans)  # the next replay
            if t in (0, 12):
                sp = perf.open("consumers.capture", t=10.0 * t + 3.0)
                perf.close(sp, t=10.0 * t + 4.0)
                sp.nodes_by_section = {"multiview": 5000 + t, "libmv": 6000 + t, "almeida": 3}
    assert perf.missed == 1
    return perf


def _record(window=range(10, 20), traced=range(15, 17)):
    served = serve.Served(step_s=[0.03] * len(window), window_s=0.0, frames=0, t_open=0.0,
                          window=window, perf={}, counters={}, timeline=None, outputs={},
                          failed=0, traced=traced)
    return types.SimpleNamespace(served=served, timeline=None, cell=None)


@pytest.mark.parametrize("name, want", [
    # The steps before the profiler: 10-13 (it starts in step 14).
    ("multiview_replay_ms", 3.0 * 11.5),
    ("libmv_replay_ms", 4.0 * 11.0),  # step 13 has no reading: 10-12
    ("multiview_graph_nodes", 5012.0),  # the last capture's
    ("libmv_graph_nodes", 6012.0),
])
def test_readers(monkeypatch, name, want):
    read = spec.metric_reader(name)
    monkeypatch.setattr(runtime, "_LAST", _perf())
    assert read(_record()) == pytest.approx(want)
    # No such span or counter: an empty recorder, one whose spans carry host
    # times only (the eager path), and a program without a recorder.
    monkeypatch.setattr(runtime, "_LAST", runtime.PerfStats())
    assert read(_record()) is None
    eager = runtime.PerfStats()
    for t in range(20):
        with eager.span("step", step=t):
            with eager.span("consumers.est.multiview"):
                pass
            with eager.span("consumers.capture") as sp:
                sp.nodes = 10
    monkeypatch.setattr(runtime, "_LAST", eager)
    assert read(_record()) is None
    monkeypatch.setattr(runtime, "_LAST", None)
    assert read(_record()) is None


# -- tr_deg --------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_all4(tmp_path_factory):
    """A tiny all-four cell with the cell's limits and its tr_deg check
    file, its bank, and the reference's own per-step translations over its
    first steps, libmv's chain carried from step 0 as the program carries
    it."""
    root = tiny.make_root(tmp_path_factory.mktemp("all4"))
    (root / "ofps_bench/checks").mkdir()
    shutil.copy(spec.check_path("tr_deg"), root / "ofps_bench/checks/tr_deg.py")
    limits = spec.load_cell(CELL).config["limits"]
    name = tiny.add_cell(root, "codec_all4_tiny.b2", "codec_tiny", "codec_tiny",
                         estimators=tiny.ALL4, limits=limits)
    cell = spec.load_cell(name, root)
    assert check.file_limits(cell.config, root) == ["tr_deg"]
    cfg, b = cell.config, cell.traffic["streams"]
    bank = inputs.codec_bank(SEED, b, cfg, cell.traffic)
    ref = Reference(cfg, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    tr, states = [[] for _ in ref.ests], None
    for t in range(5):
        got = ref.codec_step(check._rows(bank, t, cfg["capacity"], "cpu"),
                             ref.draws(gen, b, cfg["capacity"], dense=False), states)
        states = got.states
        for e, x in enumerate(got.tr):
            tr[e].append(x.numpy().copy())
    return cell, bank, ref, tr


def _served(bank, tr):
    return types.SimpleNamespace(outputs={"bank": bank,
                                          "result": types.SimpleNamespace(delta_tr=tr)})


def test_tr_deg_reads_zero_on_the_reference(tiny_all4):
    """The reference against itself reads 0; its chained translations, as
    the program carries libmv's chain, read no more than float32 rounding
    against the check's reference, which starts each checked step afresh:
    the chain sets only a translation's signed length, and scaling a unit
    vector rounds each component by at most 2**-24 of itself (~1e-5 deg at
    most).  libmv translates from step 1, the first after the bank's
    I-frame; its chain scales steps 2-4."""
    cell, bank, ref, tr = tiny_all4
    number = spec.check_number("tr_deg", cell.root)
    assert all(float(np.linalg.norm(tr[3][t], axis=-1).min()) > 0 for t in range(1, 5))
    gen = torch.Generator().manual_seed(SEED)
    fresh = [[] for _ in ref.ests]
    for t in range(5):
        got = ref.codec_step(check._rows(bank, t, cell.config["capacity"], "cpu"),
                             ref.draws(gen, 2, cell.config["capacity"], dense=False))
        for e, x in enumerate(got.tr):
            fresh[e].append(x.numpy())
    assert not np.array_equal(fresh[3][4], tr[3][4])  # the chain's length
    assert number(cell, SEED, _served(bank, fresh), ref, range(5)) == 0.0
    chained = number(cell, SEED, _served(bank, tr), ref, range(5))
    assert 0.0 <= chained < 1e-5


def test_tr_deg_reads_a_planted_fault(tiny_all4):
    cell, bank, ref, tr = tiny_all4
    number = spec.check_number("tr_deg", cell.root)
    bad = [[x.copy() for x in e] for e in tr]
    # Stream 1's libmv translation at step 3: negated (the sign is not
    # judged) and turned by 1 degree about an axis across it.
    t = bad[3][3][1].astype(np.float64)
    axis = np.cross(t, [0.0, 0.0, 1.0])
    q = quat.from_axis_angle(torch.tensor(axis / np.linalg.norm(axis)),
                             torch.tensor(np.radians(1.0), dtype=torch.float64))
    bad[3][3][1] = -quat.rotate_vec(q, torch.tensor(t)).numpy().astype(np.float32)
    got = number(cell, SEED, _served(bank, bad), ref, [0, 3])
    assert got == pytest.approx(1.0, abs=1e-3)
    assert got > cell.config["limits"]["tr_deg"]
    assert not check.passed(check.judge(
        dict(vectors_off=0.0, det_off=0.0, delta_deg=0.0, pose_deg=0.0, tr_deg=got),
        cell.config["limits"]))
    # A step not checked is not read.  A translation where the step's solve
    # found none (the I-frame at step 0) reads 90 degrees; one the chain
    # has shrunk to nothing, or to float32's last bits, is not judged; one
    # that is not finite reads inf.
    assert number(cell, SEED, _served(bank, bad), ref, [0, 2]) < 1e-5
    bad[3][0][1] = [1e-20, 0.0, 0.0]
    assert number(cell, SEED, _served(bank, bad), ref, [0, 2]) == 90.0
    bad[3][0][1] = 0.0
    bad[3][2][0] = [1e-40, 0.0, 0.0]
    bad[3][2][1] = 0.0
    assert number(cell, SEED, _served(bank, bad), ref, [0, 2]) == 0.0
    bad[3][2][1] = np.nan
    assert number(cell, SEED, _served(bank, bad), ref, [0, 2]) == np.inf
    with pytest.raises(ValueError, match="delta_tr"):
        number(cell, SEED, types.SimpleNamespace(outputs={"bank": bank, "result": None}),
               ref, [0, 2])
