"""``correct``: what the timed path produced, held against the reference.

The checked steps are the start of the run (step 0, and for the frames path
step 1, the first with a previous frame) and ``check_steps`` steps of the
window drawn from the seed; every stream of each.  The reference makes the
RANSAC draws again from the seed, the same calls in the same order as the
served step, and takes the inputs from the banks.  It judges the program's
answers only; where a step carries state (the frames path's warm start, the
integrated pose), it starts from the program's state at that step, and the
state the step hands on is compared too (the warm start), or the whole
chain is checked from its start (step 0).

Numbers, each against the limit the configuration's ``limits`` give.  A
rotation's gap is the angle between the served rotation and the
reference's (homography: the nearer of its two decomposition families);
a pose's, between the served integrated rotation and the reference's delta
applied to the served rotation of the step before.

* ``vectors_off`` (codec): window steps x streams whose count of vectors
  fed is not the bank's (every window step; exact).
* ``delta_deg``, ``pose_deg`` (codec): the widest rotation and pose gap.
* ``delta_q75_deg``, ``pose_q75_deg`` (frames): the upper quartile of the
  gaps over the checked streams and steps, of the estimator where it is
  widest.  The served flow comes from the hand kernels and the reference's
  from their plain versions, which part on near-ties; where a region of the
  grid parts, a RANSAC refit moves, so the widest gap swings from seed to
  seed, and the upper-quartile answer is the steady number (one that a
  fault in half the streams still moves).
* ``delta_off_steps``, ``pose_off_steps`` (frames): the most checked steps
  in which one stream's rotation, of one estimator, is off by more than
  ``OFF_DEG``.  A near-tie moves one stream in one step; a stream whose
  answers are wrong is off in every checked step, whatever the batch.
* ``det_off``: steps x streams whose detection verdict differs (exact).
* ``grid_off`` (frames): the share of the served 150 x 84 grid's entries
  off the reference's by more than 1e-3 px.
* ``warm_off`` (frames): the share of the handed-on warm start's pixels
  off by more than 1e-3 px.

A configuration without estimators has no rotation or pose numbers.  A
key of ``limits`` that no number above covers is computed by
``ofps_bench/checks/<key>.py``: ``number(cell, seed, served, ref, checked)
-> float``, where ``served.outputs["result"]`` is the program's whole
result (``run_batch``'s ``BatchResult``; the frames path's fetched records,
one a step).  A limit that neither computes fails when the cell loads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ofps_bench import inputs, spec
from ofps_bench.reference import quat
from ofps_bench.reference.motion import grid_size_for
from ofps_bench.reference.step import Consumed, Reference, angle_deg

MISMATCH_PX = 1e-3
OFF_DEG = 1e-3


def _rows(bank: inputs.CodecBank, step: int, capacity: int, device) -> torch.Tensor:
    """(B, capacity, 5) packed rows of ``step``'s frames: valid entries
    first, in the bank's order, then zeros."""
    b = len(bank.pos)
    k = step % len(bank.pos[0])
    out = np.zeros((b, capacity, 5), np.float32)
    for s in range(b):
        n = min(len(bank.pos[s][k]), capacity)
        out[s, :n, 0:2] = bank.pos[s][k][:n]
        out[s, :n, 2:4] = bank.motion[s][k][:n]
        out[s, :n, 4] = 1.0
    return torch.from_numpy(out).to(device)


def _gaps(ref: Consumed, delta: List[np.ndarray], rot: List[np.ndarray], t: int):
    """Per estimator the (B,) delta and pose gaps (degrees) of step ``t``:
    ``delta``, ``rot`` per estimator (T, B, 4) served."""
    out = []
    for r, fam, d_e, r_e in zip(ref.delta, ref.families, delta, rot, strict=True):
        cands = (r[:, None, :] if fam is None else fam).detach().cpu().to(torch.float64)
        served = torch.from_numpy(d_e[t]).to(torch.float64)
        pose = torch.from_numpy(r_e[t]).to(torch.float64)
        # The served rotation before step t (identity before step 0).
        prev = (torch.from_numpy(r_e[t - 1]).to(torch.float64) if t > 0
                else quat.identity(torch.float64).expand_as(pose))
        d = angle_deg(served[:, None, :], cands).min(dim=1).values
        expect = quat.mul(cands, prev[:, None, :].expand_as(cands))
        p = angle_deg(pose[:, None, :], expect).min(dim=1).values
        out.append((d, p))
    return out


def codec_numbers(cell, seed: int, out, window: range, ref: Reference,
                  checked: Iterable[int]) -> Dict[str, float]:
    cfg = cell.config
    bank, b = out["bank"], cell.traffic["streams"]
    cap = cfg["capacity"]
    bank_n = np.array([[min(len(bank.pos[s][t % len(bank.pos[0])]), cap) for s in range(b)]
                       for t in window])
    nums = {"vectors_off": float((out["vectors"][window.start:window.stop] != bank_n).sum())}
    checked = sorted(set(checked))
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    det_off = 0
    for t in range(max(checked) + 1):
        draws = ref.draws(gen, b, cap, dense=False)
        if t not in checked:
            continue
        got = ref.codec_step(_rows(bank, t, cap, ref.device), draws)
        for d, p in _gaps(got, out["delta"], out["rot"], t):
            nums["delta_deg"] = max(nums.get("delta_deg", 0.0), float(d.max()))
            nums["pose_deg"] = max(nums.get("pose_deg", 0.0), float(p.max()))
        if got.detected is not None:
            det_off += int((got.detected.cpu().numpy() != out["detected"][t]).sum())
    nums["det_off"] = float(det_off)
    return nums


def frames_gaps(cell, seed: int, out, ref: Reference,
                checked: Iterable[int]) -> Dict[str, object]:
    """The frames path's gaps at the checked steps: the grid's (px), the
    warm start's share off, per estimator the (steps, B) delta and pose
    gaps (degrees), and the verdicts that differ."""
    b, n_bank = cell.traffic["streams"], cell.traffic["bank_frames"]
    held = out["held"]
    checked = sorted(t for t in set(checked) if t in held)
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    props = ref.device_props()
    gw, gh = grid_size_for(cell.config["width"], cell.config["height"])
    n = gw * gh
    scale = torch.tensor([cell.config["width"], cell.config["height"]], device=ref.device)
    grid_gaps, warm_off, det_off = [], 0.0, 0
    d_gaps = [[] for _ in ref.ests]
    p_gaps = [[] for _ in ref.ests]
    bank = out["bank"]
    for t in range(max(checked) + 1):
        draws = ref.draws(gen, b, n, dense=True)
        if t not in checked:
            continue
        h = held[t]
        dev = ref.device
        prev = bank[inputs.bank_index(max(t - 1, 0), n_bank)].to(dev)
        cur = bank[inputs.bank_index(t, n_bank)].to(dev)
        warm_in = tuple(x.to(dev) for x in h["warm_in"])
        # Every step after the first has a previous frame: the reference
        # knows that from the step, not from the program's state.
        has_prev = torch.full((b,), float(t > 0), device=dev)
        grid, warm = ref.flow(prev, cur, warm_in, has_prev)
        grid_gaps.append(((grid - h["grid"].to(dev)).abs() * scale).flatten())
        off = torch.maximum((warm[0] - h["warm_out"][0].to(dev)).abs(),
                            (warm[1] - h["warm_out"][1].to(dev)).abs())
        warm_off = max(warm_off, float((off > MISMATCH_PX).float().mean()))
        got = ref.consume(grid, draws, props)
        for e, (d, p) in enumerate(_gaps(got, out["delta"], out["rot"], t)):
            d_gaps[e].append(d)
            p_gaps[e].append(p)
        if got.detected is not None:
            det_off += int((got.detected.cpu().numpy() != out["detected"][t]).sum())
    return {"grid": torch.cat(grid_gaps), "warm_off": warm_off,
            "delta": [torch.stack(g) for g in d_gaps], "pose": [torch.stack(g) for g in p_gaps],
            "det_off": det_off}


def off_steps(gaps: torch.Tensor) -> float:
    """The most checked steps in which one stream is off by more than
    ``OFF_DEG``, of the (steps, B) ``gaps``."""
    return float((gaps > OFF_DEG).sum(dim=0).max())


def frames_numbers(cell, seed: int, out, window: range, ref: Reference,
                   checked: Iterable[int]) -> Dict[str, float]:
    g = frames_gaps(cell, seed, out, ref, checked)
    nums = {
        "grid_off": float((g["grid"] > MISMATCH_PX).float().mean()),
        "warm_off": g["warm_off"],
        "det_off": float(g["det_off"]),
    }
    if g["delta"]:
        nums.update(
            delta_q75_deg=max(float(torch.quantile(x.flatten(), 0.75)) for x in g["delta"]),
            pose_q75_deg=max(float(torch.quantile(x.flatten(), 0.75)) for x in g["pose"]),
            delta_off_steps=max(off_steps(x) for x in g["delta"]),
            pose_off_steps=max(off_steps(x) for x in g["pose"]),
        )
    return nums


NUMBERS = {"codec_mvec": codec_numbers, "frames": frames_numbers}
# The names of the numbers above: those of every configuration of the
# input, and those of a configuration with estimators.
BUILTIN = {
    "codec_mvec": (("vectors_off", "det_off"), ("delta_deg", "pose_deg")),
    "frames": (("grid_off", "warm_off", "det_off"),
               ("delta_q75_deg", "pose_q75_deg", "delta_off_steps", "pose_off_steps")),
}


def builtin_numbers(config) -> List[str]:
    always, rotations = BUILTIN[config["input"]]
    return list(always) + (list(rotations) if config["estimators"] else [])


def file_limits(config, root: Path) -> List[str]:
    """The keys of ``limits`` that no built-in number covers, each computed
    by ``ofps_bench/checks/<key>.py``; raises where no file computes one."""
    keys = [k for k in config["limits"] if k not in builtin_numbers(config)]
    missing = [k for k in keys if not spec.check_path(k, root).is_file()]
    if missing:
        raise ValueError(f"{config['name']}: nothing computes the limits {missing} "
                         f"(built in: {builtin_numbers(config)}; no ofps_bench/checks/<key>.py)")
    return keys


def checked_steps(cell, seed: int, window: range, out) -> List[int]:
    """The start steps and ``check_steps`` window steps drawn from the seed
    (the frames path drew them ahead, to hold their state: those held)."""
    if cell.config["input"] == "frames":
        return sorted(out["held"])
    rng = np.random.default_rng([seed, 7])
    k = min(cell.traffic["check_steps"], len(window))
    picks = rng.choice(len(window), size=k, replace=False)
    return [0] + sorted(window.start + int(i) for i in picks)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number with its limit; a number without a limit is an error in
    the configuration."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def numbers_of(cell, seed: int, served, device,
               checked: Optional[List[int]] = None) -> Dict[str, float]:
    """The numbers of ``served``'s outputs, judged by the float32 reference:
    the built-in ones, then those of the configuration's check files."""
    ref = Reference(cell.config, device)
    if checked is None:
        checked = checked_steps(cell, seed, served.window, served.outputs)
    nums = NUMBERS[cell.config["input"]](cell, seed, served.outputs, served.window, ref, checked)
    for key in file_limits(cell.config, cell.root):
        nums[key] = float(spec.check_number(key, cell.root)(cell, seed, served, ref, checked))
    return nums
