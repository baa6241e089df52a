"""The control of ``correct``: the reference, put in the program's place and
computed in the nearest precision below the configuration's (float32 with
TF32 off, so TF32), judged by the float32 reference exactly as a run's
outputs are.  It has to come out not correct.

    python3 -m ofps_bench.control --workload <cell> --seeds <n,n,..>

For each seed: the cell's inputs from the seed, then the control over the
run's first steps (the codec path: ``1 + check_steps`` steps; the frames
path: ``2 + check_steps`` steps carrying its own warm start and poses), at
the cell's batch and sizes, carrying the estimators' state from step to
step as the program does; its ``outputs["result"]`` holds what it makes
under the program's field names, for the check files a configuration
brings.  Prints one JSON line per seed with the numbers and whether they
pass the cell's limits.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ofps_bench import check, inputs, spec
from ofps_bench.reference import quat
from ofps_bench.reference.motion import grid_size_for
from ofps_bench.reference.step import Consumed, Reference


class _Outputs(NamedTuple):
    window: range
    outputs: Dict


def _integrate(steps: List[Consumed]):
    """Per estimator the (T, B, 4) rotations and (T, B, 3) positions that
    the control integrates, as the program does: ``pos += rot * tr``, then
    ``rot = delta * rot``."""
    rots, poss = [], []
    for e in range(len(steps[0].delta)):
        d0 = steps[0].delta[e]
        rot = quat.identity(device=d0.device).expand_as(d0)
        pos = torch.zeros(d0.shape[:-1] + (3,), device=d0.device)
        rh, ph = [], []
        for got in steps:
            pos = pos + quat.rotate_vec(rot, got.tr[e])
            rot = quat.mul(got.delta[e], rot)
            rh.append(rot.cpu().numpy())
            ph.append(pos.cpu().numpy())
        rots.append(np.stack(rh))
        poss.append(np.stack(ph))
    return rots, poss


def _deltas(steps: List[Consumed]) -> List[np.ndarray]:
    """Per estimator (T, B, 4): the control's delta rotations."""
    return [np.stack([got.delta[e].cpu().numpy() for got in steps])
            for e in range(len(steps[0].delta))]


def control_codec(cell, seed: int, device, mode: str) -> _Outputs:
    cfg, tr = cell.config, cell.traffic
    b, cap = tr["streams"], cfg["capacity"]
    bank = inputs.codec_bank(seed, b, cfg, tr)
    ctl = Reference(cfg, device, mode)
    gen = torch.Generator(device=ctl.device).manual_seed(seed)
    n = 1 + tr["check_steps"]
    steps, states = [], None
    for t in range(n):
        got = ctl.codec_step(check._rows(bank, t, cap, ctl.device),
                             ctl.draws(gen, b, cap, dense=False), states)
        steps.append(got)
        states = got.states
    counts = np.array([[min(len(bank.pos[s][t % len(bank.pos[0])]), cap) for s in range(b)]
                       for t in range(n)])
    rot, pos = _integrate(steps)
    delta = _deltas(steps)
    detected = np.stack([got.detected.cpu().numpy() for got in steps])
    # ``run_batch``'s result, as far as the control makes it.
    result = SimpleNamespace(
        frames=n, streams=b, estimator_names=[e.name for e in ctl.ests],
        poses_rot=[r[-1] for r in rot], poses_pos=[p[-1] for p in pos],
        delta_rot=[list(d) for d in delta], rot_hist=[list(r) for r in rot],
        detections=detected, vectors=counts)
    return _Outputs(range(n), {
        "bank": bank, "rot": rot, "delta": delta, "detected": detected, "vectors": counts,
        "result": result})


def control_frames(cell, seed: int, device, mode: str) -> _Outputs:
    cfg, tr = cell.config, cell.traffic
    b, n_bank = tr["streams"], tr["bank_frames"]
    bank = inputs.frames_bank(seed, b, cfg, tr, device)
    ctl = Reference(cfg, device, mode)
    dev = ctl.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    gw, gh = grid_size_for(cfg["width"], cfg["height"])
    h2, w2 = (cfg["height"] + 1) // 2, (cfg["width"] + 1) // 2
    warm = tuple(torch.zeros((b, h2, w2), device=dev) for _ in range(2))
    props = ctl.device_props()
    n = 2 + tr["check_steps"]
    held, steps, states = {}, [], None
    for t in range(n):
        hp = torch.full((b,), float(t > 0), device=dev)
        prev = bank[inputs.bank_index(max(t - 1, 0), n_bank)].to(dev)
        cur = bank[inputs.bank_index(t, n_bank)].to(dev)
        grid, nxt = ctl.flow(prev, cur, warm, hp)
        got = ctl.consume(grid, ctl.draws(gen, b, gw * gh, dense=True), props, states)
        held[t] = {"warm_in": warm, "grid": grid, "warm_out": nxt}
        warm = nxt
        steps.append(got)
        states = got.states
    rot, pos = _integrate(steps)
    delta = _deltas(steps)
    detected = np.stack([got.detected.cpu().numpy() for got in steps])
    # The served path's fetched records, one a step.
    records = [{"rot": [r[t] for r in rot], "pos": [p[t] for p in pos],
                "delta": [d[t] for d in delta], "detected": detected[t]} for t in range(n)]
    return _Outputs(range(n), {
        "bank": bank, "rot": rot, "delta": delta, "detected": detected, "held": held,
        "result": records})


CONTROL = {"codec_mvec": control_codec, "frames": control_frames}


def control_numbers(cell, seed: int, device, mode: str = "tf32") -> Dict[str, float]:
    """The numbers of the control on ``seed``'s inputs."""
    out = CONTROL[cell.config["input"]](cell, seed, device, mode)
    return check.numbers_of(cell, seed, out, device, checked=list(out.window))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("ofps_bench.control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(cell, seed, torch.device("cuda:0"))
        checks = check.judge(nums, cell.config["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "passes": check.passed(checks), "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
