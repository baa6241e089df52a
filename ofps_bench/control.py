"""The control of ``correct``: the reference, put in the program's place and
computed in the nearest precision below the configuration's (float32 with
TF32 off, so TF32), judged by the float32 reference exactly as a run's
outputs are.  It has to come out not correct.

    python3 -m ofps_bench.control --workload <cell> --seeds <n,n,..>

For each seed: the cell's inputs from the seed, then the control over the
run's first steps (the codec path: ``1 + check_steps`` steps; the frames
path: ``2 + check_steps`` steps carrying its own warm start and poses), at
the cell's batch and sizes.  Prints one JSON line per seed with the numbers
and whether they pass the cell's limits.  The benchmark's runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ofps_bench import check, inputs, spec
from ofps_bench.reference import quat
from ofps_bench.reference.motion import grid_size_for
from ofps_bench.reference.step import Reference


class _Outputs(NamedTuple):
    window: range
    outputs: Dict


def _integrate(deltas: List[List[torch.Tensor]]) -> List[np.ndarray]:
    """Per estimator (T, B, 4): the poses the control integrates."""
    out = []
    for per_step in zip(*deltas):
        rot = quat.identity(device=per_step[0].device).expand_as(per_step[0])
        hist = []
        for d in per_step:
            rot = quat.mul(d, rot)
            hist.append(rot.cpu().numpy())
        out.append(np.stack(hist))
    return out


def control_codec(cell, seed: int, device, mode: str) -> _Outputs:
    cfg, tr = cell.config, cell.traffic
    b, cap = tr["streams"], cfg["capacity"]
    bank = inputs.codec_bank(seed, b, cfg, tr)
    ctl = Reference(cfg, device, mode)
    gen = torch.Generator(device=ctl.device).manual_seed(seed)
    steps = 1 + tr["check_steps"]
    deltas, dets = [], []
    for t in range(steps):
        got = ctl.codec_step(check._rows(bank, t, cap, ctl.device),
                             ctl.draws(gen, b, cap, dense=False))
        deltas.append(got.delta)
        dets.append(got.detected.cpu().numpy())
    counts = np.array([[min(len(bank.pos[s][t % len(bank.pos[0])]), cap) for s in range(b)]
                       for t in range(steps)])
    return _Outputs(range(steps), {
        "bank": bank, "rot": _integrate(deltas),
        "delta": [np.stack([d[e].cpu().numpy() for d in deltas]) for e in range(len(ctl.ests))],
        "detected": np.stack(dets), "vectors": counts})


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
    steps = 2 + tr["check_steps"]
    held, deltas, dets = {}, [], []
    for t in range(steps):
        hp = torch.full((b,), float(t > 0), device=dev)
        prev = bank[inputs.bank_index(max(t - 1, 0), n_bank)].to(dev)
        cur = bank[inputs.bank_index(t, n_bank)].to(dev)
        grid, nxt = ctl.flow(prev, cur, warm, hp)
        got = ctl.consume(grid, ctl.draws(gen, b, gw * gh, dense=True), props)
        held[t] = {"warm_in": warm, "grid": grid, "warm_out": nxt}
        warm = nxt
        deltas.append(got.delta)
        dets.append(got.detected.cpu().numpy())
    return _Outputs(range(steps), {
        "bank": bank, "rot": _integrate(deltas),
        "delta": [np.stack([d[e].cpu().numpy() for d in deltas]) for e in range(len(ctl.ests))],
        "detected": np.stack(dets), "held": held})


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
