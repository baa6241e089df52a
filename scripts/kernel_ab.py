#!/usr/bin/env python3
"""Kernel times of two trees of the port on one card, in turns.

    python3 scripts/kernel_ab.py PARENT_TREE [CHANGED_TREE]

Each tree is a checkout (for example ``git archive HEAD`` unpacked into a
git-ignored directory); CHANGED_TREE defaults to this repository.  The
trees run in the order parent, change, change, parent, each in its own
process (``--one TREE``), which builds that tree's kernels and times every
kernel case of ``chip_smoke.kernel_cases`` (B=4) through that tree's
wrappers: ``ms`` (CUDA events around back-to-back calls) and ``device_ms``
(a CUDA graph of 20 calls, replayed), and checks each case against the
tree's plain version.  A tree whose refine wrappers lack ``median_in``
runs the "median3x3_uv" cases as its standalone median launch followed by
the refine, so the A/B compares two launches with the one fused launch for
the same function at the same shape.  Prints one line per case, the
device ms summed over each kernel's cases per run, then the whole result
as one JSON line.  Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    # This repository's chip_smoke (its cases and timers), the tree's port.
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ofps_torch.kernels import build

    build.library()
    device = torch.device("cuda", 0)
    cases = cs.kernel_cases(torch, device, 4)
    out = {}
    for name, items in cases.items():
        t = cs.time_cases(torch, items)
        agree = []
        for c in items:
            got, ref = c.kcall(), c.pcall()
            agree.append(cs.compare(torch, got, ref, c.kind)[2])
        out[name] = [
            {"shape": list(c.shape), "ms": m, "device_ms": d, "agrees": a}
            for c, m, d, a in zip(items, t["ms"], t["device_ms"], agree)
        ]
    print(json.dumps({"tree": tree, "source_digest": build.source_digest(),
                      "card": card(), "cases": out}))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) == 3 else str(HERE)
    runs = []
    for label, tree in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            sys.exit(f"{label} tree {tree} failed")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    table = {}
    for label, run in runs:
        for name, items in run["cases"].items():
            for i, c in enumerate(items):
                row = table.setdefault(f"{name} {tuple(c['shape'])} #{i}", {})
                row.setdefault(label, []).append(
                    {"ms": c["ms"], "device_ms": c["device_ms"], "agrees": c["agrees"]})
    for key, row in table.items():
        cells = []
        for label in ("parent", "change"):
            cells.append(f"{label} ms {[round(r['ms'], 4) for r in row[label]]} device_ms "
                         f"{[round(r['device_ms'], 4) for r in row[label]]} agrees "
                         f"{all(r['agrees'] for r in row[label])}")
        print(f"{key}: " + " | ".join(cells))
    for name in runs[0][1]["cases"]:
        sums = [(label, sum(c["device_ms"] for c in run["cases"][name])) for label, run in runs]
        print(f"{name} device_ms summed over its cases per run: "
              + ", ".join(f"{label} {v:.4f}" for label, v in sums))
    print(json.dumps({"card": runs[0][1]["card"], "order": [r[0] for r in runs],
                      "digests": [r[1]["source_digest"] for r in runs], "cases": table}))


if __name__ == "__main__":
    main()
