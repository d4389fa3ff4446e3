"""The control of the comparison: the reference, put in the program's place
and computed one precision below the configuration's.

    python -m mdbench.control --workload <cell> --seeds 11,12,13 [--seconds 3]

The configurations state float32 with TF32 off, so the control is the
reference in float32 with TF32 matrix products allowed (its radial sums and
readout are matrix products). For each seed it runs the cell as
``mdbench.run`` does, with a short window at the cell's own load, and prints
the compared numbers twice: for the program's outputs, and for the control's
outputs at the same states (forces, energy and grades at the final
state and the sampled block's start, and the sampled block integrated by
the control). A limit has to pass the first and fail the second. The
benchmark's own runs never run this. On a CUDA card only: TF32 exists there
alone.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mdbench import judge
from mdbench.reference.maxvol import grades
from mdbench.run import Cell, run_cell


def control_outputs(outputs: dict, inputs, traffic: dict, device) -> dict:
    """What the control produces in the program's place, shaped as the
    program's outputs (``mdbench.run``)."""
    low = judge.reference_model(inputs, device, torch.float32)
    al = outputs.get("grades") is not None
    fin, s = outputs["final"], outputs["sample"]
    cf = judge.evaluate(low, inputs, fin, candidates=al)
    final = dict(fin, forces=cf["forces"], potential_energy=cf["energy"])
    start = dict(s["start"], forces=judge.evaluate(low, inputs, s["start"])["forces"])
    end = judge.follow(low, inputs, traffic, s)
    g = grades(cf["b"], judge.active_set_of(low, inputs)) if al else None
    return dict(final=final, sample=dict(s, start=start, end=end), grades=g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("mdbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, device=args.device,
                       keep_outputs=True)
        prog = out["readings"]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ctl = control_outputs(out["outputs"], out["inputs"], cell.traffic, args.device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ref = judge.reference_model(out["inputs"], args.device)
        ctrl = judge.readings(ctl, out["inputs"], cell.traffic, ref)
        line = dict(workload=cell.name, seed=seed, program=prog, control=ctrl,
                    control_fails={k: not ok for k, ok in (
                        (k, cell.limits.get(k) is not None and np.isfinite(v)
                         and v <= cell.limits[k]) for k, v in ctrl.items())})
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
