"""The control on the card: the reference in float32 with TF32 products,
put in the program's place, fails each cell's limits where the program
passes them. At a small box here; ``python -m mdbench.control`` reads the
same at the cells' own sizes (PERF.md)."""

import json
from pathlib import Path

import pytest
import torch

from mdbench import judge
from mdbench.control import control_outputs
from mdbench.run import Cell, run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_where_the_program_passes(cuda_device, name):
    cell = Cell(name)
    cell.config["lattice"]["reps"] = [8, 8, 8]
    for key in ("blocks_per_call", "segments_per_call"):
        if key in cell.traffic:
            cell.traffic[key] = 2
    out = run_cell(cell, 2**34 + 3, 1.0, False, device=cuda_device, keep_outputs=True)
    assert out["result"]["correct"], out["result"]["checks"]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = control_outputs(out["outputs"], out["inputs"], cell.traffic, cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = judge.reference_model(out["inputs"], cuda_device)
    correct, checks = judge.decide(judge.readings(ctl, out["inputs"], cell.traffic, ref),
                                   cell.limits)
    assert not correct, checks
