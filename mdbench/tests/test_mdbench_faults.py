"""The comparison catches a broken program: a run of a cell at a small
size on the CPU (the harness's look for a card skipped), with the timed
path broken underneath, must come out not correct, and the same run
unbroken correct, under the cell's own limits. Faults of a one-card cell:
a block that returns its state unchanged, half of the atoms' forces left
out, and an answer altered where it is produced (one atom's force, one
atom's grade). No cell crosses cards, so none can leave out an exchange
between chips."""

import dataclasses
import sys
import types

import pytest
import torch

from mdbench.run import Cell, report, run_cell


def _tiny(name):
    cell = Cell(name)
    cell.config["lattice"]["reps"] = [5, 5, 5]
    cell.config["steps_per_rebuild"] = 10
    for key in ("blocks_per_call", "segments_per_call"):
        if key in cell.traffic:
            cell.traffic[key] = 1
    if "active_set" in cell.traffic:
        cell.traffic["active_set"]["reps"] = [5, 5, 5]
    return cell


def _run(name, fault=None):
    out = run_cell(_tiny(name), 2**33 + 17, 0.5, False, device="cpu", fault=fault)
    return out["result"]


def _edit_forces(edit):
    def fault(prog):
        sim = prog.sim
        make = sim.force_fn_window

        def broken(*a, **kw):
            fn = make(*a, **kw)

            def g(positions, types, cell):
                f, e, v = fn(positions, types, cell)
                return edit(f.clone()), e, v

            g.energy_fn = fn.energy_fn
            return g

        sim.force_fn_window = broken
    return fault


def _unchanged(prog):
    """Every block hands back the state it was given, with its step count
    advanced and its flags clear."""
    def block(state, aux, *, n_steps, **kw):
        no = torch.zeros((), dtype=torch.bool)
        return dataclasses.replace(state, step=state.step + n_steps), aux, no, no
    prog.sim.block = block


def _half(f):
    f[f.shape[0] // 2:] = 0.0
    return f


def _one_force(f):
    f[0] += 0.05 * f.abs().max()
    return f


def _one_grade(prog):
    monitor = prog.monitor
    compute = monitor._compute

    def broken(*a, **kw):
        out = compute(*a, **kw)
        g = out["grades"].clone()
        g[0] += 0.05 * g.max()
        return dict(out, grades=g, max_grade=g.max())

    monitor._compute = broken


@pytest.mark.parametrize("name", ["fcc32k.nve", "fcc32k.al10"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in Cell(name).end_to_end}


def test_jax_loaded_after_the_window_stops_the_result(monkeypatch, capsys):
    """A per-layer reader that loads a module named ``jax`` after the
    window: the check made last, just before the result would be printed,
    exits 3 and prints no result."""
    reader = types.ModuleType("mdbench.metrics.loads_jax")
    reader.WHEN = "after_trace"

    def read(ctx):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    reader.read = read
    monkeypatch.setitem(sys.modules, reader.__name__, reader)
    cell = _tiny("fcc32k.nve")
    cell.per_layer = [dict(name="loads_jax", unit="%", better="higher",
                           source="device_trace", layer="test", moves="atom_steps_per_s")]
    out = run_cell(cell, 2**33 + 19, 0.3, True, device="cpu")
    assert "jax" in sys.modules and out["result"]["correct"]
    with pytest.raises(SystemExit) as stop:
        report(out)
    assert stop.value.code == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,fault,check", [
    ("fcc32k.nve", _unchanged, "velocity"),
    ("fcc32k.nve", _edit_forces(_half), "force"),
    ("fcc32k.nve", _edit_forces(_one_force), "force"),
    ("fcc32k.al10", _one_grade, "grade"),
])
def test_fault_is_caught(name, fault, check):
    r = _run(name, fault)
    assert not r["correct"]
    c = r["checks"][check]
    assert c["value"] > c["limit"], r["checks"]
