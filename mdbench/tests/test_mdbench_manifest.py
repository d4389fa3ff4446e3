"""``BENCHMARK.json`` against the contract's character rules, every cell's
files found by name, and no JAX: importing the harness and building a
cell's inputs loads no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``mtp_tpu`` (compared whole: ``mtp_tpu_torch`` is another
name)."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(NAME.fullmatch(n) for n in names) and len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    sys.path.insert(0, str(ROOT))
    from mdbench.run import Cell, quantity

    c = Cell(cell)
    assert (ROOT / f"mdbench/traffic/{c.traffic['driver']}.py").exists()
    assert c.limits and all(isinstance(v, float) for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert (ROOT / f"mdbench/metrics/{quantity(m['name'])}.py").exists()
        assert m["moves"] in reported
    assert any(m["name"] != "setup_s" for m in c.end_to_end) and c.per_layer
    for path in BENCH["paths"]:
        assert (ROOT / path).is_dir()
    for cfg in BENCH["configs"]:
        assert cfg["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_no_jax_is_loaded():
    code = (
        "import sys\n"
        "from mdbench.run import Cell\n"
        "from mdbench import inputs, judge, control, trace, work\n"
        "import mdbench.traffic.simulation_run, mdbench.traffic.extrapolation_run\n"
        "c = Cell('fcc32k.al10')\n"
        "c.config['lattice']['reps'] = [3, 3, 3]\n"
        "c.traffic['active_set']['reps'] = [3, 3, 3]\n"
        "inputs.make(c.config, c.traffic, 2**40 + 1)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "mtp_tpu"}


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "mdbench" / "reference").glob("*.py"):
        text = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(mtp_tpu|jax)", text, re.M), f.name
    for f in (ROOT / "mdbench").rglob("*.py"):
        text = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|mtp_tpu)(\s|\.|$)",
                             text, re.M), f.name
        # the JAX package's benchmarks and their records are never read
        assert not any(w in text for w in ("bench" + "_suite", "bench" + ".py", "BENCH" + "_")), \
            f.name
