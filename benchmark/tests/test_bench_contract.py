"""BENCHMARK.json against the benchmark's contract: names, units,
lengths, keys, and that every file the harness finds by name is there;
and that nothing a run loads is JAX or the JAX package."""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in
                                               BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    metric_names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert set(m.get("workloads", [])) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:      # each cell: setup_s, another end-to-end metric
        own = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert len(own) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in BENCH["per_layer"])


def test_the_run_loads_no_jax():
    """Import every module a run of each driver loads and run the tiny
    sample cell on the CPU in a fresh interpreter; then no module of
    JAX, flax or the JAX package may be loaded, by top-level name."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import importlib, torch
torch.set_num_threads(2)
from benchmark import harness, run, compare, follow, program, flops, tracing
for d in ("serve", "train", "sample"):
    importlib.import_module("benchmark.drivers." + d)
from benchmark.tests import tiny
r = tiny.cell("structure-146m.sample-ddpm1000-b64", seconds=0.5,
              mix={{"batch_size": 2, "ligand_len": 8, "pocket_len": [8, 12],
                   "peptide_len": [5, 8]}},
              config={{"sample": {{"max_seq_len": 16, "pocket_ext": 0,
                                  "sampler": "ddpm", "timesteps": 20}}}},
              spec={{"steps_followed": 4}})
importlib.import_module("benchmark.drivers.sample").run(r)
run.read_per_layer(r)
import e3diff_tpu_torch.serving, e3diff_tpu_torch.training
print("FOUND", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    # the top-level name is compared whole: the port's name begins with
    # the JAX package's
    from benchmark.harness import FORBIDDEN

    assert "e3diff_tpu_torch".split(".")[0] not in FORBIDDEN


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "structure-146m.train-b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout.strip() == ""
