"""The benchmark of e3diff_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names its
configuration (``configs``, a file under benchmark/configs/) and its
traffic mix (benchmark/traffic/<traffic>.json); its own file,
benchmark/workloads/<name>.json, names the driver (benchmark/drivers/
<driver>.py) and the limits of the numbers that decide ``correct``. With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by
benchmark/metrics/<metric>.py.

The run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and when JAX, flax or the JAX package is
loaded once the window has closed. ``--control int8`` runs the cell with
the program's int8 weight path as the control of the output check; the
benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "int8"), default="none")
    p.add_argument("--rate-rps", type=float, default=None,
                   help="an open loop's rate in place of the mix's (the "
                        "sweep for a serving cell's knee)")
    return p.parse_args(argv)


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((ROOT / config["file"]).read_text())
    spec = json.loads((ROOT / "benchmark" / "workloads"
                       / f"{name}.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return bench, cell, conf, spec, mix


def read_per_layer(run) -> None:
    for m in run.bench["per_layer"]:
        if run.cell["name"] not in m.get("workloads", [run.cell["name"]]):
            continue
        path = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            run.metrics[m["name"]] = float(value)


def main(argv=None) -> int:
    args = parse(argv)
    bench, cell, conf, spec, mix = load_cell(args.workload)
    from benchmark import harness

    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.rate_rps is not None:
        mix = {**mix, "rate_rps": args.rate_rps}
    run = harness.Run(args, T0, bench, cell, conf, spec, mix, device)
    driver = importlib.import_module(f"benchmark.drivers.{spec['driver']}")
    driver.run(run)
    if run.trace:
        read_per_layer(run)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    line = harness.result_line(run, torch, int(cell["chips"]))
    if "power" in line["device"]:
        print(f"card: {line['device']['power']}", file=sys.stderr)
    for name, r in run.readings.items():
        print(f"check {name}: {r['value']!r} (limit {r['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
