"""Tiny configurations of the benchmark's cells, for runs of a driver on
the CPU (the harness's look for a card skipped)."""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from benchmark import harness
from benchmark.run import ROOT

TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 1,
        "intermediate_size": 96}


def cell(name: str, *, seconds: float = 1.0, seed: int = 2 ** 31 + 11,
         control: str = "none", mix: dict | None = None,
         spec: dict | None = None, config: dict | None = None):
    """A Run of cell ``name`` on the CPU at tiny widths."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = next(w for w in bench["workloads"] if w["name"] == name)
    conf = json.loads((ROOT / next(
        x["file"] for x in bench["configs"] if x["name"] == c["config"])
    ).read_text())
    conf = copy.deepcopy(conf)
    for part in ("structure", "sequence"):
        if part in conf:
            conf[part].update(TINY)
    conf.update(config or {})
    s = json.loads((ROOT / "benchmark" / "workloads"
                    / f"{name}.json").read_text())
    s.update(spec or {})
    m = json.loads((ROOT / "benchmark" / "traffic"
                    / f"{c['traffic']}.json").read_text())
    m.update(mix or {})
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=0, control=control, rate_rps=None)
    torch.manual_seed(0)
    return harness.Run(args, time.monotonic(), bench, c, conf, s, m,
                       torch.device("cpu"))
