"""The generator: fixed work per mix, the seed ordering it; the open
loop's latency from due times."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import generate
from benchmark.drivers.serve import latencies, nearest_rank

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def test_requests_deterministic_and_same_work_every_seed():
    mix = _mix("steady")
    a = generate.pocket_requests(mix, 50, 2 ** 31 + 5)
    b = generate.pocket_requests(mix, 50, 2 ** 31 + 5)
    c = generate.pocket_requests(mix, 50, 7)
    assert [r["sequence"] for r in a] == [r["sequence"] for r in b]
    assert all(np.array_equal(x["angles"], y["angles"]) for x, y in zip(a, b))
    key = lambda rs: sorted((len(r["sequence"]), r["peptide_length"],  # noqa
                             r["n_designs"]) for r in rs)
    assert key(a) == key(c)
    assert [r["sequence"] for r in a] != [r["sequence"] for r in c]
    for r in a:
        assert 16 <= len(r["sequence"]) <= 64 and 5 <= r["peptide_length"] <= 16
        assert 1 <= r["n_designs"] <= 8
        assert r["angles"].shape == (len(r["sequence"]), 8)


def test_arrivals_fill_the_window_with_one_set_of_gaps():
    mix = _mix("steady")
    a = generate.arrivals(mix, 20.0, 11)
    b = generate.arrivals(mix, 20.0, 12)
    assert len(a) == len(b) == round(mix["rate_rps"] * 20)
    assert np.all(np.diff(a) > 0) and a[-1] < 20.0
    assert not np.array_equal(a, b)
    assert np.array_equal(a, generate.arrivals(mix, 20.0, 11))
    # one sequence of gaps, started at another offset
    assert sorted(np.round(np.diff(a), 9)) != [] and np.allclose(
        sorted(np.diff(np.concatenate([[0.0], a]))),
        sorted(np.diff(np.concatenate([[0.0], b]))), atol=0.5 / 52)


def test_arrivals_are_poisson():
    """Exponential gaps: their spread is their mean, and bursts come."""
    mix = _mix("steady")
    gaps = np.diff(generate.arrivals(mix, 40.0, 3))
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1
    assert gaps.min() < 0.05 / mix["rate_rps"]


def test_complexes_deterministic_and_featurized_like_the_reference():
    mix = _mix("train-b64")
    a = generate.synthetic_complexes(mix, 8, 99)
    b = generate.synthetic_complexes(mix, 8, 99)
    assert all(np.array_equal(x["angle_features"], y["angle_features"])
               for x, y in zip(a, b))
    rows = generate.stack([generate.complex_arrays(r, 128, 4) for r in a])
    assert rows["ligand_angles"].shape == (8, 128, 8)
    assert rows["receptor_seq"].shape == (8, 128, 20)
    assert (rows["ligand_attn_mask"].sum(1)
            == [r["ligand_mask"].sum() for r in a]).all()


def test_pocket_extension_keeps_the_reference_quirk():
    m = np.zeros(10, bool)
    m[[0, 8]] = True
    got = generate.pocket_extend_mask(m, 2)
    # roll by +2 then clear [0]: 8 -> 0 (cleared), 0 -> 2; roll by -2 then
    # clear [-1]: 0 -> 8, 8 -> 6
    assert np.flatnonzero(got).tolist() == [0, 2, 6, 8]


def test_p95_from_due_times_moves_with_a_stall():
    due = np.arange(100) * 0.1
    start = 1000.0
    ok = [(start + d, start + d + 0.2, 200) for d in due]
    lat, failed = latencies(ok, due, start, 99.0)
    assert failed == 0 and nearest_rank(lat, 0.95) == pytest.approx(0.2)
    # a 3 s stall at t = 5 s: every request due in it waits until 8 s
    stalled = [(s, max(e, start + 8.0) if 5.0 <= d < 8.0 else e, st)
               for (s, e, st), d in zip(ok, due)]
    lat, _ = latencies(stalled, due, start, 99.0)
    assert nearest_rank(lat, 0.95) > 2.0
    # a refused request counts as lasting the give-up time
    refused = [(s, e, 429 if i % 10 == 0 else 200)
               for i, (s, e, _) in enumerate(ok)]
    lat, failed = latencies(refused, due, start, 99.0)
    assert failed == 10 and nearest_rank(lat, 0.95) == 99.0
