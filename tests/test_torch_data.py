"""The port's data slice (e3diff_tpu_torch) against the JAX package, on the
CPU: the schedule leaves, ``tolerant_comparison_check``,
``suggest_buckets`` and ``save_complexes``; the PDB / mmCIF / gzip readers;
the DSSP features of the numpy and the C++ engine; the metadata TSV read
with ``csv`` against pandas; ``run_preprocessing`` and the Biopython
engine (through tests/bio_fakes.py); the native library's build.

Tolerances: exact everywhere, but the port's C++ engine against its numpy
engine (H-bond energies and ASA within 1e-12: numpy's norm rounds through
BLAS) and the preprocessing records, which must be equal field by field.
"""

import gzip
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import bio_fakes
import e3diff_tpu.native as j_native
from e3diff_tpu.data import dataset as j_dataset
from e3diff_tpu.data import dssp as j_dssp
from e3diff_tpu.data import native_structure as j_ns
from e3diff_tpu.data import preprocessing as j_prep
from e3diff_tpu.data.synthetic import synthetic_complexes
from e3diff_tpu.ops import angles as j_angles
from e3diff_tpu.ops import schedules as j_schedules
from test_native_cif import write_chains_cif
from test_native_dssp import build_chain, write_chains_pdb

from e3diff_tpu_torch import native
from e3diff_tpu_torch.data import dataset, dssp
from e3diff_tpu_torch.data import native_structure as ns
from e3diff_tpu_torch.data import preprocessing as prep
from e3diff_tpu_torch.ops import angles, schedules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the leaves

@pytest.mark.parametrize("timesteps", [100, 500])
def test_schedule_leaves_match_jax_exactly(timesteps):
    np.testing.assert_array_equal(
        schedules.cosine_alpha_bar_schedule(timesteps),
        j_schedules.cosine_alpha_bar_schedule(timesteps))
    np.testing.assert_array_equal(
        schedules.cosine_alpha_bar_schedule(timesteps, raise_to_power=2.0),
        j_schedules.cosine_alpha_bar_schedule(timesteps, raise_to_power=2.0))
    got, want = (schedules.GammaNoiseSchedule.cosine(timesteps),
                 j_schedules.GammaNoiseSchedule.cosine(timesteps))
    np.testing.assert_array_equal(got.gamma, want.gamma)
    t = np.random.default_rng(0).uniform(0, 1, 33)
    np.testing.assert_array_equal(got(t), want(t))
    for nodes in (20, 50):
        np.testing.assert_array_equal(
            schedules.custom_beta_schedule_discrete(timesteps, nodes),
            j_schedules.custom_beta_schedule_discrete(timesteps, nodes))


def test_custom_beta_schedule_refuses_short_schedules():
    with pytest.raises(AssertionError):
        j_schedules.custom_beta_schedule_discrete(50)
    with pytest.raises(ValueError, match=">= 100"):
        schedules.custom_beta_schedule_discrete(50)


@pytest.mark.parametrize("cmp", [">=", "<="])
def test_tolerant_comparison_check_matches_jax(cmp):
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, 50)
    base[7] = np.nan
    for v in (0.0, 1.0, float(np.nanmin(base)) - 5e-6,
              float(np.nanmax(base)) + 5e-6, 0.5, -2e-5, 1 + 2e-5):
        want = j_angles.tolerant_comparison_check(base, cmp, v)
        assert angles.tolerant_comparison_check(base, cmp, v) == want
        assert angles.tolerant_comparison_check(
            torch.from_numpy(base), cmp, v) == want
    with pytest.raises(ValueError, match="Illegal comparator"):
        angles.tolerant_comparison_check(base, "<", 0.0)


@pytest.mark.parametrize("pocket_ext", [0, 1, 4])
def test_suggest_buckets_matches_jax(pocket_ext):
    complexes = synthetic_complexes(n=12, seed=3)
    for multiple in (1, 8, 16):
        assert dataset.suggest_buckets(complexes, pocket_ext, multiple) == \
            j_dataset.suggest_buckets(complexes, pocket_ext, multiple)


def _assert_complexes_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k]


def test_save_complexes_both_ways(tmp_path):
    complexes = synthetic_complexes(n=5, seed=4)
    dataset.save_complexes(complexes, str(tmp_path / "port.pkl"))
    j_dataset.save_complexes(complexes, str(tmp_path / "jax.pkl"))
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()
    _assert_complexes_equal(j_dataset.load_complexes(str(tmp_path / "port.pkl")),
                            complexes)
    _assert_complexes_equal(dataset.load_complexes(str(tmp_path / "jax.pkl")),
                            complexes)


# ------------------------------------------------------------ the readers

QUIRKS_PDB = "\n".join([
    "ATOM      1  N  AALA A   1      1.000   0.000   0.000  0.50  5.00           N",
    "ATOM      2  N  BALA A   1      9.000   9.000   9.000  0.50  5.00           N",
    "ATOM      3  CA  ALA A   1      2.000   0.000   0.000  1.00  5.00           C",
    "ATOM      4  N   GLY A   2A     3.000   0.000   0.000  1.00  5.00           N",
    "ATOM      5 1HB2 GLY A   2A     3.500   0.000   0.000  1.00  5.00",
    "HETATM    6  N   MSE A   3      4.000   0.000   0.000  1.00  5.00           N",
    "HETATM    7  O   HOH A  99      8.000   8.000   8.000  1.00  5.00           O",
    "ENDMDL",
    "ATOM      8  N   ALA A   1     77.000   0.000   0.000  1.00  5.00           N",
    "END"])


def _chains_key(chains):
    return [(cid, r.resname, r.seq_num, r.icode, r.get_id(), r.one_letter,
             [(a.name, a.element, a.altloc, a.coord.tolist(), a.coord.dtype)
              for a in r.atoms.values()])
            for cid, residues in chains.items() for r in residues]


def _fixture_files(folder):
    chains = {"A": build_chain(-57, -47, n=14, chain_id="A"),
              "B": build_chain(-139, 135, n=8, resname="GLY", chain_id="B",
                               offset=(12.0, 2.0, 0.0))}
    paths = [write_chains_pdb(chains, os.path.join(folder, "x.pdb")),
             write_chains_cif(chains, os.path.join(folder, "x.cif"))]
    for src in list(paths):
        with open(src, "rb") as f_in, gzip.open(src + ".gz", "wb") as f_out:
            f_out.write(f_in.read())
        paths.append(src + ".gz")
    quirks = os.path.join(folder, "quirks.pdb")
    with open(quirks, "w") as f:
        f.write(QUIRKS_PDB + "\n")
    return paths + [quirks]


def test_readers_match_jax_identically(tmp_path):
    for path in _fixture_files(str(tmp_path)):
        got = _chains_key(ns.parse_structure_chains(path))
        assert got == _chains_key(j_ns.parse_structure_chains(path)), path
        assert got
    line = "ATOM 1 C 'O5\\'' \"a b\" x # comment"
    assert ns._cif_tokens(line) == j_ns._cif_tokens(line)


# ------------------------------------------------------------ DSSP

def _structures(folder):
    """Two structures: a helix with a strand pair and a short chain (the
    C++ kernels' fixture), and a two-chain receptor/ligand pair."""
    out = [{"A": build_chain(-57, -47, n=40, chain_id="A"),
            "B": build_chain(-139, 135, n=12, chain_id="B",
                             offset=(12.0, 2.0, 0.0)),
            "C": build_chain(-70, -40, n=8, chain_id="C",
                             offset=(-12.0, -3.0, 1.0))},
           {"A": build_chain(-49, -26, n=20, chain_id="A"),
            "B": build_chain(-119, 113, n=9, resname="GLY", chain_id="B",
                             offset=(6.0, 4.0, 0.0))}]
    paths = [write_chains_pdb(c, os.path.join(folder, f"s{i}.pdb"))
             for i, c in enumerate(out)]
    return [ns.parse_structure_chains(p) for p in paths]


def _features_key(feats):
    return [(cid, [(list(r), r["res"].get_id(),
                    [v for k, v in r.items() if k != "res"]) for r in rows])
            for cid, rows in feats.items()]


@pytest.fixture
def jax_numpy_engine(monkeypatch):
    monkeypatch.setattr(j_native, "_LIB", None)
    monkeypatch.setattr(j_native, "_TRIED", True)


def test_dssp_features_numpy_engine_matches_jax_exactly(
        tmp_path, jax_numpy_engine, monkeypatch):
    monkeypatch.setenv("E3DIFF_NATIVE", "0")
    assert native.load_native_lib() is None
    for chains in _structures(str(tmp_path)):
        got = _features_key(dssp.native_dssp_features(chains))
        assert got == _features_key(j_dssp.native_dssp_features(chains))


def test_dssp_features_cpp_matches_jax_cpp_exactly(tmp_path):
    assert j_native.load_native_lib() is not None
    assert native.load_native_lib() is not None
    for chains in _structures(str(tmp_path)):
        got = _features_key(dssp.native_dssp_features(chains))
        assert got == _features_key(j_dssp.native_dssp_features(chains))


def test_cpp_kernels_match_the_numpy_engine(tmp_path):
    lib = native.load_native_lib()
    for chains in _structures(str(tmp_path)):
        entries = dssp._flatten(chains)
        dssp._mark_connectivity(entries)
        a, b = (dssp.hbond_scan_native(entries, lib),
                dssp.hbond_scan_numpy(entries))
        assert len(a) > 20
        assert [x[:2] for x in a] == [x[:2] for x in b]
        assert max(abs(x[2] - y[2]) for x, y in zip(a, b)) <= 1e-12
        residues, coords, radii, owner = dssp.asa_inputs(chains)
        args = (np.stack(coords), np.asarray(radii), np.asarray(owner),
                dssp._fibonacci_sphere(dssp.N_SPHERE_POINTS), len(residues))
        np.testing.assert_allclose(dssp.asa_native(*args, lib),
                                   dssp.asa_numpy(*args), rtol=0, atol=1e-12)


def test_native_build_raises_and_can_be_switched_off(tmp_path, monkeypatch):
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert path.name == native.library_path().name
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int ks_hbond_scan( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native DSSP build failed"):
        native.build_library()
    assert not list((tmp_path / "build").glob("*"))
    monkeypatch.setenv("E3DIFF_NATIVE", "0")
    assert native.load_native_lib() is None


# ------------------------------------------------------------ the TSV

def _tsv_row(pdb_id, resolution, rec="A", lig="B", site="A3 A4 A7"):
    cols = [pdb_id, rec, resolution, "bs1", "PEP", lig, "1", site, site,
            "", "", "", "", "", "", "", "", "", "", "5", "SEQ"]
    return "\t".join(cols)


TSVS = {
    "mixed": [_tsv_row("1e10", "2.0"), _tsv_row("2abc", "", rec="1"),
              _tsv_row("1e10", "1.0"), _tsv_row("3abc", "NA", lig="NA"),
              _tsv_row("4abc", "7.5", rec="True")],
    "numeric_ids": [_tsv_row("1e10", "2"), _tsv_row("1E10", "3"),
                    _tsv_row("12", "1", rec="1", lig="2"),
                    _tsv_row("0012", "4.5", rec="3", lig="4")],
    "booleans": [_tsv_row("5abc", "1", rec="true", lig="False"),
                 _tsv_row("6abc", "2", rec="TRUE", lig="")],
    "short_row": [_tsv_row("7abc", "1.5"), "8abc\tA\t2.5\tbs1"],
}


@pytest.mark.parametrize("name", sorted(TSVS))
def test_meta_tsv_rows_match_pandas(tmp_path, name):
    pd = pytest.importorskip("pandas")
    path = tmp_path / "meta.tsv"
    path.write_text("\n".join(TSVS[name]) + "\n\n")
    df = pd.read_csv(str(path), sep="\t", names=prep.BIOLIP_META_HEADER)
    df.drop_duplicates(subset="pdb_id", inplace=True)
    df.reset_index(drop=True, inplace=True)
    df = df.loc[df.resolution < 5]
    want = [df.iloc[i] for i in range(len(df))]
    got = prep.read_biolip_meta(str(path))
    assert len(got) == len(want)

    def key(v):
        nan = isinstance(v, float) and np.isnan(v)
        return (type(v).__name__, "nan" if nan else v)

    for g, w in zip(got, want):
        assert [key(v) for v in g] == [key(w[k])
                                       for k in prep.BIOLIP_META_HEADER]


def test_meta_tsv_text_resolution_raises_as_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    path = tmp_path / "meta.tsv"
    path.write_text(_tsv_row("1abc", "high") + "\n")
    df = pd.read_csv(str(path), sep="\t", names=prep.BIOLIP_META_HEADER)
    with pytest.raises(TypeError):
        df.loc[df.resolution < 5]
    with pytest.raises(TypeError):
        prep.read_biolip_meta(str(path))


# ------------------------------------------------------------ preprocessing

def _corpus(folder):
    """Five complexes (one as mmCIF, one with a numeric ligand chain id,
    one with a 4-residue ligand) and a TSV with a duplicate pdb_id, a
    missing and a >= 5 resolution, and a row without a structure file."""
    def pair(i, rec_n, lig_n, lig_id="B"):
        return {"A": build_chain(-57 + 3 * i, -47, n=rec_n, chain_id="A"),
                lig_id: build_chain(-139, 135 - 5 * i, n=lig_n,
                                    resname="GLY", chain_id=lig_id,
                                    offset=(8.0, 3.0, 0.0))}

    write_chains_pdb(pair(0, 14, 8), os.path.join(folder, "1abc.pdb"))
    write_chains_cif(pair(1, 12, 7), os.path.join(folder, "2abc.cif"))
    write_chains_pdb(pair(2, 16, 9, lig_id="7"),
                     os.path.join(folder, "3abc.pdb"))
    write_chains_pdb(pair(3, 10, 4), os.path.join(folder, "4abc.pdb"))
    write_chains_pdb(pair(4, 13, 6), os.path.join(folder, "5abc.pdb"))
    write_chains_pdb(pair(5, 11, 6), os.path.join(folder, "6abc.pdb"))
    meta = os.path.join(folder, "meta.tsv")
    with open(meta, "w") as f:
        f.write("\n".join([
            _tsv_row("1abc", "2.0"), _tsv_row("2abc", "1.5"),
            _tsv_row("1abc", "1.0", site="A2"),
            _tsv_row("3abc", "2.2", lig="7", site="A5 A6 A9 A12"),
            _tsv_row("4abc", "2.0"), _tsv_row("5abc", ""),
            _tsv_row("6abc", "5.0"), _tsv_row("9zzz", "2.0"),
            _tsv_row("5abc", "3.0", site="A99")]) + "\n")
    return meta


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
            elif k == "structure_ids":
                assert [(type(v), v) for v in g[k].values()] == \
                    [(type(v), v) for v in w[k].values()]
                assert list(g[k]) == list(w[k])
            else:
                assert g[k] == w[k], k


def test_run_preprocessing_matches_jax(tmp_path, capsys):
    pytest.importorskip("pandas")
    folder = str(tmp_path)
    meta = _corpus(folder)
    want = j_prep.run_preprocessing(meta, folder, str(tmp_path / "j.pkl"),
                                    workers=1, engine="native")
    got = prep.run_preprocessing(meta, folder, str(tmp_path / "t.pkl"),
                                 workers=1, engine="native")
    assert [r["structure_ids"]["pdb_id"] for r in got] == \
        ["1abc", "2abc", "3abc"]
    _assert_records_equal(got, want)
    _assert_records_equal(dataset.load_complexes(str(tmp_path / "t.pkl")),
                          want)
    assert "native DSSP library: " in capsys.readouterr().out


def test_preprocess_cli_with_workers_matches_one_worker(tmp_path):
    folder = str(tmp_path)
    meta = _corpus(folder)
    want = prep.run_preprocessing(meta, folder, str(tmp_path / "one.pkl"),
                                  workers=1, engine="native")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "e3diff_tpu_torch.cli.preprocess",
         "--meta_file", meta, "--structure_folder", folder, "--output",
         str(tmp_path / "two.pkl"), "--workers", "2", "--engine", "native"],
        cwd=REPO, env=env, check=True, capture_output=True, text=True,
        timeout=120).stdout
    assert "wrote 3 complexes" in out and "native DSSP library" in out
    _assert_records_equal(dataset.load_complexes(str(tmp_path / "two.pkl")),
                          want)
    check = subprocess.run(
        [sys.executable, "-m", "e3diff_tpu_torch.cli.preprocess",
         "--check-env"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=60)
    assert check.returncode == 0
    assert "pandas: not needed" in check.stdout


def test_biopython_engine_matches_jax(tmp_path, monkeypatch):
    bio_fakes.install(monkeypatch)
    assert prep.resolve_engine("biopython") == "biopython"
    folder = str(tmp_path)
    _corpus(folder)

    class Row:
        pdb_id, receptor_chain, ligand_chain = "3abc", "A", "7"
        binding_site_pdb = "A5 A6 A9 A12"

    for pdb_id in ("1abc", "2abc", "3abc", "9zzz"):
        Row.pdb_id = pdb_id
        Row.ligand_chain = "7" if pdb_id == "3abc" else "B"
        got = prep.parse_record(Row(), folder, engine="biopython")
        want = j_prep.parse_record(Row(), folder, engine="biopython")
        assert pickle.dumps(got) == pickle.dumps(want)
        if pdb_id != "9zzz":
            assert got[1]["msg"] is False
            _assert_records_equal(prep.filter_records([got]),
                                  j_prep.filter_records([want]))


def test_biopython_engine_stays_import_gated():
    assert prep.has_biopython() == j_prep.has_biopython()
    if not prep.has_biopython():
        with pytest.raises(ImportError, match="biopython"):
            prep.requires_biopython()
    assert "Bio" not in sys.modules or prep.has_biopython()


def test_geometry_helpers_match_jax_exactly():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 4, 3))
    for p1, p2, p3, p4 in pts:
        assert prep.calc_angle(p1, p2, p3) == j_prep.calc_angle(p1, p2, p3)
        assert prep.calc_dihedral(p1, p2, p3, p4) == \
            j_prep.calc_dihedral(p1, p2, p3, p4)
    residues = [dict(zip(("N", "CA", "C", "O"), r)) for r in pts]
    assert prep.extract_angle_dihedrals(residues) == \
        j_prep.extract_angle_dihedrals(residues)
    with pytest.raises(ValueError, match="zero magnitude"):
        prep.calc_angle(pts[0, 0], pts[0, 0], pts[0, 1])
