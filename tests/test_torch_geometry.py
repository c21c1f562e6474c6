"""The port's geometry (e3diff_tpu_torch/geometry) against the JAX
package, on the CPU: the float64 NERF oracle (an exact copy), the batched
float32 torch NERF (the JAX engine's jit(vmap(NERF)) counterpart) within
the 2e-4 A that tests/test_geometry.py allows JAX's own float32 NERF,
bond lengths, the Q1 column mapping with its NaN guard, and PDB text
byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.geometry import chain as j_chain
from e3diff_tpu.geometry import nerf as j_nerf
from e3diff_tpu.geometry import pdb as j_pdb

from e3diff_tpu_torch.geometry import chain, nerf, pdb


def _angles(b, n, seed):
    """Dihedrals uniform in [-pi, pi), bond angles near their backbone
    values, in the dataset's column order."""
    rng = np.random.default_rng(seed)
    dih = rng.uniform(-np.pi, np.pi, (b, n, 4))
    bond = rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (b, n, 4))
    return np.concatenate([dih, bond], axis=-1).astype(np.float32)


def _oracle(a, center=False):
    return nerf.nerf_build_backbone_np(
        phi=a[:, 0], psi=a[:, 1], omega=a[:, 2], dihedral_o=a[:, 3],
        bond_angle_ca_c=a[:, 4], bond_angle_c_n=a[:, 5],
        bond_angle_n_ca=a[:, 6], bond_angle_c_o=a[:, 7], center=center)


def test_nerf_oracle_is_jax_packages_exactly():
    a = _angles(1, 12, seed=0)[0].astype(np.float64)
    kw = dict(phi=a[:, 0], psi=a[:, 1], omega=a[:, 2], dihedral_o=a[:, 3],
              bond_angle_ca_c=a[:, 4], bond_angle_c_n=a[:, 5],
              bond_angle_n_ca=a[:, 6], bond_angle_c_o=a[:, 7])
    np.testing.assert_array_equal(nerf.nerf_build_backbone_np(**kw),
                                  j_nerf.nerf_build_backbone_np(**kw))
    # the defaults path (scalar bond angles, bond_angle_c_o given)
    kw = dict(phi=a[:, 0], psi=a[:, 1], omega=a[:, 2], dihedral_o=a[:, 3],
              bond_angle_c_o=np.full(12, 115 / 180 * np.pi))
    np.testing.assert_array_equal(nerf.nerf_build_backbone_np(**kw),
                                  j_nerf.nerf_build_backbone_np(**kw))


@pytest.mark.parametrize("length", [1, 2, 16, 64])
def test_batched_nerf_matches_jax_and_the_oracle(length):
    """(B, L, 8) -> (B, 4L, 3) uncentred, against jit(vmap(JAX NERF)) as
    the JAX engine builds it (serving/engine.py:36-60) and the float64
    oracle: 2e-4 A up to 16 residues. The f32 rounding of the recurrence
    grows with the chain, so the serving length 64 (four times 16) is held
    to four times the bound."""
    a = _angles(3, length, seed=length)
    got = nerf.nerf_build_backbone_batch(torch.from_numpy(a))
    assert got.shape == (3, 4 * length, 3) and got.dtype == torch.float32

    def one(x):
        return j_nerf.nerf_build_backbone(
            phi=x[:, 0], psi=x[:, 1], omega=x[:, 2], dihedral_o=x[:, 3],
            bond_angle_ca_c=x[:, 4], bond_angle_c_n=x[:, 5],
            bond_angle_n_ca=x[:, 6], bond_angle_c_o=x[:, 7], center=False)

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(a)))
    tol = 2e-4 if length <= 16 else 8e-4
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), _oracle(a[i]), atol=tol)


def test_batched_nerf_prefix_equals_the_trimmed_chain():
    """A padded chain's first 4n atoms are the n-residue chain's own: the
    engine reconstructs at the bucket length, then trims and centres."""
    a = _angles(2, 16, seed=5)
    full = nerf.nerf_build_backbone_batch(torch.from_numpy(a))
    short = nerf.nerf_build_backbone_batch(torch.from_numpy(a[:, :7].copy()))
    torch.testing.assert_close(full[:, :28], short, atol=0, rtol=0)


def test_bond_lengths_are_ideal():
    a = _angles(2, 16, seed=6)
    # (atom, atom): (length, first residue); residue 0's N, CA and C are
    # 1CRN's, not placed
    want = {(0, 1): (nerf.N_CA_LENGTH, 1), (1, 2): (nerf.CA_C_LENGTH, 1),
            (2, 3): (nerf.C_O_LENGTH, 0)}
    for coords, tol in ((_oracle(a[0]), 1e-6),
                        (nerf.nerf_build_backbone_batch(
                            torch.from_numpy(a))[1].double().numpy(), 1e-4)):
        res = coords.reshape(-1, 4, 3)
        for (i, j), (length, first) in want.items():
            d = np.linalg.norm(res[first:, i] - res[first:, j], axis=-1)
            np.testing.assert_allclose(d, length, atol=tol)
        peptide = np.linalg.norm(res[1:, 0] - res[:-1, 2], axis=-1)
        np.testing.assert_allclose(peptide, nerf.C_N_LENGTH, atol=tol)


def test_pdb_text_is_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(7)
    for n_res in (1, 5, 16):
        coords = (20 * rng.normal(size=(4 * n_res, 3))).astype(np.float32)
        coords[0] = [-999.9994, 0.0005, 12.3455]   # rounding edges
        text = pdb.backbone_pdb_text(coords)
        assert text == j_pdb.backbone_pdb_text(coords)
        assert text.count("\nATOM") + 1 == 4 * n_res
    path = pdb.write_backbone_pdb(coords, str(tmp_path / "x.pdb"))
    np.testing.assert_allclose(pdb.read_backbone_pdb(path), coords, atol=5e-4)
    with pytest.raises(ValueError, match="4n"):
        pdb.backbone_pdb_text(coords[:5])


def test_chain_mapping_nan_guard_and_folder_match_jax(tmp_path):
    sampled = [a for a in _angles(3, 9, seed=8)]
    sampled[1] = sampled[1].copy()
    sampled[1][4, 0] = np.nan                      # the reference's NaN guard
    for a in sampled:
        got, want = (chain.backbone_coords_from_angles(a),
                     j_chain.backbone_coords_from_angles(a))
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    ours = chain.write_pdb_folder(sampled, str(tmp_path / "ours"))
    ref = j_chain.write_pdb_folder(sampled, str(tmp_path / "ref"))
    assert [p != "" for p in ours] == [p != "" for p in ref] == [True, False, True]
    for p, q in zip(ours, ref):
        if p:
            assert open(p, "rb").read() == open(q, "rb").read()


def test_angle_error_rate_matches_jax():
    rng = np.random.default_rng(9)
    true = rng.uniform(-np.pi, np.pi, (20, 8)).astype(np.float32)
    gen = rng.uniform(-np.pi, np.pi, (20, 8)).astype(np.float32)
    np.testing.assert_allclose(chain.angle_error_rate(true, gen),
                               j_chain.angle_error_rate(true, gen), atol=1e-6)
