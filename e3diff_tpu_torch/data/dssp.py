"""Kabsch-Sander DSSP in numpy and host C++: hydrogen bonds, bridges,
ladders, 8-class secondary structure, and Shrake-Rupley accessibility (the
port's copy of e3diff_tpu/data/dssp.py).

The reference preprocessing shells out to the external ``dssp`` binary
through Biopython (clean_data/data_preprocessing.py:746-769) for each
residue's amino acid, 8-class secondary structure, relative ASA and its
two best H-bond (relidx, energy) pairs each way. This module computes
that feature set from the published algorithm (Biopolymers 22:2577, 1983):

* the amide H placed 1 A from N along the previous residue's C=O vector;
* E = 0.084*332*(1/d_ON + 1/d_CH - 1/d_OH - 1/d_CN) kcal/mol, clamped at
  -9.9, a bond where E < -0.5; PRO donates none; a chain breaks where
  |C(i)-N(i+1)| > 2.5 A;
* n-turns (3, 4, 5), helices H/G/I from two consecutive n-turns, parallel
  and antiparallel bridges, ladders merged across beta bulges, T turns,
  S bends (kappa > 70 deg), in mkdssp's (CMBI dssp 2.x-3.x)
  CalculateSecondaryStructure order: sheets before helices, H overwriting
  strands, G and I only into runs that are still free (I may claim H, the
  modern ``prefer_pi``), T before S on loop residues only.

The two hot loops, the H-bond pair scan and the accessibility integration,
run in native/dssp_core.cpp unless ``E3DIFF_NATIVE=0`` selects the numpy
engine; both produce the same bonds in the same order and ASA within
1e-12 (``hbond_scan_numpy`` / ``hbond_scan_native``, ``asa_numpy`` /
``asa_native``).

Documented deviations from the mkdssp executable: accessibility by
Shrake-Rupley sampling (256 sphere points, DSSP atom radii + a 1.4 A
probe) instead of DSSP's slice integration, relative ASA over the Sander
maxima (Biopython's default table); no poly-proline 'P' class (the
reference pipeline maps it to '-' anyway).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from e3diff_tpu_torch.native import as_f64, as_i32, as_u8, load_native_lib

Q1Q2_F = 0.084 * 332.0   # kcal*A/mol, Kabsch-Sander electrostatic factor
E_CLAMP = -9.9
HBOND_E = -0.5
CA_CUTOFF = 9.0
CHAIN_BREAK_CN = 2.5
PROBE = 1.4
N_SPHERE_POINTS = 256

# DSSP atom radii (backbone by name, side chains by element)
_BACKBONE_RADII = {"N": 1.65, "CA": 1.87, "C": 1.76, "O": 1.40}
_ELEMENT_RADII = {"C": 1.80, "N": 1.65, "O": 1.40, "S": 1.85, "P": 1.80}

# Sander & Rost maximal accessibilities (A^2) — same table Biopython's
# DSSP wrapper divides by for relative ASA.
SANDER_MAX_ACC = {
    "ALA": 106.0, "ARG": 248.0, "ASN": 157.0, "ASP": 163.0, "CYS": 135.0,
    "GLN": 198.0, "GLU": 194.0, "GLY": 84.0, "HIS": 184.0, "ILE": 169.0,
    "LEU": 164.0, "LYS": 205.0, "MET": 188.0, "PHE": 197.0, "PRO": 136.0,
    "SER": 130.0, "THR": 142.0, "TRP": 227.0, "TYR": 222.0, "VAL": 142.0,
    "MSE": 188.0,
}


@dataclasses.dataclass
class _Entry:
    chain_id: str
    res: object          # NativeResidue (or any residue duck-type)
    n: np.ndarray
    ca: np.ndarray
    c: np.ndarray
    o: np.ndarray
    h: np.ndarray | None = None            # amide H (None: chain start/PRO)
    connected_prev: bool = False


def _flatten(chains: dict) -> list[_Entry]:
    entries = []
    for chain_id, residues in chains.items():
        for res in residues:
            if all(a in res for a in ("N", "CA", "C", "O")):
                entries.append(_Entry(
                    chain_id, res,
                    *(np.asarray(res[a].get_coord(), np.float64)
                      for a in ("N", "CA", "C", "O"))))
    return entries


def _mark_connectivity(entries: list[_Entry]) -> None:
    for i in range(1, len(entries)):
        prev, cur = entries[i - 1], entries[i]
        cur.connected_prev = (
            prev.chain_id == cur.chain_id
            and float(np.linalg.norm(cur.n - prev.c)) < CHAIN_BREAK_CN)
        if cur.connected_prev and getattr(cur.res, "resname", "") != "PRO":
            co = prev.c - prev.o
            cur.h = cur.n + co / np.linalg.norm(co)


def _hbond_energy(donor: _Entry, acceptor: _Entry) -> float:
    """E for NH(donor) ... O=C(acceptor); 0.0 when no H (PRO/chain start)."""
    if donor.h is None:
        return 0.0
    d_on = np.linalg.norm(acceptor.o - donor.n)
    d_ch = np.linalg.norm(acceptor.c - donor.h)
    d_oh = np.linalg.norm(acceptor.o - donor.h)
    d_cn = np.linalg.norm(acceptor.c - donor.n)
    if min(d_on, d_ch, d_oh, d_cn) < 0.5:
        return E_CLAMP
    e = Q1Q2_F * (1.0 / d_on + 1.0 / d_ch - 1.0 / d_oh - 1.0 / d_cn)
    return max(e, E_CLAMP)


def _best_two(partners: list[tuple[int, float]]):
    """Two lowest-energy (index, E) pairs with E < 0, padded with (None, 0)."""
    neg = sorted((p for p in partners if p[1] < 0.0), key=lambda p: p[1])
    out = neg[:2]
    while len(out) < 2:
        out.append((None, 0.0))
    return out


def hbond_scan_numpy(entries: list[_Entry]) -> list[tuple[int, int, float]]:
    """(donor, acceptor, energy) of every pair with E < 0 among residues
    whose CAs lie within 9 A: for i ascending, j = i+1.. ascending, first
    NH(i) -> CO(j), then (j > i+1) NH(j) -> CO(i)."""
    n = len(entries)
    ca = np.stack([e.ca for e in entries]) if n else np.zeros((0, 3))
    bonds = []
    for i in range(n):
        if n - i - 1 <= 0:
            continue
        d = np.linalg.norm(ca[i + 1:] - ca[i], axis=1)
        for off in np.nonzero(d < CA_CUTOFF)[0]:
            j = i + 1 + int(off)
            e_ij = _hbond_energy(entries[i], entries[j])  # NH(i) -> CO(j)
            if e_ij < 0.0:
                bonds.append((i, j, e_ij))
            if j == i + 1:
                continue  # NH(i+1)/CO(i) are peptide-bonded, never an H-bond
            e_ji = _hbond_energy(entries[j], entries[i])  # NH(j) -> CO(i)
            if e_ji < 0.0:
                bonds.append((j, i, e_ji))
    return bonds


def hbond_scan_native(entries: list[_Entry], lib
                      ) -> list[tuple[int, int, float]]:
    """``hbond_scan_numpy`` in the C++ library ``lib``: the same triples
    in the same order, energies within 1e-12."""
    n = len(entries)
    if n == 0:
        return []
    zero = np.zeros(3)
    n_k, n_p = as_f64(np.stack([e.n for e in entries]))
    ca_k, ca_p = as_f64(np.stack([e.ca for e in entries]))
    c_k, c_p = as_f64(np.stack([e.c for e in entries]))
    o_k, o_p = as_f64(np.stack([e.o for e in entries]))
    h_k, h_p = as_f64(np.stack(
        [e.h if e.h is not None else zero for e in entries]))
    hh_k, hh_p = as_u8([e.h is not None for e in entries])
    cap = max(16 * n, 64)
    while True:
        don_k, don_p = as_i32(np.empty(cap, np.int32))
        acc_k, acc_p = as_i32(np.empty(cap, np.int32))
        e_k, e_p = as_f64(np.empty(cap))
        count = lib.ks_hbond_scan(n_p, ca_p, c_p, o_p, h_p, hh_p, n,
                                  don_p, acc_p, e_p, cap)
        if count >= 0:
            return [(int(don_k[i]), int(acc_k[i]), float(e_k[i]))
                    for i in range(count)]
        cap *= 4


def compute_hbonds(entries: list[_Entry]):
    """Returns (acceptors, donors): per residue i, the two best
    (j, energy) pairs where i's NH donates to j's CO (acceptors) and
    where i's CO accepts from j's NH (donors). The pair scan runs in the
    C++ library, or in numpy with ``E3DIFF_NATIVE=0``."""
    n = len(entries)
    lib = load_native_lib()
    bonds = (hbond_scan_numpy(entries) if lib is None
             else hbond_scan_native(entries, lib))
    nh_to = [[] for _ in range(n)]    # i donates to j
    co_from = [[] for _ in range(n)]  # i accepts from j
    for d, a, e in bonds:
        nh_to[d].append((a, e))
        co_from[a].append((d, e))
    return ([_best_two(p) for p in nh_to],
            [_best_two(p) for p in co_from])


def _make_testbond(acceptors):
    """O(1) membership test: True iff NH(donor) ... CO(acceptor) is a
    stored bond with E < -0.5."""
    bonds = {(d, j) for d, row in enumerate(acceptors)
             for j, e in row if j is not None and e < HBOND_E}
    return lambda donor, acceptor: (donor, acceptor) in bonds


def _no_break(entries, i, j) -> bool:
    return all(entries[k].connected_prev for k in range(i + 1, j + 1))


@dataclasses.dataclass
class _Ladder:
    """One beta ladder: consecutive same-type bridges, later possibly
    merged with a bulge-linked neighbour (mkdssp MBridge equivalent).
    `pairs` holds (i, j) bridge positions in i-ascending order; front/back
    accessors return min/max exactly like mkdssp's deques (parallel j is
    pushed back, antiparallel j is pushed front, so front==min, back==max
    in both orientations)."""

    type: str                      # 'P' | 'A'
    pairs: list

    @property
    def i_front(self):
        return self.pairs[0][0]

    @property
    def i_back(self):
        return self.pairs[-1][0]

    @property
    def j_front(self):
        return min(p[1] for p in self.pairs)

    @property
    def j_back(self):
        return max(p[1] for p in self.pairs)


def compute_bridges(entries: list[_Entry], acceptors, test=None) -> dict:
    """(i, j) -> 'P'/'A' bridge map (Kabsch-Sander table 1; mkdssp
    TestBridge incl. its i-1..i+1 / j-1..j+1 chain-continuity guards).
    Pass a prebuilt `test` (from _make_testbond) to reuse the caller's
    bond set instead of rebuilding it."""
    n = len(entries)
    if test is None:
        test = _make_testbond(acceptors)

    def hb(a, b):
        # HB(a, b): CO(a) accepts from NH(b)
        return 0 <= a < n and 0 <= b < n and test(b, a)

    # candidate (i, j) pairs from stored bonds only — every bridge pattern
    # uses a bond inside {i-1,i,i+1} x {j-1,j,j+1}, so this is exhaustive
    # while keeping the scan linear in the number of H-bonds
    cand = set()
    for d in range(n):
        for a_, e in acceptors[d]:
            if a_ is None or e >= HBOND_E:
                continue
            for i in (d - 1, d, d + 1):
                for j in (a_ - 1, a_, a_ + 1):
                    lo, hi = (i, j) if i < j else (j, i)
                    if hi - lo >= 3 and lo >= 1 and hi < n - 1:
                        cand.add((lo, hi))

    bridges = {}
    for (i, j) in sorted(cand):
        if not (_no_break(entries, i - 1, i + 1)
                and _no_break(entries, j - 1, j + 1)):
            continue
        para = ((hb(i - 1, j) and hb(j, i + 1))
                or (hb(j - 1, i) and hb(i, j + 1)))
        anti = ((hb(i, j) and hb(j, i))
                or (hb(i - 1, j + 1) and hb(j - 1, i + 1)))
        if para or anti:
            bridges[(i, j)] = "P" if para else "A"
    return bridges


def build_ladders(entries: list[_Entry], bridges: dict) -> list[_Ladder]:
    """Chain consecutive bridges into ladders, then merge bulge-linked
    ladders (mkdssp CalculateBetaSheets).

    Bulge criterion (Kabsch-Sander via mkdssp, with its uint arithmetic
    made explicit): two same-type ladders a, b (sorted by i-start, b's
    i-strand beginning 1..5 after a's ends, no chain break across either
    strand span) merge when the j-strand gap is <6 with i-gap <3, or the
    j-strand gap is <3."""
    ladders: list[_Ladder] = []
    for (i, j), t in sorted(bridges.items()):
        for lad in ladders:
            if lad.type != t or lad.pairs[-1][0] + 1 != i:
                continue
            lj = lad.pairs[-1][1]
            if (t == "P" and lj + 1 == j) or (t == "A" and lj - 1 == j):
                lad.pairs.append((i, j))
                break
        else:
            ladders.append(_Ladder(t, [(i, j)]))

    ladders.sort(key=lambda lad: lad.i_front)
    a_idx = 0
    while a_idx < len(ladders):
        b_idx = a_idx + 1
        while b_idx < len(ladders):
            a, b = ladders[a_idx], ladders[b_idx]
            gap_i = b.i_front - a.i_back
            if (a.type != b.type or not (0 < gap_i < 6)
                    or not _no_break(entries, min(a.i_front, b.i_front),
                                     max(a.i_back, b.i_back))
                    or not _no_break(entries, min(a.j_front, b.j_front),
                                     max(a.j_back, b.j_back))):
                b_idx += 1
                continue
            if a.type == "P":
                gap_j = b.j_front - a.j_back
            else:  # antiparallel: j descends with i, so b lies below a
                gap_j = a.j_front - b.j_back
            bulge = ((0 <= gap_j < 6 and 0 < gap_i < 3)
                     or 0 <= gap_j < 3)
            if bulge:
                a.pairs.extend(b.pairs)
                del ladders[b_idx]
            else:
                b_idx += 1
        a_idx += 1
    return ladders


def assign_secondary_structure(entries: list[_Entry], acceptors,
                               prefer_pi: bool = True) -> list[str]:
    """8-class DSSP string following mkdssp's (CMBI dssp/xssp 2.x-3.x)
    CalculateSecondaryStructure control flow: beta sheets assigned first
    (E for multi-bridge/merged ladders spanning bulge gaps, B for lone
    bridges, E never overwritten by B), then H written unconditionally
    (overwriting sheet labels), G only into runs that are entirely
    unassigned-or-G, I only into runs of unassigned/I (plus H when
    `prefer_pi`, the modern-mkdssp default), finally T then S on
    still-unassigned residues only."""
    n = len(entries)
    test = _make_testbond(acceptors)

    # n-turns: CO(i) ... NH(i+stride)
    turns = {s: [False] * n for s in (3, 4, 5)}
    for s in (3, 4, 5):
        for i in range(n - s):
            if _no_break(entries, i, i + s) and test(i + s, i):
                turns[s][i] = True

    ss = ["-"] * n

    # --- beta sheets first (mkdssp runs CalculateBetaSheets before
    # CalculateAlphaHelices) ---
    bridges = compute_bridges(entries, acceptors, test=test)
    for lad in build_ladders(entries, bridges):
        label = "E" if len(lad.pairs) > 1 else "B"
        # the full inclusive strand spans — a merged ladder's bulge gap
        # residues are inside the span and get E too
        for k in range(lad.i_front, lad.i_back + 1):
            if ss[k] != "E":
                ss[k] = label
        for k in range(lad.j_front, lad.j_back + 1):
            if ss[k] != "E":
                ss[k] = label

    # --- helices ---
    for i in range(1, n - 4):       # H: unconditional (overwrites E/B)
        if turns[4][i - 1] and turns[4][i]:
            for k in range(i, i + 4):
                ss[k] = "H"
    for i in range(1, n - 3):       # G: run must be all loop-or-G
        if turns[3][i - 1] and turns[3][i]:
            if all(ss[k] in ("-", "G") for k in range(i, i + 3)):
                for k in range(i, i + 3):
                    ss[k] = "G"
    pi_ok = ("-", "I", "H") if prefer_pi else ("-", "I")
    for i in range(1, n - 5):       # I: run all loop-or-I (+H modern)
        if turns[5][i - 1] and turns[5][i]:
            if all(ss[k] in pi_ok for k in range(i, i + 5)):
                for k in range(i, i + 5):
                    ss[k] = "I"

    def put(k, c):
        if 0 <= k < n and ss[k] == "-":
            ss[k] = c

    for s in (3, 4, 5):             # T: interior of any n-turn
        for i in range(n - s):
            if turns[s][i]:
                for k in range(i + 1, i + s):
                    put(k, "T")
    if n >= 5:                      # S: bend, kappa > 70 deg (vectorized)
        ca = np.stack([e.ca for e in entries])
        connected = np.array([e.connected_prev for e in entries])
        u = ca[2:n - 2] - ca[:n - 4]
        v = ca[4:] - ca[2:n - 2]
        cosk = (u * v).sum(1) / (np.linalg.norm(u, axis=1)
                                 * np.linalg.norm(v, axis=1))
        bend = np.degrees(np.arccos(np.clip(cosk, -1, 1))) > 70.0
        # no chain break across i-2..i+2 (== all connected_prev in i-1..i+2)
        ok = np.all(np.stack([connected[off:off + n - 4]
                              for off in range(1, 5)]), axis=0)
        for i in np.nonzero(bend & ok)[0] + 2:
            put(int(i), "S")
    return ss


# ---------------------------------------------------------------------------
# Solvent accessibility (Shrake-Rupley)
# ---------------------------------------------------------------------------

def _fibonacci_sphere(k: int) -> np.ndarray:
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / k)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], axis=1)


def _atom_radius(name: str, element: str) -> float:
    if name in _BACKBONE_RADII:
        return _BACKBONE_RADII[name]
    return _ELEMENT_RADII.get(element.upper()[:1], 1.80)


def asa_numpy(coords, radii, owner, sphere, n_res) -> np.ndarray:
    """Per-residue accessible area (A^2): for each atom in input order, the
    share of its sphere points (radius incl. the probe) that no touching
    atom's sphere covers, times its sphere's area, added to its owner."""
    asa_per_res = np.zeros(n_res)
    for a in range(len(coords)):
        d = np.linalg.norm(coords - coords[a], axis=1)
        touch = (d < radii + radii[a]) & (d > 0)
        neigh_c = coords[touch]
        neigh_r = radii[touch]
        pts = coords[a] + radii[a] * sphere
        if len(neigh_c):
            d2 = ((pts[:, None, :] - neigh_c[None, :, :]) ** 2).sum(-1)
            buried = (d2 < (neigh_r ** 2)[None, :]).any(1)
            frac = 1.0 - buried.mean()
        else:
            frac = 1.0
        asa_per_res[owner[a]] += frac * 4.0 * np.pi * radii[a] ** 2
    return asa_per_res


def asa_native(coords, radii, owner, sphere, n_res, lib) -> np.ndarray:
    """``asa_numpy`` in the C++ library ``lib`` (a cell list finds the
    same neighbours; the same point set in the same atom order)."""
    c_k, c_p = as_f64(coords)
    r_k, r_p = as_f64(radii)
    ow_k, ow_p = as_i32(owner)
    s_k, s_p = as_f64(sphere)
    out_k, out_p = as_f64(np.zeros(n_res))
    lib.shrake_rupley(c_p, r_p, ow_p, len(coords), s_p, len(sphere),
                      out_p, n_res)
    return out_k


def asa_inputs(chains: dict):
    """(residues, coords, radii with the probe, owner residue index) over
    every heavy atom of the structure, in chain and atom order."""
    coords, radii, owner = [], [], []
    residues = []
    for residues_in_chain in chains.values():
        for res in residues_in_chain:
            ridx = len(residues)
            residues.append(res)
            for atom in res.atoms.values():
                if atom.element.upper().startswith("H"):
                    continue
                coords.append(np.asarray(atom.get_coord(), np.float64))
                radii.append(_atom_radius(atom.name, atom.element) + PROBE)
                owner.append(ridx)
    return residues, coords, radii, owner


def shrake_rupley_asa(chains: dict, n_points: int = N_SPHERE_POINTS) -> dict:
    """Per-residue solvent-accessible surface area (A^2) over ALL atoms in
    the structure (hydrogens excluded, as in DSSP). Returns
    {id(residue): asa}."""
    residues, coords, radii, owner = asa_inputs(chains)
    if not coords:
        return {}
    args = (np.stack(coords), np.asarray(radii), np.asarray(owner),
            _fibonacci_sphere(n_points), len(residues))
    lib = load_native_lib()
    asa = asa_numpy(*args) if lib is None else asa_native(*args, lib)
    return {id(res): asa[i] for i, res in enumerate(residues)}


# ---------------------------------------------------------------------------
# Feature assembly in the extract_dssp_features schema
# ---------------------------------------------------------------------------

def native_dssp_features(chains: dict) -> dict:
    """Per-chain feature dicts matching preprocessing.extract_dssp_features
    (same keys, same order); 'res' holds the duck-typed residue."""
    entries = _flatten(chains)
    _mark_connectivity(entries)
    acceptors, donors = compute_hbonds(entries)
    ss = assign_secondary_structure(entries, acceptors)
    asa = shrake_rupley_asa(chains)

    def relidx(i, pair):
        j, e = pair
        return (0, 0.0) if j is None else (j - i, round(float(e), 1))

    features: dict = {}
    for i, entry in enumerate(entries):
        res = entry.res
        (a1_r, a1_e), (a2_r, a2_e) = (relidx(i, p) for p in acceptors[i])
        (d1_r, d1_e), (d2_r, d2_e) = (relidx(i, p) for p in donors[i])
        max_acc = SANDER_MAX_ACC.get(getattr(res, "resname", ""), 200.0)
        features.setdefault(entry.chain_id, []).append({
            "res": res,
            "alpha_carbon_coord": [float(x) for x in entry.ca],
            "amino_acid": getattr(res, "one_letter", "X"),
            "secondary_structure": ss[i],
            "relative_ASA": min(asa.get(id(res), 0.0) / max_acc, 1.0),
            "NH_O_1_relidx": a1_r, "NH_O_1_energy": a1_e,
            "O_NH_1_relidx": d1_r, "O_NH_1_energy": d1_e,
            "NH_O_2_relidx": a2_r, "NH_O_2_energy": a2_e,
            "O_NH_2_relidx": d2_r, "O_NH_2_energy": d2_e,
        })
    return features
