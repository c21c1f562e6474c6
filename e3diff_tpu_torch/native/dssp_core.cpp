// Native DSSP compute core: Kabsch-Sander H-bond energies and
// Shrake-Rupley solvent accessibility.
//
// The reference preprocessing shells out to the external `dssp` binary
// (clean_data/data_preprocessing.py:746-769), i.e. its hot per-structure
// geometry runs in native code. This library is the rebuild's equivalent:
// the O(n^2) residue-pair scan and the O(atoms^2 * sphere) accessibility
// integration — the two costs that dominate data/dssp.py's pure-numpy
// engine (~0.1 s and ~0.6 s per 300-residue structure) — in C++, keeping
// selection/assignment logic in Python for exact engine parity.
//
// Both entry points reproduce the numpy engine's enumeration ORDER (pair
// scan i ascending then j=i+1.., ASA accumulation in atom input order) so
// outputs match element-for-element; values agree to ~1e-14 (numpy's
// norm routes 3-vector dots through BLAS, which rounds differently).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const double Q1Q2_F = 0.084 * 332.0;  // kcal*A/mol (data/dssp.py Q1Q2_F)
const double E_CLAMP = -9.9;
const double CA_CUTOFF = 9.0;

inline double dist(const double* a, const double* b) {
  const double dx = a[0] - b[0];
  const double dy = a[1] - b[1];
  const double dz = a[2] - b[2];
  return std::sqrt(dx * dx + dy * dy + dz * dz);
}

// Kabsch-Sander electrostatic energy for NH(donor) ... O=C(acceptor);
// mirrors dssp.py::_hbond_energy (0.0 when the donor has no amide H).
inline double hbond_energy(const double* n, const double* h, bool has_h,
                           const double* c_acc, const double* o_acc) {
  if (!has_h) return 0.0;
  const double d_on = dist(o_acc, n);
  const double d_ch = dist(c_acc, h);
  const double d_oh = dist(o_acc, h);
  const double d_cn = dist(c_acc, n);
  double m = d_on;
  if (d_ch < m) m = d_ch;
  if (d_oh < m) m = d_oh;
  if (d_cn < m) m = d_cn;
  if (m < 0.5) return E_CLAMP;
  const double e = Q1Q2_F * (1.0 / d_on + 1.0 / d_ch - 1.0 / d_oh - 1.0 / d_cn);
  return e < E_CLAMP ? E_CLAMP : e;
}

}  // namespace

extern "C" {

// Enumerate candidate H-bonds over residue pairs with CA distance <
// 9 A (dssp.py::compute_hbonds). Inputs are [n,3] row-major backbone
// coords; `h` rows are valid only where has_h[i] != 0.
//
// Emits (donor, acceptor, energy) triples with energy < 0 into the
// out_* arrays (capacity `cap`), in EXACTLY the numpy engine's append
// order: for i ascending, j = i+1.. ascending — first NH(i)->CO(j),
// then (if j > i+1) NH(j)->CO(i). Returns the number of bonds written,
// or -1 if cap was too small (caller retries with a larger buffer).
int ks_hbond_scan(const double* n_xyz, const double* ca_xyz,
                  const double* c_xyz, const double* o_xyz,
                  const double* h_xyz, const uint8_t* has_h, int n,
                  int32_t* out_donor, int32_t* out_acceptor,
                  double* out_energy, int cap) {
  int count = 0;
  for (int i = 0; i < n; ++i) {
    const double* ca_i = ca_xyz + 3 * i;
    for (int j = i + 1; j < n; ++j) {
      if (dist(ca_i, ca_xyz + 3 * j) >= CA_CUTOFF) continue;
      const double e_ij = hbond_energy(n_xyz + 3 * i, h_xyz + 3 * i,
                                       has_h[i] != 0, c_xyz + 3 * j,
                                       o_xyz + 3 * j);
      if (e_ij < 0.0) {
        if (count >= cap) return -1;
        out_donor[count] = i;
        out_acceptor[count] = j;
        out_energy[count] = e_ij;
        ++count;
      }
      if (j == i + 1) continue;  // peptide-bonded neighbours never H-bond
      const double e_ji = hbond_energy(n_xyz + 3 * j, h_xyz + 3 * j,
                                       has_h[j] != 0, c_xyz + 3 * i,
                                       o_xyz + 3 * i);
      if (e_ji < 0.0) {
        if (count >= cap) return -1;
        out_donor[count] = j;
        out_acceptor[count] = i;
        out_energy[count] = e_ji;
        ++count;
      }
    }
  }
  return count;
}

// Shrake-Rupley accessible surface area (dssp.py::shrake_rupley_asa).
// coords [m,3]; radii [m] already include the probe; owner [m] maps each
// atom to its residue index (< n_res); sphere [k,3] unit test points
// (passed in so both engines integrate the identical point set).
// out_asa [n_res] accumulates atom contributions in input order.
void shrake_rupley(const double* coords, const double* radii,
                   const int32_t* owner, int m, const double* sphere, int k,
                   double* out_asa, int n_res) {
  for (int r = 0; r < n_res; ++r) out_asa[r] = 0.0;
  if (m == 0) return;

  // Uniform-grid cell list for the neighbour search: cell edge 2*rmax
  // bounds the touch distance r_a + r_b, so candidates live in the 27
  // surrounding cells. The touch TEST is unchanged — identical neighbour
  // sets (sorted ascending, same as the brute-force scan order), so the
  // output is bit-identical; only the search is O(m) instead of O(m^2).
  double rmax = 0.0, lo[3], hi[3];
  for (int c = 0; c < 3; ++c) lo[c] = hi[c] = coords[c];
  for (int a = 0; a < m; ++a) {
    if (radii[a] > rmax) rmax = radii[a];
    for (int c = 0; c < 3; ++c) {
      const double v = coords[3 * a + c];
      if (v < lo[c]) lo[c] = v;
      if (v > hi[c]) hi[c] = v;
    }
  }
  const double cell = 2.0 * rmax > 1e-9 ? 2.0 * rmax : 1.0;
  long nx = static_cast<long>((hi[0] - lo[0]) / cell) + 1;
  long ny = static_cast<long>((hi[1] - lo[1]) / cell) + 1;
  long nz = static_cast<long>((hi[2] - lo[2]) / cell) + 1;
  const long ncells = nx * ny * nz;
  const bool use_grid = ncells > 0 && ncells <= 8L * m + 1024;

  std::vector<int> head, next_in_cell, cell_of;
  if (use_grid) {
    head.assign(ncells, -1);
    next_in_cell.assign(m, -1);
    cell_of.assign(m, 0);
    for (int a = 0; a < m; ++a) {
      const long cx = static_cast<long>((coords[3 * a] - lo[0]) / cell);
      const long cy = static_cast<long>((coords[3 * a + 1] - lo[1]) / cell);
      const long cz = static_cast<long>((coords[3 * a + 2] - lo[2]) / cell);
      const long ci = (cx * ny + cy) * nz + cz;
      cell_of[a] = static_cast<int>(ci);
      next_in_cell[a] = head[ci];
      head[ci] = a;
    }
  }

  std::vector<int> neigh(m);
  const double four_pi = 4.0 * M_PI;
  for (int a = 0; a < m; ++a) {
    const double* ca = coords + 3 * a;
    const double ra = radii[a];
    int n_neigh = 0;
    if (use_grid) {
      const long cx = cell_of[a] / (ny * nz);
      const long cy = (cell_of[a] / nz) % ny;
      const long cz = cell_of[a] % nz;
      for (long dx = -1; dx <= 1; ++dx) {
        if (cx + dx < 0 || cx + dx >= nx) continue;
        for (long dy = -1; dy <= 1; ++dy) {
          if (cy + dy < 0 || cy + dy >= ny) continue;
          for (long dz = -1; dz <= 1; ++dz) {
            if (cz + dz < 0 || cz + dz >= nz) continue;
            long ci = ((cx + dx) * ny + (cy + dy)) * nz + (cz + dz);
            for (int b = head[ci]; b >= 0; b = next_in_cell[b]) {
              const double d = dist(coords + 3 * b, ca);
              if (d < radii[b] + ra && d > 0.0) neigh[n_neigh++] = b;
            }
          }
        }
      }
      std::sort(neigh.begin(), neigh.begin() + n_neigh);
    } else {
      for (int b = 0; b < m; ++b) {
        const double d = dist(coords + 3 * b, ca);
        if (d < radii[b] + ra && d > 0.0) neigh[n_neigh++] = b;
      }
    }
    int buried = 0;
    for (int p = 0; p < k; ++p) {
      const double px = ca[0] + ra * sphere[3 * p];
      const double py = ca[1] + ra * sphere[3 * p + 1];
      const double pz = ca[2] + ra * sphere[3 * p + 2];
      for (int t = 0; t < n_neigh; ++t) {
        const double* cb = coords + 3 * neigh[t];
        const double dx = px - cb[0];
        const double dy = py - cb[1];
        const double dz = pz - cb[2];
        if (dx * dx + dy * dy + dz * dz < radii[neigh[t]] * radii[neigh[t]]) {
          ++buried;
          break;
        }
      }
    }
    const double frac = 1.0 - static_cast<double>(buried) / k;
    out_asa[owner[a]] += frac * four_pi * ra * ra;
  }
}

}  // extern "C"
