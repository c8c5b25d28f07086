// Native host-side setup kernels for gravo_mg_tpu.
//
// Role: the reference implements its whole setup path in C++
// (gravomg/src/multigrid_solver.cpp); in the TPU build the device owns the
// numerics, and C++ owns the irregular host-side *plan construction* that
// feeds it — the parts numpy handles poorly at the 1M-vertex scale:
//
//   * unique_i64: sorted unique of an int64 array (coarse-graph edge
//     dedup, hierarchy/builder.py _coarse_graph).
//   * shuffle_layout / sort_pairs_i64: shuffle-ELL slot assignment.
//   * disk_sample / dijkstra_cluster / fps_graph / prolongation weights:
//     the hierarchy-construction sweeps.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Build: cc -O3 -fopenmp -shared -fPIC gravomg_native.cpp -o libgravomg_native.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// LSD radix sort of (key, original-index) pairs by key, 16-bit digits.
// Memory-bound O(n * passes) with passes = ceil(bits(key_max)/16) — the
// right shape for the 2-core host this runs on (comparison sorts lose).
void parallel_sort_pairs(const int64_t* keys, int64_t n, int64_t key_max,
                         std::vector<int64_t>& sorted_keys,
                         std::vector<int64_t>& order) {
  sorted_keys.assign(keys, keys + n);
  order.resize(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  if (n < 2) return;

  int bits = 1;
  while ((key_max >> bits) > 0) ++bits;
  const int kDigitBits = 16;
  const int64_t kRadix = 1 << kDigitBits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;

  std::vector<int64_t> tmp_keys(n), tmp_order(n);
  std::vector<int64_t> hist(kRadix + 1);
  int64_t* src_k = sorted_keys.data();
  int64_t* src_o = order.data();
  int64_t* dst_k = tmp_keys.data();
  int64_t* dst_o = tmp_order.data();

  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    std::fill(hist.begin(), hist.end(), 0);
    for (int64_t i = 0; i < n; ++i)
      ++hist[((uint64_t)src_k[i] >> shift) & (kRadix - 1)];
    int64_t acc = 0;
    for (int64_t d = 0; d < kRadix; ++d) {
      int64_t c = hist[d];
      hist[d] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t pos = hist[((uint64_t)src_k[i] >> shift) & (kRadix - 1)]++;
      dst_k[pos] = src_k[i];
      dst_o[pos] = src_o[i];
    }
    std::swap(src_k, dst_k);
    std::swap(src_o, dst_o);
  }
  if (src_k != sorted_keys.data()) {
    std::memcpy(sorted_keys.data(), src_k, n * sizeof(int64_t));
    std::memcpy(order.data(), src_o, n * sizeof(int64_t));
  }
}

// Binary min-heap entry (distance, node) with lazy deletion — shared by the
// multi-source clustering and FPS kernels.
struct HeapEntry {
  float d;
  int32_t v;
};
struct HeapCmp {
  bool operator()(const HeapEntry& a, const HeapEntry& b) const {
    return a.d > b.d;
  }
};

}  // namespace

extern "C" {

// Radix argsort of int64 keys: fills sorted[n] and order[n] such that
// sorted[i] = keys[order[i]], ascending.  key_max bounds the bit width.
void sort_pairs_i64(const int64_t* keys, int64_t n, int64_t key_max,
                    int64_t* sorted, int64_t* order) {
  std::vector<int64_t> sk, od;
  parallel_sort_pairs(keys, n, key_max, sk, od);
  std::memcpy(sorted, sk.data(), n * sizeof(int64_t));
  std::memcpy(order, od.data(), n * sizeof(int64_t));
}

// Sorted unique of keys[n] into uniq (caller-allocated, size >= n).
// Returns the number of unique values.
int64_t unique_i64(const int64_t* keys, int64_t n, int64_t* uniq) {
  if (n == 0) return 0;
  std::vector<int64_t> tmp(keys, keys + n);
  int64_t mx = *std::max_element(tmp.begin(), tmp.end());
  std::vector<int64_t> sorted, order;
  parallel_sort_pairs(tmp.data(), n, mx, sorted, order);
  int64_t m = 0;
  int64_t prev = sorted[0] - 1;
  for (int64_t i = 0; i < n; ++i) {
    if (sorted[i] != prev) {
      uniq[m++] = sorted[i];
      prev = sorted[i];
    }
  }
  return m;
}

// Full shuffle-ELL slot assignment (the C++ half of sparse._shuffle_layout;
// see ShuffleEll in sparse.py for the layout contract).  The numpy
// formulation spends ~6 s in O(nnz) glue passes at 7.3M nnz; here the
// post-sort scan is a single pass.
//   rows/cols: nnz COO coordinates (row-sorted not required)
//   S: number of 128-row output groups (pre-padded by the caller)
//   kc: slot-count pad multiple; kp_cap: capacity of q (kp_cap * S int32,
//   zero-initialized by the caller)
//   flat_pos[p]: destination of input nnz p in the flattened (KP, S, 128)
//   slot arrays.
// Returns KP (padded to a multiple of kc), or -1 if kp_cap is too small.
int64_t shuffle_layout(const int64_t* rows, const int64_t* cols, int64_t nnz,
                       int64_t S, int64_t kc, int64_t kp_cap,
                       int32_t* q, int64_t* flat_pos) {
  if (nnz == 0) return kc;
  int64_t max_col = 0;
  for (int64_t p = 0; p < nnz; ++p) max_col = std::max(max_col, cols[p]);
  const int64_t nblk = (max_col >> 7) + 1;

  // composite key (group, block, lane); sort once, then one linear scan.
  std::vector<int64_t> comp(nnz);
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < nnz; ++p) {
    const int64_t g = rows[p] >> 7, lane = rows[p] & 127, b = cols[p] >> 7;
    comp[p] = (g * nblk + b) * 128 + lane;
  }
  std::vector<int64_t> sorted, order;
  const int64_t key_max = *std::max_element(comp.begin(), comp.end());
  parallel_sort_pairs(comp.data(), nnz, key_max, sorted, order);

  int64_t kp = 0, base = 0, m = 0, t = 0;
  int64_t prev_key = -1, prev_gb = -1, prev_g = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t key = sorted[i];
    const int64_t gb = key >> 7, lane = key & 127;
    const int64_t g = gb / nblk, b = gb - g * nblk;
    if (gb != prev_gb) {
      base = (g == prev_g) ? base + m : 0;
      m = 0;
      t = 0;
      prev_gb = gb;
      prev_g = g;
      prev_key = -1;
    }
    t = (key == prev_key) ? t + 1 : 0;
    prev_key = key;
    if (t + 1 > m) {
      m = t + 1;
      if (base + t >= kp_cap) return -1;
      q[(base + t) * S + g] = (int32_t)b;
    }
    const int64_t slot = base + t;
    kp = std::max(kp, slot + 1);
    flat_pos[order[i]] = (slot * S + g) * 128 + lane;
  }
  if (kp % kc) kp += kc - kp % kc;
  return std::max<int64_t>(kp, kc);
}

// Diagonal-run slot assignment (the C++ half of sparse._diag_layout; see
// sparse.DiagEll for the layout contract).  Slots are allocated per
// (tile of tg row-groups, block-diagonal d = col_block - row_group); the
// start table stores the padded xb offset g0 + d + tg.  Mirrors
// shuffle_layout's sort + single-scan structure — the numpy formulation
// costs ~5 s at 7.3M nnz, this runs in the sort time (~0.6 s).
//   S_pad: padded group count (multiple of tg); kp_cap: slot capacity of
//   start (n_tiles * kp_cap int32, prefilled with tg by the caller).
// Returns KP (padded to a multiple of kc), or -1 if kp_cap is too small.
int64_t diag_layout(const int64_t* rows, const int64_t* cols, int64_t nnz,
                    int64_t S_pad, int64_t tg, int64_t kc, int64_t kp_cap,
                    int32_t* start, int64_t* flat_pos) {
  if (nnz == 0) return kc;
  int64_t max_blk = 0;
  for (int64_t p = 0; p < nnz; ++p) max_blk = std::max(max_blk, cols[p] >> 7);
  const int64_t doff = S_pad;            // dshift = d + S_pad >= 1
  const int64_t nd = max_blk + doff + 1;
  std::vector<int64_t> comp(nnz);
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < nnz; ++p) {
    const int64_t g = rows[p] >> 7, lane = rows[p] & 127, b = cols[p] >> 7;
    const int64_t tile = g / tg, s_in = g - tile * tg;
    comp[p] = ((tile * nd + (b - g + doff)) * tg + s_in) * 128 + lane;
  }
  std::vector<int64_t> sorted, order;
  const int64_t key_max = *std::max_element(comp.begin(), comp.end());
  parallel_sort_pairs(comp.data(), nnz, key_max, sorted, order);

  int64_t kp = 0, base = 0, m = 0, t = 0;
  int64_t prev_key = -1, prev_td = -1, prev_tile = -1;
  const int64_t tg128 = tg * 128;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t key = sorted[i];
    const int64_t lane = key & 127;
    const int64_t td = key / tg128;
    const int64_t s_in = (key >> 7) - td * tg;
    const int64_t tile = td / nd, dsh = td - tile * nd;
    if (td != prev_td) {
      base = (tile == prev_tile) ? base + m : 0;
      m = 0;
      t = 0;
      prev_td = td;
      prev_tile = tile;
      prev_key = -1;
    }
    t = (key == prev_key) ? t + 1 : 0;
    prev_key = key;
    if (t + 1 > m) {
      m = t + 1;
      if (base + t >= kp_cap) return -1;
      start[tile * kp_cap + base + t] =
          (int32_t)(tile * tg + (dsh - doff) + tg);
    }
    const int64_t slot = base + t;
    kp = std::max(kp, slot + 1);
    flat_pos[order[i]] = (slot * S_pad + tile * tg + s_in) * 128 + lane;
  }
  if (kp % kc) kp += kc - kp % kc;
  return std::max<int64_t>(kp, kc);
}

// Greedy disk sampling: the reference's fastDiskSample / MIS contract
// (visit vertices in index order; an uncovered vertex becomes a sample and
// covers its <=2-hop radius ball; see multigrid_solver.cpp:930-1013 for the
// behavioral spec).  Serial one-pass — the fastest formulation on a 2-core
// host and bit-reproducible.  status: 0 undecided (in) -> 1 sample /
// 2 dominated (out).  dist is (n, k) edge lengths, inf at padding.
void disk_sample(const int32_t* neigh, const float* dist, int64_t n,
                 int64_t k, float radius, int two_ring, int8_t* status) {
  for (int64_t i = 0; i < n; ++i) {
    if (status[i] != 0) continue;
    status[i] = 1;
    const int32_t* nb = neigh + i * k;
    const float* db = dist + i * k;
    for (int64_t a = 0; a < k; ++a) {
      const int32_t j = nb[a];
      const float d1 = db[a];
      if (j < 0 || !(d1 < radius)) continue;
      if (status[j] == 0) status[j] = 2;
      if (!two_ring) continue;
      const int32_t* nb2 = neigh + (int64_t)j * k;
      const float* db2 = dist + (int64_t)j * k;
      for (int64_t b = 0; b < k; ++b) {
        const int32_t l = nb2[b];
        if (l < 0 || l == i) continue;
        if (d1 + db2[b] < radius && status[l] == 0) status[l] = 2;
      }
    }
  }
}

// disk_sample with an explicit visit order.  The reference sweeps vertices
// in index order (fastDiskSample, multigrid_solver.cpp:979); on meshes
// whose vertex numbering is raster-ordered (structured grids) that packs
// samples at the tightest legal spacing and under-coarsens.  A random
// permutation restores the expected ~1/ratio coarsening while keeping the
// one-pass greedy contract (maximal set, pairwise >= radius apart).
void disk_sample_ord(const int32_t* neigh, const float* dist, int64_t n,
                     int64_t k, float radius, int two_ring,
                     const int32_t* order, int8_t* status) {
  for (int64_t t = 0; t < n; ++t) {
    const int64_t i = order ? (int64_t)order[t] : t;
    if (status[i] != 0) continue;
    status[i] = 1;
    const int32_t* nb = neigh + i * k;
    const float* db = dist + i * k;
    for (int64_t a = 0; a < k; ++a) {
      const int32_t j = nb[a];
      const float d1 = db[a];
      if (j < 0 || !(d1 < radius)) continue;
      if (status[j] == 0) status[j] = 2;
      if (!two_ring) continue;
      const int32_t* nb2 = neigh + (int64_t)j * k;
      const float* db2 = dist + (int64_t)j * k;
      for (int64_t b = 0; b < k; ++b) {
        const int32_t l = nb2[b];
        if (l < 0 || l == i) continue;
        if (d1 + db2[b] < radius && status[l] == 0) status[l] = 2;
      }
    }
  }
}

// Exact multi-source Dijkstra over the padded neighbor graph: labels every
// vertex with the nearest sample (the reference's
// constructDijkstraWithCluster contract, multigrid_solver.cpp:1015-1056).
// D/label are outputs; unreachable vertices keep D=inf, label=-1.
void dijkstra_cluster(const int32_t* neigh, const float* dist, int64_t n,
                      int64_t k, const int32_t* samples, int64_t ns,
                      int32_t* label, float* D) {
  const float inf = std::numeric_limits<float>::infinity();
  for (int64_t i = 0; i < n; ++i) {
    D[i] = inf;
    label[i] = -1;
  }
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
  for (int64_t s = 0; s < ns; ++s) {
    const int32_t v = samples[s];
    D[v] = 0.0f;
    label[v] = (int32_t)s;
    heap.push({0.0f, v});
  }
  while (!heap.empty()) {
    const HeapEntry e = heap.top();
    heap.pop();
    if (e.d > D[e.v]) continue;  // stale
    const int32_t* nb = neigh + (int64_t)e.v * k;
    const float* db = dist + (int64_t)e.v * k;
    for (int64_t a = 0; a < k; ++a) {
      const int32_t j = nb[a];
      if (j < 0) continue;
      const float nd = e.d + db[a];
      if (nd < D[j]) {
        D[j] = nd;
        label[j] = label[e.v];
        heap.push({nd, j});
      }
    }
  }
}

// Graph farthest-point sampling (reference constructFarthestPointSample,
// gravomg/src/sampling.cpp:6-66) with incremental Dijkstra: adding a sample
// relaxes only vertices whose distance improves, so total work is
// O(E log E) amortized over all rounds instead of target * O(E log E).
// Returns the number of samples written (== target, or fewer if the graph
// is smaller/disconnected beyond reach).
int64_t fps_graph(const int32_t* neigh, const float* dist, int64_t n,
                  int64_t k, int64_t target, int32_t start,
                  int32_t* samples) {
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> D(n, inf);
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
  int64_t written = 0;
  int32_t next = start;
  for (int64_t round = 0; round < target; ++round) {
    samples[written++] = next;
    D[next] = 0.0f;
    heap.push({0.0f, next});
    while (!heap.empty()) {
      const HeapEntry e = heap.top();
      heap.pop();
      if (e.d > D[e.v]) continue;
      const int32_t* nb = neigh + (int64_t)e.v * k;
      const float* db = dist + (int64_t)e.v * k;
      for (int64_t a = 0; a < k; ++a) {
        const int32_t j = nb[a];
        if (j < 0) continue;
        const float nd = e.d + db[a];
        if (nd < D[j]) {
          D[j] = nd;
          heap.push({nd, j});
        }
      }
    }
    // farthest reachable vertex becomes the next sample
    float best = -1.0f;
    next = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (D[i] != inf && D[i] > best) {
        best = D[i];
        next = (int32_t)i;
      }
    }
    if (next < 0 || best <= 0.0f) break;
  }
  return written;
}

int native_version() { return 2; }

// Prolongation weights: the reference's per-fine-vertex triangle-selection
// sweep (constructProlongation weight phase, multigrid_solver.cpp:287-457)
// with the argmin-distance containing-triangle deviation documented in
// hierarchy/prolongation.py.  OpenMP over Voronoi cells; per cell the pair
// (candidate-triangle) geometry is hoisted out of the member loop — each
// barycentric coordinate is an affine function of the fine point, so the
// per-member per-pair cost is three dot products.
//
// weighting: 0 barycentric / 1 uniform / 2 inverse-distance
// (multigrid_solver.h:48-52).  Outputs: cols/w (n,3) row-major, rows sum
// to 1; stats[3] = {triangle, edge, closest-3} counts over live vertices.
void prolongation_weights_native(
    const double* fine_pos, int64_t n, const int32_t* labels,
    const double* coarse_pos, int64_t nc, const int32_t* coarse_neigh,
    int64_t kc, int check_voronoi, int nested, const int32_t* samples,
    const int32_t* member_start, const int32_t* member_idx,
    int weighting, int32_t* out_cols, float* out_w, int64_t* stats) {
  const double EPS = 1e-8;
  const int64_t kp_max = kc * (kc - 1) / 2;
  std::atomic<int64_t> n_tri(0), n_edge(0), n_fb(0);

  // Sorted copy of each coarse row for O(log kc) adjacency tests.
  std::vector<int32_t> sorted_neigh((size_t)nc * kc);
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nc; ++c) {
    int32_t* dst = sorted_neigh.data() + c * kc;
    std::memcpy(dst, coarse_neigh + c * kc, kc * sizeof(int32_t));
    std::sort(dst, dst + kc);
  }

#pragma omp parallel
  {
    // Per-pair precomputed affine geometry.
    std::vector<int32_t> pa(kp_max), pb(kp_max);        // neighbor slots
    std::vector<double> nhat(kp_max * 3), d0(kp_max);   // plane
    std::vector<double> g0(kp_max * 3), c0(kp_max);     // bary 0 affine
    std::vector<double> g1(kp_max * 3), c1(kp_max);     // bary 1 affine
    std::vector<uint8_t> pok(kp_max);
    // Per-slot edge geometry.
    std::vector<double> ev(kc * 3), el2(kc);
    std::vector<uint8_t> cand(kc), bad(kc);
    int64_t t_tri = 0, t_edge = 0, t_fb = 0;

#pragma omp for schedule(dynamic, 64)
    for (int64_t c = 0; c < nc; ++c) {
      const int32_t m0 = member_start[c], m1 = member_start[c + 1];
      if (m1 <= m0) continue;
      const double* qc = coarse_pos + (int64_t)c * 3;
      const int32_t* nbr = coarse_neigh + (int64_t)c * kc;
      int nvalid = 0;
      for (int64_t s = 0; s < kc; ++s)
        if (nbr[s] >= 0) ++nvalid;

      // ---- pair tables for this cell ----------------------------------
      int64_t np = 0;
      for (int64_t a = 0; a < kc; ++a) {
        const int32_t na = nbr[a];
        for (int64_t b = a + 1; b < kc; ++b, ++np) {
          const int32_t nb = nbr[b];
          pa[np] = (int32_t)a;
          pb[np] = (int32_t)b;
          pok[np] = 0;
          if (na < 0 || nb < 0) continue;
          if (check_voronoi) {
            const int32_t* row = sorted_neigh.data() + (int64_t)na * kc;
            if (!std::binary_search(row, row + kc, nb)) continue;
          }
          const double* qa = coarse_pos + (int64_t)na * 3;
          const double* qb = coarse_pos + (int64_t)nb * 3;
          const double e1x = qa[0] - qc[0], e1y = qa[1] - qc[1],
                       e1z = qa[2] - qc[2];
          const double e2x = qb[0] - qc[0], e2y = qb[1] - qc[1],
                       e2z = qb[2] - qc[2];
          double nx = e1y * e2z - e1z * e2y, ny = e1z * e2x - e1x * e2z,
                 nz = e1x * e2y - e1y * e2x;
          const double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
          if (!(nn > 1e-12)) continue;
          pok[np] = 1;
          const double inv_nn = 1.0 / nn;
          nx *= inv_nn; ny *= inv_nn; nz *= inv_nn;
          nhat[np * 3] = nx; nhat[np * 3 + 1] = ny; nhat[np * 3 + 2] = nz;
          d0[np] = nx * qc[0] + ny * qc[1] + nz * qc[2];
          // b0 = ((qb-qa) x (pp-qa)) . nhat / dA is affine in pp with
          // gradient (nhat x (qb-qa)) / dA, which is perpendicular to
          // nhat — so pp may be replaced by the unprojected point p.
          const double abx = qb[0] - qa[0], aby = qb[1] - qa[1],
                       abz = qb[2] - qa[2];
          double gx = ny * abz - nz * aby, gy = nz * abx - nx * abz,
                 gz = nx * aby - ny * abx;
          const double inv_dA = inv_nn;  // dA = nn
          g0[np * 3] = gx * inv_dA;
          g0[np * 3 + 1] = gy * inv_dA;
          g0[np * 3 + 2] = gz * inv_dA;
          c0[np] = -(g0[np * 3] * qa[0] + g0[np * 3 + 1] * qa[1] +
                     g0[np * 3 + 2] * qa[2]);
          const double cbx = qc[0] - qb[0], cby = qc[1] - qb[1],
                       cbz = qc[2] - qb[2];
          gx = ny * cbz - nz * cby; gy = nz * cbx - nx * cbz;
          gz = nx * cby - ny * cbx;
          g1[np * 3] = gx * inv_dA;
          g1[np * 3 + 1] = gy * inv_dA;
          g1[np * 3 + 2] = gz * inv_dA;
          c1[np] = -(g1[np * 3] * qb[0] + g1[np * 3 + 1] * qb[1] +
                     g1[np * 3 + 2] * qb[2]);
        }
      }
      // ---- per-slot edge geometry --------------------------------------
      for (int64_t s = 0; s < kc; ++s) {
        const int32_t ns = nbr[s];
        if (ns < 0) { el2[s] = 0; continue; }
        const double* qn = coarse_pos + (int64_t)ns * 3;
        ev[s * 3] = qn[0] - qc[0];
        ev[s * 3 + 1] = qn[1] - qc[1];
        ev[s * 3 + 2] = qn[2] - qc[2];
        el2[s] = ev[s * 3] * ev[s * 3] + ev[s * 3 + 1] * ev[s * 3 + 1] +
                 ev[s * 3 + 2] * ev[s * 3 + 2];
      }

      // ---- members ------------------------------------------------------
      for (int32_t mi = m0; mi < m1; ++mi) {
        const int64_t i = member_idx[mi];
        const double* p = fine_pos + i * 3;
        int32_t cols[3] = {(int32_t)c, (int32_t)c, (int32_t)c};
        double w[3] = {1.0, 0.0, 0.0};

        if (nested && samples && samples[c] == (int64_t)i) {
          // keep [c]=1 row
        } else if (nvalid == 0) {
          // keep [c]=1 row
        } else if (nvalid == 1) {
          // project onto segment c -> first neighbor slot
          // (multigrid_solver.cpp:309-338)
          int64_t s0 = 0;
          const double rel0 = p[0] - qc[0], rel1 = p[1] - qc[1],
                       rel2 = p[2] - qc[2];
          double tt = (rel0 * ev[s0 * 3] + rel1 * ev[s0 * 3 + 1] +
                       rel2 * ev[s0 * 3 + 2]) /
                      std::max(el2[s0], EPS * EPS);
          tt = std::min(std::max(tt, 0.0), 1.0);
          const int32_t other = nbr[s0] >= 0 ? nbr[s0] : (int32_t)c;
          cols[1] = other;
          if (weighting == 1) { w[0] = 0.5; w[1] = 0.5; }
          else if (weighting == 2) {
            const double* q1 = coarse_pos + (int64_t)other * 3;
            double dc = std::sqrt(rel0 * rel0 + rel1 * rel1 + rel2 * rel2);
            double dn = std::sqrt((p[0]-q1[0])*(p[0]-q1[0]) +
                                  (p[1]-q1[1])*(p[1]-q1[1]) +
                                  (p[2]-q1[2])*(p[2]-q1[2]));
            double w0 = 1.0 / std::max(dc, EPS), w1 = 1.0 / std::max(dn, EPS);
            const double sw = w0 + w1;
            w[0] = w0 / sw; w[1] = w1 / sw;
          } else { w[0] = 1.0 - tt; w[1] = tt; }
        } else {
          // triangle / edge / closest-3 chain
          std::memset(cand.data(), 0, kc);
          std::memset(bad.data(), 0, kc);
          double best_dt = std::numeric_limits<double>::infinity();
          int64_t best_pair = -1;
          double best_b0 = 0, best_b1 = 0;
          for (int64_t t = 0; t < np; ++t) {
            if (!pok[t]) continue;
            const double b0v = g0[t * 3] * p[0] + g0[t * 3 + 1] * p[1] +
                               g0[t * 3 + 2] * p[2] + c0[t];
            const double b1v = g1[t * 3] * p[0] + g1[t * 3 + 1] * p[1] +
                               g1[t * 3 + 2] * p[2] + c1[t];
            const double b2v = 1.0 - b0v - b1v;
            const double dtv = nhat[t * 3] * p[0] + nhat[t * 3 + 1] * p[1] +
                               nhat[t * 3 + 2] * p[2] - d0[t];
            // edge wedge bookkeeping (insideEdge map, :489-500)
            cand[pa[t]] = 1;
            cand[pb[t]] = 1;
            const bool oka = b0v >= 0 && b1v >= 0;
            const bool okb = b0v >= 0 && b2v >= 0;
            if (!oka) bad[pa[t]] = 1;
            if (!okb) bad[pb[t]] = 1;
            if (b0v >= 0 && b1v >= 0 && b2v >= 0) {
              const double ad = std::fabs(dtv);
              if (ad < best_dt) {
                best_dt = ad;
                best_pair = t;
                best_b0 = b0v;
                best_b1 = b1v;
              }
            }
          }
          if (best_pair >= 0) {
            ++t_tri;
            const int32_t na = nbr[pa[best_pair]], nb = nbr[pb[best_pair]];
            cols[1] = na; cols[2] = nb;
            if (weighting == 1) { w[0] = w[1] = w[2] = 1.0 / 3.0; }
            else if (weighting == 2) {
              double ws[3], sw = 0;
              const int32_t cc[3] = {(int32_t)c, na, nb};
              for (int j = 0; j < 3; ++j) {
                const double* q = coarse_pos + (int64_t)cc[j] * 3;
                const double d = std::sqrt(
                    (p[0]-q[0])*(p[0]-q[0]) + (p[1]-q[1])*(p[1]-q[1]) +
                    (p[2]-q[2])*(p[2]-q[2]));
                ws[j] = 1.0 / std::max(d, EPS);
                sw += ws[j];
              }
              sw = std::max(sw, EPS);
              w[0] = ws[0]/sw; w[1] = ws[1]/sw; w[2] = ws[2]/sw;
            } else {
              w[0] = best_b0; w[1] = best_b1; w[2] = 1.0 - best_b0 - best_b1;
            }
          } else {
            // nearest "inside" edge
            double best_perp = std::numeric_limits<double>::infinity();
            int64_t best_s = -1;
            double best_t = 0;
            const double rel0 = p[0] - qc[0], rel1 = p[1] - qc[1],
                         rel2 = p[2] - qc[2];
            for (int64_t s = 0; s < kc; ++s) {
              if (nbr[s] < 0 || !cand[s] || bad[s]) continue;
              const double tt = (rel0 * ev[s * 3] + rel1 * ev[s * 3 + 1] +
                                 rel2 * ev[s * 3 + 2]) /
                                std::max(el2[s], EPS * EPS);
              const double px = rel0 - tt * ev[s * 3],
                           py = rel1 - tt * ev[s * 3 + 1],
                           pz = rel2 - tt * ev[s * 3 + 2];
              const double perp = std::sqrt(px * px + py * py + pz * pz);
              if (perp < best_perp) {
                best_perp = perp;
                best_s = s;
                best_t = tt;
              }
            }
            if (best_s >= 0) {
              ++t_edge;
              const int32_t other = nbr[best_s];
              double tt = std::min(std::max(best_t, 0.0), 1.0);
              cols[1] = other;
              if (weighting == 1) { w[0] = 0.5; w[1] = 0.5; w[2] = 0.0; }
              else if (weighting == 2) {
                const double* q1 = coarse_pos + (int64_t)other * 3;
                double dc = std::sqrt(rel0*rel0 + rel1*rel1 + rel2*rel2);
                double dn = std::sqrt((p[0]-q1[0])*(p[0]-q1[0]) +
                                      (p[1]-q1[1])*(p[1]-q1[1]) +
                                      (p[2]-q1[2])*(p[2]-q1[2]));
                double w0 = 1.0/std::max(dc, EPS), w1 = 1.0/std::max(dn, EPS);
                const double sw = w0 + w1;
                w[0] = w0/sw; w[1] = w1/sw; w[2] = 0.0;
              } else { w[0] = 1.0 - tt; w[1] = tt; w[2] = 0.0; }
            } else {
              // closest-3: c plus the two nearest valid neighbors
              ++t_fb;
              double d1 = std::numeric_limits<double>::infinity();
              double d2 = std::numeric_limits<double>::infinity();
              int32_t f1 = -1, f2 = -1;
              for (int64_t s = 0; s < kc; ++s) {
                const int32_t ns = nbr[s];
                if (ns < 0) continue;
                const double* q = coarse_pos + (int64_t)ns * 3;
                const double d = std::sqrt(
                    (p[0]-q[0])*(p[0]-q[0]) + (p[1]-q[1])*(p[1]-q[1]) +
                    (p[2]-q[2])*(p[2]-q[2]));
                if (d < d1) { d2 = d1; f2 = f1; d1 = d; f1 = ns; }
                else if (d < d2) { d2 = d; f2 = ns; }
              }
              if (f1 < 0) f1 = (int32_t)c;
              if (f2 < 0) f2 = f1;
              cols[1] = f1; cols[2] = f2;
              double ws[3], sw = 0;
              const int32_t cc[3] = {(int32_t)c, f1, f2};
              for (int j = 0; j < 3; ++j) {
                const double* q = coarse_pos + (int64_t)cc[j] * 3;
                const double d = std::sqrt(
                    (p[0]-q[0])*(p[0]-q[0]) + (p[1]-q[1])*(p[1]-q[1]) +
                    (p[2]-q[2])*(p[2]-q[2]));
                ws[j] = 1.0 / std::max(d, EPS);
                sw += ws[j];
              }
              sw = std::max(sw, EPS);
              w[0] = ws[0]/sw; w[1] = ws[1]/sw; w[2] = ws[2]/sw;
            }
          }
        }
        out_cols[i * 3] = cols[0];
        out_cols[i * 3 + 1] = cols[1];
        out_cols[i * 3 + 2] = cols[2];
        out_w[i * 3] = (float)w[0];
        out_w[i * 3 + 1] = (float)w[1];
        out_w[i * 3 + 2] = (float)w[2];
      }
    }
    n_tri += t_tri;
    n_edge += t_edge;
    n_fb += t_fb;
  }
  stats[0] = n_tri.load();
  stats[1] = n_edge.load();
  stats[2] = n_fb.load();
}

}  // extern "C"
