// SIG21 intrinsic-prolongation pipeline (host-side, C ABI for ctypes).
//
// Role parity with the reference's vendored SSP code
// (gravomg/src/sig21: SSP_decimate.cpp, SSP_collapse_edge.cpp,
// joint_lscm.cpp, query_fine_to_coarse.cpp, get_prolong.cpp) — built
// independently from the algorithm in Liu et al. 2021 "Surface Multigrid
// via Intrinsic Prolongation":
//
//   1. Greedy edge collapse (qslim / shortest-edge-midpoint / vertex
//      removal) under a link-condition manifoldness guard, with a binary
//      heap and lazy stale-entry rejection.
//   2. Per collapse, a JOINT parameterization of the pre- and post-patch
//      (the 1-ring union of the collapsing edge): one least-squares
//      conformal (LSCM) solve whose unknowns are the shared boundary UVs
//      plus the pre-interior (u, v) and post-interior (merged) vertices,
//      two boundary vertices pinned.  Both patches are flattened into the
//      SAME UV domain, so barycentric coordinates transfer intrinsically.
//   3. Fine-point replay *inline at collapse time* (instead of the
//      reference's stored collapse log + per-query walk): every original
//      vertex carries (face, barycentric); points bucketed on the
//      collapse's pre-faces are mapped through UV_pre -> locate in
//      UV_post -> clamped barycentric on the post face.  O(ring) work per
//      collapse, no log storage.
//
// Output is exactly the reference's prolongation contract
// (get_prolong.cpp:44-56): per original vertex a coarse triangle and
// barycentric weights, plus the decimated mesh.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_set>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};
static inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
static inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

// Dense symmetric solve via LDL^T with diagonal fallback; n <= ~40.
bool ldlt_solve(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k] * A[k * n + k];
    if (std::abs(d) < 1e-14) return false;
    A[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k)
        s -= A[i * n + k] * A[j * n + k] * A[k * n + k];
      A[i * n + j] = s / d;
    }
  }
  for (int i = 0; i < n; ++i) {  // L y = b
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i * n + k] * b[k];
    b[i] = s;
  }
  for (int i = 0; i < n; ++i) b[i] /= A[i * n + i];  // D z = y
  for (int i = n - 1; i >= 0; --i) {                 // L^T x = z
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= A[k * n + i] * b[k];
    b[i] = s;
  }
  return true;
}

struct LscmRow {
  // one complex row: sum_i (wr_i + i*wi_i) * (u_i + i*v_i), 3 vertices
  int v[3];
  double wr[3], wi[3];
};

// Local isometric 2D coordinates of a 3D triangle; returns twice-area.
double tri_local(const Vec3& p0, const Vec3& p1, const Vec3& p2, double* X,
                 double* Y) {
  Vec3 e1 = sub(p1, p0), e2 = sub(p2, p0);
  double l1 = norm(e1);
  if (l1 < 1e-300) return 0.0;
  double x2 = dot(e2, e1) / l1;
  Vec3 c = cross(e1, e2);
  double y2 = norm(c) / l1;
  X[0] = 0; Y[0] = 0;
  X[1] = l1; Y[1] = 0;
  X[2] = x2; Y[2] = y2;
  return l1 * y2;  // = 2*area
}

// LSCM row coefficients for local coords (Levy 2002): coefficient of z_i
// is (x_{i+2} - x_{i+1}) + i (y_{i+2} - y_{i+1}), scaled by 1/sqrt(dT).
bool lscm_row(const double* X, const double* Y, double dT, LscmRow& row) {
  if (dT < 1e-300) return false;
  double s = 1.0 / std::sqrt(dT);
  for (int i = 0; i < 3; ++i) {
    int a = (i + 2) % 3, b = (i + 1) % 3;
    row.wr[i] = (X[a] - X[b]) * s;
    row.wi[i] = (Y[a] - Y[b]) * s;
  }
  return true;
}

struct Decimator {
  int64_t nv;
  std::vector<Vec3> V;
  std::vector<std::array<int64_t, 3>> F;  // dead: [0] = -1
  std::vector<std::vector<int64_t>> vfaces;
  std::vector<uint8_t> alive;
  std::vector<uint32_t> stamp;
  std::vector<double> quad;  // (nv, 10) packed symmetric 4x4, qslim only
  int dec_type;

  // replay state: per original vertex its current (face, corner bary);
  // per face the bucket of original-vertex ids sitting on it.
  std::vector<int64_t> pt_face;
  std::vector<double> pt_bc;               // (nv, 3)
  std::vector<std::array<int64_t, 3>> pt_tri;  // vertex ids of pt's tri
  std::vector<std::vector<int64_t>> face_pts;

  struct HeapItem {
    double cost;
    int64_t u, v;
    uint32_t su, sv;
    bool operator<(const HeapItem& o) const { return cost > o.cost; }
  };
  std::priority_queue<HeapItem> heap;

  void quad_add(int64_t vtx, const Vec3& n, double d, double w) {
    double q[4] = {n.x, n.y, n.z, d};
    double* Q = &quad[vtx * 10];
    int idx = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = i; j < 4; ++j) Q[idx++] += w * q[i] * q[j];
  }

  double quad_eval(const double* Q, const double* p) const {
    double h[4] = {p[0], p[1], p[2], 1.0};
    double s = 0;
    int idx = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = i; j < 4; ++j) {
        double t = Q[idx++] * h[i] * h[j];
        s += (i == j) ? t : 2 * t;
      }
    return s;
  }

  void init(const double* Vp, int64_t nv_, const int64_t* Fp, int64_t nf,
            int dec_type_) {
    nv = nv_;
    dec_type = dec_type_;
    V.resize(nv);
    for (int64_t i = 0; i < nv; ++i) V[i] = {Vp[3 * i], Vp[3 * i + 1], Vp[3 * i + 2]};
    F.resize(nf);
    vfaces.assign(nv, {});
    for (int64_t f = 0; f < nf; ++f) {
      F[f] = {Fp[3 * f], Fp[3 * f + 1], Fp[3 * f + 2]};
      for (int c = 0; c < 3; ++c) vfaces[F[f][c]].push_back(f);
    }
    alive.assign(nv, 1);
    stamp.assign(nv, 0);
    if (dec_type == 0) {
      quad.assign(nv * 10, 0.0);
      for (int64_t f = 0; f < nf; ++f) {
        Vec3 c = cross(sub(V[F[f][1]], V[F[f][0]]), sub(V[F[f][2]], V[F[f][0]]));
        double a2 = norm(c);
        if (a2 < 1e-300) continue;
        Vec3 n = {c.x / a2, c.y / a2, c.z / a2};
        double d = -dot(n, V[F[f][0]]);
        for (int cc = 0; cc < 3; ++cc) quad_add(F[f][cc], n, d, 0.5 * a2);
      }
    }
    // replay init: every vertex starts on one incident face (reference
    // get_prolong.cpp:22-39 — bary 1 at its own corner).
    pt_face.assign(nv, -1);
    pt_bc.assign(nv * 3, 0.0);
    pt_tri.resize(nv);
    face_pts.assign(nf, {});
    for (int64_t f = 0; f < nf; ++f)
      for (int c = 0; c < 3; ++c) {
        int64_t vtx = F[f][c];
        if (pt_face[vtx] < 0) {
          pt_face[vtx] = f;
          pt_bc[3 * vtx + c] = 1.0;
          pt_tri[vtx] = F[f];
          face_pts[f].push_back(vtx);
        }
      }
    // seed heap with all edges
    for (int64_t f = 0; f < (int64_t)F.size(); ++f)
      for (int c = 0; c < 3; ++c) {
        int64_t a = F[f][c], b = F[f][(c + 1) % 3];
        if (a < b) push_edge(a, b);
      }
  }

  bool cost_pos(int64_t u, int64_t v, double& cost, Vec3& pos) {
    if (dec_type == 0) {  // qslim: optimal placement of combined quadric
      double Q[10];
      for (int i = 0; i < 10; ++i) Q[i] = quad[u * 10 + i] + quad[v * 10 + i];
      // 3x3 system A p = -b from stationarity
      double A[9] = {Q[0], Q[1], Q[2], Q[1], Q[4], Q[5], Q[2], Q[5], Q[7]};
      double b[3] = {-Q[3], -Q[6], -Q[8]};
      double tr = (A[0] + A[4] + A[8]) * 1e-12;
      A[0] += tr; A[4] += tr; A[8] += tr;
      double det = A[0] * (A[4] * A[8] - A[5] * A[7]) -
                   A[1] * (A[3] * A[8] - A[5] * A[6]) +
                   A[2] * (A[3] * A[7] - A[4] * A[6]);
      if (std::abs(det) > 1e-30) {
        double inv[9] = {
            (A[4] * A[8] - A[5] * A[7]) / det, (A[2] * A[7] - A[1] * A[8]) / det,
            (A[1] * A[5] - A[2] * A[4]) / det, (A[5] * A[6] - A[3] * A[8]) / det,
            (A[0] * A[8] - A[2] * A[6]) / det, (A[2] * A[3] - A[0] * A[5]) / det,
            (A[3] * A[7] - A[4] * A[6]) / det, (A[1] * A[6] - A[0] * A[7]) / det,
            (A[0] * A[4] - A[1] * A[3]) / det};
        double p[3] = {inv[0] * b[0] + inv[1] * b[1] + inv[2] * b[2],
                       inv[3] * b[0] + inv[4] * b[1] + inv[5] * b[2],
                       inv[6] * b[0] + inv[7] * b[1] + inv[8] * b[2]};
        if (std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2])) {
          pos = {p[0], p[1], p[2]};
          cost = quad_eval(Q, p);
          return true;
        }
      }
      double best = 1e300;
      Vec3 cand[3] = {V[u], V[v],
                      {0.5 * (V[u].x + V[v].x), 0.5 * (V[u].y + V[v].y),
                       0.5 * (V[u].z + V[v].z)}};
      for (auto& c : cand) {
        double p[3] = {c.x, c.y, c.z};
        double e = quad_eval(Q, p);
        if (e < best) { best = e; pos = c; }
      }
      cost = best;
      return true;
    }
    Vec3 d = sub(V[u], V[v]);
    cost = dot(d, d);
    if (dec_type == 2) pos = V[u];  // vertex removal: keep u in place
    else pos = {0.5 * (V[u].x + V[v].x), 0.5 * (V[u].y + V[v].y),
                0.5 * (V[u].z + V[v].z)};
    return true;
  }

  void push_edge(int64_t u, int64_t v) {
    double c; Vec3 p;
    cost_pos(u, v, c, p);
    heap.push({c, u, v, stamp[u], stamp[v]});
  }

  void live_faces(int64_t vtx, std::vector<int64_t>& out) {
    auto& lst = vfaces[vtx];
    size_t w = 0;
    for (size_t i = 0; i < lst.size(); ++i)
      if (F[lst[i]][0] >= 0 &&
          (F[lst[i]][0] == vtx || F[lst[i]][1] == vtx || F[lst[i]][2] == vtx))
        lst[w++] = lst[i];
    lst.resize(w);
    out.assign(lst.begin(), lst.end());
  }

  // Attempt one collapse of (u, v) at placement `pos`.  Returns false on
  // topology/parameterization rejection (nothing modified).
  bool collapse(int64_t u, int64_t v, const Vec3& pos) {
    std::vector<int64_t> fu, fv;
    live_faces(u, fu);
    live_faces(v, fv);
    std::vector<int64_t> shared;
    for (int64_t f : fu)
      for (int64_t g : fv)
        if (f == g) shared.push_back(f);
    if (shared.empty() || shared.size() > 2) return false;

    // link condition: common neighbors must be exactly the shared faces'
    // third vertices (SSP_decimate-style manifoldness guard)
    std::unordered_set<int64_t> nu, thirds;
    for (int64_t f : fu)
      for (int c = 0; c < 3; ++c)
        if (F[f][c] != u) nu.insert(F[f][c]);
    for (int64_t f : shared)
      for (int c = 0; c < 3; ++c)
        if (F[f][c] != u && F[f][c] != v) thirds.insert(F[f][c]);
    int common = 0;
    for (int64_t f : fv)
      for (int c = 0; c < 3; ++c) {
        int64_t w = F[f][c];
        if (w != v && w != u && nu.count(w) && !thirds.count(w)) return false;
      }
    (void)common;

    // ---- patch assembly -------------------------------------------------
    std::vector<int64_t> pre;  // pre faces = ring(u) ∪ ring(v)
    pre = fu;
    for (int64_t f : fv)
      if (std::find(pre.begin(), pre.end(), f) == pre.end()) pre.push_back(f);
    std::vector<int64_t> verts;  // patch vertices, u first then v
    verts.push_back(u);
    verts.push_back(v);
    for (int64_t f : pre)
      for (int c = 0; c < 3; ++c)
        if (F[f][c] != u && F[f][c] != v &&
            std::find(verts.begin(), verts.end(), F[f][c]) == verts.end())
          verts.push_back(F[f][c]);
    int np = (int)verts.size();
    auto local = [&](int64_t g) {
      for (int i = 0; i < np; ++i)
        if (verts[i] == g) return i;
      return -1;
    };

    // unknown layout: 0..np-1 = pre UVs (u=0, v=1, boundary 2..);
    // np = post merged vertex.  Boundary UVs are SHARED between the pre
    // and post energies (joint parameterization); pin verts[2], verts[3].
    int nun = np + 1;
    if (np < 4) return false;
    int pin0 = 2, pin1 = 3;

    std::vector<LscmRow> rows;
    rows.reserve(2 * pre.size());
    double X[3], Y[3];
    for (int64_t f : pre) {  // pre-patch energy at CURRENT positions
      LscmRow row;
      double dT = tri_local(V[F[f][0]], V[F[f][1]], V[F[f][2]], X, Y);
      if (!lscm_row(X, Y, dT, row)) return false;
      for (int c = 0; c < 3; ++c) row.v[c] = local(F[f][c]);
      rows.push_back(row);
    }
    size_t npre_rows = rows.size();
    for (int64_t f : pre) {  // post-patch energy at merged positions
      bool dead = std::find(shared.begin(), shared.end(), f) != shared.end();
      if (dead) continue;
      Vec3 p[3];
      int lid[3];
      for (int c = 0; c < 3; ++c) {
        int64_t g = F[f][c];
        if (g == u || g == v) { p[c] = pos; lid[c] = np; }
        else { p[c] = V[g]; lid[c] = local(g); }
      }
      LscmRow row;
      double dT = tri_local(p[0], p[1], p[2], X, Y);
      if (!lscm_row(X, Y, dT, row)) return false;
      for (int c = 0; c < 3; ++c) row.v[c] = lid[c];
      rows.push_back(row);
    }

    // ---- joint LSCM least squares (normal equations, pinned) ------------
    // unknown real layout: free vertices' (u_i, v_i); pins fixed.
    std::vector<int> dofmap(nun, -1);
    int nfree = 0;
    for (int i = 0; i < nun; ++i)
      if (i != pin0 && i != pin1) dofmap[i] = nfree++;
    int n2 = 2 * nfree;
    std::vector<double> AtA(n2 * n2, 0.0), Atb(n2, 0.0);
    double pinu[2] = {0.0, 1.0}, pinv[2] = {0.0, 0.0};
    for (auto& row : rows) {
      // two real rows: Re and Im of sum (wr+i wi)(u+i v)
      // Re: sum wr*u - wi*v ; Im: sum wi*u + wr*v
      double cr[2 * 8], ci[2 * 8];  // coefficients per free dof
      std::vector<std::pair<int, double>> re, im;
      double rhs_re = 0, rhs_im = 0;
      for (int c = 0; c < 3; ++c) {
        int vi = row.v[c];
        double wr = row.wr[c], wi = row.wi[c];
        if (vi == pin0 || vi == pin1) {
          int pi = (vi == pin0) ? 0 : 1;
          rhs_re -= wr * pinu[pi] - wi * pinv[pi];
          rhs_im -= wi * pinu[pi] + wr * pinv[pi];
        } else {
          int d = dofmap[vi];
          re.push_back({2 * d, wr});      // u coeff
          re.push_back({2 * d + 1, -wi}); // v coeff
          im.push_back({2 * d, wi});
          im.push_back({2 * d + 1, wr});
        }
      }
      (void)cr; (void)ci;
      for (auto& [i, a] : re) {
        Atb[i] += a * rhs_re;
        for (auto& [j, b2] : re)
          if (j <= i) AtA[i * n2 + j] += a * b2;
      }
      for (auto& [i, a] : im) {
        Atb[i] += a * rhs_im;
        for (auto& [j, b2] : im)
          if (j <= i) AtA[i * n2 + j] += a * b2;
      }
    }
    for (int i = 0; i < n2; ++i)
      for (int j = i + 1; j < n2; ++j) AtA[i * n2 + j] = AtA[j * n2 + i];
    for (int i = 0; i < n2; ++i) AtA[i * n2 + i] += 1e-12;
    if (!ldlt_solve(AtA, Atb, n2)) return false;

    std::vector<double> UU(nun), VV(nun);
    for (int i = 0; i < nun; ++i) {
      if (i == pin0) { UU[i] = pinu[0]; VV[i] = pinv[0]; }
      else if (i == pin1) { UU[i] = pinu[1]; VV[i] = pinv[1]; }
      else { UU[i] = Atb[2 * dofmap[i]]; VV[i] = Atb[2 * dofmap[i] + 1]; }
      if (!std::isfinite(UU[i]) || !std::isfinite(VV[i])) return false;
    }

    // validity: consistent orientation of all pre and post UV triangles
    auto signed2 = [&](int a, int b, int c) {
      return (UU[b] - UU[a]) * (VV[c] - VV[a]) -
             (UU[c] - UU[a]) * (VV[b] - VV[a]);
    };
    double ref_sign = 0.0;
    for (size_t t = 0; t < rows.size(); ++t) {
      double s = signed2(rows[t].v[0], rows[t].v[1], rows[t].v[2]);
      if (ref_sign == 0.0) ref_sign = s;
      if (s * ref_sign <= 1e-18) return false;  // flipped/degenerate patch
    }

    // ---- replay: move points from pre faces through the joint UVs -------
    // Gather point ids on the pre faces, then redistribute over the post
    // faces by barycentric location in UV_post (reference
    // query_fine_to_coarse.cpp:88-125 incl. the snap-to-closest rule).
    std::vector<int64_t> moved;
    for (int64_t f : pre) {
      for (int64_t q : face_pts[f]) moved.push_back(q);
      face_pts[f].clear();
    }
    struct PostTri { int64_t f; int l[3]; };
    std::vector<PostTri> post;
    for (int64_t f : pre) {
      if (std::find(shared.begin(), shared.end(), f) != shared.end()) continue;
      PostTri pt;
      pt.f = f;
      for (int c = 0; c < 3; ++c) {
        int64_t g = F[f][c];
        pt.l[c] = (g == u || g == v) ? np : local(g);
      }
      post.push_back(pt);
    }
    if (post.empty()) return false;
    for (int64_t q : moved) {
      // current triangle corners -> local patch ids (pre indexing)
      double qu = 0, qv = 0;
      for (int c = 0; c < 3; ++c) {
        int li = local(pt_tri[q][c]);
        if (li < 0) return false;  // should not happen: tri is a pre face
        qu += pt_bc[3 * q + c] * UU[li];
        qv += pt_bc[3 * q + c] * VV[li];
      }
      double best = 1e300;
      int bi = 0;
      double bb[3] = {1, 0, 0};
      for (size_t t = 0; t < post.size(); ++t) {
        int a = post[t].l[0], b = post[t].l[1], c = post[t].l[2];
        double den = signed2(a, b, c);
        if (std::abs(den) < 1e-300) continue;
        double w0 = ((UU[b] - qu) * (VV[c] - qv) - (UU[c] - qu) * (VV[b] - qv)) / den;
        double w1 = ((UU[c] - qu) * (VV[a] - qv) - (UU[a] - qu) * (VV[c] - qv)) / den;
        double w2 = 1.0 - w0 - w1;
        double d = -std::min(w0, std::min(w1, w2));  // <=0 iff inside
        if (d < best) {
          best = d;
          bi = (int)t;
          bb[0] = w0; bb[1] = w1; bb[2] = w2;
        }
      }
      double s = 0;
      for (int c = 0; c < 3; ++c) { bb[c] = std::max(0.0, bb[c]); s += bb[c]; }
      if (s <= 0) { bb[0] = 1; bb[1] = bb[2] = 0; s = 1; }
      int64_t f = post[bi].f;
      pt_face[q] = f;
      for (int c = 0; c < 3; ++c) {
        pt_bc[3 * q + c] = bb[c] / s;
        int64_t g = F[f][c];
        pt_tri[q][c] = (g == u || g == v) ? u : g;  // merged vertex is u
      }
      face_pts[f].push_back(q);
    }

    // ---- commit the collapse --------------------------------------------
    V[u] = pos;
    alive[v] = 0;
    for (int64_t f : shared) F[f][0] = -1;  // kill shared faces
    for (int64_t f : fv) {
      if (F[f][0] < 0) continue;
      for (int c = 0; c < 3; ++c)
        if (F[f][c] == v) F[f][c] = u;
      vfaces[u].push_back(f);
    }
    vfaces[v].clear();
    if (dec_type == 0)
      for (int i = 0; i < 10; ++i) quad[u * 10 + i] += quad[v * 10 + i];
    ++stamp[u];
    ++stamp[v];
    // refresh candidate edges around u
    std::vector<int64_t> fu2;
    live_faces(u, fu2);
    std::unordered_set<int64_t> seen;
    for (int64_t f : fu2)
      for (int c = 0; c < 3; ++c) {
        int64_t w = F[f][c];
        if (w != u && alive[w] && seen.insert(w).second) {
          ++stamp[w];
          push_edge(std::min(u, w), std::max(u, w));
        }
      }
    return true;
  }

  int64_t run(int64_t target_nv) {
    int64_t n_alive = nv;
    int64_t fails = 0;
    while (n_alive > target_nv && !heap.empty()) {
      HeapItem it = heap.top();
      heap.pop();
      if (!alive[it.u] || !alive[it.v]) continue;
      if (it.su != stamp[it.u] || it.sv != stamp[it.v]) continue;
      double c; Vec3 p;
      cost_pos(it.u, it.v, c, p);
      if (collapse(it.u, it.v, p)) {
        --n_alive;
        fails = 0;
      } else if (++fails > 8 * nv) {
        break;  // nothing collapsible remains
      }
    }
    return n_alive;
  }
};

}  // namespace

extern "C" {

// Decimate + intrinsic replay.  Outputs (caller-allocated):
//   Vc (nv*3 doubles, first nc rows valid), Fc (nf*3 int64, first *nfc),
//   P_cols (nv*3 int64), P_w (nv*3 doubles), alive (nv int8).
// Returns nc, or -1.
int64_t ssp_decimate(const double* Vp, int64_t nv, const int64_t* Fp,
                     int64_t nf, int64_t target_nv, int dec_type,
                     double* Vc, int64_t* Fc, int64_t* nfc_out,
                     int64_t* P_cols, double* P_w, int8_t* alive_out) {
  if (nv <= 0 || nf <= 0) return -1;
  Decimator D;
  D.init(Vp, nv, Fp, nf, dec_type);
  D.run(target_nv);
  for (int64_t i = 0; i < nv; ++i) alive_out[i] = (int8_t)D.alive[i];

  // compact surviving vertices
  std::vector<int64_t> remap(nv, -1);
  int64_t nc = 0;
  for (int64_t i = 0; i < nv; ++i)
    if (D.alive[i]) {
      remap[i] = nc;
      Vc[3 * nc] = D.V[i].x;
      Vc[3 * nc + 1] = D.V[i].y;
      Vc[3 * nc + 2] = D.V[i].z;
      ++nc;
    }
  int64_t nfc = 0;
  for (int64_t f = 0; f < nf; ++f) {
    if (D.F[f][0] < 0) continue;
    int64_t a = D.F[f][0], b = D.F[f][1], c = D.F[f][2];
    if (a == b || b == c || a == c) continue;
    Fc[3 * nfc] = remap[a];
    Fc[3 * nfc + 1] = remap[b];
    Fc[3 * nfc + 2] = remap[c];
    ++nfc;
  }
  *nfc_out = nfc;
  for (int64_t q = 0; q < nv; ++q) {
    if (D.alive[q]) {  // surviving vertex: exact identity row
      P_cols[3 * q] = remap[q];
      P_cols[3 * q + 1] = P_cols[3 * q + 2] = 0;
      P_w[3 * q] = 1.0;
      P_w[3 * q + 1] = P_w[3 * q + 2] = 0.0;
      continue;
    }
    for (int c = 0; c < 3; ++c) {
      int64_t g = D.pt_tri[q][c];
      int64_t cg = (g >= 0 && remap[g] >= 0) ? remap[g] : -1;
      P_cols[3 * q + c] = cg;
      P_w[3 * q + c] = D.pt_bc[3 * q + c];
    }
    // normalize defensively; kill weights on lost columns
    double s = 0;
    for (int c = 0; c < 3; ++c) {
      if (P_cols[3 * q + c] < 0) { P_cols[3 * q + c] = 0; P_w[3 * q + c] = 0; }
      s += P_w[3 * q + c];
    }
    if (s <= 0) { P_w[3 * q] = 1.0; }
    else
      for (int c = 0; c < 3; ++c) P_w[3 * q + c] /= s;
  }
  return nc;
}

}  // extern "C"
