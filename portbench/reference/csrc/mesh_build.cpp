// Native host mesh builder: 2D Delaunay triangulation (sweep-hull /
// incremental-with-hull-hash, the standard "delaunator" algorithm family)
// plus padded-adjacency construction for the TPU mesh.
//
// Replaces the scipy(Qhull) + numpy path in mesh/build.py, which costs
// ~80 s at 1M cells on one host core — far beyond the <2 s full-planet
// budget. This is a fresh implementation of the published algorithm
// (Sinclair's s-hull; the same one the reference consumes as the
// Delaunator library dependency, README.md:269-274): seed triangle near the
// centroid, points inserted in ascending distance from its circumcenter,
// convex hull maintained as a linked list with a pseudo-angle hash, new
// triangles legalized by in-circle flips with an explicit stack.
//
// C ABI for ctypes. All buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr double EPS = 1e-12;

struct Delaunay {
    const double* x;  // [n]
    const double* y;
    int64_t n;

    std::vector<int32_t> triangles;   // 3 per triangle
    std::vector<int32_t> halfedges;   // twin halfedge or -1
    std::vector<int32_t> hull_prev, hull_next, hull_tri;
    std::vector<int32_t> hull_hash;
    std::vector<int32_t> ids;
    std::vector<double> dists;
    std::vector<int32_t> edge_stack;
    int32_t hull_start = 0;
    int64_t hash_size = 0;
    double cx = 0, cy = 0;  // seed circumcenter

    // Robust orientation (adaptive, Shewchuk-style filter + exact fallback
    // via double-double arithmetic). The stereographic projection puts
    // near-pole points at coordinates ~1e6+, where the naive determinant's
    // rounding flips signs and produces non-manifold triangles — the same
    // reason the reference's Delaunator depends on robust-predicates.
    static void two_prod(double a, double b, double* hi, double* lo) {
        *hi = a * b;
        *lo = std::fma(a, b, -*hi);
    }

    static void two_diff(double a, double b, double* hi, double* lo) {
        double s = a - b;
        double bb = a - s;
        *lo = (a - (s + bb)) + (bb - b);
        *hi = s;
    }

    static double orient2d(double ax, double ay, double bx, double by,
                           double cx_, double cy_) {
        // positive if a,b,c counterclockwise
        double detleft = (by - ay) * (cx_ - bx);
        double detright = (bx - ax) * (cy_ - by);
        double det = detleft - detright;
        double detsum = std::abs(detleft) + std::abs(detright);
        // filter: 2^-52-scale error bound on the naive evaluation
        if (std::abs(det) >= 1e-14 * detsum) return det;

        // exact-ish fallback: evaluate with error-free transforms in
        // double-double; enough headroom for coordinates up to ~1e12
        double l1, l1e, l2, l2e, r1, r1e, r2, r2e;
        two_diff(by, ay, &l1, &l1e);
        two_diff(cx_, bx, &l2, &l2e);
        two_diff(bx, ax, &r1, &r1e);
        two_diff(cy_, by, &r2, &r2e);
        double p, pe;
        two_prod(l1, l2, &p, &pe);
        pe += l1 * l2e + l1e * l2;
        double q, qe;
        two_prod(r1, r2, &q, &qe);
        qe += r1 * r2e + r1e * r2;
        double hi, lo;
        two_diff(p, q, &hi, &lo);
        return hi + (lo + (pe - qe));
    }

    static double circumradius2(double ax, double ay, double bx, double by,
                                double cx_, double cy_) {
        double dx = bx - ax, dy = by - ay;
        double ex = cx_ - ax, ey = cy_ - ay;
        double bl = dx * dx + dy * dy;
        double cl = ex * ex + ey * ey;
        double d = 0.5 / (dx * ey - dy * ex);
        double xx = (ey * bl - dy * cl) * d;
        double yy = (dx * cl - ex * bl) * d;
        return xx * xx + yy * yy;
    }

    static void circumcenter(double ax, double ay, double bx, double by,
                             double cx_, double cy_, double* ox, double* oy) {
        double dx = bx - ax, dy = by - ay;
        double ex = cx_ - ax, ey = cy_ - ay;
        double bl = dx * dx + dy * dy;
        double cl = ex * ex + ey * ey;
        double d = 0.5 / (dx * ey - dy * ex);
        *ox = ax + (ey * bl - dy * cl) * d;
        *oy = ay + (dx * cl - ex * bl) * d;
    }

    static bool in_circle(double ax, double ay, double bx, double by,
                          double cx_, double cy_, double px, double py) {
        double dx = ax - px, dy = ay - py;
        double ex = bx - px, ey = by - py;
        double fx = cx_ - px, fy = cy_ - py;
        double ap = dx * dx + dy * dy;
        double bp = ex * ex + ey * ey;
        double cp = fx * fx + fy * fy;
        return dx * (ey * cp - bp * fy) - dy * (ex * cp - bp * fx)
             + ap * (ex * fy - ey * fx) < 0;
    }

    double pseudo_angle(double dx, double dy) const {
        double p = dx / (std::abs(dx) + std::abs(dy));
        return (dy > 0 ? 3 - p : 1 + p) / 4;  // [0..1)
    }

    int64_t hash_key(double px, double py) const {
        return (int64_t)std::floor(pseudo_angle(px - cx, py - cy) * hash_size)
               % hash_size;
    }

    int32_t add_triangle(int32_t i0, int32_t i1, int32_t i2,
                         int32_t a, int32_t b, int32_t c) {
        int32_t t = (int32_t)triangles.size();
        triangles.push_back(i0);
        triangles.push_back(i1);
        triangles.push_back(i2);
        halfedges.push_back(a);
        halfedges.push_back(b);
        halfedges.push_back(c);
        if (a != -1) halfedges[a] = t;
        if (b != -1) halfedges[b] = t + 1;
        if (c != -1) halfedges[c] = t + 2;
        return t;
    }

    void link(int32_t a, int32_t b) {
        halfedges[a] = b;
        if (b != -1) halfedges[b] = a;
    }

    int32_t legalize(int32_t a) {
        // Flip illegal edges until Delaunay; explicit stack of pending edges.
        int32_t i = 0;
        int32_t ar = 0;
        while (true) {
            int32_t b = halfedges[a];
            int32_t a0 = a - a % 3;
            ar = a0 + (a + 2) % 3;
            if (b == -1) {
                if (i == 0) break;
                a = edge_stack[--i];
                continue;
            }
            int32_t b0 = b - b % 3;
            int32_t al = a0 + (a + 1) % 3;
            int32_t bl = b0 + (b + 2) % 3;

            int32_t p0 = triangles[ar];
            int32_t pr = triangles[a];
            int32_t pl = triangles[al];
            int32_t p1 = triangles[bl];

            if (in_circle(x[p0], y[p0], x[pr], y[pr], x[pl], y[pl],
                          x[p1], y[p1])) {
                triangles[a] = p1;
                triangles[b] = p0;
                int32_t hbl = halfedges[bl];
                if (hbl == -1) {
                    // edge bl was on the hull; fix the hull's triangle ref
                    int32_t e = hull_start;
                    do {
                        if (hull_tri[e] == bl) { hull_tri[e] = a; break; }
                        e = hull_prev[e];
                    } while (e != hull_start);
                }
                link(a, hbl);
                link(b, halfedges[ar]);
                link(ar, bl);
                int32_t br = b0 + (b + 1) % 3;
                if (i >= (int32_t)edge_stack.size())
                    edge_stack.resize(edge_stack.size() * 2 + 1);
                edge_stack[i++] = br;
            } else {
                if (i == 0) break;
                a = edge_stack[--i];
            }
        }
        return ar;
    }

    bool run() {
        if (n < 3) return false;
        double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
        ids.resize(n);
        for (int64_t i = 0; i < n; i++) {
            ids[i] = (int32_t)i;
            minx = std::min(minx, x[i]); maxx = std::max(maxx, x[i]);
            miny = std::min(miny, y[i]); maxy = std::max(maxy, y[i]);
        }
        double ccx = (minx + maxx) / 2, ccy = (miny + maxy) / 2;

        // seed: point closest to bbox centroid
        int32_t i0 = 0; double mind = 1e300;
        for (int64_t i = 0; i < n; i++) {
            double d = (x[i]-ccx)*(x[i]-ccx) + (y[i]-ccy)*(y[i]-ccy);
            if (d < mind) { mind = d; i0 = (int32_t)i; }
        }
        // i1: closest to i0
        int32_t i1 = -1; mind = 1e300;
        for (int64_t i = 0; i < n; i++) {
            if ((int32_t)i == i0) continue;
            double d = (x[i]-x[i0])*(x[i]-x[i0]) + (y[i]-y[i0])*(y[i]-y[i0]);
            if (d < mind) { mind = d; i1 = (int32_t)i; }
        }
        // i2: smallest circumradius with i0,i1
        int32_t i2 = -1; double minr = 1e300;
        for (int64_t i = 0; i < n; i++) {
            if ((int32_t)i == i0 || (int32_t)i == i1) continue;
            double r = circumradius2(x[i0], y[i0], x[i1], y[i1], x[i], y[i]);
            if (r < minr) { minr = r; i2 = (int32_t)i; }
        }
        if (i2 == -1 || minr >= 1e300) return false;

        if (orient2d(x[i0], y[i0], x[i1], y[i1], x[i2], y[i2]) < 0)
            std::swap(i1, i2);

        circumcenter(x[i0], y[i0], x[i1], y[i1], x[i2], y[i2], &cx, &cy);
        dists.resize(n);
        for (int64_t i = 0; i < n; i++)
            dists[i] = (x[i]-cx)*(x[i]-cx) + (y[i]-cy)*(y[i]-cy);
        std::sort(ids.begin(), ids.end(), [&](int32_t a, int32_t b) {
            return dists[a] < dists[b];
        });

        hash_size = (int64_t)std::ceil(std::sqrt((double)n));
        hull_hash.assign(hash_size, -1);
        hull_prev.resize(n); hull_next.resize(n); hull_tri.resize(n);

        hull_start = i0;
        hull_next[i0] = i1; hull_prev[i2] = i1;
        hull_next[i1] = i2; hull_prev[i0] = i2;
        hull_next[i2] = i0; hull_prev[i1] = i0;
        hull_tri[i0] = 0; hull_tri[i1] = 1; hull_tri[i2] = 2;
        hull_hash[hash_key(x[i0], y[i0])] = i0;
        hull_hash[hash_key(x[i1], y[i1])] = i1;
        hull_hash[hash_key(x[i2], y[i2])] = i2;

        triangles.reserve((size_t)(2 * n) * 3);
        halfedges.reserve((size_t)(2 * n) * 3);
        edge_stack.assign(512, 0);
        add_triangle(i0, i1, i2, -1, -1, -1);

        double xp = 0, yp = 0;
        for (int64_t k = 0; k < n; k++) {
            int32_t i = ids[k];
            if (i == i0 || i == i1 || i == i2) continue;
            if (k > 0 && std::abs(x[i]-xp) <= EPS && std::abs(y[i]-yp) <= EPS)
                continue;  // duplicate point
            xp = x[i]; yp = y[i];

            // find visible hull edge via hash
            int32_t start = 0;
            int64_t key = hash_key(x[i], y[i]);
            for (int64_t j = 0; j < hash_size; j++) {
                start = hull_hash[(key + j) % hash_size];
                if (start != -1 && start != hull_next[start]) break;
            }
            start = hull_prev[start];
            int32_t e = start, q;
            while (q = hull_next[e],
                   orient2d(x[i], y[i], x[e], y[e], x[q], y[q]) >= 0) {
                e = q;
                if (e == start) { e = -1; break; }
            }
            if (e == -1) continue;  // near-duplicate / inside

            // first triangle from the visible edge
            int32_t t = add_triangle(e, i, hull_next[e],
                                     -1, -1, hull_tri[e]);
            hull_tri[i] = legalize(t + 2);
            hull_tri[e] = t;

            // walk forward adding triangles while edges are visible
            int32_t nx = hull_next[e];
            while (q = hull_next[nx],
                   orient2d(x[i], y[i], x[nx], y[nx], x[q], y[q]) < 0) {
                t = add_triangle(nx, i, q, hull_tri[i], -1, hull_tri[nx]);
                hull_tri[i] = legalize(t + 2);
                hull_next[nx] = nx;  // removed from hull
                nx = q;
            }
            // walk backward
            if (e == start) {
                int32_t pr;
                while (pr = hull_prev[e],
                       orient2d(x[i], y[i], x[pr], y[pr], x[e], y[e]) < 0) {
                    t = add_triangle(pr, i, e, -1, hull_tri[e], hull_tri[pr]);
                    legalize(t + 2);
                    hull_tri[pr] = t;
                    hull_next[e] = e;  // removed
                    e = pr;
                }
            }
            hull_start = e;
            hull_prev[i] = e; hull_next[e] = i;
            hull_prev[nx] = i; hull_next[i] = nx;
            hull_hash[hash_key(x[i], y[i])] = i;
            hull_hash[hash_key(x[e], y[e])] = e;
        }
        return true;
    }
};

}  // namespace

extern "C" {

// Park-Miller sequence: count draws from state s0 (post-premix), writing
// floats in (0,1) and returning the advanced state. The numpy version
// (vectorized binary modexp) costs ~5 s for 4M draws; this is a plain
// sequential loop (~20 ms) matching reference js/rng.js:3-7 bit-for-bit.
int64_t pm_sequence(int64_t s0, int64_t count, double* out) {
    int64_t s = s0;
    for (int64_t i = 0; i < count; i++) {
        s = (s * 16807) % 2147483647;
        out[i] = (double)(s - 1) / 2147483646.0;
    }
    return s;
}

// Triangulate n 2D points. out_tris must hold 3*(2n) int32. Returns the
// triangle count, and writes the hull (CCW order) into out_hull
// (size <= n) with its length in *hull_len. Returns -1 on failure.
int64_t mesh_delaunay(const double* xs, const double* ys, int64_t n,
                      int32_t* out_tris, int32_t* out_hull,
                      int64_t* hull_len) {
    Delaunay d;
    d.x = xs; d.y = ys; d.n = n;
    if (!d.run()) return -1;
    int64_t t = (int64_t)(d.triangles.size() / 3);
    std::memcpy(out_tris, d.triangles.data(),
                d.triangles.size() * sizeof(int32_t));
    int64_t hl = 0;
    int32_t e = d.hull_start;
    do {
        out_hull[hl++] = e;
        e = d.hull_next[e];
        if (hl > n) return -1;  // corrupted hull
    } while (e != d.hull_start);
    *hull_len = hl;
    return t;
}

// Build padded, angle-ordered, symmetric adjacency from triangles.
// tris: [t,3]; pos: [n_total,3] float64 unit vectors; outputs sized
// [n_padded, k_max] (nbr_idx pre-filled by caller with self-indices,
// nbr_mask zeroed) and deg [n_padded] zeroed.
int mesh_adjacency(const int32_t* tris, int64_t t,
                   const double* pos, int64_t n_total,
                   int32_t k_max, int64_t n_padded,
                   int32_t* nbr_idx, uint8_t* nbr_mask, float* nbr_dist,
                   int32_t* deg) {
    // collect unique directed edges via per-vertex neighbor sets
    std::vector<int32_t> count(n_total + 1, 0);
    // first pass: upper bound on degree (6 halfedges per triangle)
    for (int64_t i = 0; i < t * 3; i++) count[tris[i]] += 2;
    std::vector<int64_t> off(n_total + 1, 0);
    for (int64_t v = 0; v < n_total; v++) off[v + 1] = off[v] + count[v];
    std::vector<int32_t> nbr(off[n_total]);
    std::vector<int64_t> fill(n_total, 0);

    auto push_edge = [&](int32_t a, int32_t b) {
        int64_t base = off[a];
        int64_t m = fill[a];
        for (int64_t j = 0; j < m; j++)
            if (nbr[base + j] == b) return;
        nbr[base + m] = b;
        fill[a] = m + 1;
    };
    for (int64_t i = 0; i < t; i++) {
        int32_t a = tris[3 * i], b = tris[3 * i + 1], c = tris[3 * i + 2];
        push_edge(a, b); push_edge(b, a);
        push_edge(b, c); push_edge(c, b);
        push_edge(c, a); push_edge(a, c);
    }

    // per-vertex: sort neighbors by tangent-plane angle, truncate to k_max
    // nearest (marking dropped pairs for symmetric removal)
    std::vector<std::pair<int64_t, int64_t>> dropped;
    for (int64_t v = 0; v < n_total; v++) {
        int64_t m = fill[v];
        if (m == 0) continue;
        const double* u = pos + 3 * v;
        // tangent frame
        double rx, ry, rz;
        if (std::abs(u[2]) < 0.9) { rx = 0; ry = 0; rz = 1; }
        else { rx = 1; ry = 0; rz = 0; }
        double t1x = ry * u[2] - rz * u[1];
        double t1y = rz * u[0] - rx * u[2];
        double t1z = rx * u[1] - ry * u[0];
        double l = std::sqrt(t1x*t1x + t1y*t1y + t1z*t1z);
        if (l < 1e-30) l = 1;
        t1x /= l; t1y /= l; t1z /= l;
        double t2x = u[1] * t1z - u[2] * t1y;
        double t2y = u[2] * t1x - u[0] * t1z;
        double t2z = u[0] * t1y - u[1] * t1x;

        int64_t base = off[v];
        std::vector<std::pair<double, int32_t>> ang(m);
        for (int64_t j = 0; j < m; j++) {
            const double* w = pos + 3 * nbr[base + j];
            double dot = w[0]*u[0] + w[1]*u[1] + w[2]*u[2];
            double ex = w[0] - dot * u[0];
            double ey = w[1] - dot * u[1];
            double ez = w[2] - dot * u[2];
            double a1 = ex*t1x + ey*t1y + ez*t1z;
            double a2 = ex*t2x + ey*t2y + ez*t2z;
            ang[j] = { std::atan2(a2, a1), nbr[base + j] };
        }
        std::sort(ang.begin(), ang.end());
        if (m > k_max) {
            // keep the k_max nearest (by chord), preserve angle order
            std::vector<std::pair<double, int64_t>> byd(m);
            for (int64_t j = 0; j < m; j++) {
                const double* w = pos + 3 * ang[j].second;
                double dx = w[0]-u[0], dy = w[1]-u[1], dz = w[2]-u[2];
                byd[j] = { dx*dx + dy*dy + dz*dz, j };
            }
            std::stable_sort(byd.begin(), byd.end());
            std::vector<char> keep(m, 0);
            for (int64_t j = 0; j < k_max; j++) keep[byd[j].second] = 1;
            for (int64_t j = 0; j < m; j++)
                if (!keep[j])
                    dropped.push_back({ v, (int64_t)ang[j].second });
            std::vector<std::pair<double, int32_t>> kept;
            kept.reserve(k_max);
            for (int64_t j = 0; j < m; j++)
                if (keep[j]) kept.push_back(ang[j]);
            ang.swap(kept);
            m = (int64_t)ang.size();
        }
        for (int64_t j = 0; j < m; j++)
            nbr[base + j] = ang[j].second;
        fill[v] = m;
    }

    // symmetric removal of dropped pairs (reverse edges)
    for (auto& pr : dropped) {
        int64_t a = pr.second, b = pr.first;  // remove a -> b
        int64_t base = off[a];
        int64_t m = fill[a];
        for (int64_t j = 0; j < m; j++) {
            if (nbr[base + j] == (int32_t)b) {
                for (int64_t jj = j; jj + 1 < m; jj++)
                    nbr[base + jj] = nbr[base + jj + 1];
                fill[a] = m - 1;
                break;
            }
        }
    }

    // write padded outputs
    for (int64_t v = 0; v < n_total; v++) {
        int64_t m = fill[v];
        deg[v] = (int32_t)m;
        const double* u = pos + 3 * v;
        for (int64_t j = 0; j < m; j++) {
            int32_t w = nbr[off[v] + j];
            nbr_idx[v * k_max + j] = w;
            nbr_mask[v * k_max + j] = 1;
            const double* pw = pos + 3 * w;
            double dx = pw[0]-u[0], dy = pw[1]-u[1], dz = pw[2]-u[2];
            nbr_dist[v * k_max + j] = (float)std::sqrt(dx*dx + dy*dy + dz*dz);
        }
    }
    (void)n_padded;
    return 0;
}

}  // extern "C"

// ── banded_pack ──────────────────────────────────────────────────────
// Single-pass banded-adjacency classification + upload packing for
// mesh/build.py:build_banded + mesh/device.py:to_device (the numpy
// version of this pass was ~1.4 s at 1M cells on one core):
//   band_bits[i] bit d  = cell i has neighbor i + band_off[d]
//   mask_bits[i] bit s  = nbr slot s valid
//   off16[i*k+s]        = nbr_idx - i when |off| <= 32000, else 0 with an
//                         (edge, idx) exception pair appended
//   rem_src/rem_dst     = valid edges whose offset is on no band
// band_off must be sorted ascending. Returns 0 on success, -1 if a
// caller-provided capacity was exceeded (caller falls back to numpy).
extern "C" int banded_pack(
    const int32_t* nbr_idx, const uint8_t* nbr_mask,
    int64_t npad, int32_t k,
    const int32_t* band_off, int32_t d,
    uint32_t* band_bits, uint32_t* mask_bits, int16_t* off16,
    int32_t* exc_flat, int32_t* exc_val, int64_t exc_cap,
    int32_t* rem_src, int32_t* rem_dst, int64_t rem_cap,
    int64_t* out_exc_n, int64_t* out_rem_n)
{
    int64_t rem_n = 0, exc_n = 0;
    for (int64_t i = 0; i < npad; i++) {
        uint32_t bb = 0, mb = 0;
        const int64_t base = i * k;
        for (int32_t s = 0; s < k; s++) {
            const int64_t e = base + s;
            const int32_t j = nbr_idx[e];
            const int64_t off = (int64_t)j - i;
            if (off > 32000 || off < -32000) {
                off16[e] = 0;
                if (exc_n >= exc_cap) return -1;
                exc_flat[exc_n] = (int32_t)e;
                exc_val[exc_n] = j;
                exc_n++;
            } else {
                off16[e] = (int16_t)off;
            }
            if (!nbr_mask[e]) continue;
            mb |= 1u << (uint32_t)s;
            int32_t lo = 0, hi = d;
            while (lo < hi) {
                int32_t mid = (lo + hi) >> 1;
                if ((int64_t)band_off[mid] < off) lo = mid + 1;
                else hi = mid;
            }
            if (lo < d && (int64_t)band_off[lo] == off) {
                bb |= 1u << (uint32_t)lo;
            } else {
                if (rem_n >= rem_cap) return -1;
                rem_src[rem_n] = (int32_t)i;
                rem_dst[rem_n] = j;
                rem_n++;
            }
        }
        band_bits[i] = bb;
        mask_bits[i] = mb;
    }
    *out_exc_n = exc_n;
    *out_rem_n = rem_n;
    return 0;
}
