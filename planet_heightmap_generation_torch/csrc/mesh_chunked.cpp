// The host sphere mesh on all of the host's cores: a latitude-chunked
// Delaunay, a threaded adjacency, and a threaded band census and band pack.
// Every array the pipeline reads equals the serial build's
// (native/mesh_build.cpp: mesh_delaunay, mesh_adjacency, banded_pack, and
// mesh/build.py _band_off_for) bit for bit.
//
// The chunked Delaunay. The Fibonacci spiral's index falls with z, so an
// index range [a, b) is a latitude band (each point's jitter moves it by
// less than one row). A chunk triangulates its points plus a margin of
// index rows on each side with the serial sweep-hull (the same struct, on
// the same stereographic doubles: the sweep-hull of native/mesh_build.cpp is
// compiled into this library) and keeps the triangles whose smallest vertex
// lies in [a, b). It is exact when each local triangle that touches an
// owned vertex has its circumcap (the cap on the sphere whose stereographic
// image is the triangle's circumcircle's interior) inside the z band that
// holds only loaded points, with a margin, and no owned vertex lies on the
// local hull (except in a chunk that loads the top of the spiral, whose hull
// is the global one): each owned vertex's whole star is then globally
// Delaunay. A chunk that fails is triangulated again with a doubled margin.
// The output is canonical: each triangle rotated to start at its smallest
// vertex and the triangles sorted, so it does not depend on the chunk count,
// the margins or the thread count. The caller closes the pole from the hull
// cycle and checks the whole surface (mesh_adjacency_mt's twin check, the
// Euler count), falling back to the serial build if either fails. What no
// check here sees: four points so near one circle that the sweep-hull's
// naive in-circle test takes both diagonals of their quad as legal; the
// serial build and a chunk insert in other orders and could keep different
// ones. No mesh tried (2K to 4M points, jitter 0.75 and 0) had such a quad.
//
// Compiled with -O3 -march=native -ffp-contract=off -pthread: the
// adjacency's angle and distance expressions are the serial ones, evaluated
// without contraction, so nbr_idx, nbr_mask, nbr_dist and deg match.
//
// C ABI for ctypes; all buffers are caller-allocated numpy arrays.

#include "../../native/mesh_build.cpp"

#include <atomic>
#include <memory>
#include <thread>

namespace {

// Run fn(i) for i in [0, n) on `threads` threads, items handed out one by
// one (the work of an item never depends on the thread that runs it).
template <class F>
void parallel_items(int64_t n, int threads, F fn) {
    if (threads <= 1 || n <= 1) {
        for (int64_t i = 0; i < n; i++) fn(i);
        return;
    }
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        for (int64_t i; (i = next.fetch_add(1)) < n;) fn(i);
    };
    int nt = (int)std::min<int64_t>(threads, n);
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
}

// Run fn(lo, hi) over `threads` contiguous ranges covering [0, n); the
// ranges are the same for a given (n, threads) and in order.
template <class F>
void parallel_ranges(int64_t n, int threads, F fn) {
    int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, n));
    parallel_items(nt, nt, [&](int64_t r) {
        fn(n * r / nt, n * (r + 1) / nt);
    });
}

struct Tri { int32_t a, b, c; };

// z range [*zlo, *zhi] of the cap of the sphere bounded by the circle
// through p, q, r on the side that does not hold the north pole. Returns
// false for a degenerate triple.
bool cap_z_range(const double* p, const double* q, const double* r,
                 double* zlo, double* zhi) {
    double ux = q[0] - p[0], uy = q[1] - p[1], uz = q[2] - p[2];
    double vx = r[0] - p[0], vy = r[1] - p[1], vz = r[2] - p[2];
    double nx = uy * vz - uz * vy;
    double ny = uz * vx - ux * vz;
    double nz = ux * vy - uy * vx;
    double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (!(nn > 0)) return false;
    nx /= nn; ny /= nn; nz /= nn;
    double d = nx * p[0] + ny * p[1] + nz * p[2];
    if (nz - d > 0) { nx = -nx; ny = -ny; nz = -nz; d = -d; }
    double theta = std::acos(std::max(-1.0, std::min(1.0, d)));
    double phi = std::acos(std::max(-1.0, std::min(1.0, nz)));
    *zhi = phi - theta <= 0 ? 1.0 : std::cos(phi - theta);
    *zlo = phi + theta >= M_PI ? -1.0 : std::cos(phi + theta);
    return true;
}

// A chunk's first margin, in rings of the spiral on each side: with four,
// no chunk of the meshes tried (204K to 4M points, jitter 0.75 and 0)
// needed a second run; with three, about half of them did.
constexpr double kMarginRows = 4.0;

struct Chunked {
    const double* xs;
    const double* ys;
    const double* xyz;   // [n, 3]
    int64_t n;
    const double* zmin_pre;   // [n] min z over [0, i]
    const double* zmax_suf;   // [n] max z over [i, n)
    double slack;             // z margin of the cap test

    // initial margin (index rows) at a chunk bound: `rows` rings of the
    // spiral at that latitude, a ring being ~2*pi*r / spacing points
    int64_t margin_at(int64_t i, double rows) const {
        double z = 1.0 - (2.0 * (double)i + 1.0) / (double)n;
        double r = std::sqrt(std::max(0.0, 1.0 - z * z));
        return 32 + (int64_t)std::ceil(rows * 1.7453 * r * std::sqrt((double)n));
    }

    // Triangulate [lo, hi) (owned) with margins; fills `out` with the
    // owned triangles (global indices, canonical order) and `hull` with the
    // hull cycle when the chunk loads index 0. Returns the re-runs made, or
    // -1 when the sweep-hull failed on the whole point set.
    int chunk(int64_t lo, int64_t hi, double rows, std::vector<Tri>& out,
              std::vector<int32_t>& hull) const {
        int64_t m_lo = margin_at(lo, rows), m_hi = margin_at(hi, rows);
        for (int rerun = 0;; rerun++) {
            int64_t A = std::max<int64_t>(0, lo - m_lo);
            int64_t B = std::min<int64_t>(n, hi + m_hi);
            Delaunay d;
            d.x = xs + A; d.y = ys + A; d.n = B - A;
            if (!d.run()) {
                if (A == 0 && B == n) return -1;
                m_lo *= 2; m_hi *= 2;
                continue;
            }
            const double zhi_safe = A > 0 ? zmin_pre[A - 1] - slack : 2.0;
            const double zlo_safe = B < n ? zmax_suf[B] + slack : -2.0;
            const int64_t nl = B - A;
            std::vector<char> on_hull(nl, 0);
            {
                int32_t e = d.hull_start;
                int64_t guard = 0;
                do {
                    on_hull[e] = 1;
                    e = d.hull_next[e];
                } while (e != d.hull_start && ++guard <= nl);
            }
            bool ok = true;
            if (A > 0) {
                for (int64_t v = lo - A; v < hi - A; v++)
                    if (on_hull[v]) { ok = false; break; }
            }
            const int64_t nt = (int64_t)d.triangles.size() / 3;
            out.clear();
            for (int64_t t = 0; ok && t < nt; t++) {
                int32_t l[3] = { d.triangles[3 * t], d.triangles[3 * t + 1],
                                 d.triangles[3 * t + 2] };
                int64_t g[3];
                bool touches = false;
                for (int s = 0; s < 3; s++) {
                    g[s] = A + l[s];
                    touches |= g[s] >= lo && g[s] < hi;
                }
                if (!touches) continue;
                double zl, zh;
                if (!cap_z_range(xyz + 3 * g[0], xyz + 3 * g[1],
                                 xyz + 3 * g[2], &zl, &zh)
                        || zh >= zhi_safe || zl <= zlo_safe) {
                    ok = false;
                    break;
                }
                int s0 = 0;
                if (g[1] < g[s0]) s0 = 1;
                if (g[2] < g[s0]) s0 = 2;
                if (g[s0] < lo) continue;   // another chunk owns it
                out.push_back({ (int32_t)g[s0], (int32_t)g[(s0 + 1) % 3],
                                (int32_t)g[(s0 + 2) % 3] });
            }
            if (!ok) {
                if (A == 0 && B == n) return -1;  // cannot widen further
                m_lo *= 2; m_hi *= 2;
                continue;
            }
            std::sort(out.begin(), out.end(), [](const Tri& x, const Tri& y) {
                return x.a != y.a ? x.a < y.a : x.b < y.b;
            });
            hull.clear();
            if (A == 0) {
                int32_t e = d.hull_start;
                do {
                    hull.push_back((int32_t)(A + e));
                    e = d.hull_next[e];
                    if ((int64_t)hull.size() > nl) return -1;
                } while (e != d.hull_start);
            }
            return rerun;
        }
    }
};

// One thread's share of the adjacency: its dropped pairs and whether some
// vertex's halfedges lack twins. Cache-line aligned, so that no two
// threads write one line.
struct alignas(64) VertexPart {
    std::vector<std::pair<int64_t, int64_t>> dropped;
    bool broken = false;
};

// The serial mesh_adjacency's per-vertex pass over vertices [v_lo, v_hi):
// neighbours in tangent-plane angle order, truncated to the k_max nearest
// (the dropped pairs appended to *dropped), into kept rows and fill. Every
// argument is passed by value, so the loop reads nothing of another
// thread's stack. Returns false when a vertex's halfedges v -> next and
// prev -> v are not distinct and equal as sets (no closed surface).
bool vertex_rows(int64_t v_lo, int64_t v_hi, const int32_t* tris,
                 const int32_t* inc, const int64_t* off, const double* pos,
                 int32_t k_max, int32_t* kept, int32_t* fill,
                 std::vector<std::pair<int64_t, int64_t>>* dropped) {
    std::vector<int32_t> outs, ins;
    std::vector<std::pair<double, int32_t>> ang;
    std::vector<std::pair<double, int64_t>> byd;
    std::vector<char> keep;
    for (int64_t v = v_lo; v < v_hi; v++) {
        // each incident triangle gives the halfedges v -> next and
        // prev -> v; on a closed surface they are v's neighbours
        outs.clear(); ins.clear();
        for (int64_t q = off[v]; q < off[v + 1]; q++) {
            const int32_t* tr = tris + 3 * (int64_t)inc[q];
            int s = tr[0] == v ? 0 : (tr[1] == v ? 1 : 2);
            outs.push_back(tr[(s + 1) % 3]);
            ins.push_back(tr[(s + 2) % 3]);
        }
        std::sort(outs.begin(), outs.end());
        std::sort(ins.begin(), ins.end());
        if (outs != ins
                || std::adjacent_find(outs.begin(), outs.end()) != outs.end())
            return false;
        int64_t m = (int64_t)outs.size();
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

        ang.resize(m);
        for (int64_t j = 0; j < m; j++) {
            const double* w = pos + 3 * outs[j];
            double dot = w[0]*u[0] + w[1]*u[1] + w[2]*u[2];
            double ex = w[0] - dot * u[0];
            double ey = w[1] - dot * u[1];
            double ez = w[2] - dot * u[2];
            double a1 = ex*t1x + ey*t1y + ez*t1z;
            double a2 = ex*t2x + ey*t2y + ez*t2z;
            ang[j] = { std::atan2(a2, a1), outs[j] };
        }
        std::sort(ang.begin(), ang.end());
        int32_t* row = kept + (size_t)v * k_max;
        if (m > k_max) {
            // keep the k_max nearest (by chord), preserve angle order
            byd.resize(m);
            for (int64_t j = 0; j < m; j++) {
                const double* w = pos + 3 * ang[j].second;
                double dx = w[0]-u[0], dy = w[1]-u[1], dz = w[2]-u[2];
                byd[j] = { dx*dx + dy*dy + dz*dz, j };
            }
            std::stable_sort(byd.begin(), byd.end());
            keep.assign(m, 0);
            for (int64_t j = 0; j < k_max; j++) keep[byd[j].second] = 1;
            int64_t f = 0;
            for (int64_t j = 0; j < m; j++) {
                if (keep[j]) row[f++] = ang[j].second;
                else dropped->push_back({ v, (int64_t)ang[j].second });
            }
            fill[v] = (int32_t)f;
        } else {
            for (int64_t j = 0; j < m; j++) row[j] = ang[j].second;
            fill[v] = (int32_t)m;
        }
    }
    return true;
}

// Padded adjacency rows [lo, hi): the kept neighbours with their chord
// distances (the serial expression), then self-index, 0, 0.
void write_rows(int64_t lo, int64_t hi, int64_t n_total, const double* pos,
                int32_t k_max, const int32_t* kept, const int32_t* fill,
                int32_t* nbr_idx, uint8_t* nbr_mask, float* nbr_dist,
                int32_t* deg) {
    for (int64_t v = lo; v < hi; v++) {
        int64_t m = v < n_total ? fill[v] : 0;
        deg[v] = (int32_t)m;
        const int32_t* row = kept + (size_t)v * k_max;
        for (int64_t j = 0; j < k_max; j++) {
            const int64_t e = v * k_max + j;
            if (j < m) {
                const double* u = pos + 3 * v;
                int32_t w = row[j];
                nbr_idx[e] = w;
                nbr_mask[e] = 1;
                const double* pw = pos + 3 * w;
                double dx = pw[0]-u[0], dy = pw[1]-u[1], dz = pw[2]-u[2];
                nbr_dist[e] = (float)std::sqrt(dx*dx + dy*dy + dz*dz);
            } else {
                nbr_idx[e] = (int32_t)v;
                nbr_mask[e] = 0;
                nbr_dist[e] = 0.0f;
            }
        }
    }
}

// One thread's share of the band census: a dense histogram of the
// positive offsets below CENSUS_CAP and the larger ones as a list.
constexpr int64_t CENSUS_CAP = 1 << 16;

struct alignas(64) CensusPart {
    std::vector<int64_t> hist, far;
};

void census_rows(int64_t lo, int64_t hi, const int32_t* nbr_idx,
                 const uint8_t* nbr_mask, int32_t k, CensusPart* part) {
    std::vector<int64_t> h(CENSUS_CAP, 0), far;
    for (int64_t i = lo; i < hi; i++) {
        for (int32_t s = 0; s < k; s++) {
            const int64_t e = i * k + s;
            if (!nbr_mask[e]) continue;
            const int64_t o = (int64_t)nbr_idx[e] - i;
            if (o > 0 && o < CENSUS_CAP) h[o]++;
            else if (o >= CENSUS_CAP) far.push_back(o);
        }
    }
    part->hist.swap(h);
    part->far.swap(far);
}

// One thread's share of banded_pack: rows [lo, hi) written in place, the
// exception and remainder entries kept in order.
struct alignas(64) PackPart {
    std::vector<int32_t> ef, ev, rs, rd;
};

void pack_rows(int64_t lo, int64_t hi, const int32_t* nbr_idx,
               const uint8_t* nbr_mask, int32_t k, const int32_t* band_off,
               int32_t d, uint32_t* band_bits, uint32_t* mask_bits,
               int16_t* off16, PackPart* part) {
    std::vector<int32_t> ef, ev, rs, rd;
    for (int64_t i = lo; i < hi; i++) {
        uint32_t bb = 0, mb = 0;
        const int64_t base = i * k;
        for (int32_t s = 0; s < k; s++) {
            const int64_t e = base + s;
            const int32_t j = nbr_idx[e];
            const int64_t off = (int64_t)j - i;
            if (off > 32000 || off < -32000) {
                off16[e] = 0;
                ef.push_back((int32_t)e);
                ev.push_back(j);
            } else {
                off16[e] = (int16_t)off;
            }
            if (!nbr_mask[e]) continue;
            mb |= 1u << (uint32_t)s;
            int32_t a = 0, b = d;
            while (a < b) {
                int32_t mid = (a + b) >> 1;
                if ((int64_t)band_off[mid] < off) a = mid + 1;
                else b = mid;
            }
            if (a < d && (int64_t)band_off[a] == off) {
                bb |= 1u << (uint32_t)a;
            } else {
                rs.push_back((int32_t)i);
                rd.push_back(j);
            }
        }
        band_bits[i] = bb;
        mask_bits[i] = mb;
    }
    part->ef.swap(ef); part->ev.swap(ev);
    part->rs.swap(rs); part->rd.swap(rd);
}

}  // namespace

extern "C" {

// Chunked Delaunay of n points (xs, ys: the stereographic doubles; xyz:
// their unit vectors). out_tris must hold 3 * (2n) int32, out_hull n.
// Writes the triangles (canonical: rotated to their smallest vertex,
// sorted) and the hull cycle (rotated to its smallest vertex), and
// stats[0] = the chunks' margin re-runs. Returns the triangle count, or
// -1 when a chunk could not be made exact (the caller builds serially).
int64_t mesh_delaunay_chunked(const double* xs, const double* ys,
                              const double* xyz, int64_t n,
                              int32_t n_chunks, int32_t threads,
                              int32_t* out_tris, int32_t* out_hull,
                              int64_t* hull_len, int64_t* stats) {
    if (n < 3 || n_chunks < 1) return -1;
    Chunked c;
    c.xs = xs; c.ys = ys; c.xyz = xyz; c.n = n;
    std::vector<double> zmin_pre(n), zmax_suf(n);
    double lo_z = 1e300, hi_z = -1e300;
    for (int64_t i = 0; i < n; i++) {
        lo_z = std::min(lo_z, xyz[3 * i + 2]);
        zmin_pre[i] = lo_z;
    }
    for (int64_t i = n - 1; i >= 0; i--) {
        hi_z = std::max(hi_z, xyz[3 * i + 2]);
        zmax_suf[i] = hi_z;
    }
    c.zmin_pre = zmin_pre.data();
    c.zmax_suf = zmax_suf.data();
    // a hundredth of a row's z step: far above the caps' rounding
    // (~1e-13), far below the jittered rows' spacing
    c.slack = 0.02 / (double)n;

    std::vector<std::vector<Tri>> tris(n_chunks);
    std::vector<int32_t> hull;
    std::vector<int> reruns(n_chunks, 0);
    parallel_items(n_chunks, threads, [&](int64_t k) {
        int64_t lo = n * k / n_chunks, hi = n * (k + 1) / n_chunks;
        // a copy of its own, so that no loop reads the calling thread's
        // stack, which that thread writes
        const Chunked mine = c;
        std::vector<int32_t> h;
        reruns[k] = mine.chunk(lo, hi, kMarginRows, tris[k], h);
        if (k == 0) hull.swap(h);
    });
    int64_t total = 0, rr = 0;
    for (int32_t k = 0; k < n_chunks; k++) {
        if (reruns[k] < 0) return -1;
        rr += reruns[k];
        total += (int64_t)tris[k].size();
    }
    if (total > 2 * n || hull.empty()) return -1;
    std::vector<int64_t> base(n_chunks + 1, 0);
    for (int32_t k = 0; k < n_chunks; k++)
        base[k + 1] = base[k] + (int64_t)tris[k].size();
    parallel_items(n_chunks, threads, [&](int64_t k) {
        std::memcpy(out_tris + 3 * base[k], tris[k].data(),
                    tris[k].size() * sizeof(Tri));
    });
    size_t h0 = std::min_element(hull.begin(), hull.end()) - hull.begin();
    for (size_t i = 0; i < hull.size(); i++)
        out_hull[i] = hull[(h0 + i) % hull.size()];
    *hull_len = (int64_t)hull.size();
    stats[0] = rr;
    return total;
}

// Threaded mesh_adjacency with a twin check. tris: [t, 3] including the
// pole closure; pos: [n_total, 3] float64. Fills every row of nbr_idx,
// nbr_mask, nbr_dist [n_padded, k_max] and deg [n_padded] (pad rows:
// self-index, 0, 0, 0). The per-vertex neighbour lists, their angle order,
// the truncation to the k_max nearest, the symmetric removal of dropped
// pairs and the distances are the serial function's, so the output is the
// same for any order of the triangles. Returns 0, or 1 when some halfedge
// lacks exactly one twin (the triangles are no closed surface).
int mesh_adjacency_mt(const int32_t* tris, int64_t t,
                      const double* pos, int64_t n_total,
                      int32_t k_max, int64_t n_padded,
                      int32_t* nbr_idx, uint8_t* nbr_mask, float* nbr_dist,
                      int32_t* deg, int32_t threads) {
    // vertex -> incident triangles (counting sort; the order inside a list
    // does not reach the output)
    std::vector<std::atomic<int32_t>> cnt(n_total + 1);
    parallel_ranges(n_total + 1, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t v = lo; v < hi; v++) cnt[v].store(0);
    });
    std::atomic<bool> bad_index(false);
    parallel_ranges(t, threads, [&, tris, n_total](int64_t lo, int64_t hi) {
        std::atomic<int32_t>* c = cnt.data();
        for (int64_t i = 3 * lo; i < 3 * hi; i++) {
            if (tris[i] < 0 || tris[i] >= n_total) { bad_index = true; return; }
            c[tris[i]].fetch_add(1, std::memory_order_relaxed);
        }
    });
    if (bad_index) return 1;
    std::vector<int64_t> off(n_total + 1, 0);
    for (int64_t v = 0; v < n_total; v++)
        off[v + 1] = off[v] + cnt[v].load(std::memory_order_relaxed);
    std::vector<int32_t> inc(off[n_total]);
    std::vector<std::atomic<int64_t>> fillpos(n_total);
    parallel_ranges(n_total, threads, [&](int64_t lo, int64_t hi) {
        for (int64_t v = lo; v < hi; v++) fillpos[v].store(off[v]);
    });
    parallel_ranges(t, threads, [&, tris](int64_t lo, int64_t hi) {
        std::atomic<int64_t>* fp = fillpos.data();
        int32_t* in = inc.data();
        for (int64_t i = lo; i < hi; i++)
            for (int s = 0; s < 3; s++)
                in[fp[tris[3 * i + s]].fetch_add(
                    1, std::memory_order_relaxed)] = (int32_t)i;
    });

    // rows of the kept neighbours: only the first fill[v] of a row are read
    std::unique_ptr<int32_t[]> kept(new int32_t[(size_t)n_total * k_max]);
    std::vector<int32_t> fill(n_total, 0);
    int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, n_total));
    std::vector<VertexPart> parts(nt);
    parallel_items(nt, nt, [&](int64_t r) {
        VertexPart& part = parts[r];
        part.broken = !vertex_rows(n_total * r / nt, n_total * (r + 1) / nt,
                                   tris, inc.data(), off.data(), pos, k_max,
                                   kept.get(), fill.data(), &part.dropped);
    });
    for (auto& part : parts)
        if (part.broken) return 1;

    // symmetric removal of dropped pairs (reverse edges)
    for (auto& part : parts) {
        for (auto& pr : part.dropped) {
            int64_t a = pr.second, b = pr.first;  // remove a -> b
            int32_t* row = kept.get() + (size_t)a * k_max;
            int64_t m = fill[a];
            for (int64_t j = 0; j < m; j++) {
                if (row[j] == (int32_t)b) {
                    for (int64_t jj = j; jj + 1 < m; jj++)
                        row[jj] = row[jj + 1];
                    fill[a] = (int32_t)(m - 1);
                    break;
                }
            }
        }
    }

    // write padded outputs
    parallel_ranges(n_padded, threads, [&](int64_t lo, int64_t hi) {
        write_rows(lo, hi, n_total, pos, k_max, kept.get(), fill.data(),
                   nbr_idx, nbr_mask, nbr_dist, deg);
    });
    return 0;
}

// The n_bands most common signed offsets j - i over the valid edges, as
// mesh/build.py _band_off_for picks them: the positive offsets by count,
// ties to the smaller offset, the first n_bands / 2 of them with their
// negatives, sorted. Writes them to band_off and returns their number.
int32_t band_census(const int32_t* nbr_idx, const uint8_t* nbr_mask,
                    int64_t npad, int32_t k, int32_t n_bands,
                    int32_t threads, int32_t* band_off) {
    int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, npad));
    std::vector<CensusPart> parts(nt);
    parallel_items(nt, nt, [&](int64_t r) {
        census_rows(npad * r / nt, npad * (r + 1) / nt, nbr_idx, nbr_mask, k,
                    &parts[r]);
    });
    std::vector<std::pair<int64_t, int64_t>> cand;   // (-count, offset)
    for (int64_t o = 1; o < CENSUS_CAP; o++) {
        int64_t s = 0;
        for (auto& part : parts) s += part.hist[o];
        if (s) cand.push_back({ -s, o });
    }
    std::vector<int64_t> big;
    for (auto& part : parts)
        big.insert(big.end(), part.far.begin(), part.far.end());
    std::sort(big.begin(), big.end());
    for (size_t i = 0; i < big.size();) {
        size_t j = i;
        while (j < big.size() && big[j] == big[i]) j++;
        cand.push_back({ -(int64_t)(j - i), big[i] });
        i = j;
    }
    std::sort(cand.begin(), cand.end());
    int64_t take = std::min<int64_t>(n_bands / 2, (int64_t)cand.size());
    std::vector<int64_t> chosen;
    for (int64_t i = 0; i < take; i++) {
        chosen.push_back(cand[i].second);
        chosen.push_back(-cand[i].second);
    }
    std::sort(chosen.begin(), chosen.end());
    for (size_t i = 0; i < chosen.size(); i++)
        band_off[i] = (int32_t)chosen[i];
    return (int32_t)chosen.size();
}

// banded_pack over `threads` row ranges: the same outputs, the exception
// and remainder lists in row-major edge order.
int banded_pack_mt(
    const int32_t* nbr_idx, const uint8_t* nbr_mask,
    int64_t npad, int32_t k,
    const int32_t* band_off, int32_t d,
    uint32_t* band_bits, uint32_t* mask_bits, int16_t* off16,
    int32_t* exc_flat, int32_t* exc_val, int64_t exc_cap,
    int32_t* rem_src, int32_t* rem_dst, int64_t rem_cap,
    int64_t* out_exc_n, int64_t* out_rem_n, int32_t threads)
{
    int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, npad));
    std::vector<PackPart> parts(nt);
    parallel_items(nt, nt, [&](int64_t r) {
        pack_rows(npad * r / nt, npad * (r + 1) / nt, nbr_idx, nbr_mask, k,
                  band_off, d, band_bits, mask_bits, off16, &parts[r]);
    });
    int64_t exc_n = 0, rem_n = 0;
    for (auto& part : parts) {
        exc_n += (int64_t)part.ef.size();
        rem_n += (int64_t)part.rs.size();
    }
    if (exc_n > exc_cap || rem_n > rem_cap) return -1;
    int64_t ep = 0, rp = 0;
    for (auto& part : parts) {
        std::copy(part.ef.begin(), part.ef.end(), exc_flat + ep);
        std::copy(part.ev.begin(), part.ev.end(), exc_val + ep);
        ep += (int64_t)part.ef.size();
        std::copy(part.rs.begin(), part.rs.end(), rem_src + rp);
        std::copy(part.rd.begin(), part.rd.end(), rem_dst + rp);
        rp += (int64_t)part.rs.size();
    }
    *out_exc_n = exc_n;
    *out_rem_n = rem_n;
    return 0;
}

}  // extern "C"
