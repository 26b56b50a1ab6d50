// Banded neighbour-sweep kernels for Hopper (sm_90a).
//
// The mesh's adjacency is "banded" (mesh/build.py): neighbour j of cell i
// sits at j = i + off[d] for one of D <= 32 signed offsets, and bit d of
// bits[i] says whether that band edge exists. The few remainder edges
// outside the bands (~0.5 % of edges) come as CSR rows of their receiving
// cell, in edge order (ops/banded.py rem_csr).
//
// Two kinds of kernel:
//
// - One synchronous (Jacobi) sweep per launch (warp, rain shadow; and a
//   single BFS sweep, for the components loop, whose driver does host-side
//   work between sweeps): a sweep reads every neighbour from the INPUT
//   buffer and writes to a separate OUTPUT buffer, so the result does not
//   depend on the order in which blocks run and equals one iteration of the
//   JAX jnp loop. Warp leaves its remainder edges to the Python driver
//   (torch scatters after each launch); rain shadow sums, so it walks the
//   CSR rows in-kernel in edge order, which reproduces the jnp order.
// - A persistent relax kernel (BFS, ε-fill, stress, smoothing: "Staged-
//   window relax" below): ONE cooperative launch runs the whole loop, sweep
//   after sweep, with a grid barrier between sweeps, the remainder edges
//   in-kernel and the sweep count written to device memory. The fixpoint
//   loops (BFS, ε-fill, stress) keep a device-side change flag; smoothing
//   runs its fixed number of passes. The host issues one launch and reads
//   nothing back.
//
// What bounds these kernels on an H100: memory traffic, never arithmetic
// for a single sweep. The least a sweep must move is its state and
// auxiliary planes read once, the packed u32 band bits read once and the
// state written once: at 204K cells ~10 MB for the 4-field BFS, ~3 us at
// 3.35 TB/s. The one-sweep kernels read band neighbours straight from
// L2 (the largest |off| is ~3.6*sqrt(N) cells), one bit test per band; a
// warp issues a band's load whenever any of its 32 lanes has that bit,
// so it touches up to D neighbour lines per field where a cell needs ~6.
// The staged-window kernels load each chunk's band window into shared
// memory with coalesced loads instead (PERF.md has the measured times).
//
// Reads off the mesh: a set band bit always points inside [0, NP), but
// indices are still wrapped modulo NP (jnp.roll semantics) so no thread
// can read out of bounds; CSR rows are clamped to [0, M] and columns
// outside [0, NP) skipped.
//
// Change flag: the one-sweep min/argmin kernels OR "some cell changed"
// into *flag (one atomicOr per block after a block-level OR) when flag is
// not null; the rain-shadow pass runs a fixed count and has none.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps a*b+c as two rounded
// operations, as torch evaluates it, so the warp distances match bit for
// bit. The grid barrier (cooperative_groups::this_grid().sync()) needs no
// -rdc since CUDA 11.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdlib>
#include <initializer_list>
#include <mutex>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBands = 32;
constexpr int kThreads = 256;
// Staged-window kernels: one 1024-thread block per SM, one work item each
// per sweep. Of the block shapes timed on an H100 while this kernel was
// brought up (256 to 1024 threads, 1 to 8 items per SM), the fewest and
// largest blocks ran fastest: the cheapest grid barrier and the longest
// chunks, so the halo is staged least often.
constexpr int kRelaxThreads = 1024;
constexpr long kItemsPerSm = 1;
// The most fields one smoothing launch carries (one staged window each).
constexpr int kMaxSmoothFields = 4;

struct Bands {
  int n;
  int off[kMaxBands];
};

__device__ __forceinline__ int wrap(int j, int np) {
  return j < 0 ? j + np : (j >= np ? j - np : j);
}

// All threads of the block must call this (it contains a barrier).
__device__ __forceinline__ void or_flag(int* flag, bool changed) {
  int any = __syncthreads_or(changed ? 1 : 0);
  if (flag != nullptr && threadIdx.x == 0 && any) atomicOr(flag, 1);
}

// ── 3. Terrain warp: nearest-candidate propagation ─────────────────────
// Replaces _make_warp_kernel (sweep_pallas.py:480). State planes [4, NP]:
// source index (f32), source position xyz; w [3, NP] is the cell's warped
// target. The cell adopts the band neighbour's candidate that lies
// strictly closer to its own target, first minimum in band order.
__global__ void __launch_bounds__(kThreads)
warp_sweep_kernel(const float* __restrict__ s, const float* __restrict__ w,
                  const uint32_t* __restrict__ bits, float* __restrict__ out,
                  int* flag, int np, Bands bands) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool changed = false;
  if (i < np) {
    const float* px = s + np;
    const float* py = s + 2 * (size_t)np;
    const float* pz = s + 3 * (size_t)np;
    const float wx = w[i], wy = w[np + i], wz = w[2 * (size_t)np + i];
    float dx = px[i] - wx, dy = py[i] - wy, dz = pz[i] - wz;
    float best = dx * dx + dy * dy + dz * dz;
    int src = i;
    const uint32_t b = bits[i];
    for (int d = 0; d < bands.n; ++d) {
      if (!((b >> d) & 1u)) continue;
      const int j = wrap(i + bands.off[d], np);
      dx = px[j] - wx;
      dy = py[j] - wy;
      dz = pz[j] - wz;
      const float cd = dx * dx + dy * dy + dz * dz;
      if (cd < best) {
        best = cd;
        src = j;
      }
    }
    out[i] = s[src];
    out[np + i] = px[src];
    out[2 * (size_t)np + i] = py[src];
    out[3 * (size_t)np + i] = pz[src];
    changed = src != i;
  }
  or_flag(flag, changed);
}

// ── Remainder edges as CSR rows ────────────────────────────────────────
// The smoothing and rain-shadow kernels SUM over neighbours, and a sum is
// not order-free: the remainder edges (the ~0.5 % of edges outside the
// bands) are walked inside the kernel, after the bands, from a CSR whose
// rows keep the edges' original order (ops/banded.py rem_csr: a stable sort
// by destination cell). That reproduces the JAX jnp order
// ((sum over bands + r0) + r1) and, unlike an atomic scatter, gives the
// same bits on every run. Rows are bounded by m and columns outside
// [0, NP) are skipped, so a malformed CSR cannot make a thread read off
// the arrays.
__device__ __forceinline__ int row_begin(const int* ptr, int i, int m) {
  const int k = ptr[i];
  return k < 0 ? 0 : (k > m ? m : k);
}
__device__ __forceinline__ int row_end(const int* ptr, int i, int m) {
  const int k = ptr[i + 1];
  return k < 0 ? 0 : (k > m ? m : k);
}

// ── 1, 2, 4, 5. Staged-window relax: BFS, stress, ε-fill, smoothing ────
// Replace _make_bfs_kernel (sweep_pallas.py:171), _make_stress_kernel
// (:388), _make_flood_kernel (:230) and _make_smooth_kernel (:564). One
// loop template, four rules:
//   BFS       out = min(cur, min_{nbr j} cur[f, j] + cost[f, i])
//   ε-fill    out = min(surf, max(elev_baked, min_{nbr j} surf'[j] + eps)),
//             surf'[j] = big at inland cells
//   stress    gated argmax of the neighbours' propagated stress, with the
//             sender's subduct factor as payload (StressRule below)
//   smoothing out = (f[i] + sum_{gated nbr j} f[j]) / c[i] (SmoothRule)
// Seeds, barriers and frozen cells are baked into cost / elev_baked. With
// cost = 0 and cell-index labels the BFS rule is one min-label sweep of
// the connected-components core. The remainder edges fold into the same
// min before cost or eps is added: f32 addition rounds monotonically, so
// min(a + c, b + c) == min(a, b) + c bit for bit, and the result equals the
// kernel-then-torch-scatter step it replaces.
//
// Inside a sweep, work items are (group, chunk of T consecutive cells): a
// group is a field (BFS), the surface (ε-fill), a stress layer, or all the
// fields of a smoothing call. A block stages the chunk's band window
// [c0 - H, c0 + T + H) of each plane the rule reads at neighbours into
// shared memory as coalesced, aligned float4 loads (H = max |off|, read
// from the offsets; nw windows an item: one for BFS and ε-fill, two for
// stress, one per field for smoothing), then each thread walks the set
// bits of its cell and reads those band neighbours from the windows: a
// cell costs (T + 2H) / T global words per window instead of up to 32 line
// loads per warp. T is chosen at launch for the windows an item holds (one
// 1024-thread block per SM, one item each: at 204K cells T = 7168 for the
// 4-field BFS, 2048 for one field, with H = 1597). On an H100 a sweep takes
// a few times its byte bound and is not held by L2 latency: several loads
// in flight per thread did not help, nor did a warp-uniform band walk
// (conflict-free reads, but a warp's 32 cells use nearly all 32 bands); in
// the relax kernel the grid barrier and the flag add about half a one-
// sweep launch's time (PERF.md has the numbers).
//
// The relax kernel runs the whole loop in one cooperative launch (grid =
// co-resident blocks, cudaLaunchCooperativeKernel): sweep s reads only what
// sweep s-1 wrote (two buffers in turn; sweep 0 reads the input), and a
// grid barrier separates sweeps. The change flag rotates over three int32
// slots: slot s % 3 is ORed in sweep s and read by every block after the
// barrier, slot (s + 1) % 3 is zeroed by block 0 before it, so no block
// reads a slot that another is resetting, and every block takes the same
// exit decision. A fixpoint loop stops at the first sweep that changes
// nothing or after `cap` sweeps (0 = no cap); smoothing (`fixed`) runs
// exactly `cap` passes. The sweep count goes to ctl[3]. Buffers written by
// other blocks are read with __ldcg (L2, not the incoherent L1 or
// read-only path).
//
// BFS, stress and smoothing run one Jacobi sweep per barrier: the BFS and
// stress loops on the path end at their caps, where any more relaxation per
// round would give other values than the jnp loop (and stress's payload
// ties leave no unique fixpoint to reach by another schedule); a smoothing
// pass is one term of a fixed sum. The ε-fill may run `inner` sweeps per
// barrier on its staged chunk (the TPU's stale-halo scheme,
// sweep_pallas.py:230-260): the chunk's own cells update in shared memory,
// the halo and the remainder neighbours stay as the round began. The fill
// operator is monotone and its iterates fall from surface0, so every
// update reads values at or above the Jacobi fixpoint and the loop can only
// stop at a fixpoint: it reaches the same greatest fixpoint, bit for bit,
// in fewer barrier rounds. The count it reports is rounds.
//
// Bound: per sweep, bytes (the state, its static planes, bits and the CSR
// read once, the state written once); per relax launch each byte counts
// once and the work of every sweep counts toward operations.

namespace cg = cooperative_groups;

// The staged planes load as aligned float4 words: the entry points refuse
// NP % 4 != 0 and planes off a 16-byte boundary.
struct Geo {
  int np;
  int ng;  // item groups: fields (BFS), 1 (ε-fill, smoothing), layers (stress)
  int nw;  // staged windows an item holds
  int T, H, m;
  const uint32_t* bits;
  const int* rptr;
  const int* rnbr;
  Bands bands;
};

// Floats one staged window takes: the chunk, a halo of H on each side and
// the float4 alignment slack, in whole float4 words.
__host__ __device__ constexpr long window_floats(long t, long h) {
  return (t + 2 * h + 8 + 3) / 4 * 4;
}

// A rule reads the state at cell j of its plane as the neighbours see it
// (stage, stage4: four cells), a cell's own value (own) and its static
// term (aux: the cost or the baked elevation), makes the new value
// (update) and, for the inner sweeps, the value the window keeps
// (restage).
struct BfsRule {
  const float* cost;
  __device__ float stage(const float* sf, int j) const { return __ldcg(sf + j); }
  __device__ float4 stage4(const float* sf, int j) const {
    return __ldcg(reinterpret_cast<const float4*>(sf + j));
  }
  __device__ float own(float w, const float*, int) const { return w; }
  __device__ float aux(size_t t, int) const { return __ldg(cost + t); }
  __device__ float update(float c, float best, float cost_i) const {
    return fminf(c, best + cost_i);
  }
  __device__ float restage(float v, int) const { return v; }
};

struct FloodRule {
  const float* inland;
  const float* baked;
  float big, eps;
  __device__ float stage(const float* sf, int j) const {
    const float v = __ldcg(sf + j);
    return __ldg(inland + j) > 0.0f ? big : v;
  }
  __device__ float4 stage4(const float* sf, int j) const {
    float4 v = __ldcg(reinterpret_cast<const float4*>(sf + j));
    const float4 m = __ldg(reinterpret_cast<const float4*>(inland + j));
    v.x = m.x > 0.0f ? big : v.x;
    v.y = m.y > 0.0f ? big : v.y;
    v.z = m.z > 0.0f ? big : v.z;
    v.w = m.w > 0.0f ? big : v.w;
    return v;
  }
  // inland cells are frozen and show `big` in the window: their own value
  // is the input's
  __device__ float own(float w, const float* sf, int i) const {
    const float v = __ldcg(sf + i);
    return __ldg(inland + i) > 0.0f ? v : w;
  }
  __device__ float aux(size_t, int i) const { return __ldg(baked + i); }
  __device__ float update(float c, float best, float baked_i) const {
    return fminf(c, fmaxf(baked_i, best + eps));
  }
  __device__ float restage(float v, int i) const {
    return __ldg(inland + i) > 0.0f ? big : v;
  }
};

// Stress propagation, the jnp semantics of _propagate_stress_jnp
// (tpu ops/banded.py:613). State per layer l: planes 3l..3l+2 = st, sf,
// act (0/1); the ocean plane is static. A neighbour j sends
//   key_j = act_j > 0 && oc_j <= 0 && prop_j >= 0.005 ? prop_j : -inf,
//   prop_j = st_j * (sf_j > 0.5 ? sub_decay : decay).
// Over the layer's gated band bits in band order the cell keeps the first
// strict maximum key (and its sender's sf). Over its gated remainder edges
// it takes w = max key and, for the payload, the LARGEST sf among the edges
// whose key equals w (the jnp's two-phase scatter-max); w replaces the band
// best if it is larger. The cell adopts the result, with act = 1, if it is
// > st. The windows hold key_j (computed once per cell while staging, the
// same single multiply) and sf_j, so a band neighbour costs two shared
// loads and no act / ocean loads.
struct StressRule {
  const float* ocean;    // [G, NP]
  const uint32_t* bits;  // [G, NP]: band bits of each layer's gate
  const uint8_t* rgate;  // [G, M]: remainder gates, in CSR order
  float decay, sub_decay;
  __device__ float key(float st, float sf, float act, float oc) const {
    const float prop = st * (sf > 0.5f ? sub_decay : decay);
    return (act > 0.0f && oc <= 0.0f && prop >= 0.005f) ? prop : -INFINITY;
  }
};

// Laplacian smoothing, the jnp semantics of ops/banded.py _smooth_field_jnp
// / _smooth_masked_jnp and climate/temperature.py _diffuse_warmth_jnp:
//   s   = sum over band neighbours j (in band order, from 0.0), then the
//         remainder neighbours (in edge order), of f[j] - counting only
//         neighbours with gate[j] > 0 when gate is given;
//   out = (f[i] + s) / c[i]          where upd is null or upd[i] > 0,
//   out = f[i]                       elsewhere.
// c = 1 + degree (or 1 + the number of gated neighbours) comes in as a
// plane. The division is IEEE-rounded (no fast math), as torch's is; the
// Pallas kernel multiplied by a precomputed 1/c instead. Masked smoothing
// passes gate = upd = mask; the frozen-cell restore of the ocean-warmth
// diffusion passes gate = null, upd = not frozen. One thread per cell
// carries all F fields, so bits, c, upd and the CSR row are read once.
//
// The gate folds into the staging: the window holds gate_j > 0 ? f_j : +0.0f,
// and the band walk adds every set band's window value. That is exact: s
// starts at +0.0f, and in round-to-nearest a sum is -0.0 only when both
// addends are -0.0, so s is never -0.0 and adding +0.0f leaves it
// unchanged; an ungated neighbour's inf or NaN never reaches the sum. The
// remainder neighbours read gate and f from global memory.
struct SmoothRule {
  const float* c;
  const float* gate;  // or null
  const float* upd;   // or null
};

template <class R>
struct RelaxArgs {
  R rule;
  Geo geo;
  const float* in;
  float* out;
  float* tmp;
  int* ctl;    // [4]: three rotating change-flag slots, then the sweep count
  int* total;  // running sweep total across launches, or null
  int cap;
  int inner;
  int planes;  // state planes (what the last buffer copy moves)
  bool fixed;  // run exactly `cap` sweeps, no change flag
};

// j in [-NP, inf) wrapped into [0, NP); windows reach past NP at most
// by T + H + 3, so the loop runs once at most on all but tiny meshes
__device__ __forceinline__ int wrap_up(int j, int np) {
  if (j < 0) j += np;
  while (j >= np) j -= np;
  return j;
}

// Staging words a thread keeps in flight at once.
constexpr int kStageBatch = 8;

// A chunk's window: it starts at the multiple of 4 at or below c0 - H, so
// that it loads as aligned float4 words (NP % 4 == 0: a word never
// straddles the wrap); `base` is cell c0's slot, nq the float4 words, c1
// the chunk's end.
struct Span {
  int ws, base, nq, c1;
};

__device__ __forceinline__ Span span_of(const Geo& g, int c0) {
  const int lead = (c0 - g.H) & 3;
  return Span{c0 - g.H - lead, g.H + lead, (g.T + 2 * g.H + lead + 3) >> 2,
              min(c0 + g.T, g.np)};
}

// Stage the words q = 0 .. nq-1 of a window: load(j) reads the float4 word
// at cell j (a multiple of 4), put(q, v) stores it; B words in flight per
// thread. All threads of the block must call it.
template <class V, int B, class Load, class Put>
__device__ __forceinline__ void stage(const Span& sp, int np, Load load,
                                      Put put) {
  const int step = blockDim.x;
  for (int q0 = threadIdx.x; q0 < sp.nq; q0 += B * step) {
    V v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int q = q0 + u * step;
      if (q < sp.nq) v[u] = load(wrap_up(sp.ws + 4 * q, np));
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int q = q0 + u * step;
      if (q < sp.nq) put(q, v[u]);
    }
  }
}

// One BFS / ε-fill work item: field f, cells [c0, c0 + T). `inner` sweeps
// on the staged window (1: a plain Jacobi sweep, written straight to dst).
// Band neighbours come from the window (offs: the band offsets in shared
// memory), remainder neighbours from global memory. Returns this thread's
// "some cell changed". All threads of the block must call it.
template <class R>
__device__ bool relax_item(const R& r, const Geo& g, const float* src,
                           float* dst, int f, int c0, float* win,
                           const int* offs, int inner) {
  const float* sf = src + (size_t)f * g.np;
  float* df = dst + (size_t)f * g.np;
  const Span sp = span_of(g, c0);
  float4* win4 = reinterpret_cast<float4*>(win);
  stage<float4, kStageBatch>(
      sp, g.np, [&](int j) { return r.stage4(sf, j); },
      [&](int q, float4 v) { win4[q] = v; });
  __syncthreads();
  const int step = blockDim.x;
  const uint32_t live = g.bands.n < 32 ? (1u << g.bands.n) - 1u : ~0u;
  bool changed = false;
  for (int s = 0; s < inner; ++s) {
    bool ch = false;
    for (int i = c0 + threadIdx.x; i < sp.c1; i += step) {
      const int p = sp.base + (i - c0);
      const float c = r.own(win[p], sf, i);
      float best = INFINITY;
      for (uint32_t b = __ldg(g.bits + i) & live; b; b &= b - 1)
        best = fminf(best, win[p + offs[__ffs(b) - 1]]);
      if (g.m > 0) {
        const int k1 = row_end(g.rptr, i, g.m);
        for (int k = row_begin(g.rptr, i, g.m); k < k1; ++k) {
          const int j = __ldg(g.rnbr + k);
          if (j >= 0 && j < g.np) best = fminf(best, r.stage(sf, j));
        }
      }
      const float v = r.update(c, best, r.aux((size_t)f * g.np + i, i));
      if (inner == 1) {
        df[i] = v;
      } else if (v != c) {
        win[p] = r.restage(v, i);
      }
      ch |= v != c;
    }
    changed |= ch;
    // a sweep that changed nothing in the chunk leaves it at a fixpoint of
    // its stale halo: the remaining inner sweeps would change nothing
    if (inner > 1 && !__syncthreads_or(ch)) break;
  }
  if (inner > 1) {
    for (int i = c0 + threadIdx.x; i < sp.c1; i += step)
      df[i] = r.own(win[sp.base + (i - c0)], sf, i);
  }
  __syncthreads();  // the window is restaged by the next item
  return changed;
}

struct KeySf {
  float4 key, sf;
};

// One stress work item: layer l, cells [c0, c0 + T), one Jacobi sweep.
__device__ bool stress_item(const StressRule& r, const Geo& g,
                            const float* src, float* dst, int l, int c0,
                            float* win, const int* offs) {
  const size_t np = g.np;
  const float* st = src + 3 * l * np;
  const float* sf = st + np;
  const float* act = sf + np;
  const float* oc = r.ocean + l * np;
  const uint32_t* bits = r.bits + l * np;
  const uint8_t* rg = r.rgate + (size_t)l * g.m;
  float* d_st = dst + 3 * l * np;
  const Span sp = span_of(g, c0);
  float* wkey = win;
  float* wsf = win + window_floats(g.T, g.H);
  stage<KeySf, kStageBatch / 4>(
      sp, g.np,
      [&](int j) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(st + j));
        const float4 b = __ldcg(reinterpret_cast<const float4*>(sf + j));
        const float4 c = __ldcg(reinterpret_cast<const float4*>(act + j));
        const float4 o = __ldg(reinterpret_cast<const float4*>(oc + j));
        KeySf v;
        v.key = make_float4(
            r.key(a.x, b.x, c.x, o.x), r.key(a.y, b.y, c.y, o.y),
            r.key(a.z, b.z, c.z, o.z), r.key(a.w, b.w, c.w, o.w));
        v.sf = b;
        return v;
      },
      [&](int q, const KeySf& v) {
        reinterpret_cast<float4*>(wkey)[q] = v.key;
        reinterpret_cast<float4*>(wsf)[q] = v.sf;
      });
  __syncthreads();
  const uint32_t live = g.bands.n < 32 ? (1u << g.bands.n) - 1u : ~0u;
  bool changed = false;
  for (int i = c0 + threadIdx.x; i < sp.c1; i += blockDim.x) {
    const int p = sp.base + (i - c0);
    float best = -INFINITY;
    float bsf = 0.0f;
    for (uint32_t b = __ldg(bits + i) & live; b; b &= b - 1) {
      const int q = p + offs[__ffs(b) - 1];
      const float k = wkey[q];
      if (k > best) {
        best = k;
        bsf = wsf[q];
      }
    }
    if (g.m > 0) {
      float w = -INFINITY;
      float wsfv = -INFINITY;
      const int k1 = row_end(g.rptr, i, g.m);
      for (int e = row_begin(g.rptr, i, g.m); e < k1; ++e) {
        const int j = __ldg(g.rnbr + e);
        if (j < 0 || j >= g.np || __ldg(rg + e) == 0) continue;
        const float sfj = __ldcg(sf + j);
        const float kj = r.key(__ldcg(st + j), sfj, __ldcg(act + j),
                               __ldg(oc + j));
        if (kj > w) {
          w = kj;
          wsfv = sfj;
        } else if (kj == w && sfj > wsfv) {
          wsfv = sfj;
        }
      }
      if (w > best) {
        best = w;
        bsf = wsfv;
      }
    }
    const float st_i = __ldcg(st + i);
    const bool upd = best > st_i;
    d_st[i] = upd ? best : st_i;
    d_st[np + i] = upd ? bsf : __ldcg(sf + i);
    d_st[2 * np + i] = upd ? 1.0f : __ldcg(act + i);
    changed |= upd;
  }
  __syncthreads();  // the windows are restaged by the next item
  return changed;
}

// One smoothing work item: all F fields of cells [c0, c0 + T), one pass.
template <int F>
__device__ void smooth_item(const SmoothRule& r, const Geo& g,
                            const float* src, float* dst, int c0, float* win,
                            const int* offs) {
  const size_t np = g.np;
  const long wf = window_floats(g.T, g.H);
  const Span sp = span_of(g, c0);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float* sf = src + f * np;
    float4* w4 = reinterpret_cast<float4*>(win + f * wf);
    stage<float4, kStageBatch>(
        sp, g.np,
        [&](int j) {
          float4 v = __ldcg(reinterpret_cast<const float4*>(sf + j));
          if (r.gate != nullptr) {
            const float4 m = __ldg(reinterpret_cast<const float4*>(r.gate + j));
            v.x = m.x > 0.0f ? v.x : 0.0f;
            v.y = m.y > 0.0f ? v.y : 0.0f;
            v.z = m.z > 0.0f ? v.z : 0.0f;
            v.w = m.w > 0.0f ? v.w : 0.0f;
          }
          return v;
        },
        [&](int q, float4 v) { w4[q] = v; });
  }
  __syncthreads();
  const uint32_t live = g.bands.n < 32 ? (1u << g.bands.n) - 1u : ~0u;
  for (int i = c0 + threadIdx.x; i < sp.c1; i += blockDim.x) {
    const int p = sp.base + (i - c0);
    float s[F];
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] = 0.0f;
    for (uint32_t b = __ldg(g.bits + i) & live; b; b &= b - 1) {
      const int q = p + offs[__ffs(b) - 1];
#pragma unroll
      for (int f = 0; f < F; ++f) s[f] += win[f * wf + q];
    }
    if (g.m > 0) {
      const int k1 = row_end(g.rptr, i, g.m);
      for (int e = row_begin(g.rptr, i, g.m); e < k1; ++e) {
        const int j = __ldg(g.rnbr + e);
        if (j < 0 || j >= g.np) continue;
        if (r.gate != nullptr && !(__ldg(r.gate + j) > 0.0f)) continue;
#pragma unroll
        for (int f = 0; f < F; ++f) s[f] += __ldcg(src + f * np + j);
      }
    }
    const bool up = r.upd == nullptr || __ldg(r.upd + i) > 0.0f;
    const float ci = __ldg(r.c + i);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float fv = __ldcg(src + f * np + i);
      dst[f * np + i] = up ? (fv + s[f]) / ci : fv;
    }
  }
  __syncthreads();  // the windows are restaged by the next item
}

// Work item `it` of a sweep (items = ng * chunks, group-major). Returns
// this thread's "some cell changed". All threads of the block call it.
template <class R>
__device__ bool run_item(const RelaxArgs<R>& a, const float* src, float* dst,
                         int it, int chunks, float* win, const int* offs) {
  const int f = it / chunks;
  return relax_item(a.rule, a.geo, src, dst, f, (it - f * chunks) * a.geo.T,
                    win, offs, a.inner);
}

__device__ bool run_item(const RelaxArgs<StressRule>& a, const float* src,
                         float* dst, int it, int chunks, float* win,
                         const int* offs) {
  const int l = it / chunks;
  return stress_item(a.rule, a.geo, src, dst, l, (it - l * chunks) * a.geo.T,
                     win, offs);
}

template <int F>
struct SmoothArgs : RelaxArgs<SmoothRule> {};

template <int F>
__device__ bool run_item(const SmoothArgs<F>& a, const float* src, float* dst,
                         int it, int, float* win, const int* offs) {
  smooth_item<F>(a.rule, a.geo, src, dst, it * a.geo.T, win, offs);
  return false;
}

template <class A>
__device__ void sweep_once(const A& a, int* flag) {
  extern __shared__ __align__(16) float win[];
  __shared__ int offs[kMaxBands];
  const Geo& g = a.geo;
  for (int d = threadIdx.x; d < kMaxBands; d += blockDim.x)
    offs[d] = g.bands.off[d];
  __syncthreads();
  const int chunks = (g.np + g.T - 1) / g.T;
  or_flag(flag, run_item(a, a.in, a.out, blockIdx.x, chunks, win, offs));
}

template <class A>
__device__ void relax_loop(const A& a) {
  extern __shared__ __align__(16) float win[];
  __shared__ int offs[kMaxBands];
  __shared__ int stop;
  const Geo& g = a.geo;
  for (int d = threadIdx.x; d < kMaxBands; d += blockDim.x)
    offs[d] = g.bands.off[d];
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int chunks = (g.np + g.T - 1) / g.T;
  const int items = g.ng * chunks;
  int s = 0;
  for (;; ++s) {
    // sweep s reads buf[(s - 1) % 2] (the input at s = 0), writes buf[s % 2]
    const float* src = s == 0 ? a.in : ((s & 1) ? a.out : a.tmp);
    float* dst = (s & 1) ? a.tmp : a.out;
    bool changed = false;
    for (int it = blockIdx.x; it < items; it += gridDim.x)
      changed |= run_item(a, src, dst, it, chunks, win, offs);
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicOr(&a.ctl[s % 3], 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[(s + 1) % 3] = 0;
    grid.sync();
    if (threadIdx.x == 0) {
      const int flag = *(volatile int*)&a.ctl[s % 3];
      stop = (!a.fixed && flag == 0) || (a.cap > 0 && s + 1 >= a.cap);
    }
    __syncthreads();
    if (stop) break;
  }
  // the state ends in buf[s % 2]; bring it to `out`
  if (s & 1) {
    const size_t n = (size_t)a.planes * g.np;
    for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
         t += (size_t)gridDim.x * blockDim.x)
      a.out[t] = __ldcg(a.tmp + t);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctl[3] = s + 1;
    if (a.total != nullptr) atomicAdd(a.total, s + 1);
  }
}

__global__ void __launch_bounds__(kRelaxThreads)
bfs_sweep_kernel(RelaxArgs<BfsRule> a, int* flag) { sweep_once(a, flag); }

__global__ void __launch_bounds__(kRelaxThreads)
bfs_relax_kernel(RelaxArgs<BfsRule> a) { relax_loop(a); }

__global__ void __launch_bounds__(kRelaxThreads)
flood_relax_kernel(RelaxArgs<FloodRule> a) { relax_loop(a); }

__global__ void __launch_bounds__(kRelaxThreads)
stress_relax_kernel(RelaxArgs<StressRule> a) { relax_loop(a); }

template <int F>
__global__ void __launch_bounds__(kRelaxThreads)
smooth_relax_kernel(SmoothArgs<F> a) { relax_loop(a); }

// ── 6. Rain-shadow hop ─────────────────────────────────────────────────
// Replaces _make_shadow_kernel (sweep_pallas.py:619); the jnp semantics of
// climate/precipitation.py _rain_shadow2_jnp, one hop per launch. One
// thread per cell carries all four columns of the state
//   {shadow, windward} x {summer, winter}  (signs -1, -1, +1, +1).
// aux planes: 0-2 position, 3-5 summer wind, 6-8 winter wind (xyz). For a
// neighbour j of a LAND cell i, with d = p_j - p_i:
//   up  weight (shadow columns)   = w_j . (-d)   (wind at j toward i),
//   down weight (windward columns) = w_i . d      (wind at i toward j),
// each dot summed x, y, z in that order, as the jnp einsum. A neighbour
// counts for column c when its weight is > 0 and v_j * sign_c > 0; then
//   wsum += w, wacc += w * v_j      (bands in order, then the remainder);
//   carried = wacc / max(wsum, 1e-20) * retain_c,
//   out = min(v_i, carried) for shadow, max(v_i, carried) for windward,
// and cells with wsum == 0 (and every non-land cell) keep their value. The
// per-column hop cap is the Python loop's. The weights are recomputed per band
// from the position and wind planes instead of being read from a
// materialized [D, 4, NP] stack (the jnp path at <= 400K cells): 9 aux
// planes against 128. Bound: bytes — state, aux, land, bits and the CSR
// read once, the state written once: 19 planes, ~16 MB at 204K, ~5 us at
// 3.35 TB/s (about 40 flops per edge stay far below the f32 rate).
__global__ void __launch_bounds__(kThreads)
shadow_sweep_kernel(const float* __restrict__ s, const float* __restrict__ aux,
                    const float* __restrict__ land,
                    const uint32_t* __restrict__ bits,
                    const int* __restrict__ rptr, const int* __restrict__ rnbr,
                    int m, float* __restrict__ out, int np, Bands bands,
                    float retain_s, float retain_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  float v[4];
  for (int c = 0; c < 4; ++c) v[c] = s[(size_t)c * np + i];
  if (!(land[i] > 0.0f)) {
    for (int c = 0; c < 4; ++c) out[(size_t)c * np + i] = v[c];
    return;
  }
  const float* px = aux;
  const float* py = aux + (size_t)np;
  const float* pz = aux + 2 * (size_t)np;
  const float* sx = aux + 3 * (size_t)np;
  const float* sy = aux + 4 * (size_t)np;
  const float* sz = aux + 5 * (size_t)np;
  const float* wx = aux + 6 * (size_t)np;
  const float* wy = aux + 7 * (size_t)np;
  const float* wz = aux + 8 * (size_t)np;
  const float pix = px[i], piy = py[i], piz = pz[i];
  const float six = sx[i], siy = sy[i], siz = sz[i];
  const float wix = wx[i], wiy = wy[i], wiz = wz[i];
  const float sgn[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
  float wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float wacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  auto visit = [&](int j) {
    const float dx = px[j] - pix, dy = py[j] - piy, dz = pz[j] - piz;
    const float nx = -dx, ny = -dy, nz = -dz;
    float w[4];
    w[0] = sx[j] * nx + sy[j] * ny + sz[j] * nz;
    w[1] = wx[j] * nx + wy[j] * ny + wz[j] * nz;
    w[2] = six * dx + siy * dy + siz * dz;
    w[3] = wix * dx + wiy * dy + wiz * dz;
    for (int c = 0; c < 4; ++c) {
      const float vj = s[(size_t)c * np + j];
      if (w[c] > 0.0f && vj * sgn[c] > 0.0f) {
        wsum[c] += w[c];
        wacc[c] += w[c] * vj;
      }
    }
  };

  const uint32_t b = bits[i];
  for (int d = 0; d < bands.n; ++d) {
    if ((b >> d) & 1u) visit(wrap(i + bands.off[d], np));
  }
  const int k1 = row_end(rptr, i, m);
  for (int k = row_begin(rptr, i, m); k < k1; ++k) {
    const int j = rnbr[k];
    if (j >= 0 && j < np) visit(j);
  }
  for (int c = 0; c < 4; ++c) {
    float o = v[c];
    if (wsum[c] > 0.0f) {
      const float carried = wacc[c] / fmaxf(wsum[c], 1e-20f)
                            * (c < 2 ? retain_s : retain_w);
      o = c < 2 ? fminf(v[c], carried) : fmaxf(v[c], carried);
    }
    out[(size_t)c * np + i] = o;
  }
}

Bands make_bands(const int* offs, int n_offs) {
  Bands b;
  b.n = n_offs;
  for (int d = 0; d < kMaxBands; ++d) b.off[d] = d < n_offs ? offs[d] : 0;
  return b;
}

int blocks_for(long total) { return (int)((total + kThreads - 1) / kThreads); }

// The largest dynamic shared memory a block may take (227 KB), less room
// for the static shared words.
constexpr long kMaxWindowFloats = (232448 - 1024) / (long)sizeof(float);

Geo make_geo(const uint32_t* bits, const int* rptr, const int* rnbr, int m,
             int np, int ng, int nw, const int* offs, int n_offs) {
  Geo g;
  g.np = np;
  g.ng = ng;
  g.nw = nw;
  g.T = 0;
  g.H = 0;
  g.m = (rptr != nullptr && rnbr != nullptr && m > 0) ? m : 0;
  g.bits = bits;
  g.rptr = rptr;
  g.rnbr = rnbr;
  g.bands = make_bands(offs, n_offs);
  return g;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The staged planes load as float4 words: NP % 4 == 0, 16-byte aligned.
bool staged_ok(int np, std::initializer_list<const void*> planes) {
  if (np % 4 != 0) return false;
  for (const void* p : planes)
    if (!aligned16(p)) return false;
  return true;
}

bool bad_shape(int np, int nf, int n_offs) {
  return np < 1 || nf < 1 || n_offs < 0 || n_offs > kMaxBands;
}

// A staged kernel's launch plan: window half-width H = max |off|, chunk
// size T, the windows' bytes of dynamic shared memory and the grid. Plans
// are cached per kernel, device, NP, item groups, windows per item and H
// (everything that sets T and the grid), so the SM-count, shared-memory-
// attribute and occupancy calls run once per shape, not on each of the
// components loop's one-sweep launches.
struct Plan {
  const void* kern;
  int dev, np, ng, nw, H;
  int T, grid;
  long smem;
};
constexpr int kPlanSlots = 32;
Plan g_plans[kPlanSlots];
int g_plan_count = 0;
std::mutex g_plan_mu;

// T: kItemsPerSm work items per SM, a multiple of the block size, no
// larger than the mesh or than what shared memory holds: nw windows of
// T + 2H floats plus the float4 alignment slack. Grid: one block per item,
// or for a cooperative launch the co-resident blocks (no more than there
// are items).
int get_plan(const void* kern, bool cooperative, const Geo& g, Plan* out) {
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  int h = 0;
  for (int d = 0; d < g.bands.n; ++d) h = std::max(h, std::abs(g.bands.off[d]));
  std::lock_guard<std::mutex> lock(g_plan_mu);
  for (int k = 0; k < std::min(g_plan_count, kPlanSlots); ++k) {
    const Plan& p = g_plans[k];
    if (p.kern == kern && p.dev == dev && p.np == g.np && p.ng == g.ng &&
        p.nw == g.nw && p.H == h) {
      *out = p;
      return 0;
    }
  }
  int nsm = 0;
  e = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  const int threads = kRelaxThreads;
  const long per = kItemsPerSm * nsm;
  long t = ((long)g.ng * g.np + per - 1) / per;
  t = (t + threads - 1) / threads * threads;
  t = std::max(t, (long)threads);
  t = std::min(t, ((long)g.np + threads - 1) / threads * threads);
  t = std::min(t, kMaxWindowFloats / g.nw - 2L * h - 11);
  if (t < 1) return (int)cudaErrorInvalidValue;
  Plan p{kern, dev, g.np, g.ng, g.nw, h, (int)t, 0,
         g.nw * window_floats(t, h) * (long)sizeof(float)};
  // the most any plan takes, so that no plan's limit shrinks another's
  e = (int)cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)(kMaxWindowFloats * sizeof(float)));
  if (e != 0) return e;
  const long items = (long)g.ng * ((g.np + p.T - 1) / p.T);
  if (cooperative) {
    int per_sm = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kRelaxThreads, p.smem);
    if (e != 0) return e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    p.grid = (int)std::min((long)per_sm * nsm, items);
  } else {
    p.grid = (int)items;
  }
  g_plans[g_plan_count++ % kPlanSlots] = p;
  *out = p;
  return 0;
}

// One sweep: one block per work item, a normal launch.
template <class A>
int launch_once(void (*kern)(A, int*), A a, int* flag, cudaStream_t stream) {
  Plan p;
  const int e = get_plan((const void*)kern, false, a.geo, &p);
  if (e != 0) return e;
  a.geo.T = p.T;
  a.geo.H = p.H;
  kern<<<p.grid, kRelaxThreads, p.smem, stream>>>(a, flag);
  return (int)cudaGetLastError();
}

// The whole relax loop in one cooperative launch. A refused launch
// returns its error; it never runs.
template <class A>
int launch_relax(void (*kern)(A), A a, cudaStream_t stream) {
  Plan p;
  int e = get_plan((const void*)kern, true, a.geo, &p);
  if (e != 0) return e;
  a.geo.T = p.T;
  a.geo.H = p.H;
  void* args[] = {&a};
  e = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(p.grid),
                                       dim3(kRelaxThreads), args,
                                       (size_t)p.smem, stream);
  if (e != 0) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}

template <int F>
int launch_smooth(RelaxArgs<SmoothRule> a, cudaStream_t stream) {
  SmoothArgs<F> s;
  static_cast<RelaxArgs<SmoothRule>&>(s) = a;
  return launch_relax(smooth_relax_kernel<F>, s, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// right after its launch; 0 means the launch was accepted. The relax
// entries take ctl: int32 [4] zeroed by the caller (flag slots, then the
// sweep count), and total: an int32 counter the sweep count is added to,
// or null.
extern "C" {

int bfs_sweep(const float* cur, const float* cost, const uint32_t* bits,
              float* out, int* flag, int np, int nf, const int* offs,
              int n_offs, void* stream) {
  if (bad_shape(np, nf, n_offs) || !staged_ok(np, {cur, out}))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<BfsRule> a{};
  a.rule.cost = cost;
  a.geo = make_geo(bits, nullptr, nullptr, 0, np, nf, 1, offs, n_offs);
  a.in = cur;
  a.out = out;
  a.inner = 1;
  a.planes = nf;
  return launch_once(bfs_sweep_kernel, a, flag, (cudaStream_t)stream);
}

int bfs_relax(const float* cur, const float* cost, const uint32_t* bits,
              const int* rem_ptr, const int* rem_nbr, int m, float* out,
              float* tmp, int* ctl, int* total, int np, int nf,
              const int* offs, int n_offs, int cap, void* stream) {
  if (bad_shape(np, nf, n_offs) || !staged_ok(np, {cur, out, tmp}))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<BfsRule> a{};
  a.rule.cost = cost;
  a.geo = make_geo(bits, rem_ptr, rem_nbr, m, np, nf, 1, offs, n_offs);
  a.in = cur;
  a.out = out;
  a.tmp = tmp;
  a.ctl = ctl;
  a.total = total;
  a.cap = cap;
  a.inner = 1;
  a.planes = nf;
  return launch_relax(bfs_relax_kernel, a, (cudaStream_t)stream);
}

// state: [G, 3, NP] (st, sf, act per layer); ocean [G, NP]; bits [G, NP];
// rgate [G, M] in CSR order (nonzero = gated).
int stress_relax(const float* state, const float* ocean,
                 const uint32_t* bits, const int* rem_ptr,
                 const int* rem_nbr, const uint8_t* rgate, int m, float* out,
                 float* tmp, int* ctl, int* total, int np, int ng,
                 const int* offs, int n_offs, float decay, float sub_decay,
                 int cap, void* stream) {
  if (bad_shape(np, ng, n_offs) || !staged_ok(np, {state, ocean, out, tmp}))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<StressRule> a{};
  a.rule = StressRule{ocean, bits, rgate, decay, sub_decay};
  a.geo = make_geo(nullptr, rem_ptr, rem_nbr, m, np, ng, 2, offs, n_offs);
  a.in = state;
  a.out = out;
  a.tmp = tmp;
  a.ctl = ctl;
  a.total = total;
  a.cap = cap;
  a.inner = 1;
  a.planes = 3 * ng;
  return launch_relax(stress_relax_kernel, a, (cudaStream_t)stream);
}

int warp_sweep(const float* state, const float* w, const uint32_t* bits,
               float* out, int* flag, int np, const int* offs, int n_offs,
               void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  warp_sweep_kernel<<<blocks_for(np), kThreads, 0, (cudaStream_t)stream>>>(
      state, w, bits, out, flag, np, make_bands(offs, n_offs));
  return (int)cudaGetLastError();
}

int flood_relax(const float* surf, const float* inland,
                const float* elev_baked, const uint32_t* bits,
                const int* rem_ptr, const int* rem_nbr, int m, float* out,
                float* tmp, int* ctl, int* total, int np, const int* offs,
                int n_offs, float big, float eps, int inner, void* stream) {
  if (bad_shape(np, 1, n_offs) || inner < 1 ||
      !staged_ok(np, {surf, inland, out, tmp}))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<FloodRule> a{};
  a.rule = FloodRule{inland, elev_baked, big, eps};
  a.geo = make_geo(bits, rem_ptr, rem_nbr, m, np, 1, 1, offs, n_offs);
  a.in = surf;
  a.out = out;
  a.tmp = tmp;
  a.ctl = ctl;
  a.total = total;
  a.inner = inner;
  a.planes = 1;
  return launch_relax(flood_relax_kernel, a, (cudaStream_t)stream);
}

// field [F, NP], 1 <= F <= kMaxSmoothFields; c, gate, upd [NP] (gate and
// upd may be null); exactly `passes` >= 1 passes.
int smooth_relax(const float* field, const float* c, const float* gate,
                 const float* upd, const uint32_t* bits, const int* rem_ptr,
                 const int* rem_nbr, int m, float* out, float* tmp, int* ctl,
                 int np, int nf, const int* offs, int n_offs, int passes,
                 void* stream) {
  if (bad_shape(np, nf, n_offs) || nf > kMaxSmoothFields || passes < 1 ||
      !staged_ok(np, {field, out, tmp}) || (gate && !aligned16(gate)))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<SmoothRule> a{};
  a.rule = SmoothRule{c, gate, upd};
  a.geo = make_geo(bits, rem_ptr, rem_nbr, m, np, 1, nf, offs, n_offs);
  a.in = field;
  a.out = out;
  a.tmp = tmp;
  a.ctl = ctl;
  a.cap = passes;
  a.inner = 1;
  a.planes = nf;
  a.fixed = true;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nf) {
    case 1: return launch_smooth<1>(a, s);
    case 2: return launch_smooth<2>(a, s);
    case 3: return launch_smooth<3>(a, s);
    default: return launch_smooth<4>(a, s);
  }
}

int shadow_sweep(const float* state, const float* aux, const float* land,
                 const uint32_t* bits, const int* rem_ptr, const int* rem_nbr,
                 int m, float* out, int np, const int* offs, int n_offs,
                 float retain_s, float retain_w, void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  shadow_sweep_kernel<<<blocks_for(np), kThreads, 0, (cudaStream_t)stream>>>(
      state, aux, land, bits, rem_ptr, rem_nbr, m, out, np,
      make_bands(offs, n_offs), retain_s, retain_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
