// Banded neighbour-sweep kernels for Hopper (sm_90a).
//
// The mesh's adjacency is "banded" (mesh/build.py): neighbour j of cell i
// sits at j = i + off[d] for one of D <= 32 signed offsets, and bit d of
// bits[i] says whether that band edge exists. The few remainder edges
// outside the bands (~0.5 % of edges) come as CSR rows of their receiving
// cell, in edge order (ops/banded.py rem_csr).
//
// Every loop runs in ONE cooperative launch ("Staged-window relax"
// below): the BFS, ε-fill, stress, smoothing, terrain warp and rain-shadow
// relax kernels sweep after sweep, with a grid barrier between sweeps, the
// remainder edges in-kernel and the sweep count written to device memory;
// the components kernel runs whole steps of the components loop (a gated
// min-label sweep, hooking and two pointer jumps, a barrier between
// phases). The fixpoint loops (BFS, ε-fill, stress, warp, components) keep
// a device-side change flag; smoothing and the rain shadow run their fixed
// number of passes / hops. The host issues one launch and reads nothing
// back.
//
// Besides the sweeps, the pointer-doubling accumulate (near the end of
// the file): one cooperative launch runs a whole S <- S + scatter_add(S
// along P), P <- P[P] loop, each target's float adds in source order (the
// CPU index_add's bits) with no sort and no host sync. Last, the erosion
// loop's one-pass stencils (the thermal step's two passes, the ice flow's
// argmin and the glacial step's neighbour pass): an ordinary launch, one
// thread a cell.
//
// What bounds these kernels on an H100: memory traffic, never arithmetic
// for a single sweep. The least a sweep must move is its state and
// auxiliary planes read once, the packed u32 band bits read once and the
// state written once: at 204K cells ~10 MB for the 4-field BFS, ~3 us at
// 3.35 TB/s. Reading band neighbours straight from L2 costs a warp a
// band's load whenever any of its 32 lanes has that bit, up to D
// neighbour lines per field where a cell needs ~6; so every kernel loads
// each chunk's band window into shared memory with coalesced loads instead
// (PERF.md has the measured times).
//
// Reads off the mesh: a set band bit always points inside [0, NP), but
// indices are still wrapped modulo NP (jnp.roll semantics) so no thread
// can read out of bounds; CSR rows are clamped to [0, M] and columns
// outside [0, NP) skipped.
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
// Staged-window kernels: one 1024-thread block per SM, one work item each
// per sweep. Of the block shapes timed on an H100 while this kernel was
// brought up (256 to 1024 threads, 1 to 8 items per SM), the fewest and
// largest blocks ran fastest: the cheapest grid barrier and the longest
// chunks, so the halo is staged least often.
constexpr int kRelaxThreads = 1024;
constexpr long kItemsPerSm = 1;
// The most fields one smoothing launch carries (one staged window each).
constexpr int kMaxSmoothFields = 4;
// Neighbour loads a warp or rain-shadow thread keeps in flight at once.
constexpr int kWarpBatch = 2;
constexpr int kShadowBatch = 2;

struct Bands {
  int n;
  int off[kMaxBands];
};

__device__ __forceinline__ int wrap(int j, int np) {
  return j < 0 ? j + np : (j >= np ? j - np : j);
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

// ── Staged-window relax: all six kernels ──────────────────────────────
// Replace _make_bfs_kernel (sweep_pallas.py:171), _make_stress_kernel
// (:388), _make_flood_kernel (:230), _make_warp_kernel (:480),
// _make_smooth_kernel (:564) and _make_shadow_kernel (:619). One loop
// template, six rules:
//   BFS       out = min(cur, min_{nbr j} cur[f, j] + cost[f, i])
//   ε-fill    out = min(surf, max(elev_baked, min_{nbr j} surf'[j] + eps)),
//             surf'[j] = big at inland cells
//   stress    gated argmax of the neighbours' propagated stress, with the
//             sender's subduct factor as payload (StressRule below)
//   smoothing out = (f[i] + sum_{gated nbr j} f[j]) / c[i] (SmoothRule)
//   warp      nearest-candidate pick, then the remainder edges' two-phase
//             pick (WarpRule)
//   shadow    wind-weighted signed min / max hop with retention, per-column
//             hop caps (ShadowRule)
// Seeds, barriers and frozen cells are baked into cost / elev_baked. With
// cell-index labels and no cost the min-label rule (LabelRule) is the
// sweep of a connected-components step. The remainder edges fold into the same
// min before cost or eps is added: f32 addition rounds monotonically, so
// min(a + c, b + c) == min(a, b) + c bit for bit, and the result equals the
// kernel-then-torch-scatter step it replaces.
//
// Inside a sweep, work items are (group, chunk of T consecutive cells): a
// group is a field (BFS), the surface (ε-fill), a stress layer, or all the
// planes of a smoothing call, a warp or a rain-shadow state. A block
// stages the chunk's band window [c0 - H, c0 + T + H) of each plane the
// rule reads at neighbours into shared memory as coalesced, aligned float4
// loads (H = max |off|, read from the offsets; nw windows an item: one for
// BFS and ε-fill, two for stress, one per field for smoothing, three
// candidate coordinates for warp; the rain shadow, whose changing cells are
// the land minority, stages none and keeps its land-cell list in one
// window's space), then each thread walks the set
// bits of its cell and reads those band neighbours from the windows: a
// cell costs (T + 2H) / T global words per window instead of up to 32 line
// loads per warp. T is chosen at launch for the windows an item holds (one
// 1024-thread block per SM, one item each: at 204K cells T = 7168 for the
// 4-field BFS, 2048 for one field, with H = 1597; warp and the rain shadow
// round T to 4 cells, not to the block, so that all 132 SMs get an item:
// T = 1552). On an H100 a BFS sweep takes a few times its byte bound and
// is not held by L2 latency: several loads in flight per thread did not
// help, nor did a warp-uniform band walk (conflict-free reads, but a
// warp's 32 cells use nearly all 32 bands); in the relax kernel the grid
// barrier and the flag add ~4.6 us a sweep (PERF.md has the numbers). Warp and the rain shadow, whose remainder and land
// work is L2 gathers, keep two neighbours' loads in flight per thread.
//
// The relax kernel runs the whole loop in one cooperative launch (grid =
// co-resident blocks, cudaLaunchCooperativeKernel): sweep s reads only what
// sweep s-1 wrote (two buffers in turn; sweep 0 reads the input), and a
// grid barrier separates sweeps. The change flag rotates over three int32
// slots: slot s % 3 is ORed in sweep s and read by every block after the
// barrier, slot (s + 1) % 3 is zeroed by block 0 before it, so no block
// reads a slot that another is resetting, and every block takes the same
// exit decision. A fixpoint loop stops at the first sweep that changes
// nothing or after `cap` sweeps (0 = no cap); smoothing and the rain
// shadow (`fixed`) run exactly `cap` passes. The sweep count goes to
// ctl[3]. Buffers written by
// other blocks are read with __ldcg (L2, not the incoherent L1 or
// read-only path).
//
// All but the ε-fill run one Jacobi sweep per barrier: the BFS and stress
// loops on the path end at their caps, where any more relaxation per round
// would give other values than the jnp loop (and stress's payload ties
// leave no unique fixpoint to reach by another schedule); a smoothing pass
// is one term of a fixed sum, a rain-shadow hop one step of a walk whose
// length is part of the result, and the warp loop's cap sets how far a
// candidate travels. The ε-fill may run `inner` sweeps per
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
  int tstep;  // T rounds up to a multiple of it, unless the window cap binds
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
  __device__ bool hidden(int) const { return false; }
};

// The components loop's min-label sweep: out = min(cur, min_{nbr j} cur[j])
// over the gated band bits and the gated remainder rows (BfsRule at zero
// cost, without a cost plane to read).
struct LabelRule {
  __device__ float stage(const float* sf, int j) const { return __ldcg(sf + j); }
  __device__ float4 stage4(const float* sf, int j) const {
    return __ldcg(reinterpret_cast<const float4*>(sf + j));
  }
  __device__ float own(float w, const float*, int) const { return w; }
  __device__ float aux(size_t, int) const { return 0.0f; }
  __device__ float update(float c, float best, float) const {
    return fminf(c, best);
  }
  __device__ float restage(float v, int) const { return v; }
  __device__ bool hidden(int) const { return false; }
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
  // inland cells show `big` in the window (hidden): their own value is
  // the round's input
  __device__ float own(float w, const float* sf, int i) const {
    const float v = __ldcg(sf + i);
    return __ldg(inland + i) > 0.0f ? v : w;
  }
  __device__ bool hidden(int i) const { return __ldg(inland + i) > 0.0f; }
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

// Terrain warp, the port's synchronous sweep of erosion/warp.py (the
// nearest-candidate search of _warp_terrain_jnp, without its band-
// sequential update). State planes [4, NP]: each cell's candidate source
// index (f32) and that candidate's position xyz; w [3, NP] is the cell's
// warped target. One sweep:
//   band phase       new_i = of the cell's own candidate and its band
//                    neighbours' (band order), the first strictly nearest
//                    to w_i;
//   remainder phase  over the cell's remainder row (any order: a min and
//                    maxima), wmin = the least dist2(new_j, w_i) and, among
//                    the edges at wmin with a finite distance, the largest
//                    value of each of the 4 planes SEPARATELY (the torch
//                    step's four amax scatters); the cell takes that pick
//                    where wmin < dist2(new_i, w_i).
// dist2 sums x, y, z in that order (--fmad=false rounds as torch does).
// The change flag: an index changed in the band phase, or a cell took a
// remainder pick. The remainder phase reads new_j, which another block
// writes in the same sweep: rather than a second grid barrier, the block
// recomputes each remainder neighbour's band phase from the pre-sweep
// buffer (its band walk, through L2), ~5K edges at 204K cells, one thread
// an edge (warp_item). The windows hold the candidates' x, y, z; the index
// is read only where a cell adopts a band neighbour's candidate. Bound:
// bytes per sweep (state and targets read, state written); ~9 flops per
// edge.
struct WarpRule {
  const float* w;  // [3, NP]
  float4* rcand;   // [M]: each remainder edge's neighbour candidate
};

// Rain shadow, the jnp semantics of climate/precipitation.py
// _rain_shadow2_jnp: every hop of one call. State [4, NP]: the columns
// {shadow, windward} x {summer, winter}; aux [9, NP]: position, summer
// wind, winter wind (xyz each). For a neighbour j of a LAND cell i, with
// d = p_j - p_i:
//   up   weight (shadow columns)   = w_j . (-d)   (wind at j toward i),
//   down weight (windward columns) = w_i . d      (wind at i toward j),
// each dot summed x, y, z in that order, as the jnp einsum. A neighbour
// counts for a shadow column when its weight is > 0 and v_j < 0, for a
// windward column when its weight is > 0 and v_j > 0; then
//   wsum += w, wacc += w * v_j     (bands in order, then the remainder row);
//   carried = wacc / max(wsum, 1e-20) * retain_c,
//   out = min(v_i, carried) for shadow, max(v_i, carried) for windward,
// and cells with wsum == 0 (and every non-land cell) keep their value.
// Hop s updates the shadow columns while s < shadow_hops and the windward
// columns while s < windward_hops; a frozen column keeps its value (the
// Python loop's per-column torch.where). The state is not staged
// (shadow_item says why).
// The four weights of an edge depend on position and wind only: hop 0
// computes them from aux and stores them, slot-major ([slots, NP] float4:
// slot k of a cell is its k-th edge, bands in order, then the row), and
// later hops read them back in place of 9 gathered aux values; a cell with
// more edges than slots (none on these meshes: the degree is at most 8)
// recomputes its weights every hop, by the same expressions, so the same
// bits.
// Bound: bytes per hop (state, aux, land, bits and the CSR read once, the
// state written once); ~23 flops per land edge once (the weights), then
// ~3 per land edge and ~2 per land cell for each column a hop updates.
struct ShadowRule {
  const float* aux;   // [9, NP]
  const float* land;  // [NP]
  int* lands;         // [NP + 1]: the land cells as hop 0 lists them, then
                      // their count (zeroed by the caller)
  float4* wts;        // [slots, NP]
  int slots;
  float retain_s, retain_w;
  int shadow_hops, windward_hops;
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
      if (inner == 1 || r.hidden(i)) {
        // a hidden cell (the ε-fill's inland cells: the window shows `big`)
        // updates as the plain sweep does, from the round's input; best
        // only falls within a round, so its last v is its least
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
      if (!r.hidden(i)) df[i] = win[sp.base + (i - c0)];
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

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return dx * dx + dy * dy + dz * dz;
}

// The band phase of warp cell i from the pre-sweep state in global memory,
// as (index, x, y, z): a remainder neighbour's candidate for this sweep.
// The band neighbours load kWarpBatch at a time and compare in band order.
__device__ float4 warp_band_global(const WarpRule& r, const Geo& g,
                                   const float* src, int i, const int* offs,
                                   uint32_t live) {
  const size_t np = g.np;
  const float tx = __ldg(r.w + i), ty = __ldg(r.w + np + i),
              tz = __ldg(r.w + 2 * np + i);
  uint32_t b = __ldg(g.bits + i) & live;
  int jb = i;
  float x = __ldcg(src + np + i), y = __ldcg(src + 2 * np + i),
        z = __ldcg(src + 3 * np + i);
  float best = dist2(x - tx, y - ty, z - tz);
  while (b) {
    int jj[kWarpBatch];
    float xs[kWarpBatch], ys[kWarpBatch], zs[kWarpBatch];
#pragma unroll
    for (int u = 0; u < kWarpBatch; ++u) {
      jj[u] = -1;
      if (b) {
        jj[u] = wrap(i + offs[__ffs(b) - 1], g.np);
        b &= b - 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kWarpBatch; ++u) {
      if (jj[u] < 0) continue;
      xs[u] = __ldcg(src + np + jj[u]);
      ys[u] = __ldcg(src + 2 * np + jj[u]);
      zs[u] = __ldcg(src + 3 * np + jj[u]);
    }
#pragma unroll
    for (int u = 0; u < kWarpBatch; ++u) {
      if (jj[u] < 0) continue;
      const float cd = dist2(xs[u] - tx, ys[u] - ty, zs[u] - tz);
      if (cd < best) {
        best = cd;
        x = xs[u];
        y = ys[u];
        z = zs[u];
        jb = jj[u];
      }
    }
  }
  return make_float4(__ldcg(src + jb), x, y, z);
}

// One warp work item: cells [c0, c0 + T), one sweep, in three phases.
// B: the block's threads share out the remainder edges of the chunk's
//    rows (contiguous in the CSR) and recompute each edge's neighbour
//    candidate into rcand[e], each a few L2 round trips at once, rather
//    than one thread walking a row edge after edge; B reads only the
//    pre-sweep state, so it runs while the windows stage.
// A: the band phase of every cell from the staged windows, written to dst.
// C: each cell with a row picks from rcand and patches its dst entry.
__device__ bool warp_item(const WarpRule& r, const Geo& g, const float* src,
                          float* dst, int c0, float* win, const int* offs) {
  const size_t np = g.np;
  const long wf = window_floats(g.T, g.H);
  const Span sp = span_of(g, c0);
  const uint32_t live = g.bands.n < 32 ? (1u << g.bands.n) - 1u : ~0u;
  if (g.m > 0) {  // B; an edge off the mesh gets a candidate at +inf
    const int e0 = row_begin(g.rptr, c0, g.m);
    const int e1 = row_begin(g.rptr, sp.c1, g.m);
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      const int j = __ldg(g.rnbr + e);
      r.rcand[e] = j >= 0 && j < g.np
                       ? warp_band_global(r, g, src, j, offs, live)
                       : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    }
  }
  for (int c = 0; c < 3; ++c) {
    const float* sc = src + (c + 1) * np;
    float4* w4 = reinterpret_cast<float4*>(win + c * wf);
    stage<float4, kStageBatch>(
        sp, g.np,
        [&](int j) { return __ldcg(reinterpret_cast<const float4*>(sc + j)); },
        [&](int q, float4 v) { w4[q] = v; });
  }
  __syncthreads();  // the windows and rcand are complete
  const float* wx = win;
  const float* wy = win + wf;
  const float* wz = win + 2 * wf;
  bool changed = false;
  for (int i = c0 + threadIdx.x; i < sp.c1; i += blockDim.x) {
    const int p = sp.base + (i - c0);
    const float tx = __ldg(r.w + i), ty = __ldg(r.w + np + i),
                tz = __ldg(r.w + 2 * np + i);
    float best = dist2(wx[p] - tx, wy[p] - ty, wz[p] - tz);
    int q = p;
    for (uint32_t b = __ldg(g.bits + i) & live; b; b &= b - 1) {
      const int qb = p + offs[__ffs(b) - 1];
      const float cd = dist2(wx[qb] - tx, wy[qb] - ty, wz[qb] - tz);
      if (cd < best) {
        best = cd;
        q = qb;
      }
    }
    const float own = __ldcg(src + i);
    float idx = own;
    if (q != p) {
      idx = __ldcg(src + wrap(i + (q - p), g.np));
      changed |= idx != own;
    }
    dst[i] = idx;
    dst[np + i] = wx[q];
    dst[2 * np + i] = wy[q];
    dst[3 * np + i] = wz[q];
  }
  if (g.m == 0) {
    __syncthreads();  // the windows are restaged by the next item
    return changed;
  }
  for (int i = c0 + threadIdx.x; i < sp.c1; i += blockDim.x) {
    int e = row_begin(g.rptr, i, g.m);
    const int k1 = row_end(g.rptr, i, g.m);
    if (e >= k1) continue;
    // min over the row (NaN-propagating, as torch.minimum), and the
    // per-plane maxima of the candidates at the running min: those at
    // the final min are the winners
    const float tx = __ldg(r.w + i), ty = __ldg(r.w + np + i),
                tz = __ldg(r.w + 2 * np + i);
    const float best = dist2(dst[np + i] - tx, dst[2 * np + i] - ty,
                             dst[3 * np + i] - tz);
    float wmin = INFINITY;
    float4 pk = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll 4
    for (; e < k1; ++e) {
      const float4 c = __ldcg(r.rcand + e);
      const float cd = dist2(c.y - tx, c.z - ty, c.w - tz);
      if (cd < wmin || cd != cd) {
        wmin = cd;
        pk = c;
      } else if (cd == wmin && isfinite(cd)) {
        pk.x = c.x > pk.x ? c.x : pk.x;
        pk.y = c.y > pk.y ? c.y : pk.y;
        pk.z = c.z > pk.z ? c.z : pk.z;
        pk.w = c.w > pk.w ? c.w : pk.w;
      }
    }
    if (wmin < best) {
      dst[i] = pk.x;
      dst[np + i] = pk.y;
      dst[2 * np + i] = pk.z;
      dst[3 * np + i] = pk.w;
      changed = true;
    }
  }
  __syncthreads();  // the windows are restaged by the next item
  return changed;
}

// A land cell's own position and winds, for the rain-shadow weights.
struct ShadowOwn {
  float px, py, pz, sx, sy, sz, wx, wy, wz;
};

// The four weights of the edge from neighbour j to the cell `o`.
__device__ __forceinline__ float4 shadow_weights(const float* aux, size_t np,
                                                 const ShadowOwn& o, int j) {
  const float dx = __ldg(aux + j) - o.px, dy = __ldg(aux + np + j) - o.py,
              dz = __ldg(aux + 2 * np + j) - o.pz;
  const float nx = -dx, ny = -dy, nz = -dz;
  float4 w;
  w.x = __ldg(aux + 3 * np + j) * nx + __ldg(aux + 4 * np + j) * ny +
        __ldg(aux + 5 * np + j) * nz;
  w.y = __ldg(aux + 6 * np + j) * nx + __ldg(aux + 7 * np + j) * ny +
        __ldg(aux + 8 * np + j) * nz;
  w.z = o.sx * dx + o.sy * dy + o.sz * dz;
  w.w = o.wx * dx + o.wy * dy + o.wz * dz;
  return w;
}

__device__ __forceinline__ void shadow_add(float w, float v, bool counts,
                                           float& wsum, float& wacc) {
  if (counts && w > 0.0f) {
    wsum += w;
    wacc += w * v;
  }
}

// One rain-shadow work item `it` of `items`, hop s. Only land cells
// change, and land is clustered, so chunks hold very different numbers of
// them: on hop 0 the block lists its chunk's land cells in cell order (in
// the window's space), appends them to the global list r.lands (one
// atomicAdd for the block) and relaxes them; from hop 1 on, item `it`
// takes the it-th equal share of that list, one cell to a thread. The
// other cells are copied on hops 0 and 1 (into both buffers) and on the
// last. Between the first and the last hop the buffers hold the state
// cell-major ([NP] float4: the 4 columns of a cell together), so a
// neighbour is one 16-byte load through L2 (the land cells are a
// minority, and staged windows read at random band offsets cost more than
// they saved); hop 0 reads the [4, NP] input and the last hop writes
// [4, NP]. A land cell takes its edges (slot k: the k-th set band bit,
// then the k-th entry of its row) kShadowBatch at a time: their columns
// and weights all load before any is added, in slot order. The stored
// weights of slot k of the t-th listed cell sit at [k, t], so a warp's
// loads are contiguous.
__device__ __forceinline__ float4 load_cols(const float* buf, size_t np,
                                            int i, bool planar) {
  if (planar)
    return make_float4(__ldcg(buf + i), __ldcg(buf + np + i),
                       __ldcg(buf + 2 * np + i), __ldcg(buf + 3 * np + i));
  return __ldcg(reinterpret_cast<const float4*>(buf) + i);
}

__device__ __forceinline__ void store_cols(float* buf, size_t np, int i,
                                           bool planar, const float4& v) {
  if (planar) {
    buf[i] = v.x;
    buf[np + i] = v.y;
    buf[2 * np + i] = v.z;
    buf[3 * np + i] = v.w;
  } else {
    reinterpret_cast<float4*>(buf)[i] = v;
  }
}

__device__ void shadow_item(const ShadowRule& r, const Geo& g,
                            const float* src, float* dst, int it, int items,
                            float* win, const int* offs, int s) {
  const size_t np = g.np;
  const int c0 = it * g.T, c1 = min(c0 + g.T, g.np);
  const int hops = max(r.shadow_hops, r.windward_hops);
  const bool in_planar = s == 0, out_planar = s == hops - 1;
  int* chunk_lands = reinterpret_cast<int*>(win);
  int* count = r.lands + np;
  __shared__ int wcount[kRelaxThreads / 32];
  __shared__ int t_base;
  int t0 = 0, t1 = 0;  // this item's share of the land list
  if (s == 0) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int nl = 0;
    for (int base = c0; base < c1; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const bool is_land = i < c1 && __ldg(r.land + i) > 0.0f;
      if (i < c1 && !is_land)
        store_cols(dst, np, i, out_planar, load_cols(src, np, i, true));
      const unsigned ball = __ballot_sync(0xffffffffu, is_land);
      if (lane == 0) wcount[wid] = __popc(ball);
      __syncthreads();
      int at = nl, total = nl;
      for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) {
        at += w < wid ? wcount[w] : 0;
        total += wcount[w];
      }
      if (is_land) chunk_lands[at + __popc(ball & ((1u << lane) - 1u))] = i;
      nl = total;
      __syncthreads();  // wcount is rewritten next round
    }
    if (threadIdx.x == 0) t_base = atomicAdd(count, nl);
    __syncthreads();
    t0 = t_base;
    t1 = t0 + nl;
    for (int t = threadIdx.x; t < nl; t += blockDim.x)
      r.lands[t0 + t] = chunk_lands[t];
  } else {
    if (s == 1 || out_planar) {
      for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x)
        if (!(__ldg(r.land + i) > 0.0f))
          store_cols(dst, np, i, out_planar, load_cols(src, np, i, false));
    }
    // complete: every block appended before hop 0's grid barrier
    const long total = __ldcg(count);
    t0 = (int)(total * it / items);
    t1 = (int)(total * (it + 1) / items);
  }
  const bool act_s = s < r.shadow_hops, act_w = s < r.windward_hops;
  const uint32_t live = g.bands.n < 32 ? (1u << g.bands.n) - 1u : ~0u;
  for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    const int i = s == 0 ? chunk_lands[t - t0] : __ldcg(r.lands + t);
    const float4 own_v = load_cols(src, np, i, in_planar);
    float o[4] = {own_v.x, own_v.y, own_v.z, own_v.w};
    uint32_t b = __ldg(g.bits + i) & live;
    int e = g.m > 0 ? row_begin(g.rptr, i, g.m) : 0;
    const int deg = __popc(b) + (g.m > 0 ? row_end(g.rptr, i, g.m) - e : 0);
    // hops after the first read the stored weights; the first hop and a
    // cell past the store's slots compute them
    const bool from_store = s > 0 && deg <= r.slots;
    ShadowOwn own{};
    if (!from_store) {
      const float* a = r.aux + i;
      own = ShadowOwn{__ldg(a), __ldg(a + np), __ldg(a + 2 * np),
                      __ldg(a + 3 * np), __ldg(a + 4 * np),
                      __ldg(a + 5 * np), __ldg(a + 6 * np),
                      __ldg(a + 7 * np), __ldg(a + 8 * np)};
    }
    float wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float wacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < deg; k0 += kShadowBatch) {
      int jj[kShadowBatch];
      float4 v[kShadowBatch], w[kShadowBatch];
#pragma unroll
      for (int u = 0; u < kShadowBatch; ++u) {
        jj[u] = -1;
        if (k0 + u >= deg) continue;
        if (b) {
          jj[u] = wrap(i + offs[__ffs(b) - 1], g.np);
          b &= b - 1;
        } else {
          const int j = __ldg(g.rnbr + e++);
          if (j >= 0 && j < g.np) jj[u] = j;
        }
      }
#pragma unroll
      for (int u = 0; u < kShadowBatch; ++u) {
        if (jj[u] < 0) continue;
        v[u] = load_cols(src, np, jj[u], in_planar);
        const size_t slot = (size_t)(k0 + u) * np + t;
        if (from_store) {
          w[u] = __ldcg(r.wts + slot);
        } else {
          w[u] = shadow_weights(r.aux, np, own, jj[u]);
          if (s == 0 && k0 + u < r.slots) r.wts[slot] = w[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kShadowBatch; ++u) {
        if (jj[u] < 0) continue;
        shadow_add(w[u].x, v[u].x, act_s && v[u].x < 0.0f, wsum[0], wacc[0]);
        shadow_add(w[u].y, v[u].y, act_s && v[u].y < 0.0f, wsum[1], wacc[1]);
        shadow_add(w[u].z, v[u].z, act_w && v[u].z > 0.0f, wsum[2], wacc[2]);
        shadow_add(w[u].w, v[u].w, act_w && v[u].w > 0.0f, wsum[3], wacc[3]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if ((c < 2 ? act_s : act_w) && wsum[c] > 0.0f) {
        const float carried = wacc[c] / fmaxf(wsum[c], 1e-20f) *
                              (c < 2 ? r.retain_s : r.retain_w);
        o[c] = c < 2 ? fminf(o[c], carried) : fmaxf(o[c], carried);
      }
    }
    store_cols(dst, np, i, out_planar, make_float4(o[0], o[1], o[2], o[3]));
  }
  __syncthreads();  // the window is reused by the next item
}

// Work item `it` of sweep s (items = ng * chunks, group-major). Returns
// this thread's "some cell changed". All threads of the block call it.
template <class R>
__device__ bool run_item(const RelaxArgs<R>& a, const float* src, float* dst,
                         int it, int chunks, float* win, const int* offs,
                         int) {
  const int f = it / chunks;
  return relax_item(a.rule, a.geo, src, dst, f, (it - f * chunks) * a.geo.T,
                    win, offs, a.inner);
}

__device__ bool run_item(const RelaxArgs<StressRule>& a, const float* src,
                         float* dst, int it, int chunks, float* win,
                         const int* offs, int) {
  const int l = it / chunks;
  return stress_item(a.rule, a.geo, src, dst, l, (it - l * chunks) * a.geo.T,
                     win, offs);
}

template <int F>
struct SmoothArgs : RelaxArgs<SmoothRule> {};

template <int F>
__device__ bool run_item(const SmoothArgs<F>& a, const float* src, float* dst,
                         int it, int, float* win, const int* offs, int) {
  smooth_item<F>(a.rule, a.geo, src, dst, it * a.geo.T, win, offs);
  return false;
}

__device__ bool run_item(const RelaxArgs<WarpRule>& a, const float* src,
                         float* dst, int it, int, float* win, const int* offs,
                         int) {
  return warp_item(a.rule, a.geo, src, dst, it * a.geo.T, win, offs);
}

__device__ bool run_item(const RelaxArgs<ShadowRule>& a, const float* src,
                         float* dst, int it, int chunks, float* win,
                         const int* offs, int s) {
  shadow_item(a.rule, a.geo, src, dst, it, chunks, win, offs, s);
  return false;
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
      changed |= run_item(a, src, dst, it, chunks, win, offs, s);
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
bfs_relax_kernel(RelaxArgs<BfsRule> a) { relax_loop(a); }

__global__ void __launch_bounds__(kRelaxThreads)
flood_relax_kernel(RelaxArgs<FloodRule> a) { relax_loop(a); }

__global__ void __launch_bounds__(kRelaxThreads)
stress_relax_kernel(RelaxArgs<StressRule> a) { relax_loop(a); }

template <int F>
__global__ void __launch_bounds__(kRelaxThreads)
smooth_relax_kernel(SmoothArgs<F> a) { relax_loop(a); }

__global__ void __launch_bounds__(kRelaxThreads)
warp_relax_kernel(RelaxArgs<WarpRule> a) { relax_loop(a); }

__global__ void __launch_bounds__(kRelaxThreads)
shadow_relax_kernel(RelaxArgs<ShadowRule> a) { relax_loop(a); }

// ── Connected components: the whole loop in one launch ────────────────
// Replaces the components use of _make_bfs_kernel (sweep_pallas.py:171,
// through BfsSweeper in the JAX _cc_core_pallas, ops/banded.py:877). One
// step of the loop, as ops/banded.py components_core computes it:
//   1. sweep   N = min(P, min over gated band and remainder nbrs j of P[j])
//              (LabelRule on the staged windows; the gated remainder edges
//              come as CSR rows, the ungated ones past rem_ptr[NP]);
//   2. hook    H = N, then H[P[m]] = min(H[P[m]], N[m]) for every member m;
//   3. jump    J[i] = H[clamp(H[i])] for members, H[i] for the others;
//   4. jump    P'[i] = J[clamp(J[i])] likewise; the step changed something
//              when P' != P anywhere.
// Labels are non-negative integral floats (cell indices, NP at
// non-members), so their int32 bit patterns order as their values do and
// the hook is one atomicMin on the bits: exact in any order. Each phase
// reads only what the phase before wrote (a grid barrier between phases,
// H, J and N buffers of their own), so every step equals the plain loop's
// and the step count is the plain loop's. The loop ends at the first step
// that changes nothing (change flag in three rotating device slots, as
// relax_loop keeps it); P' overwrites P in place in phase 4, where each
// thread reads only its own cell of P.
// Bound: bytes per step (labels read and written, bits, members and the
// CSR read once); the min, the hook and the jumps are a few operations a
// cell.
struct CompArgs : RelaxArgs<LabelRule> {
  const uint8_t* member;  // [NP] nonzero = member, or null: every cell
  float* hook;            // [NP] H
  float* jmp;             // [NP] J
};

__device__ __forceinline__ bool is_member(const CompArgs& a, int i) {
  return a.member == nullptr || __ldg(a.member + i) != 0;
}

// lab[clamp(v, 0, np - 1)]: the jump through label v
__device__ __forceinline__ float jump_label(const float* lab, float v,
                                            int np) {
  const int j = (int)v;
  return __ldcg(lab + (j < 0 ? 0 : (j >= np ? np - 1 : j)));
}

__global__ void __launch_bounds__(kRelaxThreads)
components_relax_kernel(CompArgs a) {
  extern __shared__ __align__(16) float win[];
  __shared__ int offs[kMaxBands];
  __shared__ int stop;
  const Geo& g = a.geo;
  for (int d = threadIdx.x; d < kMaxBands; d += blockDim.x)
    offs[d] = g.bands.off[d];
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int chunks = (g.np + g.T - 1) / g.T;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  int s = 0;
  for (;; ++s) {
    const float* prev = s == 0 ? a.in : a.out;
    for (int it = blockIdx.x; it < chunks; it += gridDim.x) {
      const int c0 = it * g.T;
      relax_item(a.rule, g, prev, a.tmp, 0, c0, win, offs, 1);
      for (int i = c0 + threadIdx.x; i < min(c0 + g.T, g.np); i += blockDim.x)
        a.hook[i] = __ldcg(a.tmp + i);
    }
    grid.sync();
    for (int i = gtid; i < g.np; i += gstride) {
      if (!is_member(a, i)) continue;
      const int par = (int)__ldcg(prev + i);
      if (par < 0 || par >= g.np) continue;
      const float v = __ldcg(a.tmp + i);
      if (v < __ldcg(a.hook + par))
        atomicMin(reinterpret_cast<int*>(a.hook) + par, __float_as_int(v));
    }
    grid.sync();
    for (int i = gtid; i < g.np; i += gstride) {
      const float h = __ldcg(a.hook + i);
      a.jmp[i] = is_member(a, i) ? jump_label(a.hook, h, g.np) : h;
    }
    grid.sync();
    bool changed = false;
    for (int i = gtid; i < g.np; i += gstride) {
      const float j = __ldcg(a.jmp + i);
      const float v = is_member(a, i) ? jump_label(a.jmp, j, g.np) : j;
      changed |= v != __ldcg(prev + i);
      a.out[i] = v;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicOr(&a.ctl[s % 3], 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[(s + 1) % 3] = 0;
    grid.sync();
    if (threadIdx.x == 0) stop = *(volatile int*)&a.ctl[s % 3] == 0;
    __syncthreads();
    if (stop) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctl[3] = s + 1;
    if (a.total != nullptr) atomicAdd(a.total, s + 1);
  }
}

Bands make_bands(const int* offs, int n_offs) {
  Bands b;
  b.n = n_offs;
  for (int d = 0; d < kMaxBands; ++d) b.off[d] = d < n_offs ? offs[d] : 0;
  return b;
}

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
  g.tstep = kRelaxThreads;
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
// size T (t_free: T before the window cap), the windows' bytes of dynamic
// shared memory and the grid. Plans are cached per kernel, device, NP,
// item groups, windows per item and H (everything that sets T and the
// grid), so the SM-count, shared-memory-attribute and occupancy calls run
// once per shape, not on each launch; relax_plans() reads them back.
struct Plan {
  const void* kern;
  int dev, np, ng, nw, H;
  int T, grid;
  long smem;
  int t_free;
};
constexpr int kPlanSlots = 32;
constexpr int kPlanFields = 9;  // the ints relax_plans() writes a plan
Plan g_plans[kPlanSlots];
int g_plan_count = 0;
std::mutex g_plan_mu;

// T: kItemsPerSm work items per SM, rounded up to a multiple of g.tstep
// (the block size; 4 for warp and the rain shadow, whose items then fill
// every SM), no larger than the mesh, then capped to what shared memory
// holds: nw windows of T + 2H floats plus the float4 alignment slack. A
// capped T is any integer >= 1, a multiple of neither tstep nor 4: the
// item loops run to min(c0 + T, NP), span_of aligns each window by its
// own lead, and the remainder rows and the change flag are per cell, so
// every launch holds at any T (chip_smoke.py checks capped plans against
// the plain loops). With H ~ 3.6 sqrt(N) the cap first binds at ~1M cells
// for four smoothing fields (nw = 4), ~1.3-1.6M for the 4- and 5-field
// BFS, warp, stress and three fields, ~2.3M for two; the launch is
// refused (T < 1: 2H + 11 >= kMaxWindowFloats / nw) from H = 7227
// (nw = 4, ~4.1M cells), 9637 (nw = 3, warp, ~7.3M), 14459 (nw = 2,
// stress or two fields, ~16M) and 28923 (nw = 1, ~66M). Grid: the
// co-resident blocks of the cooperative launch, no more than there are
// items.
int get_plan(const void* kern, const Geo& g, Plan* out) {
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
  const long per = kItemsPerSm * nsm;
  const long step = g.tstep;
  long t = ((long)g.ng * g.np + per - 1) / per;
  t = (t + step - 1) / step * step;
  t = std::max(t, step);
  t = std::min(t, ((long)g.np + step - 1) / step * step);
  const long t_free = t;
  t = std::min(t, kMaxWindowFloats / g.nw - 2L * h - 11);
  if (t < 1) return (int)cudaErrorInvalidValue;
  Plan p{kern, dev, g.np, g.ng, g.nw, h, (int)t, 0,
         g.nw * window_floats(t, h) * (long)sizeof(float), (int)t_free};
  // the most any plan takes, so that no plan's limit shrinks another's
  e = (int)cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)(kMaxWindowFloats * sizeof(float)));
  if (e != 0) return e;
  const long items = (long)g.ng * ((g.np + p.T - 1) / p.T);
  int per_sm = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kRelaxThreads, p.smem);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.grid = (int)std::min((long)per_sm * nsm, items);
  g_plans[g_plan_count++ % kPlanSlots] = p;
  *out = p;
  return 0;
}

// The launches of capped plans (T < t_free) this host thread made since
// it last asked; take_capped_launches() reads and clears it.
thread_local int g_capped_launches = 0;

// The whole relax loop in one cooperative launch. A refused launch
// returns its error; it never runs.
template <class A>
int launch_relax(void (*kern)(A), A a, cudaStream_t stream) {
  Plan p;
  int e = get_plan((const void*)kern, a.geo, &p);
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
  if (p.T < p.t_free) ++g_capped_launches;
  return (int)cudaGetLastError();
}

template <int F>
int launch_smooth(RelaxArgs<SmoothRule> a, cudaStream_t stream) {
  SmoothArgs<F> s;
  static_cast<RelaxArgs<SmoothRule>&>(s) = a;
  return launch_relax(smooth_relax_kernel<F>, s, stream);
}

// ── Pointer-doubling accumulate: one cooperative launch per loop ───────
//
// Replaces the XLA scatter-adds `.at[p].add` of the JAX pointer-doubling
// loops (erosion/glacial.py:72 the ice flow, erosion/flood.py:333
// downstream_accumulate, erosion/fluvial.py:84 flow_accumulation) and of
// the wind stage's geo bins (climate/wind.py:50-52); the TPU ran them as
// XLA scatters, not as a Pallas kernel. One round of a loop:
//   added[t] = sum of s[i] over the i with p[i] == t, for t < n, added
//              from +0.0f in ascending i (the order of torch's CPU
//              index_add and of the jnp scatter-add, hence their bits);
//   s <- s + added;   p <- p[p]   (targets outside [0, n) are the sink,
//              which maps to itself and is never summed).
// A loop stops before a round in which no pointer is off the sink
// (stop_at_sink: the JAX while_loop's cond) or, otherwise, once at least
// one round ran (then s has no -0.0, since added never is, and s + 0.0f ==
// s: the remaining rounds would change nothing), and after `rounds`
// rounds. The one-round form (loop = 0: the bins and dep_sum) writes added
// alone for n_out targets of k entries.
//
// A float round, with a grid barrier after each phase:
//   S  scan: each block takes an exclusive scan of its chunk of the
//      per-target counts (chunk-local offsets, and the chunk total);
//   P  place: every block scans the chunk totals itself (in shared
//      memory: the grid's few hundred words), so a row starts at
//      offl[t] + bpref[chunk(t)]; each source takes a slot of its target's
//      row by an atomic cursor (rows in arbitrary order, no global sort);
//   A  add: a row of at most kThreadRow entries is one thread's: it loads
//      the indices, sorts them in registers (an insertion network of 4 or
//      16 wide), loads all the values at once and adds them in order (a
//      row of ~10 entries left to a warp cost ~20x as much: the block's
//      warps took its long rows one at a time); a longer row goes to
//      a warp, which ranks each entry by shuffles (the entries are distinct
//      source indices; a row of up to 256 entries is held in registers),
//      writes its values to their ranked slot, then loads 32 slots a time
//      and adds them in order (every lane adds the same shuffled values;
//      one writes). Loads are in flight together; only the adds are
//      serial. A row longer than kRankRow (a star; none on the 204K path,
//      whose rows hold at most ~90) is summed by a warp that walks every
//      source in index order and adds those of the row: O(k), not
//      O(len^2). With few targets (the 2592 bins) every row goes to a warp,
//      spread over the grid. Then p <- p[p], and the next round's targets
//      are counted with int32 atomics that skip the sink (no contention on
//      the slot most cells point at).
// The int32 flow counts add in any order exactly: their rounds take an
// atomic add per source (again skipping the sink) and one pass that adds
// and jumps. Nothing is read back: the round count goes to ctl[3].
// Bound: bytes per round (s and p read, s and p written); the adds are
// one operation per source and field.
constexpr int kAccThreads = 512;
constexpr int kMaxAccGrid = 1024;  // the chunk totals the scratch holds
constexpr int kMaxSumFields = 4;
constexpr int kThreadRow = 16;
constexpr int kWarpChunks = 8;
constexpr int kRankRow = 2048;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;

struct AccArgs {
  const void* s_in;   // [k, nf] float32 values, or [k] int32 counts
  const void* p_in;   // [k] int32 or int64 targets
  int p64;            // p_in is int64
  int k, n_out, nf;
  int rounds;
  int loop;          // 1: k == n_out, s <- s + added and p <- p[p]
  int stop_at_sink;
  void* out;         // [n_out, nf] sums, or the final [k, nf] state
  void* tmp;         // [k, nf] second state buffer (loop)
  int* pbuf;         // [2, k] pointer buffers (loop)
  int* cnt;          // [2, n_out] per-target counts (int: [n_out] sums), zeroed
  int* offl;         // [n_out] chunk-local row offsets
  int* cur;          // [n_out] placement cursors, zeroed
  int* list;         // [k] sources by target
  float* vbuf;       // [k, nf] the long rows' values, in source order
  int* bsum;         // [kMaxAccGrid] chunk totals
  int* ctl;          // [4] three flag slots, then the rounds run; zeroed
  int* total;        // running round total, or null
};

// target of entry i: p[i] if it is in [0, n), else the sink n
__device__ __forceinline__ int target_of(const void* p, bool p64, int i,
                                         int n) {
  const long long v =
      p64 ? __ldcg(static_cast<const long long*>(p) + i)
          : (long long)__ldcg(static_cast<const int*>(p) + i);
  return (v >= 0 && v < n) ? (int)v : n;
}

// Exclusive prefix sum of v over the block (all threads call it, blockDim
// a multiple of 32); *sum gets the block's total.
__device__ int block_scan(int v, int* sum) {
  __shared__ int wsum[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? wsum[wid - 1] : 0);
  *sum = wsum[nw - 1];
  __syncthreads();  // wsum is rewritten by the next call
  return excl;
}

// Where a round's sums go: dst[t] = src[t] + added (loop) or added.
template <int F>
struct RowSum {
  const float* src;  // the sources' values (and the targets', in a loop)
  float* dst;
  const int* list;
  float* vbuf;
  bool loop;
  const void* p;     // the round's targets, for sum_row_scan
  bool p64;
  int k, n;
  __device__ void put(int t, const float* acc) const {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const size_t q = (size_t)t * F + f;
      dst[q] = loop ? __ldcg(src + q) + acc[f] : acc[f];
    }
  }
};

// A row of len <= R entries, one thread: the indices sorted in registers
// (an insertion network of R(R-1)/2 compare-exchanges), all the values
// loaded at once, then added in order.
template <int F, int R>
__device__ void sum_row_thread(const RowSum<F>& r, int t, int start,
                               int len) {
  int ix[R];
#pragma unroll
  for (int q = 0; q < R; ++q)
    ix[q] = q < len ? __ldcg(r.list + start + q) : kNoIndex;
#pragma unroll
  for (int q = 1; q < R; ++q)
#pragma unroll
    for (int j = q; j > 0; --j) {
      const int lo = min(ix[j - 1], ix[j]), hi = max(ix[j - 1], ix[j]);
      ix[j - 1] = lo;
      ix[j] = hi;
    }
  float v[R][F];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[q][f] = q < len ? __ldcg(r.src + (size_t)ix[q] * F + f) : 0.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (q < len)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += v[q][f];
  r.put(t, acc);
}

// A row longer than kRankRow, one warp: walk every source in index order
// and add those that target t, 32 at a time.
template <int F>
__device__ void sum_row_scan(const RowSum<F>& r, int t) {
  const int lane = threadIdx.x & 31;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int i0 = 0; i0 < r.k; i0 += 32) {
    const int i = i0 + lane;
    const bool hit = i < r.k && target_of(r.p, r.p64, i, r.n) == t;
    const unsigned ball = __ballot_sync(kFull, hit);
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[f] = hit ? __ldcg(r.src + (size_t)i * F + f) : 0.0f;
    for (unsigned q = ball; q; q &= q - 1) {
      const int j = __ffs((int)q) - 1;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += __shfl_sync(kFull, v[f], j);
    }
  }
  if (lane == 0) r.put(t, acc);
}

// The ordered sum of a row whose values sit in vbuf in source order.
template <int F>
__device__ void add_ranked(const RowSum<F>& r, int t, int start, int len) {
  const int lane = threadIdx.x & 31;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int c0 = 0; c0 < len; c0 += 32) {
    const int q = c0 + lane;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[f] = q < len ? __ldcg(r.vbuf + (size_t)(start + q) * F + f) : 0.0f;
    const int m = min(32, len - c0);
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float x = __shfl_sync(kFull, v[f], j);
        if (j < m) acc[f] += x;
      }
  }
  if (lane == 0) r.put(t, acc);
}

// Ranks of a row of up to C * 32 entries held in registers (one load
// latency), and each entry's values written to slot start + rank of vbuf.
template <int F, int C>
__device__ void rank_row_regs(const RowSum<F>& r, int start, int len) {
  const int lane = threadIdx.x & 31;
  int ix[C], rank[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int q = c * 32 + lane;
    ix[c] = q < len ? __ldcg(r.list + start + q) : kNoIndex;
    rank[c] = 0;
  }
  const int nch = (len + 31) >> 5;  // the chunks the row fills
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= nch) break;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int o = __shfl_sync(kFull, ix[c], j);
#pragma unroll
      for (int e = 0; e < C; ++e)
        if (e < nch) rank[e] += o < ix[e] ? 1 : 0;
    }
  }
  float v[C][F];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[c][f] = c * 32 + lane < len ? __ldcg(r.src + (size_t)ix[c] * F + f)
                                    : 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c * 32 + lane < len)
#pragma unroll
      for (int f = 0; f < F; ++f)
        r.vbuf[(size_t)(start + rank[c]) * F + f] = v[c][f];
}

// A row of any length, one warp (all 32 lanes call it with the same row):
// each entry's rank among the row's (distinct source indices), its values
// to slot start + rank of vbuf, then the ordered add. A row of up to
// kWarpChunks * 32 entries is held in registers (rank_row_regs, at the
// fewest 32-entry chunks, rounded up to a power of two, that hold it); a
// longer one reloads the row's chunks from L2 for each chunk it ranks.
template <int F>
__device__ void sum_row_warp(const RowSum<F>& r, int t, int start, int len) {
  if (len > kRankRow) {
    sum_row_scan(r, t);
    return;
  }
  const int lane = threadIdx.x & 31;
  if (len <= 32) {
    rank_row_regs<F, 1>(r, start, len);
  } else if (len <= 64) {
    rank_row_regs<F, 2>(r, start, len);
  } else if (len <= 128) {
    rank_row_regs<F, 4>(r, start, len);
  } else if (len <= kWarpChunks * 32) {
    rank_row_regs<F, kWarpChunks>(r, start, len);
  } else {
    for (int e0 = 0; e0 < len; e0 += 32) {
      const int q = e0 + lane;
      const int mine = q < len ? __ldcg(r.list + start + q) : kNoIndex;
      int rank = 0;
      for (int c0 = 0; c0 < len; c0 += 32) {
        const int other =
            c0 + lane < len ? __ldcg(r.list + start + c0 + lane) : kNoIndex;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          rank += __shfl_sync(kFull, other, j) < mine ? 1 : 0;
      }
      if (q < len)
#pragma unroll
        for (int f = 0; f < F; ++f)
          r.vbuf[(size_t)(start + rank) * F + f] =
              __ldcg(r.src + (size_t)mine * F + f);
    }
  }
  __syncwarp();
  add_ranked(r, t, start, len);
}

// the state ends in `out`: copy it there from where the last round left it
template <class V>
__device__ void acc_finish(const AccArgs& a, int r, size_t words) {
  const V* last = r == 0 ? static_cast<const V*>(a.s_in)
                         : (((r - 1) & 1) ? static_cast<const V*>(a.tmp)
                                          : static_cast<const V*>(a.out));
  if (last != a.out) {
    V* out = static_cast<V*>(a.out);
    for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < words;
         q += (size_t)gridDim.x * blockDim.x)
      out[q] = __ldcg(last + q);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctl[3] = r;
    if (a.total != nullptr) atomicAdd(a.total, r);
  }
}

template <int F>
__global__ void __launch_bounds__(kAccThreads)
accumulate_relax_kernel(AccArgs a) {
  __shared__ int bpref[kMaxAccGrid];
  __shared__ int nlong;
  __shared__ int longs[kAccThreads];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int gtid = b * blockDim.x + threadIdx.x, gstride = G * blockDim.x;
  const int k = a.k, n = a.n_out;
  const int chunk = (n + G - 1) / G;
  const float* s_in = static_cast<const float*>(a.s_in);
  float* out = static_cast<float*>(a.out);
  float* tmp = static_cast<float*>(a.tmp);
  for (int i = gtid; i < k; i += gstride) {
    const int t = target_of(a.p_in, a.p64, i, n);
    if (t < n) atomicAdd(a.cnt + t, 1);
  }
  grid.sync();
  int r = 0;
  for (; r < a.rounds; ++r) {
    int* cnt_cur = a.cnt + (size_t)(r & 1) * n;
    int* cnt_nxt = a.cnt + (size_t)((r + 1) & 1) * n;
    // S: this block's chunk of the counts
    const int lo = min(b * chunk, n), hi = min(lo + chunk, n);
    int carry = 0;
    for (int base = lo; base < hi; base += blockDim.x) {
      const int t = base + threadIdx.x;
      int tot;
      const int ex = block_scan(t < hi ? __ldcg(cnt_cur + t) : 0, &tot);
      if (t < hi) {
        a.offl[t] = carry + ex;
        cnt_nxt[t] = 0;
      }
      carry += tot;
    }
    if (threadIdx.x == 0) a.bsum[b] = carry;
    grid.sync();
    // P: the chunks' starts, then place every source in its target's row
    int total = 0;
    for (int base = 0; base < G; base += blockDim.x) {
      const int q = base + threadIdx.x;
      int tot;
      const int ex = block_scan(q < G ? __ldcg(a.bsum + q) : 0, &tot);
      if (q < G) bpref[q] = total + ex;
      total += tot;
    }
    __syncthreads();
    if (total == 0 && (a.stop_at_sink || r > 0)) break;
    const void* p_cur = r == 0 ? a.p_in : a.pbuf + (size_t)((r - 1) & 1) * k;
    const bool p64 = r == 0 && a.p64;
    for (int i = gtid; i < k; i += gstride) {
      const int t = target_of(p_cur, p64, i, n);
      if (t < n)
        a.list[__ldcg(a.offl + t) + bpref[t / chunk] + atomicAdd(a.cur + t, 1)] =
            i;
    }
    grid.sync();
    // A: every row's ordered sum, then the jump and the next counts
    auto row_start = [&](int t) { return __ldcg(a.offl + t) + bpref[t / chunk]; };
    auto row_len = [&](int t, int st) {
      return (t + 1 < n ? row_start(t + 1) : total) - st;
    };
    const RowSum<F> rs{r == 0 ? s_in : ((r & 1) ? out : tmp),
                       (r & 1) ? tmp : out, a.list, a.vbuf, a.loop != 0,
                       p_cur, p64, k, n};
    if (n <= 4 * (gstride >> 5)) {
      for (int t = gtid >> 5; t < n; t += gstride >> 5) {
        const int st = row_start(t);
        sum_row_warp(rs, t, st, row_len(t, st));
      }
    } else {
      for (int base = b * blockDim.x; base < n; base += gstride) {
        if (threadIdx.x == 0) nlong = 0;
        __syncthreads();
        const int t = base + threadIdx.x;
        if (t < n) {
          const int st = row_start(t), len = row_len(t, st);
          if (len <= 4)
            sum_row_thread<F, 4>(rs, t, st, len);
          else if (len <= kThreadRow)
            sum_row_thread<F, kThreadRow>(rs, t, st, len);
          else
            longs[atomicAdd(&nlong, 1)] = t;
        }
        __syncthreads();
        for (int q = threadIdx.x >> 5; q < nlong; q += blockDim.x >> 5) {
          const int tl = longs[q], st = row_start(tl);
          sum_row_warp(rs, tl, st, row_len(tl, st));
        }
        __syncthreads();  // nlong and longs are reset next
      }
    }
    for (int t = gtid; t < n; t += gstride) a.cur[t] = 0;
    if (a.loop) {
      int* p_nxt = a.pbuf + (size_t)(r & 1) * k;
      for (int i = gtid; i < k; i += gstride) {
        const int t = target_of(p_cur, p64, i, n);
        const int tn = t < n ? target_of(p_cur, p64, t, n) : n;
        p_nxt[i] = tn;
        if (tn < n) atomicAdd(cnt_nxt + tn, 1);
      }
    }
    grid.sync();
    if (!a.loop) {
      ++r;
      break;
    }
  }
  acc_finish<float>(a, r, a.loop ? (size_t)k * F : 0);
}

// The int32 loop (the flow counts): atomic adds, exact in any order.
__global__ void __launch_bounds__(kAccThreads)
accumulate_relax_count_kernel(AccArgs a) {
  __shared__ int stop;
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int n = a.n_out;
  const int* s_in = static_cast<const int*>(a.s_in);
  int* out = static_cast<int*>(a.out);
  int* tmp = static_cast<int*>(a.tmp);
  int* sums = a.cnt;
  bool any = false;
  for (int i = gtid; i < n; i += gstride)
    any |= target_of(a.p_in, a.p64, i, n) < n;
  if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(&a.ctl[0], 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[1] = 0;
  grid.sync();
  int r = 0;
  for (;; ++r) {
    if (threadIdx.x == 0) {
      const int off_sink = *(volatile int*)&a.ctl[r % 3];
      stop = r >= a.rounds || (off_sink == 0 && (a.stop_at_sink || r > 0));
    }
    __syncthreads();
    if (stop) break;
    const void* p_cur = r == 0 ? a.p_in : a.pbuf + (size_t)((r - 1) & 1) * n;
    const bool p64 = r == 0 && a.p64;
    const int* src = r == 0 ? s_in : ((r & 1) ? out : tmp);
    int* dst = (r & 1) ? tmp : out;
    int* p_nxt = a.pbuf + (size_t)(r & 1) * n;
    for (int i = gtid; i < n; i += gstride) {
      const int t = target_of(p_cur, p64, i, n);
      if (t < n) atomicAdd(sums + t, __ldcg(src + i));
    }
    grid.sync();
    any = false;
    for (int t = gtid; t < n; t += gstride) {
      dst[t] = __ldcg(src + t) + __ldcg(sums + t);
      sums[t] = 0;
      const int tt = target_of(p_cur, p64, t, n);
      const int tn = tt < n ? target_of(p_cur, p64, tt, n) : n;
      p_nxt[t] = tn;
      any |= tn < n;
    }
    if (__syncthreads_or(any) && threadIdx.x == 0)
      atomicOr(&a.ctl[(r + 1) % 3], 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[(r + 2) % 3] = 0;
    grid.sync();
  }
  acc_finish<int>(a, r, (size_t)n);
}

// Co-resident blocks of a cooperative launch of `kern` at `threads`
// threads, at most two per SM (fewer blocks make a cheaper grid barrier),
// cached per kernel and device.
int coop_blocks(const void* kern, int threads, int* out) {
  struct Slot {
    const void* kern;
    int dev, blocks;
  };
  static Slot slots[16];
  static int used = 0;
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  std::lock_guard<std::mutex> lock(g_plan_mu);
  for (int q = 0; q < used; ++q)
    if (slots[q].kern == kern && slots[q].dev == dev) {
      *out = slots[q].blocks;
      return 0;
    }
  int nsm = 0, per_sm = 0;
  e = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         threads, 0);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *out = std::min(std::min(per_sm, 2) * nsm, kMaxAccGrid);
  if (used < 16) slots[used++] = Slot{kern, dev, *out};
  return 0;
}

int launch_accumulate(void (*kern)(AccArgs), AccArgs a, cudaStream_t stream) {
  int blocks = 0;
  int e = coop_blocks((const void*)kern, kAccThreads, &blocks);
  if (e != 0) return e;
  const long need =
      ((long)std::max(a.k, a.n_out) + kAccThreads - 1) / kAccThreads;
  const int grid = (int)std::max(1L, std::min((long)blocks, need));
  void* args[] = {&a};
  e = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                       dim3(kAccThreads), args, 0, stream);
  if (e != 0) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}


// ── One-pass stencils of the erosion loop's glacial and thermal steps ──
// Port-only (the JAX steps are jnp band loops): each neighbour pass of
// erosion/thermal.py and erosion/glacial.py is one launch, one thread per
// cell. A thread walks its cell's set band bits in band order, then its
// remainder row in edge order (the order of the band loop's sums and of
// the jnp scatter-add), keeps its accumulators in registers and writes each
// output plane once. Every float operation is the band loop's own, in its
// order and with its constants rounded as torch rounds a Python float to
// float32: with --fmad=false the card gives the band loop's bits. A band
// or remainder edge whose bit is clear adds nothing: every accumulator
// starts at +0 and takes only values >= +0, where the band loop adds +0.
// The per-cell pow terms of the glacial step stay torch's (their f32 pow
// is the library's), and come in as planes. Land is valid && !ocean.
// Bound: bytes; every plane read once, each output written once.
constexpr int kCellThreads = 256;

__device__ __forceinline__ bool is_land(const uint8_t* ocean,
                                        const uint8_t* valid, int j) {
  return valid[j] != 0 && ocean[j] == 0;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// erosion/thermal.py _edge_excess: the slope excess above the talus slope
// across one edge of length d, where ok
__device__ __forceinline__ float edge_excess(float h_me, float h_nb, float d,
                                             bool ok, float talus) {
  const float dd = clamp_min(d, (float)1e-6);
  const float slope = (h_me - h_nb) / dd;
  return (ok && slope > talus) ? (slope - talus) * dd : 0.0f;
}

__device__ __forceinline__ uint32_t band_word(const uint32_t* bits, int i,
                                              int n_bands) {
  const uint32_t b = bits[i];
  return n_bands >= 32 ? b : (b & ((1u << n_bands) - 1u));
}

struct ThermalArgs {
  const float* elev;
  const uint8_t* ocean;
  const uint8_t* valid;
  const uint32_t* bits;
  const float* bdist;  // [np, n_bands] band edge lengths
  const int* rptr;
  const int* rnbr;
  const float* rdist;  // [m] remainder edge lengths in CSR order
  const float* shed;   // receive: the cells' shed [np]
  const float* share;  // receive: the cells' edge share [np]
  float* out;          // shed: [2, np] (shed, share); receive: [np]
  int m, np;
  float talus, k;
  Bands bands;
};

// Pass 1 (thermal_shed): each land cell's total slope excess over its land
// neighbours, the transfer k * total * 0.5 it sheds and the share of it
// each edge carries.
__global__ void __launch_bounds__(kCellThreads)
thermal_shed_kernel(ThermalArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.np) return;
  const bool li = is_land(a.ocean, a.valid, i);
  const float hi = a.elev[i];
  const float* bd = a.bdist + (size_t)i * a.bands.n;
  float total = 0.0f;
  for (uint32_t b = band_word(a.bits, i, a.bands.n); b; b &= b - 1) {
    const int d = __ffs((int)b) - 1;
    const int j = wrap(i + a.bands.off[d], a.np);
    total = total + edge_excess(hi, a.elev[j], bd[d],
                                li && is_land(a.ocean, a.valid, j), a.talus);
  }
  for (int k = row_begin(a.rptr, i, a.m), e = row_end(a.rptr, i, a.m); k < e;
       ++k) {
    const int j = a.rnbr[k];
    if (j < 0 || j >= a.np) continue;
    total = total + edge_excess(hi, a.elev[j], a.rdist[k],
                                li && is_land(a.ocean, a.valid, j), a.talus);
  }
  const float transfer = a.k * total * 0.5f;
  a.out[i] = total > 0.0f ? transfer : 0.0f;
  a.out[a.np + i] =
      total > 0.0f ? transfer / clamp_min(total, (float)1e-20) : 0.0f;
}

// Pass 2 (thermal_receive): what each land cell receives from its higher
// land neighbours (their edge share of the excess across the edge), less
// what it sheds.
__global__ void __launch_bounds__(kCellThreads)
thermal_receive_kernel(ThermalArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.np) return;
  const bool li = is_land(a.ocean, a.valid, i);
  const float hi = a.elev[i];
  const float* bd = a.bdist + (size_t)i * a.bands.n;
  float recv = 0.0f;
  for (uint32_t b = band_word(a.bits, i, a.bands.n); b; b &= b - 1) {
    const int d = __ffs((int)b) - 1;
    const int j = wrap(i + a.bands.off[d], a.np);
    const float in = edge_excess(a.elev[j], hi, bd[d],
                                 li && is_land(a.ocean, a.valid, j), a.talus);
    recv = recv + in * a.share[j];
  }
  for (int k = row_begin(a.rptr, i, a.m), e = row_end(a.rptr, i, a.m); k < e;
       ++k) {
    const int j = a.rnbr[k];
    if (j < 0 || j >= a.np) continue;
    const float in = edge_excess(a.elev[j], hi, a.rdist[k],
                                 li && is_land(a.ocean, a.valid, j), a.talus);
    recv = recv + in * a.share[j];
  }
  a.out[i] = hi + (li ? recv - a.shed[i] : 0.0f);
}

struct IceArgs {
  const float* elev;
  const uint8_t* ocean;
  const uint8_t* valid;  // null: every cell
  const float* glac;
  const int* gidx;  // global index of each cell, or null: the cell's own
  const uint32_t* bits;
  const int* rptr;
  const int* rnbr;
  int* target;  // [np] ice target (global index) or -1
  int* ptr;     // [np] pointer: the target clamped into [0, n_total), or
                // n_total (the sink)
  int m, np, n_total;
  Bands bands;
};

// ice_flow's banded argmin: the lowest neighbour, the first best in band
// order; the remainder row's least key wins only on strict improvement,
// its ties to the largest target index. A glaciated land cell drains there
// when that neighbour is strictly lower.
__global__ void __launch_bounds__(kCellThreads) ice_argmin_kernel(IceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.np) return;
  const int gi = a.gidx ? a.gidx[i] : i;
  float best = INFINITY;
  int tgt = 0;
  for (uint32_t b = band_word(a.bits, i, a.bands.n); b; b &= b - 1) {
    const int d = __ffs((int)b) - 1;
    const float v = a.elev[wrap(i + a.bands.off[d], a.np)];
    if (v < best) {
      best = v;
      tgt = gi + a.bands.off[d];
    }
  }
  float w = INFINITY;
  int wt = -1;
  for (int k = row_begin(a.rptr, i, a.m), e = row_end(a.rptr, i, a.m); k < e;
       ++k) {
    const int j = a.rnbr[k];
    if (j < 0 || j >= a.np) continue;
    const float v = a.elev[j];
    const int g = a.gidx ? a.gidx[j] : j;
    if (v < w) {
      w = v;
      wt = g;
    } else if (v == w && g > wt) {
      wt = g;
    }
  }
  if (w < best) {
    best = w;
    tgt = wt;
  }
  const bool land = (a.valid == nullptr || a.valid[i] != 0) && a.ocean[i] == 0;
  const bool has = land && a.glac[i] > 0.0f && a.elev[i] - best > 0.0f &&
                   isfinite(best);
  a.target[i] = has ? tgt : -1;
  a.ptr[i] = has ? (tgt < 0 ? 0 : (tgt > a.n_total - 1 ? a.n_total - 1 : tgt))
                 : a.n_total;
}

struct GlacialArgs {
  const float* elev;
  const uint8_t* ocean;
  const uint8_t* valid;
  const float* glac;
  const float* flow;
  const int* target;  // ice_argmin_kernel's
  const int* gidx;    // or null
  const float* p06;   // torch.pow(flow, 0.6)
  const float* p03;   // torch.pow(flow, 0.3)
  const float* p04;   // torch.pow(flow, 0.4)
  const float* p05;   // torch.pow(flow, 0.5)
  const uint32_t* bits;
  const float* bdist;
  const int* rptr;
  const int* rnbr;
  const float* rdist;
  float* out;
  int m, np;
  // 0.02, 0.005, 0.01 and 0.015 times g_scale, each a float32 product
  float c_deep, c_mor, c_trib, c_fjord, strength;
  Bands bands;
};

struct GlacialAcc {
  int nup;
  float widen, deposit;
  bool ocean_nb;
};

// One edge j -> i of the glacial step's neighbour pass: tributaries
// pointing at i, valley widening from a carving neighbour, moraine deposit
// at a terminus, and whether an ocean cell borders i.
__device__ __forceinline__ void glacial_edge(const GlacialArgs& a, int i,
                                             int gi, bool li, float hi,
                                             float gl_i, int j, float dist,
                                             GlacialAcc& s) {
  const bool lj = is_land(a.ocean, a.valid, j);
  const float fj = a.flow[j];
  const bool flow_ok = fj > (float)0.1;
  const bool carving = lj && flow_ok;
  const bool pam = a.target[j] == gi;
  s.nup += pam ? 1 : 0;
  const float slope = fabsf(hi - a.elev[j]) / clamp_min(dist, (float)1e-6);
  const float deep = carving ? a.c_deep * a.p06[j] * a.strength : 0.0f;
  s.widen = s.widen + ((carving && li && lj)
                           ? deep * (float)0.4 * clamp_min(1.0f - slope, 0.0f)
                           : 0.0f);
  const bool dep_ok = pam && li && flow_ok && gl_i < a.glac[j] * (float)0.3;
  s.deposit = s.deposit + (dep_ok ? a.c_mor * a.p03[j] : 0.0f);
  s.ocean_nb = s.ocean_nb || a.ocean[j] != 0;
}

// glacial_step after the ice flow: the neighbour pass, the delta, the
// fjord carve on glaciated coastal cells and the land clamp.
__global__ void __launch_bounds__(kCellThreads)
glacial_stencil_kernel(GlacialArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.np) return;
  const int gi = a.gidx ? a.gidx[i] : i;
  const bool li = is_land(a.ocean, a.valid, i);
  const float hi = a.elev[i];
  const float gl_i = a.glac[i];
  const float* bd = a.bdist + (size_t)i * a.bands.n;
  GlacialAcc s{0, 0.0f, 0.0f, false};
  for (uint32_t b = band_word(a.bits, i, a.bands.n); b; b &= b - 1) {
    const int d = __ffs((int)b) - 1;
    glacial_edge(a, i, gi, li, hi, gl_i, wrap(i + a.bands.off[d], a.np),
                 bd[d], s);
  }
  for (int k = row_begin(a.rptr, i, a.m), e = row_end(a.rptr, i, a.m); k < e;
       ++k) {
    const int j = a.rnbr[k];
    if (j < 0 || j >= a.np) continue;
    glacial_edge(a, i, gi, li, hi, gl_i, j, a.rdist[k], s);
  }
  const float fi = a.flow[i];
  const bool carving = li && fi > (float)0.1;
  const float deep = carving ? a.c_deep * a.p06[i] * a.strength : 0.0f;
  float delta = -deep;
  delta = delta - s.widen;
  delta = delta - ((carving && s.nup >= 2) ? a.c_trib * a.p04[i] : 0.0f);
  delta = delta + s.deposit;
  float nw = hi + (li ? delta : 0.0f);
  if (li && s.ocean_nb && gl_i > (float)0.2 && fi > (float)0.5)
    nw = clamp_min(nw - a.c_fjord * a.p05[i], 0.0f);
  a.out[i] = li ? clamp_min(nw, 0.0f) : nw;
}

// The remainder edges a stencil walks: none without a CSR.
int rem_csr_m(const int* rptr, const int* rnbr, int m) {
  return (rptr != nullptr && rnbr != nullptr && m > 0) ? m : 0;
}

template <class A>
int launch_cells(void (*kern)(A), A a, int np, cudaStream_t stream) {
  void* args[] = {&a};
  const int e = (int)cudaLaunchKernel(
      (const void*)kern, dim3((np + kCellThreads - 1) / kCellThreads),
      dim3(kCellThreads), args, 0, stream);
  if (e != 0) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// right after its launch; 0 means the launch was accepted. The relax
// entries take ctl: int32 [4] zeroed by the caller (flag slots, then the
// sweep count), and total: an int32 counter the sweep count is added to,
// or null.
extern "C" {

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

// state [4, NP] (index, xyz), w [3, NP]; at most `cap` >= 1 sweeps.
// rcand: [M] float4 scratch, one per remainder edge (16-byte aligned).
int warp_relax(const float* state, const float* w, const uint32_t* bits,
               const int* rem_ptr, const int* rem_nbr, int m, float* rcand,
               float* out, float* tmp, int* ctl, int* total, int np,
               const int* offs, int n_offs, int cap, void* stream) {
  if (bad_shape(np, 1, n_offs) || cap < 1 ||
      !staged_ok(np, {state, out, tmp, rcand}))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<WarpRule> a{};
  a.rule.w = w;
  a.rule.rcand = reinterpret_cast<float4*>(rcand);
  a.geo = make_geo(bits, rem_ptr, rem_nbr, m, np, 1, 3, offs, n_offs);
  a.geo.tstep = 4;
  a.in = state;
  a.out = out;
  a.tmp = tmp;
  a.ctl = ctl;
  a.total = total;
  a.cap = cap;
  a.inner = 1;
  a.planes = 4;
  return launch_relax(warp_relax_kernel, a, (cudaStream_t)stream);
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

// state [4, NP], aux [9, NP], land [NP]; exactly max(shadow_hops,
// windward_hops) >= 1 hops. lands: [NP + 1] int32 scratch, zeroed. wts:
// [slots >= 1, NP] float4 scratch for the edge weights.
int shadow_relax(const float* state, const float* aux, const float* land,
                 const uint32_t* bits, const int* rem_ptr, const int* rem_nbr,
                 int m, float* out, float* tmp, int* ctl, int* total,
                 int* lands, float* wts, int slots, int np, const int* offs,
                 int n_offs, float retain_s, float retain_w, int shadow_hops,
                 int windward_hops, void* stream) {
  const int hops = std::max(shadow_hops, windward_hops);
  if (bad_shape(np, 1, n_offs) || hops < 1 || lands == nullptr ||
      wts == nullptr || slots < 1 || !aligned16(wts) ||
      !staged_ok(np, {state, out, tmp}))
    return (int)cudaErrorInvalidValue;
  RelaxArgs<ShadowRule> a{};
  a.rule = ShadowRule{aux, land, lands, reinterpret_cast<float4*>(wts),
                      slots, retain_s, retain_w, shadow_hops, windward_hops};
  // one window's space holds the chunk's land-cell list
  a.geo = make_geo(bits, rem_ptr, rem_nbr, m, np, 1, 1, offs, n_offs);
  a.geo.tstep = 4;
  a.in = state;
  a.out = out;
  a.tmp = tmp;
  a.ctl = ctl;
  a.total = total;
  a.cap = hops;
  a.inner = 1;
  a.planes = 4;
  a.fixed = true;
  return launch_relax(shadow_relax_kernel, a, (cudaStream_t)stream);
}

// lab [NP] f32 cell-index labels (NP at non-members); member [NP] uint8 or
// null (every cell); bits [NP] the gated band bits; rem_ptr / rem_nbr the
// gated remainder edges as CSR rows of their receiving cell (the ungated
// ones may follow past rem_ptr[NP]); out, nxt, hook, jmp [NP] f32, out and
// lab 16-byte aligned.
int components_relax(const float* lab, const uint8_t* member,
                     const uint32_t* bits, const int* rem_ptr,
                     const int* rem_nbr, int m, float* out, float* nxt,
                     float* hook, float* jmp, int* ctl, int* total, int np,
                     const int* offs, int n_offs, void* stream) {
  if (bad_shape(np, 1, n_offs) || hook == nullptr || jmp == nullptr ||
      nxt == nullptr || !staged_ok(np, {lab, out}))
    return (int)cudaErrorInvalidValue;
  CompArgs a{};
  a.geo = make_geo(bits, rem_ptr, rem_nbr, m, np, 1, 1, offs, n_offs);
  a.in = lab;
  a.out = out;
  a.tmp = nxt;
  a.ctl = ctl;
  a.total = total;
  a.inner = 1;
  a.planes = 1;
  a.member = member;
  a.hook = hook;
  a.jmp = jmp;
  return launch_relax(components_relax_kernel, a, (cudaStream_t)stream);
}

// s [k, nf] float32 (1 <= nf <= kMaxSumFields) or, with is_int, [k] int32;
// p [k] int32 or (p64) int64 targets. loop = 1 runs up to `rounds` rounds
// of s <- s + added, p <- p[p] over k == n_out cells into out [k, nf]
// (tmp [k, nf] and pbuf [2k] scratch); loop = 0 writes one round's sums
// for n_out targets into out [n_out, nf]. Scratch: cnt [2 n_out] and cur
// [n_out] zeroed, offl [n_out], list [k], vbuf [k, nf] float32, bsum
// [kMaxAccGrid];
// ctl [4] zeroed.
int accumulate(const void* s, const void* p, int p64, int k, int n_out,
               int nf, int is_int, int rounds, int loop, int stop_at_sink,
               void* out, void* tmp, int* pbuf, int* cnt, int* offl,
               int* cur, int* list, float* vbuf, int* bsum, int* ctl,
               int* total, void* stream) {
  if (k < 0 || n_out < 1 || nf < 1 || nf > kMaxSumFields || rounds < 0 ||
      (loop && (k != n_out || tmp == nullptr || pbuf == nullptr)) ||
      (is_int && (nf != 1 || !loop)) || (k > 0 && (s == nullptr || p == nullptr)) ||
      out == nullptr || cnt == nullptr || ctl == nullptr ||
      (!is_int && (offl == nullptr || cur == nullptr || list == nullptr ||
                   vbuf == nullptr || bsum == nullptr)))
    return (int)cudaErrorInvalidValue;
  AccArgs a{s, p, p64, k, n_out, nf, rounds, loop, stop_at_sink, out, tmp,
            pbuf, cnt, offl, cur, list, vbuf, bsum, ctl, total};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_int) return launch_accumulate(accumulate_relax_count_kernel, a, st);
  switch (nf) {
    case 1: return launch_accumulate(accumulate_relax_kernel<1>, a, st);
    case 2: return launch_accumulate(accumulate_relax_kernel<2>, a, st);
    case 3: return launch_accumulate(accumulate_relax_kernel<3>, a, st);
    default: return launch_accumulate(accumulate_relax_kernel<4>, a, st);
  }
}

// The erosion stencils (one thread a cell, no grid barrier). Planes are
// [np]; ocean and valid uint8 0/1; bdist [np, n_offs] band edge lengths;
// the remainder CSR with rdist [m], its edge lengths in CSR order.
// thermal_shed writes out [2, np] (shed, share).
int thermal_shed(const float* elev, const uint8_t* ocean, const uint8_t* valid,
                 const uint32_t* bits, const float* bdist, const int* rem_ptr,
                 const int* rem_nbr, const float* rdist, int m, float* out,
                 int np, const int* offs, int n_offs, float talus, float k,
                 void* stream) {
  if (bad_shape(np, 1, n_offs)) return (int)cudaErrorInvalidValue;
  ThermalArgs a{elev, ocean, valid, bits, bdist, rem_ptr, rem_nbr, rdist,
                nullptr, nullptr, out, rem_csr_m(rem_ptr, rem_nbr, m), np,
                talus, k, make_bands(offs, n_offs)};
  return launch_cells(thermal_shed_kernel, a, np, (cudaStream_t)stream);
}

// shed, share: thermal_shed's planes; out [np] the new elevation.
int thermal_receive(const float* elev, const uint8_t* ocean,
                    const uint8_t* valid, const uint32_t* bits,
                    const float* bdist, const int* rem_ptr, const int* rem_nbr,
                    const float* rdist, int m, const float* shed,
                    const float* share, float* out, int np, const int* offs,
                    int n_offs, float talus, void* stream) {
  if (bad_shape(np, 1, n_offs)) return (int)cudaErrorInvalidValue;
  ThermalArgs a{elev, ocean, valid, bits, bdist, rem_ptr, rem_nbr, rdist,
                shed, share, out, rem_csr_m(rem_ptr, rem_nbr, m), np,
                talus, 0.0f, make_bands(offs, n_offs)};
  return launch_cells(thermal_receive_kernel, a, np, (cudaStream_t)stream);
}

// valid and gidx may be null; target, ptr [np] int32; n_total the sink.
int ice_argmin(const float* elev, const uint8_t* ocean, const uint8_t* valid,
               const float* glac, const int* gidx, const uint32_t* bits,
               const int* rem_ptr, const int* rem_nbr, int m, int* target,
               int* ptr, int np, int n_total, const int* offs, int n_offs,
               void* stream) {
  if (bad_shape(np, 1, n_offs) || n_total < 1)
    return (int)cudaErrorInvalidValue;
  IceArgs a{elev, ocean, valid, glac, gidx, bits, rem_ptr, rem_nbr, target,
            ptr, rem_csr_m(rem_ptr, rem_nbr, m), np, n_total,
            make_bands(offs, n_offs)};
  return launch_cells(ice_argmin_kernel, a, np, (cudaStream_t)stream);
}

// p06, p03, p04, p05: torch.pow(flow, 0.6 / 0.3 / 0.4 / 0.5); gidx may be
// null; out [np] the new elevation.
int glacial_stencil(const float* elev, const uint8_t* ocean,
                    const uint8_t* valid, const float* glac, const float* flow,
                    const int* target, const int* gidx, const float* p06,
                    const float* p03, const float* p04, const float* p05,
                    const uint32_t* bits, const float* bdist,
                    const int* rem_ptr, const int* rem_nbr, const float* rdist,
                    int m, float* out, int np, const int* offs, int n_offs,
                    float c_deep, float c_mor, float c_trib, float c_fjord,
                    float strength, void* stream) {
  if (bad_shape(np, 1, n_offs)) return (int)cudaErrorInvalidValue;
  GlacialArgs a{elev, ocean, valid, glac, flow, target, gidx, p06, p03, p04,
                p05, bits, bdist, rem_ptr, rem_nbr, rdist, out,
                rem_csr_m(rem_ptr, rem_nbr, m), np, c_deep, c_mor, c_trib,
                c_fjord, strength, make_bands(offs, n_offs)};
  return launch_cells(glacial_stencil_kernel, a, np, (cudaStream_t)stream);
}

// The cached launch plans (the last kPlanSlots), kPlanFields ints each:
// kernel (ops/sweep_cuda.py PLAN_KERNELS: 0 bfs, 1 flood, 2 stress,
// 3 warp, 4 smooth, 5 shadow, 6 components), NP, item groups, windows per
// item, H, T, T before the window cap, grid, dynamic shared bytes. Writes
// at most max_plans rows; returns the count. For measurement only.
int relax_plans(int* out, int max_plans) {
  const void* kerns[] = {(const void*)bfs_relax_kernel,
                         (const void*)flood_relax_kernel,
                         (const void*)stress_relax_kernel,
                         (const void*)warp_relax_kernel,
                         (const void*)smooth_relax_kernel<1>,
                         (const void*)smooth_relax_kernel<2>,
                         (const void*)smooth_relax_kernel<3>,
                         (const void*)smooth_relax_kernel<4>,
                         (const void*)shadow_relax_kernel,
                         (const void*)components_relax_kernel};
  const int kinds[] = {0, 1, 2, 3, 4, 4, 4, 4, 5, 6};
  constexpr int n_kerns = sizeof kinds / sizeof kinds[0];
  std::lock_guard<std::mutex> lock(g_plan_mu);
  const int n = std::min(std::min(g_plan_count, kPlanSlots), max_plans);
  for (int k = 0; k < n; ++k) {
    const Plan& p = g_plans[k];
    int kind = -1;
    for (int i = 0; i < n_kerns; ++i)
      if (kerns[i] == p.kern) kind = kinds[i];
    const int row[kPlanFields] = {kind, p.np,     p.ng,   p.nw,      p.H,
                                  p.T,  p.t_free, p.grid, (int)p.smem};
    std::copy(row, row + kPlanFields, out + kPlanFields * k);
  }
  return n;
}

// The capped launches (launch_relax) the calling thread made since its
// last call, for the port's stage spans: a host counter, no sync.
int take_capped_launches() {
  const int n = g_capped_launches;
  g_capped_launches = 0;
  return n;
}

}  // extern "C"
