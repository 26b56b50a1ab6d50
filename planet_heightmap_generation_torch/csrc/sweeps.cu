// Banded neighbour-sweep kernels for Hopper (sm_90a), one synchronous
// (Jacobi) sweep per launch.
//
// The mesh's adjacency is "banded" (mesh/build.py): neighbour j of cell i
// sits at j = i + off[d] for one of D <= 32 signed offsets, and bit d of
// bits[i] says whether that band edge exists. A sweep reads every band
// neighbour of a cell from the INPUT buffer and writes the cell's new value
// to a separate OUTPUT buffer, so the result does not depend on the order in
// which blocks run: each kernel equals its plain-torch version in
// ops/sweep_cuda.py bit for bit, and equals one iteration of the JAX jnp
// loop it replaces. The few remainder edges outside the bands are applied
// by the Python driver after each launch, as torch scatters on [M].
//
// What bounds these kernels on an H100: memory traffic, never arithmetic.
// The least a launch must move is its state and auxiliary planes read
// once, the packed u32 band bits read once and the state written once: at
// 204K cells ~10 MB for the 4-field BFS, ~3 us at 3.35 TB/s. The band
// reads at i+off come from L2 (the largest |off| is ~3.6*sqrt(N) cells,
// so a block's band window is a few hundred KB), but a warp loops over all
// D bands and issues a band's load whenever any of its 32 lanes has that
// bit, so it touches up to D neighbour lines per field where a cell needs
// ~6: that L2 traffic, not HBM, sets the device time, a few times the HBM
// bound (PERF.md has the measured times). Either is small beside the host
// cost of one sweep in the Python driver loop. The design keeps each
// kernel simple and synchronous (one bit test per band, no shared memory,
// coalesced reads of consecutive cells); several sweeps per launch and
// fewer band loads per warp are later work.
//
// Reads off the mesh: a set band bit always points inside [0, NP), but the
// index is still wrapped modulo NP (jnp.roll semantics) so no thread can
// read out of bounds.
//
// Change flag: every kernel ORs "some cell changed" into *flag (one
// atomicOr per block after a block-level OR) when flag is not null.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps a*b+c as two rounded
// operations, as torch evaluates it, so the warp distances match bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBands = 32;
constexpr int kThreads = 256;

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

// ── 1. BFS / components: min-plus relaxation ───────────────────────────
// Replaces _make_bfs_kernel (planet_heightmap_generation_tpu/ops/
// sweep_pallas.py:171). One thread per (field, cell):
//   out = min(cur, min_{d: bit d} cur[f, i + off_d] + cost[f, i]).
// Seeds (cur = 0) and barriers (cost = +inf) are baked into the inputs.
// With cost = 0 and cell-index labels it is one min-label sweep of the
// connected-components core.
__global__ void __launch_bounds__(kThreads)
bfs_sweep_kernel(const float* __restrict__ cur, const float* __restrict__ cost,
                 const uint32_t* __restrict__ bits, float* __restrict__ out,
                 int* flag, int np, int nf, Bands bands) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  bool changed = false;
  if (t < nf * np) {
    const int f = t / np;
    const int i = t - f * np;
    const float* row = cur + (size_t)f * np;
    const uint32_t b = bits[i];
    float best = INFINITY;
    for (int d = 0; d < bands.n; ++d) {
      if ((b >> d) & 1u) best = fminf(best, row[wrap(i + bands.off[d], np)]);
    }
    const float c = cur[t];
    const float v = fminf(c, best + cost[t]);
    out[t] = v;
    changed = v != c;
  }
  or_flag(flag, changed);
}

// ── 2. Stress propagation: gated argmax with payload ───────────────────
// Replaces _make_stress_kernel (sweep_pallas.py:388). State planes
// [4, NP]: st, sf, act (0/1), ocean (0/1, static). A band neighbour sends
// prop = st * (sf > 0.5 ? sub_decay : decay) when it is active, not ocean
// and prop >= 0.005; the cell keeps the first strict maximum in band order
// and adopts it (with the sender's sf) if it beats its own st.
__global__ void __launch_bounds__(kThreads)
stress_sweep_kernel(const float* __restrict__ s, const uint32_t* __restrict__ bits,
                    float* __restrict__ out, int* flag, int np, Bands bands,
                    float decay, float sub_decay) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool changed = false;
  if (i < np) {
    const float* st = s;
    const float* sf = s + np;
    const float* act = s + 2 * (size_t)np;
    const float* oc = s + 3 * (size_t)np;
    const uint32_t b = bits[i];
    float best = -INFINITY;
    float bsf = 0.0f;
    for (int d = 0; d < bands.n; ++d) {
      if (!((b >> d) & 1u)) continue;
      const int j = wrap(i + bands.off[d], np);
      const float nsf = sf[j];
      const float prop = st[j] * (nsf > 0.5f ? sub_decay : decay);
      const bool ok = act[j] > 0.0f && oc[j] <= 0.0f && prop >= 0.005f;
      if (ok && prop > best) {
        best = prop;
        bsf = nsf;
      }
    }
    const float st0 = st[i];
    const bool upd = best > st0;
    out[i] = upd ? best : st0;
    out[np + i] = upd ? bsf : sf[i];
    out[2 * (size_t)np + i] = upd ? 1.0f : act[i];
    out[3 * (size_t)np + i] = oc[i];
    changed = upd;
  }
  or_flag(flag, changed);
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

// ── 4. Priority-flood ε-fill ───────────────────────────────────────────
// Replaces _make_flood_kernel (sweep_pallas.py:230). Inland-sea cells
// present `big` to their neighbours; frozen cells are baked in through
// elev_baked (= their surface), so min(surf, cand) keeps them:
//   out = min(surf, max(elev_baked, min_{d} surf'[i + off_d] + eps)).
__global__ void __launch_bounds__(kThreads)
flood_sweep_kernel(const float* __restrict__ surf, const float* __restrict__ inland,
                   const float* __restrict__ elev_baked,
                   const uint32_t* __restrict__ bits, float* __restrict__ out,
                   int* flag, int np, Bands bands, float big, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool changed = false;
  if (i < np) {
    const uint32_t b = bits[i];
    float best = INFINITY;
    for (int d = 0; d < bands.n; ++d) {
      if (!((b >> d) & 1u)) continue;
      const int j = wrap(i + bands.off[d], np);
      best = fminf(best, inland[j] > 0.0f ? big : surf[j]);
    }
    const float c = surf[i];
    const float v = fminf(c, fmaxf(elev_baked[i], best + eps));
    out[i] = v;
    changed = v != c;
  }
  or_flag(flag, changed);
}

Bands make_bands(const int* offs, int n_offs) {
  Bands b;
  b.n = n_offs;
  for (int d = 0; d < kMaxBands; ++d) b.off[d] = d < n_offs ? offs[d] : 0;
  return b;
}

int blocks_for(long total) { return (int)((total + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// right after its launch; 0 means the launch was accepted.
extern "C" {

int bfs_sweep(const float* cur, const float* cost, const uint32_t* bits,
              float* out, int* flag, int np, int nf, const int* offs,
              int n_offs, void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  bfs_sweep_kernel<<<blocks_for((long)nf * np), kThreads, 0,
                     (cudaStream_t)stream>>>(cur, cost, bits, out, flag, np,
                                             nf, make_bands(offs, n_offs));
  return (int)cudaGetLastError();
}

int stress_sweep(const float* state, const uint32_t* bits, float* out,
                 int* flag, int np, const int* offs, int n_offs, float decay,
                 float sub_decay, void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  stress_sweep_kernel<<<blocks_for(np), kThreads, 0, (cudaStream_t)stream>>>(
      state, bits, out, flag, np, make_bands(offs, n_offs), decay, sub_decay);
  return (int)cudaGetLastError();
}

int warp_sweep(const float* state, const float* w, const uint32_t* bits,
               float* out, int* flag, int np, const int* offs, int n_offs,
               void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  warp_sweep_kernel<<<blocks_for(np), kThreads, 0, (cudaStream_t)stream>>>(
      state, w, bits, out, flag, np, make_bands(offs, n_offs));
  return (int)cudaGetLastError();
}

int flood_sweep(const float* surf, const float* inland,
                const float* elev_baked, const uint32_t* bits, float* out,
                int* flag, int np, const int* offs, int n_offs, float big,
                float eps, void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  flood_sweep_kernel<<<blocks_for(np), kThreads, 0, (cudaStream_t)stream>>>(
      surf, inland, elev_baked, bits, out, flag, np,
      make_bands(offs, n_offs), big, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
