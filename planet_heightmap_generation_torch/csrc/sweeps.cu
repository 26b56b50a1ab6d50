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
// by the Python sweep loop after each launch, as torch scatters on [M], for
// the four min/argmin kernels (1-4), whose result does not depend on the
// order of its terms; the two summing kernels (5-6) walk them in-kernel
// from a CSR, in edge order (see "Remainder edges as CSR rows").
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
// Change flag: kernels 1-4 OR "some cell changed" into *flag (one
// atomicOr per block after a block-level OR) when flag is not null; the
// smoothing and rain-shadow passes run a fixed count and have none.
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

// ── Remainder edges as CSR rows ────────────────────────────────────────
// The two climate kernels below SUM over neighbours, and a sum is not
// order-free: the remainder edges (the ~0.5 % of edges outside the bands)
// are walked inside the kernel, after the bands, from a CSR whose rows keep
// the edges' original order (ops/banded.py rem_csr: a stable sort by
// destination cell). That reproduces the JAX jnp order
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

// ── 5. Laplacian smoothing pass ────────────────────────────────────────
// Replaces _make_smooth_kernel (sweep_pallas.py:564). One thread per
// (field, cell), the jnp semantics of ops/banded.py _smooth_field_jnp /
// _smooth_masked_jnp and climate/temperature.py _diffuse_warmth_jnp:
//   s   = sum over band neighbours j (in band order, from 0.0), then the
//         remainder neighbours (in edge order), of f[j] — counting only
//         neighbours with gate[j] > 0 when gate is given;
//   out = (f[i] + s) / c[i]          where upd is null or upd[i] > 0,
//   out = f[i]                       elsewhere.
// c = 1 + degree (or 1 + the number of gated neighbours) comes in as a
// plane. The division is IEEE-rounded (no fast math), as torch's is; the
// Pallas kernel multiplied by a precomputed 1/c instead.
// Masked smoothing passes gate = upd = mask; the frozen-cell restore of the
// ocean-warmth diffusion passes gate = null, upd = not frozen.
// Bound: bytes. An F=2 pass at 204K reads the field, c, bits and the CSR
// once and writes the field: ~5.7 MB, ~1.7 us at 3.35 TB/s.
__global__ void __launch_bounds__(kThreads)
smooth_sweep_kernel(const float* __restrict__ f, const float* __restrict__ c,
                    const float* __restrict__ gate,
                    const float* __restrict__ upd,
                    const uint32_t* __restrict__ bits,
                    const int* __restrict__ rptr, const int* __restrict__ rnbr,
                    int m, float* __restrict__ out, int np, int nf,
                    Bands bands) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nf * np) return;
  const int fi = t / np;
  const int i = t - fi * np;
  const float* row = f + (size_t)fi * np;
  const uint32_t b = bits[i];
  float s = 0.0f;
  for (int d = 0; d < bands.n; ++d) {
    if (!((b >> d) & 1u)) continue;
    const int j = wrap(i + bands.off[d], np);
    if (gate == nullptr || gate[j] > 0.0f) s += row[j];
  }
  const int k1 = row_end(rptr, i, m);
  for (int k = row_begin(rptr, i, m); k < k1; ++k) {
    const int j = rnbr[k];
    if (j < 0 || j >= np) continue;
    if (gate == nullptr || gate[j] > 0.0f) s += row[j];
  }
  const float fv = row[i];
  out[t] = (upd == nullptr || upd[i] > 0.0f) ? (fv + s) / c[i] : fv;
}

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

int smooth_sweep(const float* field, const float* c, const float* gate,
                 const float* upd, const uint32_t* bits, const int* rem_ptr,
                 const int* rem_nbr, int m, float* out, int np, int nf,
                 const int* offs, int n_offs, void* stream) {
  if (n_offs < 0 || n_offs > kMaxBands) return (int)cudaErrorInvalidValue;
  smooth_sweep_kernel<<<blocks_for((long)nf * np), kThreads, 0,
                        (cudaStream_t)stream>>>(
      field, c, gate, upd, bits, rem_ptr, rem_nbr, m, out, np, nf,
      make_bands(offs, n_offs));
  return (int)cudaGetLastError();
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
