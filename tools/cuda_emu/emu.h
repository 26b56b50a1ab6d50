// CPU emulation of the CUDA subset csrc/sweeps.cu uses: every CUDA thread
// is an OS thread; barriers, shuffles and shared memory are emulated.
#pragma once
#include <pthread.h>
#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorCooperativeLaunchTooLarge = 720 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int emu_nsm() { const char* e = getenv("EMU_NSM"); return e ? atoi(e) : 2; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = emu_nsm(); return 0; }
inline int cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) {
  const char* e = getenv("EMU_PER_SM"); *n = e ? atoi(e) : 1; return 0; }
inline int cudaGetLastError() { return 0; }

using std::isfinite;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long min(long a, long b) { return a < b ? a : b; }
inline long max(long a, long b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }

struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::barrier<>*> wbar;
  std::vector<std::array<uint64_t, 32>> slots;
  std::atomic<int> orv[3];
  std::vector<char> dyn;
  std::map<int, std::vector<char>> shared;
  std::mutex mu;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_blk;
inline thread_local int emu_orc = 0;
inline std::barrier<>* emu_grid_bar;

template <class T> T& emu_shared(int key) {
  std::lock_guard<std::mutex> l(emu_blk->mu);
  auto& v = emu_blk->shared[key];
  if (v.empty()) v.assign(sizeof(T) + 16, 0);
  return *reinterpret_cast<T*>(v.data());
}
inline float* emu_dyn_shared() { return reinterpret_cast<float*>(emu_blk->dyn.data()); }

inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  const int c = emu_orc++ % 3;
  if (threadIdx.x == 0) emu_blk->orv[(c + 1) % 3] = 0;
  if (p) emu_blk->orv[c] |= 1;
  emu_blk->bar->arrive_and_wait();
  return emu_blk->orv[c].load();
}
inline int emu_lane() { return threadIdx.x & 31; }
inline std::barrier<>* emu_wbar() { return emu_blk->wbar[threadIdx.x >> 5]; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wbar()->arrive_and_wait(); }
template <class T> T emu_xchg(T v, int src) {
  auto& s = emu_blk->slots[threadIdx.x >> 5];
  uint64_t w = 0; memcpy(&w, &v, sizeof(T));
  s[emu_lane()] = w;
  emu_wbar()->arrive_and_wait();
  uint64_t r = s[src & 31];
  emu_wbar()->arrive_and_wait();
  T out; memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_xchg(v, src); }
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int l = emu_lane();
  T o = emu_xchg(v, l >= d ? l - d : l);
  return o;
}
inline unsigned __ballot_sync(unsigned, int p) {
  auto& s = emu_blk->slots[threadIdx.x >> 5];
  s[emu_lane()] = p ? 1 : 0;
  emu_wbar()->arrive_and_wait();
  unsigned b = 0;
  for (int l = 0; l < 32; ++l) if (s[l]) b |= 1u << l;
  emu_wbar()->arrive_and_wait();
  return b;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *(volatile const T*)p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return old;
}

namespace cooperative_groups {
struct grid_group { void sync() { emu_grid_bar->arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}

template <class A> struct EmuCall { void (*kern)(A); A a; EmuBlock* blk; unsigned bx, tx; };
template <class A> void* emu_thread(void* p) {
  auto* c = static_cast<EmuCall<A>*>(p);
  threadIdx = dim3(c->tx); blockIdx = dim3(c->bx); emu_blk = c->blk; emu_orc = 0;
  c->kern(c->a);
  return nullptr;
}
template <class A>
int emu_launch(void (*kern)(A), dim3 grid, dim3 block, void** args, size_t smem, cudaStream_t) {
  const A a = *static_cast<A*>(args[0]);
  gridDim = grid; blockDim = block;
  const int nb = grid.x, nt = block.x;
  emu_grid_bar = new std::barrier<>(nb * nt);
  std::vector<EmuBlock*> blks;
  for (int b = 0; b < nb; ++b) {
    auto* e = new EmuBlock();
    e->bar = new std::barrier<>(nt);
    for (int w = 0; w < (nt + 31) / 32; ++w) e->wbar.push_back(new std::barrier<>(32));
    e->slots.resize((nt + 31) / 32);
    for (auto& o : e->orv) o = 0;
    e->dyn.assign(smem + 64, 0);
    blks.push_back(e);
  }
  std::vector<EmuCall<A>> calls(nb * nt);
  std::vector<pthread_t> th(nb * nt);
  pthread_attr_t at; pthread_attr_init(&at); pthread_attr_setstacksize(&at, 512 * 1024);
  for (int b = 0; b < nb; ++b)
    for (int t = 0; t < nt; ++t) {
      auto& c = calls[b * nt + t];
      c = EmuCall<A>{kern, a, blks[b], (unsigned)b, (unsigned)t};
      if (pthread_create(&th[b * nt + t], &at, emu_thread<A>, &c)) abort();
    }
  for (auto& t : th) pthread_join(t, nullptr);
  for (auto* e : blks) { delete e->bar; for (auto* w : e->wbar) delete w; delete e; }
  delete emu_grid_bar;
  return 0;
}
