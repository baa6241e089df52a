// CPU emulation of the CUDA subset used by ofps_torch/csrc, for the tests
// in test_torch_kernels_emulated.py: the kernel sources compile with g++
// against this header and run on CPU tensors.  Each CUDA thread of a block
// is a fiber (ucontext) on the calling OS thread; blocks run one after
// another, so a `__shared__` variable (static here) is shared by the
// threads of the running block.  A fiber runs until it reaches
// __syncthreads or __syncwarp (the warp shuffles sync twice), then the
// next one runs; a barrier opens when every thread of its block or warp
// has reached it.  One OS thread and a fixed order: a launch is
// deterministic and does not compete for cores.  It checks the kernels'
// indexing, halos, passes, argmin order and grid reduction; the CUDA
// compiler and the card stay untested.
#pragma once
#include <math.h>

#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

using std::max;
using std::min;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 {
  unsigned x, y, z;
};
// The running fiber's indices, set before each fiber resumes.
inline emu_uint3 threadIdx, blockIdx;
inline int emu_tid;

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static

template <class T>
T __ldg(const T* p) { return *p; }

struct __nv_bfloat16 {
  uint16_t bits;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

enum { EMU_RUNNABLE = 0, EMU_AT_BLOCK = 1, EMU_AT_WARP = 2, EMU_DONE = 3 };
struct EmuFiber {
  ucontext_t ctx;
  int state = EMU_RUNNABLE;
};
inline ucontext_t emu_scheduler;
inline std::vector<EmuFiber> emu_fibers;
inline std::function<void()> emu_body;  // the kernel call of the launch
inline char* emu_dyn_smem = nullptr;  // the block's dynamic shared memory
inline uint64_t emu_lanes[64][32];

inline void emu_wait(int state) {
  EmuFiber& f = emu_fibers[emu_tid];
  f.state = state;
  swapcontext(&f.ctx, &emu_scheduler);
}
inline void __syncthreads() { emu_wait(EMU_AT_BLOCK); }
inline void __syncwarp() { emu_wait(EMU_AT_WARP); }

inline float atomicAdd(float* p, float v) {
  const float old = *p;
  *p = old + v;
  return old;
}
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}

inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// Value of `v` in lane `src` of the calling thread's warp.
template <class T>
T emu_from_lane(T v, int src) {
  const int warp = emu_tid / 32, lane = emu_tid % 32;
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  emu_lanes[warp][lane] = bits;
  __syncwarp();
  bits = emu_lanes[warp][src];
  __syncwarp();
  T out;
  memcpy(&out, &bits, sizeof(T));
  return out;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) { return emu_from_lane(v, (emu_tid % 32) ^ mask); }
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = emu_tid % 32;
  return emu_from_lane(v, lane >= d ? lane - d : lane);
}
template <class T>
T __shfl_sync(unsigned, T v, int src) { return emu_from_lane(v, src); }
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned out = 0;
  for (int i = 0; i < 32; ++i) out |= unsigned(emu_from_lane<int>(pred != 0, i)) << i;
  return out;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// The warp's sum in one exchange (the lanes' values written, then read).
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const int warp = emu_tid / 32;
  emu_lanes[warp][emu_tid % 32] = v;
  __syncwarp();
  unsigned sum = 0;
  for (int i = 0; i < 32; ++i) sum += (unsigned)emu_lanes[warp][i];
  __syncwarp();
  return sum;
}

inline void emu_fiber_entry() {
  emu_body();
  emu_fibers[emu_tid].state = EMU_DONE;  // returns to uc_link, the scheduler
}

// Runs the n fibers of one block until all are done: round robin over the
// runnable ones; when none is, the warps whose threads all wait at
// __syncwarp are released, else, when every thread waits at
// __syncthreads, all of them.
inline void emu_run_block(int n, dim3 block) {
  for (;;) {
    bool ran = false;
    for (int t = 0; t < n; ++t) {
      if (emu_fibers[t].state != EMU_RUNNABLE) continue;
      emu_tid = t;
      threadIdx = {unsigned(t % block.x), unsigned(t / block.x % block.y),
                   unsigned(t / (block.x * block.y))};
      swapcontext(&emu_scheduler, &emu_fibers[t].ctx);
      ran = true;
    }
    if (ran) continue;
    int done = 0, at_block = 0;
    bool released = false;
    for (int w = 0; w < (n + 31) / 32; ++w) {
      const int lo = 32 * w, hi = std::min(n, lo + 32);
      bool all = true;
      for (int t = lo; t < hi; ++t) all &= emu_fibers[t].state == EMU_AT_WARP;
      if (all) {
        for (int t = lo; t < hi; ++t) emu_fibers[t].state = EMU_RUNNABLE;
        released = true;
      }
    }
    if (released) continue;
    for (int t = 0; t < n; ++t) {
      done += emu_fibers[t].state == EMU_DONE;
      at_block += emu_fibers[t].state == EMU_AT_BLOCK;
    }
    if (done == n) return;
    if (at_block != n) {
      fprintf(stderr, "cuda_cpu_emu: barrier deadlock (%d done, %d at __syncthreads of %d)\n",
              done, at_block, n);
      abort();
    }
    for (int t = 0; t < n; ++t) emu_fibers[t].state = EMU_RUNNABLE;
  }
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// emu_launch(kernel, grid, block, smem, stream, args...).
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  const int n = block.x * block.y * block.z;
  constexpr size_t kStack = 64 * 1024;
  std::vector<char> stacks(size_t(n) * kStack);
  emu_fibers.assign(n, EmuFiber());
  emu_body = [&]() { kernel(args...); };
  // Unwritten shared memory reads as large floats, not zeros.
  std::vector<char> dyn(smem + 16, 0x7f);
  emu_dyn_smem = dyn.data() + (16 - reinterpret_cast<uintptr_t>(dyn.data()) % 16) % 16;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = {bx, by, bz};
        for (int t = 0; t < n; ++t) {
          EmuFiber& f = emu_fibers[t];
          f.state = EMU_RUNNABLE;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = stacks.data() + size_t(t) * kStack;
          f.ctx.uc_stack.ss_size = kStack;
          f.ctx.uc_link = &emu_scheduler;
          makecontext(&f.ctx, emu_fiber_entry, 0);
        }
        emu_run_block(n, block);
      }
}
