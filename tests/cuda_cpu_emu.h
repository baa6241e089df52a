// CPU emulation of the CUDA subset used by ofps_torch/csrc, for the tests
// in test_torch_kernels_emulated.py: the kernel sources compile with g++
// against this header and run on CPU tensors.  One std::thread per CUDA
// thread of a block; blocks run one after another, so a `__shared__`
// variable (static here) is shared by the threads of the running block.
// __syncthreads, __syncwarp and the warp shuffles are barriers between
// those threads.  It checks the kernels' indexing, halos, passes, argmin
// order and grid reduction; the CUDA compiler and the card stay untested.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
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
inline thread_local emu_uint3 threadIdx, blockIdx;
inline thread_local int emu_tid;

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

inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline char* emu_dyn_smem = nullptr;  // the block's dynamic shared memory
inline std::mutex emu_atomic_mutex;
inline uint64_t emu_lanes[64][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_barriers[emu_tid / 32]->arrive_and_wait(); }

inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const float old = *p;
  *p = old + v;
  return old;
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

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// emu_launch(kernel, grid, block, smem, stream, args...).
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  const int n = block.x * block.y * block.z;
  std::barrier<> block_barrier(n);
  emu_block_barrier = &block_barrier;
  emu_warp_barriers.clear();
  for (int i = 0; i < (n + 31) / 32; ++i)
    emu_warp_barriers.emplace_back(new std::barrier<>(std::min(32, n - 32 * i)));
  // Unwritten shared memory reads as large floats, not zeros.
  std::vector<char> dyn(smem + 16, 0x7f);
  emu_dyn_smem = dyn.data() + (16 - reinterpret_cast<uintptr_t>(dyn.data()) % 16) % 16;
  std::vector<std::thread> threads;
  for (int t = 0; t < n; ++t) {
    threads.emplace_back([&, t]() {
      emu_tid = t;
      threadIdx = {unsigned(t % block.x), unsigned(t / block.x % block.y),
                   unsigned(t / (block.x * block.y))};
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = {bx, by, bz};
            kernel(args...);
            block_barrier.arrive_and_wait();
          }
    });
  }
  for (auto& t : threads) t.join();
}
