// A CPU stand-in for the CUDA runtime and device built-ins, enough to
// compile a kernel source with g++ and run its blocks on the calling host
// thread: each CUDA thread of a block is a fiber (ucontext) with a stack
// of its own, and a barrier per block (__syncthreads) and per warp (the
// warp-collective instructions) switches a fiber that waits back to the
// block's scheduler, which resumes the block's fibers in turn until all
// have returned (main.cpp).  Blocks run one after another; dynamic shared
// memory is a host buffer filled with 0xff (bf16 NaN) before each block,
// so a read of anything not written shows.  For tests of index logic
// only: no timing, no asynchrony (cp.async copies at once), and the f32
// sums of mma run in double.  A fault (a shared-memory access out of
// range, a misaligned copy, a barrier some threads never reach) is
// recorded, the access skipped, and the launch's cudaGetLastError()
// reports it.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
// the first fault of the current launch, if any (main.cpp)
bool emu_take_fault();
void emu_fault(const char* what);
inline cudaError_t cudaGetLastError() { return emu_take_fault() ? 1 : 0; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "emulated fault" : "no error"; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }

// A barrier of ``count`` fibers of one block: the last to arrive moves the
// generation on and goes on; the others switch back to the scheduler until
// the generation has moved (main.cpp).
struct EmuBarrier {
  int count, arrived = 0;
  unsigned gen = 0;
  explicit EmuBarrier(int n) : count(n) {}
  void arrive_and_wait();
};
struct EmuWarp {
  EmuBarrier bar{32};
  const void* addr[32];
  uint32_t a[32][4], b[32][2];
  float f[32];
  int i[32];
};
struct EmuBlock {
  std::unique_ptr<EmuBarrier> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  uint8_t* smem = nullptr;
  size_t smem_size = 0;
};
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
extern thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
// a thread's index in its block, x fastest
inline int emu_tid() {
  return (int)(threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z));
}
inline EmuWarp& emu_warp() { return *emu_block->warps[emu_tid() >> 5]; }
inline uint8_t* emu_dyn_smem() { return emu_block->smem; }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  EmuWarp& w = emu_warp();
  const int l = emu_tid() & 31;
  w.f[l] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ m];
  w.bar.arrive_and_wait();
  return r;
}
inline bool __any_sync(unsigned, bool p) {
  EmuWarp& w = emu_warp();
  const int l = emu_tid() & 31;
  w.i[l] = p;
  w.bar.arrive_and_wait();
  bool r = false;
  for (int k = 0; k < 32; ++k) r = r || w.i[k];
  w.bar.arrive_and_wait();
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) {
  return (const uint8_t*)p - emu_block->smem;
}
// whether [p, p + bytes) lies in the block's shared memory; a fault if not
bool emu_check_smem(const void* p, size_t bytes, const char* what);

// the dynamic shared memory the last launch asked for
extern size_t emu_launch_smem;

// run ``body(arg)`` as every thread of one block, each a fiber (main.cpp)
void emu_run_block(int threads, void (*body)(void*), void* arg, dim3 block_idx,
                   EmuBlock* blk);

// kernel<<<grid, block, smem, stream>>>(args...), block by block
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  emu_launch_smem = smem;
  blockDim = block;
  const int threads = (int)(block.x * block.y * block.z);
  gridDim = grid;
  std::vector<uint8_t> buf(smem + 64);
  auto run = [&] { kernel(args...); };
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuBlock blk;
        blk.bar = std::make_unique<EmuBarrier>(threads);
        for (int w = 0; w < (threads + 31) / 32; ++w)
          blk.warps.push_back(std::make_unique<EmuWarp>());
        std::memset(buf.data(), 0xff, buf.size());
        blk.smem = (uint8_t*)(((uintptr_t)buf.data() + 15) & ~(uintptr_t)15);
        blk.smem_size = smem;
        emu_run_block(threads, [](void* f) { (*(decltype(run)*)f)(); }, &run,
                      dim3(x, y, z), &blk);
      }
}
