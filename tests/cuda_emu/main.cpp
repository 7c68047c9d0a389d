// The emulation's globals and its fibers (see cuda_runtime.h).
#include <sys/mman.h>
#include <ucontext.h>

#include <atomic>
#include <string>

#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local EmuBlock* emu_block;
size_t emu_launch_smem;

// The fibers of the block being run, on the host thread that runs it: their
// contexts and stacks (kept from block to block and launch to launch), which
// have returned, the one running, and the arrivals at barriers so far (the
// scheduler's measure of progress).
namespace {
constexpr size_t kStack = 256 << 10;  // a fiber's stack, below a guard page
constexpr size_t kGuard = 4096;
struct Fibers {
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
  std::vector<uint8_t*> stacks;
  std::vector<uint8_t> done;
  int current = 0;
  long progress = 0;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
};
thread_local Fibers fibers;

void fiber_main() {
  Fibers& f = fibers;
  f.body(f.arg);
  f.done[f.current] = 1;
  ++f.progress;
}  // returns to the scheduler (uc_link)
}  // namespace

void EmuBarrier::arrive_and_wait() {
  Fibers& f = fibers;
  const unsigned g = gen;
  ++f.progress;
  if (++arrived == count) {
    arrived = 0;
    ++gen;
    return;
  }
  while (gen == g) swapcontext(&f.ctx[f.current], &f.sched);
}

void emu_run_block(int threads, void (*body)(void*), void* arg, dim3 block_idx,
                   EmuBlock* blk) {
  Fibers& f = fibers;
  while ((int)f.stacks.size() < threads) {
    void* p = mmap(nullptr, kStack + kGuard, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      emu_fault("no memory for a fiber's stack");
      return;
    }
    mprotect(p, kGuard, PROT_NONE);  // an overflow faults, not corrupts
    f.stacks.push_back((uint8_t*)p);
  }
  f.ctx.resize(threads);
  f.done.assign(threads, 0);
  f.body = body;
  f.arg = arg;
  for (int t = 0; t < threads; ++t) {
    getcontext(&f.ctx[t]);
    f.ctx[t].uc_stack.ss_sp = f.stacks[t] + kGuard;
    f.ctx[t].uc_stack.ss_size = kStack;
    f.ctx[t].uc_link = &f.sched;
    makecontext(&f.ctx[t], fiber_main, 0);
  }
  const dim3 b = blockDim;
  for (int left = threads; left > 0;) {
    const long before = f.progress;
    for (int t = 0; t < threads; ++t) {
      if (f.done[t]) continue;
      f.current = t;
      threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
      blockIdx = block_idx;
      emu_block = blk;
      swapcontext(&f.sched, &f.ctx[t]);
      left -= f.done[t];
    }
    if (left > 0 && f.progress == before) {
      emu_fault("deadlock: threads wait at a barrier that the others never reach");
      return;
    }
  }
}

static std::atomic<bool> fault_flag{false};
static std::string fault_text;

void emu_fault(const char* what) {
  bool expected = false;
  if (fault_flag.compare_exchange_strong(expected, true)) fault_text = what;
}

bool emu_take_fault() { return fault_flag.exchange(false); }

bool emu_check_smem(const void* p, size_t bytes, const char* what) {
  const uint8_t* q = (const uint8_t*)p;
  if (q >= emu_block->smem && q + bytes <= emu_block->smem + emu_block->smem_size)
    return true;
  emu_fault(what);
  return false;
}

// the text of the last fault reported
extern "C" const char* emu_fault_text() { return fault_text.c_str(); }

// the dynamic shared memory of the last launch
extern "C" size_t emu_smem_bytes() { return emu_launch_smem; }
