// The emulation's globals (see cuda_runtime.h).
#include <atomic>
#include <string>

#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local EmuBlock* emu_block;
size_t emu_launch_smem;

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
