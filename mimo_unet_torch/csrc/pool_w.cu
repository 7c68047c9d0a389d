// W-pair max of a channels-last bf16 tensor: [rows, W, C] -> [rows, W/2, C].
//
// Replaces mimo_unet_tpu/ops/pallas/ct_elem.py:193 max_pool_w_ct, the W
// half of the 2x2 max pool whose H half the DoubleConv kernel emitted.
// Bound on the H100 by device-memory bytes (one read of the input, one
// write of the half-size output, no arithmetic to speak of).  Design:
// one grid-stride pass; with C even, each thread moves a bf16 pair
// (__hmax2_nan), so a warp reads 128 contiguous bytes of each input pixel
// pair.  The max is bitwise the input's values (NaN propagates, as in
// torch.maximum).
#include "common.cuh"

namespace {

__global__ void pool_w_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                              int64_t n_out, int64_t c) {
  // out element e = pixel*C + ch reads input pixels 2*pixel and 2*pixel+1,
  // i.e. x[e + pixel*C] and x[e + pixel*C + C]
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_out;
       e += stride) {
    const int64_t i0 = e + (e / c) * c;
    out[e] = __hmax_nan(x[i0], x[i0 + c]);
  }
}

__global__ void pool_w_pairs_kernel(const __nv_bfloat162* __restrict__ x,
                                    __nv_bfloat162* __restrict__ out,
                                    int64_t n_out2, int64_t c2) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_out2;
       e += stride) {
    const int64_t i0 = e + (e / c2) * c2;
    out[e] = __hmax2_nan(x[i0], x[i0 + c2]);
  }
}

}  // namespace

extern "C" int mimo_pool_w(const void* x, void* out, int64_t rows, int64_t w,
                           int64_t c, void* stream) {
  if (rows <= 0 || w < 2 || w % 2 || c <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_out = rows * (w / 2) * c;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 2 == 0) {
    pool_w_pairs_kernel<<<elementwise_blocks(n_out / 2, threads), threads, 0, s>>>(
        (const __nv_bfloat162*)x, (__nv_bfloat162*)out, n_out / 2, c / 2);
  } else {
    pool_w_kernel<<<elementwise_blocks(n_out, threads), threads, 0, s>>>(
        (const bf16*)x, (bf16*)out, n_out, c);
  }
  return (int)cudaGetLastError();
}
