// Fused SimHash: packed sign bits of x @ M, one warp per row.
//
// Replaces the TPU kernel takzero_tpu/ops/pallas_kernels.py:_simhash_kernel
// (called via simhash_pack).  Contract (simhash_pack_reference): bit b of
// the output word is set iff (x @ M)[row, b] >= 0, the dot product taken in
// full float32 (no TF32, no tensor cores, no bf16 passes: a rounded pass
// can flip the sign of a near-zero dot and hash the same position
// differently on two backends).
//
// Bound on an H100: at the main path's shape (x f32[128, 1296], M f32[1296,
// 26 or 32]) the kernel must read 0.66 MB + 0.13-0.17 MB and write 512 B, and
// does 8.6 MFLOP -- memory-bound, about 0.24 us at 3.35 TB/s.  What the
// design does about it: x and M are each read once from device memory per
// block (the [B, bits] dot matrix never leaves registers), the row is staged
// in shared memory, reads of M[i, :] are coalesced across the lanes, and the
// pack is one warp ballot.  Four independent accumulators per lane hide the
// FMA latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row

__global__ void __launch_bounds__(32 * kRowsPerBlock)
simhash_kernel(const float* __restrict__ x, const float* __restrict__ m,
               int* __restrict__ out, int rows, int in, int bits) {
  extern __shared__ float xs[];  // kRowsPerBlock * in floats
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, rows - row0);
  for (int i = threadIdx.x; i < nrows * in; i += blockDim.x)
    xs[i] = x[static_cast<size_t>(row0) * in + i];
  __syncthreads();
  if (warp >= nrows) return;

  const float* xr = xs + warp * in;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  if (lane < bits) {
    int i = 0;
    for (; i + 3 < in; i += 4) {
      acc0 = fmaf(xr[i + 0], m[(i + 0) * bits + lane], acc0);
      acc1 = fmaf(xr[i + 1], m[(i + 1) * bits + lane], acc1);
      acc2 = fmaf(xr[i + 2], m[(i + 2) * bits + lane], acc2);
      acc3 = fmaf(xr[i + 3], m[(i + 3) * bits + lane], acc3);
    }
    for (; i < in; ++i) acc0 = fmaf(xr[i], m[i * bits + lane], acc0);
  }
  const float dot = (acc0 + acc1) + (acc2 + acc3);
  const unsigned word = __ballot_sync(0xffffffffu, lane < bits && dot >= 0.f);
  if (lane == 0) out[row0 + warp] = static_cast<int>(word);  // uint32 bits
}

}  // namespace

// x f32[rows, in], m f32[in, bits] (bits <= 32) -> out i32[rows] holding the
// uint32 bit pattern.  Returns the CUDA error code of the launch.
extern "C" int simhash_launch(const void* x, const void* m, void* out, int rows,
                              int in, int bits, void* stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int smem = kRowsPerBlock * in * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      simhash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  simhash_kernel<<<blocks, 32 * kRowsPerBlock, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<int*>(out), rows, in, bits);
  return static_cast<int>(cudaGetLastError());
}
