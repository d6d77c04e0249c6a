// Fused SimHash: packed sign bits of x @ M, the input dimension split over
// a thread block cluster.
//
// Replaces the TPU kernel takzero_tpu/ops/pallas_kernels.py:_simhash_kernel
// (called via simhash_pack).  Contract (simhash_pack_reference): bit b of
// the output word is set iff (x @ M)[row, b] >= 0, the dot product taken in
// full float32 (FMA on the CUDA cores: no TF32, no tensor cores, no bf16
// passes -- a rounded pass can flip the sign of a near-zero dot and hash the
// same position differently on two backends).
//
// Bound on an H100: at the main path's shape (x f32[128, 1296], M f32[1296,
// 26]) the kernel must read 0.66 MB + 0.13 MB and write 1 KB, and does
// 8.6 MFLOP -- memory-bound, about 0.24 us at 3.35 TB/s.  The work is small
// enough that latency, not bytes, sets the time, so the design puts many
// loads in flight at once across the card:
//   * a cluster of kCluster blocks shares one tile of kRowsPerTile rows;
//     block r of the cluster takes the r-th slice of the input dimension,
//     so the grid is kCluster x ceil(B / kRowsPerTile) blocks (8 x 16 = 128
//     at the main path's shape);
//   * each block stages its x tile and its M slice in shared memory with
//     cp.async (16-byte copies where the addresses allow), all issued
//     before one wait;
//   * warp w computes the partial dots of row w, lane b that of bit b, from
//     shared memory (float4 reads of x, conflict-free reads of M);
//   * block r then sums row r's partials of every block of the cluster
//     through distributed shared memory, in the fixed order of cluster rank,
//     so the same input gives the same word on every run, and one ballot
//     packs the word, written as the int64 that holds the uint32 value.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // blocks per row tile, splitting the input dimension
constexpr int kRowsPerTile = 8;  // one warp per row; block r reduces row r
constexpr int kThreads = 32 * kRowsPerTile;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on Hopper
static_assert(kRowsPerTile == kCluster, "block r of the cluster reduces row r of the tile");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Issue the copy of n contiguous floats into 16-byte aligned shared memory,
// spread over the threads t, t + stride, ...
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int t, int stride) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = t; i < n4; i += stride) cp_async16(dst + 4 * i, src + 4 * i);
    done = 4 * n4;
  }
  for (int i = done + t; i < n; i += stride) cp_async4(dst + i, src + i);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
simhash_kernel(const float* __restrict__ x, const float* __restrict__ m,
               long long* __restrict__ out, int rows, int in, int bits, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                           // [kRowsPerTile][chunk]
  float* ms = xs + kRowsPerTile * chunk;      // [chunk][bits]
  float* part = ms + chunk * bits;            // [kRowsPerTile][32] partial dots

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRowsPerTile;
  const int nrows = min(kRowsPerTile, rows - row0);
  const int k0 = rank * chunk;
  const int nk = max(0, min(chunk, in - k0));

  if (warp < nrows) stage(xs + warp * chunk, x + static_cast<size_t>(row0 + warp) * in + k0, nk, lane, 32);
  stage(ms, m + static_cast<size_t>(k0) * bits, nk * bits, threadIdx.x, kThreads);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  if (warp < nrows && lane < bits) {
    const float* xr = xs + warp * chunk;  // 16-byte aligned: chunk is a multiple of 4
    const float* mc = ms + lane;
    int i = 0;
    for (; i + 3 < nk; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + i);
      acc0 = fmaf(xv.x, mc[(i + 0) * bits], acc0);
      acc1 = fmaf(xv.y, mc[(i + 1) * bits], acc1);
      acc2 = fmaf(xv.z, mc[(i + 2) * bits], acc2);
      acc3 = fmaf(xv.w, mc[(i + 3) * bits], acc3);
    }
    for (; i < nk; ++i) acc0 = fmaf(xr[i], mc[i * bits], acc0);
  }
  part[warp * 32 + lane] = (acc0 + acc1) + (acc2 + acc3);
  cluster.sync();

  if (warp == 0 && rank < nrows) {
    float dot = 0.f;
    for (int j = 0; j < kCluster; ++j) dot += cluster.map_shared_rank(part, j)[rank * 32 + lane];
    const unsigned word = __ballot_sync(0xffffffffu, lane < bits && dot >= 0.f);
    if (lane == 0) out[row0 + rank] = static_cast<long long>(word);
  }
  cluster.sync();  // every block's partials stay alive until all are read
}

// Set the kernel's shared-memory limit once per device and process.
cudaError_t configure_once() {
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (configured.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(simhash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

}  // namespace

// x f32[rows, in], m f32[in, bits] (bits <= 32) -> out i64[rows] holding the
// uint32 word.  Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue when a block's slice does not fit in shared memory,
// which takes In above about 11,000).
extern "C" int simhash_launch(const void* x, const void* m, void* out, int rows,
                              int in, int bits, void* stream) {
  const int chunk = ((in + kCluster - 1) / kCluster + 3) & ~3;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kRowsPerTile) * chunk +
                                       static_cast<size_t>(chunk) * bits + kRowsPerTile * 32);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = configure_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kCluster, (rows + kRowsPerTile - 1) / kRowsPerTile);
  simhash_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<long long*>(out), rows, in, bits, chunk);
  return static_cast<int>(cudaGetLastError());
}
