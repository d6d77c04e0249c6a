// Exact unsorted top-k by radix select: one thread block per row.
//
// Replaces the TPU kernel takzero_tpu/ops/topk.py:_topk_kernel (called via
// exact_top_k_unsorted).  Contract (exact_top_k_unsorted_reference): the k
// largest values of each row, ties broken toward the lower index, output
// in ascending index order, values returned exactly as given (+-inf too).
//
// Bound on an H100: at the main path's shape (x f32[128, 9036], k = 256)
// the kernel must read 4.6 MB and write 0.26 MB -- memory-bound, about
// 1.5 us at 3.35 TB/s.  What the design does about it: each row is read
// from device memory once into shared memory (36 KB at 6x6) and every
// later pass (four 8-bit histogram passes, the tie count, the emit) works
// there; only the chosen k (value, index) pairs are written back.
//
// Signed zeros: -0.0 is keyed as +0.0, so the two tie and resolve by index
// as in the reference's stable sort on (-x, index).  The TPU kernel keys on
// raw bits and orders -0.0 below +0.0; this kernel follows the reference.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Block-wide exclusive prefix sum of one int per thread; also returns the
// block total.  `scratch` holds kWarps + 1 ints.
__device__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < kWarps) scratch[lane] = wi - w;  // exclusive warp offsets
    if (lane == kWarps - 1) scratch[kWarps] = wi;
  }
  __syncthreads();
  int out = scratch[warp] + incl - v;
  *total = scratch[kWarps];
  __syncthreads();  // scratch is reused by the next call
  return out;
}

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, int a, int k) {
  extern __shared__ uint32_t keys[];  // a keys
  __shared__ int hist[256];
  __shared__ int scan_scratch[kWarps + 1];
  __shared__ uint32_t s_prefix;
  __shared__ int s_remaining;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + static_cast<size_t>(row) * a;

  for (int i = tid; i < a; i += kThreads) keys[i] = order_key(xr[i]);
  if (tid == 0) {
    s_prefix = 0u;
    s_remaining = k;
  }
  __syncthreads();

  // Four 8-bit passes, most significant byte first: find the key of the
  // k-th largest element (the threshold).
  uint32_t mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    const uint32_t prefix = s_prefix;
    for (int base = 0; base < a; base += kThreads) {
      const int i = base + tid;
      int bin = 256;  // sentinel: not counted
      if (i < a) {
        const uint32_t key = keys[i];
        if ((key & mask) == prefix) bin = (key >> shift) & 0xFF;
      }
      // Warp-aggregated increments: masked rows put thousands of equal
      // keys in one bin, which would serialise plain shared atomics.
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l owns bins 255-8l .. 248-8l (counted from the top).
      int c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const int remaining = s_remaining;
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= remaining);
      const int owner = __ffs(hit) - 1;  // first lane reaching `remaining`
      if (lane == owner) {
        int above = incl - sum;  // elements in higher bins
        int j = 0;
        while (above + c[j] < remaining) {
          above += c[j];
          ++j;
        }
        const uint32_t bin = 255 - 8 * lane - j;
        s_prefix = prefix | (bin << shift);
        s_remaining = remaining - above;
      }
    }
    mask |= 0xFFu << shift;
    __syncthreads();
  }
  const uint32_t thresh = s_prefix;
  const int need_eq = s_remaining;  // ties at the threshold to keep

  // Each thread owns a contiguous chunk of indices, so block scans over
  // the per-thread counts rank ties and outputs in index order.
  const int chunk = (a + kThreads - 1) / kThreads;
  const int lo = min(a, tid * chunk), hi = min(a, lo + chunk);
  int n_gt = 0, n_eq = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = keys[i];
    n_gt += key > thresh;
    n_eq += key == thresh;
  }
  int total;
  const int eq_before = block_exclusive_scan(n_eq, scan_scratch, &total);
  int take_eq = need_eq - eq_before;
  take_eq = take_eq < 0 ? 0 : (take_eq > n_eq ? n_eq : take_eq);
  int out = block_exclusive_scan(n_gt + take_eq, scan_scratch, &total);

  float* vr = vals + static_cast<size_t>(row) * k;
  int* ir = idx + static_cast<size_t>(row) * k;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = keys[i];
    bool sel = key > thresh;
    if (key == thresh && take_eq > 0) {
      sel = true;
      --take_eq;
    }
    if (sel) {
      vr[out] = xr[i];
      ir[out] = i;
      ++out;
    }
  }
}

}  // namespace

extern "C" int topk_smem_bytes(int a) { return a * static_cast<int>(sizeof(uint32_t)); }

// x f32[rows, a] -> vals f32[rows, k], idx i32[rows, k].  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int topk_launch(const void* x, void* vals, void* idx, int rows, int a,
                           int k, void* stream) {
  const int smem = topk_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_rows_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(idx), a, k);
  return static_cast<int>(cudaGetLastError());
}
