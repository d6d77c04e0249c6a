// Exact unsorted top-k by radix select: one 1024-thread block per row, one
// sweep of the whole row, then only the threshold bin's keys.
//
// Replaces the TPU kernel takzero_tpu/ops/topk.py:_topk_kernel (called via
// exact_top_k_unsorted).  Contract (exact_top_k_unsorted_reference): the k
// largest values of each row, ties broken toward the lower index, output
// in ascending index order, values returned exactly as given (+-inf and
// -0.0 too).
//
// Bound on an H100: at the main path's shape (x f32[128, 9036], k = 256)
// the kernel must read 4.6 MB and write 0.26 MB -- memory-bound, about
// 1.5 us at 3.35 TB/s.  What the design does about it:
//   * the row is read from device memory once (16-byte loads where the row
//     is aligned) into shared memory (36 KB at 6x6), and every later step
//     works there;
//   * while the row streams in, each key's top digit (11 bits) is counted
//     into a shared histogram with one plain shared atomic per key (on the
//     H100 that was faster, on every kind of row, than grouping equal bins
//     with __match_any_sync first), and a block-wide scan finds the bin that
//     holds the k-th largest key;
//   * if the row's k largest take that whole bin, the threshold is known.
//     Otherwise one more sweep counts the bin's keys and finds their least
//     and greatest in registers, then per warp: if those are equal -- the main path's rows
//     with fewer than k legal actions, whose threshold is the search's mask
//     value -- the threshold is that key.  Only otherwise are the bin's keys
//     (the candidates) copied out, each warp into the range it reserved, and
//     the two remaining digits (11 and 10 bits) resolved over the
//     candidates alone;
//   * the emit is one block-wide scan over contiguous per-thread chunks in
//     index order, which ranks the threshold's ties and places the outputs;
//     each thread keeps its chunk's verdicts as bit masks, so only the k
//     chosen keys are read again.
//
// Signed zeros: -0.0 is keyed as +0.0, so the two tie and resolve by index
// as in the reference's stable sort on (-x, index).  The TPU kernel keys on
// raw bits and orders -0.0 below +0.0; this kernel follows the reference.
//
// Rows too wide for shared memory (8 bytes an entry above 27,904 entries;
// 8x8 has A = 65,216, 510 KB) take a second kernel, topk_wide_kernel, with
// the same steps and the row left in device memory: the histogram sweep and
// the threshold-bin sweep read the row from global memory, the candidates
// go to a workspace in device memory that the wrapper allocates ([rows, A]
// words), the last two digits are resolved there, and the emit walks the
// row in tiles of 31 keys a thread, carrying the counts of earlier tiles.
// Bound at f32[128, 65216], k = 256: 33.4 MB read, about 10 us at
// 3.35 TB/s.  The whole input fits the H100's 50 MB L2, so the sweeps after
// the first mostly hit L2.  A cluster split over distributed shared memory
// was not taken: at the search's 128 rows one block a row already holds 128
// of the 132 SMs, so a split would add no SMs, only cluster barriers.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;  // 11-bit digits
constexpr int kLoads = 3;    // loads in flight per thread while the row streams in
constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

struct Pick {
  int bin;        // the bin holding the k-th largest key
  int remaining;  // keys still to take from that bin
  int count;      // keys in that bin
};

__device__ __forceinline__ uint32_t order_key(uint32_t u) {
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Block-wide exclusive prefix sum of one int per thread.  `scratch` holds
// kWarps ints; the caller syncs before scratch is used again.
__device__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = scratch[lane];  // kWarps == 32
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    scratch[lane] = wi - w;  // exclusive warp offsets
  }
  __syncthreads();
  return scratch[warp] + incl - v;
}

// Histogram of bin_of(i) over i = tid, tid + kThreads, ... < n (a negative
// bin is not counted).
template <class BinOf>
__device__ __forceinline__ void histogram(int* hist, int n, BinOf bin_of) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int bin = bin_of(i);
    if (bin >= 0) atomicAdd(&hist[bin], 1);
  }
}

// Find, from the top, the bin of `hist` (kPer * kThreads bins) in which the
// count of keys reaches `remaining`.  Thread t owns kPer adjacent bins.
template <int kPer>
__device__ void pick_bin(const int* hist, int remaining, int* scratch, Pick* pick) {
  constexpr int nb = kPer * kThreads;
  const int top = nb - 1 - kPer * static_cast<int>(threadIdx.x);
  int c[kPer];
  int s = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = hist[top - j];
    s += c[j];
  }
  int above = block_exclusive_scan(s, scratch);
  if (above < remaining && remaining <= above + s) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (above + c[j] >= remaining) {
        pick->bin = top - j;
        pick->remaining = remaining - above;
        pick->count = c[j];
        break;
      }
      above += c[j];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, int a, int k) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* row = smem;       // the row's float bits, a words
  uint32_t* cand = smem + a;  // keys of the threshold bin, at most a
  __shared__ int hist[kBins];
  __shared__ int scratch[kWarps];
  __shared__ Pick pick;
  __shared__ int s_ncand;
  __shared__ uint32_t s_min, s_max;

  const int tid = threadIdx.x, lane = tid & 31;
  const float* xr = x + static_cast<size_t>(blockIdx.x) * a;

  // The row, read from device memory once; its keys' top digits (bits
  // 31..21) are counted as it streams in.
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  if (tid == 0) {
    s_ncand = 0;
    s_min = 0xffffffffu;
    s_max = 0u;
  }
  __syncthreads();
  int staged = 0;
  if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const int n4 = a >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int base = 0; base < n4; base += kLoads * kThreads) {
      float4 v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int q = base + j * kThreads + tid;
        if (q < n4) v[j] = __ldg(x4 + q);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int q = base + j * kThreads + tid;
        if (q < n4) {
          const uint32_t w[4] = {__float_as_uint(v[j].x), __float_as_uint(v[j].y),
                                 __float_as_uint(v[j].z), __float_as_uint(v[j].w)};
          reinterpret_cast<uint4*>(row)[q] = make_uint4(w[0], w[1], w[2], w[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) atomicAdd(&hist[order_key(w[e]) >> 21], 1);
        }
      }
    }
    staged = 4 * n4;
  }
  for (int base = staged; base < a; base += kLoads * kThreads) {
    uint32_t v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreads + tid;
      if (i < a) v[j] = __float_as_uint(__ldg(xr + i));
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreads + tid;
      if (i < a) {
        row[i] = v[j];
        atomicAdd(&hist[order_key(v[j]) >> 21], 1);
      }
    }
  }
  __syncthreads();
  pick_bin<2>(hist, k, scratch, &pick);
  uint32_t prefix = static_cast<uint32_t>(pick.bin) << 21;
  uint32_t mask = 0xffe00000u;
  int remaining = pick.remaining;

  if (pick.count != remaining) {
    // Only part of the threshold bin is taken.  Count its keys and find the
    // least and greatest, in registers, then per warp and per block; each
    // warp reserves its range of the candidates as it adds its count.
    const int nc = pick.count;
    int count = 0;
    uint32_t lo = 0xffffffffu, hi = 0u;
    for (int i = tid; i < a; i += kThreads) {
      const uint32_t key = order_key(row[i]);
      if ((key & mask) == prefix) {
        ++count;
        lo = min(lo, key);
        hi = max(hi, key);
      }
    }
    count = __reduce_add_sync(kFull, count);
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    int pos = 0;
    if (lane == 0) {
      atomicMin(&s_min, lo);
      atomicMax(&s_max, hi);
      pos = atomicAdd(&s_ncand, count);
    }
    pos = __shfl_sync(kFull, pos, 0);
    __syncthreads();
    if (s_min == s_max) {
      prefix = s_min;  // one distinct key: its ties resolve by index
      mask = 0xffffffffu;
    } else {
      // Copy the bin's keys (the candidates) out, each warp into its range.
      for (int base = 0; base < a; base += kThreads) {
        const int i = base + tid;
        const uint32_t key = i < a ? order_key(row[i]) : 0u;
        const bool in_bin = i < a && (key & mask) == prefix;
        const unsigned hit = __ballot_sync(kFull, in_bin);
        if (in_bin) cand[pos + __popc(hit & ((1u << lane) - 1u))] = key;
        pos += __popc(hit);
      }
      // Second digit (bits 20..10), over the candidates only.
      for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
      __syncthreads();
      histogram(hist, nc, [&](int i) { return static_cast<int>((cand[i] >> 10) & 0x7ffu); });
      __syncthreads();
      pick_bin<2>(hist, remaining, scratch, &pick);
      prefix |= static_cast<uint32_t>(pick.bin) << 10;
      mask = 0xfffffc00u;
      remaining = pick.remaining;
      if (pick.count != remaining) {
        // Last digit (bits 9..0), over the candidates that share the prefix.
        for (int i = tid; i < kThreads; i += kThreads) hist[i] = 0;
        __syncthreads();
        histogram(hist, nc, [&](int i) {
          const uint32_t key = cand[i];
          return (key & mask) == prefix ? static_cast<int>(key & 0x3ffu) : -1;
        });
        __syncthreads();
        pick_bin<1>(hist, remaining, scratch, &pick);
        prefix |= static_cast<uint32_t>(pick.bin);
        mask = 0xffffffffu;
        remaining = pick.remaining;
      }
    }
  }

  // Emit.  Keys whose masked value is above `prefix` are all taken; of the
  // keys equal to it, the first `remaining` in index order (all of them
  // when the mask is partial).  Each thread owns a contiguous chunk of at
  // most 32 keys, an odd number long so that the strided reads miss no bank
  // twice, and keeps its verdicts as two bit masks; one scan of (greater,
  // equal) counts packed as 16-bit halves places them.  The wrapper keeps
  // a < 32768, so neither half overflows.
  const int chunk = ((a + kThreads - 1) / kThreads) | 1;
  const int lo = min(a, tid * chunk), n = min(a, lo + chunk) - lo;
  uint32_t gt_bits = 0u, eq_bits = 0u;
  for (int j = 0; j < n; ++j) {
    const uint32_t key = order_key(row[lo + j]) & mask;
    gt_bits |= static_cast<uint32_t>(key > prefix) << j;
    eq_bits |= static_cast<uint32_t>(key == prefix) << j;
  }
  const int n_gt = __popc(gt_bits), n_eq = __popc(eq_bits);
  const int before = block_exclusive_scan((n_gt << 16) | n_eq, scratch);
  const int gt_before = before >> 16, eq_before = before & 0xffff;
  int take_eq = min(max(remaining - eq_before, 0), n_eq);
  uint32_t sel = gt_bits;
  for (; take_eq > 0; --take_eq) {  // the lowest-indexed ties of the chunk
    sel |= eq_bits & (0u - eq_bits);
    eq_bits &= eq_bits - 1u;
  }
  int out = gt_before + min(eq_before, remaining);
  float* vr = vals + static_cast<size_t>(blockIdx.x) * k;
  int* ir = idx + static_cast<size_t>(blockIdx.x) * k;
  for (; sel != 0u; sel &= sel - 1u, ++out) {
    const int i = lo + __ffs(sel) - 1;
    vr[out] = __uint_as_float(row[i]);
    ir[out] = i;
  }
}

constexpr int kWideChunk = 31;  // keys a thread owns in one emit tile (odd, < 32)

// The same select for a row in device memory; `work` holds the row's
// threshold-bin keys (at most a).
__global__ void __launch_bounds__(kThreads)
topk_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, uint32_t* __restrict__ work, int a, int k) {
  __shared__ int hist[kBins];
  __shared__ int scratch[kWarps];
  __shared__ Pick pick;
  __shared__ int s_ncand, s_total;
  __shared__ uint32_t s_min, s_max;

  const int tid = threadIdx.x, lane = tid & 31;
  const size_t roff = static_cast<size_t>(blockIdx.x) * a;
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(x) + roff;
  uint32_t* cand = work + roff;

  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  if (tid == 0) {
    s_ncand = 0;
    s_min = 0xffffffffu;
    s_max = 0u;
  }
  __syncthreads();
  // Sweep 1: the top digits' histogram, straight from device memory.
  int swept = 0;
  if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const int n4 = a >> 2;
    const uint4* x4 = reinterpret_cast<const uint4*>(xr);
    for (int base = 0; base < n4; base += kLoads * kThreads) {
      uint4 v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int q = base + j * kThreads + tid;
        if (q < n4) v[j] = __ldg(x4 + q);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int q = base + j * kThreads + tid;
        if (q < n4) {
          atomicAdd(&hist[order_key(v[j].x) >> 21], 1);
          atomicAdd(&hist[order_key(v[j].y) >> 21], 1);
          atomicAdd(&hist[order_key(v[j].z) >> 21], 1);
          atomicAdd(&hist[order_key(v[j].w) >> 21], 1);
        }
      }
    }
    swept = 4 * n4;
  }
  for (int i = swept + tid; i < a; i += kThreads) atomicAdd(&hist[order_key(__ldg(xr + i)) >> 21], 1);
  __syncthreads();
  pick_bin<2>(hist, k, scratch, &pick);
  uint32_t prefix = static_cast<uint32_t>(pick.bin) << 21;
  uint32_t mask = 0xffe00000u;
  int remaining = pick.remaining;

  if (pick.count != remaining) {
    // Sweep 2: the threshold bin's count, least and greatest key.
    const int nc = pick.count;
    int count = 0;
    uint32_t lo = 0xffffffffu, hi = 0u;
#pragma unroll 4
    for (int i = tid; i < a; i += kThreads) {
      const uint32_t key = order_key(__ldg(xr + i));
      if ((key & mask) == prefix) {
        ++count;
        lo = min(lo, key);
        hi = max(hi, key);
      }
    }
    count = __reduce_add_sync(kFull, count);
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    int pos = 0;
    if (lane == 0) {
      atomicMin(&s_min, lo);
      atomicMax(&s_max, hi);
      pos = atomicAdd(&s_ncand, count);
    }
    pos = __shfl_sync(kFull, pos, 0);
    __syncthreads();
    if (s_min == s_max) {
      prefix = s_min;
      mask = 0xffffffffu;
    } else {
      // Sweep 3: the candidates out to the workspace, each warp into its range.
      for (int base = 0; base < a; base += kThreads) {
        const int i = base + tid;
        const uint32_t key = i < a ? order_key(__ldg(xr + i)) : 0u;
        const bool in_bin = i < a && (key & mask) == prefix;
        const unsigned hit = __ballot_sync(kFull, in_bin);
        if (in_bin) cand[pos + __popc(hit & ((1u << lane) - 1u))] = key;
        pos += __popc(hit);
      }
      for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
      __syncthreads();  // also orders the candidates' stores before their reads
      histogram(hist, nc, [&](int i) { return static_cast<int>((cand[i] >> 10) & 0x7ffu); });
      __syncthreads();
      pick_bin<2>(hist, remaining, scratch, &pick);
      prefix |= static_cast<uint32_t>(pick.bin) << 10;
      mask = 0xfffffc00u;
      remaining = pick.remaining;
      if (pick.count != remaining) {
        for (int i = tid; i < kThreads; i += kThreads) hist[i] = 0;
        __syncthreads();
        histogram(hist, nc, [&](int i) {
          const uint32_t key = cand[i];
          return (key & mask) == prefix ? static_cast<int>(key & 0x3ffu) : -1;
        });
        __syncthreads();
        pick_bin<1>(hist, remaining, scratch, &pick);
        prefix |= static_cast<uint32_t>(pick.bin);
        mask = 0xffffffffu;
        remaining = pick.remaining;
      }
    }
  }

  // Emit, a tile of kWideChunk * kThreads keys at a time in index order:
  // each thread's contiguous chunk gives two bit masks, one block scan of
  // packed 16-bit (greater, equal) counts places them within the tile (a
  // tile holds 31,744 keys, so neither half overflows), and the counts of
  // the earlier tiles are carried.
  float* vr = vals + static_cast<size_t>(blockIdx.x) * k;
  int* ir = idx + static_cast<size_t>(blockIdx.x) * k;
  int carry_gt = 0, carry_eq = 0;
  for (int t0 = 0; t0 < a; t0 += kWideChunk * kThreads) {
    const int lo = min(a, t0 + tid * kWideChunk), n = min(a, lo + kWideChunk) - lo;
    uint32_t gt_bits = 0u, eq_bits = 0u;
    for (int j = 0; j < n; ++j) {
      const uint32_t key = order_key(__ldg(xr + lo + j)) & mask;
      gt_bits |= static_cast<uint32_t>(key > prefix) << j;
      eq_bits |= static_cast<uint32_t>(key == prefix) << j;
    }
    const int n_gt = __popc(gt_bits), n_eq = __popc(eq_bits);
    const int packed = (n_gt << 16) | n_eq;
    const int before = block_exclusive_scan(packed, scratch);
    if (tid == kThreads - 1) s_total = before + packed;
    const int eq_before = carry_eq + (before & 0xffff);
    int take_eq = min(max(remaining - eq_before, 0), n_eq);
    uint32_t sel = gt_bits;
    for (; take_eq > 0; --take_eq) {
      sel |= eq_bits & (0u - eq_bits);
      eq_bits &= eq_bits - 1u;
    }
    int out = carry_gt + (before >> 16) + min(eq_before, remaining);
    for (; sel != 0u; sel &= sel - 1u, ++out) {
      const int i = lo + __ffs(sel) - 1;
      vr[out] = __uint_as_float(__ldg(xr + i));
      ir[out] = i;
    }
    __syncthreads();  // s_total written; scratch free for the next tile
    carry_gt += s_total >> 16;
    carry_eq += s_total & 0xffff;
  }
}

// Set the kernel's shared-memory limit once per device and process.
cudaError_t configure_once() {
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (configured.load() & bit) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, topk_rows_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

}  // namespace

// x f32[rows, a] -> vals f32[rows, k], idx i32[rows, k].  Returns the CUDA
// error code of the launch (0 on success).  Needs 8 * a bytes of dynamic
// shared memory (the row and its candidates) beside 8.3 KB of static.
extern "C" int topk_launch(const void* x, void* vals, void* idx, int rows, int a,
                           int k, void* stream) {
  const cudaError_t err = configure_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * sizeof(uint32_t) * static_cast<size_t>(a);
  topk_rows_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(idx), a, k);
  return static_cast<int>(cudaGetLastError());
}

// The same for rows too wide for shared memory: `work` is u32[rows, a] of
// device memory for the candidates.  No dynamic shared memory.
extern "C" int topk_wide_launch(const void* x, void* vals, void* idx, void* work, int rows,
                                int a, int k, void* stream) {
  topk_wide_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<uint32_t*>(work), a, k);
  return static_cast<int>(cudaGetLastError());
}
