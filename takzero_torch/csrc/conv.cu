// The evaluator's 3x3 convolutions (the stem, the residual tower and the
// policy head of the BN-folded network) as one implicit-GEMM kernel a layer,
// on Hopper's warpgroup tensor-core instruction (wgmma) with bf16 operands
// and float32 accumulators.
//
// Replaces no TPU kernel: the JAX package leaves the convolutions to XLA
// (takzero_tpu/models/network.py apply_folded), and the port ran them as
// cuDNN TF32 convolutions of float32 copies of the bf16 operands
// (models/network.py _conv2d), with layout transposes, casts and separate
// bias, residual and relu passes, some eleven launches a layer.  No library
// call takes bf16 operands to a float32 result that is rounded once after
// the bias (cuDNN's bf16 convolution rounds its product first), so this
// kernel computes exactly the folded path's function:
//
//   out = round_bf16(relu(sum_k bf16(x) * bf16(w) + bias_f32 [+ f32(residual)]))
//
// summed in float32, with the policy head's channels left unrounded and
// unrelued in float32, channel-major ([B, C, n, n], apply_folded's flatten),
// and the value and UBE heads' 1x1 convolutions riding in the same launch as
// two more output channels (their weights at the centre tap, relu on them).
//
// GEMM view: M = B n^2 board cells (rows, NHWC), N = Cout, K = 9 Cin ordered
// (64-channel block, tap, channel).  A K-block is 64 channels of one tap, so
// each GEMM row of a stage is 128 contiguous bytes of one shifted cell (zero
// off the board): an implicit im2col gathered by cp.async with zero fill, no
// buffer in device memory.  The nine taps of a channel block follow each
// other, so they gather nearly the same cells while L1 still holds them.
// The stem reads the float32 NCHW planes instead and rounds them to bf16 as
// it stages them.  Weights are packed once, when the network is folded
// (ops/conv.py pack_weight), as [K-blocks][Cout_pad][64] rows already in the
// 128-byte swizzle that wgmma reads, so a weight tile is one contiguous
// copy.  Both operands are K-major in shared memory under the 128-byte
// swizzle (layout type 1); each warpgroup multiplies its 64 rows by the
// tile's BN columns (m64nBNk16), four instructions a K-block, the first of
// which overwrites the accumulators (no other instruction writes them, so
// ptxas keeps the products asynchronous).
//
// Pipeline: STAGES buffers of (A, B) tiles; the loads for K-block kb + STAGES
// - 2 are issued while the tensor cores run K-block kb and the previous
// group drains (wgmma.wait_group 1), so two stages are always in the
// tensor cores' hands and the rest in flight.  One CTA a tile: the wrapper
// chooses the tile from (M, Cout) (ops/conv.py choose_tile).
//
// Bound on an H100: tensor-core operations.  A tower layer at net6_simhash
// (M = 4,608, N = 256, K = 2,304) is 5.4 GFLOP, 5.5 us at 989 TFLOP/s,
// against 2.4 MB of activations and 1.2 MB of weights, which stay in the
// 50 MB L2 across layers (2.5 us at 3.35 TB/s even from HBM).  Measured on
// the card (PERF.md): about 25 us, 22% of the peak, with 72 of the 132 SMs
// holding a 128 x 128 tile.  The loop without any load runs at about half
// an SM's tensor rate, the activation gather adds a quarter, and spreading
// the same work over every SM (tiles split between CTAs) made it slower:
// the memory path, not the number of SMs, bounds it at these sizes.

#include <cstdint>
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;              // K values a stage: 64 bf16 = one 128-byte row
constexpr int kRowBytes = kBK * 2;
constexpr int kModeTower = 0, kModeStem = 1, kModeHead = 2;

struct ConvArgs {
  const void* x;                  // stem: f32 [B, cin, n, n]; else bf16 [M, cin] (NHWC rows)
  const __nv_bfloat16* w;         // [9 * cblocks][cout_pad][64], swizzled rows
  const float* bias;              // f32 [cout_pad]
  const __nv_bfloat16* residual;  // bf16 [M, cout_pad] or null
  void* out0;                     // bf16 [M, cout_pad]; head: f32 [B, split, n, n]
  float* out1;                    // head: f32 [B, cout - split, n, n]
  int m, n, cin, cblocks, cout_pad, cout, split;
};

template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = 2 * BM;  // one warpgroup (128 threads) per 64 rows
  static constexpr int kStages = BM == 128 ? 5 : (BN == 128 ? 4 : 6);  // 160, 96 or 96 KB: one or two CTAs an SM
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment to 1024 B
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows under
// the 128-byte swizzle (Swizzle<3,4,3>): the chunk index XOR the row's index
// within its 8-row atom.  Tiles start on 1024-byte boundaries.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_cg(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows under the
// 128-byte swizzle: start address >> 4, leading offset 16 B (unused by this
// layout), stride 1024 B between 8-row core-matrix groups, layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, bf16 A and B from shared memory (K-major): float32 D = A B + D,
// or D = A B where scale_d is 0.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db, scale_d);
  } else {
    wgmma_n128(d, da, db, scale_d);
  }
}

// One BM x BN output tile: BM / 64 warpgroups, each 64 rows.
template <int BM, int BN, int MODE>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, 1) conv3x3_bf16_kernel(const ConvArgs a) {
  using T = Tile<BM, BN>;
  constexpr int kThreads = T::kThreads, kStages = T::kStages, kDist = kStages - 2;
  constexpr int kAIters = BM * 8 / kThreads;  // 16-byte chunks of A a thread a stage
  constexpr int kBIters = BN * 8 / kThreads;  // of B
  constexpr int kRowStep = kThreads / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n = a.n, nn = n * n;
  const int kblocks = 9 * a.cblocks;
  const int c = tid & 7;  // this thread's 16-byte chunk of each of its rows

  // The board cell of each row this thread gathers (b = -1 past M).
  int row_b[kAIters], row_y[kAIters], row_x[kAIters];
#pragma unroll
  for (int j = 0; j < kAIters; ++j) {
    const int m = m0 + (tid >> 3) + j * kRowStep;
    const int b = m / nn, cell = m - b * nn;
    row_b[j] = m < a.m ? b : -1;
    row_y[j] = cell / n;
    row_x[j] = cell - row_y[j] * n;
  }

  auto load_stage = [&](int s, int kb) {
    const int cb = kb / 9, tap = kb - cb * 9;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t sa = base + s * T::kStageBytes, sb = sa + T::kABytes;
#pragma unroll
    for (int j = 0; j < kAIters; ++j) {
      const int r = (tid >> 3) + j * kRowStep;
      const int y = row_y[j] + dy, x = row_x[j] + dx;
      const bool in = row_b[j] >= 0 && static_cast<unsigned>(y) < static_cast<unsigned>(n) &&
                      static_cast<unsigned>(x) < static_cast<unsigned>(n);
      if constexpr (MODE == kModeStem) {
        // float32 NCHW planes, rounded to bf16 here; channels past cin are 0.
        const float* planes = static_cast<const float*>(a.x);
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = cb * kBK + c * 8 + 2 * e;
          float lo = 0.f, hi = 0.f;
          if (in) {
            const size_t at = ((static_cast<size_t>(row_b[j]) * a.cin + ch) * n + y) * n + x;
            if (ch < a.cin) lo = __ldg(planes + at);
            if (ch + 1 < a.cin) hi = __ldg(planes + at + nn);
          }
          const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
          v[e] = *reinterpret_cast<const uint32_t*>(&h);
        }
        st_shared_v4(sa + swizzled(r, c), v[0], v[1], v[2], v[3]);
      } else {
        const __nv_bfloat16* xs = static_cast<const __nv_bfloat16*>(a.x);
        const __nv_bfloat16* src =
            in ? xs + (static_cast<size_t>(row_b[j] * nn + y * n + x) * a.cin + cb * kBK + c * 8) : xs;
        cp_async_ca(sa + swizzled(r, c), src, in ? 16 : 0);
      }
    }
    const __nv_bfloat16* wt = a.w + (static_cast<size_t>(kb) * a.cout_pad + n0) * kBK;
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int q = tid + i * kThreads;
      cp_async_cg(sb + q * 16, wt + q * 8);
    }
  };

  float acc[BN / 2];  // set by the first product (scale-d 0): no instruction outside wgmma writes it
#pragma unroll
  for (int s = 0; s < kDist; ++s) {
    if (s < kblocks) load_stage(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < kblocks; ++i) {
    // K-block i has landed for every thread, and every warpgroup has
    // retired its products of K-block i - 2, whose buffers the loads
    // below refill.
    cp_async_wait<kDist - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = i + kDist;
    if (next < kblocks) load_stage(next % kStages, next);
    cp_async_commit();
    const uint32_t sa = base + (i % kStages) * T::kStageBytes + wg * 64 * kRowBytes;
    const uint32_t sb = base + (i % kStages) * T::kStageBytes + T::kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)  // the first product overwrites the accumulators
      mma<BN>(acc, desc_sw128(sa + 32 * k), desc_sw128(sb + 32 * k), i > 0 || k > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue from the accumulators: thread (warp w, lane l) holds rows
  // 16 w + l / 4 (+ 8) and columns 2 (l % 4) (+ 1) of each 8-column group.
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = n0 + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + r0 + 8 * i;
    if (m >= a.m) continue;
    if constexpr (MODE == kModeHead) {
      const int b = m / nn, cell = m - b * nn;
      float* policy = static_cast<float*>(a.out0) + static_cast<size_t>(b) * a.split * nn + cell;
      float* heads = a.out1 + static_cast<size_t>(b) * (a.cout - a.split) * nn + cell;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + e;
          const float v = acc[4 * j + 2 * i + e] + a.bias[col];
          if (col < a.split) {
            policy[static_cast<size_t>(col) * nn] = v;
          } else if (col < a.cout) {
            heads[static_cast<size_t>(col - a.split) * nn] = fmaxf(v, 0.f);
          }
        }
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out0) + static_cast<size_t>(m) * a.cout_pad;
      const __nv_bfloat16* res = a.residual ? a.residual + static_cast<size_t>(m) * a.cout_pad : nullptr;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j;
        float v0 = acc[4 * j + 2 * i] + a.bias[col], v1 = acc[4 * j + 2 * i + 1] + a.bias[col + 1];
        if (res) {
          const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + col));
          v0 += rf.x;
          v1 += rf.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

// Set the instantiation's shared-memory limit once per device and process.
template <int BM, int BN, int MODE>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(conv3x3_bf16_kernel<BM, BN, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const dim3 grid((a.m + BM - 1) / BM, a.cout_pad / BN);
  conv3x3_bf16_kernel<BM, BN, MODE><<<grid, T::kThreads, T::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(int bm, int bn, const ConvArgs& a, cudaStream_t stream) {
  if (bm == 128 && bn == 128) return launch<128, 128, MODE>(a, stream);
  if (bm == 64 && bn == 128) return launch<64, 128, MODE>(a, stream);
  if (bm == 64 && bn == 64) return launch<64, 64, MODE>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// One convolution layer; see ops/conv.py conv3x3 for the operands' layouts.
// mode 0: bf16 NHWC rows in and out (a tower layer, the residual optional);
// mode 1: the stem, float32 NCHW planes in; mode 2: the policy head, float32
// channel-major out (channels below split to out0, the rest relued to out1).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int conv3x3_launch(const void* x, const void* w, const void* bias, const void* residual, void* out0,
                              void* out1, int m, int n, int cin, int cblocks, int cout_pad, int cout, int split,
                              int mode, int bm, int bn, void* stream) {
  if (m <= 0 || n <= 0 || cblocks <= 0 || bn <= 0 || cout_pad % bn != 0 || cout > cout_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvArgs a{x, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
                   static_cast<const __nv_bfloat16*>(residual), out0, static_cast<float*>(out1),
                   m, n, cin, cblocks, cout_pad, cout, split};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeTower: return static_cast<int>(dispatch<kModeTower>(bm, bn, a, s));
    case kModeStem: return static_cast<int>(dispatch<kModeStem>(bm, bn, a, s));
    case kModeHead: return static_cast<int>(dispatch<kModeHead>(bm, bn, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
