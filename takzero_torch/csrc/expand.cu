// The search's expansion around kernel A: the legal mask before it and the
// guarded stores after it.
//
// Replaces no TPU kernel.  It is JAX's apply_eval
// (takzero_tpu/search/core.py:305) with tak/engine.py's legal_mask, which
// XLA fuses; the port ran it as batched torch operators (search/core.py
// apply_eval, still the CPU's path and that of any engine other than Tak's),
// about 165 kernels a simulation: the gathers of the [B, 4P, n-1, S] shifted
// tops that decide each spread, the masking, the softmax, and some twenty
// indexed stores of the guarded expansion.  Kernel A (csrc/topk.cu) picks the
// children between the two kernels here:
//
//   * expand_mask_kernel, before kernel A, a block a (lane, chunk of 2048
//     actions): the legal mask of the lane's evaluated state, as
//     TakEngine.legal_mask decides it, and kernel A's input, the logits where
//     legal and -3e38 elsewhere, float32 [B, A]; each block writes its count
//     of legal actions.  A spread is decided from runs of passable squares:
//     the block first counts, for each square and direction, the empty or
//     flat squares in a row from the square's neighbour (in shared memory),
//     so that a spread of k drops is legal where the mover controls the
//     square outside the swap plies, carry <= min(height, n), the run covers
//     the first k - 1 drops, and the k-th square is passable or a wall that
//     a lone capstone crushes.  The drop pattern gives k, the carry and the
//     last drop as moves.py decode_pattern does (settle.cu decodes it alike).
//   * expand_store_kernel, after kernel A, a block a lane and a thread a
//     child slot: the leaf's and the root's statistics, the children's
//     priors (max, expf, the sum in the order of torch's CUDA reduction, one
//     division), and every store of the guarded expansion into the allocated
//     row (the root's where the lane expands its root, the scratch row where
//     it expands nothing), in the batched path's order: the statistics, then
//     the row, then the parent's link and the lane's counters.  A lane owns
//     its counters, so there are no atomics.
//
// Bound on an H100: at [128 lanes, 6x6] the mask reads the logits (9036 a
// lane, 2.3 MB in bf16, 4.6 MB in float32) and writes 4.6 MB of float32, and
// the stores write ten [C] rows and a state a lane, about 1.3 MB at C = 256:
// about 3 us in all at 3.35 TB/s.
//
// Exact: the mask is integer; the statistics are the batched path's float32
// operations in its order, a subtraction, a division and an addition with no
// contraction (the __f*_rn intrinsics); the priors' sum adds the same terms in
// the order torch's reduction adds them for the layout the wrapper passes
// (the block width of one row and whether its loads are vectorised; see
// search/lanewise.py softmax_sum), and expf and the division are correctly
// the library's, so the trees are the batched path's bit for bit.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSquares = 64;
constexpr int kMaxChildren = 1024;
constexpr int kMaskThreads = 256;
constexpr int kMaskChunk = 2048;  // actions a mask block
constexpr float kNeg = -3.0e38f;

// The tensors of a mask, in the order of ops/tree.py's expand_mask.
struct Mask {
  const int* height;         // [B, S]
  const long long* owner;    // [B, S]
  const int* tops;           // [B, S]
  const int* reserves;       // [B, 2, 2]
  const int* to_move;        // [B]
  const int* ply;            // [B]
  const void* logits;        // [B, A] rows (float32 or bfloat16), a row every logits_row elements
  float* masked;             // [B, A]
  int* legal;                // [B, chunks]: legal actions of each chunk
};
static_assert(sizeof(Mask) == 9 * sizeof(void*), "Mask holds only pointers");

struct MaskShape {
  int n, actions, chunks, logits_bf16;
  long long logits_row;
};

// The tensors of a store, in the order of ops/tree.py's expand_store.
struct Store {
  // The tree.
  int* child_action;          // [B, M, C]
  float* child_logit;
  float* child_prob;
  int* child_visit;
  int* child_flag;
  int* child_ply;
  float* child_value;
  float* child_std;
  int* child_node;
  int* node_parent;           // [B, M]
  int* node_slot;
  bool* node_incomplete;
  bool* node_live;
  const int* free_rows;
  int* node_count;            // [B]
  int* alloc_ptr;
  const int* free_count;
  const int* root_visit;
  float* root_value;
  float* root_std;
  int* overflow;
  // The node pool's states.
  int* env_height;            // [B, M, S]
  long long* env_owner;       // [B, M, S]
  int* env_tops;              // [B, M, S]
  int* env_reserves;          // [B, M, 2, 2]
  int* env_to_move;           // [B, M]
  int* env_ply;
  int* env_reversible;
  // settle's outputs.
  const bool* lane_eval_leaf;   // [B]
  const bool* lane_eval_root;
  const bool* lane_root_expand;
  const long long* leaf_parent;
  const long long* leaf_slot;
  const int* eval_height;       // [B, S]: the evaluated states
  const long long* eval_owner;
  const int* eval_tops;
  const int* eval_reserves;     // [B, 2, 2]
  const int* eval_to_move;      // [B]
  const int* eval_ply;
  const int* eval_reversible;
  // Kernel A's children, the mask's counts and the evaluation.
  const float* top_vals;      // [B, C]
  const int* top_idx;         // [B, C]
  const int* legal;           // [B, chunks]
  const float* v_net;         // [B]
  const float* var_net;       // [B]
};
constexpr int kStorePointers = 45;
static_assert(sizeof(Store) == kStorePointers * sizeof(void*), "Store holds only pointers");

struct StoreShape {
  int m, c, s, chunks, sum_width, sum_vectorised;
};

// torch's int64 right shift: the sign for a count outside [0, 63).
__device__ __forceinline__ long long shr64(long long a, long long k) {
  return (k < 0 || k >= 63) ? (a >> 63) : (a >> k);
}

// torch's max: NaN wins.
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

__global__ void __launch_bounds__(kMaskThreads) expand_mask_kernel(Mask p, MaskShape sh) {
  __shared__ int s_tops[kMaxSquares], s_height[kMaxSquares];
  __shared__ bool s_control[kMaxSquares];
  __shared__ int s_run[4][kMaxSquares];
  __shared__ int s_count;
  const int b = blockIdx.x, t = threadIdx.x, n = sh.n, s = n * n;
  const int me = p.to_move[b];
  const bool swap = p.ply[b] < 2;
  const int stones = p.reserves[b * 4 + me * 2], caps = p.reserves[b * 4 + me * 2 + 1];

  for (int q = t; q < s; q += kMaskThreads) {
    const int h = p.height[static_cast<size_t>(b) * s + q], top = p.tops[static_cast<size_t>(b) * s + q];
    const int color = static_cast<int>(shr64(p.owner[static_cast<size_t>(b) * s + q], max(h - 1, 0)) & 1);
    s_tops[q] = top;
    s_height[q] = h;
    s_control[q] = top > 0 && color == me && !swap;
  }
  if (t == 0) s_count = 0;
  __syncthreads();
  // The passable squares (empty or flat) in a row from q's neighbour in
  // direction d (moves.py DIR_DELTAS: up, right, down, left).
  for (int i = t; i < 4 * s; i += kMaskThreads) {
    const int d = i / s, q = i % s;
    const int dr = d == 0 ? 1 : (d == 2 ? -1 : 0), dc = d == 1 ? 1 : (d == 3 ? -1 : 0);
    int r = q / n + dr, c = q % n + dc, steps = 0;
    while (0 <= r && r < n && 0 <= c && c < n && s_tops[r * n + c] <= 1) {
      ++steps;
      r += dr;
      c += dc;
    }
    s_run[d][q] = steps;
  }
  __syncthreads();

  const int patterns = (1 << n) - 2;
  const size_t row = static_cast<size_t>(b) * sh.actions;
  const long long logits_row = static_cast<long long>(b) * sh.logits_row;
  const int first = blockIdx.y * kMaskChunk, last_action = min(first + kMaskChunk, sh.actions);
  int count = 0;
  for (int a = first + t; a < last_action; a += kMaskThreads) {
    const int ch = a / s, q = a - ch * s;
    bool legal;
    if (ch < 3) {  // placements: the swap plies place the opponent's flat
      const bool empty = s_tops[q] == 0;
      legal = ch == 0 ? empty && (swap || stones > 0) : (ch == 1 ? empty && !swap && stones > 0 : empty && !swap && caps > 0);
    } else {
      const int si = ch - 3, d = si / patterns, mask = si % patterns + 1;
      const int k = __popc(mask), carry = n - (__ffs(mask) - 1), last = n - (31 - __clz(mask));
      const int run = s_run[d][q];
      legal = s_control[q] && carry <= min(s_height[q], n) && run >= k - 1;
      if (legal && run < k) {  // the k-th square: off the board, a wall or a capstone
        const int dr = d == 0 ? 1 : (d == 2 ? -1 : 0), dc = d == 1 ? 1 : (d == 3 ? -1 : 0);
        const int r = q / n + k * dr, c = q % n + k * dc;
        legal = last == 1 && s_tops[q] == 3 && 0 <= r && r < n && 0 <= c && c < n && s_tops[r * n + c] == 2;
      }
    }
    const float logit = sh.logits_bf16
                            ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.logits)[logits_row + a])
                            : static_cast<const float*>(p.logits)[logits_row + a];
    p.masked[row + a] = legal ? logit : kNeg;
    count += legal;
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if ((t & 31) == 0) atomicAdd(&s_count, count);
  __syncthreads();
  if (t == 0) p.legal[static_cast<size_t>(b) * sh.chunks + blockIdx.y] = s_count;
}

// Thread t's partial sum of a row of c terms in torch's CUDA reduction
// (ATen Reduce.cuh input_vectorized_thread_reduce_impl and
// thread_reduce_impl, 4 accumulators a thread), for a row whose first term
// lies `shift` terms past a 16-byte boundary.
__device__ float thread_sum(const float* x, int c, int t, int width, bool vectorised, int shift) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (vectorised) {
    int base = 0, end = c;
    if (shift > 0) {
      if (t >= shift && t < 4) acc[0] = __fadd_rn(acc[0], x[t - shift]);
      base = 4 - shift;
      end = c - 4 + shift;
    }
    for (int j = t; 4 * j + 3 < end; j += width)
      for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], x[base + 4 * j + i]);
    const int tail = end - end % 4 + t;
    if (tail < end) acc[0] = __fadd_rn(acc[0], x[base + tail]);
  } else {
    int j = t;
    for (; j + 3 * width < c; j += 4 * width)
      for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], x[j + i * width]);
    for (int i = 0; i < 4 && j < c; ++i, j += width) acc[i] = __fadd_rn(acc[i], x[j]);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

__global__ void __launch_bounds__(kMaxChildren) expand_store_kernel(Store p, StoreShape sh) {
  __shared__ float s_ex[kMaxChildren], s_part[kMaxChildren];
  __shared__ float s_v_after, s_s_after, s_sum;
  __shared__ int s_node, s_parent, s_slot, s_legal;
  __shared__ bool s_leaf_expand, s_expanding;
  const int b = blockIdx.x, j = threadIdx.x, m = sh.m, c = sh.c, s = sh.s;
  const size_t lane_nodes = static_cast<size_t>(b) * m;

  if (j == 0) {
    // Every read of the tree first, then the statistics' stores.
    const int parent = static_cast<int>(p.leaf_parent[b]), slot = static_cast<int>(p.leaf_slot[b]);
    const bool eval_leaf = p.lane_eval_leaf[b], eval_root = p.lane_eval_root[b], root_expand = p.lane_root_expand[b];
    const size_t edge = (lane_nodes + parent) * c + slot;
    const float v_net = p.v_net[b], sd_net = __fsqrt_rn(p.var_net[b]);
    const float n_leaf = fmaxf(static_cast<float>(p.child_visit[edge]), 1.0f);
    const float old_v = p.child_value[edge], old_s = p.child_std[edge];
    const float leaf_v = __fadd_rn(old_v, __fdiv_rn(__fsub_rn(v_net, old_v), n_leaf));
    const float leaf_s = __fadd_rn(old_s, __fdiv_rn(__fsub_rn(sd_net, old_s), n_leaf));
    const float rn = fmaxf(static_cast<float>(p.root_visit[b]), 1.0f);
    const float root_v0 = p.root_value[b], root_s0 = p.root_std[b];
    const float root_v = __fadd_rn(root_v0, __fdiv_rn(__fsub_rn(v_net, root_v0), rn));
    const float root_s = __fadd_rn(root_s0, __fdiv_rn(__fsub_rn(sd_net, root_s0), rn));
    const bool already = p.child_node[edge] >= 0 && !root_expand;
    const int ptr = p.alloc_ptr[b];
    const int alloc_row = p.free_rows[lane_nodes + min(max(ptr, 0), m - 1)];
    const bool can_expand = root_expand || ptr < p.free_count[b];
    const bool evaluated = eval_leaf || eval_root;
    const bool expanding = evaluated && can_expand && !already;
    int legal = 0;
    for (int i = 0; i < sh.chunks; ++i) legal += p.legal[static_cast<size_t>(b) * sh.chunks + i];

    const size_t stats = (lane_nodes + (eval_leaf ? parent : m - 1)) * c + slot;
    p.child_value[stats] = leaf_v;
    p.child_std[stats] = leaf_s;
    if (eval_root) {
      p.root_value[b] = root_v;
      p.root_std[b] = root_s;
    }
    if (evaluated && !can_expand) p.overflow[b] += 1;
    s_v_after = eval_root ? root_v : leaf_v;
    s_s_after = eval_root ? root_s : leaf_s;
    s_node = expanding ? (root_expand ? 0 : alloc_row) : m - 1;
    s_parent = parent;
    s_slot = slot;
    s_legal = legal;
    s_expanding = expanding;
    s_leaf_expand = expanding && eval_leaf;
  }

  // The priors: a softmax over the valid children.
  const float val = j < c ? p.top_vals[static_cast<size_t>(b) * c + j] : kNeg;
  const bool valid = val > kNeg * 0.5f;
  float mx = valid ? val : __int_as_float(0xff800000);  // -inf
  for (int off = 16; off > 0; off >>= 1) mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((j & 31) == 0) s_part[j >> 5] = mx;
  __syncthreads();
  mx = s_part[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) mx = max_nan(mx, s_part[w]);
  const float ex = valid ? expf(__fsub_rn(val, mx)) : 0.0f;
  if (j < c) s_ex[j] = ex;
  __syncthreads();
  const int width = sh.sum_width;
  if (j < width)
    s_part[j] = thread_sum(s_ex, c, j, width, sh.sum_vectorised, static_cast<int>((static_cast<long long>(b) * c) % 4));
  __syncthreads();
  for (int half = width >> 1; half > 0; half >>= 1) {
    if (j < half) s_part[j] = __fadd_rn(s_part[j], s_part[j + half]);
    __syncthreads();
  }
  if (j == 0) {
    const float sum = s_part[0];
    s_sum = sum != sum ? sum : fmaxf(sum, 1e-30f);  // torch's clamp(min=1e-30)
  }
  __syncthreads();

  // The row of the new node (the root's, or the scratch row's).
  const int node = s_node;
  if (j < c) {
    const size_t at = (lane_nodes + node) * c + j;
    p.child_action[at] = valid ? p.top_idx[static_cast<size_t>(b) * c + j] : -1;
    p.child_logit[at] = valid ? val : 0.0f;
    p.child_prob[at] = __fdiv_rn(ex, s_sum);
    p.child_visit[at] = 0;
    p.child_flag[at] = 0;
    p.child_ply[at] = 0;
    p.child_value[at] = -s_v_after;
    p.child_std[at] = s_s_after;
    p.child_node[at] = -1;
  }
  const size_t to = lane_nodes + node;
  for (int q = j; q < s; q += blockDim.x) {
    p.env_height[to * s + q] = p.eval_height[static_cast<size_t>(b) * s + q];
    p.env_owner[to * s + q] = p.eval_owner[static_cast<size_t>(b) * s + q];
    p.env_tops[to * s + q] = p.eval_tops[static_cast<size_t>(b) * s + q];
  }
  if (j < 4) p.env_reserves[to * 4 + j] = p.eval_reserves[b * 4 + j];
  if (j == 0) {
    const bool leaf_expand = s_leaf_expand;
    p.env_to_move[to] = p.eval_to_move[b];
    p.env_ply[to] = p.eval_ply[b];
    p.env_reversible[to] = p.eval_reversible[b];
    p.node_parent[to] = leaf_expand ? s_parent : -1;
    p.node_slot[to] = leaf_expand ? s_slot : -1;
    p.node_incomplete[to] = s_legal > c;
    p.node_live[to] = s_expanding;
  }
  __syncthreads();

  // The parent's link (the scratch row's where the lane expands no leaf) and
  // the lane's counters.
  if (j == 0) {
    const bool leaf_expand = s_leaf_expand;
    p.child_node[(lane_nodes + (leaf_expand ? s_parent : m - 1)) * c + s_slot] = node;
    p.node_count[b] += leaf_expand;
    p.alloc_ptr[b] += leaf_expand;
  }
}

}  // namespace

// The legal mask and kernel A's input of every lane's evaluated state (n x n
// squares, 3 <= n <= 8; `actions` = the engine's), in `chunks` blocks a lane.
// `pointers` holds the tensors' addresses in Mask's order.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int expand_mask_launch(const void* const* pointers, int b, int n, int actions, int chunks,
                                  long long logits_row, int logits_bf16, void* stream) {
  if (n < 3 || n * n > kMaxSquares || actions < 1 || chunks != (actions + kMaskChunk - 1) / kMaskChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  Mask p;
  std::memcpy(&p, pointers, sizeof(p));
  const MaskShape sh{n, actions, chunks, logits_bf16, logits_row};
  expand_mask_kernel<<<dim3(b, chunks), kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, sh);
  return static_cast<int>(cudaGetLastError());
}

// The guarded expansion of every lane of a batch of trees (child arrays
// [b, m, c], c <= 1024, states over s squares) from kernel A's children, in
// place.  `sum_width` and `sum_vectorised` are the layout of torch's CUDA sum
// over a [b, c] row.  `pointers` holds the tensors' addresses in Store's
// order.  Returns the CUDA error code of the launch (0 on success).
extern "C" int expand_store_launch(const void* const* pointers, int b, int m, int c, int s, int chunks, int sum_width,
                                   int sum_vectorised, void* stream) {
  if (m < 1 || c < 1 || c > kMaxChildren || s < 1 || s > kMaxSquares || chunks < 1 || sum_width < 1 ||
      sum_width > c || (sum_width & (sum_width - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Store p;
  std::memcpy(&p, pointers, sizeof(p));
  const StoreShape sh{m, c, s, chunks, sum_width, sum_vectorised};
  const int threads = (c + 31) / 32 * 32;
  expand_store_kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(p, sh);
  return static_cast<int>(cudaGetLastError());
}
