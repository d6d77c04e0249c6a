// The search's descent and backup: one thread block a tree, walking one path.
//
// Replaces no TPU kernel.  The JAX package runs both walks as lax.while_loop
// and fori_loop over the whole batch (takzero_tpu/search/core.py forward :101,
// backward :430); the port ran them as Python loops of batched operators
// (search/core.py descend and backward, still the CPU's path), about 80
// operators and one host read a level for the descent and about 139 a level
// for the backup.  Each lane of the batch is an independent tree, so each
// walk is a path of dependent levels within one lane: these kernels give a
// lane a block and walk its whole path with no host read, so that a
// simulation can be captured whole in CUDA graphs.
//
//   * tree_descend_kernel: from the root to the first unexpanded child or to
//     max_depth; at each level thread s scores child slot s (PUCT with the
//     search's c_rate, proven-win pruning unless the node is a LOSS) and the
//     block takes the argmax (first index on ties, NaN first, as argmax);
//     the forced slot replaces it at depth 0.  It writes every output of
//     search/core.py _descent_buffers and adds the root's visit.
//   * tree_backup_kernel: from the lane's own length - 1 down to the root (to
//     depth 1 under skip_root); at each level thread s reads child s of the
//     path's node for the exact solver (argmin_eval: the least primary key,
//     then the least secondary among the ties, first index; all known; the
//     node's incompleteness), then the slot's owner updates the parent slot's
//     (or the root's) statistics and the value propagated upward.
//
// Bound on an H100: the work is a few thousand flops and, at [128 lanes,
// C = 256], about 8 KB read a level a lane (a node's row of 7 int32/f32
// arrays): 5-6 levels read about 6 MB, 1.8 us at 3.35 TB/s.  Neither bound
// binds: the levels are dependent, so the time is the levels' latency (a
// row load, two block reductions and one dependent store a level).  One
// block a lane keeps every lane's walk on its own SM (128 of the 132).
//
// Exact arithmetic: the float work repeats the batched torch loops on the
// card operation for operation, so that trees stay bit-equal to them:
// explicit round-to-nearest intrinsics (no FMA contraction, which nvcc does
// by default for a * b + c), logf / sqrt / powf as torch's CUDA kernels call
// them, and the scalar divisions as torch's CUDA division by a scalar does
// them, a multiplication by the scalar's float reciprocal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kValue = 0, kWin = 1, kLoss = 2, kDraw = 3;
constexpr float kDiscount = 0.997f;
constexpr float kDiscount2 = static_cast<float>(0.997 * 0.997);  // Python's DISCOUNT**2, then float32
constexpr float kContempt = -0.05f;
constexpr float kNeg = -3.0e38f;  // search/core.py NEG
constexpr float kBig = 3.4e38f;   // search/eval.py _BIG
constexpr float kInv500 = 1.0f / 500.0f;
constexpr int kNone = 0x7fffffff;  // no slot: a thread past the row's end
constexpr int kMaxThreads = 1024;

struct Tree {
  const int* action;      // [B, M, C]
  int* flag;              // [B, M, C]
  int* ply;               // [B, M, C]
  float* value;           // [B, M, C]
  const float* prob;      // [B, M, C]
  float* std_;            // [B, M, C]
  const int* visit;       // [B, M, C]
  const int* node;        // [B, M, C]
  const bool* incomplete; // [B, M]
  int* root_visit;        // [B]
  int* root_flag;
  int* root_ply;
  float* root_value;
  float* root_std;
  int m, c;
};

struct Descent {
  const float* beta;        // [B] at stride beta_stride
  const long long* forced;  // [B] or null
  bool* lane_root_expand;   // [B]
  long long* cur;
  int* cur_flag;
  bool* active;
  int* path_node;           // [B, depth]
  int* path_slot;
  int* length;
  bool* stop_known;
  int* known_f;
  int* known_p;
  float* known_v;
  bool* stop_leaf;
  long long* leaf_parent;
  long long* leaf_slot;
  int depth, skip_root, beta_stride;
};

struct Backup {
  const int* path_node;     // [B, depth]
  const int* path_slot;
  const int* length;        // [B]
  const bool* stop_known;
  const int* known_f;
  const int* known_p;
  const float* known_v;
  const bool* lane_eval_leaf;
  const float* v_net;
  const float* var_net;
  int depth, skip_root, mode;  // mode 0 "all", 1 "known", 2 "leaf"
};

// search/eval.py eval_to_float, torch's order: base * gamma^ply.
__device__ __forceinline__ float eval_to_float(int flag, int ply, float value) {
  const float sign = flag == kWin ? 1.0f : (flag == kLoss ? -1.0f : 0.0f);
  const float base = flag == kValue ? value : sign;
  const float disc = flag == kValue ? 1.0f : powf(kDiscount, static_cast<float>(ply));
  return __fmul_rn(base, disc);
}

__device__ __forceinline__ int negate_flag(int flag) {
  return flag == kWin ? kLoss : (flag == kLoss ? kWin : flag);
}

__device__ __forceinline__ int negate_ply(int flag, int ply) { return flag == kValue ? ply : ply + 1; }

// search/eval.py negated_float: the q-value of a child.
__device__ __forceinline__ float negated_float(int flag, int ply, float value) {
  return eval_to_float(negate_flag(flag), negate_ply(flag, ply), -value);
}

// (value, index) pairs reduced as torch's argmax (greater, NaN first, lower
// index on ties) or argmin (less, NaN first, lower index on ties).
struct Pick {
  float v;
  int i;
};

template <bool kMax>
__device__ __forceinline__ Pick better(Pick a, Pick b) {
  if (b.i == kNone) return a;
  if (a.i == kNone) return b;
  const bool an = isnan(a.v), bn = isnan(b.v);
  bool take_a;
  if (an || bn) {
    take_a = an && (!bn || a.i < b.i);
  } else if (a.v == b.v) {
    take_a = a.i < b.i;
  } else {
    take_a = kMax ? a.v > b.v : a.v < b.v;
  }
  return take_a ? a : b;
}

// The block's best pair; every thread gets it.  `scratch` holds one pair a warp.
template <bool kMax>
__device__ Pick block_pick(Pick p, Pick* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    Pick o{__shfl_down_sync(0xffffffffu, p.v, off), __shfl_down_sync(0xffffffffu, p.i, off)};
    p = better<kMax>(p, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < warps ? scratch[lane] : Pick{0.0f, kNone};
    for (int off = 16; off > 0; off >>= 1) {
      Pick o{__shfl_down_sync(0xffffffffu, p.v, off), __shfl_down_sync(0xffffffffu, p.i, off)};
      p = better<kMax>(p, o);
    }
    if (lane == 0) scratch[0] = p;
  }
  __syncthreads();
  p = scratch[0];
  __syncthreads();  // scratch free for the next reduction
  return p;
}

// torch's min of two floats: NaN if either is.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b < a ? b : a;
}

// The least value of the block (threads with no entry hold +inf, which
// changes no minimum); `scratch` holds one value a warp.
__device__ float block_min(float v, bool has, float* scratch) {
  const float inf = __int_as_float(0x7f800000);
  v = has ? v : inf;
  for (int off = 16; off > 0; off >>= 1) v = nan_min(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < warps ? scratch[lane] : inf;
    for (int off = 16; off > 0; off >>= 1) v = nan_min(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  v = scratch[0];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kMaxThreads) tree_descend_kernel(Tree t, Descent o) {
  __shared__ Pick scratch[32];
  __shared__ long long s_cur;
  __shared__ int s_cur_flag, s_cur_visit, s_active;
  const int b = blockIdx.x, s = threadIdx.x, c = t.c;
  const bool has = s < c;
  const size_t lane_rows = static_cast<size_t>(b) * t.m;

  for (int d = s; d < o.depth; d += blockDim.x) {
    o.path_node[static_cast<size_t>(b) * o.depth + d] = -1;
    o.path_slot[static_cast<size_t>(b) * o.depth + d] = -1;
  }
  const bool expanded = __syncthreads_or(has && t.action[lane_rows * c + s] >= 0);
  const float beta = o.beta[static_cast<size_t>(b) * o.beta_stride];
  if (s == 0) {
    const int root_visit = t.root_visit[b] + (o.skip_root ? 0 : 1);
    t.root_visit[b] = root_visit;
    s_cur = 0;
    s_cur_flag = t.root_flag[b];
    s_cur_visit = root_visit;
    s_active = expanded;
    o.lane_root_expand[b] = !expanded && t.root_flag[b] == kValue;
    o.length[b] = 0;
    o.stop_known[b] = false;
    o.known_f[b] = 0;
    o.known_p[b] = 0;
    o.known_v[b] = 0.0f;
    o.stop_leaf[b] = false;
    o.leaf_parent[b] = 0;
    o.leaf_slot[b] = 0;
  }
  __syncthreads();

  for (int d = 0; d < o.depth && s_active; ++d) {
    const long long cur = s_cur;
    const int cur_flag = s_cur_flag;
    const size_t at = (lane_rows + static_cast<size_t>(cur)) * c + s;
    int flag = 0, ply = 0, visit = 0, node = -1;
    float value = 0.0f, score = 0.0f;
    bool valid = false, unpruned = false;
    if (has) {
      const int action = t.action[at];
      flag = t.flag[at];
      ply = t.ply[at];
      value = t.value[at];
      visit = t.visit[at];
      node = t.node[at];
      const float prob = t.prob[at], sd = t.std_[at];
      valid = action >= 0;
      const float q = negated_float(flag, ply, value);
      const float pv = static_cast<float>(s_cur_visit);
      // torch.log((1 + pv + 500) / 500) + 4, the division by the scalar as
      // torch's CUDA kernel does it.
      const float c_rate = __fadd_rn(logf(__fmul_rn(__fadd_rn(__fadd_rn(pv, 1.0f), 500.0f), kInv500)), 4.0f);
      const float u = __fdiv_rn(__fmul_rn(__fmul_rn(c_rate, prob), __fsqrt_rn(pv)),
                                __fadd_rn(static_cast<float>(visit), 1.0f));
      score = __fadd_rn(__fadd_rn(q, u), __fmul_rn(beta, sd));
      unpruned = valid && !(flag == kWin && cur_flag != kLoss);
    }
    // An incomplete node may hold only proven-win children: select among
    // them rather than an invalid slot.
    const bool any_unpruned = __syncthreads_or(unpruned);
    int slot;
    if (o.forced != nullptr && d == 0) {
      slot = static_cast<int>(o.forced[b]);
    } else {
      const bool pick = any_unpruned ? unpruned : valid;
      slot = block_pick<true>(Pick{pick ? score : kNeg, has ? s : kNone}, scratch).i;
    }
    if (s == slot) {  // the chosen slot's thread holds its child
      const size_t p = static_cast<size_t>(b) * o.depth + d;
      o.path_node[p] = static_cast<int>(cur);
      o.path_slot[p] = slot;
      if (node < 0) {
        o.length[b] = d + 1;
        if (flag != kValue) {
          o.stop_known[b] = true;
          o.known_f[b] = flag;
          o.known_p[b] = ply;
          o.known_v[b] = value;
        } else {
          o.stop_leaf[b] = true;
          o.leaf_parent[b] = cur;
          o.leaf_slot[b] = slot;
        }
        s_active = 0;
      } else {
        s_cur = node;
        s_cur_flag = flag;
        s_cur_visit = visit + 1;  // this simulation's visit
      }
    }
    __syncthreads();
  }
  if (s == 0) {
    o.cur[b] = s_cur;
    o.cur_flag[b] = s_cur_flag;
    o.active[b] = s_active != 0;
  }
}

__global__ void __launch_bounds__(kMaxThreads) tree_backup_kernel(Tree t, Backup r) {
  __shared__ Pick scratch[32];
  __shared__ int s_pf, s_pp;
  __shared__ float s_pv, s_pvar;
  const int b = blockIdx.x, s = threadIdx.x, c = t.c;
  const bool has = s < c;
  const bool known = r.stop_known[b];
  const bool active = r.mode == 0 ? known || r.lane_eval_leaf[b] : (r.mode == 1 ? known : r.lane_eval_leaf[b]);
  if (!active) return;  // the whole block leaves together
  const size_t lane_rows = static_cast<size_t>(b) * t.m;
  const size_t path = static_cast<size_t>(b) * r.depth;
  if (s == 0) {
    s_pf = known ? r.known_f[b] : kValue;
    s_pp = known ? r.known_p[b] : 0;
    s_pv = known ? r.known_v[b] : __fmul_rn(r.v_net[b], kDiscount);
    s_pvar = known ? 0.0f : __fmul_rn(r.var_net[b], kDiscount2);
  }
  __syncthreads();
  const int min_j = r.skip_root ? 1 : 0;

  for (int j = r.length[b] - 1; j >= min_j; --j) {
    const int node_j = max(r.path_node[path + j], 0);
    const size_t at = (lane_rows + node_j) * c + s;
    int flag = 0, ply = 0;
    float value = 0.0f, primary = kBig, secondary = 0.0f;
    bool valid = false;
    if (has) {
      valid = t.action[at] >= 0;
      flag = t.flag[at];
      ply = t.ply[at];
      value = t.value[at];
      const float plyf = static_cast<float>(ply);
      // search/eval.py order_keys, then argmin_eval's masks.
      const float key = flag == kLoss ? -2.0f : (flag == kWin ? 2.0f : (flag == kDraw ? kContempt : value));
      primary = valid ? key : kBig;
      secondary = flag == kLoss ? plyf : ((flag == kWin || flag == kDraw) ? -plyf : 0.0f);
    }
    const bool any_valid = __syncthreads_or(valid);
    const bool all_known = __syncthreads_and(!has || !valid || flag != kValue) && any_valid;
    const float least = block_min(primary, has, reinterpret_cast<float*>(scratch));
    const bool tie = primary == least;
    const int mi = block_pick<false>(Pick{tie && valid ? secondary : kBig, has ? s : kNone}, scratch).i;

    if (s == mi) {  // the worst child's thread holds it: the solver and the update
      const int pf = s_pf, pp = s_pp;
      const float pv = s_pv, pvar = s_pvar;
      const int solved_f = negate_flag(flag), solved_p = negate_ply(flag, ply);
      const float solved_v = -value;
      int* sf_at;
      int* sp_at;
      float* sv_at;
      float* ss_at;
      int svisit;
      if (j == 0) {
        sf_at = t.root_flag + b;
        sp_at = t.root_ply + b;
        sv_at = t.root_value + b;
        ss_at = t.root_std + b;
        svisit = t.root_visit[b];
      } else {
        const int pn = max(r.path_node[path + j - 1], 0), ps = max(r.path_slot[path + j - 1], 0);
        const size_t p = (lane_rows + pn) * c + ps;
        sf_at = t.flag + p;
        sp_at = t.ply + p;
        sv_at = t.value + p;
        ss_at = t.std_ + p;
        svisit = t.visit[p];
      }
      const int sf = *sf_at, sp = *sp_at;
      const float sv = *sv_at, ss = *ss_at;
      const bool incomplete = t.incomplete[lane_rows + node_j];
      const bool trigger = pf == kLoss || (all_known && !incomplete);
      const int new_f = trigger ? solved_f : sf;
      const int new_p = trigger ? solved_p : sp;
      const bool known_now = new_f != kValue;
      const float negated = negated_float(pf, pp, pv);
      const float visf = fmaxf(static_cast<float>(svisit), 1.0f);
      const float val_upd = __fadd_rn(sv, __fdiv_rn(__fsub_rn(negated, sv), visf));
      const float std_upd = __fadd_rn(ss, __fdiv_rn(__fsub_rn(__fsqrt_rn(pvar), ss), visf));
      const float new_v = trigger ? solved_v : (known_now ? sv : val_upd);
      const float new_s = trigger ? 0.0f : (known_now ? ss : std_upd);
      *sf_at = new_f;
      *sp_at = new_p;
      *sv_at = new_v;
      *ss_at = new_s;
      s_pf = known_now ? new_f : kValue;
      s_pp = known_now ? new_p : 0;
      s_pv = known_now ? new_v : __fmul_rn(negated, kDiscount);
      s_pvar = known_now ? __fmul_rn(new_s, new_s) : __fmul_rn(pvar, kDiscount2);
    }
    __syncthreads();  // the parent's row and the propagated value, for the next level
  }
}

int threads_for(int c) { return ((c + 31) / 32) * 32; }

}  // namespace

// The descent of every lane of a batch of trees (child arrays [b, m, c],
// c <= 1024), its outputs written in place.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int tree_descend_launch(
    const void* action, const void* flag, const void* ply, const void* value, const void* prob,
    const void* std_, const void* visit, const void* node, void* root_flag, void* root_visit,
    const void* beta, const void* forced, void* lane_root_expand, void* cur, void* cur_flag,
    void* active, void* path_node, void* path_slot, void* length, void* stop_known, void* known_f,
    void* known_p, void* known_v, void* stop_leaf, void* leaf_parent, void* leaf_slot, int b, int m,
    int c, int depth, int skip_root, int beta_stride, void* stream) {
  if (c < 1 || c > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  Tree t{static_cast<const int*>(action), const_cast<int*>(static_cast<const int*>(flag)),
         const_cast<int*>(static_cast<const int*>(ply)), const_cast<float*>(static_cast<const float*>(value)),
         static_cast<const float*>(prob), const_cast<float*>(static_cast<const float*>(std_)),
         static_cast<const int*>(visit),
         static_cast<const int*>(node), nullptr, static_cast<int*>(root_visit), static_cast<int*>(root_flag),
         nullptr, nullptr, nullptr, m, c};
  Descent o{static_cast<const float*>(beta), static_cast<const long long*>(forced),
            static_cast<bool*>(lane_root_expand), static_cast<long long*>(cur), static_cast<int*>(cur_flag),
            static_cast<bool*>(active), static_cast<int*>(path_node), static_cast<int*>(path_slot),
            static_cast<int*>(length), static_cast<bool*>(stop_known), static_cast<int*>(known_f),
            static_cast<int*>(known_p), static_cast<float*>(known_v), static_cast<bool*>(stop_leaf),
            static_cast<long long*>(leaf_parent), static_cast<long long*>(leaf_slot), depth, skip_root,
            beta_stride};
  tree_descend_kernel<<<b, threads_for(c), 0, static_cast<cudaStream_t>(stream)>>>(t, o);
  return static_cast<int>(cudaGetLastError());
}

// The backup of every lane whose mode selects it (0 "all": known stops and
// evaluated leaves, 1 "known", 2 "leaf"), in place.  Returns the CUDA error
// code of the launch.
extern "C" int tree_backup_launch(
    const void* action, void* flag, void* ply, void* value, void* std_, const void* visit,
    const void* incomplete, void* root_visit, void* root_flag, void* root_ply, void* root_value,
    void* root_std, const void* path_node, const void* path_slot, const void* length,
    const void* stop_known, const void* known_f, const void* known_p, const void* known_v,
    const void* lane_eval_leaf, const void* v_net, const void* var_net, int b, int m, int c, int depth,
    int skip_root, int mode, void* stream) {
  if (c < 1 || c > kMaxThreads || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  Tree t{static_cast<const int*>(action), static_cast<int*>(flag), static_cast<int*>(ply),
         static_cast<float*>(value), nullptr, static_cast<float*>(std_),
         static_cast<const int*>(visit), nullptr, static_cast<const bool*>(incomplete),
         static_cast<int*>(root_visit), static_cast<int*>(root_flag), static_cast<int*>(root_ply),
         static_cast<float*>(root_value), static_cast<float*>(root_std), m, c};
  Backup r{static_cast<const int*>(path_node), static_cast<const int*>(path_slot),
           static_cast<const int*>(length), static_cast<const bool*>(stop_known),
           static_cast<const int*>(known_f), static_cast<const int*>(known_p),
           static_cast<const float*>(known_v), static_cast<const bool*>(lane_eval_leaf),
           static_cast<const float*>(v_net), static_cast<const float*>(var_net), depth, skip_root, mode};
  tree_backup_kernel<<<b, threads_for(c), 0, static_cast<cudaStream_t>(stream)>>>(t, r);
  return static_cast<int>(cudaGetLastError());
}
