// Reference-architecture MCTS throughput anchor (CPU).
//
// The reference (ViliamVadocz/takzero) is Rust and this image has no Rust
// toolchain, so its binaries cannot be built here.  To anchor BASELINE.md
// with a *measured* number instead of a convention, this is a faithful
// re-creation of the reference's search ARCHITECTURE in C++ on top of the
// same independent rules engine used by the fuzz oracle (tak_core.hpp):
//
//   * pointer tree, one heap node per expanded position, children as a
//     contiguous vector of edge stats    (takzero/src/search/node/mod.rs:14-23)
//   * sequential simulations: descend / expand / backup, game cloned and
//     advanced along the path            (takzero/src/search/mcts.rs:36-118)
//   * PUCT selection with the reference's exploration rate
//     c(N) = 4 + ln((N + 501)/500), Q from the negated child eval, and
//     proven-win child pruning           (node/mod.rs:104-147)
//   * exact solver propagation on the Eval algebra Value|Win|Loss|Draw
//     with ply counts and 0.997 discount (takzero/src/search/eval.rs)
//   * uniform-policy, zero-value evaluation (the reference's DummyAgent,
//     takzero/src/search/agent.rs) — deliberately NO network, so this
//     measures the search machinery alone.  The NN half of the reference
//     stack is anchored separately (tools/anchor.py runs the same-shape
//     ResNet under torch-CPU, the engine this host could actually run
//     LibTorch on), and BASELINE.md composes the two.
//
// Build & run:  make -C takzero_tpu/cpp bench && takzero_tpu/cpp/tak_mcts_bench
// Output: one JSON line {"sims_per_s": ..., ...}.

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "tak_core.hpp"

namespace {

using tak::Board;

constexpr float kDiscount = 0.997f;
enum Flag { VALUE = 0, WIN = 1, LOSS = 2, DRAW = 3 };

struct Node;

struct Child {
  int action;
  float prob;
  float value = 0.0f;  // running mean, child's POV negated into parent Q
  int visits = 0;
  int flag = VALUE;
  int ply = 0;
  Node* node = nullptr;  // null until expanded
};

struct Node {
  std::vector<Child> children;  // empty = unexpanded/terminal
  ~Node() {
    for (auto& c : children) delete c.node;
  }
};

float eval_to_float(int flag, int ply, float value) {
  if (flag == VALUE) return value;
  float sign = flag == WIN ? 1.0f : (flag == LOSS ? -1.0f : 0.0f);
  return sign * std::pow(kDiscount, static_cast<float>(ply));
}

// Q of a child edge from the parent's point of view (node/mod.rs:114-124).
float negated_q(const Child& c) {
  int f = c.flag == WIN ? LOSS : (c.flag == LOSS ? WIN : c.flag);
  int p = c.flag == VALUE ? c.ply : c.ply + 1;
  return eval_to_float(f, p, -c.value);
}

struct Search {
  int n, half_komi, reversible_limit;
  std::vector<uint8_t> mask;
  long long simulations = 0;

  explicit Search(int n_, int hk, int rl)
      : n(n_), half_komi(hk), reversible_limit(rl),
        mask(tak::num_actions(n_)) {}

  // Expand `node` for `b`; returns the leaf evaluation (node POV):
  // terminal eval, or Value(0) with uniform priors (DummyAgent).
  void expand(Node* node, const Board& b, int& flag, int& ply, float& value) {
    int res = tak::result(b);
    if (res >= 0) {
      // result: 0 white / 1 black / 2 draw; POV of the player to move.
      flag = res == 2 ? DRAW : (res == b.to_move ? WIN : LOSS);
      ply = 0;
      value = 0.0f;
      return;
    }
    tak::legal_mask(b, mask.data());
    int count = 0;
    for (size_t a = 0; a < mask.size(); ++a) count += mask[a];
    node->children.reserve(count);
    float p = 1.0f / static_cast<float>(count);
    for (size_t a = 0; a < mask.size(); ++a)
      if (mask[a]) node->children.push_back({static_cast<int>(a), p});
    flag = VALUE;
    ply = 0;
    value = 0.0f;
  }

  // One simulation from the root (mcts.rs:36-118): returns the root eval.
  void simulate(Node* node, Board b, int parent_visits, int& flag, int& ply,
                float& value) {
    ++simulations;
    if (node->children.empty()) {
      expand(node, b, flag, ply, value);
      return;
    }
    // PUCT selection with proven-win-child pruning (node/mod.rs:104-147).
    float c_rate =
        std::log((1.0f + parent_visits + 500.0f) / 500.0f) + 4.0f;
    float sqrt_n = std::sqrt(static_cast<float>(parent_visits));
    Child* best = nullptr;
    float best_score = -3.0e38f;
    bool any_unpruned = false;
    for (auto& c : node->children) any_unpruned |= c.flag != WIN;
    for (auto& c : node->children) {
      if (any_unpruned && c.flag == WIN) continue;
      float score = negated_q(c) +
                    c_rate * c.prob * sqrt_n / (1.0f + c.visits);
      if (score > best_score) {
        best_score = score;
        best = &c;
      }
    }
    tak::step(b, best->action);
    int cf, cp;
    float cv;
    if (best->flag != VALUE) {
      // Already proven: re-backup the known eval (the reference descends
      // only unproven lines; proven edges still feed the running means).
      cf = best->flag, cp = best->ply, cv = best->value;
    } else if (best->node == nullptr) {
      best->node = new Node();
      expand(best->node, b, cf, cp, cv);
    } else {
      simulate(best->node, b, best->visits, cf, cp, cv);
    }
    // Edge update (child POV): running mean + proof adoption.
    best->visits += 1;
    if (cf != VALUE) {
      best->flag = cf;
      best->ply = cp;
    } else {
      best->value += (cv - best->value) / static_cast<float>(best->visits);
    }
    // Solver at this node (mcts.rs:171-225): any losing child proves a
    // win; all children proven proves the negation of the best child.
    int win_ply = 1 << 30;
    bool all_known = true, any_loss = false, any_draw = false;
    int worst_ply = 0;
    for (auto& c : node->children) {
      if (c.flag == LOSS) {
        any_loss = true;
        win_ply = std::min(win_ply, c.ply + 1);
      }
      if (c.flag == VALUE) all_known = false;
      if (c.flag == DRAW) any_draw = true;
      worst_ply = std::max(worst_ply, c.ply + 1);
    }
    if (any_loss) {
      flag = WIN, ply = win_ply, value = 0.0f;
    } else if (all_known) {
      flag = any_draw ? DRAW : LOSS;
      ply = worst_ply;
      value = 0.0f;
    } else {
      flag = VALUE, ply = 0, value = -cv;  // negate child value into our POV
    }
  }

  // Visit-count move selection (node/mod.rs best action).
  int best_action(const Node* node) const {
    int best = -1, bv = -1;
    for (auto& c : node->children)
      if (c.visits > bv) bv = c.visits, best = c.action;
    return best;
  }
};

uint64_t xorshift(uint64_t& s) {
  s ^= s << 13;
  s ^= s >> 7;
  s ^= s << 17;
  return s;
}

}  // namespace

int main(int argc, char** argv) {
  int n = 6, half_komi = 4, reversible_limit = 50;
  int budget = 768;       // selfplay/src/main.rs:45
  int games = 8, max_moves = 20, random_plies = 4;
  double min_seconds = 10.0;
  for (int i = 1; i + 1 < argc; i += 2) {
    if (!std::strcmp(argv[i], "--budget")) budget = std::atoi(argv[i + 1]);
    if (!std::strcmp(argv[i], "--games")) games = std::atoi(argv[i + 1]);
    if (!std::strcmp(argv[i], "--moves")) max_moves = std::atoi(argv[i + 1]);
    if (!std::strcmp(argv[i], "--size")) n = std::atoi(argv[i + 1]);
  }

  Search search(n, half_komi, reversible_limit);
  uint64_t rng = 0x9e3779b97f4a7c15ULL;
  auto t0 = std::chrono::steady_clock::now();
  double elapsed = 0.0;
  int moves_played = 0;

  for (int g = 0; elapsed < min_seconds || g < games; ++g) {
    Board b;
    b.n = n;
    b.half_komi = half_komi;
    b.reversible_limit = reversible_limit;
    for (auto& sq : b.sq) sq = tak::Square{};
    // Standard Tak reserves (tak/moves.py DEFAULT_RESERVES).
    static const int kStones[9] = {0, 0, 0, 10, 15, 21, 30, 40, 50};
    static const int kCaps[9] = {0, 0, 0, 0, 0, 1, 1, 2, 2};
    b.reserves[0][0] = b.reserves[1][0] = kStones[n];
    b.reserves[0][1] = b.reserves[1][1] = kCaps[n];
    b.to_move = 0;
    b.ply = 0;
    b.reversible = 0;
    // Random opening plies (search/openings.py / reference opening books).
    for (int p = 0; p < random_plies && tak::result(b) < 0; ++p) {
      tak::legal_mask(b, search.mask.data());
      std::vector<int> legal;
      for (size_t a = 0; a < search.mask.size(); ++a)
        if (search.mask[a]) legal.push_back(static_cast<int>(a));
      tak::step(b, legal[xorshift(rng) % legal.size()]);
    }

    Node* root = new Node();
    for (int mv = 0; mv < max_moves && tak::result(b) < 0; ++mv) {
      int flag, ply;
      float value;
      for (int s = 0; s < budget; ++s) {
        int visits = 0;
        for (auto& c : root->children) visits += c.visits;
        search.simulate(root, b, visits, flag, ply, value);
      }
      int action = search.best_action(root);
      tak::step(b, action);
      ++moves_played;
      // Tree reuse across moves (node/mod.rs descend, batched.rs:139).
      Node* next = nullptr;
      for (auto& c : root->children)
        if (c.action == action) {
          next = c.node;
          c.node = nullptr;
        }
      delete root;
      root = next ? next : new Node();
    }
    delete root;
    elapsed = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  }

  std::printf(
      "{\"metric\": \"reference_architecture_cpu_mcts\", "
      "\"sims_per_s\": %.1f, \"moves\": %d, \"budget\": %d, \"size\": %d, "
      "\"threads\": 1, \"evaluation\": \"dummy-uniform (no NN)\"}\n",
      static_cast<double>(search.simulations) / elapsed, moves_played,
      budget, n);
  return 0;
}
