// Native HNSW graph builder.
//
// The device runs every query (batched beam search in pyrope_tpu/index/hnsw.py),
// but graph CONSTRUCTION is inherently sequential — insert i depends on the
// graph state after insert i-1 — so it belongs on the host, in native code.
// This is the rebuild's analog of the reference's compiled-engine insert path
// (ref: src/Pyrope.GarnetServer/Vector/HnswVectorIndex.cs — greedy descent
// :106-134, SearchLayer(efConstruction) :281-325, link + prune-to-closest
// :141-162, SelectNeighbors = closest-M :327-331). Same algorithm as the
// Python fallback builder; levels are pre-drawn by the caller so both
// builders are deterministic given the same seed.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libpyrope_native.so hnsw_builder.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

namespace {

struct Ctx {
  const float* vecs;   // [n, dim]
  const float* sqnorm; // [n]
  int n;
  int dim;
  int m;
  int max_deg0;        // 2m at layer 0
  int ef_construction;
  int metric;          // 0 = L2 (score = -d^2), 1 = IP/cosine (score = dot)
  const int32_t* levels;
  int32_t* adj0;                   // [n, 2m]
  std::vector<int32_t*> adj_up;    // per level>=1: [n, m]
  // epoch-stamped visited set: O(1) clear per insert
  std::vector<int32_t> visit_mark;
  int32_t visit_epoch = 0;

  float score(const float* q, float qsq, int row) const {
    const float* x = vecs + (size_t)row * dim;
    float dot = 0.f;
    for (int i = 0; i < dim; ++i) dot += q[i] * x[i];  // auto-vectorized
    if (metric == 0) {
      float d2 = qsq - 2.f * dot + sqnorm[row];
      return d2 > 0.f ? -d2 : 0.f;
    }
    return dot;
  }

  int32_t* adj_at(int level) { return level == 0 ? adj0 : adj_up[level - 1]; }
  int deg_at(int level) const { return level == 0 ? max_deg0 : m; }
};

using ScoredNode = std::pair<float, int>;  // (score, node), higher = closer

int greedy_descent(Ctx& c, const float* q, float qsq, int start, int level) {
  int cur = start;
  float cur_s = c.score(q, qsq, cur);
  const int32_t* adj = c.adj_at(level);
  const int deg = c.deg_at(level);
  for (;;) {
    const int32_t* row = adj + (size_t)cur * deg;
    int best = -1;
    float best_s = cur_s;
    for (int j = 0; j < deg; ++j) {
      int nb = row[j];
      if (nb < 0) continue;
      float s = c.score(q, qsq, nb);
      if (s > best_s) { best_s = s; best = nb; }
    }
    if (best < 0) return cur;
    cur = best;
    cur_s = best_s;
  }
}

// SearchLayer with ef beam; returns best-first results.
void search_layer(Ctx& c, const float* q, float qsq, int entry, int ef,
                  int level, std::vector<ScoredNode>& out) {
  ++c.visit_epoch;
  const int32_t* adj = c.adj_at(level);
  const int deg = c.deg_at(level);

  // candidates: max-heap by score; w: min-heap (worst of the ef kept on top)
  std::priority_queue<ScoredNode> cand;
  std::priority_queue<ScoredNode, std::vector<ScoredNode>,
                      std::greater<ScoredNode>> w;
  float es = c.score(q, qsq, entry);
  c.visit_mark[entry] = c.visit_epoch;
  cand.push({es, entry});
  w.push({es, entry});

  while (!cand.empty()) {
    ScoredNode top = cand.top();
    cand.pop();
    if ((int)w.size() >= ef && top.first < w.top().first) break;
    const int32_t* row = adj + (size_t)top.second * deg;
    for (int j = 0; j < deg; ++j) {
      int nb = row[j];
      if (nb < 0 || c.visit_mark[nb] == c.visit_epoch) continue;
      c.visit_mark[nb] = c.visit_epoch;
      float s = c.score(q, qsq, nb);
      if ((int)w.size() < ef || s > w.top().first) {
        cand.push({s, nb});
        w.push({s, nb});
        if ((int)w.size() > ef) w.pop();
      }
    }
  }
  out.clear();
  out.reserve(w.size());
  while (!w.empty()) { out.push_back(w.top()); w.pop(); }
  std::reverse(out.begin(), out.end());  // best first
}

// Diversity-heuristic neighbor selection (HNSW paper Alg. 4, with
// keep-pruned backfill): walking candidates best-first, keep e only if e
// is closer to the query point than to every already-kept neighbor.
// The reference's closest-M (:327-331) piles all M links into the densest
// direction; the heuristic spreads them, which is what lets a beam escape
// a local cluster — measured recall wins at equal ef (see bench hnsw rows).
// `cands` must be sorted best-first; writes <= m_out survivors into out.
void select_heuristic(Ctx& c, const std::vector<ScoredNode>& cands,
                      int m_out, std::vector<int>& out) {
  out.clear();
  std::vector<int> rejected;
  for (const auto& sn : cands) {
    if ((int)out.size() >= m_out) break;
    int e = sn.second;
    const float* ve = c.vecs + (size_t)e * c.dim;
    float vesq = c.sqnorm[e];
    bool keep = true;
    for (int s : out) {
      if (c.score(ve, vesq, s) > sn.first) { keep = false; break; }
    }
    if (keep) out.push_back(e);
    else rejected.push_back(e);
  }
  for (int e : rejected) {  // keepPrunedConnections: backfill closest
    if ((int)out.size() >= m_out) break;
    out.push_back(e);
  }
}

// Add b into a's list; prune when full — closest-deg (ref link+prune
// :141-162, SelectNeighbors = closest :327-331) or diversity-heuristic.
void link(Ctx& c, int a, int b, int level, bool heuristic,
          std::vector<ScoredNode>& scratch, std::vector<int>& sel) {
  int32_t* row = c.adj_at(level) + (size_t)a * c.deg_at(level);
  const int deg = c.deg_at(level);
  for (int j = 0; j < deg; ++j) {
    if (row[j] < 0) { row[j] = b; return; }
  }
  const float* va = c.vecs + (size_t)a * c.dim;
  float vasq = c.sqnorm[a];
  std::vector<ScoredNode>& cands = scratch;
  cands.clear();
  cands.reserve(deg + 1);
  for (int j = 0; j < deg; ++j) cands.push_back({c.score(va, vasq, row[j]), row[j]});
  cands.push_back({c.score(va, vasq, b), b});
  std::sort(cands.begin(), cands.end(),
            [](const ScoredNode& x, const ScoredNode& y) {
              return x.first > y.first;
            });
  if (heuristic) {
    select_heuristic(c, cands, deg, sel);
    int j = 0;
    for (int e : sel) row[j++] = e;
    for (; j < deg; ++j) row[j] = -1;
  } else {
    for (int j = 0; j < deg; ++j) row[j] = cands[j].second;
  }
}

}  // namespace

extern "C" {

// Builds the full graph over n pre-validated vectors.
// adj0:   [n * 2m] int32, caller-initialized to -1
// adj_up: [max_level * n * m] int32 (level l>=1 at offset (l-1)*n*m), init -1
// Returns the entry point row; writes top level to *top_level_out.
int hnsw_build(const float* vecs, const float* sqnorm, int n, int dim,
               int m, int ef_construction, int metric, int heuristic,
               const int32_t* levels, int max_level,
               int32_t* adj0, int32_t* adj_up, int32_t* top_level_out) {
  Ctx c;
  c.vecs = vecs;
  c.sqnorm = sqnorm;
  c.n = n;
  c.dim = dim;
  c.m = m;
  c.max_deg0 = 2 * m;
  c.ef_construction = ef_construction;
  c.metric = metric;
  c.levels = levels;
  c.adj0 = adj0;
  c.adj_up.resize(max_level);
  for (int l = 1; l <= max_level; ++l)
    c.adj_up[l - 1] = adj_up + (size_t)(l - 1) * n * m;
  c.visit_mark.assign(n, 0);

  int entry = -1;
  int top = -1;
  std::vector<ScoredNode> w;
  std::vector<ScoredNode> scratch;
  std::vector<int> sel;       // outer selection for the new node
  std::vector<int> link_sel;  // scratch for link()'s own pruning
  for (int i = 0; i < n; ++i) {
    int level = levels[i];
    const float* v = c.vecs + (size_t)i * dim;
    float vsq = c.sqnorm[i];
    if (entry < 0) {
      entry = i;
      top = level;
      continue;
    }
    int cur = entry;
    for (int lev = top; lev > level; --lev)
      cur = greedy_descent(c, v, vsq, cur, lev);
    int start = std::min(level, top);
    for (int lev = start; lev >= 0; --lev) {
      search_layer(c, v, vsq, cur, ef_construction, lev, w);
      int32_t* my_row = c.adj_at(lev) + (size_t)i * c.deg_at(lev);
      int slot = 0;
      if (heuristic) {
        select_heuristic(c, w, m, sel);
        for (int nb : sel) {
          if (nb == i) continue;
          if (slot < c.deg_at(lev)) my_row[slot++] = nb;
          link(c, nb, i, lev, true, scratch, link_sel);
        }
      } else {
        const int take = std::min((int)w.size(), m);  // closest-M selection
        for (int j = 0; j < take; ++j) {
          int nb = w[j].second;
          if (nb == i) continue;
          if (slot < c.deg_at(lev)) my_row[slot++] = nb;
          link(c, nb, i, lev, false, scratch, link_sel);
        }
      }
      if (!w.empty()) cur = w[0].second;
    }
    if (level > top) {
      entry = i;
      top = level;
    }
  }
  *top_level_out = top;
  return entry;
}

}  // extern "C"
