// graphkit — native C++ kernels for the host-side irregular graph
// algorithms (the sequential/data-dependent preprocessing the reference
// implements in C++/OpenMP). The PyTorch port's own copy of
// sparsebase_tpu/native/graphkit.cpp; the module paths below are the JAX
// package's, whose numpy routes these kernels mirror.
//
// Reference parity targets:
//   * slashburn  — reorder/slashburn_reorder.cc semantics (k-hubset
//     removal + spoke ordering); EXACT mirror of the numpy
//     implementation in ops/reorder/slashburn.py (deterministic).
//   * rcm        — reorder/rcm_reorder.cc:22-166 (pseudo-peripheral root
//     + BFS with (parent-pos, degree, id) rank + reversal); EXACT
//     mirror of ops/reorder/rcm.py::_rcm_host.
//   * rabbit     — reorder/rabbit_reorder.cc aggregation + compute_perm;
//     EXACT mirror of ops/reorder/rabbit.py (insertion-ordered
//     community adjacency, identical float expression order).
//   * amd        — reorder/amd_reorder.cc quotient-graph minimum degree;
//     EXACT mirror of ops/reorder/amd.py (lazy (degree, id) min-heap).
//   * partition  — partition/metis_partition.cc-equivalent multilevel
//     k-way (HEM coarsening, greedy growing, boundary FM refinement)
//     with its own deterministic RNG (quality-tested, not bit-matched).
//
// All arrays are int64 CSR (indptr[n+1], indices[nnz]); outputs are
// int64 inverse permutations order[old] = new (or part labels).
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 graphkit.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <unordered_map>
#include <vector>

using std::int64_t;
using std::size_t;
using std::vector;

namespace {

constexpr int64_t I64MAX = std::numeric_limits<int64_t>::max();

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// A ∪ Aᵀ pattern over n vertices, deduplicated, no guaranteed within-row
// order beyond sorted-ascending (rows are sorted + uniqued).
void symmetrize_dedup(int64_t n, const int64_t* indptr, const int64_t* indices,
                      vector<int64_t>& sp, vector<int64_t>& sc) {
  vector<int64_t> cnt(n + 1, 0);
  for (int64_t u = 0; u < n; ++u) {
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      ++cnt[u + 1];
      ++cnt[v + 1];
    }
  }
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  vector<int64_t> tmp(cnt.back());
  vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
  for (int64_t u = 0; u < n; ++u) {
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      tmp[cur[u]++] = v;
      tmp[cur[v]++] = u;
    }
  }
  sp.assign(n + 1, 0);
  sc.clear();
  sc.reserve(tmp.size());
  for (int64_t u = 0; u < n; ++u) {
    int64_t b = cnt[u], e = (u + 1 <= n) ? cnt[u + 1] : (int64_t)tmp.size();
    std::sort(tmp.begin() + b, tmp.begin() + e);
    int64_t prev = -1;
    for (int64_t i = b; i < e; ++i) {
      if (tmp[i] != prev) {
        sc.push_back(tmp[i]);
        prev = tmp[i];
      }
    }
    sp[u + 1] = (int64_t)sc.size();
  }
}

// connected components over the active subgraph; label = min vertex id in
// the component (matches min-label propagation); inactive vertices = -1.
void cc_min_labels(int64_t n, const vector<int64_t>& sp, const vector<int64_t>& sc,
                   const vector<char>& active, vector<int64_t>& labels,
                   vector<int64_t>& stack) {
  labels.assign(n, -1);
  for (int64_t s = 0; s < n; ++s) {
    if (!active[s] || labels[s] >= 0) continue;
    // BFS collecting the component; min id is the seed s (we scan ascending)
    labels[s] = s;
    stack.clear();
    stack.push_back(s);
    while (!stack.empty()) {
      int64_t u = stack.back();
      stack.pop_back();
      for (int64_t e = sp[u]; e < sp[u + 1]; ++e) {
        int64_t v = sc[e];
        if (active[v] && labels[v] < 0) {
          labels[v] = s;
          stack.push_back(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// SlashBurn (mirror of ops/reorder/slashburn.py::_slashburn_host)
// ---------------------------------------------------------------------------

int64_t sbtpu_slashburn(int64_t n, const int64_t* indptr, const int64_t* indices,
                        int64_t k_size, int greedy, int hub_order,
                        int64_t* out_order) {
  if (n <= 0) return 0;
  int64_t k = k_size < 1 ? 1 : k_size;
  vector<int64_t> sp, sc;
  symmetrize_dedup(n, indptr, indices, sp, sc);

  vector<int64_t> order(n, -1);
  vector<char> active(n, 1);
  int64_t front = 0, back = n - 1;
  vector<int64_t> labels, stack, degrees(n), hub_of, hubs;

  // place all active non-gcc components at the back; components ascend by
  // (hub_key, size, label), blocks from the end, ascending id within.
  auto place_spokes = [&](int64_t gcc, const vector<int64_t>* hubof) {
    // collect spoke components
    std::unordered_map<int64_t, int64_t> comp_ix;  // label -> slot
    vector<int64_t> comp_label, comp_size, comp_hub;
    vector<vector<int64_t>> members;
    for (int64_t v = 0; v < n; ++v) {
      if (!active[v] || labels[v] < 0 || labels[v] == gcc) continue;
      auto it = comp_ix.find(labels[v]);
      int64_t slot;
      if (it == comp_ix.end()) {
        slot = (int64_t)comp_label.size();
        comp_ix.emplace(labels[v], slot);
        comp_label.push_back(labels[v]);
        comp_size.push_back(0);
        comp_hub.push_back(hubof ? I64MAX : 0);
        members.emplace_back();
      } else {
        slot = it->second;
      }
      ++comp_size[slot];
      members[slot].push_back(v);  // ascending id (scan order)
      if (hubof) comp_hub[slot] = std::min(comp_hub[slot], (*hubof)[v]);
    }
    if (comp_label.empty()) return;
    vector<int64_t> perm(comp_label.size());
    for (size_t i = 0; i < perm.size(); ++i) perm[i] = (int64_t)i;
    std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
      if (comp_hub[a] != comp_hub[b]) return comp_hub[a] < comp_hub[b];
      if (comp_size[a] != comp_size[b]) return comp_size[a] < comp_size[b];
      return comp_label[a] < comp_label[b];
    });
    for (int64_t slot : perm) {
      int64_t sz = comp_size[slot];
      int64_t start = back - sz + 1;
      const auto& mem = members[slot];
      for (int64_t i = 0; i < sz; ++i) {
        order[mem[i]] = start + i;
        active[mem[i]] = 0;
      }
      back -= sz;
    }
  };

  auto active_degrees = [&]() {
    for (int64_t v = 0; v < n; ++v) {
      if (!active[v]) {
        degrees[v] = -1;
        continue;
      }
      int64_t d = 0;
      for (int64_t e = sp[v]; e < sp[v + 1]; ++e)
        if (active[sc[e]]) ++d;
      degrees[v] = d;
    }
  };

  cc_min_labels(n, sp, sc, active, labels, stack);
  {  // initial spokes: everything outside the giant component
    vector<int64_t> sizes(n, 0);
    for (int64_t v = 0; v < n; ++v)
      if (labels[v] >= 0) ++sizes[labels[v]];
    int64_t gcc = 0, best = -1;
    for (int64_t l = 0; l < n; ++l)
      if (sizes[l] > best) {
        best = sizes[l];
        gcc = l;
      }
    place_spokes(gcc, nullptr);
  }

  while (true) {
    int64_t count = 0;
    for (int64_t v = 0; v < n; ++v) count += active[v];
    if (count == 0) break;
    if (count < k) {
      int64_t pos = back - count + 1;
      for (int64_t v = 0; v < n; ++v)
        if (active[v]) order[v] = pos++;
      back -= count;
      break;
    }
    active_degrees();
    hub_of.assign(n, I64MAX);
    hubs.assign(k, -1);
    if (greedy) {
      for (int64_t i = 0; i < k; ++i) {
        int64_t h = 0, best = degrees[0];
        for (int64_t v = 1; v < n; ++v)
          if (degrees[v] > best) {
            best = degrees[v];
            h = v;
          }
        hubs[i] = h;
        degrees[h] = -1;
        for (int64_t e = sp[h]; e < sp[h + 1]; ++e) {
          int64_t v = sc[e];
          if (active[v] && degrees[v] > 0) --degrees[v];
        }
        active[h] = 0;
      }
    } else {
      // descending degree, ascending id within ties
      vector<int64_t> idx(n);
      for (int64_t v = 0; v < n; ++v) idx[v] = v;
      std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                        [&](int64_t a, int64_t b) {
                          if (degrees[a] != degrees[b]) return degrees[a] > degrees[b];
                          return a < b;
                        });
      for (int64_t i = 0; i < k; ++i) {
        hubs[i] = idx[i];
        active[idx[i]] = 0;
      }
    }
    for (int64_t i = 0; i < k; ++i) order[hubs[i]] = front + i;
    front += k;
    if (hub_order) {
      for (int64_t i = 0; i < k; ++i) {
        int64_t h = hubs[i];
        for (int64_t e = sp[h]; e < sp[h + 1]; ++e)
          hub_of[sc[e]] = std::min(hub_of[sc[e]], i);
      }
    }
    cc_min_labels(n, sp, sc, active, labels, stack);
    vector<int64_t> sizes(n, 0);
    bool any_live = false;
    for (int64_t v = 0; v < n; ++v)
      if (labels[v] >= 0) {
        ++sizes[labels[v]];
        any_live = true;
      }
    if (!any_live) break;
    int64_t gcc = 0, best = -1;
    for (int64_t l = 0; l < n; ++l)
      if (sizes[l] > best) {
        best = sizes[l];
        gcc = l;
      }
    place_spokes(gcc, hub_order ? &hub_of : nullptr);
    if (sizes[gcc] < k) {
      int64_t cnt = 0;
      for (int64_t v = 0; v < n; ++v) cnt += active[v];
      int64_t pos = back - cnt + 1;
      for (int64_t v = 0; v < n; ++v)
        if (active[v]) order[v] = pos++;
      back -= cnt;
      break;
    }
  }
  std::memcpy(out_order, order.data(), n * sizeof(int64_t));
  return 0;
}

// ---------------------------------------------------------------------------
// RCM (mirror of ops/reorder/rcm.py::_rcm_host on the folded A ∪ Aᵀ graph
// with duplicates kept — degrees double uniformly like the numpy path)
// ---------------------------------------------------------------------------

namespace {

// BFS distances; returns eccentricity. dist preset to -1.
int64_t bfs_ecc(int64_t n, const vector<int64_t>& sp, const vector<int64_t>& sc,
                int64_t root, vector<int64_t>& dist, vector<int64_t>& q) {
  // dist assumed reset for touched vertices by caller
  q.clear();
  q.push_back(root);
  dist[root] = 0;
  int64_t ecc = 0;
  for (size_t h = 0; h < q.size(); ++h) {
    int64_t u = q[h];
    for (int64_t e = sp[u]; e < sp[u + 1]; ++e) {
      int64_t v = sc[e];
      if (dist[v] < 0) {
        dist[v] = dist[u] + 1;
        ecc = std::max(ecc, dist[v]);
        q.push_back(v);
      }
    }
  }
  return ecc;
}

}  // namespace

int64_t sbtpu_rcm(int64_t nrows, int64_t ncols, const int64_t* indptr,
                  const int64_t* indices, int64_t* out_order) {
  int64_t n = std::max(nrows, ncols);
  if (n <= 0) return 0;
  // fold + symmetrize keeping duplicates (matches _symmetrized_square):
  // every entry (u,v) contributes v to u's list and u to v's list.
  vector<int64_t> sp(n + 1, 0), sc;
  {
    for (int64_t u = 0; u < nrows; ++u)
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        ++sp[u + 1];
        ++sp[indices[e] + 1];
      }
    for (int64_t i = 0; i < n; ++i) sp[i + 1] += sp[i];
    sc.resize(sp[n]);
    vector<int64_t> cur(sp.begin(), sp.end() - 1);
    for (int64_t u = 0; u < nrows; ++u)
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int64_t v = indices[e];
        sc[cur[u]++] = v;
        sc[cur[v]++] = u;
      }
  }
  vector<int64_t> degrees(n);
  for (int64_t v = 0; v < n; ++v) degrees[v] = sp[v + 1] - sp[v];

  vector<int64_t> order(n, -1);
  vector<char> visited(n, 0);
  vector<int64_t> dist(n, -1), q, touched;
  vector<int64_t> frontier, frontier_pos, lvl_minpos(n, I64MAX), lvl_verts;
  int64_t counter = 0;

  auto reset_dist = [&]() {
    for (int64_t v : q) dist[v] = -1;
  };

  for (int64_t i = 0; i < n; ++i) {
    if (visited[i]) continue;
    if (degrees[i] == 0) {  // isolated keeps scan position (rcm_reorder.cc:110-116)
      order[i] = counter++;
      visited[i] = 1;
      continue;
    }
    // pseudo-peripheral root (rcm_reorder.cc:22-81): repeat BFS, jump to
    // min-degree vertex of the last level until eccentricity stalls
    int64_t r = i, prev_ecc = -1;
    while (true) {
      int64_t ecc = bfs_ecc(n, sp, sc, r, dist, q);
      if (ecc == prev_ecc) {
        reset_dist();
        break;
      }
      prev_ecc = ecc;
      int64_t bestv = -1, bestd = I64MAX;
      for (int64_t v : q)
        if (dist[v] == ecc && degrees[v] < bestd) {
          bestd = degrees[v];
          bestv = v;
        }
      // ascending-id tie-break: q is BFS order; scan ascending ids instead
      for (int64_t v : q)
        if (dist[v] == ecc && degrees[v] == bestd) {
          bestv = std::min(bestv, v);
        }
      reset_dist();
      r = bestv;
    }
    int64_t comp_start = counter;
    visited[r] = 1;
    order[r] = counter++;
    frontier.assign(1, r);
    frontier_pos.assign(1, comp_start);
    while (!frontier.empty()) {
      lvl_verts.clear();
      for (size_t fi = 0; fi < frontier.size(); ++fi) {
        int64_t u = frontier[fi], upos = frontier_pos[fi];
        for (int64_t e = sp[u]; e < sp[u + 1]; ++e) {
          int64_t v = sc[e];
          if (visited[v]) continue;
          if (lvl_minpos[v] == I64MAX) lvl_verts.push_back(v);
          lvl_minpos[v] = std::min(lvl_minpos[v], upos);
        }
      }
      if (lvl_verts.empty()) break;
      std::sort(lvl_verts.begin(), lvl_verts.end(), [&](int64_t a, int64_t b) {
        if (lvl_minpos[a] != lvl_minpos[b]) return lvl_minpos[a] < lvl_minpos[b];
        if (degrees[a] != degrees[b]) return degrees[a] < degrees[b];
        return a < b;
      });
      frontier.clear();
      frontier_pos.clear();
      for (int64_t v : lvl_verts) {
        visited[v] = 1;
        order[v] = counter;
        frontier.push_back(v);
        frontier_pos.push_back(counter);
        ++counter;
        lvl_minpos[v] = I64MAX;
      }
    }
    for (int64_t v : lvl_verts) lvl_minpos[v] = I64MAX;
    // reverse the component (rcm_reorder.cc:146-153)
    for (int64_t v = 0; v < n; ++v)
      if (order[v] >= comp_start && order[v] < counter && degrees[v] > 0)
        order[v] = comp_start + (counter - 1) - order[v];
  }
  std::memcpy(out_order, order.data(), n * sizeof(int64_t));
  return 0;
}

// ---------------------------------------------------------------------------
// Rabbit-order-style clustering (mirror of ops/reorder/rabbit.py)
// ---------------------------------------------------------------------------

namespace {

// insertion-ordered float-accumulating map (mirrors Python dict semantics)
struct OrderedAdj {
  vector<std::pair<int64_t, double>> items;
  std::unordered_map<int64_t, int64_t> index;
  void add(int64_t key, double w) {
    auto it = index.find(key);
    if (it == index.end()) {
      index.emplace(key, (int64_t)items.size());
      items.emplace_back(key, w);
    } else {
      items[it->second].second += w;
    }
  }
  void clear() {
    items.clear();
    index.clear();
  }
};

}  // namespace

int64_t sbtpu_rabbit(int64_t n, const int64_t* indptr, const int64_t* indices,
                     int64_t* out_inv) {
  if (n <= 0) return 0;
  int64_t nnz = indptr[n];
  double W = (double)std::max<int64_t>(nnz, 1);
  vector<int64_t> parent(n);
  for (int64_t v = 0; v < n; ++v) parent[v] = v;
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  vector<vector<int64_t>> children(n);
  vector<OrderedAdj> com_adj(n);
  vector<double> com_deg(n, 0.0);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      if (u != v) com_adj[u].add(v, 1.0);
    }
  for (int64_t v = 0; v < n; ++v) {
    double s = 0.0;
    for (auto& kv : com_adj[v].items) s += kv.second;
    com_deg[v] = s;
  }
  // ascending (degree, id) visit order — argsort(diff(indptr), stable)
  vector<int64_t> by_deg(n);
  for (int64_t v = 0; v < n; ++v) by_deg[v] = v;
  std::stable_sort(by_deg.begin(), by_deg.end(), [&](int64_t a, int64_t b) {
    return (indptr[a + 1] - indptr[a]) < (indptr[b + 1] - indptr[b]);
  });
  for (int64_t v : by_deg) {
    int64_t rv = find(v);
    if (rv != v) continue;
    auto& adj = com_adj[rv];
    if (adj.items.empty()) continue;
    double best_gain = 0.0;
    int64_t best_c = -1;
    double deg_v = com_deg[rv];
    for (auto& kv : adj.items) {
      int64_t ru = find(kv.first);
      if (ru == rv) continue;
      double gain = kv.second / W - (deg_v * com_deg[ru]) / (2.0 * W * W);
      if (gain > best_gain) {
        best_gain = gain;
        best_c = ru;
      }
    }
    if (best_c >= 0) {
      parent[rv] = best_c;
      children[best_c].push_back(rv);
      auto& tgt = com_adj[best_c];
      for (auto& kv : adj.items) {
        int64_t ru = find(kv.first);
        if (ru != best_c) tgt.add(ru, kv.second);
      }
      com_adj[rv].clear();
      com_deg[best_c] += deg_v;
    }
  }
  // DFS over the merge forest (compute_perm analogue)
  vector<char> visited(n, 0);
  vector<int64_t> stack;
  int64_t counter = 0;
  for (int64_t root = 0; root < n; ++root) {
    if (find(root) != root || visited[root]) continue;
    stack.clear();
    stack.push_back(root);
    while (!stack.empty()) {
      int64_t x = stack.back();
      stack.pop_back();
      if (visited[x]) continue;
      visited[x] = 1;
      out_inv[x] = counter++;
      for (auto it = children[x].rbegin(); it != children[x].rend(); ++it)
        stack.push_back(*it);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Approximate minimum degree (AMD), Amestoy–Davis–Duff style
// (reference: reorder/amd_reorder.cc wraps SuiteSparse amd_l_order; this
// is a native implementation with the same core machinery: quotient
// graph, approximate external degrees, supervariable coalescing by
// hashing, aggressive element absorption, dense-row postponement)
// ---------------------------------------------------------------------------

namespace {

// core AMD on a symmetric dedup adjacency (sp/sc); writes inv perm.
// aggressive gates AMD's aggressive element absorption (amd_reorder.h:27):
// when off, an element whose list is contained in the new pivot list
// (w == 0) stays alive — it contributes 0 external weight this round but
// keeps its slot in E lists / coalescing signatures, matching
// SuiteSparse AMD's non-aggressive mode semantics.
void amd_core(int64_t n, const vector<int64_t>& sp, const vector<int64_t>& sc,
              double dense_threshold, int aggressive, int64_t* out_inv) {
  if (n <= 0) return;
  vector<vector<int64_t>> A(n);  // variable adjacency (pruned lazily)
  for (int64_t u = 0; u < n; ++u) {
    A[u].reserve(sp[u + 1] - sp[u]);
    for (int64_t e = sp[u]; e < sp[u + 1]; ++e)
      if (sc[e] != u) A[u].push_back(sc[e]);
  }
  vector<vector<int64_t>> E(n);       // element ids adjacent to each variable
  vector<vector<int64_t>> L;          // element -> variable list (stale-tolerant)
  vector<int64_t> lsize;              // weighted |L[e]| at creation (approximate)
  vector<char> ealive;                // element alive (not absorbed)
  vector<int64_t> nv(n, 1);           // supervariable weight; 0 = absorbed
  vector<char> eliminated(n, 0), dense_mask(n, 0);
  vector<vector<int64_t>> merged(n);  // members coalesced into a principal
  vector<int64_t> deg(n, 0);

  for (int64_t v = 0; v < n; ++v) {
    deg[v] = (int64_t)A[v].size();
    if ((double)deg[v] > dense_threshold) dense_mask[v] = 1;
  }

  // degree buckets (doubly linked, FIFO: ties pop oldest-queued first,
  // so a freshly-updated high-traffic vertex doesn't jump the queue)
  vector<int64_t> bhead(n + 1, -1), btail(n + 1, -1), bnext(n, -1), bprev(n, -1),
      bin(n, -1);
  auto bucket_remove = [&](int64_t v) {
    if (bin[v] < 0) return;
    if (bprev[v] >= 0)
      bnext[bprev[v]] = bnext[v];
    else
      bhead[bin[v]] = bnext[v];
    if (bnext[v] >= 0)
      bprev[bnext[v]] = bprev[v];
    else
      btail[bin[v]] = bprev[v];
    bin[v] = -1;
  };
  int64_t mindeg = n;
  auto bucket_insert = [&](int64_t v, int64_t d) {
    d = std::min(std::max<int64_t>(d, 0), n);
    bin[v] = d;
    bnext[v] = -1;
    bprev[v] = btail[d];
    if (btail[d] >= 0)
      bnext[btail[d]] = v;
    else
      bhead[d] = v;
    btail[d] = v;
    mindeg = std::min(mindeg, d);
  };
  int64_t nleft = 0;
  for (int64_t v = 0; v < n; ++v)
    if (!dense_mask[v]) {
      bucket_insert(v, deg[v]);
      ++nleft;
    }

  vector<int64_t> stamp(n, 0), Lp;
  vector<int64_t> wstamp, w;  // per-element workspaces (grow with L)
  vector<int64_t> elim_order;
  elim_order.reserve(n);
  int64_t gen = 0;

  auto live_var = [&](int64_t v) {
    return !eliminated[v] && nv[v] > 0 && !dense_mask[v];
  };

  while (nleft > 0) {
    while (mindeg <= n && bhead[mindeg] < 0) ++mindeg;
    int64_t p = bhead[mindeg];
    bucket_remove(p);
    ++gen;
    // Lp = (A[p] ∪ ⋃ L[e]) restricted to live principal variables
    Lp.clear();
    stamp[p] = gen;
    auto addv = [&](int64_t v) {
      if (live_var(v) && stamp[v] != gen) {
        stamp[v] = gen;
        Lp.push_back(v);
      }
    };
    for (int64_t v : A[p]) addv(v);
    for (int64_t e : E[p])
      if (ealive[e])
        for (int64_t v : L[e]) addv(v);

    eliminated[p] = 1;
    elim_order.push_back(p);
    --nleft;

    if (!Lp.empty()) {
      int64_t lpw = 0;
      for (int64_t v : Lp) lpw += nv[v];
      int64_t ep = (int64_t)L.size();
      L.push_back(Lp);
      lsize.push_back(lpw);
      ealive.push_back(1);
      wstamp.push_back(0);
      w.push_back(0);
      for (int64_t e : E[p]) ealive[e] = 0;  // absorbed into ep

      // w[e] = |L[e] \ Lp| (weighted), per AMD's scan
      for (int64_t i : Lp)
        for (int64_t e : E[i]) {
          if (!ealive[e]) continue;
          if (wstamp[e] != gen) {
            wstamp[e] = gen;
            w[e] = lsize[e];
          }
          w[e] -= nv[i];
        }

      // update each variable in Lp
      for (int64_t i : Lp) {
        if (nv[i] <= 0) continue;  // coalesced earlier in this loop
        bucket_remove(i);
        // prune A[i]: drop eliminated/absorbed/members of Lp/p (covered by ep)
        auto& ai = A[i];
        size_t kk = 0;
        int64_t a_ext = 0;
        for (size_t t = 0; t < ai.size(); ++t) {
          int64_t x = ai[t];
          if (x == p || eliminated[x] || nv[x] <= 0 || stamp[x] == gen) continue;
          ai[kk++] = x;
          a_ext += nv[x];
        }
        ai.resize(kk);
        // prune E[i]: drop dead + aggressively absorbed (w == 0) elements
        auto& ei = E[i];
        size_t k2 = 0;
        int64_t e_ext = 0;
        for (size_t t = 0; t < ei.size(); ++t) {
          int64_t e = ei[t];
          if (!ealive[e]) continue;
          int64_t we = (wstamp[e] == gen) ? w[e] : lsize[e];
          if (we <= 0) {
            if (aggressive) {
              ealive[e] = 0;  // L[e] ⊆ Lp: absorb into ep
              continue;
            }
            we = 0;  // non-aggressive: keep the element, zero weight
          }
          ei[k2++] = e;
          e_ext += we;
        }
        ei.resize(k2);
        ei.push_back(ep);
        // approximate external degree (AMD bound)
        int64_t d_new = a_ext + (lpw - nv[i]) + e_ext;
        d_new = std::min(d_new, deg[i] + lpw - nv[i]);
        d_new = std::min(d_new, n - 1);
        deg[i] = std::max<int64_t>(d_new, 0);
      }

      // supervariable coalescing: hash Lp members by adjacency signature
      std::unordered_map<int64_t, vector<int64_t>> hash_groups;
      for (int64_t i : Lp) {
        if (nv[i] <= 0) continue;
        int64_t h = 0;
        for (int64_t x : A[i]) h += x;
        for (int64_t e : E[i]) h += e;
        hash_groups[(h % n + n) % n].push_back(i);
      }
      for (auto& kvp : hash_groups) {
        auto& grp = kvp.second;
        if (grp.size() < 2) continue;
        for (size_t a = 0; a < grp.size(); ++a) {
          int64_t i = grp[a];
          if (nv[i] <= 0) continue;
          std::sort(A[i].begin(), A[i].end());
          std::sort(E[i].begin(), E[i].end());
          for (size_t b = a + 1; b < grp.size(); ++b) {
            int64_t j = grp[b];
            if (nv[j] <= 0) continue;
            if (A[i].size() != A[j].size() || E[i].size() != E[j].size()) continue;
            std::sort(A[j].begin(), A[j].end());
            std::sort(E[j].begin(), E[j].end());
            if (A[i] == A[j] && E[i] == E[j]) {
              // j indistinguishable from i: coalesce
              nv[i] += nv[j];
              nv[j] = 0;
              merged[i].push_back(j);
              bucket_remove(j);
              A[j].clear();
              A[j].shrink_to_fit();
              E[j].clear();
              E[j].shrink_to_fit();
              --nleft;
            }
          }
        }
      }
      // re-insert surviving Lp members into buckets
      for (int64_t i : Lp)
        if (nv[i] > 0 && !eliminated[i]) bucket_insert(i, deg[i]);
      mindeg = 0;  // conservative reset (degrees may have dropped)
    }
    A[p].clear();
    A[p].shrink_to_fit();
    E[p].clear();
    E[p].shrink_to_fit();
  }

  // expand: principals in elimination order, each followed by its merged
  // members (depth-first through the coalescing forest), dense rows last
  vector<int64_t> perm;
  perm.reserve(n);
  vector<int64_t> stack2;
  for (int64_t p : elim_order) {
    stack2.clear();
    stack2.push_back(p);
    while (!stack2.empty()) {
      int64_t x = stack2.back();
      stack2.pop_back();
      perm.push_back(x);
      for (auto it = merged[x].rbegin(); it != merged[x].rend(); ++it)
        stack2.push_back(*it);
    }
  }
  for (int64_t v = 0; v < n; ++v)
    if (dense_mask[v]) perm.push_back(v);
  for (int64_t pos = 0; pos < n; ++pos) out_inv[perm[pos]] = pos;
}

}  // namespace

int64_t sbtpu_amd(int64_t n, const int64_t* indptr, const int64_t* indices,
                  double dense_threshold, int64_t aggressive,
                  int64_t* out_inv) {
  if (n <= 0) return 0;
  vector<int64_t> sp, sc;
  symmetrize_dedup(n, indptr, indices, sp, sc);
  amd_core(n, sp, sc, dense_threshold, (int)aggressive, out_inv);
  return 0;
}

// ---------------------------------------------------------------------------
// Per-edge Jaccard weights (mirror of ops/feature/jaccard.py::_jaccard_host:
// J(u,v) = |N(u)∩N(v)| / (deg u + deg v − |∩|) per directed CSR entry;
// reference kernel: feature/jaccard_weights_cuda.cu)
// ---------------------------------------------------------------------------

int64_t sbtpu_jaccard(int64_t n, const int64_t* indptr, const int64_t* indices,
                      float* out_w) {
  if (n <= 0) return 0;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t u = 0; u < n; ++u) {
    int64_t du = indptr[u + 1] - indptr[u];
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      int64_t dv = indptr[v + 1] - indptr[v];
      // two-pointer over sorted N(u), N(v): every *instance* of x in
      // N(u) counts when x is a member of N(v) (set membership) — the
      // exact semantics of _jaccard_host / jaccard_weights_cuda.cu's
      // per-candidate binary search, which differ from a plain
      // multiset intersection when the input has duplicate entries
      int64_t a = indptr[u], b = indptr[v], inter = 0;
      while (a < indptr[u + 1] && b < indptr[v + 1]) {
        int64_t xa = indices[a], xb = indices[b];
        if (xa == xb) {
          int64_t run = 1;
          while (a + run < indptr[u + 1] && indices[a + run] == xa) ++run;
          inter += run;
          a += run;
          while (b < indptr[v + 1] && indices[b] == xb) ++b;
        } else if (xa < xb) {
          ++a;
        } else {
          ++b;
        }
      }
      int64_t uni = du + dv - inter;
      out_w[e] = (float)((double)inter / (double)std::max<int64_t>(uni, 1));
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Triangle counting (mirror of ops/feature/triangles.py; reference
// semantics: feature/triangle_count.cc — undirected u<v<w triples,
// directed 3-cycles anchored at the minimum vertex)
// ---------------------------------------------------------------------------

int64_t sbtpu_triangles(int64_t n, const int64_t* indptr, const int64_t* indices,
                        int directed, int64_t* out_count) {
  if (n <= 0) {
    *out_count = 0;
    return 0;
  }
  int64_t total = 0;
  if (!directed) {
    // predecessor lists P(x) = {u < x : (u,x) ∈ E}, sorted (u ascending)
    // set semantics (triangles._dedup_adj contract): indices are sorted
    // within each row, so duplicate entries are adjacent — skip them
    // both when building predecessor lists and when iterating edges
    vector<int64_t> pc(n + 1, 0);
    for (int64_t u = 0; u < n; ++u)
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e)
        if (indices[e] > u && (e == indptr[u] || indices[e] != indices[e - 1]))
          ++pc[indices[e] + 1];
    for (int64_t i = 0; i < n; ++i) pc[i + 1] += pc[i];
    vector<int64_t> pi(pc[n]);
    vector<int64_t> cur(pc.begin(), pc.end() - 1);
    for (int64_t u = 0; u < n; ++u)
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e)
        if (indices[e] > u && (e == indptr[u] || indices[e] != indices[e - 1]))
          pi[cur[indices[e]]++] = u;
    // for each distinct edge (v,w), v<w: |P(v) ∩ P(w)|
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : total)
    for (int64_t v = 0; v < n; ++v)
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        int64_t w = indices[e];
        if (w <= v) continue;
        if (e > indptr[v] && indices[e - 1] == w) continue;
        int64_t a = pc[v], b = pc[w];
        while (a < pc[v + 1] && b < pc[w + 1]) {
          int64_t xa = pi[a], xb = pi[b];
          if (xa == xb) {
            ++total;
            ++a;
            ++b;
          } else if (xa < xb) {
            ++a;
          } else {
            ++b;
          }
        }
      }
  } else {
    // directed 3-cycles u→v→w→u anchored at min vertex u: edges u→v with
    // u<v, then w ∈ N(v) with w>u and edge w→u present
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : total)
    for (int64_t u = 0; u < n; ++u)
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int64_t v = indices[e];
        if (v <= u) continue;
        if (e > indptr[u] && indices[e - 1] == v) continue;  // set semantics
        for (int64_t e2 = indptr[v]; e2 < indptr[v + 1]; ++e2) {
          int64_t w = indices[e2];
          if (w <= u) continue;
          if (e2 > indptr[v] && indices[e2 - 1] == w) continue;
          if (std::binary_search(indices + indptr[w], indices + indptr[w + 1], u))
            ++total;
        }
      }
  }
  *out_count = total;
  return 0;
}

// ---------------------------------------------------------------------------
// Multilevel k-way partition (METIS_PartGraphKway-equivalent; own design)
// ---------------------------------------------------------------------------

namespace {

struct WGraph {
  vector<int64_t> ip, ix;
  vector<double> ew;
  vector<double> vw;
  int64_t n() const { return (int64_t)ip.size() - 1; }
};

struct Rng {  // splitmix64
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  int64_t below(int64_t m) { return (int64_t)(next() % (uint64_t)m); }
};

// symmetrize with weight accumulation, dropping self loops
WGraph build_sym(int64_t n, const int64_t* indptr, const int64_t* indices,
                 const double* ewts) {
  vector<int64_t> cnt(n + 1, 0);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      if (v == u) continue;
      ++cnt[u + 1];
      ++cnt[v + 1];
    }
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  vector<std::pair<int64_t, double>> tmp(cnt.back());
  vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t v = indices[e];
      if (v == u) continue;
      double w = ewts ? ewts[e] : 1.0;
      tmp[cur[u]++] = {v, w};
      tmp[cur[v]++] = {u, w};
    }
  WGraph g;
  g.ip.assign(n + 1, 0);
  g.vw.assign(n, 1.0);
  for (int64_t u = 0; u < n; ++u) {
    int64_t b = cnt[u], e = cnt[u + 1];
    std::sort(tmp.begin() + b, tmp.begin() + e);
    int64_t prev = -1;
    for (int64_t i = b; i < e; ++i) {
      if (tmp[i].first != prev) {
        g.ix.push_back(tmp[i].first);
        g.ew.push_back(tmp[i].second);
        prev = tmp[i].first;
      } else {
        g.ew.back() += tmp[i].second;
      }
    }
    g.ip[u + 1] = (int64_t)g.ix.size();
  }
  return g;
}

// heavy-edge matching; cmap out, returns coarse n
int64_t hem_coarsen(const WGraph& g, Rng& rng, double max_vwt, vector<int64_t>& cmap) {
  int64_t n = g.n();
  vector<int64_t> match(n, -1), visit(n);
  for (int64_t v = 0; v < n; ++v) visit[v] = v;
  for (int64_t i = n - 1; i > 0; --i) std::swap(visit[i], visit[rng.below(i + 1)]);
  for (int64_t vi = 0; vi < n; ++vi) {
    int64_t u = visit[vi];
    if (match[u] >= 0) continue;
    int64_t best = -1;
    double bw = -1.0;
    for (int64_t e = g.ip[u]; e < g.ip[u + 1]; ++e) {
      int64_t v = g.ix[e];
      if (match[v] >= 0 || v == u) continue;
      if (g.vw[u] + g.vw[v] > max_vwt) continue;
      if (g.ew[e] > bw) {
        bw = g.ew[e];
        best = v;
      }
    }
    if (best >= 0) {
      match[u] = best;
      match[best] = u;
    } else {
      match[u] = u;
    }
  }
  cmap.assign(n, -1);
  int64_t nc = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (cmap[v] >= 0) continue;
    cmap[v] = nc;
    if (match[v] != v) cmap[match[v]] = nc;
    ++nc;
  }
  return nc;
}

WGraph contract(const WGraph& g, const vector<int64_t>& cmap, int64_t nc) {
  int64_t n = g.n();
  WGraph c;
  c.ip.assign(nc + 1, 0);
  c.vw.assign(nc, 0.0);
  for (int64_t v = 0; v < n; ++v) c.vw[cmap[v]] += g.vw[v];
  // bucket coarse edges
  vector<vector<std::pair<int64_t, double>>> rows(nc);
  for (int64_t u = 0; u < n; ++u) {
    int64_t cu = cmap[u];
    for (int64_t e = g.ip[u]; e < g.ip[u + 1]; ++e) {
      int64_t cv = cmap[g.ix[e]];
      if (cu != cv) rows[cu].emplace_back(cv, g.ew[e]);
    }
  }
  for (int64_t u = 0; u < nc; ++u) {
    auto& r = rows[u];
    std::sort(r.begin(), r.end());
    int64_t prev = -1;
    for (auto& kv : r) {
      if (kv.first != prev) {
        c.ix.push_back(kv.first);
        c.ew.push_back(kv.second);
        prev = kv.first;
      } else {
        c.ew.back() += kv.second;
      }
    }
    c.ip[u + 1] = (int64_t)c.ix.size();
  }
  return c;
}

// greedy graph growing from random seeds (initial partition)
void region_grow(const WGraph& g, int64_t k, Rng& rng, double cap,
                 vector<int64_t>& labels) {
  int64_t n = g.n();
  labels.assign(n, -1);
  vector<double> sizes(k, 0.0);
  using QN = std::pair<double, int64_t>;  // (-gain proxy: edge weight into part)
  vector<std::priority_queue<QN>> front((size_t)k);
  for (int64_t p = 0; p < k && p < n; ++p) {
    int64_t s;
    int64_t tries = 0;
    do {
      s = rng.below(n);
    } while (labels[s] >= 0 && ++tries < 64);
    if (labels[s] >= 0) {
      for (s = 0; s < n && labels[s] >= 0; ++s) {
      }
      if (s == n) break;
    }
    labels[s] = p;
    sizes[p] += g.vw[s];
    for (int64_t e = g.ip[s]; e < g.ip[s + 1]; ++e)
      front[p].emplace(g.ew[e], g.ix[e]);
  }
  // grow lightest part first
  using PQ = std::pair<double, int64_t>;
  std::priority_queue<PQ, vector<PQ>, std::greater<PQ>> parts;
  for (int64_t p = 0; p < k; ++p) parts.emplace(sizes[p], p);
  int64_t assigned = 0;
  for (int64_t v = 0; v < n; ++v) assigned += labels[v] >= 0;
  int64_t stall = 0;
  while (assigned < n && stall < 4 * k) {
    auto [sz, p] = parts.top();
    parts.pop();
    if (sz != sizes[p]) {
      parts.emplace(sizes[p], p);
      continue;
    }
    bool grew = false;
    while (!front[p].empty()) {
      int64_t v = front[p].top().second;
      front[p].pop();
      if (labels[v] >= 0) continue;
      labels[v] = p;
      sizes[p] += g.vw[v];
      ++assigned;
      for (int64_t e = g.ip[v]; e < g.ip[v + 1]; ++e)
        if (labels[g.ix[e]] < 0) front[p].emplace(g.ew[e], g.ix[e]);
      grew = true;
      break;
    }
    stall = grew ? 0 : stall + 1;
    parts.emplace(sizes[p], p);
  }
  for (int64_t v = 0; v < n; ++v)
    if (labels[v] < 0) {
      int64_t p = 0;
      for (int64_t q2 = 1; q2 < k; ++q2)
        if (sizes[q2] < sizes[p]) p = q2;
      labels[v] = p;
      sizes[p] += g.vw[v];
    }
}

// boundary FM-style refinement. Positive-gain moves always; zero-gain
// moves accepted toward a smaller part (boundary straightening) or with
// a coin flip (plateau escape) — positive-only refinement stalls on the
// jagged diagonal boundaries zero-gain sweeps iron out (measured 2-3x
// cuts on grids). The best labeling seen is kept, so the hill-climbing
// sweeps can only help.
double cut_of(const WGraph& gg, const vector<int64_t>& lab) {
  double c = 0.0;
  for (int64_t u = 0; u < gg.n(); ++u)
    for (int64_t e = gg.ip[u]; e < gg.ip[u + 1]; ++e)
      if (lab[u] != lab[gg.ix[e]]) c += gg.ew[e];
  return c;
}

void refine(const WGraph& g, int64_t k, double cap, vector<int64_t>& labels,
            int rounds, Rng& rng) {
  int64_t n = g.n();
  vector<double> sizes(k, 0.0);
  for (int64_t v = 0; v < n; ++v) sizes[labels[v]] += g.vw[v];
  vector<double> aff(k, 0.0);
  vector<int64_t> touched;
  vector<int64_t> best_lab = labels;
  double best_cut = cut_of(g, labels);
  int sweeps = rounds * 3;
  for (int r = 0; r < sweeps; ++r) {
    int64_t moved = 0;
    bool fwd = (r % 2 == 0);  // alternate sweep direction between rounds
    for (int64_t s = 0; s < n; ++s) {
      int64_t v = fwd ? s : n - 1 - s;
      touched.clear();
      bool boundary = false;
      for (int64_t e = g.ip[v]; e < g.ip[v + 1]; ++e) {
        int64_t lp = labels[g.ix[e]];
        if (aff[lp] == 0.0) touched.push_back(lp);
        aff[lp] += g.ew[e];
        if (lp != labels[v]) boundary = true;
      }
      if (boundary) {
        int64_t cur = labels[v];
        double cur_aff = aff[cur];
        int64_t best = -1;
        double best_gain = -1.0;
        for (int64_t lp : touched) {
          if (lp == cur) continue;
          if (sizes[lp] + g.vw[v] > cap) continue;
          double gain = aff[lp] - cur_aff;
          if (gain > best_gain ||
              (gain == best_gain && best >= 0 && sizes[lp] < sizes[best])) {
            best_gain = gain;
            best = lp;
          }
        }
        bool zero_ok =
            best >= 0 && best_gain == 0.0 &&
            (sizes[best] + g.vw[v] < sizes[cur] || (rng.next() % 10) < 3);
        if (best >= 0 && (best_gain > 0.0 || zero_ok)) {
          sizes[cur] -= g.vw[v];
          sizes[best] += g.vw[v];
          labels[v] = best;
          ++moved;
        }
      }
      for (int64_t lp : touched) aff[lp] = 0.0;
    }
    double c = cut_of(g, labels);
    if (c < best_cut) {
      best_cut = c;
      best_lab = labels;
    }
    if (moved == 0) break;
  }
  labels = best_lab;
}

// one multilevel ladder at a given coarsening depth
void ladder_run(const WGraph& g, int64_t k, Rng& rng, double cap,
                double total_w, int64_t niter, int64_t coarsest,
                vector<int64_t>& labels) {
  vector<WGraph> levels;
  vector<vector<int64_t>> cmaps;
  levels.push_back(g);
  while (levels.back().n() > coarsest) {
    const WGraph& top = levels.back();
    vector<int64_t> cmap;
    int64_t nc = hem_coarsen(top, rng, 4.0 * total_w / std::max<int64_t>(top.n(), 1),
                             cmap);
    if (nc >= (int64_t)(top.n() * 0.95)) break;
    WGraph c = contract(top, cmap, nc);
    levels.push_back(std::move(c));
    cmaps.push_back(std::move(cmap));
  }
  // multi-restart initial partitioning on the coarsest graph (the METIS
  // ncuts analogue): grow+refine several times, keep the smallest cut
  vector<int64_t> trial;
  double best_cut = -1.0;
  for (int t = 0; t < 6; ++t) {
    region_grow(levels.back(), k, rng, cap, trial);
    refine(levels.back(), k, cap, trial, (int)std::max<int64_t>(niter, 2), rng);
    double c = cut_of(levels.back(), trial);
    if (best_cut < 0 || c < best_cut) {
      best_cut = c;
      labels = trial;
    }
  }
  for (int64_t lvl = (int64_t)cmaps.size() - 1; lvl >= 0; --lvl) {
    const vector<int64_t>& cmap = cmaps[lvl];
    vector<int64_t> fine(cmap.size());
    for (size_t v = 0; v < cmap.size(); ++v) fine[v] = labels[cmap[v]];
    labels = std::move(fine);
    refine(levels[lvl], k, cap, labels, (int)std::max<int64_t>(niter, 4), rng);
  }
}

// full multilevel k-way on a prebuilt symmetric WGraph. Two ladders at
// different coarsening depths (shallow wins at small k where geometry
// survives; deep wins at large k where the initial partition needs a
// tiny coarsest graph — measured on grid/torus anchors), best cut kept.
void kway_core(WGraph g, int64_t k, Rng& rng, int64_t ufactor, int64_t niter,
               vector<int64_t>& labels) {
  double total_w = 0.0;
  for (double w : g.vw) total_w += w;
  double cap = (1.0 + (double)ufactor / 1000.0) * total_w / (double)k;
  const int64_t depths[2] = {std::max<int64_t>(20 * k, 128),
                             std::max<int64_t>(4 * k, 48)};
  double best_cut = -1.0;
  for (int64_t coarsest : depths) {
    vector<int64_t> trial;
    ladder_run(g, k, rng, cap, total_w, niter, coarsest, trial);
    double c = cut_of(g, trial);
    if (best_cut < 0 || c < best_cut) {
      best_cut = c;
      labels = trial;
    }
    if (depths[0] == depths[1]) break;
  }
}

}  // namespace

int64_t sbtpu_partition_kway(int64_t n, const int64_t* indptr,
                             const int64_t* indices, const double* ewts,
                             int64_t k, int64_t seed, int64_t ufactor,
                             int64_t niter, int64_t* out_labels) {
  if (n <= 0) return 0;
  if (k <= 1) {
    std::fill(out_labels, out_labels + n, 0);
    return 0;
  }
  WGraph g = build_sym(n, indptr, indices, ewts);
  Rng rng((uint64_t)seed * 2654435761ULL + 1);
  vector<int64_t> labels;
  kway_core(std::move(g), k, rng, ufactor, niter, labels);
  std::memcpy(out_labels, labels.data(), n * sizeof(int64_t));
  return 0;
}

// ---------------------------------------------------------------------------
// PULP-equivalent size-constrained label propagation (mirror of
// ops/partition/labelprop.py: BFS seeding, penalty-tightened synchronous
// propagation, eviction fixup, boundary refinement; reference wraps the
// external PULP solver, partition/pulp_partition.cc:30-69)
// ---------------------------------------------------------------------------

int64_t sbtpu_pulp(int64_t n, const int64_t* indptr, const int64_t* indices,
                   const int64_t* seeds, int64_t nseeds, int64_t k, double cap,
                   int64_t iters, int64_t* out_labels) {
  if (n <= 0) return 0;
  if (k <= 1) {
    std::fill(out_labels, out_labels + n, 0);
    return 0;
  }
  vector<int64_t> labels(n, -1);
  for (int64_t i = 0; i < nseeds; ++i) labels[seeds[i]] = i;
  if (nseeds > 0) {
    // min-label propagation rounds along out-edges (mirror of _bfs_seed)
    vector<int64_t> cand(n);
    for (int round = 0; round < 64; ++round) {
      std::fill(cand.begin(), cand.end(), (int64_t)1 << 30);
      for (int64_t u = 0; u < n; ++u) {
        if (labels[u] < 0) continue;
        for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e)
          cand[indices[e]] = std::min(cand[indices[e]], labels[u]);
      }
      bool changed = false;
      for (int64_t v = 0; v < n; ++v)
        if (labels[v] < 0 && cand[v] < ((int64_t)1 << 30)) {
          labels[v] = cand[v];
          changed = true;
        }
      if (!changed) break;
    }
  }
  for (int64_t v = 0; v < n; ++v)
    if (labels[v] < 0) labels[v] = (v * k) / std::max<int64_t>(n, 1);

  // synchronous penalty-tightened propagation (mirror of _propagate)
  vector<int64_t> new_labels(n);
  vector<double> cnt(k);
  vector<double> sizes(k);
  for (int64_t it = 0; it < iters; ++it) {
    std::fill(sizes.begin(), sizes.end(), 0.0);
    for (int64_t v = 0; v < n; ++v) sizes[labels[v]] += 1.0;
    // pass 1: global max neighbor count (the numpy counts.max())
    double gmax = 0.0;
    for (int64_t v = 0; v < n; ++v) {
      std::fill(cnt.begin(), cnt.end(), 0.0);
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e)
        cnt[labels[indices[e]]] += 1.0;
      for (int64_t p = 0; p < k; ++p) gmax = std::max(gmax, cnt[p]);
    }
    double alpha = (double)(it + 1) / (double)iters;
    vector<double> penalty(k);
    for (int64_t p = 0; p < k; ++p)
      penalty[p] =
          alpha * std::max(sizes[p] - cap, 0.0) * (gmax + 1.0) / std::max(cap, 1.0);
    bool changed = false;
    for (int64_t v = 0; v < n; ++v) {
      if (indptr[v + 1] == indptr[v]) {  // isolated stays
        new_labels[v] = labels[v];
        continue;
      }
      std::fill(cnt.begin(), cnt.end(), 0.0);
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e)
        cnt[labels[indices[e]]] += 1.0;
      int64_t best = 0;
      double bs = cnt[0] - penalty[0];
      for (int64_t p = 1; p < k; ++p) {
        double s = cnt[p] - penalty[p];
        if (s > bs) {
          bs = s;
          best = p;
        }
      }
      new_labels[v] = best;
      changed |= best != labels[v];
    }
    labels.swap(new_labels);
    if (!changed) break;
  }

  // eviction fixup (mirror of _balance_fixup): oversized parts move their
  // lowest-loss members to the best under-capacity part
  int64_t cap_i = (int64_t)std::floor(cap);
  vector<int64_t> isz(k, 0);
  for (int64_t v = 0; v < n; ++v) ++isz[labels[v]];
  vector<int64_t> parts(k);
  for (int64_t p = 0; p < k; ++p) parts[p] = p;
  std::sort(parts.begin(), parts.end(),
            [&](int64_t a, int64_t b) { return isz[a] > isz[b]; });
  vector<double> aff(k);
  for (int64_t p : parts) {
    int64_t excess = isz[p] - cap_i;
    if (excess <= 0) continue;
    // gain of each member leaving p
    vector<std::pair<double, int64_t>> movers;  // (-gain, v)
    vector<int64_t> besta;
    for (int64_t v = 0; v < n; ++v) {
      if (labels[v] != p) continue;
      std::fill(aff.begin(), aff.end(), 0.0);
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e)
        aff[labels[indices[e]]] += 1.0;
      int64_t alt = p == 0 ? 1 : 0;
      for (int64_t q = 0; q < k; ++q)
        if (q != p && aff[q] > aff[alt]) alt = q;
      movers.emplace_back(-(aff[alt] - aff[p]), v * (int64_t)k + alt);
    }
    std::sort(movers.begin(), movers.end());
    int64_t moved = 0;
    for (auto& mv : movers) {
      if (moved >= excess) break;
      int64_t v = mv.second / k, tgt = mv.second % k;
      if (isz[tgt] >= cap_i) {
        tgt = -1;
        for (int64_t q = 0; q < k; ++q)
          if (q != p && isz[q] < cap_i && (tgt < 0 || isz[q] < isz[tgt])) tgt = q;
        if (tgt < 0) continue;
      }
      labels[v] = tgt;
      --isz[p];
      ++isz[tgt];
      ++moved;
    }
  }

  // final boundary refinement on the symmetrized graph
  WGraph g = build_sym(n, indptr, indices, nullptr);
  Rng rrng(0x9e3779b97f4a7c15ULL);
  refine(g, k, cap, labels, 4, rrng);
  std::memcpy(out_labels, labels.data(), n * sizeof(int64_t));
  return 0;
}

// ---------------------------------------------------------------------------
// Nested dissection (METIS_NodeND-equivalent; recursive native bisection +
// boundary-vertex separators + minimum-degree leaf blocks — same scheme as
// ops/reorder/nested_dissection.py, all in C++)
// ---------------------------------------------------------------------------

namespace {

struct NDContext {
  const vector<int64_t>* sp;
  const vector<int64_t>* sc;
  Rng rng;
  int64_t ufactor, niter, leaf_size;
  vector<int64_t> result;  // result[pos] = vertex
  int64_t cursor = 0;
  vector<int64_t> sub_id;  // global scratch, -1 outside current block
  NDContext(int64_t n, uint64_t seed) : rng(seed), sub_id(n, -1) {}
};

// extract block subgraph (symmetric) into local CSR
void nd_subgraph(NDContext& ctx, const vector<int64_t>& verts,
                 vector<int64_t>& sip, vector<int64_t>& six) {
  const auto& sp = *ctx.sp;
  const auto& sc = *ctx.sc;
  int64_t m = (int64_t)verts.size();
  for (int64_t i = 0; i < m; ++i) ctx.sub_id[verts[i]] = i;
  sip.assign(m + 1, 0);
  for (int64_t i = 0; i < m; ++i) {
    int64_t u = verts[i];
    for (int64_t e = sp[u]; e < sp[u + 1]; ++e)
      if (ctx.sub_id[sc[e]] >= 0) ++sip[i + 1];
  }
  for (int64_t i = 0; i < m; ++i) sip[i + 1] += sip[i];
  six.resize(sip[m]);
  vector<int64_t> cur(sip.begin(), sip.end() - 1);
  for (int64_t i = 0; i < m; ++i) {
    int64_t u = verts[i];
    for (int64_t e = sp[u]; e < sp[u + 1]; ++e)
      if (ctx.sub_id[sc[e]] >= 0) six[cur[i]++] = ctx.sub_id[sc[e]];
  }
  for (int64_t i = 0; i < m; ++i) ctx.sub_id[verts[i]] = -1;
}

void nd_recurse(NDContext& ctx, vector<int64_t> verts, int depth) {
  int64_t m = (int64_t)verts.size();
  if (m == 0) return;
  vector<int64_t> sip, six;
  if (m <= ctx.leaf_size || depth > 120) {
    nd_subgraph(ctx, verts, sip, six);
    vector<int64_t> inv(m);
    amd_core(m, sip, six, 1e300, 1, inv.data());
    // emit in elimination order: result slot (cursor + inv[i]) = verts[i]
    for (int64_t i = 0; i < m; ++i) ctx.result[ctx.cursor + inv[i]] = verts[i];
    ctx.cursor += m;
    return;
  }
  nd_subgraph(ctx, verts, sip, six);
  // bisect the block with the multilevel machinery
  WGraph g;
  g.ip = sip;
  g.ix = six;
  g.ew.assign(six.size(), 1.0);
  g.vw.assign(m, 1.0);
  vector<int64_t> two;
  kway_core(std::move(g), 2, ctx.rng, ctx.ufactor, ctx.niter, two);
  // separator: smaller boundary side of the cut
  vector<char> boundary0(m, 0), boundary1(m, 0);
  int64_t nb0 = 0, nb1 = 0;
  for (int64_t i = 0; i < m; ++i)
    for (int64_t e = sip[i]; e < sip[i + 1]; ++e)
      if (two[i] != two[six[e]]) {
        if (two[i] == 0) {
          if (!boundary0[i]) ++nb0;
          boundary0[i] = 1;
        } else {
          if (!boundary1[i]) ++nb1;
          boundary1[i] = 1;
        }
        break;
      }
  const vector<char>& sep_side = nb0 <= nb1 ? boundary0 : boundary1;
  vector<int64_t> left, right, sep;
  for (int64_t i = 0; i < m; ++i) {
    if (sep_side[i])
      sep.push_back(verts[i]);
    else if (two[i] == 0)
      left.push_back(verts[i]);
    else
      right.push_back(verts[i]);
  }
  if (left.empty() || right.empty()) {
    vector<int64_t> inv(m);
    amd_core(m, sip, six, 1e300, 1, inv.data());
    for (int64_t i = 0; i < m; ++i) ctx.result[ctx.cursor + inv[i]] = verts[i];
    ctx.cursor += m;
    return;
  }
  sip.clear();
  sip.shrink_to_fit();
  six.clear();
  six.shrink_to_fit();
  nd_recurse(ctx, std::move(left), depth + 1);
  nd_recurse(ctx, std::move(right), depth + 1);
  for (int64_t v : sep) ctx.result[ctx.cursor++] = v;
}

}  // namespace

int64_t sbtpu_nested_dissection(int64_t n, const int64_t* indptr,
                                const int64_t* indices, int64_t seed,
                                int64_t ufactor, int64_t niter,
                                int64_t leaf_size, int64_t* out_inv) {
  if (n <= 0) return 0;
  vector<int64_t> sp, sc;
  symmetrize_dedup(n, indptr, indices, sp, sc);
  NDContext ctx(n, (uint64_t)seed * 0x9e3779b97f4a7c15ULL + 7);
  ctx.sp = &sp;
  ctx.sc = &sc;
  ctx.ufactor = ufactor;
  ctx.niter = niter;
  ctx.leaf_size = std::max<int64_t>(leaf_size, 8);
  ctx.result.assign(n, -1);
  vector<int64_t> all(n);
  for (int64_t v = 0; v < n; ++v) all[v] = v;
  nd_recurse(ctx, std::move(all), 0);
  for (int64_t pos = 0; pos < n; ++pos) out_inv[ctx.result[pos]] = pos;
  return 0;
}


// ---------------------------------------------------------------------------
// Symbolic-factorization fill count (mirror of ops/feature/fill.py::
// _fill_nnz_host): nnz(L) incl. diagonal of the Cholesky factor of the
// symmetrized pattern in natural order -- elimination-tree upward walks
// (Gilbert-Ng-Peyton row structure), O(nnz(L)).
// ---------------------------------------------------------------------------
int64_t sbtpu_fill_in(int64_t n, const int64_t* indptr, const int64_t* indices,
                      int64_t* out_count) {
  if (n <= 0) {
    *out_count = 0;
    return 0;
  }
  vector<int64_t> sp, sc;
  symmetrize_dedup(n, indptr, indices, sp, sc);
  vector<int64_t> parent(n, -1), mark(n, -1);
  int64_t count = n;  // diagonal
  for (int64_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t e = sp[i]; e < sp[i + 1]; ++e) {
      int64_t k = sc[e];
      if (k >= i) continue;  // strictly-lower neighbors only
      while (mark[k] != i) {
        if (parent[k] == -1) parent[k] = i;
        mark[k] = i;
        ++count;
        k = parent[k];
      }
    }
  }
  *out_count = count;
  return 0;
}

}  // extern "C"
