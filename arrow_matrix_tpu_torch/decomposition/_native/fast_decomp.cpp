// Native kernels for the arrow decomposition's offline pipeline.
//
// Role: the compiled-performance decomposer layer — the counterpart of
// the reference's Julia module (reference julia/arrow/
// GraphAlgorithms.jl: union-find :7-41, Kruskal MSF :45-80, masked BFS
// :83-195; ArrowDecomposition.jl:_arrow_linear_order :102-135), which
// exists because the per-vertex bookkeeping of linearization is the only
// super-linear-constant hot spot of the offline pipeline at 10^8 rows.
//
// Operates directly on CSR arrays, no graph library.  Exposed via
// ctypes (this environment has no pybind11); see ../native.py.
//
// v2 (round 4): vertex ids are int32 internally (the framework guards
// n < 2^31; half the memory traffic of the v1 int64 arrays), the edge
// shuffle permutes PACKED (u,v) pairs in place so Kruskal scans
// linearly instead of gathering by shuffled id, CSR `indices` may be
// int32 (scipy's native dtype — skips the int64 conversion copy), and
// a structure-only symmetrize replaces scipy's value-carrying A + A^T.
// The Fisher-Yates sequence is UNCHANGED (same splitmix64 stream, same
// swap order), so a given seed produces the identical forest — and
// identical decomposition — as v1.
//
// Threading: AMT_DECOMP_THREADS (default: hardware concurrency,
// clamped to 16) parallelizes edge extraction, symmetrize counting,
// the Kruskal scan (filter-Kruskal: parallel read-only connectivity
// filter between sequential unite passes — the unique-MSF argument
// makes the forest bit-identical to the plain scan), the forest-
// adjacency fill (destination-range partitioning), and large-
// component linearization (level-synchronous sweeps reproducing the
// DFS emit positions exactly — see linearize_tree_levelsync).  Every
// output is thread-count-invariant and bit-identical to the
// single-thread stream; only the Fisher-Yates shuffle is inherently
// sequential (it IS the seed contract).
//
// Algorithms (matching arrow_matrix_tpu/decomposition/linearize.py):
//   amt_random_forest_order[_i32]: uniformly random spanning forest by
//     shuffled-edge Kruskal + union-find, then per-component DFS with
//     children visited in increasing subtree-size order.  Components of
//     size <= base_size are emitted as-is (ascending vertex id).
//   amt_bfs_order[_i32]: deterministic per-component BFS.
//   amt_symmetrize_structure[_i32]: sorted deduped CSR structure of
//     A + A^T (values ignored — the linear-order pipeline only ever
//     consumes the pattern).
//
// Permutation outputs are int64 (numpy-native). All return 0 on
// success unless documented otherwise.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using vid = int32_t;   // vertex id (n < 2^31 guarded by the caller)

// Phase timing to stderr under AMT_DECOMP_PROFILE=1 (pairs with the
// Python-side _phase timers in decompose.py — one switch for the whole
// offline pipeline's attribution).
struct PhaseTimer {
  const char *label;
  bool on;
  std::chrono::steady_clock::time_point t0;

  explicit PhaseTimer(const char *l)
      : label(l), on(std::getenv("AMT_DECOMP_PROFILE") != nullptr),
        t0(std::chrono::steady_clock::now()) {}

  ~PhaseTimer() {
    if (!on) return;
    auto dt = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
    std::fprintf(stderr, "[decomp-native] %s: %.2fs\n", label, dt);
  }
};

int n_threads() {
  if (const char *env = std::getenv("AMT_DECOMP_THREADS")) {
    int t = std::atoi(env);
    if (t >= 1) return std::min(t, 16);
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? std::min<int>(hw, 16) : 1;
}

// Run fn(t, lo, hi) over [0, n) split into T contiguous ranges.
// min_n: below this the call runs inline sequential (spawn cost floor);
// the level-synchronous sweeps pass a lower floor than the default —
// their per-element work is an adjacency scan + sort, not a counter.
template <typename F>
void parallel_ranges(int64_t n, int T, F fn, int64_t min_n = 1 << 16) {
  if (T <= 1 || n < min_n) {
    fn(0, 0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, t, lo, hi);
  }
  for (auto &th : threads) th.join();
}

// SplitMix64: tiny, high-quality, seedable — the RNG for edge shuffling.
inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Union-find with path halving + union by size (reference
// GraphAlgorithms.jl:7-41 uses path compression + rank; size works the
// same and doubles as the component-size lookup).
struct UnionFind {
  std::vector<vid> parent;
  std::vector<vid> size;

  explicit UnionFind(vid n) : parent(n), size(n, 1) {
    for (vid i = 0; i < n; ++i) parent[i] = i;
  }

  vid find(vid x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }

  // Read-only find for CONCURRENT use (no path halving, no writes).
  // Union-by-size bounds the chain at O(log n).  Only valid while no
  // thread is mutating — the filter-Kruskal phases alternate strictly
  // between parallel read-only filtering and sequential uniting.
  vid find_ro(vid x) const {
    while (parent[x] != x) x = parent[x];
    return x;
  }

  bool unite(vid a, vid b) {
    a = find(a);
    b = find(b);
    if (a == b) return false;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    return true;
  }
};

inline uint64_t pack_edge(vid u, vid v) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(u)) << 32) |
         static_cast<uint32_t>(v);
}

// Linearize one rooted forest tree: DFS preorder + parents, subtree
// sizes in reverse preorder, then a second DFS visiting children in
// increasing subtree-size order (larger subtrees last — the linear-
// arrangement cost heuristic, reference
// ArrowDecomposition.jl/_linearize_tree, linearize.py:_linearize_tree).
void linearize_tree(vid root, const std::vector<int64_t> &adj_ptr,
                    const std::vector<vid> &adj, std::vector<vid> &parent,
                    std::vector<vid> &subtree, std::vector<vid> &preorder,
                    std::vector<vid> &stack, int64_t *out,
                    int64_t &out_pos) {
  // Pass 1: DFS preorder, recording parents.
  preorder.clear();
  stack.clear();
  stack.push_back(root);
  parent[root] = -1;
  while (!stack.empty()) {
    vid v = stack.back();
    stack.pop_back();
    preorder.push_back(v);
    for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
      vid u = adj[e];
      if (u != parent[v] && parent[u] == -2) {
        parent[u] = v;
        stack.push_back(u);
      }
    }
  }
  // Pass 2: subtree sizes in reverse preorder.
  for (auto it = preorder.rbegin(); it != preorder.rend(); ++it) {
    subtree[*it] = 1;
  }
  for (auto it = preorder.rbegin(); it != preorder.rend(); ++it) {
    vid v = *it;
    if (parent[v] >= 0) subtree[parent[v]] += subtree[v];
  }
  // Pass 3: DFS emitting children by increasing subtree size (push
  // descending so the smallest pops first).
  std::vector<std::pair<vid, vid>> kids;  // (size, child)
  stack.clear();
  stack.push_back(root);
  while (!stack.empty()) {
    vid v = stack.back();
    stack.pop_back();
    out[out_pos++] = v;
    kids.clear();
    for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
      vid u = adj[e];
      if (parent[u] == v) kids.emplace_back(subtree[u], u);
    }
    std::sort(kids.begin(), kids.end());
    for (auto it = kids.rbegin(); it != kids.rend(); ++it) {
      stack.push_back(it->second);
    }
  }
}

// Level-synchronous linearization of ONE large tree — emit-order-
// IDENTICAL to linearize_tree, with every sweep parallel over a level:
//
// 1. parents by tree-BFS.  In a tree the parent of v is its unique
//    neighbor on the path to the root, so the parent array is a
//    property of (tree, root), not of traversal order — BFS and DFS
//    produce the same parents.  Each unvisited vertex is adjacent to
//    exactly ONE frontier vertex (its parent), so frontier expansion
//    has no write conflicts and needs no atomics.
// 2. subtree sizes bottom-up per level: subtree[v] = 1 + sum over
//    children (one level deeper, already final).
// 3. emit positions top-down per level.  The sequential DFS emits v at
//    the start of its subtree block, then the children blocks in
//    increasing (subtree, id) order — so pos[child] = pos[v] + 1 +
//    total size of smaller siblings, a per-vertex computation once
//    pos[v] is known.  Same comparator as linearize_tree's kids sort.
// 4. scatter out[pos[v]] = v (positions are a permutation — disjoint).
//
// Within-level ORDER of the bfs array depends on the thread partition,
// but nothing below derives from it (levels are sets); the OUTPUT is
// thread-count-invariant and bit-identical to the sequential path.
constexpr int64_t kLevelParMin = 1 << 13;

void linearize_tree_levelsync(vid root, const std::vector<int64_t> &adj_ptr,
                              const std::vector<vid> &adj,
                              std::vector<vid> &parent,
                              std::vector<vid> &subtree,
                              std::vector<vid> &pos, std::vector<vid> &order,
                              std::vector<int64_t> &level_lo, int T,
                              int64_t *out, int64_t &out_pos) {
  order.clear();
  level_lo.clear();
  order.push_back(root);
  parent[root] = -1;
  level_lo.push_back(0);
  // Pass 1: BFS levels.
  {
    std::vector<std::vector<vid>> parts(std::max(T, 1));
    size_t lo = 0;
    while (lo < order.size()) {
      size_t hi = order.size();
      int64_t width = static_cast<int64_t>(hi - lo);
      if (T <= 1 || width < kLevelParMin) {
        for (size_t i = lo; i < hi; ++i) {
          vid v = order[i];
          for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
            vid u = adj[e];
            if (u != parent[v]) {
              parent[u] = v;
              order.push_back(u);
            }
          }
        }
      } else {
        parallel_ranges(width, T, [&](int tid, int64_t a, int64_t b) {
          auto &buf = parts[tid];
          buf.clear();
          for (int64_t i = a; i < b; ++i) {
            vid v = order[lo + i];
            for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
              vid u = adj[e];
              if (u != parent[v]) {
                parent[u] = v;   // u's unique parent: conflict-free
                buf.push_back(u);
              }
            }
          }
        }, kLevelParMin);
        for (auto &p : parts) {
          order.insert(order.end(), p.begin(), p.end());
          p.clear();
        }
      }
      lo = hi;
      level_lo.push_back(static_cast<int64_t>(order.size()));
    }
  }
  const int n_levels = static_cast<int>(level_lo.size()) - 1;
  if (std::getenv("AMT_DECOMP_PROFILE") != nullptr) {
    int64_t widest = 0;
    for (int L = 0; L < n_levels; ++L) {
      widest = std::max(widest, level_lo[L + 1] - level_lo[L]);
    }
    // widest >= kLevelParMin (2^13) means the per-level sweeps
    // actually ran their parallel branch, not just the level-sync
    // dispatch — the attribution the parity tests need.
    std::fprintf(stderr,
                 "[decomp-native] levelsync: %lld vertices, %d levels, "
                 "widest %lld\n",
                 static_cast<long long>(order.size()), n_levels,
                 static_cast<long long>(widest));
  }
  // Pass 2: subtree sizes, deepest level first.
  for (int L = n_levels - 1; L >= 0; --L) {
    int64_t lo = level_lo[L], width = level_lo[L + 1] - level_lo[L];
    parallel_ranges(width, T, [&](int, int64_t a, int64_t b) {
      for (int64_t i = a; i < b; ++i) {
        vid v = order[lo + i];
        vid s = 1;
        for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
          vid u = adj[e];
          if (parent[u] == v) s += subtree[u];
        }
        subtree[v] = s;
      }
    }, kLevelParMin);
  }
  // Pass 3: positions, top level first.
  pos[root] = static_cast<vid>(out_pos);
  for (int L = 0; L < n_levels; ++L) {
    int64_t lo = level_lo[L], width = level_lo[L + 1] - level_lo[L];
    parallel_ranges(width, T, [&](int, int64_t a, int64_t b) {
      std::vector<std::pair<vid, vid>> kids;
      for (int64_t i = a; i < b; ++i) {
        vid v = order[lo + i];
        kids.clear();
        for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
          vid u = adj[e];
          if (parent[u] == v) kids.emplace_back(subtree[u], u);
        }
        std::sort(kids.begin(), kids.end());
        vid p = pos[v] + 1;
        for (auto &su : kids) {
          pos[su.second] = p;
          p += su.first;
        }
      }
    }, kLevelParMin);
  }
  // Pass 4: scatter.
  int64_t total = static_cast<int64_t>(order.size());
  parallel_ranges(total, T, [&](int, int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      vid v = order[i];
      out[pos[v]] = v;
    }
  }, kLevelParMin);
  out_pos += total;
}

// Core of the random-forest linearization once the unique undirected
// edge list (u < v, packed, vertex ids in [0, n)) is in hand:
// shuffled-edge Kruskal, forest adjacency, per-component emit.
int forest_order_from_edges(vid n, std::vector<uint64_t> &edges,
                            uint64_t seed, int64_t base_size,
                            int64_t *out) {
  const int64_t m = static_cast<int64_t>(edges.size());

  // Shuffled-edge Kruskal == Kruskal on iid random weights == a random
  // spanning forest (reference GraphAlgorithms.jl:45-80 sorts random
  // weights; a Fisher-Yates shuffle of edge ids is the same ordering).
  // v2: the PACKED pairs are shuffled in place — the same splitmix64
  // swap sequence as v1's id shuffle applies the identical permutation,
  // but the Kruskal pass below then scans LINEARLY instead of gathering
  // 16 B per edge at random (the v1 profile's hottest native phase).
  {
    PhaseTimer t("shuffle");
    uint64_t state = seed ^ 0xdeadbeefcafef00dULL;
    for (int64_t i = m - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(splitmix64(state) % (i + 1));
      std::swap(edges[i], edges[j]);
    }
  }

  const int T = n_threads();
  UnionFind uf(n);
  std::vector<vid> tu, tv;
  {
    PhaseTimer t(T > 1 && m >= (1 << 19) ? "kruskal-filter" : "kruskal");
    tu.reserve(n);
    tv.reserve(n);
    auto unite_edge = [&](int64_t i) {
      vid a = static_cast<vid>(edges[i] >> 32);
      vid b = static_cast<vid>(edges[i] & 0xffffffffu);
      if (uf.unite(a, b)) {
        tu.push_back(a);
        tv.push_back(b);
      }
    };
    if (T <= 1 || m < (1 << 19)) {
      for (int64_t i = 0; i < m; ++i) unite_edge(i);
    } else {
      // Filter-Kruskal over the shuffled stream (the shuffled position
      // IS the random weight, so the MSF is unique): unite the first
      // chunk sequentially, then for each subsequent (doubling) chunk
      // first drop — in parallel, with the read-only find — every edge
      // whose endpoints are already connected.  Filtering only removes
      // edges that can never be tree edges at their position, so the
      // tree-edge sequence (and the forest) is BIT-IDENTICAL to the
      // plain scan for every thread count.  After the first ~2n edges
      // the forest is nearly complete and the filter kills almost all
      // of the remaining stream, leaving the sequential unite with
      // O(n)-ish survivors.
      int64_t done = std::min<int64_t>(
          m, std::max<int64_t>(2 * static_cast<int64_t>(n), 1 << 19));
      for (int64_t i = 0; i < done; ++i) unite_edge(i);
      std::vector<char> keep;
      int64_t chunk = done;
      while (done < m) {
        int64_t c = std::min(m - done, chunk);
        keep.assign(c, 0);
        parallel_ranges(c, T, [&](int, int64_t lo, int64_t hi) {
          for (int64_t i = lo; i < hi; ++i) {
            vid a = static_cast<vid>(edges[done + i] >> 32);
            vid b = static_cast<vid>(edges[done + i] & 0xffffffffu);
            keep[i] = uf.find_ro(a) != uf.find_ro(b);
          }
        });
        for (int64_t i = 0; i < c; ++i) {
          if (keep[i]) unite_edge(done + i);
        }
        done += c;
        chunk *= 2;
      }
    }
  }
  edges.clear();
  edges.shrink_to_fit();

  // Forest adjacency (CSR, both directions).  Parallel mode partitions
  // by DESTINATION vertex range (the sym-transpose-count recipe): each
  // thread scans the whole tree-edge list but touches only its own
  // disjoint adj_ptr/fill/adj slice, in the same scan order — output
  // identical to the sequential fill, no atomics.
  std::vector<int64_t> adj_ptr(n + 1, 0);
  std::vector<vid> adj;
  {
    PhaseTimer t("forest-adjacency");
    const int64_t nt = static_cast<int64_t>(tu.size());
    if (T <= 1 || n < (1 << 18)) {
      for (int64_t i = 0; i < nt; ++i) {
        ++adj_ptr[tu[i] + 1];
        ++adj_ptr[tv[i] + 1];
      }
    } else {
      parallel_ranges(n, T, [&](int, int64_t v_lo, int64_t v_hi) {
        for (int64_t i = 0; i < nt; ++i) {
          if (tu[i] >= v_lo && tu[i] < v_hi) ++adj_ptr[tu[i] + 1];
          if (tv[i] >= v_lo && tv[i] < v_hi) ++adj_ptr[tv[i] + 1];
        }
      });
    }
    for (vid v = 0; v < n; ++v) adj_ptr[v + 1] += adj_ptr[v];
    adj.resize(adj_ptr[n]);
    std::vector<int64_t> fill(adj_ptr.begin(), adj_ptr.end() - 1);
    if (T <= 1 || n < (1 << 18)) {
      for (int64_t i = 0; i < nt; ++i) {
        adj[fill[tu[i]]++] = tv[i];
        adj[fill[tv[i]]++] = tu[i];
      }
    } else {
      parallel_ranges(n, T, [&](int, int64_t v_lo, int64_t v_hi) {
        for (int64_t i = 0; i < nt; ++i) {
          if (tu[i] >= v_lo && tu[i] < v_hi) adj[fill[tu[i]]++] = tv[i];
          if (tv[i] >= v_lo && tv[i] < v_hi) adj[fill[tv[i]]++] = tu[i];
        }
      });
    }
  }

  // Emit components in order of smallest member (scipy's label order in
  // linearize.py).  parent doubles as the visited marker: -2 unvisited.
  PhaseTimer t_emit(T > 1 ? "linearize-emit-par" : "linearize-emit");
  std::vector<vid> parent(n, -2), subtree(n, 0), preorder, stack;
  std::vector<vid> members;
  // Scratch for the level-synchronous path, allocated on first use.
  std::vector<vid> ls_pos, ls_order;
  std::vector<int64_t> ls_levels;
  int64_t out_pos = 0;
  for (vid v = 0; v < n; ++v) {
    if (parent[v] != -2) continue;
    vid root = uf.find(v);
    int64_t comp_size = uf.size[root];
    if (comp_size <= base_size) {
      // Small component: ascending vertex ids.  Collect by BFS over the
      // forest (spanning: reaches every member), then sort.
      members.clear();
      members.push_back(v);
      parent[v] = -1;
      for (size_t h = 0; h < members.size(); ++h) {
        vid w = members[h];
        for (int64_t e = adj_ptr[w]; e < adj_ptr[w + 1]; ++e) {
          vid u = adj[e];
          if (parent[u] == -2) {
            parent[u] = w;
            members.push_back(u);
          }
        }
      }
      std::sort(members.begin(), members.end());
      for (vid w : members) out[out_pos++] = w;
    } else if (T > 1 && comp_size >= (1 << 16)) {
      if (ls_pos.empty()) {
        ls_pos.resize(n);
        ls_order.reserve(comp_size);
      }
      linearize_tree_levelsync(v, adj_ptr, adj, parent, subtree, ls_pos,
                               ls_order, ls_levels, T, out, out_pos);
    } else {
      linearize_tree(v, adj_ptr, adj, parent, subtree, preorder, stack,
                     out, out_pos);
    }
  }
  return out_pos == n ? 0 : 1;
}

// Indices accessor generic over the CSR index dtype (int32 = scipy's
// native dtype below 2^31 nnz — v1 forced an int64 conversion COPY of
// the whole index array per call).
template <typename IDX>
void extract_edges(vid n, const int64_t *indptr, const IDX *indices,
                   std::vector<uint64_t> &edges) {
  PhaseTimer t("edge-extract");
  int T = n_threads();
  std::vector<std::vector<uint64_t>> parts(std::max(T, 1));
  parallel_ranges(n, T, [&](int tid, int64_t lo, int64_t hi) {
    auto &buf = parts[tid];
    buf.reserve((indptr[hi] - indptr[lo]) / 2);
    for (int64_t u = lo; u < hi; ++u) {
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int64_t v = static_cast<int64_t>(indices[e]);
        if (u < v)
          buf.push_back(pack_edge(static_cast<vid>(u),
                                  static_cast<vid>(v)));
      }
    }
  });
  size_t total = 0;
  for (auto &p : parts) total += p.size();
  edges.clear();
  edges.reserve(total);
  for (auto &p : parts) {   // in tid order: deterministic edge order
    edges.insert(edges.end(), p.begin(), p.end());
    p.clear();
    p.shrink_to_fit();
  }
}

template <typename IDX>
void extract_edges_masked(vid n, const int64_t *indptr, const IDX *indices,
                          int64_t k, const int64_t *active,
                          const std::vector<vid> &label,
                          std::vector<uint64_t> &edges) {
  PhaseTimer t("edge-extract-masked");
  int T = n_threads();
  std::vector<std::vector<uint64_t>> parts(std::max(T, 1));
  parallel_ranges(k, T, [&](int tid, int64_t lo, int64_t hi) {
    auto &buf = parts[tid];
    for (int64_t i = lo; i < hi; ++i) {
      int64_t u = active[i];
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        vid lv = label[indices[e]];
        if (lv > i)
          buf.push_back(pack_edge(static_cast<vid>(i), lv));
      }
    }
  });
  size_t total = 0;
  for (auto &p : parts) total += p.size();
  edges.clear();
  edges.reserve(total);
  for (auto &p : parts) {
    edges.insert(edges.end(), p.begin(), p.end());
    p.clear();
    p.shrink_to_fit();
  }
}

template <typename IDX>
int forest_order_impl(int64_t n64, const int64_t *indptr,
                      const IDX *indices, uint64_t seed,
                      int64_t base_size, int64_t *out) {
  if (n64 == 0) return 0;
  if (n64 > INT32_MAX) return 3;
  vid n = static_cast<vid>(n64);
  std::vector<uint64_t> edges;
  extract_edges(n, indptr, indices, edges);
  return forest_order_from_edges(n, edges, seed, base_size, out);
}

template <typename IDX>
int forest_order_masked_impl(int64_t n64, const int64_t *indptr,
                             const IDX *indices, uint64_t seed,
                             int64_t base_size, int64_t k,
                             const int64_t *active, int64_t *out) {
  // Forest order of the induced submatrix sym[active][:, active]
  // WITHOUT materializing it: one O(n + m) label-and-filter pass
  // replaces scipy's fancy-indexed row+column extraction.  ``active``
  // holds the original vertex id of each submatrix position; ``out``
  // receives a permutation of [0, k) in submatrix positions — the same
  // contract as running the full forest order on the materialized
  // submatrix.
  if (k == 0) return 0;
  if (n64 > INT32_MAX || k > INT32_MAX) return 3;
  vid n = static_cast<vid>(n64);
  std::vector<vid> label(n, -1);
  for (int64_t i = 0; i < k; ++i) {
    if (active[i] < 0 || active[i] >= n64 || label[active[i]] != -1)
      return 2;  // not a valid vertex subset
    label[active[i]] = static_cast<vid>(i);
  }
  std::vector<uint64_t> edges;
  extract_edges_masked(n, indptr, indices, k, active, label, edges);
  return forest_order_from_edges(static_cast<vid>(k), edges, seed,
                                 base_size, out);
}

template <typename IDX>
int bfs_order_impl(int64_t n64, const int64_t *indptr, const IDX *indices,
                   int64_t base_size, int64_t *out) {
  if (n64 == 0) return 0;
  if (n64 > INT32_MAX) return 3;
  vid n = static_cast<vid>(n64);
  std::vector<vid> queue;
  std::vector<char> visited(n, 0);
  int64_t out_pos = 0;
  for (vid v = 0; v < n; ++v) {
    if (visited[v]) continue;
    // BFS the component (reference masked BFS,
    // GraphAlgorithms.jl:83-195).
    queue.clear();
    queue.push_back(v);
    visited[v] = 1;
    for (size_t h = 0; h < queue.size(); ++h) {
      vid w = queue[h];
      for (int64_t e = indptr[w]; e < indptr[w + 1]; ++e) {
        vid u = static_cast<vid>(indices[e]);
        if (!visited[u]) {
          visited[u] = 1;
          queue.push_back(u);
        }
      }
    }
    if (static_cast<int64_t>(queue.size()) <= base_size) {
      std::sort(queue.begin(), queue.end());
    }
    for (vid w : queue) out[out_pos++] = w;
  }
  return out_pos == n64 ? 0 : 1;
}

// Structure-only A + A^T: sorted, deduped CSR pattern (what the whole
// linear-order pipeline consumes — scipy's value-carrying A + A.T was
// the single largest host phase in the v1 profile).  out_indices must
// have capacity 2 * nnz; returns the symmetric nnz, or -1 on error.
template <typename IDX>
int64_t symmetrize_structure_impl(int64_t n64, const int64_t *indptr,
                                  const IDX *indices, int64_t *out_indptr,
                                  int32_t *out_indices) {
  if (n64 > INT32_MAX) return -1;
  vid n = static_cast<vid>(n64);
  const int64_t nnz = indptr[n];
  int T = n_threads();

  // Transpose counts.  Parallel mode partitions by DESTINATION column
  // range — each thread scans the whole index array but increments
  // only its disjoint slice of the ONE shared histogram (no per-thread
  // O(n) copies: T x 8 B x n transient histograms would rival the
  // graph's own index arrays at the 10^8-row target).  Deterministic
  // and race-free by construction.
  std::vector<int64_t> t_ptr(static_cast<size_t>(n) + 1, 0);
  {
    PhaseTimer t("sym-transpose-count");
    if (T <= 1 || nnz < (1 << 18)) {
      for (int64_t e = 0; e < nnz; ++e) ++t_ptr[indices[e] + 1];
    } else {
      parallel_ranges(n, T, [&](int, int64_t col_lo, int64_t col_hi) {
        for (int64_t e = 0; e < nnz; ++e) {
          int64_t c = static_cast<int64_t>(indices[e]);
          if (c >= col_lo && c < col_hi) ++t_ptr[c + 1];
        }
      });
    }
    for (vid v = 0; v < n; ++v) t_ptr[v + 1] += t_ptr[v];
  }

  // Transpose fill: the ascending row scan makes every transpose row
  // sorted by construction.  Above a size cutoff the single-pass
  // scatter (random writes across the whole t_idx span) is replaced
  // by a BUCKETED two-pass fill: pass A streams (col, row) pairs into
  // ~256 column-range buckets (sequential writes), pass B scatters
  // within one bucket at a time (its fill span fits cache).  Each
  // bucket receives entries in ascending row order, so the per-column
  // order — and therefore the output — is bit-identical.
  std::vector<vid> t_idx(nnz);
  {
    PhaseTimer t("sym-transpose-fill");
    if (nnz < (1 << 22)) {
      std::vector<int64_t> fill(t_ptr.begin(), t_ptr.end() - 1);
      for (vid u = 0; u < n; ++u) {
        for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
          t_idx[fill[indices[e]]++] = u;
        }
      }
    } else {
      const int n_buckets = 256;
      // Shift must be derived from the MAX ID (n-1), not n: bucket
      // index is (id >> shift) and must stay < n_buckets for every
      // id.  Deriving it from n left id n-1 mapping to bucket 256
      // for any n in (256*2^s, 257*2^s] — an out-of-bounds b_count/
      // bf write AND a bucket pass B never scattered (ADVICE r4).
      const int shift = [&] {
        int s = 0;
        while ((static_cast<int64_t>(n - 1) >> s) >= n_buckets) ++s;
        return s;
      }();
      std::vector<int64_t> b_count(n_buckets + 1, 0);
      for (vid u = 0; u < n; ++u) {
        for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
          ++b_count[(indices[e] >> shift) + 1];
        }
      }
      for (int b = 0; b < n_buckets; ++b) b_count[b + 1] += b_count[b];
      std::vector<uint64_t> pairs(nnz);   // (col << 32) | row
      {
        std::vector<int64_t> bf(b_count.begin(), b_count.end() - 1);
        for (vid u = 0; u < n; ++u) {
          for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
            vid c = static_cast<vid>(indices[e]);
            pairs[bf[c >> shift]++] = pack_edge(c, u);
          }
        }
      }
      std::vector<int64_t> fill(t_ptr.begin(), t_ptr.end() - 1);
      for (int b = 0; b < n_buckets; ++b) {
        for (int64_t i = b_count[b]; i < b_count[b + 1]; ++i) {
          vid c = static_cast<vid>(pairs[i] >> 32);
          t_idx[fill[c]++] = static_cast<vid>(pairs[i] & 0xffffffffu);
        }
      }
    }
  }

  // Per-row union of the A row (sorted on demand) and the transpose
  // row (sorted by construction), deduped, written compacted.
  {
    PhaseTimer t("sym-merge");
    std::vector<vid> arow;
    int64_t pos = 0;
    out_indptr[0] = 0;
    for (vid u = 0; u < n; ++u) {
      const int64_t a_lo = indptr[u], a_hi = indptr[u + 1];
      arow.assign(indices + a_lo, indices + a_hi);
      // Input CSR rows are not guaranteed canonical (the decomposer
      // accepts any tocsr()); sort+dedup the A row locally.  Most
      // rows ARE already sorted (level_split emits canonical levels
      // and row-ordered rests) — the linear is_sorted check skips the
      // O(d log d) sort for them.
      if (!std::is_sorted(arow.begin(), arow.end())) {
        std::sort(arow.begin(), arow.end());
      }
      arow.erase(std::unique(arow.begin(), arow.end()), arow.end());
      const vid *b = t_idx.data() + t_ptr[u];
      const vid *b_end = t_idx.data() + t_ptr[u + 1];
      const vid *a = arow.data();
      const vid *a_end = a + arow.size();
      while (a < a_end && b < b_end) {
        vid av = *a, bv = *b;
        vid w = av < bv ? av : bv;
        out_indices[pos++] = w;
        if (av <= bv) ++a;
        if (bv <= av) {
          // Skip duplicate transpose entries (parallel edges).
          do {
            ++b;
          } while (b < b_end && *b == bv);
        }
      }
      while (a < a_end) out_indices[pos++] = *a++;
      while (b < b_end) {
        vid bv = *b;
        out_indices[pos++] = bv;
        do {
          ++b;
        } while (b < b_end && *b == bv);
      }
      out_indptr[u + 1] = pos;
    }
    return pos;
  }
}

// Fused per-level edge routing (v2): one pass over the source CSR
// replaces the numpy chain tocoo -> inv-gather -> boolean select ->
// two scipy COO->CSR builds (+ sum_duplicates + sort_indices) that the
// v1 profile measured at ~10 s of 37 s (n=2^21).  Classifies every
// entry by the arrow criterion in PERMUTED coordinates, emits
//   * the level matrix as canonical CSR in permuted coordinates
//     (rows sorted, duplicates summed — what the tiling builders
//     require), and
//   * the remainder as CSR in ORIGINAL coordinates (the recursion
//     re-linearizes it; canonical form not required, matching the
//     numpy path's coo build).
// data == nullptr means implicit-ones values (level_data still
// emitted, as ones, so the scipy wrapper is uniform).
template <typename IDX, typename VAL>
int level_split_impl(int64_t n64, const int64_t *indptr,
                     const IDX *indices, const VAL *data,
                     const int32_t *inv, int64_t width,
                     int block_diagonal, int prune,
                     int64_t *lvl_indptr, int32_t *lvl_indices,
                     VAL *lvl_data, int64_t *rest_indptr,
                     int32_t *rest_indices, VAL *rest_data,
                     int64_t *counts /* [lvl_nnz, rest_nnz] out */) {
  if (n64 > INT32_MAX) return 3;
  vid n = static_cast<vid>(n64);
  const int64_t w = width;

  auto in_level = [&](vid rp, vid cp) -> bool {
    bool in;
    if (block_diagonal) {
      in = (rp / w) == (cp / w);
    } else {
      int64_t d = static_cast<int64_t>(rp) - cp;
      in = (d < 0 ? -d : d) <= w;
    }
    if (prune) in = in || rp < w || cp < w;
    return in;
  };

  // Pass 1: count level entries per PERMUTED row, rest entries per
  // SOURCE row.  The permuted columns are CACHED (one int32 per
  // entry) so pass 2 reruns no random inv[] gather — the gathers are
  // the passes' dominant cost (split profile, PERFORMANCE.md).
  const int64_t nnz = indptr[n];
  std::vector<int64_t> lvl_count(static_cast<size_t>(n) + 1, 0);
  std::vector<vid> cp_cache(nnz);
  int64_t rest_total = 0;
  {
    PhaseTimer t("split-count");
    rest_indptr[0] = 0;
    for (vid u = 0; u < n; ++u) {
      vid rp = inv[u];
      int64_t rest_row = 0;
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        vid cp = inv[indices[e]];
        cp_cache[e] = cp;
        if (in_level(rp, cp)) {
          ++lvl_count[rp + 1];
        } else {
          ++rest_row;
        }
      }
      rest_total += rest_row;
      rest_indptr[u + 1] = rest_total;
    }
  }
  int64_t lvl_total = nnz - rest_total;
  if (lvl_total == 0 && rest_total > 0) {
    // Degenerate all-False case: the caller keeps every edge in the
    // level instead (decompose.py's fallback) — signal it.
    return 4;
  }

  // Level row offsets.
  {
    lvl_indptr[0] = 0;
    for (vid v = 0; v < n; ++v)
      lvl_indptr[v + 1] = lvl_indptr[v] + lvl_count[v + 1];
  }

  // Pass 2: fill both outputs.
  {
    PhaseTimer t("split-fill");
    std::vector<int64_t> fill(lvl_indptr, lvl_indptr + n);
    int64_t rpos = 0;
    for (vid u = 0; u < n; ++u) {
      vid rp = inv[u];
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        vid cp = cp_cache[e];
        VAL val = data ? data[e] : static_cast<VAL>(1);
        if (in_level(rp, cp)) {
          int64_t p = fill[rp]++;
          lvl_indices[p] = cp;
          lvl_data[p] = val;
        } else {
          rest_indices[rpos] = static_cast<int32_t>(indices[e]);
          rest_data[rpos] = val;
          ++rpos;
        }
      }
    }
  }

  // Pass 3: canonicalize the level rows (sort by column, sum
  // duplicates, compact).  Rows are short (<= a few hundred); an
  // insertion-friendly std::sort per row is cache-local.
  {
    PhaseTimer t("split-canonicalize");
    std::vector<std::pair<int32_t, VAL>> row;
    int64_t wpos = 0;
    int64_t read_base = 0;
    for (vid v = 0; v < n; ++v) {
      int64_t lo = read_base, hi = lvl_indptr[v + 1];
      read_base = hi;
      row.clear();
      for (int64_t e = lo; e < hi; ++e)
        row.emplace_back(lvl_indices[e], lvl_data[e]);
      std::sort(row.begin(), row.end(),
                [](const auto &x, const auto &y) {
                  return x.first < y.first;
                });
      int64_t row_start = wpos;
      for (size_t i = 0; i < row.size(); ++i) {
        if (wpos > row_start &&
            lvl_indices[wpos - 1] == row[i].first) {
          lvl_data[wpos - 1] += row[i].second;
        } else {
          lvl_indices[wpos] = row[i].first;
          lvl_data[wpos] = row[i].second;
          ++wpos;
        }
      }
      lvl_indptr[v + 1] = wpos;
    }
    lvl_total = wpos;
  }

  counts[0] = lvl_total;
  counts[1] = rest_total;
  return 0;
}

}  // namespace

extern "C" {

int amt_random_forest_order(int64_t n, const int64_t *indptr,
                            const int64_t *indices, uint64_t seed,
                            int64_t base_size, int64_t *out) {
  return forest_order_impl(n, indptr, indices, seed, base_size, out);
}

int amt_random_forest_order_i32(int64_t n, const int64_t *indptr,
                                const int32_t *indices, uint64_t seed,
                                int64_t base_size, int64_t *out) {
  return forest_order_impl(n, indptr, indices, seed, base_size, out);
}

int amt_random_forest_order_masked(int64_t n, const int64_t *indptr,
                                   const int64_t *indices, uint64_t seed,
                                   int64_t base_size, int64_t k,
                                   const int64_t *active, int64_t *out) {
  return forest_order_masked_impl(n, indptr, indices, seed, base_size, k,
                                  active, out);
}

int amt_random_forest_order_masked_i32(int64_t n, const int64_t *indptr,
                                       const int32_t *indices,
                                       uint64_t seed, int64_t base_size,
                                       int64_t k, const int64_t *active,
                                       int64_t *out) {
  return forest_order_masked_impl(n, indptr, indices, seed, base_size, k,
                                  active, out);
}

int amt_bfs_order(int64_t n, const int64_t *indptr, const int64_t *indices,
                  int64_t base_size, int64_t *out) {
  return bfs_order_impl(n, indptr, indices, base_size, out);
}

int amt_bfs_order_i32(int64_t n, const int64_t *indptr,
                      const int32_t *indices, int64_t base_size,
                      int64_t *out) {
  return bfs_order_impl(n, indptr, indices, base_size, out);
}

int64_t amt_symmetrize_structure(int64_t n, const int64_t *indptr,
                                 const int64_t *indices,
                                 int64_t *out_indptr,
                                 int32_t *out_indices) {
  return symmetrize_structure_impl(n, indptr, indices, out_indptr,
                                   out_indices);
}

int64_t amt_symmetrize_structure_i32(int64_t n, const int64_t *indptr,
                                     const int32_t *indices,
                                     int64_t *out_indptr,
                                     int32_t *out_indices) {
  return symmetrize_structure_impl(n, indptr, indices, out_indptr,
                                   out_indices);
}

#define AMT_LEVEL_SPLIT(NAME, IDX, VAL)                                   \
  int NAME(int64_t n, const int64_t *indptr, const IDX *indices,          \
           const VAL *data, const int32_t *inv, int64_t width,            \
           int block_diagonal, int prune, int64_t *lvl_indptr,            \
           int32_t *lvl_indices, VAL *lvl_data, int64_t *rest_indptr,     \
           int32_t *rest_indices, VAL *rest_data, int64_t *counts) {      \
    return level_split_impl(n, indptr, indices, data, inv, width,         \
                            block_diagonal, prune, lvl_indptr,            \
                            lvl_indices, lvl_data, rest_indptr,           \
                            rest_indices, rest_data, counts);             \
  }

AMT_LEVEL_SPLIT(amt_level_split_i32_f32, int32_t, float)
AMT_LEVEL_SPLIT(amt_level_split_i32_f64, int32_t, double)
AMT_LEVEL_SPLIT(amt_level_split_i64_f32, int64_t, float)
AMT_LEVEL_SPLIT(amt_level_split_i64_f64, int64_t, double)

#undef AMT_LEVEL_SPLIT

}  // extern "C"
