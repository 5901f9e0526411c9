// Host C++ builders of the data path's graphs (counterpart of
// graphphysics_tpu/native/graph_native.cpp): FaceToEdge, the k-hop
// expansion and the fixed-degree (ELL) grouping. A plain C interface, bound
// with ctypes by native/__init__.py, which checks shapes and dtypes first.
//
// No global sort: each function groups its pairs by sender (or receiver)
// with a counting pass, then works inside one node's short row, so the
// result comes out in (sender, receiver) order as the rows are walked.
//
// Node ids are int64 in and int32 out (the port's edge dtype). Every id is
// checked against [0, num_nodes): an id outside it returns -3 before any
// output is written past the caller's buffers.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Sorts v[0, n) ascending and keeps one of each value; returns how many.
int64_t sort_unique(int32_t* v, int64_t n) {
  if (n <= 24) {  // a mesh node's row: insertion sort beats std::sort's set-up
    for (int64_t i = 1; i < n; ++i) {
      const int32_t x = v[i];
      int64_t j = i;
      for (; j > 0 && v[j - 1] > x; --j) v[j] = v[j - 1];
      v[j] = x;
    }
  } else {
    std::sort(v, v + n);
  }
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (w == 0 || v[i] != v[w - 1]) v[w++] = v[i];
  }
  return w;
}

bool in_range(int64_t id, int64_t num_nodes) { return id >= 0 && id < num_nodes; }

}  // namespace

extern "C" {

// Triangles [F, 3] -> the distinct directed pairs of their sides, both
// directions, without self loops, in (sender, receiver) order. out_s and
// out_r hold 6 F entries each: out_r is the scratch of the per-sender
// buckets, compacted in place toward its front. Returns the number of
// pairs, or -3 if an id lies outside [0, num_nodes).
int64_t gn_face_to_edge(const int64_t* faces, int64_t nfaces, int64_t num_nodes,
                        int32_t* out_s, int32_t* out_r) {
  std::vector<int64_t> start(num_nodes + 1, 0);
  for (int64_t f = 0; f < 3 * nfaces; ++f) {
    if (!in_range(faces[f], num_nodes)) return -3;
  }
  // each side (a, b) of a face gives (a, b) and (b, a) unless a == b
  const int sides[3][2] = {{0, 1}, {1, 2}, {0, 2}};
  for (int64_t f = 0; f < nfaces; ++f) {
    const int64_t* t = faces + 3 * f;
    for (const auto& sd : sides) {
      const int64_t a = t[sd[0]], b = t[sd[1]];
      if (a == b) continue;
      ++start[a + 1];
      ++start[b + 1];
    }
  }
  for (int64_t u = 0; u < num_nodes; ++u) start[u + 1] += start[u];
  std::vector<int64_t> fill(start.begin(), start.end() - 1);
  for (int64_t f = 0; f < nfaces; ++f) {
    const int64_t* t = faces + 3 * f;
    for (const auto& sd : sides) {
      const int64_t a = t[sd[0]], b = t[sd[1]];
      if (a == b) continue;
      out_r[fill[a]++] = (int32_t)b;
      out_r[fill[b]++] = (int32_t)a;
    }
  }
  // the written front never passes the row being read: w <= start[u]
  int64_t w = 0;
  for (int64_t u = 0; u < num_nodes; ++u) {
    const int64_t lo = start[u];
    const int64_t n = sort_unique(out_r + lo, start[u + 1] - lo);
    std::memmove(out_r + w, out_r + lo, n * sizeof(int32_t));
    std::fill(out_s + w, out_s + w + n, (int32_t)u);
    w += n;
  }
  return w;
}

// Every pair (u, w), u != w, joined by a walk of at most k edges of the
// directed list, in (sender, receiver) order: a breadth-first search from
// each source over a CSR built here, a stamp array marking the nodes a
// source has reached (no reset between sources), each source's receivers
// sorted before they are written. The result is allocated here with
// malloc into *out_s and *out_r (free both with gn_free). Returns the
// number of pairs, -3 if an id lies outside [0, num_nodes), -4 if an
// allocation failed.
int64_t gn_k_hop(const int64_t* senders, const int64_t* receivers, int64_t num_edges,
                 int64_t num_nodes, int64_t k, int32_t** out_s, int32_t** out_r) {
  *out_s = nullptr;
  *out_r = nullptr;
  std::vector<int64_t> row(num_nodes + 1, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (!in_range(senders[e], num_nodes) || !in_range(receivers[e], num_nodes)) return -3;
    ++row[senders[e] + 1];
  }
  for (int64_t u = 0; u < num_nodes; ++u) row[u + 1] += row[u];
  std::vector<int32_t> adj(num_edges);
  {
    std::vector<int64_t> fill(row.begin(), row.end() - 1);
    for (int64_t e = 0; e < num_edges; ++e) adj[fill[senders[e]]++] = (int32_t)receivers[e];
  }
  std::vector<int32_t> stamp(num_nodes, -1);
  std::vector<int64_t> counts(num_nodes, 0);
  std::vector<int32_t> reached;  // every source's receivers, source after source
  std::vector<int32_t> frontier, next;
  for (int64_t u = 0; u < num_nodes; ++u) {
    const int64_t first = (int64_t)reached.size();
    stamp[u] = (int32_t)u;
    frontier.assign(1, (int32_t)u);
    for (int64_t hop = 0; hop < k && !frontier.empty(); ++hop) {
      next.clear();
      for (const int32_t v : frontier) {
        for (int64_t t = row[v]; t < row[v + 1]; ++t) {
          const int32_t w = adj[t];
          if (stamp[w] == (int32_t)u) continue;
          stamp[w] = (int32_t)u;
          next.push_back(w);
        }
      }
      reached.insert(reached.end(), next.begin(), next.end());
      frontier.swap(next);
    }
    std::sort(reached.begin() + first, reached.end());
    counts[u] = (int64_t)reached.size() - first;
  }
  const int64_t total = (int64_t)reached.size();
  const size_t bytes = (size_t)std::max<int64_t>(total, 1) * sizeof(int32_t);
  int32_t* s = (int32_t*)std::malloc(bytes);
  int32_t* r = (int32_t*)std::malloc(bytes);
  if (s == nullptr || r == nullptr) {
    std::free(s);
    std::free(r);
    return -4;
  }
  std::memcpy(r, reached.data(), (size_t)total * sizeof(int32_t));
  int64_t w = 0;
  for (int64_t u = 0; u < num_nodes; ++u) {
    std::fill(s + w, s + w + counts[u], (int32_t)u);
    w += counts[u];
  }
  *out_s = s;
  *out_r = r;
  return total;
}

void gn_free(void* p) { std::free(p); }

// The ELL grouping of a symmetric edge list: each receiver (the owner) gets
// `degree` slots, filled with its edges in input order (a stable grouping);
// padding slots point at their owner, are masked out, take edge 0 and are
// their own twin. The twin of a real slot (owner r, sender s) is the first
// slot of s's row whose sender is r: it is looked for in that row, at most
// `degree` slots, not in a table of every edge. Outputs hold
// num_nodes * degree entries. Returns 0; -1 if a node's in-degree exceeds
// `degree` (*detail = the largest in-degree); -2 if some edges have no
// reversed twin (*detail = how many); -3 if an id lies outside
// [0, num_nodes).
int64_t gn_build_ell(const int64_t* senders, const int64_t* receivers, int64_t num_edges,
                     int64_t num_nodes, int64_t degree, int32_t* senders_ell, uint8_t* mask,
                     int32_t* edge_perm, int32_t* twin_perm, int64_t* detail) {
  std::vector<int64_t> count(num_nodes, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (!in_range(senders[e], num_nodes) || !in_range(receivers[e], num_nodes)) return -3;
    ++count[receivers[e]];
  }
  const int64_t dmax = num_nodes ? *std::max_element(count.begin(), count.end()) : 0;
  if (dmax > degree) {
    *detail = dmax;
    return -1;
  }
  const int64_t slots = num_nodes * degree;
  for (int64_t i = 0; i < slots; ++i) {
    senders_ell[i] = (int32_t)(i / degree);
    mask[i] = 0;
    edge_perm[i] = 0;
    twin_perm[i] = (int32_t)i;
  }
  std::fill(count.begin(), count.end(), 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t r = receivers[e];
    const int64_t slot = r * degree + count[r]++;
    senders_ell[slot] = (int32_t)senders[e];
    mask[slot] = 1;
    edge_perm[slot] = (int32_t)e;
  }
  int64_t missing = 0;
  for (int64_t r = 0; r < num_nodes; ++r) {
    for (int64_t j = 0; j < count[r]; ++j) {
      const int64_t slot = r * degree + j;
      const int64_t s = senders_ell[slot];
      const int32_t* other = senders_ell + s * degree;
      int64_t t = 0;
      while (t < count[s] && other[t] != (int32_t)r) ++t;
      if (t == count[s]) {
        ++missing;
      } else {
        twin_perm[slot] = (int32_t)(s * degree + t);
      }
    }
  }
  if (missing) {
    *detail = missing;
    return -2;
  }
  return 0;
}

}  // extern "C"
