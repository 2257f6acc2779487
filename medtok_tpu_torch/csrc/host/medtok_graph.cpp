// medtok_graph.cpp — native graph runtime of the MedTok host data path
// (medtok_tpu_torch's own copy of csrc/medtok_graph.cpp, built with g++ by
// medtok_tpu_torch/data/host_build.py).
//
// Replaces the reference's per-item PyG subgraph() + EdgeDropout + PyG Batch
// collation (dataset_creator.py:250-276, 302-304 — the CPU hot spot feeding
// the accelerator, SURVEY.md section 3.1): CSR adjacency over PrimeKG,
// induced-subgraph extraction with relabeling, deterministic edge dropout
// (xoshiro256**), and direct packing into the static-shape CodeBatch layout
// (padded [B, Ln] node blocks + per-graph-chunked local edge arrays).
//
// C ABI for ctypes; no Python dependencies.

#include <algorithm>
#include <type_traits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Graph {
  int64_t num_nodes = 0;
  std::vector<int64_t> indptr;   // [num_nodes + 1] into order
  std::vector<int64_t> dst;      // [E] edge dst, CSR-ordered by src
  std::vector<int32_t> rel;      // [E] relation id, CSR-ordered
};

// xoshiro256** — deterministic, seedable, fast.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    for (int i = 0; i < 4; i++) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

// Worker count for a batch-parallel loop. MEDTOK_PACK_THREADS overrides the
// hardware-concurrency default (tests force the threaded path on 1-core
// hosts; deployments can cap it); one thread below min_chunk items.
inline int64_t pack_thread_count(int64_t items, int64_t min_chunk) {
  int64_t hw = 0;
  if (const char* env = std::getenv("MEDTOK_PACK_THREADS")) hw = std::atoll(env);
  if (hw <= 0) hw = std::thread::hardware_concurrency();
  return std::min<int64_t>(hw ? hw : 1,
                           std::max<int64_t>(items / min_chunk, 1));
}

// Split [0, items) across threads running fn(b0, b1, &truncated_out);
// returns the summed per-range truncation counts. The single shared body for
// every packer's thread spawn/join/sum scaffolding.
template <class Fn>
int64_t run_truncating_ranges(int64_t items, int64_t min_chunk, Fn&& fn) {
  int64_t nt = pack_thread_count(items, min_chunk);
  if (nt <= 1) {
    int64_t truncated = 0;
    fn(0, items, &truncated);
    return truncated;
  }
  std::vector<int64_t> trunc(nt, 0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int64_t t = 0; t < nt; t++) {
    threads.emplace_back(fn, items * t / nt, items * (t + 1) / nt, &trunc[t]);
  }
  int64_t truncated = 0;
  for (int64_t t = 0; t < nt; t++) {
    threads[t].join();
    truncated += trunc[t];
  }
  return truncated;
}

}  // namespace

extern "C" {

// Build a CSR graph from an edge list. Returns an opaque handle.
void* medtok_graph_build(const int64_t* src, const int64_t* dst,
                         const int32_t* rel, int64_t num_edges,
                         int64_t num_nodes) {
  auto* g = new Graph();
  g->num_nodes = num_nodes;
  g->indptr.assign(num_nodes + 1, 0);
  for (int64_t e = 0; e < num_edges; e++) g->indptr[src[e] + 1]++;
  for (int64_t n = 0; n < num_nodes; n++) g->indptr[n + 1] += g->indptr[n];
  g->dst.resize(num_edges);
  g->rel.resize(num_edges);
  std::vector<int64_t> cursor(g->indptr.begin(), g->indptr.end() - 1);
  for (int64_t e = 0; e < num_edges; e++) {
    int64_t pos = cursor[src[e]]++;
    g->dst[pos] = dst[e];
    g->rel[pos] = rel[e];
  }
  return g;
}

void medtok_graph_free(void* handle) { delete static_cast<Graph*>(handle); }

// Induced subgraph of `nodes` (must be sorted ascending, PyG semantics after
// the reference's nodes_l.sort()). Writes up to max_out local-index edges;
// returns the TOTAL number of induced edges (callers detect truncation).
int64_t medtok_graph_subgraph(const void* handle, const int64_t* nodes,
                              int64_t n_nodes, int32_t* out_src,
                              int32_t* out_dst, int32_t* out_rel,
                              int64_t max_out) {
  const auto* g = static_cast<const Graph*>(handle);
  int64_t count = 0;
  for (int64_t i = 0; i < n_nodes; i++) {
    int64_t u = nodes[i];
    if (u < 0 || u >= g->num_nodes) continue;
    for (int64_t p = g->indptr[u]; p < g->indptr[u + 1]; p++) {
      int64_t v = g->dst[p];
      const int64_t* it = std::lower_bound(nodes, nodes + n_nodes, v);
      if (it != nodes + n_nodes && *it == v) {
        if (count < max_out) {
          out_src[count] = static_cast<int32_t>(i);
          out_dst[count] = static_cast<int32_t>(it - nodes);
          out_rel[count] = g->rel[p];
        }
        count++;
      }
    }
  }
  return count;
}

// Pack B samples into the CodeBatch graph layout in one call.
//
// Inputs: concatenated sorted node lists (node_data, offsets node_off[B+1]).
// Outputs (pre-allocated by caller):
//   node_ids  [B * ln]  int32, zero-padded
//   node_mask [B * ln]  uint8
//   edge_src/edge_dst [B * epg] int32 local indices, per-graph chunks
//   edge_weight       [B * epg] float
//   edge_*_aug        same, with edge dropout applied when p > 0. When the
//   aug pointers ALIAS the main pointers (edge_src_aug == edge_src) the aug
//   pass is skipped entirely — the eval/export path needs no augmented copy
//   and saves both the memory traffic and the allocation.
// Returns number of samples whose edges were truncated to epg.
//
// Membership testing uses a per-thread stamp array over the global node id
// space (O(1) per neighbor) instead of per-edge binary search — at the
// heavy-tail bench shape (B=512 graphs x 512 nodes, ~31 CSR neighbors each)
// the binary-searched version measured 264 ms/call on one core; stamps plus
// tail-only zeroing measure 40 ms (6.6x). Graphs write disjoint output
// chunks, so the batch parallelizes across hardware threads (one stamp
// array each).
}  // extern "C"

namespace {

struct Stamp {
  std::vector<int64_t> mark;    // last graph index that touched this node
  std::vector<int32_t> local;   // node's local index within that graph
  void ensure(int64_t n) {
    if (static_cast<int64_t>(mark.size()) < n) {
      mark.assign(n, -1);
      local.assign(n, 0);
    }
  }
};

// Induced edges of graph b via the stamp array; same edge order as
// medtok_graph_subgraph (source nodes in list order, CSR neighbor order;
// duplicate node-list entries map to their FIRST occurrence, matching
// lower_bound).
template <class NodeT>
int64_t subgraph_stamped(const Graph* g, const NodeT* nodes, int64_t n,
                         int64_t b, Stamp& st, int32_t* out_src,
                         int32_t* out_dst, int64_t max_out) {
  for (int64_t i = 0; i < n; i++) {
    int64_t u = nodes[i];
    if (u < 0 || u >= g->num_nodes) continue;
    if (st.mark[u] != b) {
      st.mark[u] = b;
      st.local[u] = static_cast<int32_t>(i);
    }
  }
  int64_t count = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t u = nodes[i];
    if (u < 0 || u >= g->num_nodes) continue;
    for (int64_t p = g->indptr[u]; p < g->indptr[u + 1]; p++) {
      int64_t v = g->dst[p];
      if (st.mark[v] == b) {
        if (count < max_out) {
          out_src[count] = static_cast<int32_t>(i);
          out_dst[count] = st.local[v];
        }
        count++;
      }
    }
  }
  return count;
}

}  // namespace

extern "C" {

// Classic pack: the CodeBatch graph arrays, real entries at the front of
// each graph's slots, and each graph's real edge count (ne_out; ne_aug_out
// after the dropout, written only when the aug arrays do not alias the
// clean ones). Returns the number of edge-truncated graphs.
int64_t medtok_graph_pack_batch(
    const void* handle, const int64_t* node_data, const int64_t* node_off,
    int64_t batch, int64_t ln, int64_t epg, double dropout_p, uint64_t seed,
    int32_t* node_ids, uint8_t* node_mask, int32_t* edge_src,
    int32_t* edge_dst, float* edge_weight, int32_t* edge_src_aug,
    int32_t* edge_dst_aug, float* edge_weight_aug, int32_t* ne_out,
    int32_t* ne_aug_out) {
  const auto* g = static_cast<const Graph*>(handle);
  const bool want_aug = edge_src_aug != edge_src;

  auto pack_range = [&](int64_t b0, int64_t b1, int64_t* out_truncated) {
    Stamp st;
    st.ensure(g->num_nodes);
    std::vector<int32_t> s(epg), d(epg);
    int64_t truncated = 0;
    for (int64_t b = b0; b < b1; b++) {
      const int64_t* nodes = node_data + node_off[b];
      int64_t n = node_off[b + 1] - node_off[b];
      int64_t n_keep = std::min(n, ln);
      for (int64_t i = 0; i < n_keep; i++) {
        node_ids[b * ln + i] = static_cast<int32_t>(nodes[i]);
        node_mask[b * ln + i] = 1;
      }
      for (int64_t i = n_keep; i < ln; i++) {
        node_ids[b * ln + i] = 0;
        node_mask[b * ln + i] = 0;
      }
      int64_t total = subgraph_stamped(g, nodes, n_keep, b, st, s.data(),
                                       d.data(), epg);
      int64_t ne = std::min(total, epg);
      if (total > epg) truncated++;
      int64_t o = b * epg;
      for (int64_t e = 0; e < ne; e++) {
        edge_src[o + e] = s[e];
        edge_dst[o + e] = d[e];
        edge_weight[o + e] = 1.0f;
      }
      // zero only the padding tail (the old full-batch memsets moved
      // ~100 MB per call at the 512x8192 tail shape)
      std::memset(edge_src + o + ne, 0, sizeof(int32_t) * (epg - ne));
      std::memset(edge_dst + o + ne, 0, sizeof(int32_t) * (epg - ne));
      std::memset(edge_weight + o + ne, 0, sizeof(float) * (epg - ne));
      ne_out[b] = static_cast<int32_t>(ne);
      if (want_aug) {
        Rng rng(seed * 0x9E3779B97f4A7C15ULL + static_cast<uint64_t>(b));
        int64_t na = 0;
        for (int64_t e = 0; e < ne; e++) {
          bool keep = dropout_p <= 0.0 || rng.uniform() > dropout_p;
          if (keep) {
            edge_src_aug[o + na] = s[e];
            edge_dst_aug[o + na] = d[e];
            edge_weight_aug[o + na] = 1.0f;
            na++;
          }
        }
        std::memset(edge_src_aug + o + na, 0, sizeof(int32_t) * (epg - na));
        std::memset(edge_dst_aug + o + na, 0, sizeof(int32_t) * (epg - na));
        std::memset(edge_weight_aug + o + na, 0, sizeof(float) * (epg - na));
        ne_aug_out[b] = static_cast<int32_t>(na);
      }
    }
    *out_truncated = truncated;
  };

  return run_truncating_ranges(batch, 64, pack_range);
}

}  // extern "C"

// Compact pack: same extraction as medtok_graph_pack_batch, but edges are
// emitted as ONE int32 per edge — (src << 16) | dst (requires ln <= 32768 so
// the sign bit stays clear) — plus per-graph edge counts ne[B] instead of a
// float weight array (edges are front-packed; consumers rebuild the padding
// mask as iota < ne on device). Relative to the classic layout this is 3x
// less output memory traffic and 3x fewer bytes to ship host->device, which
// is what the heavy-tail export step is bound by (B=512 x epg=8192 classic
// edge arrays are ~100 MB with the augmented copies; compact is 16.8 MB).
// When the aug pointers ALIAS the main pointers the aug pass is skipped
// (eval/export path). Returns the number of edge-truncated samples, or -1
// if ln > 32768.
namespace {

// Shared body for the compact packers: NodesOf(b) -> (ptr, len). EdgeT /
// Shift select the packed-edge encoding: int32 with (src << 16) | dst for
// ln <= 32768, or uint16 with (src << 8) | dst for ln <= 256 — the local
// indices fit 8 bits there, and halving edge bytes halves what the export
// sweep ships over slow h2d links.
template <class NodeT, class EdgeT, int Shift, class NodesOf>
int64_t pack_compact_impl(
    const Graph* g, NodesOf nodes_of, int64_t batch, int64_t ln, int64_t epg,
    double dropout_p, uint64_t seed, int32_t* node_ids, uint8_t* node_mask,
    EdgeT* edge_packed, int32_t* ne, EdgeT* edge_packed_aug,
    int32_t* ne_aug) {
  // signed EdgeT must keep the sign bit clear: src < 2^(Shift-1)
  constexpr int64_t kMaxLn =
      std::is_signed<EdgeT>::value ? (int64_t{1} << (Shift - 1))
                                   : (int64_t{1} << Shift);
  if (ln > kMaxLn) return -1;
  const bool want_aug = edge_packed_aug != edge_packed;

  auto pack_range = [&](int64_t b0, int64_t b1, int64_t* out_truncated) {
    Stamp st;
    st.ensure(g->num_nodes);
    std::vector<int32_t> s(epg), d(epg);
    int64_t truncated = 0;
    for (int64_t b = b0; b < b1; b++) {
      const NodeT* nodes;
      int64_t n;
      nodes_of(b, &nodes, &n);
      int64_t n_keep = std::min(n, ln);
      for (int64_t i = 0; i < n_keep; i++) {
        node_ids[b * ln + i] = static_cast<int32_t>(nodes[i]);
        node_mask[b * ln + i] = 1;
      }
      for (int64_t i = n_keep; i < ln; i++) {
        node_ids[b * ln + i] = 0;
        node_mask[b * ln + i] = 0;
      }
      int64_t total = subgraph_stamped(g, nodes, n_keep, b, st, s.data(),
                                       d.data(), epg);
      int64_t nedge = std::min(total, epg);
      if (total > epg) truncated++;
      int64_t o = b * epg;
      for (int64_t e = 0; e < nedge; e++)
        edge_packed[o + e] = static_cast<EdgeT>((s[e] << Shift) | d[e]);
      std::memset(edge_packed + o + nedge, 0,
                  sizeof(EdgeT) * (epg - nedge));
      ne[b] = static_cast<int32_t>(nedge);
      if (want_aug) {
        Rng rng(seed * 0x9E3779B97f4A7C15ULL + static_cast<uint64_t>(b));
        int64_t na = 0;
        for (int64_t e = 0; e < nedge; e++) {
          bool keep = dropout_p <= 0.0 || rng.uniform() > dropout_p;
          if (keep)
            edge_packed_aug[o + na++] =
                static_cast<EdgeT>((s[e] << Shift) | d[e]);
        }
        std::memset(edge_packed_aug + o + na, 0,
                    sizeof(EdgeT) * (epg - na));
        ne_aug[b] = static_cast<int32_t>(na);
      }
    }
    *out_truncated = truncated;
  };

  return run_truncating_ranges(batch, 64, pack_range);
}

}  // namespace

extern "C" {

int64_t medtok_graph_pack_compact(
    const void* handle, const int64_t* node_data, const int64_t* node_off,
    int64_t batch, int64_t ln, int64_t epg, double dropout_p, uint64_t seed,
    int32_t* node_ids, uint8_t* node_mask, int32_t* edge_packed, int32_t* ne,
    int32_t* edge_packed_aug, int32_t* ne_aug) {
  const auto* g = static_cast<const Graph*>(handle);
  auto nodes_of = [&](int64_t b, const int64_t** nodes, int64_t* n) {
    *nodes = node_data + node_off[b];
    *n = node_off[b + 1] - node_off[b];
  };
  return pack_compact_impl<int64_t, int32_t, 16>(
      g, nodes_of, batch, ln, epg, dropout_p, seed, node_ids, node_mask,
      edge_packed, ne, edge_packed_aug, ne_aug);
}

// Per-code induced-edge counts over [lo, hi) of the int32 node arena (no
// edge output) — lets the export sweep sub-bucket codes by edge count so
// padded edge buffers ship ~2x fewer bytes over slow h2d links. Node lists
// are truncated to ln first (matching what a pack at that ln would emit).
void medtok_graph_count_edges(const void* handle, const int32_t* all_data,
                              const int64_t* all_off, int64_t lo, int64_t hi,
                              int64_t ln, int32_t* out_counts) {
  const auto* g = static_cast<const Graph*>(handle);
  int64_t n_rows = hi - lo;
  auto count_range = [&](int64_t r0, int64_t r1, int64_t* /*unused*/) {
    Stamp st;
    st.ensure(g->num_nodes);
    for (int64_t r = r0; r < r1; r++) {
      int64_t i = lo + r;
      const int32_t* nodes = all_data + all_off[i];
      int64_t n = std::min(all_off[i + 1] - all_off[i], ln);
      // stamp membership, then count CSR neighbors that are members
      for (int64_t j = 0; j < n; j++) {
        int64_t u = nodes[j];
        if (u >= 0 && u < g->num_nodes) st.mark[u] = i;
      }
      int64_t c = 0;
      for (int64_t j = 0; j < n; j++) {
        int64_t u = nodes[j];
        if (u < 0 || u >= g->num_nodes) continue;
        for (int64_t p = g->indptr[u]; p < g->indptr[u + 1]; p++) {
          if (st.mark[g->dst[p]] == i) c++;
        }
      }
      out_counts[r] = static_cast<int32_t>(c);
    }
  };
  run_truncating_ranges(n_rows, 1024, count_range);
}

// Indexed variant: node lists come from a PRE-CONCATENATED int32 arena
// (all_data, all_off over the whole vocabulary, built once by warm_cache —
// int32 halves the arena's first-touch page cost)
// selected by idxs[batch] - removes the per-batch python list build +
// concatenate from the hot path entirely.
int64_t medtok_graph_pack_compact_idx(
    const void* handle, const int32_t* all_data, const int64_t* all_off,
    const int64_t* idxs, int64_t batch, int64_t ln, int64_t epg,
    double dropout_p, uint64_t seed, int32_t* node_ids, uint8_t* node_mask,
    int32_t* edge_packed, int32_t* ne, int32_t* edge_packed_aug,
    int32_t* ne_aug) {
  const auto* g = static_cast<const Graph*>(handle);
  auto nodes_of = [&](int64_t b, const int32_t** nodes, int64_t* n) {
    int64_t i = idxs[b];
    *nodes = all_data + all_off[i];
    *n = all_off[i + 1] - all_off[i];
  };
  return pack_compact_impl<int32_t, int32_t, 16>(
      g, nodes_of, batch, ln, epg, dropout_p, seed, node_ids, node_mask,
      edge_packed, ne, edge_packed_aug, ne_aug);
}

// STREAM edge encoding for big node buckets: dst-only uint16 stream plus a
// per-node out-degree vector. The packer emits edges grouped by source node
// (list order), so the src column is fully redundant given outdeg — the
// consumer rebuilds src on device as searchsorted(cumsum(outdeg), e). At
// 2 bytes/edge (+2 bytes/node) this halves what the heavy-tail export step
// ships vs (src << 16) | dst int32 pairs; on this environment every shipped
// byte also becomes retained host RSS in the transfer proxy, so bytes are
// doubly expensive. Requires ln <= 65536 and epg <= 65535 (uint16 ranges).
// Returns truncation count, or -1 on range violation.
int64_t medtok_graph_pack_stream_idx(
    const void* handle, const int32_t* all_data, const int64_t* all_off,
    const int64_t* idxs, int64_t batch, int64_t ln, int64_t epg,
    double dropout_p, uint64_t seed, int32_t* node_ids, uint8_t* node_mask,
    uint16_t* outdeg, uint16_t* dst_stream, int32_t* ne,
    uint16_t* outdeg_aug, uint16_t* dst_stream_aug, int32_t* ne_aug) {
  if (ln > 65536 || epg > 65535) return -1;
  const auto* g = static_cast<const Graph*>(handle);
  const bool want_aug = dst_stream_aug != dst_stream;

  auto pack_range = [&](int64_t b0, int64_t b1, int64_t* out_truncated) {
    Stamp st;
    st.ensure(g->num_nodes);
    std::vector<int32_t> s(epg), d(epg);
    int64_t truncated = 0;
    for (int64_t b = b0; b < b1; b++) {
      int64_t row = idxs[b];
      const int32_t* nodes = all_data + all_off[row];
      int64_t n = all_off[row + 1] - all_off[row];
      int64_t n_keep = std::min(n, ln);
      for (int64_t i = 0; i < n_keep; i++) {
        node_ids[b * ln + i] = nodes[i];
        node_mask[b * ln + i] = 1;
      }
      for (int64_t i = n_keep; i < ln; i++) {
        node_ids[b * ln + i] = 0;
        node_mask[b * ln + i] = 0;
      }
      int64_t total = subgraph_stamped(g, nodes, n_keep, b, st, s.data(),
                                       d.data(), epg);
      int64_t nedge = std::min(total, epg);
      if (total > epg) truncated++;
      std::memset(outdeg + b * ln, 0, sizeof(uint16_t) * ln);
      for (int64_t e = 0; e < nedge; e++) {
        outdeg[b * ln + s[e]]++;  // s is non-decreasing (src-grouped)
        dst_stream[b * epg + e] = static_cast<uint16_t>(d[e]);
      }
      std::memset(dst_stream + b * epg + nedge, 0,
                  sizeof(uint16_t) * (epg - nedge));
      ne[b] = static_cast<int32_t>(nedge);
      if (want_aug) {
        Rng rng(seed * 0x9E3779B97f4A7C15ULL + static_cast<uint64_t>(b));
        std::memset(outdeg_aug + b * ln, 0, sizeof(uint16_t) * ln);
        int64_t na = 0;
        for (int64_t e = 0; e < nedge; e++) {
          bool keep = dropout_p <= 0.0 || rng.uniform() > dropout_p;
          if (keep) {
            outdeg_aug[b * ln + s[e]]++;
            dst_stream_aug[b * epg + na++] = static_cast<uint16_t>(d[e]);
          }
        }
        std::memset(dst_stream_aug + b * epg + na, 0,
                    sizeof(uint16_t) * (epg - na));
        ne_aug[b] = static_cast<int32_t>(na);
      }
    }
    *out_truncated = truncated;
  };

  return run_truncating_ranges(batch, 64, pack_range);
}

// uint16 edge encoding — (src << 8) | dst, requires ln <= 256. Halves the
// edge bytes of the small/mid node buckets (the bulk of the vocabulary).
int64_t medtok_graph_pack_compact16(
    const void* handle, const int64_t* node_data, const int64_t* node_off,
    int64_t batch, int64_t ln, int64_t epg, double dropout_p, uint64_t seed,
    int32_t* node_ids, uint8_t* node_mask, uint16_t* edge_packed, int32_t* ne,
    uint16_t* edge_packed_aug, int32_t* ne_aug) {
  const auto* g = static_cast<const Graph*>(handle);
  auto nodes_of = [&](int64_t b, const int64_t** nodes, int64_t* n) {
    *nodes = node_data + node_off[b];
    *n = node_off[b + 1] - node_off[b];
  };
  return pack_compact_impl<int64_t, uint16_t, 8>(
      g, nodes_of, batch, ln, epg, dropout_p, seed, node_ids, node_mask,
      edge_packed, ne, edge_packed_aug, ne_aug);
}

int64_t medtok_graph_pack_compact_idx16(
    const void* handle, const int32_t* all_data, const int64_t* all_off,
    const int64_t* idxs, int64_t batch, int64_t ln, int64_t epg,
    double dropout_p, uint64_t seed, int32_t* node_ids, uint8_t* node_mask,
    uint16_t* edge_packed, int32_t* ne, uint16_t* edge_packed_aug,
    int32_t* ne_aug) {
  const auto* g = static_cast<const Graph*>(handle);
  auto nodes_of = [&](int64_t b, const int32_t** nodes, int64_t* n) {
    int64_t i = idxs[b];
    *nodes = all_data + all_off[i];
    *n = all_off[i + 1] - all_off[i];
  };
  return pack_compact_impl<int32_t, uint16_t, 8>(
      g, nodes_of, batch, ln, epg, dropout_p, seed, node_ids, node_mask,
      edge_packed, ne, edge_packed_aug, ne_aug);
}

}  // extern "C"
