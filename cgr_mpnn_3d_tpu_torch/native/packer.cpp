// Native block-dense graph packer, C++17, C ABI.
//
// Bit-identical port of data/batch.py::pack_graphs (first-fit placement,
// gather-only ELL adjacency, sentinel conventions — see that module's
// docstring for the format).  At ~13 Medge/s device throughput the Python
// packer becomes the host bottleneck in real training; this native path
// packs a 64-graph batch in tens of microseconds.
//
// Two entry points:
//   cgr_pack_graphs — one window (the PackedLoader per-step path);
//     concatenated input arrays, unchanged ABI.
//   cgr_pack_epoch  — a WHOLE epoch in one call (the --reuse_packs cache
//     build).  Takes PER-GRAPH POINTER TABLES instead of concatenated
//     arrays, so the host never materializes an epoch-sized feature
//     concatenation (numpy concatenate of thousands of small arrays was
//     the dominant cost of the first mega-call draft); graph features are
//     memcpy'd from their featurizer-cache buffers straight into the
//     packed output.  Replicates data/loader.py::_iter_pack's SERIAL
//     semantics exactly (in-window stable sort by descending edge count,
//     overflow shrink n -> int(n*0.8), carry of unconsumed rows into the
//     next window), probing feasibility with a placement-only dry pass so
//     the expensive init+write runs once per emitted window — at bs-64
//     with te=128 tiles the shrink path is the NORM (a 64-graph window
//     holds ~2.5x the slots) and doomed-attempt write churn dominated
//     before.  Cache output is bit-identical to per-window iteration
//     (tests/test_torch_native.py).
//
// Returns 0 on success, -1 on error (message via cgr_last_error(), shared
// with featurizer.cpp); cgr_pack_epoch returns -2 when max_windows is too
// small (caller grows and retries).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

// error reporting shared with featurizer.cpp
extern "C" const char* cgr_last_error();
extern "C" void cgr_set_error(const char* msg);

namespace {

struct Spec {
  int32_t p, te, tn, tb, d, dn;
  int64_t ET() const { return static_cast<int64_t>(p) * te; }
  int64_t NT() const { return static_cast<int64_t>(p) * tn; }
  int64_t BT() const { return static_cast<int64_t>(p) * tb; }
};

// Per-graph input accessors: pointer tables indexed by graph id.  The
// node feature row of a graph is base_feats[gi] (base_dim floats) with an
// optional extra_feats[gi] block (extra_dim floats) appended per node —
// the MACE-descriptor fusion, done during the copy instead of ahead of it.
struct Graphs {
  const uint64_t* node_feats;   // const float* per graph [nn, base_dim]
  const uint64_t* extra_feats;  // const float* per graph [nn, extra_dim]
  int32_t base_dim;
  int32_t extra_dim;            // 0 = no extra block
  const uint64_t* edge_feats;   // const float* per graph [ne, e_feat]
  const uint64_t* senders;      // const int32_t* per graph [ne]
  const uint64_t* receivers;    // const int32_t* per graph [ne]
  const int32_t* node_counts;
  const int32_t* edge_counts;
  const float* labels;
  const int32_t* row_ids;

  int32_t n_feat() const { return base_dim + extra_dim; }
  const float* nf(int32_t gi) const {
    return reinterpret_cast<const float*>(node_feats[gi]);
  }
  const float* xf(int32_t gi) const {
    return reinterpret_cast<const float*>(extra_feats[gi]);
  }
  const float* ef(int32_t gi) const {
    return reinterpret_cast<const float*>(edge_feats[gi]);
  }
  const int32_t* send(int32_t gi) const {
    return reinterpret_cast<const int32_t*>(senders[gi]);
  }
  const int32_t* recv(int32_t gi) const {
    return reinterpret_cast<const int32_t*>(receivers[gi]);
  }
};

struct Outputs {
  float* node_x;
  float* edge_attr;
  int32_t* senders;
  int32_t* receivers;
  int32_t* rev;
  int32_t* edge_nbr;
  int32_t* edge_nbr_rev;
  int32_t* node_inc;
  int32_t* node_out;
  int32_t* graph_of_node;
  int32_t* graph_nodes;
  float* labels_out;
  float* graph_mask;
  int32_t* row_ids_out;
};

void init_outputs(const Spec& s, int32_t n_feat, int32_t e_feat,
                  const Outputs& o) {
  const int64_t ET = s.ET(), NT = s.NT(), BT = s.BT();
  std::memset(o.node_x, 0, sizeof(float) * NT * n_feat);
  std::memset(o.edge_attr, 0, sizeof(float) * ET * e_feat);
  for (int64_t i = 0; i < ET; ++i) {
    o.senders[i] = static_cast<int32_t>(NT);
    o.receivers[i] = static_cast<int32_t>(NT);
    o.rev[i] = static_cast<int32_t>(ET);
  }
  for (int64_t i = 0; i < ET * s.d; ++i) {
    o.edge_nbr[i] = static_cast<int32_t>(ET);
    o.edge_nbr_rev[i] = static_cast<int32_t>(ET);
  }
  for (int64_t i = 0; i < NT * s.d; ++i) {
    o.node_inc[i] = static_cast<int32_t>(ET);
    o.node_out[i] = static_cast<int32_t>(ET);
  }
  for (int64_t i = 0; i < NT; ++i)
    o.graph_of_node[i] = static_cast<int32_t>(BT);
  for (int64_t i = 0; i < BT * s.dn; ++i)
    o.graph_nodes[i] = static_cast<int32_t>(NT);
  std::memset(o.labels_out, 0, sizeof(float) * BT);
  std::memset(o.graph_mask, 0, sizeof(float) * BT);
  for (int64_t i = 0; i < BT; ++i) o.row_ids_out[i] = -1;
}

// Best-fit pack choice: tightest post-placement edge slack, ties by node
// slack then lowest index (mirrors data/batch.py's np.argmin first-min).
inline int32_t best_fit(const Spec& s, const int32_t* e_fill,
                        const int32_t* n_fill, const int32_t* g_fill,
                        int32_t ne, int32_t nn) {
  int32_t pk = -1;
  int64_t best = std::numeric_limits<int64_t>::max();
  for (int32_t q = 0; q < s.p; ++q) {
    if (e_fill[q] + ne <= s.te && n_fill[q] + nn <= s.tn &&
        g_fill[q] + 1 <= s.tb) {
      const int64_t key =
          static_cast<int64_t>(s.te - e_fill[q] - ne) * (s.tn + 1) +
          (s.tn - n_fill[q] - nn);
      if (key < best) {
        best = key;
        pk = q;
      }
    }
  }
  return pk;
}

// Placement-only dry run of pack_window: same feasibility checks, same
// best-fit sequence, NO output writes.
int place_window(const Spec& s, const Graphs& g, const int32_t* idx,
                 int32_t n) {
  std::vector<int32_t> e_fill(s.p, 0), n_fill(s.p, 0), g_fill(s.p, 0);
  std::vector<int32_t> inc_fill;
  for (int32_t k = 0; k < n; ++k) {
    const int32_t gi = idx[k];
    const int32_t nn = g.node_counts[gi];
    const int32_t ne = g.edge_counts[gi];
    if (ne > s.te || nn > s.tn) {
      cgr_set_error("graph exceeds pack tile; increase te/tn");
      return -1;
    }
    if (nn > s.dn) {
      cgr_set_error("graph has more nodes than dn");
      return -1;
    }
    const int32_t pk = best_fit(s, e_fill.data(), n_fill.data(),
                                g_fill.data(), ne, nn);
    if (pk < 0) {
      cgr_set_error("graphs do not fit into the configured packs");
      return -1;
    }
    inc_fill.assign(nn, 0);
    const int32_t* g_recv = g.recv(gi);
    for (int32_t e = 0; e < ne; ++e) {
      if (inc_fill[g_recv[e]]++ >= s.d) {
        cgr_set_error("node in-degree exceeds ELL width d");
        return -1;
      }
    }
    e_fill[pk] += ne;
    n_fill[pk] += nn;
    g_fill[pk] += 1;
  }
  return 0;
}

// Pack the graphs `idx[0..n)` into freshly initialized outputs.
// Returns 0, or -1 with the error set.
int pack_window_ef(const Spec& s, const Graphs& g, int32_t e_feat,
                   const int32_t* idx, int32_t n, const Outputs& o) {
  const int32_t n_feat = g.n_feat();
  init_outputs(s, n_feat, e_feat, o);
  std::vector<int32_t> e_fill(s.p, 0), n_fill(s.p, 0), g_fill(s.p, 0);
  std::vector<int32_t> inc_fill;  // per-graph scratch

  for (int32_t k = 0; k < n; ++k) {
    const int32_t gi = idx[k];
    const int32_t nn = g.node_counts[gi];
    const int32_t ne = g.edge_counts[gi];
    if (ne > s.te || nn > s.tn) {
      cgr_set_error("graph exceeds pack tile; increase te/tn");
      return -1;
    }
    if (nn > s.dn) {
      cgr_set_error("graph has more nodes than dn");
      return -1;
    }
    const int32_t pk = best_fit(s, e_fill.data(), n_fill.data(),
                                g_fill.data(), ne, nn);
    if (pk < 0) {
      cgr_set_error("graphs do not fit into the configured packs");
      return -1;
    }
    const int64_t n_off = static_cast<int64_t>(pk) * s.tn + n_fill[pk];
    const int64_t e_off = static_cast<int64_t>(pk) * s.te + e_fill[pk];
    const int64_t g_off = static_cast<int64_t>(pk) * s.tb + g_fill[pk];

    if (g.extra_dim == 0) {
      std::memcpy(o.node_x + n_off * n_feat, g.nf(gi),
                  sizeof(float) * nn * n_feat);
    } else {
      // fuse base + MACE-descriptor block per node row during the copy
      const float* base_src = g.nf(gi);
      const float* extra_src = g.xf(gi);
      for (int32_t v = 0; v < nn; ++v) {
        float* dst = o.node_x + (n_off + v) * n_feat;
        std::memcpy(dst, base_src + static_cast<int64_t>(v) * g.base_dim,
                    sizeof(float) * g.base_dim);
        std::memcpy(dst + g.base_dim,
                    extra_src + static_cast<int64_t>(v) * g.extra_dim,
                    sizeof(float) * g.extra_dim);
      }
    }
    std::memcpy(o.edge_attr + e_off * e_feat, g.ef(gi),
                sizeof(float) * ne * e_feat);

    const int32_t* g_send = g.send(gi);
    const int32_t* g_recv = g.recv(gi);
    for (int32_t e = 0; e < ne; ++e) {
      o.senders[e_off + e] = static_cast<int32_t>(n_off) + g_send[e];
      o.receivers[e_off + e] = static_cast<int32_t>(n_off) + g_recv[e];
      o.rev[e_off + e] = static_cast<int32_t>(e_off) + (e ^ 1);
    }

    // node_inc / node_out (ELL over receivers; rev(e) = e^1)
    inc_fill.assign(nn, 0);
    for (int32_t e = 0; e < ne; ++e) {
      const int32_t r = g_recv[e];
      const int32_t kf = inc_fill[r];
      if (kf >= s.d) {
        cgr_set_error("node in-degree exceeds ELL width d");
        return -1;
      }
      o.node_inc[(n_off + r) * s.d + kf] = static_cast<int32_t>(e_off) + e;
      o.node_out[(n_off + r) * s.d + kf] =
          static_cast<int32_t>(e_off) + (e ^ 1);
      inc_fill[r] = kf + 1;
    }
    // edge_nbr[e] = node_inc[sender(e)]; edge_nbr_rev[e] = node_out[recv(e)]
    for (int32_t e = 0; e < ne; ++e) {
      std::memcpy(o.edge_nbr + (e_off + e) * s.d,
                  o.node_inc + (n_off + g_send[e]) * s.d,
                  sizeof(int32_t) * s.d);
      std::memcpy(o.edge_nbr_rev + (e_off + e) * s.d,
                  o.node_out + (n_off + g_recv[e]) * s.d,
                  sizeof(int32_t) * s.d);
    }

    for (int32_t v = 0; v < nn; ++v) {
      o.graph_of_node[n_off + v] = static_cast<int32_t>(g_off);
      o.graph_nodes[g_off * s.dn + v] = static_cast<int32_t>(n_off) + v;
    }
    o.labels_out[g_off] = g.labels[gi];
    o.graph_mask[g_off] = 1.0f;
    o.row_ids_out[g_off] = g.row_ids[gi];

    e_fill[pk] += ne;
    n_fill[pk] += nn;
    g_fill[pk] += 1;
  }
  return 0;
}

Outputs window_slice(const Spec& s, int32_t n_feat, int32_t e_feat,
                     const Outputs& base, int64_t w) {
  const int64_t ET = s.ET(), NT = s.NT(), BT = s.BT();
  Outputs o;
  o.node_x = base.node_x + w * NT * n_feat;
  o.edge_attr = base.edge_attr + w * ET * e_feat;
  o.senders = base.senders + w * ET;
  o.receivers = base.receivers + w * ET;
  o.rev = base.rev + w * ET;
  o.edge_nbr = base.edge_nbr + w * ET * s.d;
  o.edge_nbr_rev = base.edge_nbr_rev + w * ET * s.d;
  o.node_inc = base.node_inc + w * NT * s.d;
  o.node_out = base.node_out + w * NT * s.d;
  o.graph_of_node = base.graph_of_node + w * NT;
  o.graph_nodes = base.graph_nodes + w * BT * s.dn;
  o.labels_out = base.labels_out + w * BT;
  o.graph_mask = base.graph_mask + w * BT;
  o.row_ids_out = base.row_ids_out + w * BT;
  return o;
}

}  // namespace

extern "C" int cgr_pack_graphs(
    // spec
    int32_t p, int32_t te, int32_t tn, int32_t tb, int32_t d, int32_t dn,
    // graphs (concatenated, local indices)
    int32_t n_graphs, const int32_t* node_counts, const int32_t* edge_counts,
    const float* node_feats, int32_t n_feat,
    const float* edge_feats, int32_t e_feat,
    const int32_t* senders_in, const int32_t* receivers_in,
    const float* labels_in, const int32_t* row_ids_in,
    // outputs (caller-allocated, pre-filled is NOT required)
    float* node_x, float* edge_attr,
    int32_t* senders, int32_t* receivers, int32_t* rev,
    int32_t* edge_nbr, int32_t* edge_nbr_rev,
    int32_t* node_inc, int32_t* node_out,
    int32_t* graph_of_node, int32_t* graph_nodes,
    float* labels_out, float* graph_mask, int32_t* row_ids_out) {
  const Spec s{p, te, tn, tb, d, dn};
  const Outputs o{node_x, edge_attr, senders, receivers, rev,
                  edge_nbr, edge_nbr_rev, node_inc, node_out,
                  graph_of_node, graph_nodes, labels_out, graph_mask,
                  row_ids_out};
  // build per-graph pointer tables over the concatenated inputs
  std::vector<int32_t> idx(n_graphs);
  std::vector<uint64_t> nfp(n_graphs), efp(n_graphs), sp(n_graphs),
      rp(n_graphs);
  int64_t nb = 0, eb = 0;
  for (int32_t i = 0; i < n_graphs; ++i) {
    idx[i] = i;
    nfp[i] = reinterpret_cast<uint64_t>(node_feats + nb * n_feat);
    efp[i] = reinterpret_cast<uint64_t>(edge_feats + eb * e_feat);
    sp[i] = reinterpret_cast<uint64_t>(senders_in + eb);
    rp[i] = reinterpret_cast<uint64_t>(receivers_in + eb);
    nb += node_counts[i];
    eb += edge_counts[i];
  }
  const Graphs g{nfp.data(), nullptr, n_feat, 0, efp.data(),
                 sp.data(),  rp.data(), node_counts, edge_counts,
                 labels_in,  row_ids_in};
  return pack_window_ef(s, g, e_feat, idx.data(), n_graphs, o);
}

// Placement-only feasibility probe for ONE window of concatenated
// graphs: the loader's overflow-shrink loop (data/loader._pack_window)
// calls this per attempt instead of paying a full pack (output
// allocation + init + writes) per doomed attempt, then packs exactly
// once at the surviving n.  Returns 0 feasible / -1 with the error set.
extern "C" int cgr_place_graphs(
    int32_t p, int32_t te, int32_t tn, int32_t tb, int32_t d, int32_t dn,
    int32_t n_graphs, const int32_t* node_counts, const int32_t* edge_counts,
    const int32_t* receivers_in) {
  const Spec s{p, te, tn, tb, d, dn};
  std::vector<int32_t> idx(n_graphs);
  std::vector<uint64_t> rp(n_graphs);
  int64_t eb = 0;
  for (int32_t i = 0; i < n_graphs; ++i) {
    idx[i] = i;
    rp[i] = reinterpret_cast<uint64_t>(receivers_in + eb);
    eb += edge_counts[i];
  }
  const Graphs g{nullptr,      nullptr, 0,         0,
                 nullptr,      nullptr, rp.data(), node_counts,
                 edge_counts,  nullptr, nullptr};
  return place_window(s, g, idx.data(), n_graphs);
}

// One call packs a whole epoch from per-graph pointer tables (epoch
// order); windows, in-window sorting, overflow shrink and carry replicate
// data/loader.py::_iter_pack serially.  Outputs are max_windows stacked
// PackedGraphBatch buffers; *n_windows_out reports how many were written.
extern "C" int cgr_pack_epoch(
    int32_t p, int32_t te, int32_t tn, int32_t tb, int32_t d, int32_t dn,
    int32_t n_rows, const int32_t* node_counts, const int32_t* edge_counts,
    const uint64_t* node_feat_ptrs, int32_t base_dim,
    const uint64_t* extra_feat_ptrs, int32_t extra_dim,
    const uint64_t* edge_feat_ptrs, int32_t e_feat,
    const uint64_t* sender_ptrs, const uint64_t* receiver_ptrs,
    const float* labels_in, const int32_t* row_ids_in,
    int32_t batch_size, int32_t sort_within, int32_t drop_last,
    int32_t max_windows,
    float* node_x, float* edge_attr,
    int32_t* senders, int32_t* receivers, int32_t* rev,
    int32_t* edge_nbr, int32_t* edge_nbr_rev,
    int32_t* node_inc, int32_t* node_out,
    int32_t* graph_of_node, int32_t* graph_nodes,
    float* labels_out, float* graph_mask, int32_t* row_ids_out,
    int32_t* n_windows_out) {
  const Spec s{p, te, tn, tb, d, dn};
  const Outputs base{node_x, edge_attr, senders, receivers, rev,
                     edge_nbr, edge_nbr_rev, node_inc, node_out,
                     graph_of_node, graph_nodes, labels_out, graph_mask,
                     row_ids_out};
  const Graphs g{node_feat_ptrs,
                 extra_dim > 0 ? extra_feat_ptrs : nullptr,
                 base_dim,
                 extra_dim > 0 ? extra_dim : 0,
                 edge_feat_ptrs,
                 sender_ptrs,
                 receiver_ptrs,
                 node_counts,
                 edge_counts,
                 labels_in,
                 row_ids_in};
  const int32_t n_feat = g.n_feat();

  std::vector<int32_t> pending, rows, window;
  int32_t pos = 0, w = 0;
  while (pos < n_rows || !pending.empty()) {
    const int32_t take = batch_size - static_cast<int32_t>(pending.size());
    rows = pending;
    const int32_t end = std::min(pos + take, n_rows);
    for (int32_t i = pos; i < end; ++i) rows.push_back(i);
    pos = end;
    if (drop_last && pos >= n_rows &&
        static_cast<int32_t>(rows.size()) < batch_size) {
      break;  // skip the final partial batch (loader drop_last semantics)
    }
    // _pack_window: try rows[:n], shrink n = max(1, int(n*0.8)) on
    // overflow.  Probe feasibility with the placement-only dry pass;
    // write the window exactly once, at the surviving n.
    int32_t n = static_cast<int32_t>(rows.size());
    if (w >= max_windows) return -2;  // caller grows and retries
    while (true) {
      window.assign(rows.begin(), rows.begin() + n);
      if (sort_within) {
        // python sorted(key=-num_edges) is a STABLE descending sort
        std::stable_sort(window.begin(), window.end(),
                         [&](int32_t a, int32_t b) {
                           return edge_counts[a] > edge_counts[b];
                         });
      }
      if (place_window(s, g, window.data(), n) == 0) {
        break;
      }
      if (n == 1) return -1;  // error already set by place_window
      n = std::max<int32_t>(
          1, static_cast<int32_t>(static_cast<double>(n) * 0.8));
    }
    const Outputs o = window_slice(s, n_feat, e_feat, base, w);
    if (pack_window_ef(s, g, e_feat, window.data(), n, o) != 0) {
      return -1;  // unreachable if place_window agreed; defensive
    }
    pending.assign(rows.begin() + n, rows.end());
    ++w;
  }
  *n_windows_out = w;
  return 0;
}
