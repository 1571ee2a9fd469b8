// Native block-dense graph packer, C++17, C ABI.
//
// Bit-identical port of data/batch.py::pack_graphs (first-fit placement,
// gather-only ELL adjacency, sentinel conventions — see that module's
// docstring for the format).  The inputs are per-row tables that the
// caller builds once per dataset (native/__init__.py::RowTables): counts,
// labels, output row ids and a data pointer per row to each of its
// arrays, so that no call concatenates graphs.  A screening window of
// 1,024 candidate rows (819 packed into 64 packs, 11 MB of output) takes
// about 5 ms on one core of an H100 host (PERF.md section 6), most of it
// the output's bytes.
//
// Three entry points, all over the same tables:
//   cgr_fit_window  — how many of a window's candidate rows fit: the
//     in-window stable sort by descending edge count, the placement-only
//     probe and the overflow shrink n -> max(1, int(n*0.8)); no writes
//     (PackedLoader.plan_windows, and native.place_graphs_native without
//     sort or shrink).
//   cgr_pack_window — the same fit, then one pack at the surviving n
//     (PackedLoader._pack_window: one call a window).
//   cgr_pack_epoch  — a WHOLE epoch in one call (the --reuse_packs cache
//     build): windows, fit and pack as above, and the carry of unconsumed
//     rows into the next window, replicating data/loader.py::_iter_pack's
//     serial semantics.
// The probe runs before every write, so the output is written once per
// emitted window, and a pack writes each slot once: a graph its own
// footprint (sentinel tails of its ELL and graph_nodes rows included),
// then the packs' unused tail slots their padding.  Output is
// bit-identical to per-window iteration and to the Python twin
// (tests/test_torch_native.py).
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

}  // namespace

// Per-row input tables, indexed by row id; the layout of
// native/__init__.py::RowTables._Tables.  The node feature row of a graph
// is node_feats[r] (base_dim floats) with an optional extra_feats[r] block
// (extra_dim floats) appended per node — the MACE-descriptor fusion, done
// during the copy instead of ahead of it.
struct CgrRowTables {
  const int32_t* node_counts;
  const int32_t* edge_counts;
  const float* labels;
  const int32_t* row_ids;       // the id a packed graph carries out
  const uint64_t* node_feats;   // const float* per row [nn, base_dim]
  const uint64_t* extra_feats;  // const float* per row [nn, extra_dim]
  const uint64_t* edge_feats;   // const float* per row [ne, e_feat]
  const uint64_t* senders;      // const int32_t* per row [ne]
  const uint64_t* receivers;    // const int32_t* per row [ne]
  int32_t n_rows;
  int32_t base_dim;
  int32_t extra_dim;            // 0 = no extra block
  int32_t e_feat;

  int32_t n_feat() const { return base_dim + extra_dim; }
  const float* nf(int32_t r) const {
    return reinterpret_cast<const float*>(node_feats[r]);
  }
  const float* xf(int32_t r) const {
    return reinterpret_cast<const float*>(extra_feats[r]);
  }
  const float* ef(int32_t r) const {
    return reinterpret_cast<const float*>(edge_feats[r]);
  }
  const int32_t* send(int32_t r) const {
    return reinterpret_cast<const int32_t*>(senders[r]);
  }
  const int32_t* recv(int32_t r) const {
    return reinterpret_cast<const int32_t*>(receivers[r]);
  }
};

namespace {

using Rows = CgrRowTables;

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

template <typename T>
inline void fill(T* p, int64_t n, T v) {
  std::fill(p, p + n, v);
}

// The padding of every slot a pack leaves unused: node slots past n_fill,
// edge slots past e_fill, graph slots past g_fill.
void pad_tails(const Spec& s, int32_t n_feat, int32_t e_feat,
               const int32_t* e_fill, const int32_t* n_fill,
               const int32_t* g_fill, const Outputs& o) {
  const int32_t ET = static_cast<int32_t>(s.ET());
  const int32_t NT = static_cast<int32_t>(s.NT());
  const int32_t BT = static_cast<int32_t>(s.BT());
  for (int32_t q = 0; q < s.p; ++q) {
    const int64_t v0 = static_cast<int64_t>(q) * s.tn + n_fill[q];
    const int64_t nv = s.tn - n_fill[q];
    std::memset(o.node_x + v0 * n_feat, 0, sizeof(float) * nv * n_feat);
    fill(o.node_inc + v0 * s.d, nv * s.d, ET);
    fill(o.node_out + v0 * s.d, nv * s.d, ET);
    fill(o.graph_of_node + v0, nv, BT);

    const int64_t e0 = static_cast<int64_t>(q) * s.te + e_fill[q];
    const int64_t ne = s.te - e_fill[q];
    std::memset(o.edge_attr + e0 * e_feat, 0, sizeof(float) * ne * e_feat);
    fill(o.senders + e0, ne, NT);
    fill(o.receivers + e0, ne, NT);
    fill(o.rev + e0, ne, ET);
    fill(o.edge_nbr + e0 * s.d, ne * s.d, ET);
    fill(o.edge_nbr_rev + e0 * s.d, ne * s.d, ET);

    const int64_t g0 = static_cast<int64_t>(q) * s.tb + g_fill[q];
    const int64_t ng = s.tb - g_fill[q];
    fill(o.graph_nodes + g0 * s.dn, ng * s.dn, NT);
    fill(o.labels_out + g0, ng, 0.0f);
    fill(o.graph_mask + g0, ng, 0.0f);
    fill(o.row_ids_out + g0, ng, int32_t{-1});
  }
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

// The per-graph checks shared by the probe and the pack: -1 with the
// error set for a graph that no pack of this spec can hold.
int check_graph(const Spec& s, const Rows& g, int32_t r) {
  if (g.edge_counts[r] > s.te || g.node_counts[r] > s.tn) {
    cgr_set_error("graph exceeds pack tile; increase te/tn");
    return -1;
  }
  if (g.node_counts[r] > s.dn) {
    cgr_set_error("graph has more nodes than dn");
    return -1;
  }
  return 0;
}

// Placement-only dry run of pack_window_ef: same feasibility checks, same
// best-fit sequence, NO output writes.
int place_window(const Spec& s, const Rows& g, const int32_t* idx,
                 int32_t n) {
  std::vector<int32_t> e_fill(s.p, 0), n_fill(s.p, 0), g_fill(s.p, 0);
  std::vector<int32_t> inc_fill;
  for (int32_t k = 0; k < n; ++k) {
    const int32_t gi = idx[k];
    if (check_graph(s, g, gi) != 0) return -1;
    const int32_t nn = g.node_counts[gi];
    const int32_t ne = g.edge_counts[gi];
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

// Pack the rows `idx[0..n)` into the outputs, writing every slot once
// (no prior fill is needed).  Returns 0, or -1 with the error set.
int pack_window_ef(const Spec& s, const Rows& g, const int32_t* idx,
                   int32_t n, const Outputs& o) {
  const int32_t n_feat = g.n_feat();
  const int32_t e_feat = g.e_feat;
  const int32_t ET = static_cast<int32_t>(s.ET());
  const int32_t NT = static_cast<int32_t>(s.NT());
  std::vector<int32_t> e_fill(s.p, 0), n_fill(s.p, 0), g_fill(s.p, 0);
  std::vector<int32_t> inc_fill;  // per-graph scratch

  for (int32_t k = 0; k < n; ++k) {
    const int32_t gi = idx[k];
    if (check_graph(s, g, gi) != 0) return -1;
    const int32_t nn = g.node_counts[gi];
    const int32_t ne = g.edge_counts[gi];
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

    // node_inc / node_out (ELL over receivers; rev(e) = e^1), then the
    // sentinel tail of each of the graph's rows
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
    for (int32_t v = 0; v < nn; ++v) {
      const int64_t row = (n_off + v) * s.d;
      fill(o.node_inc + row + inc_fill[v], s.d - inc_fill[v], ET);
      fill(o.node_out + row + inc_fill[v], s.d - inc_fill[v], ET);
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

    int32_t* nodes = o.graph_nodes + g_off * s.dn;
    for (int32_t v = 0; v < nn; ++v) {
      o.graph_of_node[n_off + v] = static_cast<int32_t>(g_off);
      nodes[v] = static_cast<int32_t>(n_off) + v;
    }
    fill(nodes + nn, s.dn - nn, NT);
    o.labels_out[g_off] = g.labels[gi];
    o.graph_mask[g_off] = 1.0f;
    o.row_ids_out[g_off] = g.row_ids[gi];

    e_fill[pk] += ne;
    n_fill[pk] += nn;
    g_fill[pk] += 1;
  }
  pad_tails(s, n_feat, e_feat, e_fill.data(), n_fill.data(), g_fill.data(),
            o);
  return 0;
}

// PackedLoader._pack_window's loop: window = rows[0..n), stable-sorted by
// descending edge count when `sort` (Python's sorted(key=-num_edges)),
// probed; on a refusal n shrinks to max(1, int(n*0.8)) when `shrink` and
// the probe runs again.  Returns the surviving n (`window` holds its
// rows), or -1 with the error set (a row id outside the tables, a refused
// single row, or any refusal without `shrink`).  *probes counts the
// attempts.
int32_t fit_window(const Spec& s, const Rows& g, const int32_t* rows,
                   int32_t n, bool sort, bool shrink,
                   std::vector<int32_t>& window, int32_t* probes) {
  for (int32_t k = 0; k < n; ++k) {
    if (rows[k] < 0 || rows[k] >= g.n_rows) {
      cgr_set_error("row id out of range of the row tables");
      return -1;
    }
  }
  while (true) {
    window.assign(rows, rows + n);
    if (sort) {
      std::stable_sort(window.begin(), window.end(),
                       [&](int32_t a, int32_t b) {
                         return g.edge_counts[a] > g.edge_counts[b];
                       });
    }
    ++*probes;
    if (place_window(s, g, window.data(), n) == 0) return n;
    if (!shrink || n <= 1) return -1;  // error already set
    n = std::max<int32_t>(
        1, static_cast<int32_t>(static_cast<double>(n) * 0.8));
  }
}

Outputs make_outputs(float* node_x, float* edge_attr, int32_t* senders,
                     int32_t* receivers, int32_t* rev, int32_t* edge_nbr,
                     int32_t* edge_nbr_rev, int32_t* node_inc,
                     int32_t* node_out, int32_t* graph_of_node,
                     int32_t* graph_nodes, float* labels_out,
                     float* graph_mask, int32_t* row_ids_out) {
  return Outputs{node_x, edge_attr, senders, receivers, rev,
                 edge_nbr, edge_nbr_rev, node_inc, node_out,
                 graph_of_node, graph_nodes, labels_out, graph_mask,
                 row_ids_out};
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

// How many of the candidate rows `rows[0..n)` one window takes (see
// fit_window); no output is written.  *consumed is that count.
extern "C" int cgr_fit_window(
    int32_t p, int32_t te, int32_t tn, int32_t tb, int32_t d, int32_t dn,
    const CgrRowTables* tables, const int32_t* rows, int32_t n,
    int32_t sort, int32_t shrink, int32_t* consumed, int32_t* probes) {
  const Spec s{p, te, tn, tb, d, dn};
  std::vector<int32_t> window;
  *probes = 0;
  const int32_t got = fit_window(s, *tables, rows, n, sort != 0,
                                 shrink != 0, window, probes);
  if (got < 0) return -1;
  *consumed = got;
  return 0;
}

// One window: fit the candidate rows `rows[0..n)`, then pack the
// surviving *consumed of them, once, into the caller's outputs (any prior
// content: every slot is written).
extern "C" int cgr_pack_window(
    int32_t p, int32_t te, int32_t tn, int32_t tb, int32_t d, int32_t dn,
    const CgrRowTables* tables, const int32_t* rows, int32_t n,
    int32_t sort, int32_t shrink,
    float* node_x, float* edge_attr,
    int32_t* senders, int32_t* receivers, int32_t* rev,
    int32_t* edge_nbr, int32_t* edge_nbr_rev,
    int32_t* node_inc, int32_t* node_out,
    int32_t* graph_of_node, int32_t* graph_nodes,
    float* labels_out, float* graph_mask, int32_t* row_ids_out,
    int32_t* consumed, int32_t* probes) {
  const Spec s{p, te, tn, tb, d, dn};
  const Outputs o = make_outputs(node_x, edge_attr, senders, receivers, rev,
                                 edge_nbr, edge_nbr_rev, node_inc, node_out,
                                 graph_of_node, graph_nodes, labels_out,
                                 graph_mask, row_ids_out);
  std::vector<int32_t> window;
  *probes = 0;
  const int32_t got = fit_window(s, *tables, rows, n, sort != 0,
                                 shrink != 0, window, probes);
  if (got < 0) return -1;
  *consumed = got;
  return pack_window_ef(s, *tables, window.data(), got, o);
}

// One call packs a whole epoch: `order[0..n_order)` are the rows in epoch
// order; windows of batch_size (less the carried rows), the fit of
// cgr_pack_window, and the carry of unconsumed rows replicate
// data/loader.py::_iter_pack serially.  Outputs are max_windows stacked
// PackedGraphBatch buffers; *n_windows_out reports how many were written,
// *probes the placement attempts.
extern "C" int cgr_pack_epoch(
    int32_t p, int32_t te, int32_t tn, int32_t tb, int32_t d, int32_t dn,
    const CgrRowTables* tables, const int32_t* order, int32_t n_order,
    int32_t batch_size, int32_t drop_last, int32_t max_windows,
    float* node_x, float* edge_attr,
    int32_t* senders, int32_t* receivers, int32_t* rev,
    int32_t* edge_nbr, int32_t* edge_nbr_rev,
    int32_t* node_inc, int32_t* node_out,
    int32_t* graph_of_node, int32_t* graph_nodes,
    float* labels_out, float* graph_mask, int32_t* row_ids_out,
    int32_t* n_windows_out, int32_t* probes) {
  const Spec s{p, te, tn, tb, d, dn};
  const Rows& g = *tables;
  const Outputs base = make_outputs(node_x, edge_attr, senders, receivers,
                                    rev, edge_nbr, edge_nbr_rev, node_inc,
                                    node_out, graph_of_node, graph_nodes,
                                    labels_out, graph_mask, row_ids_out);
  std::vector<int32_t> pending, rows, window;
  int32_t pos = 0, w = 0;
  *probes = 0;
  while (pos < n_order || !pending.empty()) {
    const int32_t take = batch_size - static_cast<int32_t>(pending.size());
    rows = pending;
    const int32_t end = std::min(pos + take, n_order);
    rows.insert(rows.end(), order + pos, order + end);
    pos = end;
    if (drop_last && pos >= n_order &&
        static_cast<int32_t>(rows.size()) < batch_size) {
      break;  // skip the final partial batch (loader drop_last semantics)
    }
    if (w >= max_windows) return -2;  // caller grows and retries
    const int32_t n = fit_window(s, g, rows.data(),
                                 static_cast<int32_t>(rows.size()), true,
                                 true, window, probes);
    if (n < 0) return -1;
    const Outputs o = window_slice(s, g.n_feat(), g.e_feat, base, w);
    if (pack_window_ef(s, g, window.data(), n, o) != 0) {
      return -1;  // unreachable if place_window agreed; defensive
    }
    pending.assign(rows.begin() + n, rows.end());
    ++w;
  }
  *n_windows_out = w;
  return 0;
}
