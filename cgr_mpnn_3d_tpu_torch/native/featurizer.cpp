// Native host featurizer: SMILES -> CGR graph arrays, C++17, C ABI.
//
// Mirrors the Python chem/ stack exactly (chem/smiles.py, chem/mol.py,
// chem/featurize.py — which themselves reproduce the reference's RDKit-based
// feature contracts, the original model's
// cgr_mpnn_3D/utils/graph_features.py).
// The Python featurizer costs ~1-3 ms per reaction; for the ~10k-reaction
// Transition1x splits and for high-throughput serving this native path cuts
// host featurization latency by >10x (see tests/test_torch_native.py).
//
// Build: at first use, by cgr_mpnn_3d_tpu_torch/native/__init__.py::build
// (g++ -O3 -std=c++17 -fPIC -shared, with packer.cpp, into
// cgr_mpnn_3d_tpu_torch/build/libcgrfeat-<hash>.so); it is also the ctypes
// binding.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <memory>
#include <optional>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- periodic
struct ElementInfo {
  double weight;
  int nouter;  // valence electrons (-1 = unknown -> 4)
};

const std::unordered_map<std::string, ElementInfo>& periodic() {
  static const std::unordered_map<std::string, ElementInfo> table = {
      {"H", {1.008, 1}},      {"He", {4.002602, 2}}, {"Li", {6.94, 1}},
      {"Be", {9.0121831, 2}}, {"B", {10.81, 3}},     {"C", {12.011, 4}},
      {"N", {14.007, 5}},     {"O", {15.999, 6}},    {"F", {18.998403163, 7}},
      {"Ne", {20.1797, 8}},   {"Na", {22.98976928, 1}}, {"Mg", {24.305, 2}},
      {"Al", {26.9815385, 3}},{"Si", {28.085, 4}},   {"P", {30.973761998, 5}},
      {"S", {32.06, 6}},      {"Cl", {35.45, 7}},    {"Ar", {39.948, 8}},
      {"K", {39.0983, 1}},    {"Ca", {40.078, 2}},   {"Sc", {44.955908, 4}},
      {"Ti", {47.867, 4}},    {"V", {50.9415, 4}},   {"Cr", {51.9961, 4}},
      {"Mn", {54.938044, 4}}, {"Fe", {55.845, 4}},   {"Co", {58.933194, 4}},
      {"Ni", {58.6934, 4}},   {"Cu", {63.546, 4}},   {"Zn", {65.38, 4}},
      {"Ga", {69.723, 3}},    {"Ge", {72.630, 4}},   {"As", {74.921595, 5}},
      {"Se", {78.971, 6}},    {"Br", {79.904, 7}},   {"Kr", {83.798, 8}},
      {"Rb", {85.4678, 1}},   {"Sr", {87.62, 2}},    {"I", {126.90447, 7}},
      {"Sn", {118.710, 4}},   {"Sb", {121.760, 5}},  {"Te", {127.60, 6}},
      {"Xe", {131.293, 8}},   {"Cs", {132.90545196, 1}}, {"Ba", {137.327, 2}},
      {"W", {183.84, 4}},     {"Pt", {195.084, 4}},  {"Au", {196.966569, 4}},
      {"Hg", {200.592, 4}},   {"Tl", {204.38, 3}},   {"Pb", {207.2, 4}},
      {"Bi", {208.98040, 5}}, {"U", {238.02891, 4}}, {"*", {0.0, 0}},
  };
  return table;
}

double atomic_weight(const std::string& sym, int isotope) {
  if (isotope) return static_cast<double>(isotope);
  auto it = periodic().find(sym);
  return it == periodic().end() ? 0.0 : it->second.weight;
}

int valence_electrons(const std::string& sym) {
  auto it = periodic().find(sym);
  return it == periodic().end() ? 4 : it->second.nouter;
}

std::vector<int> default_valences(const std::string& sym) {
  if (sym == "B") return {3};
  if (sym == "C") return {4};
  if (sym == "N") return {3, 5};
  if (sym == "O") return {2};
  if (sym == "P") return {3, 5};
  if (sym == "S") return {2, 4, 6};
  if (sym == "F" || sym == "Cl" || sym == "Br" || sym == "I") return {1};
  return {};
}

bool aromatic_ok(const std::string& lower) {
  static const char* ok[] = {"b", "c", "n", "o", "p", "s", "se", "as", "te"};
  for (auto* s : ok)
    if (lower == s) return true;
  return false;
}

// ------------------------------------------------------------------ parser
struct RawAtom {
  std::string symbol;
  bool aromatic = false;
  int charge = 0;
  int isotope = 0;
  int map_num = 0;
  int h_count = 0;       // explicit bracket H
  bool bracket = false;
};

// bond symbol codes
enum BondSym { UNSPEC = 0, SINGLE, DOUBLE, TRIPLE, QUAD, AROM };

struct RawBond {
  int a1, a2;
  int sym;  // BondSym
};

struct Parsed {
  std::vector<RawAtom> atoms;
  std::vector<RawBond> bonds;
};

[[noreturn]] void fail(const std::string& msg) { throw std::runtime_error(msg); }

RawAtom parse_bracket(const std::string& s, size_t& i) {
  // s[i] == '['
  size_t j = i + 1;
  RawAtom a;
  a.bracket = true;
  while (j < s.size() && std::isdigit(s[j]))
    a.isotope = a.isotope * 10 + (s[j++] - '0');
  // symbol
  if (j >= s.size()) fail("malformed bracket atom");
  if (s[j] == '*') {
    a.symbol = "*";
    ++j;
  } else if (std::isupper(s[j])) {
    a.symbol += s[j++];
    if (j < s.size() && std::islower(s[j]) && s[j] != 'H' &&
        periodic().count(a.symbol + s[j]))
      a.symbol += s[j++];
  } else if (std::islower(s[j])) {
    std::string low;
    low += s[j++];
    if (j < s.size() && std::islower(s[j]) && aromatic_ok(low + s[j]))
      low += s[j++];
    if (!aromatic_ok(low)) fail("element '" + low + "' cannot be aromatic");
    a.aromatic = true;
    a.symbol = low;
    a.symbol[0] = std::toupper(a.symbol[0]);
  } else {
    fail("malformed bracket atom symbol");
  }
  if (a.symbol != "*" && !periodic().count(a.symbol))
    fail("unknown element symbol '" + a.symbol + "'");
  // chirality (ignored)
  if (j < s.size() && s[j] == '@') {
    ++j;
    if (j < s.size() && s[j] == '@') ++j;
    // @TH1 etc.
    while (j < s.size() && (std::isupper(s[j]) || std::isdigit(s[j]))) {
      if (s[j] == 'H' && (j + 1 >= s.size() || !std::isupper(s[j + 1]))) break;
      ++j;
    }
  }
  // hcount
  if (j < s.size() && s[j] == 'H') {
    ++j;
    a.h_count = 1;
    if (j < s.size() && std::isdigit(s[j])) {
      a.h_count = 0;
      while (j < s.size() && std::isdigit(s[j]))
        a.h_count = a.h_count * 10 + (s[j++] - '0');
    }
  }
  // charge
  if (j < s.size() && (s[j] == '+' || s[j] == '-')) {
    char c = s[j];
    int n = 0;
    while (j < s.size() && s[j] == c) {
      ++n;
      ++j;
    }
    if (n == 1 && j < s.size() && std::isdigit(s[j])) {
      n = 0;
      while (j < s.size() && std::isdigit(s[j])) n = n * 10 + (s[j++] - '0');
    }
    a.charge = (c == '+') ? n : -n;
  }
  // atom map
  if (j < s.size() && s[j] == ':') {
    ++j;
    int m = 0;
    if (j >= s.size() || !std::isdigit(s[j])) fail("malformed atom map");
    while (j < s.size() && std::isdigit(s[j])) m = m * 10 + (s[j++] - '0');
    a.map_num = m;
  }
  if (j >= s.size() || s[j] != ']') fail("unterminated bracket atom");
  i = j + 1;
  return a;
}

Parsed parse_smiles(const std::string& s) {
  Parsed out;
  int prev = -1;
  int pending = -1;  // -1 = none, else BondSym
  std::vector<int> branch;
  std::map<int, std::pair<int, int>> ring;  // num -> (atom, bondsym or -1)

  auto add_atom = [&](RawAtom a) {
    int idx = static_cast<int>(out.atoms.size());
    out.atoms.push_back(std::move(a));
    if (prev >= 0)
      out.bonds.push_back({prev, idx, pending < 0 ? UNSPEC : pending});
    prev = idx;
    pending = -1;
  };
  auto close_ring = [&](int num) {
    if (prev < 0) fail("ring-closure digit before any atom");
    auto it = ring.find(num);
    if (it == ring.end()) {
      ring[num] = {prev, pending};
      pending = -1;
      return;
    }
    auto [open_atom, open_sym] = it->second;
    ring.erase(it);
    if (open_atom == prev) fail("ring bond closes onto its own atom");
    int sym = pending >= 0 ? pending : (open_sym >= 0 ? open_sym : UNSPEC);
    if (pending >= 0 && open_sym >= 0 && pending != open_sym)
      fail("conflicting ring-closure bond symbols");
    out.bonds.push_back({open_atom, prev, sym});
    pending = -1;
  };

  size_t i = 0;
  while (i < s.size()) {
    char c = s[i];
    if (c == '[') {
      add_atom(parse_bracket(s, i));
      continue;
    }
    int bs = -1;
    switch (c) {
      case '-': case '/': case '\\': bs = SINGLE; break;
      case '=': bs = DOUBLE; break;
      case '#': bs = TRIPLE; break;
      case '$': bs = QUAD; break;
      case ':': bs = AROM; break;
      default: break;
    }
    if (bs >= 0) {
      if (pending >= 0) fail("two bond symbols in a row");
      pending = bs;
      ++i;
      continue;
    }
    if (c == '(') {
      if (prev < 0) fail("branch before any atom");
      branch.push_back(prev);
      ++i;
      continue;
    }
    if (c == ')') {
      if (branch.empty()) fail("unmatched ')'");
      prev = branch.back();
      branch.pop_back();
      ++i;
      continue;
    }
    if (c == '.') {
      prev = -1;
      pending = -1;
      ++i;
      continue;
    }
    if (std::isdigit(c)) {
      close_ring(c - '0');
      ++i;
      continue;
    }
    if (c == '%') {
      if (i + 2 >= s.size() || !std::isdigit(s[i + 1]) ||
          !std::isdigit(s[i + 2]))
        fail("malformed %nn ring closure");
      close_ring((s[i + 1] - '0') * 10 + (s[i + 2] - '0'));
      i += 3;
      continue;
    }
    // organic subset
    {
      RawAtom a;
      bool two = false;
      if (c == 'C' && i + 1 < s.size() && s[i + 1] == 'l') {
        a.symbol = "Cl";
        two = true;
      } else if (c == 'B' && i + 1 < s.size() && s[i + 1] == 'r') {
        a.symbol = "Br";
        two = true;
      } else if (std::strchr("BCNOPSFI", c)) {
        a.symbol = std::string(1, c);
      } else if (std::strchr("bcnops", c)) {
        a.aromatic = true;
        a.symbol = std::string(1, std::toupper(c));
      } else if (c == '*') {
        a.symbol = "*";
      } else {
        fail(std::string("unexpected character '") + c + "' in SMILES");
      }
      a.h_count = -1;  // organic subset: implicit H computed later
      add_atom(std::move(a));
      i += two ? 2 : 1;
      continue;
    }
  }
  if (!branch.empty()) fail("unclosed branch '('");
  if (!ring.empty()) fail("unclosed ring bonds");
  if (pending >= 0) fail("dangling bond symbol at end of SMILES");
  return out;
}

// -------------------------------------------------------------- perception
// Hybridization codes matching chem/mol.py
enum { HYB_OTHER = 0, HYB_SP = 2, HYB_SP2 = 3, HYB_SP3 = 4, HYB_SP3D = 5,
       HYB_SP3D2 = 6 };

struct Atom {
  std::string symbol;
  bool aromatic;
  int charge, isotope, map_num;
  int num_hs, degree, total_degree;
  bool in_ring;
  int hybridization;
  int lone_pairs;
  double mass;
};

struct Bond {
  int a1, a2;
  int order;
  bool aromatic;
  bool in_ring;
  bool conjugated;
};

struct Molecule {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
  std::vector<std::vector<int>> adj;

  int bond_between(int a, int b) const {
    for (int bi : adj[a])
      if (bonds[bi].a1 + bonds[bi].a2 - a == b) return bi;
    return -1;
  }
};

// ring bonds = non-bridges (iterative DFS lowlink)
std::vector<bool> ring_bonds(int n, const std::vector<RawBond>& bonds,
                             const std::vector<std::vector<int>>& adj) {
  std::vector<bool> visited(n, false), is_bridge(bonds.size(), false);
  std::vector<int> disc(n, 0), low(n, 0);
  int timer = 1;
  struct Frame { int u, pbond; size_t it; };
  for (int root = 0; root < n; ++root) {
    if (visited[root]) continue;
    std::vector<Frame> stack{{root, -1, 0}};
    visited[root] = true;
    disc[root] = low[root] = timer++;
    while (!stack.empty()) {
      Frame& f = stack.back();
      bool advanced = false;
      while (f.it < adj[f.u].size()) {
        int bi = adj[f.u][f.it++];
        if (bi == f.pbond) continue;
        const RawBond& b = bonds[bi];
        int v = b.a1 + b.a2 - f.u;
        if (!visited[v]) {
          visited[v] = true;
          disc[v] = low[v] = timer++;
          stack.push_back({v, bi, 0});
          advanced = true;
          break;
        }
        low[f.u] = std::min(low[f.u], disc[v]);
      }
      if (!advanced) {
        Frame done = stack.back();
        stack.pop_back();
        if (!stack.empty()) {
          Frame& par = stack.back();
          low[par.u] = std::min(low[par.u], low[done.u]);
          if (low[done.u] > disc[par.u]) is_bridge[done.pbond] = true;
        }
      }
    }
  }
  std::vector<bool> in_ring(bonds.size());
  for (size_t i = 0; i < bonds.size(); ++i) in_ring[i] = !is_bridge[i];
  return in_ring;
}

// Small rings as bond-index lists: shortest cycle through each ring bond
// (BFS avoiding that bond) — mirrors chem/mol.py::_small_rings.
std::vector<std::vector<int>> small_rings(
    int n_atoms, const std::vector<RawBond>& bonds,
    const std::vector<std::vector<int>>& adj,
    const std::vector<bool>& in_ring, int max_size = 7) {
  std::vector<std::vector<int>> rings;
  std::set<std::set<int>> seen;
  for (size_t bi = 0; bi < bonds.size(); ++bi) {
    if (!in_ring[bi]) continue;
    const RawBond& b = bonds[bi];
    std::vector<int> prev_bond(n_atoms, -2);  // -2 unvisited, -1 root
    std::vector<int> queue{b.a1};
    prev_bond[b.a1] = -1;
    size_t head = 0;
    while (head < queue.size() && prev_bond[b.a2] == -2) {
      int u = queue[head++];
      for (int bj : adj[u]) {
        if (bj == static_cast<int>(bi)) continue;
        int w = bonds[bj].a1 + bonds[bj].a2 - u;
        if (prev_bond[w] == -2) {
          prev_bond[w] = bj;
          queue.push_back(w);
        }
      }
    }
    if (prev_bond[b.a2] == -2) continue;
    std::vector<int> path{static_cast<int>(bi)};
    int cur = b.a2;
    while (cur != b.a1) {
      int bj = prev_bond[cur];
      path.push_back(bj);
      cur = bonds[bj].a1 + bonds[bj].a2 - cur;
    }
    if (static_cast<int>(path.size()) <= max_size) {
      std::set<int> key(path.begin(), path.end());
      if (seen.insert(key).second) rings.push_back(path);
    }
  }
  return rings;
}

// Hueckel-style perception for kekulized input; mirrors
// chem/mol.py::_perceive_aromatic_rings (marks atoms aromatic in-place,
// returns perceived aromatic bond indices).
std::set<int> perceive_aromatic(Parsed& parsed,
                                const std::vector<std::vector<int>>& adj,
                                const std::vector<bool>& in_ring,
                                const std::vector<int>& orders) {
  std::set<int> arom_bonds;
  auto rings = small_rings(static_cast<int>(parsed.atoms.size()),
                           parsed.bonds, adj, in_ring);
  if (rings.empty()) return arom_bonds;

  int n = static_cast<int>(parsed.atoms.size());
  std::vector<bool> ring_dbl(n, false), exo_dbl(n, false);
  for (size_t bi = 0; bi < parsed.bonds.size(); ++bi) {
    if (orders[bi] >= 2) {
      auto& b = parsed.bonds[bi];
      if (in_ring[bi]) {
        ring_dbl[b.a1] = ring_dbl[b.a2] = true;
      } else {
        exo_dbl[b.a1] = exo_dbl[b.a2] = true;
      }
    }
  }

  bool changed = true;
  while (changed) {
    changed = false;
    for (const auto& ring : rings) {
      bool all_arom = true;
      for (int bi : ring)
        if (!arom_bonds.count(bi)) { all_arom = false; break; }
      if (all_arom) continue;
      std::vector<int> ring_atoms;
      for (int bi : ring)
        for (int a : {parsed.bonds[bi].a1, parsed.bonds[bi].a2})
          if (std::find(ring_atoms.begin(), ring_atoms.end(), a) ==
              ring_atoms.end())
            ring_atoms.push_back(a);
      int pi = 0;
      bool ok = true;
      for (int a : ring_atoms) {
        const RawAtom& atom = parsed.atoms[a];
        if (atom.aromatic) {
          pi += 1;
        } else if (ring_dbl[a]) {
          pi += 1;
        } else if (exo_dbl[a]) {
          // contributes 0
        } else if (atom.symbol == "C") {
          if (atom.charge == 1) {
            // 0
          } else if (atom.charge == -1) {
            pi += 2;
          } else {
            ok = false;
            break;
          }
        } else if (atom.symbol == "N" || atom.symbol == "O" ||
                   atom.symbol == "S" || atom.symbol == "P" ||
                   atom.symbol == "Se" || atom.symbol == "Te") {
          pi += 2;
        } else {
          ok = false;
          break;
        }
      }
      if (ok && pi % 4 == 2) {
        for (int a : ring_atoms) parsed.atoms[a].aromatic = true;
        for (int bi : ring)
          if (arom_bonds.insert(bi).second) changed = true;
      }
    }
  }
  return arom_bonds;
}

bool needs_double(const RawAtom& a, int conn, bool exo_multiple) {
  if (exo_multiple) return false;
  const std::string& s = a.symbol;
  if (s == "C") return a.charge == 0;
  if (s == "N" || s == "P" || s == "As") {
    if (a.charge == 1) return true;
    if (a.charge == -1) return false;
    return conn == 2;
  }
  if (s == "O" || s == "S" || s == "Se" || s == "Te") return a.charge == 1;
  return false;
}

bool kekulize_backtrack(
    size_t pos, const std::vector<int>& order_atoms,
    const std::map<int, std::vector<int>>& cand_bonds,
    const std::vector<RawBond>& bonds, std::map<int, int>& matched,
    std::vector<int>& chosen) {
  while (pos < order_atoms.size() && matched.count(order_atoms[pos])) ++pos;
  if (pos == order_atoms.size()) return true;
  int u = order_atoms[pos];
  for (int bi : cand_bonds.at(u)) {
    int v = bonds[bi].a1 + bonds[bi].a2 - u;
    if (matched.count(v) || matched.count(u)) continue;
    matched[u] = bi;
    matched[v] = bi;
    chosen.push_back(bi);
    if (kekulize_backtrack(pos + 1, order_atoms, cand_bonds, bonds, matched,
                           chosen))
      return true;
    chosen.pop_back();
    matched.erase(u);
    matched.erase(v);
  }
  return false;
}

Molecule perceive(Parsed parsed) {
  int n = static_cast<int>(parsed.atoms.size());
  std::vector<std::vector<int>> adj(n);
  for (size_t bi = 0; bi < parsed.bonds.size(); ++bi) {
    adj[parsed.bonds[bi].a1].push_back(static_cast<int>(bi));
    adj[parsed.bonds[bi].a2].push_back(static_cast<int>(bi));
  }
  std::vector<bool> in_ring = ring_bonds(n, parsed.bonds, adj);

  // bond aromaticity
  std::vector<bool> barom(parsed.bonds.size(), false);
  for (size_t bi = 0; bi < parsed.bonds.size(); ++bi) {
    const RawBond& b = parsed.bonds[bi];
    if (b.sym == AROM)
      barom[bi] = true;
    else if (b.sym == UNSPEC && in_ring[bi] && parsed.atoms[b.a1].aromatic &&
             parsed.atoms[b.a2].aromatic)
      barom[bi] = true;
  }

  // kekulize
  std::vector<int> orders(parsed.bonds.size());
  for (size_t bi = 0; bi < parsed.bonds.size(); ++bi) {
    switch (parsed.bonds[bi].sym) {
      case DOUBLE: orders[bi] = 2; break;
      case TRIPLE: orders[bi] = 3; break;
      case QUAD: orders[bi] = 4; break;
      default: orders[bi] = 1; break;
    }
  }
  {
    std::vector<bool> exo(n, false);
    for (size_t bi = 0; bi < parsed.bonds.size(); ++bi)
      if (!barom[bi] && orders[bi] >= 2) {
        exo[parsed.bonds[bi].a1] = true;
        exo[parsed.bonds[bi].a2] = true;
      }
    std::map<int, std::vector<int>> cand_bonds;
    std::map<int, bool> needs;
    for (int i = 0; i < n; ++i) {
      const RawAtom& a = parsed.atoms[i];
      if (!a.aromatic) continue;
      int conn = static_cast<int>(adj[i].size()) +
                 (a.h_count > 0 ? a.h_count : 0);
      if (!a.bracket && a.symbol == "C" && adj[i].size() == 2) conn += 1;
      needs[i] = needs_double(a, conn, exo[i]);
      if (needs[i]) cand_bonds[i];  // ensure key
    }
    for (size_t bi = 0; bi < parsed.bonds.size(); ++bi) {
      const RawBond& b = parsed.bonds[bi];
      if (barom[bi] && needs.count(b.a1) && needs[b.a1] && needs.count(b.a2) &&
          needs[b.a2]) {
        cand_bonds[b.a1].push_back(static_cast<int>(bi));
        cand_bonds[b.a2].push_back(static_cast<int>(bi));
      }
    }
    std::vector<int> order_atoms;
    for (auto& kv : cand_bonds) order_atoms.push_back(kv.first);
    std::sort(order_atoms.begin(), order_atoms.end(), [&](int x, int y) {
      return cand_bonds[x].size() < cand_bonds[y].size();
    });
    std::map<int, int> matched;
    std::vector<int> chosen;
    if (!kekulize_backtrack(0, order_atoms, cand_bonds, parsed.bonds, matched,
                            chosen))
      fail("cannot kekulize aromatic system");
    for (int bi : chosen) orders[bi] = 2;
  }

  // aromaticity perception for kekulized input (keeps written orders;
  // mirrors chem/mol.py)
  for (int bi : perceive_aromatic(parsed, adj, in_ring, orders))
    barom[bi] = true;

  Molecule mol;
  mol.adj = adj;
  for (size_t bi = 0; bi < parsed.bonds.size(); ++bi)
    mol.bonds.push_back({parsed.bonds[bi].a1, parsed.bonds[bi].a2, orders[bi],
                         barom[bi], in_ring[bi], false});

  for (int i = 0; i < n; ++i) {
    const RawAtom& ra = parsed.atoms[i];
    int bond_sum = 0;
    for (int bi : adj[i]) bond_sum += orders[bi];
    int num_hs;
    if (ra.bracket || ra.h_count >= 0) {
      num_hs = std::max(ra.h_count, 0);
    } else {
      num_hs = 0;
    }
    if (!ra.bracket) {  // organic subset: implicit H
      num_hs = 0;
      for (int v : default_valences(ra.symbol))
        if (bond_sum <= v) {
          num_hs = v - bond_sum;
          break;
        }
    }
    int degree = static_cast<int>(adj[i].size());
    int total_valence = bond_sum + num_hs;
    int nouter = valence_electrons(ra.symbol);
    int lone_pairs = std::max(0, (nouter - ra.charge - total_valence) / 2);
    int sigma = degree + num_hs;
    int norbs = sigma + lone_pairs;
    int hyb;
    switch (norbs) {
      case 2: hyb = HYB_SP; break;
      case 3: hyb = HYB_SP2; break;
      case 4: hyb = HYB_SP3; break;
      case 5: hyb = HYB_SP3D; break;
      case 6: hyb = HYB_SP3D2; break;
      default: hyb = HYB_OTHER; break;
    }
    if (ra.aromatic && hyb == HYB_SP3) hyb = HYB_SP2;
    if (ra.symbol == "H" || ra.symbol == "*") hyb = HYB_OTHER;
    bool atom_in_ring = false;
    for (int bi : adj[i]) atom_in_ring |= in_ring[bi];
    mol.atoms.push_back({ra.symbol, ra.aromatic, ra.charge, ra.isotope,
                         ra.map_num, num_hs, degree, degree + num_hs,
                         atom_in_ring, hyb, lone_pairs,
                         atomic_weight(ra.symbol, ra.isotope)});
  }

  // conjugation (chem/mol.py _set_conjugation approximation)
  auto pi_candidate = [&](int i) {
    const Atom& a = mol.atoms[i];
    if (a.aromatic) return true;
    for (int bi : adj[i])
      if (mol.bonds[bi].order >= 2) return true;
    return a.lone_pairs > 0 && a.symbol != "C" && a.symbol != "H" &&
           a.symbol != "*";
  };
  for (auto& b : mol.bonds)
    if (b.aromatic) b.conjugated = true;
  for (int i = 0; i < n; ++i) {
    if (!pi_candidate(i)) continue;
    std::vector<int> multi;
    for (int bi : adj[i])
      if (mol.bonds[bi].order >= 2 || mol.bonds[bi].aromatic)
        multi.push_back(bi);
    if (multi.empty()) continue;
    for (int b1 : multi)
      for (int b2 : adj[i]) {
        if (b1 == b2) continue;
        int j = mol.bonds[b2].a1 + mol.bonds[b2].a2 - i;
        if (pi_candidate(j)) {
          mol.bonds[b1].conjugated = true;
          mol.bonds[b2].conjugated = true;
        }
      }
  }
  return mol;
}

// ------------------------------------------------------------ featurization
constexpr int ATOM_FDIM = 39;
constexpr int BOND_FDIM = 7;

void atom_features(const Molecule& mol, int idx, float* out) {
  const Atom& a = mol.atoms[idx];
  std::memset(out, 0, sizeof(float) * ATOM_FDIM);
  static const char* SYMS[] = {"H", "C", "N", "O", "F", "Si",
                               "P", "S", "Cl", "Br", "I"};
  int k = 11;
  for (int i = 0; i < 11; ++i)
    if (a.symbol == SYMS[i]) { k = i; break; }
  out[k] = 1.0f;
  int td = a.total_degree;
  out[12 + (td >= 0 && td <= 5 ? td : 6)] = 1.0f;
  static const int CHG[] = {-1, -2, 1, 2, 0};
  int ci = 5;
  for (int i = 0; i < 5; ++i)
    if (a.charge == CHG[i]) { ci = i; break; }
  out[19 + ci] = 1.0f;
  out[25 + (a.num_hs >= 0 && a.num_hs <= 4 ? a.num_hs : 5)] = 1.0f;
  static const int HYBS[] = {HYB_SP, HYB_SP2, HYB_SP3, HYB_SP3D, HYB_SP3D2};
  int hi = 5;
  for (int i = 0; i < 5; ++i)
    if (a.hybridization == HYBS[i]) { hi = i; break; }
  out[31 + hi] = 1.0f;
  out[37] = a.aromatic ? 1.0f : 0.0f;
  out[38] = static_cast<float>(a.mass * 0.01);
}

void bond_features(const Molecule* mol, int bi, float* out) {
  std::memset(out, 0, sizeof(float) * BOND_FDIM);
  if (mol == nullptr || bi < 0) {
    out[0] = 1.0f;
    return;
  }
  const Bond& b = mol->bonds[bi];
  if (!b.aromatic && b.order == 1) out[1] = 1.0f;
  if (!b.aromatic && b.order == 2) out[2] = 1.0f;
  if (!b.aromatic && b.order == 3) out[3] = 1.0f;
  if (b.aromatic) out[4] = 1.0f;
  out[5] = b.conjugated ? 1.0f : 0.0f;
  out[6] = b.in_ring ? 1.0f : 0.0f;
}

// ------------------------------------------------------------ graph builder
struct Graph {
  int n_atoms = 0;
  int n_edges = 0;
  int atom_fdim = 0;
  int bond_fdim = 0;
  std::vector<float> node_feats;   // [n_atoms, atom_fdim]
  std::vector<float> edge_feats;   // [n_edges, bond_fdim]
  std::vector<int32_t> senders;
  std::vector<int32_t> receivers;
};

std::string split_section(const std::string& smiles, int which) {
  // reac>agents>prod
  size_t p1 = smiles.find('>');
  if (p1 == std::string::npos) fail("reaction SMILES needs '>' separators");
  size_t p2 = smiles.find('>', p1 + 1);
  if (p2 == std::string::npos) fail("reaction SMILES needs two '>'");
  if (which == 0) return smiles.substr(0, p1);
  return smiles.substr(p2 + 1);
}

Graph build_mol_graph(const std::string& smiles) {
  Molecule mol = perceive(parse_smiles(smiles));
  Graph g;
  g.n_atoms = static_cast<int>(mol.atoms.size());
  g.atom_fdim = ATOM_FDIM;
  g.bond_fdim = BOND_FDIM;
  g.node_feats.resize(g.n_atoms * ATOM_FDIM);
  for (int i = 0; i < g.n_atoms; ++i)
    atom_features(mol, i, g.node_feats.data() + i * ATOM_FDIM);
  for (int a1 = 0; a1 < g.n_atoms; ++a1)
    for (int a2 = a1 + 1; a2 < g.n_atoms; ++a2) {
      int bi = mol.bond_between(a1, a2);
      if (bi < 0) continue;
      float fb[BOND_FDIM];
      bond_features(&mol, bi, fb);
      for (int r = 0; r < 2; ++r)
        g.edge_feats.insert(g.edge_feats.end(), fb, fb + BOND_FDIM);
      g.senders.push_back(a1);
      g.receivers.push_back(a2);
      g.senders.push_back(a2);
      g.receivers.push_back(a1);
    }
  g.n_edges = static_cast<int>(g.senders.size());
  return g;
}

Graph build_rxn_graph(const std::string& smiles) {
  Molecule reac = perceive(parse_smiles(split_section(smiles, 0)));
  Molecule prod = perceive(parse_smiles(split_section(smiles, 2)));
  // map_reac_to_prod via atom map numbers (graph_features.py:83-103)
  std::map<int, int> prod_map_to_id;
  for (size_t i = 0; i < prod.atoms.size(); ++i)
    prod_map_to_id[prod.atoms[i].map_num] = static_cast<int>(i);
  int n = static_cast<int>(reac.atoms.size());
  std::vector<int> ri2pi(n);
  for (int i = 0; i < n; ++i) {
    auto it = prod_map_to_id.find(reac.atoms[i].map_num);
    if (it == prod_map_to_id.end())
      fail("reactant atom map number missing in product");
    ri2pi[i] = it->second;
  }

  Graph g;
  g.n_atoms = n;
  g.atom_fdim = 2 * ATOM_FDIM;
  g.bond_fdim = 2 * BOND_FDIM;
  g.node_feats.resize(n * g.atom_fdim);
  for (int i = 0; i < n; ++i) {
    float fr[ATOM_FDIM], fp[ATOM_FDIM];
    atom_features(reac, i, fr);
    atom_features(prod, ri2pi[i], fp);
    float* row = g.node_feats.data() + i * g.atom_fdim;
    for (int k = 0; k < ATOM_FDIM; ++k) {
      row[k] = fr[k];
      row[ATOM_FDIM + k] = fp[k] - fr[k];
    }
  }
  for (int a1 = 0; a1 < n; ++a1)
    for (int a2 = a1 + 1; a2 < n; ++a2) {
      int br = reac.bond_between(a1, a2);
      int bp = prod.bond_between(ri2pi[a1], ri2pi[a2]);
      if (br < 0 && bp < 0) continue;
      float fbr[BOND_FDIM], fbp[BOND_FDIM], fb[2 * BOND_FDIM];
      bond_features(br >= 0 ? &reac : nullptr, br, fbr);
      bond_features(bp >= 0 ? &prod : nullptr, bp, fbp);
      for (int k = 0; k < BOND_FDIM; ++k) {
        fb[k] = fbr[k];
        fb[BOND_FDIM + k] = fbp[k] - fbr[k];
      }
      for (int r = 0; r < 2; ++r)
        g.edge_feats.insert(g.edge_feats.end(), fb, fb + 2 * BOND_FDIM);
      g.senders.push_back(a1);
      g.receivers.push_back(a2);
      g.senders.push_back(a2);
      g.receivers.push_back(a1);
    }
  g.n_edges = static_cast<int>(g.senders.size());
  return g;
}

thread_local std::string g_last_error;

}  // namespace

// ------------------------------------------------------------------- C ABI
extern "C" {

const char* cgr_last_error() { return g_last_error.c_str(); }

void cgr_set_error(const char* msg) { g_last_error = msg; }

// Returns an opaque graph handle or nullptr (check cgr_last_error()).
void* cgr_graph_new(const char* smiles, int is_rxn) {
  try {
    auto* g = new Graph(is_rxn ? build_rxn_graph(smiles)
                               : build_mol_graph(smiles));
    return g;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return nullptr;
  }
}

int cgr_graph_num_atoms(void* h) { return static_cast<Graph*>(h)->n_atoms; }
int cgr_graph_num_edges(void* h) { return static_cast<Graph*>(h)->n_edges; }
int cgr_graph_atom_fdim(void* h) { return static_cast<Graph*>(h)->atom_fdim; }
int cgr_graph_bond_fdim(void* h) { return static_cast<Graph*>(h)->bond_fdim; }

// Copy out into caller-allocated buffers (numpy arrays).
void cgr_graph_copy(void* h, float* node_feats, float* edge_feats,
                    int32_t* senders, int32_t* receivers) {
  Graph* g = static_cast<Graph*>(h);
  std::memcpy(node_feats, g->node_feats.data(),
              g->node_feats.size() * sizeof(float));
  std::memcpy(edge_feats, g->edge_feats.data(),
              g->edge_feats.size() * sizeof(float));
  std::memcpy(senders, g->senders.data(), g->senders.size() * sizeof(int32_t));
  std::memcpy(receivers, g->receivers.data(),
              g->receivers.size() * sizeof(int32_t));
}

void cgr_graph_free(void* h) { delete static_cast<Graph*>(h); }

}  // extern "C"
