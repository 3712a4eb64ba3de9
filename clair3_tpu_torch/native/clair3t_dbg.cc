// De Bruijn graph consensus haplotypes — native counterpart of
// clair3_tpu_torch/realign/dbg.py (itself a clean-room re-design of the
// reference's DeepVariant-derived preprocess/realign/debruijn_graph.cpp,
// which used boost::adjacency_list).  K-mers are 2-bit packed into
// uint64 (k <= 31), so the graph is hash maps over integers instead of
// strings.  Output must stay set-identical to the Python implementation
// (enforced by differential tests).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr char kBases[4] = {'A', 'C', 'G', 'T'};

inline int base_code(char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

using EdgeMap = std::unordered_map<uint64_t, std::unordered_map<uint64_t, int>>;

// add k-mer transition edges of `seq` with `weight`; transitions touching a
// non-ACGT base are skipped (dbg.py:_kmer_edges skips k-mers containing N)
void add_edges(const std::string& seq, int k, int weight, EdgeMap* edges) {
  int n = (int)seq.size();
  if (n < k + 1) return;
  uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t kmer = 0;
  int valid = 0;  // number of consecutive valid bases ending at i
  for (int i = 0; i < n; i++) {
    int c = base_code(seq[i]);
    if (c < 0) {
      valid = 0;
      kmer = 0;
      continue;
    }
    kmer = ((kmer << 2) | (uint64_t)c) & mask;
    valid++;
    // edge u(i-k .. i-1) -> v(i-k+1 .. i) needs k+1 valid bases ending at i
    if (valid >= k + 1) {
      uint64_t v = kmer;
      uint64_t u = 0;
      // u = previous k-mer: drop the newest base, restore the evicted one
      int c0 = base_code(seq[i - k]);
      u = ((uint64_t)c0 << (2 * (k - 1))) | (v >> 2);
      (*edges)[u][v] += weight;
    }
  }
}

bool encode_kmer(const char* s, int k, uint64_t* out) {
  uint64_t v = 0;
  for (int i = 0; i < k; i++) {
    int c = base_code(s[i]);
    if (c < 0) return false;
    v = (v << 2) | (uint64_t)c;
  }
  *out = v;
  return true;
}

// DFS cycle check over the subgraph reachable from source (dbg.py:28-55)
bool is_acyclic_from(uint64_t source, const EdgeMap& edges) {
  enum : uint8_t { WHITE = 0, GRAY = 1, BLACK = 2 };
  std::unordered_map<uint64_t, uint8_t> color;
  std::unordered_map<uint64_t, std::vector<uint64_t>> iters;
  std::vector<uint64_t> stack{source};
  while (!stack.empty()) {
    uint64_t node = stack.back();
    auto& col = color[node];
    if (col == WHITE) {
      col = GRAY;
      auto it = edges.find(node);
      auto& vec = iters[node];
      if (it != edges.end())
        for (const auto& kv : it->second) vec.push_back(kv.first);
    }
    bool advanced = false;
    auto& vec = iters[node];
    while (!vec.empty()) {
      uint64_t cand = vec.back();
      vec.pop_back();
      uint8_t cc = color[cand];
      if (cc == GRAY) return false;
      if (cc == WHITE) {
        stack.push_back(cand);
        advanced = true;
        break;
      }
    }
    if (!advanced) {
      color[node] = BLACK;
      stack.pop_back();
    }
  }
  return true;
}

}  // namespace

extern "C" {

struct DbgOut {
  char* haps;      // '\n'-joined haplotype sequences
  int32_t n_haps;
  int32_t error;   // 1 = unsupported k (caller should use the Python path)
};

// Consensus haplotypes over `ref_window` from window reads (dbg.py:58-115).
DbgOut* clair3t_dbg(const char** reads, int32_t n_reads,
                    const char* ref_window_c,
                    const int32_t* k_range, int32_t n_k,
                    int32_t min_edge_weight, int32_t max_haplotypes) {
  DbgOut* out = (DbgOut*)calloc(1, sizeof(DbgOut));
  std::string ref_window(ref_window_c);
  std::vector<std::string> haplotypes;

  for (int ki = 0; ki < n_k; ki++) {
    int k = k_range[ki];
    if (k < 1 || k > 31) {  // 2-bit packing bound; Python handles any k
      out->error = 1;
      return out;
    }
    if ((int)ref_window.size() <= k) break;

    EdgeMap edges;
    add_edges(ref_window, k, min_edge_weight, &edges);
    for (int i = 0; i < n_reads; i++)
      add_edges(std::string(reads[i]), k, 1, &edges);

    // prune low-support edges
    EdgeMap pruned;
    for (auto& ue : edges) {
      std::unordered_map<uint64_t, int> kept;
      for (auto& ve : ue.second)
        if (ve.second >= min_edge_weight) kept.emplace(ve);
      if (!kept.empty()) pruned.emplace(ue.first, std::move(kept));
    }

    uint64_t source, sink;
    if (!encode_kmer(ref_window.data(), k, &source) ||
        !encode_kmer(ref_window.data() + ref_window.size() - k, k, &sink))
      break;  // N in the anchor k-mers
    if (!is_acyclic_from(source, pruned)) continue;

    // enumerate source->sink paths, bounded in length and count
    haplotypes.clear();
    size_t max_len = ref_window.size() + 64;
    std::vector<std::pair<uint64_t, std::string>> stack;
    stack.emplace_back(source, ref_window.substr(0, k));
    bool truncated = false;
    while (!stack.empty()) {
      auto [node, seq] = std::move(stack.back());
      stack.pop_back();
      if (seq.size() > max_len) continue;
      if (node == sink) {
        haplotypes.push_back(std::move(seq));
        if ((int)haplotypes.size() >= max_haplotypes) {
          truncated = true;
          break;
        }
        continue;
      }
      auto it = pruned.find(node);
      if (it == pruned.end()) continue;
      for (const auto& ve : it->second)
        stack.emplace_back(ve.first, seq + kBases[ve.first & 3]);
    }
    if (truncated) continue;  // too tangled at this k; try larger

    bool have_ref = false;
    for (const auto& h : haplotypes)
      if (h == ref_window) { have_ref = true; break; }
    if (!have_ref) haplotypes.push_back(ref_window);
    goto done;
  }
  haplotypes.assign(1, ref_window);

done:
  size_t total = 0;
  for (const auto& h : haplotypes) total += h.size() + 1;
  out->haps = (char*)malloc(total ? total : 1);
  char* p = out->haps;
  for (size_t i = 0; i < haplotypes.size(); i++) {
    memcpy(p, haplotypes[i].data(), haplotypes[i].size());
    p += haplotypes[i].size();
    *p++ = (i + 1 < haplotypes.size()) ? '\n' : '\0';
  }
  if (haplotypes.empty()) out->haps[0] = '\0';
  out->n_haps = (int32_t)haplotypes.size();
  return out;
}

void clair3t_dbg_free(DbgOut* out) {
  if (!out) return;
  free(out->haps);
  free(out);
}

}  // extern "C"
