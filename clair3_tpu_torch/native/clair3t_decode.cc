// Native decode core: network head probabilities -> VCF row strings.
//
// Byte-identical C++ port of clair3_tpu_torch/decode/decoder.py (itself a
// behavioral port of the reference clair3/CallVariants.py:375-1454:
// possible_outcome_probabilites_from / output_from / output_with /
// compute_PL).  The Python decoder remains the oracle; differential fuzz
// tests in tests/test_native_decode.py enforce byte equality.
//
// Fidelity notes (each mirrors a CPython/numpy semantic):
//  * dict iteration order == insertion order -> ordered vectors here.
//  * sorted(...) is stable; `sorted(..)[::-1]` reverses ties -> stable_sort
//    ascending then reverse.
//  * np.argmax picks the FIRST maximum (strict > scan).
//  * round(x, 2) == snprintf("%.2f") + strtod (both round-half-even on the
//    exact binary value via correctly-rounded dtoa).
//  * float equality between family maxima decides the outcome flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

const double PHRED = -10.0 * std::log10(M_E);
const int VL_OFF = 16;
const int VL_MAX = 16;

// ---- label tables (task/labels.py) ----
enum GT21 {
  AA = 0, AC, AG, AT, CC, CG, CT, GG, GT_, TT,
  DelDel, ADel, CDel, GDel, TDel,
  InsIns, AIns, CIns, GIns, TIns,
  InsDel
};
const char* GT21_LABELS[21] = {
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DelDel", "ADel", "CDel", "GDel", "TDel",
    "InsIns", "AIns", "CIns", "GIns", "TIns",
    "InsDel"};
const int HOMO_SNP_GT21[4] = {AA, CC, GG, TT};
const int HETERO_SNP_GT21[6] = {AC, AG, AT, CG, CT, GT_};
const char* HOMO_SNP_LABELS[4] = {"AA", "CC", "GG", "TT"};
const char* HETERO_SNP_LABELS[6] = {"AC", "AG", "AT", "CG", "CT", "GT"};
const int INS_GT21_IDX[4] = {AIns, CIns, GIns, TIns};
const int DEL_GT21_IDX[4] = {ADel, CDel, GDel, TDel};
const char ACGT[5] = "ACGT";

enum Zygosity { homo_reference = 0, homo_variant = 1, hetero_variant = 2,
                hetero_variant_multi = 3 };
const char* GENOTYPES[4] = {"0/0", "1/1", "0/1", "1/2"};

int gt21_enum_from_label(const std::string& label) {
  for (int i = 0; i < 21; i++)
    if (label == GT21_LABELS[i]) return i;
  return -1;  // KeyError
}

char iupac_to_acgt(char c) {
  switch (c) {
    case 'A': return 'A'; case 'C': return 'C'; case 'G': return 'G';
    case 'T': return 'T'; case 'U': return 'T'; case 'R': return 'A';
    case 'Y': return 'C'; case 'S': return 'C'; case 'W': return 'A';
    case 'K': return 'G'; case 'M': return 'A'; case 'B': return 'C';
    case 'D': return 'A'; case 'H': return 'A'; case 'V': return 'A';
    case 'N': return 'A';
    default: return 0;  // KeyError in Python; callers guarantee IUPAC input
  }
}

// utils/common.py convert_iupac_to_n: non-ACGTN (upper) -> 'N'; "." verbatim.
std::string convert_iupac_to_n(const std::string& s) {
  if (s == ".") return s;
  std::string out = s;
  for (auto& c : out) {
    char u = (char)std::toupper((unsigned char)c);
    if (u != 'A' && u != 'C' && u != 'G' && u != 'T' && u != 'N' &&
        u != ',' && u != '.')
      c = 'N';
  }
  return out;
}

// partial_label_from / mix_two_partial_labels (task/labels.py:70-92)
std::string partial_label_from(const std::string& ref, const std::string& alt) {
  if (ref.size() > alt.size()) return "Del";
  if (ref.size() < alt.size()) return "Ins";
  return std::string(1, alt[0]);
}

std::string mix_two_partial_labels(const std::string& l1, const std::string& l2) {
  if (l1.size() == 1 && l2.size() == 1)
    return l1 <= l2 ? l1 + l2 : l2 + l1;
  std::string a = l1, b = l2;
  if (l1.size() > 1 && l2.size() == 1) { a = l2; b = l1; }
  if (b.size() > 1 && a.size() == 1) return a + b;
  if (!l1.empty() && !l2.empty() && l1 == l2) return l1 + l2;
  return "InsDel";
}

int genotype_enum_from(int g1, int g2) {
  if (g1 == 0 && g2 == 0) return homo_reference;
  if (g1 == g2) return homo_variant;
  if (g1 != 0 && g2 != 0) return hetero_variant_multi;
  return hetero_variant;
}

int genotype_enum_for_task(int g) {
  return g == hetero_variant_multi ? hetero_variant : g;
}

// Python round(x, 2): correctly-rounded 2-decimal conversion and back.
double py_round2(double x) {
  char buf[64];
  snprintf(buf, sizeof buf, "%.2f", x);
  return strtod(buf, nullptr);
}

double quality_score_from(double p) {
  double tmp = PHRED * std::log(((1.0 - p) + 1e-10) / (p + 1e-10)) + 10.0;
  if (tmp < 0) tmp = 0;
  return py_round2(tmp);
}

// ---- alt-info parsing (insertion-ordered dict) ----
struct AltDict {
  std::vector<std::pair<std::string, long long>> items;  // insertion order
  void put(const std::string& k, long long v) {
    for (auto& it : items)
      if (it.first == k) { it.second = v; return; }  // dict: update in place
    items.emplace_back(k, v);
  }
};

// 'depth-Xa n Ic.. n Dc.. n Rr n ' -> (read_depth, ordered dict)
bool parse_alt_info(const std::string& alt_info, long long* read_depth,
                    AltDict* dict) {
  // rstrip
  size_t end = alt_info.size();
  while (end > 0 && std::isspace((unsigned char)alt_info[end - 1])) end--;
  std::string s = alt_info.substr(0, end);
  size_t dash = s.find('-');
  std::string depth_part = dash == std::string::npos ? s : s.substr(0, dash);
  std::string indel_str =
      dash == std::string::npos ? "" : s.substr(dash + 1, s.find('-', dash + 1) == std::string::npos
                                                    ? std::string::npos
                                                    : s.find('-', dash + 1) - dash - 1);
  // Python: parts = s.split("-"); parts[1] if len>1 else ""
  // (split on every '-'; deletion keys never contain '-')
  char* endp = nullptr;
  *read_depth = strtoll(depth_part.c_str(), &endp, 10);
  if (endp == depth_part.c_str()) return false;
  // tokenize indel_str by single spaces, pairwise key/value
  std::vector<std::string> seqs;
  {
    std::string cur;
    for (char c : indel_str) {
      if (c == ' ') { seqs.push_back(cur); cur.clear(); }
      else cur.push_back(c);
    }
    seqs.push_back(cur);
  }
  if (!seqs.empty() && !seqs[0].empty()) {
    for (size_t i = 0; i + 1 < seqs.size(); i += 2)
      dict->put(seqs[i], strtoll(seqs[i + 1].c_str(), nullptr, 10));
  }
  return true;
}

// ---- indel base recovery (decoder.py:96-173) ----
// max(d, key=d.get): first key with maximal value, insertion order.
static std::string first_max_key(
    const std::vector<std::pair<std::string, long long>>& d) {
  size_t best = 0;
  for (size_t i = 1; i < d.size(); i++)
    if (d[i].second > d[best].second) best = i;
  return d[best].first;
}

// sorted(items, key=count)[::-1]: stable ascending by count, then reversed.
static std::vector<std::pair<std::string, long long>> sorted_desc_rev(
    std::vector<std::pair<std::string, long long>> v) {
  std::stable_sort(v.begin(), v.end(),
                   [](const auto& a, const auto& b) { return a.second < b.second; });
  std::reverse(v.begin(), v.end());
  return v;
}

struct MultiOrOne {
  std::vector<std::string> multi;  // used when return_multi
  std::string one;                 // used otherwise
};

MultiOrOne insertion_bases_from(const AltDict& alt, long long propose_len,
                                long long min_len, long long max_len,
                                const std::string& ignore, bool return_multi) {
  MultiOrOne out;
  if (propose_len) propose_len += 1;  // include anchor base
  if (alt.items.empty()) return out;
  std::vector<std::pair<std::string, long long>> bases, proposed;
  for (const auto& it : alt.items) {
    if (it.first.empty() || it.first[0] != 'I') continue;
    std::string key = it.first.substr(1);
    if (propose_len && (long long)key.size() == propose_len && key != ignore)
      proposed.emplace_back(key, it.second);
    else if ((long long)key.size() >= min_len && (long long)key.size() <= max_len &&
             key != ignore)
      bases.emplace_back(key, it.second);
  }
  if (propose_len && !proposed.empty()) {
    out.one = first_max_key(proposed);
    return out;
  }
  if (return_multi) {
    auto ordered = sorted_desc_rev(bases);
    for (size_t i = 0; i < ordered.size() && i < 2; i++)
      out.multi.push_back(ordered[i].first);
    return out;  // may be 0, 1, or 2 entries (Python "" -> empty)
  }
  if (!bases.empty()) out.one = first_max_key(bases);
  return out;
}

MultiOrOne deletion_bases_from(const AltDict& alt, long long propose_len,
                               long long min_len, long long max_len,
                               const std::string& ignore, bool return_multi) {
  MultiOrOne out;
  if (alt.items.empty()) return out;
  std::vector<std::pair<std::string, long long>> bases, proposed;
  for (const auto& it : alt.items) {
    if (it.first.empty() || it.first[0] != 'D') continue;
    std::string key = it.first.substr(1);
    if (propose_len && (long long)key.size() == propose_len && key != ignore)
      proposed.emplace_back(key, it.second);
    else if ((long long)key.size() >= min_len && (long long)key.size() <= max_len &&
             key != ignore)
      bases.emplace_back(key, it.second);
  }
  if (propose_len && !proposed.empty()) {
    out.one = first_max_key(proposed);
    return out;
  }
  if (return_multi) {
    auto ordered = sorted_desc_rev(bases);
    if (ordered.size() <= 1) return out;  // Python returns "" (empty)
    if (ordered[0].first.size() > ordered[1].first.size()) {
      out.multi = {ordered[0].first, ordered[1].first};
    } else {
      out.multi = {ordered[1].first, ordered[0].first};
    }
    return out;
  }
  if (!bases.empty()) out.one = first_max_key(bases);
  return out;
}

// find_alt_base (decoder.py:159-173): returns (sorted X bases desc, chosen)
void find_alt_base(const AltDict& alt, const std::string& alternate_in,
                   bool has_alt_in, std::vector<std::string>* sorted_bases,
                   std::string* alternate_out, bool* has_alt_out) {
  const long long max_depth_gap = 9;
  std::vector<std::pair<std::string, long long>> xs;
  for (const auto& it : alt.items)
    if (!it.first.empty() && it.first[0] == 'X' && it.first.size() >= 2)
      xs.emplace_back(std::string(1, it.first[1]), it.second);
  // sorted(key=count, reverse=True): stable desc keeps insertion order on ties
  std::stable_sort(xs.begin(), xs.end(),
                   [](const auto& a, const auto& b) { return a.second > b.second; });
  std::string alternate = alternate_in;
  bool has_alt = has_alt_in;
  long long my_count = -1;
  bool found = false;
  if (has_alt) {
    for (const auto& x : xs)
      if (x.first == alternate) { my_count = x.second; found = true; break; }
  }
  sorted_bases->clear();
  if (xs.empty()) {
    *has_alt_out = false;  // Python returns ([], None)
    alternate_out->clear();
    return;
  }
  if (!found || xs[0].second - my_count >= max_depth_gap) {
    alternate = xs[0].first;
    has_alt = true;
  }
  for (const auto& x : xs) sorted_bases->push_back(x.first);
  *alternate_out = alternate;
  *has_alt_out = has_alt;
}

// ---- config ----
struct Config {
  bool add_indel_length;
  bool pileup;
  bool show_ref_calls;
  bool gvcf;
  bool has_qual_pass;
  double qual_pass;
  bool haploid_precise;
  bool haploid_sensitive;
  bool enable_long_indel;
  long long max_infer;
  bool keep_iupac;
  bool cal_precise_long_indel_af;
  double long_indel_distance_proportion;
  long long max_infer_default;
};

// get_long_indel_read_count (decoder.py:176-200)
long long long_indel_read_count(
    const std::vector<std::pair<std::string, long long>>& alt_map,
    const Config& cfg, const std::string& proposed_ins_base,
    long long propose_del_len, bool is_del) {
  long long count = 0;
  long long max_infer = cfg.max_infer_default;
  if (!cfg.cal_precise_long_indel_af &&
      ((long long)proposed_ins_base.size() > max_infer ||
       propose_del_len > max_infer)) {
    long long length =
        is_del ? propose_del_len : (long long)proposed_ins_base.size() - 1;
    double lo = std::max((double)length * (1.0 - cfg.long_indel_distance_proportion),
                         (double)max_infer);
    double hi = (double)length * (1.0 + cfg.long_indel_distance_proportion);
    for (const auto& it : alt_map) {
      if (is_del && (long long)it.first.size() == propose_del_len) continue;
      if (it.first == proposed_ins_base) continue;
      double n = (double)it.first.size();
      if (lo <= n && n <= hi) count += it.second;
    }
  }
  return count;
}

// ---- outcome enumeration + fallback selection ----
// static pair tables (decoder.py:207-222)
struct PairTables {
  std::vector<std::pair<int, int>> insins;       // (i, j) i<=j, 1..16
  std::vector<std::pair<int, int>> deldel_raw;   // excl i==j except (16,16)
  std::vector<std::pair<int, int>> deldel;       // sorted variant of raw
  std::vector<std::pair<int, int>> insdel;       // all (i, j)
  PairTables() {
    for (int i = 1; i <= VL_MAX; i++)
      for (int j = i; j <= VL_MAX; j++) insins.emplace_back(i, j);
    for (int i = 1; i <= VL_MAX; i++)
      for (int j = 1; j <= VL_MAX; j++)
        if (!(i == j && i != VL_OFF && j != VL_OFF)) {
          deldel_raw.emplace_back(i, j);
          deldel.emplace_back(std::min(i, j), std::max(i, j));
        }
    for (int i = 1; i <= VL_MAX; i++)
      for (int j = 1; j <= VL_MAX; j++) insdel.emplace_back(i, j);
  }
};
const PairTables PT;

int argmax_first(const std::vector<double>& v) {
  int best = 0;
  for (size_t i = 1; i < v.size(); i++)
    if (v[i] > v[best]) best = (int)i;
  return best;
}

double vmax(const std::vector<double>& v) {
  if (v.empty()) return 0.0;
  double m = v[0];
  for (double x : v) m = std::max(m, x);
  return m;
}

struct Outcomes {
  bool ref_only = false;
  double homo_ref = 0.0;
  std::vector<double> homo_snp, hetero_snp;
  std::vector<double> homo_ins, het_insins, het_acgt_ins;
  std::vector<double> homo_del, het_deldel, het_acgt_del;
  std::vector<double> het_insdel;
};

void enumerate_outcomes(const double* gt21, const double* genotype,
                        const double* vl1, const double* vl2,
                        char reference_base, bool add_indel_length,
                        Outcomes* o) {
  double p_ref = genotype[homo_reference];
  double p_hom = genotype[homo_variant];
  double p_het = genotype[hetero_variant];
  char rb[3] = {reference_base, reference_base, 0};
  int ref_gt21 = gt21_enum_from_label(rb);

  if (!add_indel_length) {
    o->homo_ref = p_ref * gt21[ref_gt21];
    if (p_ref >= 0.5 && gt21[ref_gt21] >= 0.5) { o->ref_only = true; return; }
    for (int g : HOMO_SNP_GT21) o->homo_snp.push_back(p_hom * gt21[g]);
    for (int g : HETERO_SNP_GT21) o->hetero_snp.push_back(p_het * gt21[g]);
    o->homo_ins.push_back(p_hom * gt21[InsIns]);
    o->het_insins.push_back(p_het * gt21[InsIns]);
    for (int g : INS_GT21_IDX) o->het_acgt_ins.push_back(gt21[g] * p_het);
    o->homo_del.push_back(p_hom * gt21[DelDel]);
    o->het_deldel.push_back(p_het * gt21[DelDel]);
    for (int g : DEL_GT21_IDX) o->het_acgt_del.push_back(gt21[g] * p_het);
    o->het_insdel.push_back(p_het * gt21[InsDel]);
    return;
  }

  double vl0_1 = vl1[VL_OFF];
  double vl0_2 = vl2[VL_OFF];
  double vl0 = vl0_1 * vl0_2;
  o->homo_ref = (vl0 * p_ref) * gt21[ref_gt21];
  if (vl0_1 >= 0.5 && vl0_2 >= 0.5 && p_ref >= 0.5 && gt21[ref_gt21] >= 0.5) {
    o->ref_only = true;
    return;
  }
  for (int g : HOMO_SNP_GT21) o->homo_snp.push_back((vl0 * p_hom) * gt21[g]);
  for (int g : HETERO_SNP_GT21) o->hetero_snp.push_back((vl0 * p_het) * gt21[g]);

  // v1p[i] = vl1[VL_OFF + 1 + i], v1n[i] = vl1[VL_OFF - 1 - i]  (i: 0..15)
  auto v1p = [&](int i) { return vl1[VL_OFF + 1 + i]; };
  auto v2p = [&](int i) { return vl2[VL_OFF + 1 + i]; };
  auto v1n = [&](int i) { return vl1[VL_OFF - 1 - i]; };
  auto v2n = [&](int i) { return vl2[VL_OFF - 1 - i]; };

  {
    double c = p_hom * gt21[InsIns];
    for (int i = 0; i < VL_MAX; i++) o->homo_ins.push_back((v1p(i) * v2p(i)) * c);
  }
  {
    double c = p_het * gt21[InsIns];
    for (const auto& p : PT.insins)
      o->het_insins.push_back((v1p(p.first - 1) * v2p(p.second - 1)) * c);
  }
  {
    // ((vl1[VL_OFF] * v2p[l]) * gt21[idx_b]) * p_het — grouping matches the
    // reference (CallVariants.py:600-607) for bitwise float parity
    for (int l = 0; l < VL_MAX; l++) {
      double a = vl1[VL_OFF] * v2p(l);
      for (int b = 0; b < 4; b++)
        o->het_acgt_ins.push_back((a * gt21[INS_GT21_IDX[b]]) * p_het);
    }
  }
  {
    double c = p_hom * gt21[DelDel];
    for (int i = 0; i < VL_MAX; i++) o->homo_del.push_back((v1n(i) * v2n(i)) * c);
  }
  {
    double c = p_het * gt21[DelDel];
    for (const auto& p : PT.deldel_raw)
      o->het_deldel.push_back((v1n(p.first - 1) * v2n(p.second - 1)) * c);
  }
  {
    for (int l = 0; l < VL_MAX; l++) {
      double a = v1n(l) * vl2[VL_OFF];
      for (int b = 0; b < 4; b++)
        o->het_acgt_del.push_back((a * gt21[DEL_GT21_IDX[b]]) * p_het);
    }
  }
  {
    double c = p_het * gt21[InsDel];
    for (int i = 0; i < VL_MAX; i++)
      for (int j = 0; j < VL_MAX; j++)
        o->het_insdel.push_back((v1n(i) * v2p(j)) * c);
  }
}

struct Selection {
  // flags (decoder.py:318,370-375)
  bool is_reference = false, is_homo_SNP = false, is_hetero_SNP = false;
  bool is_homo_insertion = false, is_hetero_ACGT_Ins = false,
       is_hetero_InsIns = false;
  bool is_homo_deletion = false, is_hetero_ACGT_Del = false,
       is_hetero_DelDel = false;
  bool is_insertion_and_deletion = false;
  std::string reference_base, alternate_base;
  bool ok = false;  // reference_base/alternate_base valid
  double probability = 0.0;
};

void select_output(const std::string& reference_sequence, int center,
                   const double* gt21, const double* genotype,
                   const double* vl1, const double* vl2, const AltDict& alt,
                   const Config& cfg, Selection* sel) {
  bool add_indel_length = cfg.add_indel_length;
  char center_base = reference_sequence[center];
  char reference_base_acgt = iupac_to_acgt(center_base);
  Outcomes o;
  enumerate_outcomes(gt21, genotype, vl1, vl2, reference_base_acgt,
                     add_indel_length, &o);
  if (o.ref_only) {
    sel->is_reference = true;
    sel->reference_base = std::string(1, reference_base_acgt);
    sel->alternate_base = std::string(1, reference_base_acgt);
    sel->probability = o.homo_ref;
    sel->ok = true;
    return;
  }

  long long max_infer = cfg.max_infer;
  // reference quirk preserved (CallVariants.py:722-1012): reference_base /
  // alternate_base are LOOP STATE that is never reset — a failure `continue`
  // after a branch assigned both terminates the loop with that partial
  // (single-alt) result, because the while condition sees them set.
  bool have_ref = false, have_alt = false;
  std::string reference_base, alternate_base;
  double maximum_probability = 0.0;

  while (!have_ref || !have_alt) {
    double m_homo_snp = vmax(o.homo_snp), m_het_snp = vmax(o.hetero_snp);
    double m_homo_ins = vmax(o.homo_ins), m_homo_del = vmax(o.homo_del);
    double m_acgt_ins = vmax(o.het_acgt_ins), m_insins = vmax(o.het_insins);
    double m_acgt_del = vmax(o.het_acgt_del), m_deldel = vmax(o.het_deldel);
    double m_insdel = vmax(o.het_insdel);
    maximum_probability = o.homo_ref;
    for (double v : {m_homo_snp, m_het_snp, m_homo_ins, m_homo_del, m_acgt_ins,
                     m_insins, m_acgt_del, m_deldel, m_insdel})
      maximum_probability = std::max(maximum_probability, v);

    if (maximum_probability == o.homo_ref) {
      *sel = Selection{};  // clear flags assigned by earlier iterations
      sel->is_reference = true;
      sel->reference_base = std::string(1, reference_base_acgt);
      sel->alternate_base = std::string(1, reference_base_acgt);
      sel->probability = maximum_probability;
      sel->ok = true;
      return;
    }

    bool is_homo_SNP = maximum_probability == m_homo_snp;
    bool is_hetero_SNP = maximum_probability == m_het_snp;
    bool is_homo_insertion = maximum_probability == m_homo_ins;
    bool is_hetero_ACGT_Ins = maximum_probability == m_acgt_ins;
    bool is_hetero_InsIns = maximum_probability == m_insins;
    bool is_homo_deletion = maximum_probability == m_homo_del;
    bool is_hetero_ACGT_Del = maximum_probability == m_acgt_del;
    bool is_hetero_DelDel = maximum_probability == m_deldel;
    bool is_insertion_and_deletion = maximum_probability == m_insdel;
    sel->is_reference = false;
    sel->is_homo_SNP = is_homo_SNP;
    sel->is_hetero_SNP = is_hetero_SNP;
    sel->is_homo_insertion = is_homo_insertion;
    sel->is_hetero_ACGT_Ins = is_hetero_ACGT_Ins;
    sel->is_hetero_InsIns = is_hetero_InsIns;
    sel->is_homo_deletion = is_homo_deletion;
    sel->is_hetero_ACGT_Del = is_hetero_ACGT_Del;
    sel->is_hetero_DelDel = is_hetero_DelDel;
    sel->is_insertion_and_deletion = is_insertion_and_deletion;

    if (is_homo_SNP) {
      int idx = argmax_first(o.homo_snp);
      reference_base = std::string(1, reference_sequence[center]);
      have_ref = true;
      const char* bases = HOMO_SNP_LABELS[idx];
      std::string alt_b(1, bases[0] != reference_base[0] ? bases[0] : bases[1]);
      std::vector<std::string> sb;
      bool has;
      find_alt_base(alt, alt_b, true, &sb, &alt_b, &has);
      // alternate_base is reassigned even when find_alt_base returned None
      have_alt = has;
      if (has) alternate_base = alt_b;
      if (!has || alt_b == reference_base) {
        o.homo_snp[idx] = 0;
        continue;
      }

    } else if (is_hetero_SNP) {
      int idx = argmax_first(o.hetero_snp);
      const char* bases = HETERO_SNP_LABELS[idx];
      char base1 = bases[0], base2 = bases[1];
      reference_base = std::string(1, reference_sequence[center]);
      have_ref = true;
      if (base1 != reference_base[0] && base2 != reference_base[0]) {
        std::vector<std::string> sb;
        std::string dummy;
        bool has;
        find_alt_base(alt, "", false, &sb, &dummy, &has);
        if (sb.size() < 2) {
          o.hetero_snp[idx] = 0;
          continue;
        }
        alternate_base = sb[0] + "," + sb[1];
        have_alt = true;
      } else {
        std::string alt_b(1, base1 != reference_base[0] ? base1 : base2);
        std::vector<std::string> sb;
        bool has;
        find_alt_base(alt, alt_b, true, &sb, &alt_b, &has);
        have_alt = has;
        if (has) alternate_base = alt_b;
        if (!has || alt_b == reference_base) {
          o.hetero_snp[idx] = 0;
          continue;
        }
      }

    } else if (is_homo_insertion) {
      int idx = argmax_first(o.homo_ins);
      long long variant_length = add_indel_length ? idx + 1 : 0;
      long long propose =
          (variant_length && variant_length < VL_MAX) ? variant_length : 0;
      auto r = insertion_bases_from(alt, propose, 1, max_infer, "", false);
      if (r.one.empty()) {
        o.homo_ins[idx] = 0;
        continue;
      }
      reference_base = std::string(1, reference_sequence[center]);
      alternate_base = r.one;
      have_ref = have_alt = true;

    } else if (is_hetero_ACGT_Ins) {  // NOLINT
      int idx = argmax_first(o.het_acgt_ins);
      char hetero_ins_base;
      long long variant_length;
      if (add_indel_length) {
        hetero_ins_base = ACGT[idx % 4];  // length-major ravel: base inner
        variant_length = idx / 4 + 1;
      } else {
        hetero_ins_base = ACGT[idx];
        variant_length = 0;
      }
      long long propose =
          (variant_length && variant_length < VL_MAX) ? variant_length : 0;
      auto r = insertion_bases_from(alt, propose, 1, max_infer, "", false);
      if (r.one.empty()) {
        o.het_acgt_ins[idx] = 0;
        continue;
      }
      reference_base = std::string(1, reference_sequence[center]);
      alternate_base = r.one;
      have_ref = have_alt = true;
      if (hetero_ins_base != reference_base[0]) {
        std::vector<std::string> sb;
        std::string dummy;
        bool has;
        find_alt_base(alt, "", false, &sb, &dummy, &has);
        if (sb.empty()) {
          // quirk: ref/alt already set -> loop exits with single-ins result
          o.het_acgt_ins[idx] = 0;
          continue;
        }
        alternate_base = sb[0] + "," + alternate_base;
      }

    } else if (is_hetero_InsIns) {
      int idx = argmax_first(o.het_insins);
      std::vector<std::string> ins_list;
      if (add_indel_length) {
        int vlen1 = PT.insins[idx].first, vlen2 = PT.insins[idx].second;
        long long p1 = (vlen1 && vlen1 < VL_MAX) ? vlen1 : 0;
        auto r1 = insertion_bases_from(alt, p1, 1, max_infer, "", false);
        if (!r1.one.empty()) {
          long long p2 = (vlen2 && vlen2 < VL_MAX) ? vlen2 : 0;
          auto r2 = insertion_bases_from(alt, p2, 1, max_infer, r1.one, false);
          if (!r2.one.empty()) ins_list = {r1.one, r2.one};
        }
        if (ins_list.size() < 2) {
          auto rm = insertion_bases_from(alt, 0, 1, max_infer, "", true);
          ins_list = rm.multi;
        }
      } else {
        auto rm = insertion_bases_from(alt, 0, 1, max_infer, "", true);
        ins_list = rm.multi;
      }
      if (ins_list.size() < 2) {
        o.het_insins[idx] = 0;
        continue;
      }
      const std::string& insertion_bases = ins_list[0];
      const std::string& another = ins_list[1];
      reference_base = std::string(1, reference_sequence[center]);
      alternate_base = insertion_bases;
      have_ref = have_alt = true;
      if (another != insertion_bases) {
        alternate_base = another + "," + insertion_bases;
      } else {
        // quirk: alternate_base stays the single insertion -> loop exits
        o.het_insins[idx] = 0;
        continue;
      }

    } else if (is_homo_deletion) {
      int idx = argmax_first(o.homo_del);
      long long variant_length = add_indel_length ? idx + 1 : 0;
      long long propose =
          (variant_length && variant_length < VL_MAX) ? variant_length : 0;
      auto r = deletion_bases_from(alt, propose, 1, max_infer, "", false);
      if (r.one.empty()) {
        o.homo_del[idx] = 0;
        continue;
      }
      reference_base = std::string(1, reference_sequence[center]) + r.one;
      alternate_base = std::string(1, reference_base[0]);
      have_ref = have_alt = true;

    } else if (is_hetero_ACGT_Del) {  // NOLINT
      int idx = argmax_first(o.het_acgt_del);
      char hetero_del_base;
      long long variant_length;
      if (add_indel_length) {
        variant_length = idx / 4 + 1;
        hetero_del_base = ACGT[idx % 4];
      } else {
        variant_length = 0;
        hetero_del_base = ACGT[idx];
      }
      long long propose =
          (variant_length && variant_length < VL_MAX) ? variant_length : 0;
      auto r = deletion_bases_from(alt, propose, 1, max_infer, "", false);
      if (r.one.empty()) {
        o.het_acgt_del[idx] = 0;
        continue;
      }
      reference_base = std::string(1, reference_sequence[center]) + r.one;
      alternate_base = std::string(1, reference_base[0]);
      have_ref = have_alt = true;
      if (hetero_del_base != reference_base[0]) {
        alternate_base +=
            "," + (std::string(1, hetero_del_base) + reference_base.substr(1));
      }

    } else if (is_hetero_DelDel) {
      int idx = argmax_first(o.het_deldel);
      std::vector<std::string> del_list;
      if (add_indel_length) {
        int a = PT.deldel[idx].first, b = PT.deldel[idx].second;
        int vlen1 = std::max(a, b), vlen2 = std::min(a, b);  // sorted desc
        long long p1 = (vlen1 && vlen1 < VL_MAX) ? vlen1 : 0;
        auto r1 = deletion_bases_from(alt, p1, 1, max_infer, "", false);
        if (!r1.one.empty()) {
          long long p2 = (vlen2 && vlen2 < VL_MAX) ? vlen2 : 0;
          auto r2 = deletion_bases_from(alt, p2, 1, max_infer, r1.one, false);
          if (!r2.one.empty()) {
            if (r1.one.size() > r2.one.size())
              del_list = {r1.one, r2.one};
            else
              del_list = {r2.one, r1.one};
          }
        }
        if (del_list.size() < 2) {
          auto rm = deletion_bases_from(alt, 0, 1, max_infer, "", true);
          del_list = rm.multi;
        }
      } else {
        auto rm = deletion_bases_from(alt, 0, 1, max_infer, "", true);
        del_list = rm.multi;
      }
      if (del_list.size() < 2) {
        o.het_deldel[idx] = 0;
        continue;
      }
      const std::string& deletion_bases = del_list[0];
      const std::string& deletion_bases1 = del_list[1];
      reference_base =
          std::string(1, reference_sequence[center]) + deletion_bases;
      alternate_base = std::string(1, reference_base[0]);
      have_ref = have_alt = true;
      std::string alt1 = alternate_base;
      std::string alt2 = std::string(1, reference_base[0]) +
                         reference_base.substr(deletion_bases1.size() + 1);
      if (alt1 != alt2 && reference_base != alt1 && reference_base != alt2) {
        alternate_base = alt1 + "," + alt2;
      } else {
        // quirk: alternate_base stays reference_base[0] -> loop exits
        o.het_deldel[idx] = 0;
        continue;
      }

    } else if (is_insertion_and_deletion) {
      int idx = argmax_first(o.het_insdel);
      long long vlen1 = 0, vlen2 = 0;
      if (add_indel_length) {
        vlen1 = PT.insdel[idx].first;   // deletion length
        vlen2 = PT.insdel[idx].second;  // insertion length
      }
      long long pi = (vlen2 && vlen2 < VL_MAX) ? vlen2 : 0;
      auto ri = insertion_bases_from(alt, pi, 1, max_infer, "", false);
      long long pd = (vlen1 && vlen1 < VL_MAX) ? vlen1 : 0;
      auto rd = deletion_bases_from(alt, pd, 1, max_infer, "", false);
      if (ri.one.empty() || rd.one.empty()) {
        o.het_insdel[idx] = 0;
        continue;
      }
      reference_base = std::string(1, reference_sequence[center]) + rd.one;
      alternate_base = std::string(1, reference_base[0]) + "," +
                       (ri.one + reference_base.substr(1));
      have_ref = have_alt = true;
    } else {
      // No family matched (shouldn't happen): avoid an infinite loop.
      sel->ok = false;
      return;
    }
  }

  sel->reference_base = reference_base;
  sel->alternate_base = alternate_base;
  sel->probability = maximum_probability;
  sel->ok = true;
}

// compute_pl (decoder.py:615-639)
std::vector<long long> compute_pl(const std::string& genotype_string,
                                  const double* genotype_probs,
                                  const double* gt21_probs,
                                  std::string reference_base,
                                  const std::string& alternate_base) {
  (void)genotype_string;
  std::vector<std::string> alt_array;
  {
    std::string cur;
    for (char c : alternate_base) {
      if (c == ',') { alt_array.push_back(cur); cur.clear(); }
      else cur.push_back(c);
    }
    alt_array.push_back(cur);
  }
  size_t alt_num = alt_array.size();
  static const int GENO1[3][2] = {{0, 0}, {0, 1}, {1, 1}};
  static const int GENO2[6][2] = {{0, 0}, {0, 1}, {1, 1}, {0, 2}, {1, 2}, {2, 2}};
  const int (*geno)[2] = alt_num == 1 ? GENO1 : GENO2;
  size_t n_geno = alt_num == 1 ? 3 : 6;
  if (reference_base.size() == 1) {
    char c = iupac_to_acgt(reference_base[0]);
    reference_base = std::string(1, c ? c : reference_base[0]);
  }
  std::vector<std::string> all_base;
  all_base.push_back(reference_base);
  for (const auto& a : alt_array) all_base.push_back(a);
  std::vector<double> likelihoods;
  for (size_t k = 0; k < n_geno; k++) {
    int g1 = geno[k][0], g2 = geno[k][1];
    std::string p1 = partial_label_from(reference_base, all_base[g1]);
    std::string p2 = partial_label_from(reference_base, all_base[g2]);
    std::string label = mix_two_partial_labels(p1, p2);
    int gt21_idx = gt21_enum_from_label(label);
    if (gt21_idx < 0) {
      if (alternate_base == ".") return {990};
      return std::vector<long long>(n_geno, 990);
    }
    int zyg = genotype_enum_for_task(genotype_enum_from(g1, g2));
    likelihoods.push_back(gt21_probs[gt21_idx] * genotype_probs[zyg]);
  }
  double sum_p = 0;
  for (double x : likelihoods) sum_p += x;
  std::vector<double> pls;
  double min_pl = 1e308;
  for (double x : likelihoods) {
    double v = -10.0 * std::log10(x / sum_p + 1e-8);
    pls.push_back(v);
    min_pl = std::min(min_pl, v);
  }
  std::vector<long long> out;
  for (double x : pls) out.push_back((long long)std::ceil(x - min_pl));
  return out;
}

// decode one candidate -> VCF row string; returns false when suppressed.
bool decode_candidate(const char* position_info, const char* alt_info,
                      const double* probabilities, int prob_width,
                      const Config& cfg, std::string* row) {
  // parse "ctg[:more]:pos:refseq" (rstrip, rsplit semantics)
  std::string pi(position_info);
  while (!pi.empty() && std::isspace((unsigned char)pi.back())) pi.pop_back();
  std::vector<size_t> colons;
  for (size_t i = 0; i < pi.size(); i++)
    if (pi[i] == ':') colons.push_back(i);
  if (colons.size() < 2) return false;
  size_t c_last = colons.back(), c_prev = colons[colons.size() - 2];
  std::string chromosome = pi.substr(0, c_prev);
  std::string position_s = pi.substr(c_prev + 1, c_last - c_prev - 1);
  std::string reference_sequence = pi.substr(c_last + 1);
  long long position = strtoll(position_s.c_str(), nullptr, 10);
  int center = reference_sequence.size() > 1 ? 16 : 0;
  const char* information_string = cfg.pileup ? "P" : "F";

  long long read_depth = 0;
  AltDict alt;
  if (!parse_alt_info(alt_info, &read_depth, &alt)) return false;

  const double* gt21_probs = probabilities;
  const double* genotype_probs = probabilities + 21;
  static const double ZEROS[33] = {0};
  const double* vl1 = ZEROS;
  const double* vl2 = ZEROS;
  if (cfg.add_indel_length && prob_width >= 90) {
    vl1 = probabilities + 24;
    vl2 = probabilities + 57;
  }

  Selection sel;
  select_output(reference_sequence, center, gt21_probs, genotype_probs, vl1,
                vl2, alt, cfg, &sel);
  if (!sel.ok) return false;

  std::string reference_base = sel.reference_base;
  std::string alternate_base = sel.alternate_base;

  if ((!cfg.show_ref_calls && sel.is_reference) ||
      (!sel.is_reference && reference_base == alternate_base))
    return false;

  bool is_multi = alternate_base.find(',') != std::string::npos;

  if (cfg.haploid_precise &&
      (sel.is_hetero_SNP || sel.is_hetero_ACGT_Ins || sel.is_hetero_InsIns ||
       sel.is_hetero_ACGT_Del || sel.is_hetero_DelDel ||
       sel.is_insertion_and_deletion))
    return false;
  if (cfg.haploid_sensitive && is_multi) return false;

  std::string genotype_string;
  if (sel.is_reference)
    genotype_string = GENOTYPES[homo_reference];
  else if (sel.is_homo_SNP || sel.is_homo_insertion || sel.is_homo_deletion)
    genotype_string = GENOTYPES[homo_variant];
  else
    genotype_string = GENOTYPES[hetero_variant];
  if (is_multi) genotype_string = GENOTYPES[hetero_variant_multi];

  // _decode_alt_types
  std::vector<std::pair<std::string, long long>> snp_map, ins_map, del_map;
  long long ref_count = 0;
  for (const auto& it : alt.items) {
    if (it.first.empty()) continue;
    if (it.first[0] == 'X' && it.first.size() >= 2)
      snp_map.emplace_back(std::string(1, it.first[1]), it.second);
    else if (it.first[0] == 'I')
      ins_map.emplace_back(it.first.substr(1), it.second);
    else if (it.first[0] == 'D')
      del_map.emplace_back(it.first.substr(1), it.second);
    else if (it.first[0] == 'R')
      ref_count = it.second;
  }
  if (ref_count < 0) ref_count = 0;
  auto map_get = [](const std::vector<std::pair<std::string, long long>>& m,
                    const std::string& k) -> long long {
    for (const auto& it : m)
      if (it.first == k) return it.second;
    return 0;
  };
  auto split_commas = [](const std::string& s) {
    std::vector<std::string> out;
    std::string cur;
    for (char c : s) {
      if (c == ',') { out.push_back(cur); cur.clear(); }
      else cur.push_back(c);
    }
    out.push_back(cur);
    return out;
  };

  long long supported_reads_count = 0;
  std::vector<long long> alt_list_count;

  if (sel.is_reference) {
    supported_reads_count = ref_count;
    alternate_base = ".";
  } else if (sel.is_homo_SNP || sel.is_hetero_SNP) {
    for (char base : alternate_base) {
      if (base == ',') continue;
      long long rc = map_get(snp_map, std::string(1, base));
      supported_reads_count += rc;
      alt_list_count.push_back(rc);
    }
  } else if (sel.is_homo_insertion || sel.is_hetero_InsIns) {
    for (const auto& ins_bases : split_commas(alternate_base)) {
      long long li = cfg.enable_long_indel
                         ? long_indel_read_count(ins_map, cfg, ins_bases, 0, false)
                         : 0;
      long long n = map_get(ins_map, ins_bases) + li;
      supported_reads_count += n;
      alt_list_count.push_back(n);
    }
  } else if (sel.is_hetero_ACGT_Ins) {
    auto parts = split_commas(alternate_base);
    bool has_snp = is_multi;
    std::string snp_base = has_snp ? parts[0].substr(0, 1) : "";
    std::string ins_bases = has_snp ? parts[1] : alternate_base;
    long long snp_reads = has_snp ? map_get(snp_map, snp_base) : 0;
    long long li = cfg.enable_long_indel
                       ? long_indel_read_count(ins_map, cfg, ins_bases, 0, false)
                       : 0;
    long long ins_reads = map_get(ins_map, ins_bases) + li;
    supported_reads_count = ins_reads + snp_reads;
    if (has_snp) alt_list_count.push_back(snp_reads);
    alt_list_count.push_back(ins_reads);
  } else if (sel.is_homo_deletion || sel.is_hetero_DelDel) {
    if (!del_map.empty()) {
      if (sel.is_homo_deletion) {
        std::string del_bases =
            reference_base.size() > 1 ? reference_base.substr(1) : "";
        bool has_del = reference_base.size() > 1;
        long long ld =
            cfg.enable_long_indel
                ? long_indel_read_count(del_map, cfg, "",
                                        (long long)del_bases.size(), true)
                : 0;
        supported_reads_count = (has_del ? map_get(del_map, del_bases) : 0) + ld;
        alt_list_count.push_back(supported_reads_count);
      } else if (sel.is_hetero_DelDel && del_map.size() > 1) {
        for (const auto& bases : split_commas(alternate_base)) {
          long long alt_len =
              (long long)reference_base.size() - (long long)bases.size();
          long long tmp = -1;
          for (const auto& it : del_map)
            if ((long long)it.first.size() == alt_len) { tmp = it.second; break; }
          long long ld = cfg.enable_long_indel
                             ? long_indel_read_count(del_map, cfg, "", alt_len, true)
                             : 0;
          long long n = (tmp >= 0 ? tmp : 0) + ld;
          alt_list_count.push_back(n);
          supported_reads_count += n;
        }
      }
    }
  } else if (sel.is_hetero_ACGT_Del) {
    auto alt_list = split_commas(alternate_base);
    bool is_snp_del_multi = is_multi && !alt_list.empty();
    bool has_snp = is_snp_del_multi && alt_list.size() > 1;
    std::string snp_base = has_snp ? alt_list[1].substr(0, 1) : "";
    long long snp_reads =
        (is_snp_del_multi && has_snp) ? map_get(snp_map, snp_base) : 0;
    std::string del_bases =
        reference_base.size() > 1 ? reference_base.substr(1) : "";
    bool has_del = reference_base.size() > 1;
    long long ld = cfg.enable_long_indel
                       ? long_indel_read_count(
                             del_map, cfg, "",
                             has_del ? (long long)del_bases.size() : 0, true)
                       : 0;
    long long del_reads = (has_del ? map_get(del_map, del_bases) : 0) + ld;
    supported_reads_count = del_reads + snp_reads;
    if (has_snp && !snp_base.empty()) alt_list_count.push_back(snp_reads);
    alt_list_count.push_back(del_reads);
  } else if (sel.is_insertion_and_deletion) {
    for (const auto& bases : split_commas(alternate_base)) {
      long long alt_len =
          (long long)reference_base.size() - (long long)bases.size();
      long long n;
      if (alt_len < 0) {
        std::string ins_bases =
            reference_base.size() > 1
                ? bases.substr(0, bases.size() - (reference_base.size() - 1))
                : bases;
        long long li =
            cfg.enable_long_indel
                ? long_indel_read_count(ins_map, cfg, ins_bases, 0, false)
                : 0;
        n = map_get(ins_map, ins_bases) + li;
      } else {
        long long tmp = -1;
        for (const auto& it : del_map)
          if ((long long)it.first.size() == alt_len) { tmp = it.second; break; }
        long long ld = cfg.enable_long_indel
                           ? long_indel_read_count(del_map, cfg, "", alt_len, true)
                           : 0;
        n = (tmp >= 0 ? tmp : 0) + ld;
      }
      alt_list_count.push_back(n);
      supported_reads_count += n;
    }
  }

  double allele_frequency =
      read_depth != 0 ? (double)supported_reads_count / (double)read_depth : 0.0;
  if (allele_frequency > 1) allele_frequency = 1;

  double quality_score = quality_score_from(sel.probability);

  if (cfg.haploid_precise || cfg.haploid_sensitive)
    genotype_string =
        genotype_string.find('1') != std::string::npos ? "1" : "0";

  const char* filtration_value;
  if (sel.is_reference)
    filtration_value = "RefCall";
  else if (!cfg.has_qual_pass || quality_score >= cfg.qual_pass)
    filtration_value = "PASS";
  else
    filtration_value = "LowQual";

  if (!cfg.keep_iupac) {
    reference_base = convert_iupac_to_n(reference_base);
    alternate_base = convert_iupac_to_n(alternate_base);
  }

  std::string allele_depth = std::to_string(ref_count);
  if (!alt_list_count.empty()) {
    for (long long x : alt_list_count) allele_depth += "," + std::to_string(x);
  }
  char fbuf[64];
  std::string allele_frequency_s;
  if (alt_list_count.size() <= 1) {
    snprintf(fbuf, sizeof fbuf, "%.4f", allele_frequency);
    allele_frequency_s = fbuf;
  } else {
    for (size_t i = 0; i < alt_list_count.size(); i++) {
      double af = (double)alt_list_count[i] / (double)read_depth;
      if (af > 1.0) af = 1.0;
      snprintf(fbuf, sizeof fbuf, "%.4f", af);
      if (i) allele_frequency_s += ",";
      allele_frequency_s += fbuf;
    }
  }

  char head[256];
  snprintf(head, sizeof head, "%s\t%lld\t.\t", chromosome.c_str(), position);
  char qualbuf[64];
  snprintf(qualbuf, sizeof qualbuf, "%.2f", quality_score);
  long long gq = (long long)quality_score;  // Python "%d" % float truncates

  row->clear();
  *row += head;
  *row += reference_base;
  *row += "\t";
  *row += alternate_base;
  *row += "\t";
  *row += qualbuf;
  *row += "\t";
  *row += filtration_value;
  *row += "\t";
  *row += information_string;
  if (cfg.gvcf) {
    auto pls = compute_pl(genotype_string, genotype_probs, gt21_probs,
                          reference_base, alternate_base);
    std::string pl_str;
    for (size_t i = 0; i < pls.size(); i++) {
      if (i) pl_str += ",";
      pl_str += std::to_string(pls[i]);
    }
    char tail[128];
    snprintf(tail, sizeof tail, "\tGT:GQ:DP:AD:AF:PL\t%s:%lld:%lld:",
             genotype_string.c_str(), gq, read_depth);
    *row += tail;
    *row += allele_depth + ":" + allele_frequency_s + ":" + pl_str + "\n";
  } else {
    char tail[128];
    snprintf(tail, sizeof tail, "\tGT:GQ:DP:AD:AF\t%s:%lld:%lld:",
             genotype_string.c_str(), gq, read_depth);
    *row += tail;
    *row += allele_depth + ":" + allele_frequency_s + "\n";
  }
  return true;
}

}  // namespace

extern "C" {

struct DecodeOut {
  char** rows;  // n entries; nullptr = suppressed row
  int32_t n;
  int32_t error;
};

DecodeOut* clair3t_decode(const char** pos_infos, const char** alt_infos,
                          const double* probs, int32_t n, int32_t prob_width,
                          int32_t add_indel_length, int32_t pileup,
                          int32_t show_ref_calls, int32_t gvcf,
                          int32_t has_qual_pass, double qual_pass,
                          int32_t haploid_precise, int32_t haploid_sensitive,
                          int32_t enable_long_indel, int64_t max_infer,
                          int32_t keep_iupac, int32_t cal_precise_long_indel_af,
                          double long_indel_distance_proportion,
                          int64_t max_infer_default, int32_t n_threads) {
  auto* out = new DecodeOut();
  out->n = n;
  out->error = 0;
  out->rows = new char*[n]();
  Config cfg;
  cfg.add_indel_length = add_indel_length;
  cfg.pileup = pileup;
  cfg.show_ref_calls = show_ref_calls;
  cfg.gvcf = gvcf;
  cfg.has_qual_pass = has_qual_pass;
  cfg.qual_pass = qual_pass;
  cfg.haploid_precise = haploid_precise;
  cfg.haploid_sensitive = haploid_sensitive;
  cfg.enable_long_indel = enable_long_indel;
  cfg.max_infer = max_infer;
  cfg.keep_iupac = keep_iupac;
  cfg.cal_precise_long_indel_af = cal_precise_long_indel_af;
  cfg.long_indel_distance_proportion = long_indel_distance_proportion;
  cfg.max_infer_default = max_infer_default;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? (int32_t)hw : 1;
  }
  // candidates are independent; shard [0, n) across a thread pool
  int shards = (int)std::min<int64_t>(n_threads, std::max<int64_t>(1, n / 512));
  std::vector<uint8_t> failed(std::max(shards, 1), 0);
  auto work = [&](int t, int32_t lo, int32_t hi) {
    try {
      for (int32_t i = lo; i < hi; i++) {
        std::string row;
        if (decode_candidate(pos_infos[i], alt_infos[i],
                             probs + (size_t)i * prob_width, prob_width, cfg,
                             &row)) {
          out->rows[i] = new char[row.size() + 1];
          memcpy(out->rows[i], row.c_str(), row.size() + 1);
        }
      }
    } catch (...) {
      failed[t] = 1;
    }
  };
  if (shards <= 1) {
    work(0, 0, n);
  } else {
    std::vector<std::thread> workers;
    for (int t = 0; t < shards; t++)
      workers.emplace_back(work, t, (int32_t)((int64_t)n * t / shards),
                           (int32_t)((int64_t)n * (t + 1) / shards));
    for (auto& w : workers) w.join();
  }
  for (uint8_t f : failed)
    if (f) out->error = 1;
  return out;
}

void clair3t_decode_free(DecodeOut* out) {
  if (!out) return;
  for (int32_t i = 0; i < out->n; i++) delete[] out->rows[i];
  delete[] out->rows;
  delete out;
}

}  // extern "C"
