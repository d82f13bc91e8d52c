// Native data layer: TSV interaction parsing, graph edge extraction, and
// train/eval example construction.
//
// The port's copy of c2dsr_tpu/native/preprocess.cpp: the same code, so
// that from the same raw files and seed both packages build the same splits,
// the std::mt19937_64 streams of the corrupted sequences and the sampled
// negatives included.  Edit only together with that file.
//
// The reference does all of this in per-user Python loops
// (dataloader.py:60-228, utils/graph.py:33-96); at EE scale (120k users)
// that is minutes of preprocessing.  This C++ core runs the same semantics
// ~50-100x faster and is exposed through a plain C ABI consumed via ctypes
// (c2dsr_tpu_torch/native/__init__.py).  The port's pure-Python
// implementation (c2dsr_tpu_torch/data) computes the same deterministic
// fields from numpy's generator instead; it runs only when asked for.
//
// Layouts (all row-major, int32 unless noted):
//   parse:   offsets int64[n_users+1], items int32[sum(len)] (time-sorted)
//   train:   out[n_kept][14][len_max]   field order = preprocess.TRAIN_FIELDS
//   eval:    seqs[n][6][len_max], scalars int32[n][4] (idx_last_a,
//            idx_last_b, xory_last, gt_last), negs int32[n][n_neg]
//   edges:   int32[cap][2] (src, dst) per edge list

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <random>
#include <string>
#include <unordered_set>
#include <vector>

extern "C" {

struct ParseResult {
  std::vector<int64_t> offsets;
  std::vector<int32_t> items;
};

// ---------------------------------------------------------------- parsing

// Parse one interaction file: per line, drop the first two tab fields, then
// fields "item|unixts|datestr|" -> (item, ts), sorted by ts
// (dataloader.py:44-58).
void* cds_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* res = new ParseResult();
  res->offsets.push_back(0);

  std::string line;
  std::vector<std::pair<int64_t, int32_t>> pairs;  // (ts, item)
  char buf[1 << 16];
  std::string acc;
  while (true) {
    size_t n = fread(buf, 1, sizeof(buf), f);
    if (n == 0) break;
    acc.append(buf, n);
    size_t start = 0;
    size_t nl;
    while ((nl = acc.find('\n', start)) != std::string::npos) {
      const char* p = acc.data() + start;
      const char* end = acc.data() + nl;
      // skip two tab-separated fields
      int tabs = 0;
      while (p < end && tabs < 2) {
        if (*p == '\t') tabs++;
        p++;
      }
      pairs.clear();
      while (p < end) {
        // parse "item|ts|datestr|" up to next tab
        int64_t item = 0, ts = 0;
        while (p < end && *p >= '0' && *p <= '9')
          item = item * 10 + (*p++ - '0');
        if (p < end && *p == '|') p++;
        while (p < end && *p >= '0' && *p <= '9') ts = ts * 10 + (*p++ - '0');
        while (p < end && *p != '\t') p++;  // skip rest of the cell
        if (p < end) p++;
        pairs.emplace_back(ts, (int32_t)item);
      }
      std::stable_sort(pairs.begin(), pairs.end(),
                       [](const auto& a, const auto& b) {
                         return a.first < b.first;
                       });
      for (auto& pr : pairs) res->items.push_back(pr.second);
      res->offsets.push_back((int64_t)res->items.size());
      start = nl + 1;
    }
    acc.erase(0, start);
  }
  fclose(f);
  return res;
}

int64_t cds_n_users(void* h) {
  return (int64_t)((ParseResult*)h)->offsets.size() - 1;
}
int64_t cds_n_interactions(void* h) {
  return (int64_t)((ParseResult*)h)->items.size();
}
void cds_fill(void* h, int64_t* offsets, int32_t* items) {
  auto* r = (ParseResult*)h;
  memcpy(offsets, r->offsets.data(), r->offsets.size() * sizeof(int64_t));
  memcpy(items, r->items.data(), r->items.size() * sizeof(int32_t));
}
void cds_free(void* h) { delete (ParseResult*)h; }

// ------------------------------------------------------------ graph edges

// Directed edge extraction (utils/graph.py:54-81): per user walk three
// cursors — pre over the shared sequence, source over A items, target over
// B items; append an edge per consecutive pair (duplicates kept: the
// reference's dedup set is never populated).
// Returns number of edges written; caller provides cap = n_interactions.
int64_t cds_build_edges(const int64_t* offsets, const int32_t* items,
                        int64_t n_users, int32_t n_item_a,
                        int32_t* out_share, int32_t* out_spec,
                        int64_t* n_spec_out) {
  int64_t ns = 0, np = 0;
  for (int64_t u = 0; u < n_users; u++) {
    int32_t source = -1, target = -1, pre = -1;
    for (int64_t i = offsets[u]; i < offsets[u + 1]; i++) {
      int32_t d = items[i];
      if (d < n_item_a) {
        if (source != -1) {
          out_spec[2 * np] = source;
          out_spec[2 * np + 1] = d;
          np++;
        }
        source = d;
      } else {
        if (target != -1) {
          out_spec[2 * np] = target;
          out_spec[2 * np + 1] = d;
          np++;
        }
        target = d;
      }
      if (pre != -1) {
        out_share[2 * ns] = pre;
        out_share[2 * ns + 1] = d;
        ns++;
      }
      pre = d;
    }
  }
  *n_spec_out = np;
  return ns;
}

// -------------------------------------------------- train example builder

// Field indices within the [14][len_max] block, matching
// c2dsr_tpu_torch.data.preprocess.TRAIN_FIELDS order.
enum {
  F_SEQ = 0, F_SEQ_A, F_SEQ_B, F_POS, F_POS_A, F_POS_B,
  F_GT_SHARE_A, F_GT_SHARE_B, F_GT_A, F_GT_B, F_MASK_A, F_MASK_B,
  F_NEG_A, F_NEG_B, N_FIELDS
};

// Thread per-step ground truths backwards through one domain subsequence
// (dataloader.py:97-134).  Mutates seq/pos; in_domain uses `<` for A and
// the reference's strict `>` for B (quirk kept).
static bool thread_gt(int32_t* seq, int32_t* pos, int n, int32_t gt_last,
                      int32_t off, int32_t ignore, bool is_a,
                      int32_t n_item_a, int32_t pad, int32_t* gt,
                      int32_t* mask) {
  for (int i = 0; i < n; i++) {
    gt[i] = ignore;
    mask[i] = 0;
  }
  int32_t cur = -1;
  bool any = false;
  for (int i = n - 1; i >= 0; i--) {
    if (!pos[i]) continue;
    if (cur == -1) {
      cur = seq[i] - off;
      bool in_dom = is_a ? (gt_last < n_item_a) : (gt_last > n_item_a);
      if (in_dom) {
        gt[i] = gt_last - off;
        mask[i] = 1;
        any = true;
      } else {
        seq[i] = pad;
        pos[i] = 0;
      }
    } else {
      gt[i] = cur;
      mask[i] = 1;
      any = true;
      cur = seq[i] - off;
    }
  }
  return any;
}

// Build packed train examples (dataloader.py:60-161 semantics).  Corrupted
// sequences use std::mt19937_64 — same distribution as the reference's
// random.randint, not the same stream (SURVEY.md section 7: sampling parity
// is achieved at the data level, not the RNG level).
int64_t cds_preprocess_train(const int64_t* offsets, const int32_t* items,
                             int64_t n_users, int32_t n_item_a,
                             int32_t n_item_b, int32_t len_max,
                             uint64_t seed, int32_t* out) {
  const int32_t pad = n_item_a + n_item_b;  // idx_pad in shared space
  std::mt19937_64 rng(seed);
  auto rand_in = [&](int32_t lo, int32_t hi) {  // uniform [lo, hi)
    return lo + (int32_t)(rng() % (uint64_t)(hi - lo));
  };
  std::vector<int32_t> sa(len_max), pa(len_max), na_(len_max);
  std::vector<int32_t> sb(len_max), pb(len_max), nb_(len_max);
  std::vector<int32_t> gta(len_max), ma(len_max), gtb(len_max), mb(len_max);

  int64_t kept = 0;
  for (int64_t u = 0; u < n_users; u++) {
    int64_t len_seq = offsets[u + 1] - offsets[u];
    if (len_seq < 2 || len_seq > len_max) continue;
    const int32_t* user = items + offsets[u];
    int n = (int)len_seq - 1;  // seq_share length
    int32_t gt_last = user[len_seq - 1];

    int xc = 1, yc = 1;
    for (int i = 0; i < n; i++) {
      int32_t idx = user[i];
      if (idx < n_item_a) {
        na_[i] = idx;      sa[i] = idx;  pa[i] = xc++;
        nb_[i] = rand_in(0, n_item_a);   sb[i] = pad;  pb[i] = 0;
      } else {
        na_[i] = rand_in(n_item_a, pad); sa[i] = pad;  pa[i] = 0;
        nb_[i] = idx;      sb[i] = idx;  pb[i] = yc++;
      }
    }
    if (!thread_gt(sa.data(), pa.data(), n, gt_last, 0, n_item_a, true,
                   n_item_a, pad, gta.data(), ma.data()))
      continue;
    if (!thread_gt(sb.data(), pb.data(), n, gt_last, n_item_a, n_item_b,
                   false, n_item_a, pad, gtb.data(), mb.data()))
      continue;

    int lp = len_max - (int)len_seq + 1;  // left padding
    int32_t* blk = out + kept * N_FIELDS * len_max;
    auto field = [&](int f) { return blk + (int64_t)f * len_max; };
    for (int f = 0; f < N_FIELDS; f++) {
      int32_t fill;
      switch (f) {
        case F_POS: case F_POS_A: case F_POS_B:
        case F_MASK_A: case F_MASK_B: fill = 0; break;
        case F_GT_SHARE_A: case F_GT_A: fill = n_item_a; break;
        case F_GT_SHARE_B: case F_GT_B: fill = n_item_b; break;
        default: fill = pad;
      }
      for (int i = 0; i < lp; i++) field(f)[i] = fill;
    }
    for (int i = 0; i < n; i++) {
      int j = lp + i;
      int32_t g = user[i + 1];  // gt (shared) at step i
      field(F_SEQ)[j] = user[i];
      field(F_SEQ_A)[j] = sa[i];
      field(F_SEQ_B)[j] = sb[i];
      field(F_POS)[j] = i + 1;
      field(F_POS_A)[j] = pa[i];
      field(F_POS_B)[j] = pb[i];
      field(F_GT_SHARE_A)[j] = g < n_item_a ? g : n_item_a;
      field(F_GT_SHARE_B)[j] = g >= n_item_a ? g - n_item_a : n_item_b;
      field(F_GT_A)[j] = gta[i];
      field(F_GT_B)[j] = gtb[i];
      field(F_MASK_A)[j] = ma[i];
      field(F_MASK_B)[j] = mb[i];
      field(F_NEG_A)[j] = na_[i];
      field(F_NEG_B)[j] = nb_[i];
    }
    kept++;
  }
  return kept;
}

// --------------------------------------------------- eval example builder

// Build packed eval examples (dataloader.py:163-228).  seqs layout:
// [n][6][len_max] field order seq_share, seq_share_a, seq_share_b, pos,
// pos_a, pos_b; scalars [n][4]; negs [n][n_neg] (domain-local, gt
// excluded; bug_truncated_b_neg_pool reproduces dataloader.py:222-224).
int64_t cds_preprocess_eval(const int64_t* offsets, const int32_t* items,
                            int64_t n_users, int32_t n_item_a,
                            int32_t n_item_b, int32_t len_max,
                            int32_t n_neg, int32_t bug_truncated_b,
                            uint64_t seed, int32_t* seqs, int32_t* scalars,
                            int32_t* negs) {
  const int32_t pad = n_item_a + n_item_b;
  std::mt19937_64 rng(seed);
  int64_t kept = 0;
  std::vector<int32_t> sampled;
  for (int64_t u = 0; u < n_users; u++) {
    int64_t len_seq = offsets[u + 1] - offsets[u];
    if (len_seq < 2 || len_seq > len_max) continue;
    const int32_t* user = items + offsets[u];
    int n = (int)len_seq - 1;
    int lp = len_max - (int)len_seq + 1;
    int32_t gt_last = user[len_seq - 1];

    int32_t* blk = seqs + kept * 6 * (int64_t)len_max;
    auto field = [&](int f) { return blk + (int64_t)f * len_max; };
    for (int i = 0; i < lp; i++) {
      field(0)[i] = pad; field(1)[i] = pad; field(2)[i] = pad;
      field(3)[i] = 0;   field(4)[i] = 0;   field(5)[i] = 0;
    }
    int xc = 1, yc = 1;
    for (int i = 0; i < n; i++) {
      int j = lp + i;
      int32_t idx = user[i];
      field(0)[j] = idx;
      field(3)[j] = i + 1;
      if (idx < n_item_a) {
        field(1)[j] = idx; field(4)[j] = xc++;
        field(2)[j] = pad; field(5)[j] = 0;
      } else {
        field(1)[j] = pad; field(4)[j] = 0;
        field(2)[j] = idx; field(5)[j] = yc++;
      }
    }
    int32_t ila = -1, ilb = -1;
    for (int i = len_max - 1; i >= 0; i--)
      if (field(4)[i]) { ila = i; break; }
    for (int i = len_max - 1; i >= 0; i--)
      if (field(5)[i]) { ilb = i; break; }

    int32_t xory, gt_local, pool;
    if (gt_last < n_item_a) {
      xory = 0; gt_local = gt_last; pool = n_item_a;
    } else {
      xory = 1; gt_local = gt_last - n_item_a;
      pool = bug_truncated_b ? (n_item_b - n_item_a) : n_item_b;
    }
    // n_neg distinct uniform draws over [0, pool) \ {gt_local}: draw from
    // [0, pool-1) without replacement (Floyd), shift >= gt up by one
    sampled.clear();
    int32_t m = pool - 1;
    // Floyd's algorithm for distinct sampling without replacement
    {
      std::unordered_set<int32_t> seen;
      seen.reserve(n_neg * 2);
      for (int32_t j = m - n_neg; j < m; j++) {
        int32_t t = (int32_t)(rng() % (uint64_t)(j + 1));
        if (seen.count(t)) t = j;
        seen.insert(t);
        sampled.push_back(t);
      }
    }
    int32_t* ng = negs + kept * (int64_t)n_neg;
    for (int i = 0; i < n_neg; i++)
      ng[i] = sampled[i] >= gt_local ? sampled[i] + 1 : sampled[i];

    int32_t* sc = scalars + kept * 4;
    sc[0] = ila; sc[1] = ilb; sc[2] = xory; sc[3] = gt_local;
    kept++;
  }
  return kept;
}

}  // extern "C"
