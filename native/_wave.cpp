// bwa_flow_tpu native wave driver (CPython extension).
//
// Per-read seed-extension state machines for the device wave loop — the
// C++ counterpart of ops/region.py chain2aln_tasks + pipeline/batch.py's
// wave driver (itself the analog of the reference's FPGA task pipeline,
// /root/reference/src/fpga/FPGAPipeline.cpp:367-579). Python stepped
// ~4k generators per batch on the critical path; here the driver holds
// all state in C++: pack() fills a descriptor wave for the device,
// apply() feeds results back (including the band-doubling retry stages),
// oversized/non-resident tasks run inline on the exact scalar kernel,
// and finish() emits packed regions straight into the native tail.
// Byte-exact against the Python driver (tests/test_native_wave.py).
//
// Build: python setup.py build_ext --inplace  (g++, no external deps)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include "ksw_impl.h"

namespace {

constexpr int DESC_ROWS = 11;
constexpr int OUT_ROWS = 12;
constexpr int REG_NF = 12;

struct Opt {
  int32_t a, o_del, e_del, o_ins, e_ins, w, zdrop, pen_clip5, pen_clip3;
  int8_t mat[25];
};

struct Bns {
  const uint8_t* pac;
  int64_t l_pac;
  const int64_t* offsets;
  int64_t n_ctg;

  int32_t pos2rid(int64_t pos_f) const {
    const int64_t* e = offsets + n_ctg;
    return (int32_t)(std::upper_bound(offsets, e, pos_f) - offsets) - 1;
  }
  void get_seq(int64_t beg, int64_t end, std::vector<uint8_t>* out) const {
    out->clear();
    if (end < beg) std::swap(beg, end);
    end = std::min(end, l_pac << 1);
    beg = std::max(beg, (int64_t)0);
    if (beg < l_pac && end > l_pac) return;
    bool rev = beg >= l_pac;
    int64_t bf = rev ? (l_pac << 1) - end : beg;
    int64_t ef = rev ? (l_pac << 1) - beg : end;
    out->reserve(ef - bf);
    for (int64_t p = bf; p < ef; ++p)
      out->push_back((pac[p >> 2] >> ((~p & 3) << 1)) & 3);
    if (rev) {
      std::reverse(out->begin(), out->end());
      for (uint8_t& c : *out) c = 3 - c;
    }
  }
  // golden fmindex.fetch_seq: clip [beg,end) to the contig containing mid
  void fetch_clip(int64_t* beg, int64_t mid, int64_t* end,
                  int32_t* rid) const {
    int64_t pos_f = mid >= l_pac ? (l_pac << 1) - 1 - mid : mid;
    bool is_rev = mid >= l_pac;
    *rid = pos2rid(pos_f);
    int64_t far_beg = offsets[*rid];
    int64_t far_end = (*rid + 1 < n_ctg) ? offsets[*rid + 1] : l_pac;
    if (is_rev) {
      int64_t b = (l_pac << 1) - far_end;
      int64_t e = (l_pac << 1) - far_beg;
      far_beg = b;
      far_end = e;
    }
    *beg = std::max(*beg, far_beg);
    *end = std::min(*end, far_end);
  }
};

struct Reg {
  int64_t rb, re;
  int32_t qb, qe, rid, score, truesc, w, seedcov, seedlen0, csub, is_alt;
  double frac_rep;
};

struct Seed {
  int64_t rbeg;
  int32_t qbeg, len, score;
};

// golden region.py cal_max_gap (bwamem.c:630-637)
int64_t cal_max_gap(const Opt& o, int64_t qlen) {
  int64_t l_del = (int64_t)((double)(qlen * o.a - o.o_del) / o.e_del + 1.0);
  int64_t l_ins = (int64_t)((double)(qlen * o.a - o.o_ins) / o.e_ins + 1.0);
  int64_t l = std::max(std::max(l_del, l_ins), (int64_t)1);
  return std::min(l, (int64_t)o.w << 1);
}

struct ReadState {
  const uint8_t* seq = nullptr;
  int32_t l_query = 0;
  bool dev_ok = false;
  // chain range in the packed arrays
  int64_t chain_lo = 0, chain_hi = 0;
  int64_t cur_chain = -1;      // absolute index; -1 = before first
  // per-chain context
  int64_t rmax0 = 0, rmax1 = 0;
  int32_t chain_rid = 0;
  double chain_frac = 0.0;
  std::vector<Seed> seeds;           // current chain's seeds
  std::vector<int32_t> srt;
  std::vector<uint8_t> srt_alive;
  int32_t k = -1;                    // srt cursor (descending)
  std::vector<uint8_t> rseq;         // lazily fetched window
  bool rseq_ready = false;
  // in-flight task
  bool in_flight = false;
  int32_t stage = 0;
  int64_t lfinal[6] = {0, 0, 0, 0, 0, 0};
  Seed cur;                          // seed being extended
  std::vector<Reg> regs;
  bool done = false;
  // speculation bookkeeping: slots of this read still unapplied in the
  // in-flight wave (apply decrements; 0 -> advance() repicks a task)
  int32_t slots_in_wave = 0;
};

// Per-chain precomputed context: rmax window and srt order depend only
// on the chain's seeds (never on extension results, bwamem.c:650-668),
// so they are computed once at driver creation — which lets pack()
// speculate tasks from chains BEYOND the read's current one and
// setup_chain() skip the recompute.
struct ChainPre {
  int64_t rmax0 = 0, rmax1 = 0;
  std::vector<int32_t> srt;
};

struct Driver {
  Opt opt;
  Bns bns;
  int32_t qmax, tmax, cap;
  // packed chain inputs (owned copies)
  std::vector<int64_t> chain_off, seed_off, seeds_flat;
  std::vector<int32_t> chain_rid;
  std::vector<double> chain_frac;
  std::vector<ChainPre> chains;      // per absolute chain index
  std::vector<uint8_t> seq_store;
  std::vector<int64_t> seq_off;
  std::vector<ReadState> reads;
  // per-stream slot identity: owning chain + srt position of the packed
  // seed (kpos = -1 marks the read's advance()-selected pending task)
  struct SlotRef {
    int32_t read, kpos;
    int64_t chain;
  };
  std::vector<std::vector<SlotRef>> stream_refs;
  // Harvester threads (py_steal) run claimed reads concurrently with the
  // wave loop: the claim scans (pack/steal/drain) serialize on mu;
  // per-read state is owned by whoever set in_flight; shared counters
  // are atomic (the CPU+accelerator work sharing of the reference,
  // kflow/include/kflow/MapStage.h:78-116).
  std::mutex mu;
  std::atomic<int64_t> n_pending{0};  // reads not done
  std::atomic<int64_t> n_host_tasks{0};  // tasks run on the scalar kernel
  // host-task cause breakdown (diagnosis: which limit spills work off
  // the device — query side too long, target window too long, or
  // deliberately drained/stolen work)
  std::atomic<int64_t> n_host_q{0};   // oversize: ql/qr > qmax
  std::atomic<int64_t> n_host_t{0};   // oversize: clamped span > tmax
  std::atomic<int64_t> n_host_sched{0};  // drain()/steal() scheduling
  std::vector<uint8_t>* pac_store = nullptr;
  std::vector<int64_t>* ann_store = nullptr;
  PyObject* ref_cap = nullptr;  // shared per-index RefBlock (borrowed pac)
  ~Driver() {
    delete pac_store;
    delete ann_store;
    Py_XDECREF(ref_cap);  // driver capsules die with the GIL held
  }
};

// Per-index reference block: pac (hundreds of MB at Gbp scale) and contig
// offsets copied ONCE per index into a capsule the Python side caches;
// every per-batch driver borrows it instead of re-copying
// (the per-batch copy measured ~1 s/batch on a 1 Gbp genome).
struct RefBlock {
  std::vector<uint8_t> pac;
  std::vector<int64_t> ann;
};

void refblock_free(PyObject* cap) {
  delete (RefBlock*)PyCapsule_GetPointer(cap, "bwa_refblock");
}

// ---------- chain setup + seed stepping ------------------------------

Seed seed_at(const Driver& D, int64_t ci, int32_t idx) {
  const int64_t* f = D.seeds_flat.data() + (D.seed_off[ci] + idx) * 4;
  return Seed{f[0], (int32_t)f[1], (int32_t)f[2], (int32_t)f[3]};
}

// per-chain rmax window + srt order (bwamem.c:650-668) — result-
// independent, computed once at creation (enables cross-chain pack
// speculation and removes the per-transition recompute)
void chain_precompute(Driver& D, int32_t l_query, int64_t ci) {
  ChainPre& P = D.chains[ci];
  const Opt& o = D.opt;
  int64_t lo = D.seed_off[ci], hi = D.seed_off[ci + 1];
  int32_t n = (int32_t)(hi - lo);
  int64_t l_pac = D.bns.l_pac;
  int64_t rmax0 = l_pac << 1, rmax1 = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t* f = D.seeds_flat.data() + i * 4;
    int64_t rbeg = f[0];
    int32_t qbeg = (int32_t)f[1], len = (int32_t)f[2];
    int64_t b = rbeg - (qbeg + cal_max_gap(o, qbeg));
    int64_t e = rbeg + len +
                ((l_query - qbeg - len) +
                 cal_max_gap(o, l_query - qbeg - len));
    rmax0 = std::min(rmax0, b);
    rmax1 = std::max(rmax1, e);
  }
  rmax0 = std::max(rmax0, (int64_t)0);
  rmax1 = std::min(rmax1, l_pac << 1);
  int64_t rbeg0 = D.seeds_flat[lo * 4];
  if (rmax0 < l_pac && l_pac < rmax1) {
    if (rbeg0 < l_pac) rmax1 = l_pac;
    else rmax0 = l_pac;
  }
  int32_t rid = 0;
  D.bns.fetch_clip(&rmax0, rbeg0, &rmax1, &rid);
  P.rmax0 = rmax0;
  P.rmax1 = rmax1;
  // srt: ascending (score, index); consumed from the top
  P.srt.resize(n);
  for (int32_t i = 0; i < n; ++i) P.srt[i] = i;
  std::stable_sort(P.srt.begin(), P.srt.end(),
                   [&](int32_t x, int32_t y) {
                     int32_t sx = (int32_t)D.seeds_flat[(lo + x) * 4 + 3];
                     int32_t sy = (int32_t)D.seeds_flat[(lo + y) * 4 + 3];
                     if (sx != sy) return sx < sy;
                     return x < y;
                   });
}

void setup_chain(Driver& D, ReadState& R, int64_t ci) {
  R.cur_chain = ci;
  int64_t lo = D.seed_off[ci], hi = D.seed_off[ci + 1];
  R.seeds.clear();
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t* f = D.seeds_flat.data() + i * 4;
    R.seeds.push_back(Seed{f[0], (int32_t)f[1], (int32_t)f[2],
                           (int32_t)f[3]});
  }
  R.chain_rid = D.chain_rid[ci];
  R.chain_frac = D.chain_frac[ci];
  const ChainPre& P = D.chains[ci];
  R.rmax0 = P.rmax0;
  R.rmax1 = P.rmax1;
  R.rseq.clear();
  R.rseq_ready = false;
  R.srt = P.srt;
  R.srt_alive.assign(R.seeds.size(), 1);
  R.k = (int32_t)R.seeds.size() - 1;
}

// skip-extension test (golden region.py:181-222); true = skip this seed.
// Generalized over an explicit chain (seeds via seed_fn, srt order,
// optional alive mask) so pack() can evaluate it speculatively on chains
// the read has not reached yet (alive == nullptr: all seeds alive).
template <class SeedFn>
bool skip_test(const Opt& o, const std::vector<Reg>& regs, int32_t l_query,
               SeedFn&& seed_fn, const std::vector<int32_t>& srt,
               const uint8_t* alive, const Seed& s, int32_t k) {
  int64_t hit = -1;
  for (size_t i = 0; i < regs.size(); ++i) {
    const Reg& p = regs[i];
    if (s.rbeg < p.rb || s.rbeg + s.len > p.re || s.qbeg < p.qb ||
        s.qbeg + s.len > p.qe)
      continue;
    if (s.len - p.seedlen0 > 0.1 * l_query) continue;
    int64_t qd = s.qbeg - p.qb;
    int64_t rd = s.rbeg - p.rb;
    int64_t max_gap = cal_max_gap(o, std::min(qd, rd));
    int64_t w = std::min(max_gap, (int64_t)p.w);
    if (qd - rd < w && rd - qd < w) { hit = (int64_t)i; break; }
    qd = p.qe - (s.qbeg + s.len);
    rd = p.re - (s.rbeg + s.len);
    max_gap = cal_max_gap(o, std::min(qd, rd));
    w = std::min(max_gap, (int64_t)p.w);
    if (qd - rd < w && rd - qd < w) { hit = (int64_t)i; break; }
  }
  if (hit < 0) return false;
  int32_t n = (int32_t)srt.size();
  int32_t i = k + 1;
  for (; i < n; ++i) {
    if (alive && !alive[i]) continue;
    const Seed t = seed_fn(srt[i]);
    if (t.len >= s.len * 0.95) {
      if (s.qbeg <= t.qbeg && s.qbeg + s.len - t.qbeg >= (s.len >> 2) &&
          t.qbeg - s.qbeg != t.rbeg - s.rbeg)
        break;
      if (t.qbeg <= s.qbeg && t.qbeg + t.len - s.qbeg >= (s.len >> 2) &&
          s.qbeg - t.qbeg != s.rbeg - t.rbeg)
        break;
    }
  }
  return i == n;  // no overlapping seeds in the chain: skip extension
}

bool seed_skippable(const Opt& o, ReadState& R, const Seed& s, int32_t k) {
  return skip_test(o, R.regs, R.l_query,
                   [&](int32_t idx) { return R.seeds[idx]; }, R.srt,
                   R.srt_alive.data(), s, k);
}

// apply a final 12-tuple to build the AlnReg (golden region.py:246-283)
void apply_tuple(const Opt& o, ReadState& R, const int64_t t[12]) {
  int64_t ls = t[0], lqle = t[1], ltle = t[2], lgtle = t[3], lgscore = t[4],
          aw0 = t[5];
  int64_t rs = t[6], rqle = t[7], rtle = t[8], rgtle = t[9], rgscore = t[10],
          aw1 = t[11];
  const Seed& s = R.cur;
  Reg a{};
  a.rid = R.chain_rid;
  if (s.qbeg) {
    a.score = (int32_t)ls;
    if (lgscore <= 0 || lgscore <= ls - o.pen_clip5) {  // local
      a.qb = (int32_t)(s.qbeg - lqle);
      a.rb = s.rbeg - ltle;
      a.truesc = (int32_t)ls;
    } else {  // to-end
      a.qb = 0;
      a.rb = s.rbeg - lgtle;
      a.truesc = (int32_t)lgscore;
    }
  } else {
    a.score = a.truesc = s.len * o.a;
    a.qb = 0;
    a.rb = s.rbeg;
  }
  if (s.qbeg + s.len != R.l_query) {
    int64_t sc0 = a.score;
    int64_t qe = s.qbeg + s.len;
    int64_t re = s.rbeg + s.len - R.rmax0;
    a.score = (int32_t)rs;
    if (rgscore <= 0 || rgscore <= rs - o.pen_clip3) {  // local
      a.qe = (int32_t)(qe + rqle);
      a.re = R.rmax0 + re + rtle;
      a.truesc += (int32_t)(rs - sc0);
    } else {  // to-end
      a.qe = R.l_query;
      a.re = R.rmax0 + re + rgtle;
      a.truesc += (int32_t)(rgscore - sc0);
    }
  } else {
    a.qe = R.l_query;
    a.re = s.rbeg + s.len;
  }
  a.seedcov = 0;
  for (const Seed& t2 : R.seeds) {
    if (t2.qbeg >= a.qb && t2.qbeg + t2.len <= a.qe && t2.rbeg >= a.rb &&
        t2.rbeg + t2.len <= a.re)
      a.seedcov += t2.len;
  }
  a.w = (int32_t)std::max(aw0, aw1);
  a.seedlen0 = s.len;
  a.frac_rep = R.chain_frac;
  a.csub = 0;
  a.is_alt = 0;
  R.regs.push_back(a);
}

// golden region.py run_task_host: exact band-doubling loops on the scalar
// kernel; fills out[12]
void run_host(const Opt& o, Driver& D, ReadState& R, int64_t out[12]) {
  const Seed& s = R.cur;
  if (!R.rseq_ready) {
    D.bns.get_seq(R.rmax0, R.rmax1, &R.rseq);
    R.rseq_ready = true;
  }
  // left (reversed)
  if (s.qbeg) {
    std::vector<uint8_t> qs(s.qbeg), ts;
    for (int32_t i = 0; i < s.qbeg; ++i) qs[i] = R.seq[s.qbeg - 1 - i];
    int64_t tmp = s.rbeg - R.rmax0;
    ts.resize(tmp);
    for (int64_t i = 0; i < tmp; ++i) ts[i] = R.rseq[tmp - 1 - i];
    int64_t score = -1, aw0 = o.w;
    bwaflow::Ext2Result r{};
    for (int t = 0; t < 2; ++t) {
      int64_t prev = score;
      aw0 = (int64_t)o.w << t;
      r = bwaflow::ksw_extend2((int)qs.size(), qs.data(), (int)ts.size(),
                               ts.data(), o.mat, 5, o.o_del, o.e_del,
                               o.o_ins, o.e_ins, (int)aw0, o.pen_clip5,
                               o.zdrop, s.len * o.a);
      score = r.score;
      if (score == prev ||
          r.max_off < (aw0 >> 1) + (aw0 >> 2))
        break;
    }
    out[0] = score; out[1] = r.qle; out[2] = r.tle; out[3] = r.gtle;
    out[4] = r.gscore; out[5] = aw0;
  } else {
    out[0] = s.len * o.a;
    out[1] = out[2] = out[3] = out[4] = 0;
    out[5] = o.w;
  }
  int64_t sc0 = out[0];
  if (s.qbeg + s.len != R.l_query) {
    int64_t qe = s.qbeg + s.len;
    int64_t re = s.rbeg + s.len - R.rmax0;
    std::vector<uint8_t> qs(R.seq + qe, R.seq + R.l_query);
    std::vector<uint8_t> ts(R.rseq.begin() + re, R.rseq.end());
    int64_t score = sc0, aw1 = o.w;
    bwaflow::Ext2Result r{};
    for (int t = 0; t < 2; ++t) {
      int64_t prev = score;
      aw1 = (int64_t)o.w << t;
      r = bwaflow::ksw_extend2((int)qs.size(), qs.data(), (int)ts.size(),
                               ts.data(), o.mat, 5, o.o_del, o.e_del,
                               o.o_ins, o.e_ins, (int)aw1, o.pen_clip3,
                               o.zdrop, (int)sc0);
      score = r.score;
      if (score == prev ||
          r.max_off < (aw1 >> 1) + (aw1 >> 2))
        break;
    }
    out[6] = score; out[7] = r.qle; out[8] = r.tle; out[9] = r.gtle;
    out[10] = r.gscore; out[11] = aw1;
  } else {
    out[6] = sc0;
    out[7] = out[8] = out[9] = out[10] = 0;
    out[11] = o.w;
  }
}

bool task_fits(const Driver& D, const ReadState& R, const Seed& s) {
  // Target spans count CLAMPED to qlen_side + 2w + 1: the banded DP can
  // never reach target rows beyond qlen + w (exactness note in
  // ops/chain2aln_jax.py — the device kernel clamps tl_n/tr_n per
  // attempt), and using the MAX retry band (2w) here means a task that
  // fits at try 0 also fits every band-doubling retry. Without the
  // clamp, chains spanning kb-scale repeat elements (rmax windows of
  // many kb) spill ~75% of repeat-genome tasks to the host scalar path.
  const int64_t W2 = ((int64_t)D.opt.w << 1) + 1;
  const int64_t ql = s.qbeg, qr = R.l_query - (s.qbeg + s.len);
  return R.dev_ok && ql <= D.qmax && qr <= D.qmax &&
         std::min(s.rbeg - R.rmax0, ql + W2) <= D.tmax &&
         std::min(R.rmax1 - (s.rbeg + s.len), qr + W2) <= D.tmax;
}

// advance the read's machine until a device task is pending or the read
// is done; oversized tasks run inline on the scalar kernel
void advance(Driver& D, ReadState& R) {
  const Opt& o = D.opt;
  while (true) {
    // need a fresh seed?
    while (R.cur_chain < R.chain_lo || R.k < 0) {
      int64_t next = (R.cur_chain < R.chain_lo) ? R.chain_lo
                                                : R.cur_chain + 1;
      if (next >= R.chain_hi) {
        R.done = true;
        --D.n_pending;
        return;
      }
      setup_chain(D, R, next);
    }
    const Seed s = R.seeds[R.srt[R.k]];
    if (seed_skippable(o, R, s, R.k)) {
      R.srt_alive[R.k] = 0;
      --R.k;
      continue;
    }
    R.cur = s;
    --R.k;
    if (task_fits(D, R, s)) {
      R.stage = 0;
      return;  // pending: pack() will pick it up
    }
    int64_t out[12];
    run_host(o, D, R, out);
    apply_tuple(o, R, out);
    ++D.n_host_tasks;
    if (s.qbeg > D.qmax || R.l_query - (s.qbeg + s.len) > D.qmax)
      ++D.n_host_q;
    else
      ++D.n_host_t;
  }
}

// Structural validation of one device result row — the processOutput
// analog (/root/reference/src/fpga/FPGAPipeline.cpp:29-130): every wave
// result is range-checked against its task's shape before being applied,
// at negligible cost and ON by default. Bounds follow the exact
// ksw_extend2 contract (ops/ksw.py): score in [h0, h0 + qlen*max_mat]
// (end_bonus only caps the band, it never enters the in-kernel max),
// qle in [0, qlen], tle/gtle in [0, tlen], and a degenerate side (qlen 0)
// returns exactly (h0, 0, 0, ...). A violating row can only come from a
// corrupted kernel/transfer; the caller raises and the pipeline degrades
// to the host path (setUseAccx(false) analog).
bool row_ok(const Driver& D, const ReadState& R, const int32_t* row) {
  const Opt& o = D.opt;
  int64_t amax = 0;
  for (int i = 0; i < 25; ++i)
    amax = std::max(amax, (int64_t)o.mat[i]);
  const Seed& s = R.cur;
  bool has_left = s.qbeg > 0;
  bool has_right = s.qbeg + s.len != R.l_query;
  int64_t ls = row[0], lq = row[1], lt = row[2], lg = row[3], lmo = row[5];
  int64_t rs = row[6], rq = row[7], rt = row[8], rg = row[9], rmo = row[11];
  int64_t qlen_l = s.qbeg, tlen_l = s.rbeg - R.rmax0;
  int64_t qlen_r = R.l_query - (s.qbeg + s.len);
  int64_t tlen_r = R.rmax1 - (s.rbeg + s.len);
  int64_t h0 = (int64_t)s.len * o.a;
  int64_t h0r;
  if (R.stage == 2) {
    h0r = R.lfinal[0];  // left half saved; row's left fields are unused
  } else {
    if (has_left) {
      if (lq < 0 || lq > qlen_l || lt < 0 || lt > tlen_l) return false;
      if (lg < 0 || lg > tlen_l) return false;
      if (ls < h0 || ls > h0 + qlen_l * amax) return false;
      if (lmo < 0 || lmo > std::max(qlen_l, tlen_l)) return false;
    } else if (ls != h0 || lq != 0 || lt != 0) {
      return false;
    }
    h0r = ls;
  }
  if (has_right) {
    if (rq < 0 || rq > qlen_r || rt < 0 || rt > tlen_r) return false;
    if (rg < 0 || rg > tlen_r) return false;
    if (rs < h0r || rs > h0r + qlen_r * amax) return false;
    if (rmo < 0 || rmo > std::max(qlen_r, tlen_r)) return false;
  } else if (rs != h0r || rq != 0 || rt != 0) {
    return false;
  }
  return true;
}

// apply one device row for R.cur (stage-0 wave task). bwa's band-
// doubling retries (bwamem.c:737-744) are detected from the row's
// max_off fields and recomputed INLINE on the exact scalar kernel
// (run_host re-runs both sides with the full doubling loops — identical
// output to a staged device retry, and retries are ~1% of tasks), so a
// read never re-enters the wave for the same seed and the speculative
// multi-task packing below stays a simple in-order walk.
void apply_row(Driver& D, ReadState& R, const int32_t* row) {
  const Opt& o = D.opt;
  int64_t W = o.w;
  int64_t RETRY_OFF = (W >> 1) + (W >> 2);
  bool has_left = R.cur.qbeg > 0;
  bool has_right = R.cur.qbeg + R.cur.len != R.l_query;
  int64_t ls = row[0], lq = row[1], lt = row[2], lg = row[3], lgs = row[4],
          lmo = row[5];
  int64_t rs = row[6], rq = row[7], rt = row[8], rg = row[9], rgs = row[10],
          rmo = row[11];
  bool retry = (has_left && lmo >= RETRY_OFF) ||
               (has_right && rs != ls && rmo >= RETRY_OFF);
  int64_t tuple[12];
  if (retry) {
    run_host(o, D, R, tuple);
    ++D.n_host_tasks;
    ++D.n_host_sched;
  } else {
    tuple[0] = ls; tuple[1] = lq; tuple[2] = lt; tuple[3] = lg;
    tuple[4] = lgs; tuple[5] = W;
    tuple[6] = rs; tuple[7] = rq; tuple[8] = rt; tuple[9] = rg;
    tuple[10] = rgs; tuple[11] = W;
  }
  apply_tuple(o, R, tuple);
}

// ------------------------------------------------------------------
// binding
// ------------------------------------------------------------------

void driver_destroy(PyObject* cap) {
  delete (Driver*)PyCapsule_GetPointer(cap, "bwa_wave_driver");
}

bool get_buf(PyObject* obj, Py_buffer* view, const char* name) {
  if (PyObject_GetBuffer(obj, view, PyBUF_SIMPLE) != 0) {
    PyErr_Format(PyExc_TypeError, "%s: expected a contiguous buffer", name);
    return false;
  }
  return true;
}

// create(seq_cat u8, seq_off i64[n+1], dev_ok u8[n],
//        chain_off i64[n+1], chain_rid i32[NC], chain_frac f64[NC],
//        seed_off i64[NC+1], seeds i64[NS*4],
//        pac u8, l_pac, ann_off i64[nc],
//        opt_ints i64[9], mat i8[25], qmax, tmax, cap)
PyObject* py_create(PyObject*, PyObject* args) {
  PyObject *seq_o, *seqoff_o, *devok_o, *choff_o, *chrid_o, *chfrac_o,
      *sdoff_o, *sds_o, *pac_o, *annoff_o, *opti_o, *mat_o;
  long long l_pac;
  int qmax, tmax, cap;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOLOOOiii", &seq_o, &seqoff_o,
                        &devok_o, &choff_o, &chrid_o, &chfrac_o, &sdoff_o,
                        &sds_o, &pac_o, &l_pac, &annoff_o, &opti_o, &mat_o,
                        &qmax, &tmax, &cap))
    return nullptr;
  PyObject* objs[] = {seq_o, seqoff_o, devok_o, choff_o, chrid_o,
                      chfrac_o, sdoff_o, sds_o, pac_o, annoff_o,
                      opti_o, mat_o};
  const int NB = 12;
  // pac may arrive as a shared RefBlock capsule (ann rides inside it and
  // annoff_o is then None) instead of raw buffers
  bool use_cap = PyCapsule_CheckExact(pac_o);
  Py_buffer bufs[NB];
  for (int i = 0; i < NB; ++i) {
    if (use_cap && (i == 8 || i == 9)) {
      std::memset(&bufs[i], 0, sizeof(Py_buffer));
      continue;
    }
    if (!get_buf(objs[i], &bufs[i], "arg")) {
      for (int j = 0; j < i; ++j)
        if (bufs[j].obj) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
  }
  Driver* D = new Driver();
  const int64_t* opti = (const int64_t*)bufs[10].buf;
  D->opt.a = (int32_t)opti[0];
  D->opt.o_del = (int32_t)opti[1];
  D->opt.e_del = (int32_t)opti[2];
  D->opt.o_ins = (int32_t)opti[3];
  D->opt.e_ins = (int32_t)opti[4];
  D->opt.w = (int32_t)opti[5];
  D->opt.zdrop = (int32_t)opti[6];
  D->opt.pen_clip5 = (int32_t)opti[7];
  D->opt.pen_clip3 = (int32_t)opti[8];
  std::memcpy(D->opt.mat, bufs[11].buf, 25);
  D->qmax = qmax;
  D->tmax = tmax;
  D->cap = cap;
  // own copies of the chain arrays (the Python side may free its bytes)
  auto copy64 = [](Py_buffer& b, std::vector<int64_t>* v) {
    v->assign((const int64_t*)b.buf,
              (const int64_t*)b.buf + b.len / 8);
  };
  copy64(bufs[3], &D->chain_off);
  D->chain_rid.assign((const int32_t*)bufs[4].buf,
                      (const int32_t*)bufs[4].buf + bufs[4].len / 4);
  D->chain_frac.assign((const double*)bufs[5].buf,
                       (const double*)bufs[5].buf + bufs[5].len / 8);
  copy64(bufs[6], &D->seed_off);
  copy64(bufs[7], &D->seeds_flat);
  D->seq_store.assign((const uint8_t*)bufs[0].buf,
                      (const uint8_t*)bufs[0].buf + bufs[0].len);
  copy64(bufs[1], &D->seq_off);
  // pac/ann borrowed? copy pac for safety (can be large; the caller's
  // arrays are cached per-index so borrowing would be fine — but a
  // dangling pointer on index reload is a worse failure mode)
  static_assert(sizeof(double) == 8, "");
  D->bns.l_pac = (int64_t)l_pac;
  if (use_cap) {
    // borrow pac/ann from the shared per-index RefBlock
    auto* rb = (RefBlock*)PyCapsule_GetPointer(pac_o, "bwa_refblock");
    if (!rb) {
      delete D;
      for (int j = 0; j < NB; ++j)
        if (bufs[j].obj) PyBuffer_Release(&bufs[j]);
      return nullptr;
    }
    D->bns.pac = rb->pac.data();
    D->bns.offsets = rb->ann.data();
    D->bns.n_ctg = (int64_t)rb->ann.size();
    Py_INCREF(pac_o);
    D->ref_cap = pac_o;
  } else {
    // copy pac + ann into driver-owned storage
    auto* pacv = new std::vector<uint8_t>(
        (const uint8_t*)bufs[8].buf,
        (const uint8_t*)bufs[8].buf + bufs[8].len);
    auto* annv = new std::vector<int64_t>(
        (const int64_t*)bufs[9].buf,
        (const int64_t*)bufs[9].buf + bufs[9].len / 8);
    D->bns.pac = pacv->data();
    D->bns.offsets = annv->data();
    D->bns.n_ctg = (int64_t)annv->size();
    D->pac_store = pacv;
    D->ann_store = annv;
  }
  const uint8_t* dev_ok = (const uint8_t*)bufs[2].buf;
  int64_t n = (int64_t)(bufs[2].len);
  D->reads.resize((size_t)n);
  D->stream_refs.resize(8);
  D->n_pending = n;
  D->chains.resize(D->seed_off.size() ? D->seed_off.size() - 1 : 0);
  for (int64_t r = 0; r < n; ++r) {
    ReadState& R = D->reads[r];
    R.seq = D->seq_store.data() + D->seq_off[r];
    R.l_query = (int32_t)(D->seq_off[r + 1] - D->seq_off[r]);
    R.dev_ok = dev_ok[r] != 0;
    R.chain_lo = D->chain_off[r];
    R.chain_hi = D->chain_off[r + 1];
    R.cur_chain = R.chain_lo - 1;
    R.k = -1;
    for (int64_t ci = R.chain_lo; ci < R.chain_hi; ++ci)
      chain_precompute(*D, R.l_query, ci);
    advance(*D, R);
  }
  for (int i = 0; i < NB; ++i)
    if (bufs[i].obj) PyBuffer_Release(&bufs[i]);
  return PyCapsule_New(D, "bwa_wave_driver", driver_destroy);
}

// pack(cap_obj, stream[, reserve]) -> (slots bytes i32[count],
//                                      desc bytes i64[11*cap])
//                          | None when nothing packable
// reserve > 0 leaves that many packable reads UNPACKED at the back of
// the batch for harvester threads (py_steal) to run on host CPUs while
// the wave is in flight — the accx_priority work split of the reference
// (kflow/include/kflow/MapStage.h:78-116) at read granularity.
//
// SPECULATIVE MULTI-TASK PACKING (round 4): one task per read per wave
// serializes a read's ~8 extension tasks across ~8 wave round trips and
// starves the device on the tail. Task INPUTS never depend on earlier
// results — only WHETHER a seed extends (seed_skippable) and the rare
// band retry do — so pack() walks each read's srt cursor ahead and packs
// up to S seeds per read (S adapts to fill the wave: cap/packable).
// Apply re-evaluates the skip test in exact bwa order and discards rows
// for seeds that became skippable (wasted device work, never wrong
// output); skippability only moves toward skip as regions accumulate,
// so the pack-time filter rarely overshoots. Wave slots are then sorted
// by clamped DP extent, so lanes of similar cost share a program
// segment (the small and large shape classes) instead of every lane
// paying the wave's max target length.
PyObject* py_pack(PyObject*, PyObject* args) {
  PyObject* cap_o;
  int stream;
  long long reserve = 0;
  long long qsmall = 0;
  if (!PyArg_ParseTuple(args, "Oi|LL", &cap_o, &stream, &reserve, &qsmall))
    return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  std::vector<Driver::SlotRef>& refs = D->stream_refs[stream];
  refs.clear();
  struct Cand {
    int32_t read, kpos;
    int64_t chain;
    int64_t rmax0, rmax1;
    int32_t qcls, cost;
    Seed s;
  };
  std::vector<Cand> cands;
  const int64_t W = D->opt.w;
  const int64_t W1 = W + 1;
  const int64_t W2 = (W << 1) + 1;
  std::lock_guard<std::mutex> guard(D->mu);
  int64_t limit = D->cap;
  int64_t packable = 0;
  for (const ReadState& R : D->reads)
    if (!R.in_flight && !R.done) ++packable;  // in_flight first: done
                                              // races while claimed
  if (reserve != 0) {
    // reserve < 0: auto — leave a quarter (cap 1024) for the harvesters
    int64_t res = reserve > 0
                      ? (int64_t)reserve
                      : std::min<int64_t>(1024, packable / 4);
    limit = std::min<int64_t>(limit, packable - res);
  }
  // speculation depth: DEPTH-FIRST — pack each claimed read's full
  // remaining task list (reads average ~5 tasks; S=8 covers p95) so a
  // read retires in ONE device round trip instead of re-entering a wave
  // per task (the reference ships all of a chain's seeds to the device
  // together, src/fpga/FPGAPipeline.cpp:194-343). A breadth-first
  // S=limit/packable collapses to 1 when packable ~ limit, which
  // measured 1.2k-task waves at cap 4096 and left 76% of tasks to the
  // host scalar kernel.
  const int64_t S = 8;
  auto cost_of = [&](int32_t l_query, int64_t rm0, int64_t rm1,
                     const Seed& s) {
    int64_t ql = s.qbeg, qr = l_query - (s.qbeg + s.len);
    int64_t tl = std::min<int64_t>(
        std::min<int64_t>(s.rbeg - rm0, ql + W1), D->tmax);
    int64_t tr = std::min<int64_t>(
        std::min<int64_t>(rm1 - (s.rbeg + s.len), qr + W1), D->tmax);
    return (int32_t)(tl + tr);
  };
  // qsmall > 0 partitions the wave into a small-shape class (both query
  // sides < qsmall -> the caller's (qsmall, qsmall+w+1) kernel variant)
  // and the full-shape class; n_small returns the boundary
  auto qcls_of = [&](int32_t l_query, const Seed& s) {
    if (qsmall <= 0) return 0;
    int64_t ql = s.qbeg, qr = l_query - (s.qbeg + s.len);
    return (ql <= qsmall && qr <= qsmall) ? 0 : 1;
  };
  // task_fits with an explicit rmax window (speculated chains)
  auto fits = [&](const ReadState& R, int64_t rm0, int64_t rm1,
                  const Seed& s) {
    int64_t ql = s.qbeg, qr = R.l_query - (s.qbeg + s.len);
    return R.dev_ok && ql <= D->qmax && qr <= D->qmax &&
           std::min<int64_t>(s.rbeg - rm0, ql + W2) <= D->tmax &&
           std::min<int64_t>(rm1 - (s.rbeg + s.len), qr + W2) <= D->tmax;
  };
  for (int64_t r = 0;
       r < (int64_t)D->reads.size() && (int64_t)cands.size() < limit;
       ++r) {
    ReadState& R = D->reads[r];
    if (R.in_flight || R.done) continue;  // in_flight first (see above)
    // pending task exists by construction (advance leaves one)
    cands.push_back(Cand{(int32_t)r, -1, R.cur_chain, R.rmax0, R.rmax1,
                         qcls_of(R.l_query, R.cur),
                         cost_of(R.l_query, R.rmax0, R.rmax1, R.cur),
                         R.cur});
    R.in_flight = true;
    R.slots_in_wave = 1;
    // speculate further seeds of the current chain
    for (int32_t j = R.k;
         j >= 0 && R.slots_in_wave < S && (int64_t)cands.size() < limit;
         --j) {
      const Seed& s = R.seeds[R.srt[j]];
      if (seed_skippable(D->opt, R, s, j)) continue;  // predicted skip
      if (!fits(R, R.rmax0, R.rmax1, s)) continue;  // host at apply time
      cands.push_back(Cand{(int32_t)r, j, R.cur_chain, R.rmax0, R.rmax1,
                           qcls_of(R.l_query, s),
                           cost_of(R.l_query, R.rmax0, R.rmax1, s), s});
      ++R.slots_in_wave;
    }
    // cross-chain speculation: chain rmax/srt are precomputed (result-
    // independent), so later chains pack the same way; apply() walks the
    // chain transitions in exact order and re-validates every skip test
    for (int64_t ci = R.cur_chain + 1;
         ci < R.chain_hi && R.slots_in_wave < S &&
         (int64_t)cands.size() < limit;
         ++ci) {
      const ChainPre& P = D->chains[ci];
      auto sfn = [&](int32_t idx) { return seed_at(*D, ci, idx); };
      for (int32_t j = (int32_t)P.srt.size() - 1;
           j >= 0 && R.slots_in_wave < S && (int64_t)cands.size() < limit;
           --j) {
        const Seed s = seed_at(*D, ci, P.srt[j]);
        if (skip_test(D->opt, R.regs, R.l_query, sfn, P.srt, nullptr,
                      s, j))
          continue;  // predicted skip (re-validated at apply)
        if (!fits(R, P.rmax0, P.rmax1, s)) continue;
        cands.push_back(Cand{(int32_t)r, j, ci, P.rmax0, P.rmax1,
                             qcls_of(R.l_query, s),
                             cost_of(R.l_query, P.rmax0, P.rmax1, s), s});
        ++R.slots_in_wave;
      }
    }
  }
  int64_t count = (int64_t)cands.size();
  if (!count) Py_RETURN_NONE;
  // cost-homogeneous tiles: stable sort by (shape class, DP extent)
  std::vector<int32_t> order(cands.size());
  for (size_t i = 0; i < cands.size(); ++i) order[i] = (int32_t)i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) {
                     if (cands[a].qcls != cands[b].qcls)
                       return cands[a].qcls < cands[b].qcls;
                     return cands[a].cost < cands[b].cost;
                   });
  int64_t n_small = 0;
  for (const Cand& c : cands)
    if (c.qcls == 0) ++n_small;
  std::vector<int64_t> desc((size_t)DESC_ROWS * D->cap, 0);
  for (int64_t t = 0; t < D->cap; ++t) {
    desc[7 * D->cap + t] = 1;   // h0
    desc[8 * D->cap + t] = 1;   // wl
    desc[9 * D->cap + t] = 1;   // wr
  }
  std::vector<int32_t> slots;
  slots.reserve(cands.size());
  refs.reserve(cands.size());
  for (int64_t t = 0; t < count; ++t) {
    const Cand& c = cands[order[t]];
    const ReadState& R = D->reads[c.read];
    desc[0 * D->cap + t] = c.read;
    desc[1 * D->cap + t] = c.s.qbeg;
    desc[2 * D->cap + t] = c.s.len;
    desc[3 * D->cap + t] = R.l_query;
    desc[4 * D->cap + t] = c.s.rbeg;
    desc[5 * D->cap + t] = c.rmax0;
    desc[6 * D->cap + t] = c.rmax1;
    desc[7 * D->cap + t] = (int64_t)c.s.len * D->opt.a;
    desc[8 * D->cap + t] = W;
    desc[9 * D->cap + t] = W;
    desc[10 * D->cap + t] = 0;
    refs.push_back(Driver::SlotRef{c.read, c.kpos, c.chain});
    slots.push_back(c.read);
  }
  return Py_BuildValue(
      "(NNL)",
      PyBytes_FromStringAndSize((const char*)slots.data(),
                                (Py_ssize_t)(slots.size() * 4)),
      PyBytes_FromStringAndSize((const char*)desc.data(),
                                (Py_ssize_t)(desc.size() * 8)),
      (long long)n_small);
}

// apply(cap_obj, stream, out bytes i32[12*width]) — width is inferred
// from the buffer (the driver buckets wave widths below cap so tail
// waves run small device programs).
//
// Slots arrive cost-sorted (tile homogeneity); semantically each read's
// seeds must be processed in srt order with the skip test evaluated
// against the regions accumulated SO FAR (exact bwa semantics,
// bwamem.c:700-714), so apply re-orders processing by (read, kpos desc,
// pending-task first) and walks each read's cursor: unpacked seeds in
// between are either (re-confirmed) skippable — marked dead — or run
// inline on the scalar kernel; packed seeds re-evaluate the skip test
// and discard their device row when it now says skip.
PyObject* py_apply(PyObject*, PyObject* args) {
  PyObject *cap_o, *out_o;
  int stream;
  if (!PyArg_ParseTuple(args, "OiO", &cap_o, &stream, &out_o))
    return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  Py_buffer ob;
  if (!get_buf(out_o, &ob, "out")) return nullptr;
  const int32_t* out = (const int32_t*)ob.buf;
  int64_t width = (int64_t)(ob.len / (Py_ssize_t)(4 * OUT_ROWS));
  std::vector<Driver::SlotRef> refs = D->stream_refs[stream];
  if ((int64_t)refs.size() > width) {
    PyBuffer_Release(&ob);
    PyErr_SetString(PyExc_ValueError, "apply: result narrower than wave");
    return nullptr;
  }
  // processing order: by read, chain ascending, pending task (-1) first
  // within its chain, then kpos descending (the cursor walks downward)
  std::vector<int32_t> proc(refs.size());
  for (size_t i = 0; i < proc.size(); ++i) proc[i] = (int32_t)i;
  std::stable_sort(proc.begin(), proc.end(), [&](int32_t a, int32_t b) {
    if (refs[a].read != refs[b].read) return refs[a].read < refs[b].read;
    if (refs[a].chain != refs[b].chain)
      return refs[a].chain < refs[b].chain;
    int32_t ka = refs[a].kpos < 0 ? INT32_MAX : refs[a].kpos;
    int32_t kb = refs[b].kpos < 0 ? INT32_MAX : refs[b].kpos;
    return ka > kb;
  });
  int64_t bad = -1;
  Py_BEGIN_ALLOW_THREADS
  {
    // hold mu across the whole batch: apply mutates read state and
    // in_flight must stay set until the read's last slot finishes (a
    // harvester claiming a half-applied read would race its mutation)
    std::lock_guard<std::mutex> guard(D->mu);
    for (size_t pi = 0; pi < proc.size() && bad < 0; ++pi) {
      const Driver::SlotRef ref = refs[proc[pi]];
      ReadState& R = D->reads[ref.read];
      int32_t row[OUT_ROWS];
      for (int f = 0; f < OUT_ROWS; ++f)
        row[f] = out[(int64_t)f * width + (int64_t)proc[pi]];
      if (ref.kpos < 0) {
        // the advance()-selected pending task: skip test already done
        R.stage = 0;
        if (!row_ok(*D, R, row)) {
          bad = (int64_t)ref.read;
          break;
        }
        apply_row(*D, R, row);
      } else {
        // cross-chain slot: finish the current chain's cursor, resolve
        // any chains in between in full, then enter the slot's chain
        // (exact bwa order — each seed skip-or-run against the regions
        // accumulated so far)
        while (R.cur_chain < ref.chain) {
          while (R.k >= 0) {
            const Seed s = R.seeds[R.srt[R.k]];
            if (seed_skippable(D->opt, R, s, R.k)) {
              R.srt_alive[R.k] = 0;
            } else {
              R.cur = s;
              int64_t t[12];
              run_host(D->opt, *D, R, t);
              apply_tuple(D->opt, R, t);
              ++D->n_host_tasks;
              if (s.qbeg > D->qmax ||
                  R.l_query - (s.qbeg + s.len) > D->qmax)
                ++D->n_host_q;
              else if (!task_fits(*D, R, s))
                ++D->n_host_t;
              else
                ++D->n_host_sched;
            }
            --R.k;
          }
          setup_chain(*D, R, R.cur_chain < R.chain_lo
                                 ? R.chain_lo
                                 : R.cur_chain + 1);
        }
        // walk the cursor down to the speculated seed, resolving the
        // seeds in between exactly in order
        while (R.k > ref.kpos) {
          const Seed s = R.seeds[R.srt[R.k]];
          if (seed_skippable(D->opt, R, s, R.k)) {
            R.srt_alive[R.k] = 0;
          } else {
            // unpacked (oversized or past the spec budget): run now
            R.cur = s;
            int64_t t[12];
            run_host(D->opt, *D, R, t);
            apply_tuple(D->opt, R, t);
            ++D->n_host_tasks;
            if (s.qbeg > D->qmax ||
                R.l_query - (s.qbeg + s.len) > D->qmax)
              ++D->n_host_q;
            else if (!task_fits(*D, R, s))
              ++D->n_host_t;
            else
              ++D->n_host_sched;
          }
          --R.k;
        }
        const Seed s = R.seeds[R.srt[R.k]];
        if (seed_skippable(D->opt, R, s, R.k)) {
          R.srt_alive[R.k] = 0;  // became skippable: discard the row
        } else {
          R.cur = s;
          R.stage = 0;
          if (!row_ok(*D, R, row)) {
            bad = (int64_t)ref.read;
            break;
          }
          apply_row(*D, R, row);
        }
        --R.k;
      }
      if (--R.slots_in_wave == 0) {
        advance(*D, R);
        R.in_flight = false;
      }
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&ob);
  if (bad >= 0) {
    PyErr_Format(PyExc_ValueError,
                 "apply: structurally invalid device result for read %lld "
                 "(corrupted wave)", (long long)bad);
    return nullptr;
  }
  Py_RETURN_NONE;
}

// drain(cap_obj) -> n finished: run every pending (not in-flight) read to
// completion on the exact scalar kernel. Tail waves with a handful of
// tasks cost a full device round trip (~fixed RPC latency) but only ~ms
// on the host; the driver calls this instead of packing a near-empty
// wave (the accx_priority CPU+accelerator sharing of the reference,
// kflow/include/kflow/MapStage.h:78-116, at wave granularity). run_host
// recomputes band-doubling from scratch, which is exact regardless of
// the read's retry stage.
// claim up to max_reads pending reads (scanning back-to-front, so the
// wave packer scanning front-to-back collides last) and run each to
// completion on the exact scalar kernel; returns tasks run. run_host
// recomputes band-doubling from scratch, which is exact regardless of
// the read's retry stage, so host- and device-finished reads produce
// identical regions.
int64_t steal_run(Driver& D, int64_t max_reads) {
  std::vector<ReadState*> mine;
  {
    std::lock_guard<std::mutex> guard(D.mu);
    for (int64_t r = (int64_t)D.reads.size() - 1;
         r >= 0 && (int64_t)mine.size() < max_reads; --r) {
      ReadState& R = D.reads[r];
      if (!R.in_flight && !R.done) {  // in_flight first (see py_pack)
        R.in_flight = true;  // claim: pack/steal/apply skip it
        mine.push_back(&R);
      }
    }
  }
  int64_t tasks = 0;
  for (ReadState* Rp : mine) {
    ReadState& R = *Rp;
    while (!R.done) {
      int64_t out[12];
      run_host(D.opt, D, R, out);
      apply_tuple(D.opt, R, out);
      ++D.n_host_tasks;
      ++D.n_host_sched;
      advance(D, R);
      ++tasks;
    }
  }
  {
    // release the claims under mu so the packer's reads of done (made
    // only for reads it sees un-claimed) are ordered after our writes
    std::lock_guard<std::mutex> guard(D.mu);
    for (ReadState* Rp : mine) Rp->in_flight = false;
  }
  return tasks;
}

PyObject* py_drain(PyObject*, PyObject* args) {
  PyObject* cap_o;
  if (!PyArg_ParseTuple(args, "O", &cap_o)) return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  int64_t done = 0;
  Py_BEGIN_ALLOW_THREADS
  done = steal_run(*D, (int64_t)D->reads.size());
  Py_END_ALLOW_THREADS
  return PyLong_FromLongLong((long long)done);
}

// steal(cap_obj, max_reads) -> tasks run; harvester-thread entry (GIL
// released for the whole claim+compute)
PyObject* py_steal(PyObject*, PyObject* args) {
  PyObject* cap_o;
  long long max_reads;
  if (!PyArg_ParseTuple(args, "OL", &cap_o, &max_reads)) return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  int64_t tasks = 0;
  Py_BEGIN_ALLOW_THREADS
  tasks = steal_run(*D, (int64_t)max_reads);
  Py_END_ALLOW_THREADS
  return PyLong_FromLongLong((long long)tasks);
}

PyObject* py_n_pending(PyObject*, PyObject* args) {
  PyObject* cap_o;
  if (!PyArg_ParseTuple(args, "O", &cap_o)) return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  return PyLong_FromLongLong((long long)D->n_pending);
}

PyObject* py_host_tasks(PyObject*, PyObject* args) {
  PyObject* cap_o;
  if (!PyArg_ParseTuple(args, "O", &cap_o)) return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  return PyLong_FromLongLong((long long)D->n_host_tasks);
}

// host_breakdown(cap_obj) -> (oversize_q, oversize_t, sched)
// why tasks ran on the scalar kernel: query side > qmax, clamped target
// span > tmax (or !dev_ok), or drain/steal scheduling
PyObject* py_host_breakdown(PyObject*, PyObject* args) {
  PyObject* cap_o;
  if (!PyArg_ParseTuple(args, "O", &cap_o)) return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  return Py_BuildValue("(LLL)", (long long)D->n_host_q,
                       (long long)D->n_host_t,
                       (long long)D->n_host_sched);
}

// finish(cap_obj) -> (rows bytes i64[NR*12], frac bytes f64[NR],
//                     off bytes i64[n+1])
PyObject* py_finish(PyObject*, PyObject* args) {
  PyObject* cap_o;
  if (!PyArg_ParseTuple(args, "O", &cap_o)) return nullptr;
  Driver* D = (Driver*)PyCapsule_GetPointer(cap_o, "bwa_wave_driver");
  if (!D) return nullptr;
  int64_t n = (int64_t)D->reads.size();
  int64_t total = 0;
  for (const ReadState& R : D->reads) total += (int64_t)R.regs.size();
  std::vector<int64_t> rows((size_t)total * REG_NF);
  std::vector<double> frac((size_t)total);
  std::vector<int64_t> off((size_t)n + 1, 0);
  int64_t w = 0;
  for (int64_t r = 0; r < n; ++r) {
    for (const Reg& p : D->reads[r].regs) {
      int64_t* f = rows.data() + w * REG_NF;
      f[0] = p.rb; f[1] = p.re; f[2] = p.qb; f[3] = p.qe; f[4] = p.rid;
      f[5] = p.score; f[6] = p.truesc; f[7] = p.w; f[8] = p.seedcov;
      f[9] = p.seedlen0; f[10] = p.csub; f[11] = p.is_alt;
      frac[w] = p.frac_rep;
      ++w;
    }
    off[r + 1] = w;
  }
  return Py_BuildValue(
      "(NNN)",
      PyBytes_FromStringAndSize((const char*)rows.data(),
                                (Py_ssize_t)(rows.size() * 8)),
      PyBytes_FromStringAndSize((const char*)frac.data(),
                                (Py_ssize_t)(frac.size() * 8)),
      PyBytes_FromStringAndSize((const char*)off.data(),
                                (Py_ssize_t)(off.size() * 8)));
}

// make_ref(pac u8, ann_off i64[nc]) -> capsule owning a shared RefBlock
PyObject* py_make_ref(PyObject*, PyObject* args) {
  PyObject *pac_o, *ann_o;
  if (!PyArg_ParseTuple(args, "OO", &pac_o, &ann_o)) return nullptr;
  Py_buffer pb, ab;
  if (!get_buf(pac_o, &pb, "pac")) return nullptr;
  if (!get_buf(ann_o, &ab, "ann")) {
    PyBuffer_Release(&pb);
    return nullptr;
  }
  auto* rb = new RefBlock();
  rb->pac.assign((const uint8_t*)pb.buf, (const uint8_t*)pb.buf + pb.len);
  rb->ann.assign((const int64_t*)ab.buf,
                 (const int64_t*)ab.buf + ab.len / 8);
  PyBuffer_Release(&pb);
  PyBuffer_Release(&ab);
  return PyCapsule_New(rb, "bwa_refblock", refblock_free);
}

PyMethodDef methods[] = {
    {"create", py_create, METH_VARARGS, "create a wave driver"},
    {"make_ref", py_make_ref, METH_VARARGS,
     "copy pac/ann once into a shared per-index block"},
    {"pack", py_pack, METH_VARARGS, "pack the next wave for a stream"},
    {"apply", py_apply, METH_VARARGS, "apply device results for a stream"},
    {"steal", py_steal, METH_VARARGS,
     "claim+run up to max_reads pending reads on the scalar kernel"},
    {"drain", py_drain, METH_VARARGS,
     "finish all pending reads on the scalar kernel"},
    {"n_pending", py_n_pending, METH_VARARGS, "reads not yet finished"},
    {"host_tasks", py_host_tasks, METH_VARARGS,
     "count of tasks run inline on the scalar kernel"},
    {"host_breakdown", py_host_breakdown, METH_VARARGS,
     "(oversize_q, oversize_t, sched) host-task causes"},
    {"finish", py_finish, METH_VARARGS, "collect packed regions"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_wave",
                                "bwa_flow_tpu native wave driver", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit__wave(void) { return PyModule_Create(&moduledef); }
