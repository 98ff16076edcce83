// bwa_flow_tpu native host kernels (CPython extension).
//
// The reference keeps its host hot loops in C (banded Smith-Waterman,
// /root/reference/bwa/ksw.c); this module provides the same role for the
// framework's *host-side* work: CIGAR generation (banded global
// alignment + traceback) and the scalar extension fallback. Both are
// C++ ports of this repo's own golden NumPy specifications
// (bwa_flow_tpu/ops/ksw.py) — integer-exact against them, enforced by
// tests/test_native.py.
//
// Build: python setup.py build_ext --inplace  (g++, no external deps)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "ksw_impl.h"
#include "sais_impl.h"

namespace {

using bwaflow::Ext2Result;
using bwaflow::ksw_extend2;
using bwaflow::ksw_global2;

bool get_u8(PyObject* obj, Py_buffer* view, const char* name) {
  if (PyObject_GetBuffer(obj, view, PyBUF_SIMPLE) != 0) {
    PyErr_Format(PyExc_TypeError, "%s: expected a contiguous buffer", name);
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------
// SA re-sampling: densify the sampled suffix array by enumerating the
// full LF orbit from the stock samples.
//
// bwa ships sa_intv=32 (bwa/bwtindex.c), so every SA lookup walks ~16
// LF steps — at Gbp scale those walks dominate the device seeding cost
// (each step is one HBM row gather). A denser sample (intv 4-16) costs
// host RAM/HBM instead. Rather than walking per target row (~intv_old
// steps per target), this enumerates: the LF map is a single cycle over
// all seq_len+1 rows; the stock samples cut it into arcs of expected
// length intv_old. Each arc start has a known SA value (row 0's value
// is seq_len: inv_psi(primary)=0, so row 0 precedes value seq_len-1 on
// the cycle; bwa's stored sentinel sa[0]=-1 is re-applied at the end),
// values decrement along LF, and every row is visited EXACTLY ONCE —
// seq_len+1 total fused-LF steps for any target interval. Arcs are
// pulled from an atomic queue by K-way interleaved walkers per thread
// (independent chains → overlapping cache misses).
// ---------------------------------------------------------------------

struct FMView {
  const int32_t* blocks;  // [n_blocks, 8]
  const int64_t* L2;      // [5]
  int64_t primary;
  int64_t seq_len;
};

// LF step, exact bwa/bwt.c:53-59 semantics (ops/fm.py inv_psi; the
// symbol row and the occ row coincide for k != primary, so one 32-byte
// row read serves both)
inline int64_t inv_psi1(const FMView& f, int64_t k) {
  if (k == f.primary) return 0;
  int64_t kk = k - (k >= f.primary);
  const int32_t* row = f.blocks + (kk >> 6) * 8;
  int off = (int)(kk & 63);
  const uint32_t* words = (const uint32_t*)(row + 4);
  uint32_t word = words[off >> 4];
  int c = (int)((word >> ((15 - (off & 15)) << 1)) & 3u);
  uint32_t pat = (uint32_t)c * 0x55555555u;
  int64_t cnt = (int64_t)(uint32_t)row[c];
  int n = off + 1;
  int w = 0;
  while (n >= 16) {
    uint32_t x = ~(words[w] ^ pat);
    cnt += __builtin_popcount(x & (x >> 1) & 0x55555555u);
    ++w;
    n -= 16;
  }
  if (n > 0) {
    uint32_t x = ~(words[w] ^ pat);
    uint32_t hits = x & (x >> 1) & 0x55555555u;
    uint32_t keep = ~((1u << (2 * (16 - n))) - 1);  // first n = top 2n bits
    cnt += __builtin_popcount(hits & keep);
  }
  return f.L2[c] + cnt;
}

void resample_worker(const FMView f, const int64_t* sa_old,
                     int64_t n_lanes, int64_t old_intv, int64_t new_intv,
                     int64_t* out, std::atomic<int64_t>* next_lane) {
  constexpr int K = 16;  // interleaved arcs: overlapping HBM-miss chains
  int64_t row[K], val[K];
  bool live[K];
  int n_live = 0;
  auto refill = [&](int j) {
    int64_t i = next_lane->fetch_add(1, std::memory_order_relaxed);
    if (i >= n_lanes) {
      live[j] = false;
      return false;
    }
    row[j] = i * old_intv;
    val[j] = (i == 0) ? f.seq_len : sa_old[i];
    live[j] = true;
    return true;
  };
  for (int j = 0; j < K; ++j) n_live += refill(j) ? 1 : 0;
  int64_t mask_new = new_intv - 1, mask_old = old_intv - 1;
  while (n_live > 0) {
    for (int j = 0; j < K; ++j) {
      if (!live[j]) continue;
      int64_t kk = row[j] - (row[j] >= f.primary);
      __builtin_prefetch(f.blocks + (kk >> 6) * 8);
    }
    for (int j = 0; j < K; ++j) {
      if (!live[j]) continue;
      if ((row[j] & mask_new) == 0) out[row[j] / new_intv] = val[j];
      int64_t nr = inv_psi1(f, row[j]);
      --val[j];
      if ((nr & mask_old) == 0) {  // next arc belongs to another lane
        if (!refill(j)) --n_live;
      } else {
        row[j] = nr;
      }
    }
  }
}

// sa_resample(fm_blocks int32 buf, L2 int64[5] buf, primary LL,
//             seq_len LL, sa_old int64 buf, old_intv i, new_intv i,
//             n_threads i) -> bytes(int64[seq_len//new_intv + 1])
PyObject* py_sa_resample(PyObject*, PyObject* args) {
  PyObject *blocks_o, *l2_o, *sa_o;
  long long primary, seq_len;
  int old_intv, new_intv, n_threads;
  if (!PyArg_ParseTuple(args, "OOLLOiii", &blocks_o, &l2_o, &primary,
                        &seq_len, &sa_o, &old_intv, &new_intv, &n_threads))
    return nullptr;
  Py_buffer bb, lb, sb;
  if (!get_u8(blocks_o, &bb, "fm_blocks")) return nullptr;
  if (!get_u8(l2_o, &lb, "L2")) { PyBuffer_Release(&bb); return nullptr; }
  if (!get_u8(sa_o, &sb, "sa")) {
    PyBuffer_Release(&bb);
    PyBuffer_Release(&lb);
    return nullptr;
  }
  if (new_intv <= 0 || old_intv <= 0 || (new_intv & (new_intv - 1)) ||
      (old_intv & (old_intv - 1)) || old_intv % new_intv != 0) {
    PyBuffer_Release(&bb); PyBuffer_Release(&lb); PyBuffer_Release(&sb);
    PyErr_SetString(PyExc_ValueError,
                    "sa_resample: intervals must be pow2, new | old");
    return nullptr;
  }
  FMView f{(const int32_t*)bb.buf, (const int64_t*)lb.buf,
           (int64_t)primary, (int64_t)seq_len};
  const int64_t* sa_old = (const int64_t*)sb.buf;
  int64_t n_lanes = (int64_t)(sb.len / 8);
  int64_t n_new = seq_len / new_intv + 1;
  PyObject* out_b = PyBytes_FromStringAndSize(nullptr,
                                              (Py_ssize_t)(n_new * 8));
  if (!out_b) {
    PyBuffer_Release(&bb); PyBuffer_Release(&lb); PyBuffer_Release(&sb);
    return nullptr;
  }
  int64_t* out = (int64_t*)PyBytes_AS_STRING(out_b);
  Py_BEGIN_ALLOW_THREADS
  std::atomic<int64_t> next_lane{0};
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; ++t)
    ths.emplace_back(resample_worker, f, sa_old, n_lanes,
                     (int64_t)old_intv, (int64_t)new_intv, out,
                     &next_lane);
  for (auto& th : ths) th.join();
  out[0] = -1;  // bwa sentinel (bwa/bwt.c:83)
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&bb);
  PyBuffer_Release(&lb);
  PyBuffer_Release(&sb);
  return out_b;
}

// ---------------------------------------------------------------------
// Python bindings
// ---------------------------------------------------------------------

PyObject* py_extend2(PyObject*, PyObject* args) {
  int qlen, tlen, m, o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0;
  PyObject *qo, *to, *mo;
  if (!PyArg_ParseTuple(args, "iOiOOiiiiiiiii", &qlen, &qo, &tlen, &to,
                        &mo, &m, &o_del, &e_del, &o_ins, &e_ins, &w,
                        &end_bonus, &zdrop, &h0))
    return nullptr;
  Py_buffer qb, tb, mb;
  if (!get_u8(qo, &qb, "query")) return nullptr;
  if (!get_u8(to, &tb, "target")) { PyBuffer_Release(&qb); return nullptr; }
  if (!get_u8(mo, &mb, "mat")) {
    PyBuffer_Release(&qb);
    PyBuffer_Release(&tb);
    return nullptr;
  }
  Ext2Result r = ksw_extend2(
      qlen, (const uint8_t*)qb.buf, tlen, (const uint8_t*)tb.buf,
      (const int8_t*)mb.buf, m, o_del, e_del, o_ins, e_ins, w, end_bonus,
      zdrop, h0);
  PyBuffer_Release(&qb);
  PyBuffer_Release(&tb);
  PyBuffer_Release(&mb);
  return Py_BuildValue("(LLLLLL)", (long long)r.score, (long long)r.qle,
                       (long long)r.tle, (long long)r.gtle,
                       (long long)r.gscore, (long long)r.max_off);
}

PyObject* py_global2(PyObject*, PyObject* args) {
  int qlen, tlen, m, o_del, e_del, o_ins, e_ins, w, want_cigar = 1;
  PyObject *qo, *to, *mo;
  if (!PyArg_ParseTuple(args, "iOiOOiiiiii|p", &qlen, &qo, &tlen, &to,
                        &mo, &m, &o_del, &e_del, &o_ins, &e_ins, &w,
                        &want_cigar))
    return nullptr;
  Py_buffer qb, tb, mb;
  if (!get_u8(qo, &qb, "query")) return nullptr;
  if (!get_u8(to, &tb, "target")) { PyBuffer_Release(&qb); return nullptr; }
  if (!get_u8(mo, &mb, "mat")) {
    PyBuffer_Release(&qb);
    PyBuffer_Release(&tb);
    return nullptr;
  }
  std::vector<std::pair<int, int>> cig;
  int64_t score = ksw_global2(
      qlen, (const uint8_t*)qb.buf, tlen, (const uint8_t*)tb.buf,
      (const int8_t*)mb.buf, m, o_del, e_del, o_ins, e_ins, w,
      want_cigar != 0, &cig);
  PyBuffer_Release(&qb);
  PyBuffer_Release(&tb);
  PyBuffer_Release(&mb);
  PyObject* clist = PyList_New((Py_ssize_t)cig.size());
  for (Py_ssize_t i = 0; i < (Py_ssize_t)cig.size(); ++i)
    PyList_SET_ITEM(clist, i,
                    Py_BuildValue("(ii)", cig[i].first, cig[i].second));
  PyObject* ret = Py_BuildValue("(LN)", (long long)score, clist);
  return ret;
}

PyObject* py_align2(PyObject*, PyObject* args) {
  int qlen, tlen, m, o_del, e_del, o_ins, e_ins, xtra;
  PyObject *qo, *to, *mo;
  if (!PyArg_ParseTuple(args, "iOiOOiiiiii", &qlen, &qo, &tlen, &to, &mo,
                        &m, &o_del, &e_del, &o_ins, &e_ins, &xtra))
    return nullptr;
  Py_buffer qb, tb, mb;
  if (!get_u8(qo, &qb, "query")) return nullptr;
  if (!get_u8(to, &tb, "target")) { PyBuffer_Release(&qb); return nullptr; }
  if (!get_u8(mo, &mb, "mat")) {
    PyBuffer_Release(&qb);
    PyBuffer_Release(&tb);
    return nullptr;
  }
  bwaflow::KswResult r = bwaflow::ksw_align2(
      qlen, (const uint8_t*)qb.buf, tlen, (const uint8_t*)tb.buf,
      (const int8_t*)mb.buf, m, o_del, e_del, o_ins, e_ins, xtra);
  PyBuffer_Release(&qb);
  PyBuffer_Release(&tb);
  PyBuffer_Release(&mb);
  return Py_BuildValue("(LLLLLLL)", (long long)r.score, (long long)r.te,
                       (long long)r.qe, (long long)r.score2,
                       (long long)r.te2, (long long)r.tb,
                       (long long)r.qb);
}

// sais(seq_u8 [n], K) -> bytes int64[n+1] — suffix array of
// seq + implicit minimal sentinel (out[0] == n). Production index
// construction at any scale (the reference's is.c/bwt_gen.c role).
PyObject* py_sais(PyObject*, PyObject* args) {
  PyObject* so;
  long long K = 4;
  if (!PyArg_ParseTuple(args, "O|L", &so, &K)) return nullptr;
  Py_buffer sb;
  if (!get_u8(so, &sb, "seq")) return nullptr;
  int64_t n = (int64_t)sb.len;
  PyObject* out =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)((n + 1) * 8));
  if (!out) {
    PyBuffer_Release(&sb);
    return nullptr;
  }
  int64_t* sa = (int64_t*)PyBytes_AS_STRING(out);
  Py_BEGIN_ALLOW_THREADS
  bwaflow_sais::sais<uint8_t>((const uint8_t*)sb.buf, n, (int64_t)K, sa);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&sb);
  return out;
}

PyMethodDef methods[] = {
    {"sais", py_sais, METH_VARARGS,
     "SA-IS suffix array of a small-alphabet text (+ sentinel)"},
    {"ksw_extend2", py_extend2, METH_VARARGS,
     "scalar banded extension (exact golden semantics)"},
    {"ksw_align2", py_align2, METH_VARARGS,
     "local alignment with sub-score (exact golden semantics)"},
    {"ksw_global2", py_global2, METH_VARARGS,
     "banded global alignment + CIGAR (exact golden semantics)"},
    {"sa_resample", py_sa_resample, METH_VARARGS,
     "densify a sampled SA by LF-orbit enumeration (multithreaded)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_native",
                                "bwa_flow_tpu native host kernels", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moduledef); }
