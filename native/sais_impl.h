// SA-IS suffix array construction (induced sorting), int64 indices.
//
// framework's production index builder — the equivalent of the
// reference's offline suffix-array/BWT construction suite
// (/root/reference/bwa/is.c (SA-IS for short refs), bwt_gen.c:1-1629 (the
// blockwise BWT-SW used at Gbp scale), driven by bwa/bwtindex.c:210-324).
// Unlike the reference, one in-memory SA-IS serves every scale: with
// int64 indices and a bit-packed type array, peak memory is
// ~9 bytes/symbol (human fwd+rc, 6.2e9 symbols: ~56 GB), and a single
// pass takes minutes where bwtsw took ~108 (measured: stock `bwa index`
// on the 3.1 Gbp fixture = 6,518 CPU-seconds).
//
// This is an original implementation of the published SA-IS algorithm
// (Nong, Zhang & Chan, DCC'09): classify suffix types, induce-sort from
// LMS positions, name LMS substrings, recurse on the reduced text while
// reusing the tail of the SA buffer, induce the final order.
//
// Contract: text s[0..n-1] over alphabet [0, K); s[n-1] is the unique
// minimum (sentinel). SA receives the full suffix order.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace bwaflow_sais {

using i64 = int64_t;

// bit-packed suffix-type array: bit set = S-type
struct TypeBits {
  std::vector<uint64_t> w;
  explicit TypeBits(i64 n) : w((size_t)((n + 63) >> 6), 0) {}
  inline bool get(i64 i) const {
    return (w[(size_t)(i >> 6)] >> (i & 63)) & 1;
  }
  inline void set(i64 i, bool v) {
    uint64_t m = 1ull << (i & 63);
    if (v)
      w[(size_t)(i >> 6)] |= m;
    else
      w[(size_t)(i >> 6)] &= ~m;
  }
};

// LMS position: S-type whose left neighbor is L-type
template <class T>
static inline bool is_lms(const TypeBits& tb, i64 i) {
  return i > 0 && tb.get(i) && !tb.get(i - 1);
}

template <class T>
static void count_symbols(const T* s, i64 n, i64 K, std::vector<i64>* cnt) {
  cnt->assign((size_t)K, 0);
  for (i64 i = 0; i < n; ++i) ++(*cnt)[(size_t)s[i]];
}

static void bucket_starts(const std::vector<i64>& cnt, std::vector<i64>* b) {
  b->resize(cnt.size());
  i64 acc = 0;
  for (size_t c = 0; c < cnt.size(); ++c) {
    (*b)[c] = acc;
    acc += cnt[c];
  }
}

static void bucket_ends(const std::vector<i64>& cnt, std::vector<i64>* b) {
  b->resize(cnt.size());
  i64 acc = 0;
  for (size_t c = 0; c < cnt.size(); ++c) {
    acc += cnt[c];
    (*b)[c] = acc;  // one past the last slot of bucket c
  }
}

// induce L-type order from the placed entries, then S-type (one full
// left-to-right pass + one right-to-left pass)
template <class T>
static void induce(const T* s, i64* SA, i64 n, const std::vector<i64>& cnt,
                   const TypeBits& tb) {
  std::vector<i64> b;
  bucket_starts(cnt, &b);
  for (i64 k = 0; k < n; ++k) {
    i64 j = SA[k];
    if (j > 0 && !tb.get(j - 1)) SA[b[(size_t)s[j - 1]]++] = j - 1;
  }
  bucket_ends(cnt, &b);
  for (i64 k = n - 1; k >= 0; --k) {
    i64 j = SA[k];
    if (j > 0 && tb.get(j - 1)) SA[--b[(size_t)s[j - 1]]] = j - 1;
  }
}

constexpr i64 EMPTY = -1;

template <class T>
static void sais_rec(const T* s, i64* SA, i64 n, i64 K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  TypeBits tb(n);
  // classify backward: s[n-1] (sentinel) is S; s[i] is S iff
  // s[i] < s[i+1] or (equal and s[i+1] is S)
  tb.set(n - 1, true);
  for (i64 i = n - 2; i >= 0; --i)
    tb.set(i, s[i] < s[i + 1] || (s[i] == s[i + 1] && tb.get(i + 1)));

  std::vector<i64> cnt;
  count_symbols(s, n, K, &cnt);

  // stage 1: place LMS suffixes at their bucket ends (text order is
  // enough for the first induce), induce, and collect the LMS order
  std::vector<i64> b;
  bucket_ends(cnt, &b);
  for (i64 i = 0; i < n; ++i) SA[i] = EMPTY;
  i64 n_lms = 0;
  for (i64 i = 1; i < n; ++i)
    if (tb.get(i) && !tb.get(i - 1)) {
      SA[--b[(size_t)s[i]]] = i;
      ++n_lms;
    }
  // guard: the sentinel suffix is LMS by construction (s[n-2] is L
  // because s[n-1] is the unique minimum) except n==2 degenerate cases
  {
    // induce needs every non-EMPTY slot meaningful; EMPTY entries are
    // skipped via j > 0 checks only when EMPTY == -1 keeps j <= 0
  }
  induce(s, SA, n, cnt, tb);

  // compact the sorted LMS positions into SA[0..m)
  i64 m = 0;
  for (i64 k = 0; k < n; ++k) {
    i64 j = SA[k];
    if (j > 0 && tb.get(j) && !tb.get(j - 1)) SA[m++] = j;
  }
  // name LMS substrings: the buffer tail SA[m..) is the sparse name
  // store indexed by position/2 (LMS positions are >= 2 apart, and
  // m <= n/2, so (n-1)>>1 < n-m always fits)
  i64* name_of = SA + m;
  for (i64 i = m; i < n; ++i) SA[i] = EMPTY;
  i64 names = 0;
  i64 prev = -1;
  for (i64 k = 0; k < m; ++k) {
    i64 pos = SA[k];
    bool differ = false;
    if (prev < 0) {
      differ = true;
    } else {
      // compare LMS substrings at prev / pos (through the closing LMS
      // position; the sentinel is unique so walks never pass n-1)
      i64 a = prev, c = pos;
      while (true) {
        if (s[a] != s[c] || tb.get(a) != tb.get(c)) {
          differ = true;
          break;
        }
        ++a;
        ++c;
        bool la = is_lms<T>(tb, a), lc = is_lms<T>(tb, c);
        if (la || lc) {
          differ = !(la && lc);
          break;
        }
      }
    }
    if (differ) {
      ++names;
      prev = pos;
    }
    name_of[pos >> 1] = names - 1;
  }
  // compact the sparse names RIGHTWARD from the end: the reduced text
  // (names in LMS-position order) lands in SA[n-m..n)
  for (i64 i = n - 1, w = n - 1; i >= m; --i)
    if (SA[i] != EMPTY) SA[w--] = SA[i];
  i64* s1 = SA + n - m;

  if (names < m) {
    sais_rec<i64>(s1, SA, m, names);
  } else {
    for (i64 k = 0; k < m; ++k) SA[(size_t)s1[k]] = k;
  }
  // map reduced order back to LMS positions: rebuild the LMS position
  // list (text order) into s1
  {
    i64 w = 0;
    for (i64 i = 1; i < n; ++i)
      if (tb.get(i) && !tb.get(i - 1)) s1[w++] = i;
  }
  for (i64 k = 0; k < m; ++k) SA[k] = s1[(size_t)SA[k]];

  // stage 2: place the now-SORTED LMS suffixes at bucket ends and do
  // the final induce
  std::vector<i64> be;
  bucket_ends(cnt, &be);
  for (i64 i = m; i < n; ++i) SA[i] = EMPTY;
  for (i64 k = m - 1; k >= 0; --k) {
    i64 j = SA[k];
    SA[k] = EMPTY;
    SA[--be[(size_t)s[j]]] = j;
  }
  induce(s, SA, n, cnt, tb);
}

// public entry: seq over [0, K-1] WITHOUT sentinel; writes SA of
// seq + implicit minimal sentinel into out[n+1] (out[0] == n).
template <class T>
static void sais(const T* seq, i64 n, i64 K, i64* out) {
  // build text+sentinel shifted by +1 so 0 is the unique minimum
  std::vector<T> t((size_t)(n + 1));
  for (i64 i = 0; i < n; ++i) t[(size_t)i] = (T)(seq[i] + 1);
  t[(size_t)n] = 0;
  sais_rec<T>(t.data(), out, n + 1, K + 1);
}

}  // namespace bwaflow_sais
