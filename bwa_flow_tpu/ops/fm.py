"""Golden (NumPy) FM-index primitives.

Scalar-exact reimplementations of the reference's occ/extend/SA machinery
(bwa/bwt.c:107-287) over the device block layout in index/fmindex.py. These
are the oracles the JAX ops are diffed against, and the host fallback for
overflow reads.
"""

from __future__ import annotations

import numpy as np

from ..index.fmindex import BLOCK, FMIndex


def _count_words(words: np.ndarray, upto: int, c: int) -> int:
    """Count symbol ``c`` among the first ``upto`` symbols packed in
    ``words`` (16 symbols/word, first symbol in top bits)."""
    total = 0
    full = upto >> 4
    w = words.astype(np.uint32)
    for i in range(full):
        total += _count_word(int(w[i]), 16, c)
    rem = upto & 15
    if rem:
        total += _count_word(int(w[full]), rem, c)
    return total


def _count_word(word: int, n_sym: int, c: int) -> int:
    cnt = 0
    for t in range(n_sym):
        if (word >> ((15 - t) << 1)) & 3 == c:
            cnt += 1
    return cnt


def occ(fm: FMIndex, k: int, c: int) -> int:
    """#occurrences of c in B0[0..k'] where k' = k - (k >= primary).

    k is a row coordinate in [-1, seq_len] (bwa/bwt.c:107-129 semantics)."""
    if k == fm.seq_len:
        return int(fm.L2[c + 1] - fm.L2[c])
    if k == -1:
        return 0
    k -= k >= fm.primary
    blk = k // BLOCK
    row = fm.fm_blocks[blk]
    base = int(row[c])
    within = k % BLOCK + 1  # count symbols [blk*BLOCK, k] inclusive
    words = row[4:8].astype(np.int64).astype(np.uint32)
    return base + _count_words(words, within, c)


def occ4(fm: FMIndex, k: int) -> np.ndarray:
    """All-symbol occ at row coordinate k (bwa/bwt.c:169-186)."""
    out = np.zeros(4, dtype=np.int64)
    if k == -1:
        return out
    if k == fm.seq_len:
        return (fm.L2[1:5] - fm.L2[0:4]).astype(np.int64)
    for c in range(4):
        out[c] = occ(fm, k, c)
    return out


def two_occ4(fm: FMIndex, k: int, l: int) -> tuple[np.ndarray, np.ndarray]:
    return occ4(fm, k), occ4(fm, l)


def bwt_extend(fm: FMIndex, ik: np.ndarray, is_back: bool) -> np.ndarray:
    """Bidirectional extension (bwa/bwt.c:262-275).

    ik: int64[3] = (k, l, s) triple; returns ok: int64[4, 3] for the four
    bases, where ok[c] is the interval after prepending/appending base c."""
    fwd = 0 if is_back else 1          # x[!is_back]: occ-probe coordinate
    bwd = 1 if is_back else 0          # x[is_back]: cumulatively derived
    x_f = int(ik[fwd])
    s = int(ik[2])
    tk = occ4(fm, x_f - 1)
    tl = occ4(fm, x_f - 1 + s)
    ok = np.zeros((4, 3), dtype=np.int64)
    for i in range(4):
        ok[i, fwd] = fm.L2[i] + 1 + tk[i]
        ok[i, 2] = tl[i] - tk[i]
    ok[3, bwd] = ik[bwd] + (x_f <= fm.primary and x_f + s - 1 >= fm.primary)
    ok[2, bwd] = ok[3, bwd] + ok[3, 2]
    ok[1, bwd] = ok[2, bwd] + ok[2, 2]
    ok[0, bwd] = ok[1, bwd] + ok[1, 2]
    return ok


def set_intv(fm: FMIndex, c: int) -> np.ndarray:
    """Initial single-base interval (bwa/bwt.h:80 bwt_set_intv)."""
    return np.array([fm.L2[c] + 1,
                     fm.L2[3 - c] + 1,
                     fm.L2[c + 1] - fm.L2[c]], dtype=np.int64)


def bwt_b0(fm: FMIndex, k: int) -> int:
    """Symbol at $-removed BWT position k (bwa/bwt.h:78)."""
    blk, off = divmod(k, BLOCK)
    word = int(np.uint32(fm.fm_blocks[blk, 4 + (off >> 4)]))
    return (word >> ((15 - (off & 15)) << 1)) & 3


def inv_psi(fm: FMIndex, k: int) -> int:
    """LF-mapping step (bwa/bwt.c:53-59)."""
    x = k - (k > fm.primary)
    c = bwt_b0(fm, x)
    x = int(fm.L2[c]) + occ(fm, k, c)
    return 0 if k == fm.primary else x


def bwt_sa(fm: FMIndex, k: int) -> int:
    """Suffix-array value at row k via LF-walk to a sampled row
    (bwa/bwt.c:86-96)."""
    sa = 0
    mask = fm.sa_intv - 1
    while k & mask:
        sa += 1
        k = inv_psi(fm, k)
    return sa + int(fm.sa[k // fm.sa_intv])
