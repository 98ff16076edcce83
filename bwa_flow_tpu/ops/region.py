"""Alignment regions: seed extension driver, dedup/patch, primary marking,
MAPQ (golden host implementation).

Reimplements mem_chain2aln (bwa/bwamem.c:641-795), mem_sort_dedup_patch
(:446-498), mem_patch_reg (:415-444), mem_mark_primary_se (:502-567),
mem_approx_mapq_se (:967-991) and mem_reorder_primary5 (:993-1015).

The ksw_extend2 calls route through an injectable extension function so the
device batch path can substitute device results while everything else stays
identical.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..index.fmindex import FMIndex
from ..utils.ksort import ks_introsort
from ..utils.opts import MemOpt
from . import ksw
from .chain import Chain

MAX_BAND_TRY = 2
PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
MEM_MAPQ_COEF = 30.0


def hash_64(key: int) -> int:
    """bwa/utils.h:98-108 (64-bit mix)."""
    mask = (1 << 64) - 1
    key = (key + (~(key << 32) & mask)) & mask
    key ^= key >> 22
    key = (key + (~(key << 13) & mask)) & mask
    key ^= key >> 8
    key = (key + (key << 3)) & mask
    key ^= key >> 15
    key = (key + (~(key << 27) & mask)) & mask
    key ^= key >> 31
    return key


@dataclasses.dataclass
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 0
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0


def cal_max_gap(opt: MemOpt, qlen: int) -> int:
    """bwamem.c:630-637."""
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w << 1)


def default_extend(opt: MemOpt, qs: np.ndarray, rs: np.ndarray, w: int,
                   pen_clip: int, h0: int):
    """One ksw_extend2 call: returns (score, qle, tle, gtle, gscore, max_off)."""
    return ksw.ksw_extend2(len(qs), qs, len(rs), rs, opt.mat, opt.o_del,
                           opt.e_del, opt.o_ins, opt.e_ins, w, pen_clip,
                           opt.zdrop, h0)


@dataclasses.dataclass
class SeedExtTask:
    """One coupled seed-extension task (one chain seed): the unit the device
    kernel (ops/chain2aln_jax.py) processes. Left sequences are reversed.

    The array fields serve the host fallback path; the scalar descriptor
    fields (qbeg/slen/l_query/rbeg/rmax0/rmax1) let the device kernel
    assemble the same windows from resident read+reference data."""

    q_left: np.ndarray
    t_left: np.ndarray
    q_right: np.ndarray
    t_right: np.ndarray
    h0: int
    qbeg: int = 0
    slen: int = 0
    l_query: int = 0
    rbeg: int = 0
    rmax0: int = 0
    rmax1: int = 0


_EMPTY = np.empty(0, dtype=np.uint8)


def run_task_host(opt: MemOpt, task: SeedExtTask, extend=default_extend
                  ) -> tuple[int, ...]:
    """Golden execution of one SeedExtTask: bwa band-doubling left+right
    (bwamem.c:716-779). Returns the 12-tuple
    (lscore, lqle, ltle, lgtle, lgscore, aw0,
     rscore, rqle, rtle, rgtle, rgscore, aw1)."""
    if len(task.q_left):
        score = -1
        lqle = ltle = lgtle = lgscore = 0
        aw0 = opt.w
        for i in range(MAX_BAND_TRY):
            prev = score
            aw0 = opt.w << i
            score, lqle, ltle, lgtle, lgscore, max_off = extend(
                opt, task.q_left, task.t_left, aw0, opt.pen_clip5, task.h0)
            if score == prev or max_off < (aw0 >> 1) + (aw0 >> 2):
                break
        lres = (score, lqle, ltle, lgtle, lgscore, aw0)
    else:
        lres = (task.h0, 0, 0, 0, 0, opt.w)
    sc0 = lres[0]
    if len(task.q_right):
        score = sc0
        rqle = rtle = rgtle = rgscore = 0
        aw1 = opt.w
        for i in range(MAX_BAND_TRY):
            prev = score
            aw1 = opt.w << i
            score, rqle, rtle, rgtle, rgscore, max_off = extend(
                opt, task.q_right, task.t_right, aw1, opt.pen_clip3, sc0)
            if score == prev or max_off < (aw1 >> 1) + (aw1 >> 2):
                break
        rres = (score, rqle, rtle, rgtle, rgscore, aw1)
    else:
        rres = (sc0, 0, 0, 0, 0, opt.w)
    return lres + rres


def chain2aln_tasks(opt: MemOpt, fm: FMIndex, l_query: int,
                    query: np.ndarray, c: Chain, regs: list[AlnReg]):
    """Generator form of mem_chain2aln (bwamem.c:641-795): yields one
    SeedExtTask per extended seed, receives its 12-tuple result via
    ``send``, and appends the finished AlnReg to ``regs``. The skip
    heuristics consult ``regs`` between yields, so driving this generator
    one task at a time reproduces the sequential semantics exactly — the
    device pipeline interleaves many reads' generators to form batches."""
    bns = fm.bns
    l_pac = bns.l_pac
    if c.n == 0:
        return
    # max possible span
    rmax0, rmax1 = l_pac << 1, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = t.rbeg + t.len + ((l_query - t.qbeg - t.len)
                              + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:  # crossing the fw-rev boundary: pick one side
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rseq, rid, rmax0, rmax1 = bns.fetch_seq(rmax0, c.seeds[0].rbeg, rmax1)
    assert c.rid == rid

    srt = sorted(range(c.n), key=lambda i: (c.seeds[i].score, i))
    srt_alive = [True] * c.n

    for k in range(c.n - 1, -1, -1):
        s = c.seeds[srt[k]]
        # has this seed's region been extended before?
        hit = -1
        for i, p in enumerate(regs):
            if (s.rbeg < p.rb or s.rbeg + s.len > p.re or s.qbeg < p.qb
                    or s.qbeg + s.len > p.qe):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd = s.qbeg - p.qb
            rd = s.rbeg - p.rb
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
            qd = p.qe - (s.qbeg + s.len)
            rd = p.re - (s.rbeg + s.len)
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
        if hit >= 0:
            # check overlapping seeds in the same chain (bwamem.c:701-715)
            i = k + 1
            while i < c.n:
                if srt_alive[i]:
                    t = c.seeds[srt[i]]
                    if t.len >= s.len * 0.95:
                        if (s.qbeg <= t.qbeg
                                and s.qbeg + s.len - t.qbeg >= s.len >> 2
                                and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                            break
                        if (t.qbeg <= s.qbeg
                                and t.qbeg + t.len - s.qbeg >= s.len >> 2
                                and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                            break
                i += 1
            if i == c.n:  # no overlapping seeds: skip extension
                srt_alive[k] = False
                continue

        if s.qbeg:  # left extension inputs (reversed)
            qs_l = query[s.qbeg - 1::-1].copy()
            tmp = s.rbeg - rmax0
            rs_l = rseq[tmp - 1::-1].copy() if tmp else _EMPTY
        else:
            qs_l = rs_l = _EMPTY
        if s.qbeg + s.len != l_query:  # right extension inputs
            qe = s.qbeg + s.len
            re = s.rbeg + s.len - rmax0
            assert re >= 0
            qs_r = query[qe:].copy()
            rs_r = rseq[re:].copy()
        else:
            qs_r = rs_r = _EMPTY

        (lscore, lqle, ltle, lgtle, lgscore, aw0,
         rscore, rqle, rtle, rgtle, rgscore, aw1) = yield SeedExtTask(
            qs_l, rs_l, qs_r, rs_r, s.len * opt.a,
            qbeg=s.qbeg, slen=s.len, l_query=l_query, rbeg=s.rbeg,
            rmax0=rmax0, rmax1=rmax1)

        a = AlnReg()
        a.rid = c.rid
        if s.qbeg:
            a.score = lscore
            if lgscore <= 0 or lgscore <= lscore - opt.pen_clip5:  # local
                a.qb = s.qbeg - lqle
                a.rb = s.rbeg - ltle
                a.truesc = lscore
            else:  # to-end
                a.qb = 0
                a.rb = s.rbeg - lgtle
                a.truesc = lgscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:
            sc0 = a.score
            a.score = rscore
            if rgscore <= 0 or rgscore <= rscore - opt.pen_clip3:  # local
                a.qe = qe + rqle
                a.re = rmax0 + re + rtle
                a.truesc += rscore - sc0
            else:  # to-end
                a.qe = l_query
                a.re = rmax0 + re + rgtle
                a.truesc += rgscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        a.seedcov = 0
        for t in c.seeds:
            if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                a.seedcov += t.len
        a.w = max(aw0, aw1)
        a.seedlen0 = s.len
        a.frac_rep = c.frac_rep
        regs.append(a)


def mem_chain2aln(opt: MemOpt, fm: FMIndex, l_query: int, query: np.ndarray,
                  c: Chain, regs: list[AlnReg], extend=default_extend) -> None:
    """Banded extension of each seed in the chain (bwamem.c:641-795):
    drives chain2aln_tasks synchronously with the host task runner."""
    gen = chain2aln_tasks(opt, fm, l_query, query, c, regs)
    try:
        task = next(gen)
        while True:
            task = gen.send(run_task_host(opt, task, extend))
    except StopIteration:
        pass


def mem_patch_reg(opt: MemOpt, fm: FMIndex | None, query: np.ndarray | None,
                  a: AlnReg, b: AlnReg, gen_cigar_score) -> tuple[int, int]:
    """bwamem.c:415-444. Returns (score, w); score 0 means no merge.

    ``gen_cigar_score(w, qb, qe, rb, re)`` computes the banded global score
    (bwa_gen_cigar2 score-only)."""
    if fm is None or query is None:
        return 0, 0
    bns = fm.bns
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < bns.l_pac <= b.rb:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0  # not colinear
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap on query or ref
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += a.w + b.w
    w = min(w, opt.w << 2)
    score = gen_cigar_score(w, a.qb, b.qe, a.rb, b.re)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def mem_sort_dedup_patch(opt: MemOpt, fm: FMIndex | None,
                         query: np.ndarray | None, regs: list[AlnReg],
                         gen_cigar_score=None) -> list[AlnReg]:
    """bwamem.c:446-498."""
    n = len(regs)
    if n <= 1:
        return regs
    a = list(regs)
    # sort by the END position with the reference's exact tie permutation
    # (alnreg_slt2 / ks_introsort, bwamem.c:400,450)
    ks_introsort(a, lambda x, y: x.re < y.re)
    for p in a:
        p.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and p.rb < a[j].re + opt.max_chain_gap:
            q = a[j]
            j -= 1
            if q.qe == q.qb:
                continue  # excluded
            o_r = q.re - p.rb
            o_q = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            m_r = min(q.re - q.rb, p.re - p.rb)
            m_q = min(q.qe - q.qb, p.qe - p.qb)
            if o_r > opt.mask_level_redun * m_r and o_q > opt.mask_level_redun * m_q:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb and gen_cigar_score is not None:
                score, w = mem_patch_reg(opt, fm, query, q, p, gen_cigar_score)
                if score > 0:  # merge q into p
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [p for p in a if p.qe > p.qb]
    # alnreg_slt (bwamem.c:403): score desc, rb, qb — not a total order
    # (qe can differ on full ties), so introsort permutation matters
    ks_introsort(a, lambda x, y: x.score > y.score or (
        x.score == y.score and (x.rb < y.rb or
                                (x.rb == y.rb and x.qb < y.qb))))
    for i in range(1, len(a)):
        if (a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb
                and a[i].qb == a[i - 1].qb):
            a[i].qe = a[i].qb
    return [p for i, p in enumerate(a) if i == 0 or p.qe > p.qb]


def _mark_primary_core(opt: MemOpt, a: list[AlnReg], n: int) -> None:
    """bwamem.c:502-528 over a[:n]."""
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z: list[int] = [0]
    for i in range(1, n):
        found = -1
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if a[k].score - a[i].score <= tmp and (a[k].is_alt or not a[i].is_alt):
                        a[k].sub_n += 1
                    found = k
                    break
        if found < 0:
            z.append(i)
        else:
            a[i].secondary = found


def mem_mark_primary_se(opt: MemOpt, a: list[AlnReg], rid_: int) -> int:
    """bwamem.c:530-567; rid_ is the read id used for tie-break hashing.
    Sorts ``a`` in place; returns n_pri."""
    n = len(a)
    if n == 0:
        return 0
    n_pri = 0
    for i, p in enumerate(a):
        p.sub = p.alt_sc = 0
        p.secondary = p.secondary_all = -1
        p.hash = hash_64((rid_ + i) & ((1 << 64) - 1))
        if not p.is_alt:
            n_pri += 1
    # alnreg_hlt (bwamem.c:406); hash makes this a near-total order but
    # keep the exact introsort permutation anyway
    ks_introsort(a, lambda x, y: x.score > y.score or (
        x.score == y.score and (x.is_alt < y.is_alt or
                                (x.is_alt == y.is_alt and x.hash < y.hash))))
    _mark_primary_core(opt, a, n)
    for i, p in enumerate(a):
        p.secondary_all = i  # rank in the first round
        if not p.is_alt and p.secondary >= 0 and a[p.secondary].is_alt:
            p.alt_sc = a[p.secondary].score
    if 0 <= n_pri < n:
        if n_pri > 0:
            # alnreg_hlt2 (bwamem.c:409)
            ks_introsort(a, lambda x, y: x.is_alt < y.is_alt or (
                x.is_alt == y.is_alt and (
                    x.score > y.score or
                    (x.score == y.score and x.hash < y.hash))))
        z = [0] * n
        for i, p in enumerate(a):
            z[p.secondary_all] = i
        for p in a:
            if p.secondary >= 0:
                p.secondary_all = z[p.secondary]
                if p.is_alt:
                    p.secondary = (1 << 31) - 1  # INT_MAX
            else:
                p.secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                a[i].sub = 0
                a[i].secondary = -1
            _mark_primary_core(opt, a, n_pri)
    else:
        for p in a:
            p.secondary_all = p.secondary
    return n_pri


def mem_approx_mapq_se(opt: MemOpt, a: AlnReg) -> int:
    """bwamem.c:967-991."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1.0 - a.frac_rep) + 0.499)


def mem_reorder_primary5(T: int, a: list[AlnReg]) -> None:
    """bwamem.c:993-1015 (-5 flag support)."""
    n_pri = sum(1 for p in a if p.secondary < 0 and not p.is_alt and p.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = (1 << 31) - 1, -1
    for k, p in enumerate(a):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    assert a[0].secondary < 0
    if left_k == 0:
        return
    a[0], a[left_k] = a[left_k], a[0]
    for k in range(1, len(a)):
        p = a[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0
