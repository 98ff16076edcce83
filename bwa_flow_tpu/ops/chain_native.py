"""Native chain-stage wrapper: batched seed chaining + filtering in C++.

The chain stage (mem_chain/mem_chain_flt) is host work between two
device stages; the host CPU is the scarce resource, so the hot
path runs in the _chain extension (native/_chain.cpp — a C++ port of
ops/chain.py including the klib-introsort tie permutation). Reads the
long-read seed-SW filter applies to (mem_flt_chained_seeds would not be
a no-op) come back as None and run through the Python path.
"""

from __future__ import annotations

import numpy as np

from ..index.fmindex import FMIndex
from ..utils.opts import MemOpt
from .chain import Chain, Seed

try:
    from .. import _chain as _ext
except ImportError:  # extension not built: callers use the Python path
    _ext = None


def available() -> bool:
    return _ext is not None


def sa_probe_layout(opt: MemOpt, all_intvs, build_owners: bool = True
                    ) -> tuple[np.ndarray, np.ndarray, list | None]:
    """Occurrence enumeration shared by SA resolution and chaining:
    (rows int64[NO] of interval coordinates x0+k, off int64[n+1] per-read
    boundaries, owners [(read, x0, k)] for the dict-based Python path).
    owners is skipped (None) when the native chain stage serves — its
    construction is the costly part of this pure-Python loop.

    Array-native IntvBatch inputs take a fully vectorized path."""
    from .smem import IntvBatch
    if isinstance(all_intvs, IntvBatch) and not build_owners:
        sv, x0, iv_off = all_intvs.sv, all_intvs.x0, all_intvs.iv_off
        mo = np.int64(opt.max_occ)
        over = sv > mo
        step = np.where(over, sv // np.maximum(mo, 1), 1)
        cnt = np.where(over, np.minimum(sv, step * mo)
                       // np.maximum(step, 1), sv)
        tot = np.zeros(len(sv) + 1, np.int64)
        np.cumsum(cnt, out=tot[1:])
        NO = int(tot[-1])
        # rows[j] = x0_i + (j - tot[i]) * step_i for j in intv i's range
        j = np.arange(NO, dtype=np.int64)
        i_of = np.repeat(np.arange(len(sv), dtype=np.int64), cnt)
        rows_v = x0[i_of] + (j - tot[i_of]) * step[i_of]
        return rows_v, tot[iv_off], None
    rows: list[int] = []
    owners: list[tuple[int, int, int]] | None =         [] if build_owners else None
    max_occ = opt.max_occ
    off = np.zeros(len(all_intvs) + 1, np.int64)
    for ridx, intvs in enumerate(all_intvs):
        for p in intvs:
            s_, x0 = p.s, p.x0
            if s_ > max_occ:
                step = s_ // max_occ
                ks = range(0, min(s_, step * max_occ), step)
            else:
                ks = range(s_)
            rows.extend(x0 + k for k in ks)
            if owners is not None:
                owners.extend((ridx, x0, k) for k in ks)
        off[ridx + 1] = len(rows)
    return np.asarray(rows, dtype=np.int64), off, owners


def owners_for(opt: MemOpt, all_intvs) -> list:
    """Rebuild the owners triplets (lazy path for Python fallbacks)."""
    return sa_probe_layout(opt, all_intvs, build_owners=True)[2]


def intv_arrays(all_intvs) -> tuple[np.ndarray, ...]:
    """(iv_off, x0, sv, st, en) flat arrays for a batch of intervals —
    pass-through for IntvBatch, packing loop for Intv lists."""
    from .smem import IntvBatch
    if isinstance(all_intvs, IntvBatch):
        b = all_intvs
        return b.iv_off, b.x0, b.sv, b.st, b.en
    n = len(all_intvs)
    NI = sum(len(iv) for iv in all_intvs)
    iv_off = np.zeros(n + 1, np.int64)
    x0 = np.empty(NI, np.int64)
    sv = np.empty(NI, np.int64)
    st = np.empty(NI, np.int32)
    en = np.empty(NI, np.int32)
    i = 0
    for r, intvs in enumerate(all_intvs):
        for p in intvs:
            x0[i] = p.x0
            sv[i] = p.s
            info = p.info
            st[i] = info >> 32
            en[i] = info & 0xFFFFFFFF
            i += 1
        iv_off[r + 1] = i
    return iv_off, x0, sv, st, en


def ann_arrays(fm: FMIndex):
    """Cached (contig offsets int64, is_alt uint8) for an index."""
    key = id(fm)
    cache = _ANN_CACHE.get(key)
    if cache is None:
        anns = fm.bns.anns
        cache = (np.array([a.offset for a in anns], np.int64),
                 np.array([1 if a.is_alt else 0 for a in anns], np.uint8))
        _ANN_CACHE[key] = cache
    return cache


def chain_batch(opt: MemOpt, fm: FMIndex, seqs, all_intvs,
                sa_vals: np.ndarray, sa_off: np.ndarray) -> list:
    """Chains for a batch of reads; entries are lists of Chain, or None
    for reads that need the Python fallback. sa_vals/sa_off follow
    sa_probe_layout's enumeration."""
    assert _ext is not None
    n = len(seqs)
    l_query = np.fromiter((len(s) for s in seqs), np.int32, n)
    iv_off, x0, sv, st, en = intv_arrays(all_intvs)
    bns = fm.bns
    anns = bns.anns
    ann_off, ann_alt = ann_arrays(fm)
    res = _ext.chain_batch(
        l_query, iv_off, x0, sv, st, en,
        np.ascontiguousarray(sa_off, np.int64),
        np.ascontiguousarray(sa_vals, np.int64),
        ann_off, ann_alt, bns.l_pac,
        opt.min_seed_len, opt.max_occ, opt.max_chain_gap, opt.w,
        opt.min_chain_weight, opt.max_chain_extend,
        float(opt.drop_ratio), float(opt.mask_level))
    out = []
    for r, item in enumerate(res):
        if item is None:
            out.append(None)
            continue
        frac_rep, clist = item
        chains = []
        for rid, seeds in clist:
            chains.append(Chain(
                pos=0, rid=rid, is_alt=int(bool(anns[rid].is_alt)),
                seeds=[Seed(rbeg=s0, qbeg=s1, len=s2, score=s3)
                       for (s0, s1, s2, s3) in seeds],
                frac_rep=frac_rep))
        out.append(chains)
    return out


_ANN_CACHE: dict = {}
