"""Device (JAX/XLA) SMEM seeding — a batched FM-index state machine.

Device replacement for the reference seeding front-end
(mem_collect_intv, bwa/bwamem.c:120-168; FPGA variant
src/bwa_wrapper.cpp:207-246 + the SMEM FPGA kernel fed by SMemTask,
src/fpga/SMemTask.cpp). The FPGA restructure's key
insight — replace bwa's coupled backward list-pruning pass with an
*independent backward walk per forward break interval* — is what makes the
algorithm fixed-shape; this module keeps that insight but derives its own
emission rule so the output is *exactly* bwa's bwt_smem1a semantics (not
the FPGA's flagstat-level approximation):

  For break intervals processed longest-forward-first, backward death
  steps r_j are non-increasing (containment), and bwa emits exactly the
  first interval of each distinct-r cohort, with its own (k, l, s) state at
  maximal backward reach. So: walk each break independently, emit when
  r < r_prev. Total extend count equals bwa's backward pass.

Execution model: one unified `lax.while_loop` state machine, vectorized
over a batch of reads. Every iteration performs exactly one batched
bwt_extend (two occ row-gathers) for all lanes; each lane interprets it
according to its mode (pivot-scan / forward-walk / backward-walk / done).
Fixed budgets (break slots, mem slots, iterations) with per-lane overflow
flags; overflowing reads are redone on host by the golden implementation,
mirroring the reference's FPGA redo-on-overflow
(/root/reference/src/fpga/FPGAPipeline.cpp:706-714).

Three passes, matching mem_collect_intv: (1) all SMEMs from scanning
pivots; (2) re-seed long low-occ SMEMs from their middle with
min_intv = s+1; (3) LAST-like forward-only seeding (bwa/bwt.c:358-379).
Results are sorted by `info` on device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex
from ..utils.opts import MemOpt
from . import smem as smem_golden
from .fm_jax import DeviceFM, occ4_batch, sa_batch, set_intv_batch

I32 = jnp.int32
I64 = jnp.int64
BIG32 = jnp.int32(1 << 30)


def bwt_extend_dir_batch(dfm: DeviceFM, ik: jnp.ndarray,
                         is_back: jnp.ndarray) -> jnp.ndarray:
    """bwt_extend with a per-lane direction flag (bwa/bwt.c:262-275).

    ik: int64[B, 3]; is_back: bool[B]. Returns ok int64[B, 4, 3].
    The two occ probes are shared between directions."""
    probe = jnp.where(is_back, ik[:, 0], ik[:, 1])
    s = ik[:, 2]
    # flat [2B] probe coords: one 1-D-index gather for both probes
    both = jnp.concatenate([probe - 1, probe - 1 + s], axis=0)
    occ2 = occ4_batch(dfm, both)
    tk, tl = occ2[: probe.shape[0]], occ2[probe.shape[0]:]
    ok_probe = dfm.L2[:4] + 1 + tk                       # [B, 4]
    ok_s = tl - tk
    crosses = ((probe <= dfm.primary) & (probe + s - 1 >= dfm.primary)
               ).astype(ik.dtype)
    base = jnp.where(is_back, ik[:, 1], ik[:, 0]) + crosses
    b3 = base
    b2 = b3 + ok_s[:, 3]
    b1 = b2 + ok_s[:, 2]
    b0 = b1 + ok_s[:, 1]
    derived = jnp.stack([b0, b1, b2, b3], axis=-1)
    isb = is_back[:, None]
    ok_k = jnp.where(isb, ok_probe, derived)
    ok_l = jnp.where(isb, derived, ok_probe)
    return jnp.stack([ok_k, ok_l, ok_s], axis=-1)


class _MachineConsts(NamedTuple):
    L: int
    MAXB: int
    MAXM: int
    ITERS: int


def _pack_info(start, end, dt):
    """mem info sort key. Wide: start<<32|end (bwa's uint64_t info,
    bwa/bwt.c:311). Narrow (int32 coords, reads < 32768 bp): start<<16|end
    — same lexicographic order, half the sort/compare cost."""
    if dt == I32:
        return ((start << 16) | end).astype(I32)
    return (start.astype(I64) << 32) | end.astype(I64)


INFO_SHIFT = {np.dtype(np.int32): 16, np.dtype(np.int64): 32}


def _take1(arr, idx):
    """arr[b, idx[b]] along axis 1 (idx assumed clamped) — as a one-hot
    select; batched take_along_axis gathers lower to slow per-row code."""
    oh = jnp.arange(arr.shape[1], dtype=I32)[None, :] == idx[:, None]
    return (arr * oh.astype(arr.dtype)).sum(axis=1, dtype=arr.dtype)


def _q_at(q_flat, idx):
    """q_flat[idx] for int32 idx[N] — as a width-8 ROW gather plus an
    in-row select, in place of a scalar 1-D gather; the read-symbol
    lookup sits in every machine's inner loop. Which of the two is
    faster on the GPU is not measured. Requires len(q_flat) % 8 == 0
    (pad_reads pads L to multiples of 8)."""
    if q_flat.shape[0] % 8 != 0:
        return q_flat[idx]
    row = q_flat.reshape(-1, 8)[idx >> 3]
    off = idx & 7
    out = row[:, 0]
    for j in range(1, 8):
        out = jnp.where(off == j, row[:, j], out)
    return out


def _take_row(arr, idx):
    """arr[b, idx[b], :] for [B, 4, 3] arrays (idx in [0, 4)) — unrolled
    4-way select."""
    out = arr[:, 0, :]
    for cc in range(1, arr.shape[1]):
        out = jnp.where((idx == cc)[:, None], arr[:, cc, :], out)
    return out


def _scatter_slot(arr, idx, val, do):
    """arr[b, :, idx[b]] = val[b, :] where do[b] — flat 1-D scatter.

    The round-2 one-hot-select formulation (jnp.where over the whole
    [NL, K, N] buffer) rewrites every break buffer in full on EVERY
    while-loop iteration (~30 MB/iteration at NB=160), more memory
    traffic than the occ gathers. A flat scalar-index scatter (K*NL
    elements, mode=drop) updates the loop carry in place instead (and,
    being elementwise, cannot lower to B sequential row updates as a
    row scatter can)."""
    NL, K, N = arr.shape
    lane = jnp.arange(NL, dtype=I32)
    base = jnp.where(do, lane * (K * N) + idx, NL * K * N)
    flat_idx = (base[:, None]
                + jnp.arange(K, dtype=I32)[None, :] * N).reshape(-1)
    return arr.reshape(-1).at[flat_idx].set(
        val.reshape(-1), mode="drop").reshape(NL, K, N)


def _take_slot(arr, idx):
    """arr[b, :, idx[b]] for [B, K, N] slot-minor buffers."""
    oh = jnp.arange(arr.shape[2], dtype=I32)[None, :] == idx[:, None]
    return (arr * oh[:, None, :].astype(arr.dtype)).sum(axis=2,
                                                        dtype=arr.dtype)


def _scatter1(arr, idx, val, do):
    """arr[b, idx[b]] = val[b] where do[b] — flat 1-D scatter (see
    _scatter_slot for why not a one-hot select)."""
    NL, N = arr.shape
    flat_idx = jnp.where(do, jnp.arange(NL, dtype=I32) * N + idx, NL * N)
    return arr.reshape(-1).at[flat_idx].set(
        val, mode="drop").reshape(NL, N)


def _p3_pre2(dfm: DeviceFM, L: int, val, s):
    """Pass-3 pivot acquisition from ONE prefetched sym-table value
    (bwt_seed_strategy1 scan; see _fwd_pre2)."""
    mode = s["mode"]
    m0 = mode == 0
    cand = jnp.where(s["x"] < L, val >> 6, jnp.asarray(L, I32))
    found = cand < L
    start = m0 & found
    x = jnp.where(start, cand, s["x"])
    mode = jnp.where(m0, jnp.where(found, 1, 3), mode)
    init_ik = set_intv_batch(dfm, jnp.clip((val >> 3) & 7, 0, 3))
    return dict(s, mode=mode, x=x,
                ik=jnp.where(start[:, None], init_ik, s["ik"]),
                i=jnp.where(start, x + 1, s["i"])), val & 7


def _p3_post(c: _MachineConsts, qlen, min_seed_len, max_mem_intv,
             s, ok, q_i):
    """Pass-3 step after the shared occ probe (ok = bwt_extend rows;
    q_i = prefetched read symbol at i)."""
    mode, x, i, ik = s["mode"], s["x"], s["i"], s["ik"]
    m1 = mode == 1
    ended = m1 & (i >= qlen)          # loop exhausted: jump to len
    amb = m1 & ~ended & (q_i > 3)     # N base: jump to i+1, no seed
    live = m1 & ~ended & ~amb
    cf = jnp.clip(3 - q_i, 0, 3)
    okc = _take_row(ok, cf)
    hit = live & (okc[:, 2] < max_mem_intv) & ((i - x) >= min_seed_len)
    emit = hit & (okc[:, 2] > 0)
    info = _pack_info(x, i + 1, okc.dtype)
    new_mem = jnp.concatenate([okc, info[:, None]], axis=1)
    mem_ovf = emit & (s["n_mem"] >= c.MAXM)
    mems2 = _scatter_slot(s["mems"], s["n_mem"], new_mem,
                          emit & ~mem_ovf)
    n_mem = jnp.where(emit & ~mem_ovf, s["n_mem"] + 1, s["n_mem"])

    walk = live & ~hit
    ik = jnp.where(walk[:, None], okc, ik)
    i2 = jnp.where(walk, i + 1, i)
    # pivot jumps
    x = jnp.where(ended, qlen, jnp.where(amb | hit, i + 1, x))
    mode = jnp.where(ended | amb | hit, 0, mode)
    return dict(s, mode=mode, x=x, i=i2, ik=ik, mems=mems2, n_mem=n_mem,
                ovf=s["ovf"] | mem_ovf, it=s["it"] + 1)


# ---------------------------------------------------------------------------
# Phase-split machine (round 3): the coupled pivot/forward/backward machine
# above serializes every backward walk behind every other one — ~1000
# all-lane iterations for a 151 bp batch. The split runs (A) a forward-only
# serial scan that RECORDS break intervals instead of walking them back
# (~L iterations), then (B) ONE batch-parallel backward phase where every
# break of every read walks simultaneously (~max-SMEM-length iterations),
# with the cohort-emission rule applied post-hoc as array ops. Pass 2's
# re-seed tasks are independent, so its forward walks also run in parallel
# (one lane per (read, task)). Same emission semantics, ~4x fewer
# all-lane-barrier iterations and no [B,4,MAXM] rewrite inside any loop.


def _fwd_pre2(dfm: DeviceFM, L: int, val, s):
    """Pass-1 mode-0 pivot acquisition from ONE prefetched sym-table
    value (see _sym_tab). Returns (state, q_i): for a starting lane the
    walk symbol q[x+1] rides in the low bits; for a walking lane val IS
    the symbol at i."""
    mode, x = s["mode"], s["x"]
    m0 = mode == 0
    cand = jnp.where(x < L, val >> 6, jnp.asarray(L, I32))
    found = cand < L
    start = m0 & found
    x = jnp.where(start, cand, x)
    mode = jnp.where(m0, jnp.where(found, 1, 3), mode)
    init_ik = set_intv_batch(dfm, jnp.clip((val >> 3) & 7, 0, 3))
    return dict(s, mode=mode, x=x,
                ik=jnp.where(start[:, None], init_ik, s["ik"]),
                ik_info=jnp.where(start, x + 1, s["ik_info"]),
                i=jnp.where(start, x + 1, s["i"]),
                g=jnp.where(start, s["g"] + 1, s["g"])), val & 7


def _fwd_post(L: int, NB: int, qlen_l, mi,
              task_mode: bool, s, ok, q_i):
    """Forward-scan step after the shared occ probe (q_i = prefetched
    read symbol at i)."""
    mode, x, i, ik, ik_info, g, nb = (s["mode"], s["x"], s["i"], s["ik"],
                                      s["ik_info"], s["g"], s["nb"])
    m1 = mode == 1
    end_now = m1 & ((i >= qlen_l) | (q_i > 3))
    cf = jnp.clip(3 - q_i, 0, 3)
    okc = _take_row(ok, cf)
    changed = okc[:, 2] != ik[:, 2]
    die = changed & (okc[:, 2] < mi)
    push = m1 & (end_now | changed)
    to_next = m1 & (end_now | die)
    adv = m1 & ~to_next

    nb_ovf = push & (nb >= NB)
    do = push & ~nb_ovf
    brk_kls = _scatter_slot(s["brk_kls"], nb, ik, do)
    # (end, x, g) consolidated into ONE i32 buffer/scatter: each
    # separate scatter is its own kernel dispatch in the loop body
    brk_meta = _scatter_slot(s["brk_meta"], nb,
                             jnp.stack([ik_info, x, g], axis=1), do)
    nb = jnp.where(do, nb + 1, nb)

    ik = jnp.where(adv[:, None], okc, ik)
    ik_info = jnp.where(adv, i + 1, ik_info)
    i = jnp.where(adv, i + 1, i)
    if task_mode:
        mode = jnp.where(to_next, 3, mode)
    else:
        # next pivot = end of longest match (= last push's end)
        x = jnp.where(to_next, ik_info, x)
        mode = jnp.where(to_next, 0, mode)
    ovf = s["ovf"] | nb_ovf
    mode = jnp.where(nb_ovf, 3, mode)
    return dict(s, mode=mode, x=x, i=i, ik=ik, ik_info=ik_info, g=g,
                nb=nb, brk_kls=brk_kls, brk_meta=brk_meta,
                ovf=ovf, it=s["it"] + 1)


def _sym_tab(q2, qlen2, L: int):
    """Packed per-position lookup table, ONE [2*B*L] i32 array:

      [0,   B*L): q[b, j]                      (plain symbol 0..4)
      [B*L, 2*B*L): nv[b, j] = (p << 6) | (q[b, p] << 3) | q[b, p+1]
                    where p = smallest valid pivot position >= j
                    (j' < qlen and q < 4), or p = L when none.

    A scan lane needs EITHER the next pivot (mode 0: position + its
    base + the following base, all needed the same iteration) OR the
    read symbol at i (mode 1) — never both — so one per-lane gather
    from this table replaces the three separate nxt/qx/q_i gathers.
    The while body is bound by its gathers, so row count is the cost.
    nv builds with a reverse cummin: the pivot
    position sits in the high bits, so min-by-packed = min-by-position
    and the winning entry carries its own symbols."""
    B2 = q2.shape[0]
    jl = jnp.arange(L, dtype=I32)[None, :]
    valid_base = (jl < qlen2[:, None]) & (q2 < 4)
    q_next = jnp.concatenate(
        [q2[:, 1:], jnp.full((B2, 1), 4, q2.dtype)], axis=1)
    packed = jnp.where(valid_base, (jl << 6) | (q2 << 3) | q_next,
                       jnp.asarray(L << 6, I32))
    nv = jax.lax.cummin(packed, axis=1, reverse=True)
    return jnp.concatenate([q2.reshape(-1), nv.reshape(-1)])


def _fwd_scan_machine(dfm: DeviceFM, L: int, NB: int, ITERS: int,
                      q_flat, read_id, qlen_l, mi, st0, task_mode: bool,
                      q2=None, qlen2=None):
    """Phase A: forward-only scan recording break intervals.

    Lanes NL: pass 1 = one per read (pivot jump rule is serial); pass 2
    = one per (read, task) (tasks are independent). Per-lane state in
    st0; break store: brk_kls [NL,3,NB] in the coordinate dtype,
    brk_meta [NL,3,NB] i32 = (end, x, g) rows. In task_mode the
    pivot-acquisition scan is compiled out (st0 arrives pre-initialized
    in mode 1/3)."""
    NL = st0["mode"].shape[0]
    if not task_mode:
        sym = _sym_tab(q2, qlen2, L)
        BL = jnp.asarray(q2.shape[0] * L, I32)

    def cond(s):
        return (s["it"] < ITERS) & jnp.any(s["mode"] != 3)

    def step(s):
        if not task_mode:
            m0 = s["mode"] == 0
            idx = (read_id * L
                   + jnp.where(m0, jnp.clip(s["x"], 0, L - 1) + BL,
                               jnp.clip(s["i"], 0, L - 1)))
            s, q_i = _fwd_pre2(dfm, L, _q_at(sym, idx), s)
        else:
            q_i = _q_at(q_flat,
                        read_id * L + jnp.clip(s["i"], 0, L - 1))
        ok = bwt_extend_dir_batch(dfm, s["ik"], jnp.zeros(NL, bool))
        return _fwd_post(L, NB, qlen_l, mi, task_mode, s, ok, q_i)

    out = jax.lax.while_loop(cond, step, st0)
    out["ovf"] = out["ovf"] | (out["mode"] != 3)
    return out


def _p1p3_machine(dfm: DeviceFM, L: int, NB: int, ITERS: int, q_flat,
                  read_id, qlen_l, st1, q2, qlen2, c3: _MachineConsts,
                  min_seed_len, max_mem_intv, st3):
    """Pass 1's forward scan and pass 3, fused into ONE while loop.

    Both machines are serial per-read scans of ~qlen iterations whose
    per-iteration cost is dominated by the shared batched bwt_extend;
    concatenating their lanes (2B) into a single probe per iteration
    runs pass 3 for free inside pass 1's barrier count instead of
    paying a second ~qlen-iteration loop."""
    B = st1["mode"].shape[0]
    sym = _sym_tab(q2, qlen2, L)
    BL = jnp.asarray(B * L, I32)
    mi1 = jnp.ones(B, st1["ik"].dtype)  # pass-1 min_intv
    rid3 = jnp.arange(B, dtype=I32)

    def cond(s):
        return (s["it"] < ITERS) & (jnp.any(s["p1"]["mode"] != 3)
                                    | jnp.any(s["p3"]["mode"] != 3))

    def step(s):
        # ONE symbol gather per iteration serves both machines: a lane
        # needs either the packed next-pivot entry (mode 0) or the read
        # symbol at i (mode 1), never both (_sym_tab). The body is
        # bound by its gathers, so per-lane gather rows are the cost.
        s1, s3 = s["p1"], s["p3"]
        m0_1 = s1["mode"] == 0
        m0_3 = s3["mode"] == 0
        idx = jnp.concatenate([
            read_id * L + jnp.where(m0_1,
                                    jnp.clip(s1["x"], 0, L - 1) + BL,
                                    jnp.clip(s1["i"], 0, L - 1)),
            rid3 * L + jnp.where(m0_3,
                                 jnp.clip(s3["x"], 0, L - 1) + BL,
                                 jnp.clip(s3["i"], 0, L - 1))])
        vals = _q_at(sym, idx)
        s1, q_i1 = _fwd_pre2(dfm, L, vals[:B], s1)
        s3, q_i3 = _p3_pre2(dfm, c3.L, vals[B:], s3)
        ik_all = jnp.concatenate([s1["ik"], s3["ik"]], axis=0)
        ok = bwt_extend_dir_batch(dfm, ik_all, jnp.zeros(2 * B, bool))
        s1 = _fwd_post(L, NB, qlen_l, mi1, False, s1, ok[:B], q_i1)
        s3 = _p3_post(c3, qlen2, min_seed_len, max_mem_intv,
                      s3, ok[B:], q_i3)
        return dict(p1=s1, p3=s3, it=s["it"] + 1)

    out = jax.lax.while_loop(
        cond, step, dict(p1=st1, p3=st3, it=jnp.zeros((), I32)))
    s1, s3 = out["p1"], out["p3"]
    s1["ovf"] = s1["ovf"] | (s1["mode"] != 3)
    return s1, (s3["mems"], s3["n_mem"], s3["ovf"] | (s3["mode"] != 3))


def _bwd_walk_machine(dfm: DeviceFM, L: int, q_flat, read_id, bst0, i_b0,
                      mi, alive0, CS: int):
    """Phase B: recorded break intervals walk backward via a persistent
    WORKLIST of A active lanes over the front-packed break queue.

    The round-4 chunked design (while_loop per CS-lane chunk of the
    sorted pool) paid ~1,400 sequential loop iterations per batch, each
    a fixed launch cost. Worklist: A lanes walk; a lane whose walk dies
    writes its result (4 one-element-per-lane scatters) and immediately
    pulls the next queue entry, so total iterations ~ max(total_steps/A,
    longest_walk) — ~150 for a typical batch, utilization-optimal for
    ANY walk-length distribution (no chunk-schedule tuning; robust on
    novel genomes). Callers sort the queue longest-bound-first so the
    drain tail finishes on short walks.

    Returns (r int32[M] death step, bst [M,3] state at maximal backward
    reach); lanes with alive0=False report r = i_b0."""
    M = i_b0.shape[0]
    A = min(max(4 * CS, 2048), M)
    dt = bst0.dtype
    total = alive0.astype(I32).sum(dtype=I32)  # live prefix (front-packed)

    # the queue as ONE [M, 8] row-gatherable table: a refill pulls every
    # per-entry field with a single row gather instead of four scalar
    # 1-D gathers
    z = jnp.zeros(M, dt)
    qtab = jnp.stack([bst0[:, 0], bst0[:, 1], bst0[:, 2],
                      i_b0.astype(dt), read_id.astype(dt),
                      mi.astype(dt), z, z], axis=1)

    # outputs default to the dead-on-entry convention (r=i_b0, bst=bst0)
    # bst columns live in ONE flat [3*M] buffer so a death writes them
    # with a single scatter (kernel count is the walker's cost unit)
    r_out = i_b0
    bflat = jnp.concatenate([bst0[:, 0], bst0[:, 1], bst0[:, 2]])

    MI = jnp.asarray(M, I32)               # drop sentinel
    M32 = jnp.asarray(M, I32)
    lane = jnp.arange(A, dtype=I32)
    qi0 = lane                             # first A queue entries
    act0 = qi0 < total
    row0 = qtab[jnp.minimum(qi0, M - 1)]
    st0 = dict(qi=qi0, act=act0,
               bst=row0[:, :3],
               i_b=row0[:, 3].astype(I32),
               rid=row0[:, 4].astype(I32),
               mi=row0[:, 5],
               nxt=jnp.minimum(jnp.asarray(A, I32), total),
               r_out=r_out, bflat=bflat,
               it=jnp.zeros((), I32))
    # safety budget: total work / A + one longest walk (never binds)
    ITB = (M * (L + 2)) // A + L + 8

    def cond(s):
        return (s["it"] < ITB) & jnp.any(s["act"])

    def step(s):
        act, i_b, bst = s["act"], s["i_b"], s["bst"]
        qb = _q_at(q_flat, s["rid"] * L + jnp.clip(i_b, 0, L - 1))
        valid_c = (i_b >= 0) & (qb < 4)
        ok = bwt_extend_dir_batch(dfm, bst, jnp.ones(A, bool))
        okc = _take_row(ok, jnp.clip(qb, 0, 3))
        dead = act & (~valid_c | (okc[:, 2] < s["mi"]))
        walk = act & ~dead
        # finished entries: write result at their queue index (state at
        # maximal reach = bst BEFORE this failed step); one scatter for
        # r, one for all three bst columns
        widx = jnp.where(dead, s["qi"], MI)
        r_out = s["r_out"].at[widx].set(i_b, mode="drop")
        widx3 = jnp.where(
            jnp.tile(dead, 3),
            jnp.concatenate([widx, widx + M32, widx + 2 * M32]), 3 * MI)
        bvals = jnp.concatenate([bst[:, 0], bst[:, 1], bst[:, 2]])
        bflat = s["bflat"].at[widx3].set(bvals, mode="drop")
        # survivors advance
        bst = jnp.where(walk[:, None], okc, bst)
        i_b = jnp.where(walk, i_b - 1, i_b)
        # dead lanes refill from the queue head
        d32 = dead.astype(I32)
        cs = jnp.cumsum(d32)
        cs_last = cs[-1]
        new_qi = s["nxt"] + cs - d32
        refill = dead & (new_qi < total)
        qsrc = jnp.minimum(jnp.where(refill, new_qi, 0), M - 1)
        row = qtab[qsrc]                        # one row gather
        bst = jnp.where(refill[:, None], row[:, :3], bst)
        i_b = jnp.where(refill, row[:, 3].astype(I32), i_b)
        rid = jnp.where(refill, row[:, 4].astype(I32), s["rid"])
        mi_a = jnp.where(refill, row[:, 5], s["mi"])
        qi = jnp.where(dead, jnp.where(refill, new_qi, MI), s["qi"])
        nxt = s["nxt"] + jnp.where(A > 0, cs_last, 0)
        act = walk | refill
        return dict(qi=qi, act=act, bst=bst, i_b=i_b, rid=rid, mi=mi_a,
                    nxt=nxt, r_out=r_out, bflat=bflat,
                    it=s["it"] + 1)

    out = jax.lax.while_loop(cond, step, st0)
    # iteration budget blown (never for the ITB above): record as death
    widx = jnp.where(out["act"], out["qi"], MI)
    r = out["r_out"].at[widx].set(out["i_b"], mode="drop")
    widx3 = jnp.where(
        jnp.tile(out["act"], 3),
        jnp.concatenate([widx, widx + M32, widx + 2 * M32]), 3 * MI)
    bvals = jnp.concatenate([out["bst"][:, 0], out["bst"][:, 1],
                             out["bst"][:, 2]])
    bflat = out["bflat"].at[widx3].set(bvals, mode="drop")
    return r, bflat.reshape(3, M).T.astype(dt)


def _cohort_emit(r, brk_g, valid, NB: int):
    """min of r over later slots in the same group (the walk processes
    groups in slot order, longest-forward first within a group): the
    r_prev value each break's emission test compares against."""
    NL = r.shape[0]

    def body(jj, carry):
        j = NB - 1 - jj
        m_out, g_c, m_c = carry
        gj = brk_g[:, j]
        vj = valid[:, j]
        same = vj & (gj == g_c)
        m_out = m_out.at[:, j].set(jnp.where(same, m_c, BIG32))
        m_new = jnp.where(same, jnp.minimum(m_c, r[:, j]), r[:, j])
        m_c = jnp.where(vj, m_new, m_c)
        g_c = jnp.where(vj, gj, g_c)
        return m_out, g_c, m_c

    m_out = jnp.full((NL, NB), BIG32, I32)
    g_c = jnp.full(NL, -1, I32)
    m_c = jnp.full(NL, BIG32, I32)
    m_out, _, _ = jax.lax.fori_loop(0, NB, body, (m_out, g_c, m_c))
    return m_out


def _compact(vflat, budget: int):
    """Pack the True positions of vflat (flat, any order-significant
    layout) into `budget` dense lanes, order-preserving.

    Returns (src int32[budget] = flat index feeding each lane,
    dst int32[N] = lane of each flat position (== budget when dropped),
    lane_ok bool[budget], dropped bool[N]). Scatter/gather based — no
    argsort; cumsum + one dropping scatter."""
    n = vflat.shape[0]
    v32 = vflat.astype(I32)
    rank = jnp.cumsum(v32) - v32                     # exclusive prefix
    dropped = vflat & (rank >= budget)
    dst = jnp.where(vflat & ~dropped, rank, budget)
    src = jnp.zeros(budget, I32).at[dst].set(
        jnp.arange(n, dtype=I32), mode="drop")
    total = jnp.minimum(rank[-1] + v32[-1], budget)
    lane_ok = jnp.arange(budget, dtype=I32) < total
    return src, dst, lane_ok, dropped


def _smem_pass_post(dfm: DeviceFM, L: int, NB: int, q_flat, read_id,
                    mi, min_seed_len, s, PBUD: int, CS: int):
    """Backward walks + cohort emission for a finished forward scan.

    The backward walk runs over a batch-global pool of PBUD lanes packed
    from the valid break slots (typical reads record ~12 breaks of an
    NB-slot budget; walking the raw [NL*NB] grid would spend ~5x the
    occ-probe bandwidth on dead lanes), windowed in CS-lane chunks so
    probe volume tracks the real break count. Reads whose breaks do not
    fit the pool overflow to the host redo path.

    Returns (mems [NL,4,NB] dense-front in bwa emission order,
    n1 int32[NL], ovf bool[NL])."""
    NL = s["mode"].shape[0]
    nb = s["nb"]
    slot = jnp.arange(NB, dtype=I32)[None, :]
    valid = slot < nb[:, None]

    brk_end = s["brk_meta"][:, 0, :]
    brk_x = s["brk_meta"][:, 1, :]
    # breaks recorded at pivot x=0 start their walk at i_b=-1 and die
    # before the first probe (~30% of a typical batch's breaks: every
    # break of every read's first pivot). Their result is known without
    # entering the pool: r=-1, state = the recorded break interval.
    doa = valid & (brk_x == 0)

    # pack the remaining breaks into the backward-walk pool
    src, dst, lane_ok, dropped = _compact((valid & ~doa).reshape(-1),
                                          PBUD)
    # order the pool by walk-length BOUND (a lane starting at i_b0 dies
    # within i_b0+2 probes), LONGEST FIRST: the worklist walker issues
    # queue entries in order, so starting the longest walks first means
    # the drain tail (lanes finishing after the queue empties) runs on
    # the shortest walks. One argsort saves many drain iterations.
    i_b0_all = (brk_x - 1).reshape(-1)
    if SORT_BWD_POOL:
        order_key = jnp.where(lane_ok, -i_b0_all[src], BIG32)
        perm = jnp.argsort(order_key)
        src = src[perm]
        lane_ok = jnp.arange(PBUD, dtype=I32) < lane_ok.sum().astype(I32)
        inv = jnp.zeros(PBUD + 1, I32).at[perm].set(
            jnp.arange(PBUD, dtype=I32), mode="drop")
        inv = inv.at[PBUD].set(PBUD)
        dst = inv[dst]                                # compose permutation
    lane_nl = src // NB                               # owning lane row
    bst0 = s["brk_kls"].transpose(0, 2, 1).reshape(NL * NB, 3)[src]
    i_b0 = i_b0_all[src]
    rid_b = read_id[lane_nl]
    mi_b = mi[lane_nl]
    r_l, bst_l = _bwd_walk_machine(dfm, L, q_flat, rid_b, bst0, i_b0,
                                   mi_b, lane_ok, CS)
    # scatter-back = gather through dst (index PBUD -> sentinel row)
    r_pad = jnp.concatenate([r_l, jnp.full((1,), BIG32, I32)])
    bst_pad = jnp.concatenate([bst_l, jnp.zeros((1, 3), bst_l.dtype)])
    r = r_pad[dst].reshape(NL, NB)
    bst = bst_pad[dst].reshape(NL, NB, 3).transpose(0, 2, 1)  # [NL,3,NB]
    r = jnp.where(doa, -1, r)
    bst = jnp.where(doa[:, None, :], s["brk_kls"], bst)
    valid = valid & ~dropped.reshape(NL, NB)
    ovf_pool = dropped.reshape(NL, NB).any(axis=1)

    # cohort emission: first break of each distinct-death-step cohort,
    # processed longest-forward-first within its pivot/task group
    brk_g = s["brk_meta"][:, 2, :]
    m_prev = _cohort_emit(r, brk_g, valid, NB)
    end = brk_end
    emit = valid & (r < m_prev) & ((end - (r + 1)) >= min_seed_len)
    info = _pack_info(r + 1, end, bst.dtype)
    # bwa appends in death order: group ascending, slot descending
    key = jnp.where(emit, brk_g * (2 * NB) + (NB - slot), BIG32)
    order = jnp.argsort(key, axis=1)
    mems = jnp.concatenate([bst, info[:, None, :]], axis=1)  # [NL,4,NB]
    mems = jnp.take_along_axis(mems, order[:, None, :], axis=2)
    n1 = emit.sum(axis=1).astype(I32)
    return mems, n1, s["ovf"], ovf_pool


def _smem_pass(dfm: DeviceFM, L: int, NB: int, ITERS: int, q_flat,
               read_id, qlen_l, mi, min_seed_len, st0, task_mode: bool,
               PBUD: int, CS: int, q2=None, qlen2=None):
    """One full SMEM pass: forward scan + parallel backward + emission."""
    s = _fwd_scan_machine(dfm, L, NB, ITERS, q_flat, read_id, qlen_l, mi,
                          st0, task_mode, q2=q2, qlen2=qlen2)
    return _smem_pass_post(dfm, L, NB, q_flat, read_id, mi, min_seed_len,
                           s, PBUD, CS)


SORT_BWD_POOL = True  # walk-length-sorted backward pools (perf knob)

MAXO = 64  # legacy per-read fused-SA budget (the fused path now uses a
# batch-global CAPO_PER*B ragged pool covering every read; MAXO remains
# only as a floor in older comments/tests)

# overflow-source bits (the ovf output is an int32 bitmask; nonzero ->
# host golden redo). Production counters aggregate these for tuning.
OVF_P1_FWD = 1     # pass-1 forward scan: NB break cap or ITERS
OVF_P1_POOL = 2    # pass-1 backward pool (PBUD1) exhausted
OVF_TASKPOOL = 4   # pass-2 re-seed task pool (TBUD) exhausted
OVF_P2_FWD = 8     # pass-2 forward scan: NB2 cap or ITERS
OVF_P2_POOL = 16   # pass-2 backward pool (PBUD2) exhausted
OVF_P2_EMIT = 32   # pass-2 per-read emission cap (M2)
OVF_P3 = 64        # pass-3 mem-slot cap (NP3)
OVF_MEMS = 128     # total mems > MAXM
OVF_SA = 256       # fused SA walk overflow (budget/pool; ~1e-4 reads)


@functools.partial(jax.jit,
                   static_argnums=(1, 2, 3, 4, 12, 13, 14, 15))
def collect_intv_device(dfm: DeviceFM, L: int, MAXB: int, MAXM: int,
                        ITERS: int, q: jnp.ndarray, qlen: jnp.ndarray,
                        min_seed_len: jnp.ndarray, split_len: jnp.ndarray,
                        split_width: jnp.ndarray, max_mem_intv: jnp.ndarray,
                        max_occ: jnp.ndarray, pack_H: int = 0,
                        big: bool = False, p2x: int = 1,
                        sa_intv_s: int = 0
                        ) -> tuple[jnp.ndarray, ...]:
    """All seeding intervals for a batch of reads (mem_collect_intv,
    bwa/bwamem.c:120-168), sorted by info.

    q: int32 or uint8 [B, L] (0..4; pad >= 4 beyond qlen) — uint8 is the
    production upload format (4x fewer bytes to copy), widened here;
    qlen int32[B].
    Returns (mems int64[B, 4, MAXM] = (k, l, s, info) rows, n_mem int32[B],
    overflow bool[B], occ_sa int64[B, MAXO], occ_total int32[B]).

    When the genome carries a dense device SA, the call also resolves the
    seed occurrences' SA values on device (mem_chain's x0+k enumeration,
    capped at max_occ per interval) so a typical batch needs NO separate
    SA round trip; reads whose total occurrence count exceeds MAXO are
    resolved by the caller through the probe path."""
    q = q.astype(I32)
    B = q.shape[0]
    # coordinate dtype: int32 when the caller passed a _narrow_view'd
    # index (sub-2^31 genome) — int32 ops on the whole probe chain
    # instead of int64
    dt = dfm.L2.dtype
    max_mem_intv = max_mem_intv.astype(dt)
    max_occ = max_occ.astype(dt)
    # budget profile: the default covers repeat-realistic batches at
    # p99.5+; `big` is the DEVICE REDO variant seed_collect_batch runs on
    # the overflowed residue before resorting to host golden (a per-read
    # Python model, far slower on repeat-rich genomes)
    NB = max(MAXB, 384 if big else (160 if p2x > 1 else 128))
    # pass-1 break budget (all pivots); repeat-realistic reads record
    # ~42 breaks mean, p99 ~104, max >128; Gbp-unique reads spill 128
    # on ~1% of a batch (49/4096 measured) -> 160 under p2x
    NB2 = 192 if big else (128 if p2x > 1 else 64)  # per-task break budget
    # (repeat re-seeds walk through high-occ copies and break often: 32
    # overflowed 5% of a repeat-realistic batch; 64 overflowed 72/4096
    # of the Gbp fixture)
    NP3 = 64 if big else 24    # pass-3 mem slots
    M2 = min(128 if big else (96 if p2x > 1 else 64), MAXM)
    # per-read pass-2 emission cap (Gbp genomes re-seed nearly every
    # SMEM: 64 overflowed 23/4096 of a 3.1 Gbp batch)
    PBUD1 = (128 if big else 48) * B   # pass-1 backward-pool lanes
    # pass-2 pools: low-error repeat-fixture batches measure ~1.8 re-seed
    # tasks/read (7,472/4096, long unique SMEMs) x ~13 breaks/task ≈
    # 24 walk lanes/read — a 16*B walk pool overflowed 35% of the batch
    # into the device-redo cliff.
    # 32*B holds the measured p100 with ~1.3x headroom; overflow still
    # routes to the big-budget device redo, a latency cliff only.
    # p2x: Gbp-scale genomes are ~unique at seed length, so nearly EVERY
    # SMEM qualifies for re-seeding (~6/read measured on the 1 Gbp
    # fixture; 1,273/4096 reads overflowed the x1 pools into the Gbp
    # redo cliff) — callers pass p2x=4 there (index/io loads choose
    # it by seq_len in seed_dispatch).
    # p2x>1 budgets re-measured at 3.1 Gbp (round 5): 9,562 tasks and
    # ~220k walk lanes per 4096-read batch — 2.3 tasks/read of an
    # 8/read budget. Trimmed to p2x/read tasks and 24*p2x walk lanes
    # (1.7x / 1.8x headroom); the adaptive escalation path catches
    # genomes beyond that. p2x=1 budgets are FULL at the bench fixture
    # (1.79 tasks/read of 2/read; 73% walk fill) — do not trim.
    if big:
        TBUD, PBUD2 = 8 * B, 128 * B
    elif p2x == 1:
        TBUD, PBUD2 = 2 * B, 32 * B
    else:
        TBUD, PBUD2 = p2x * B, 24 * p2x * B
    # backward-walk window: each chunk is a while_loop over a CS-lane
    # slice of the sorted pool, exiting at the chunk's own max walk.
    # Finer chunks waste fewer dead iterations but pay a fixed per-chunk
    # slicing/loop cost; the 2048 FLOOR matters for the small-B big-redo
    # variant, where B//2 alone gave 32-lane chunks -> 256 chunked loops
    # per pool, which dominated every Gbp redo call
    CS = min(4096, max(2048, B // 2))
    q_flat = q.reshape(-1)
    rid = jnp.arange(B, dtype=I32)

    def fresh(NL, NBc):
        return dict(
            mode=jnp.zeros(NL, I32), x=jnp.zeros(NL, I32),
            i=jnp.zeros(NL, I32), ik=jnp.zeros((NL, 3), dt),
            ik_info=jnp.zeros(NL, I32), g=jnp.zeros(NL, I32),
            nb=jnp.zeros(NL, I32),
            brk_kls=jnp.zeros((NL, 3, NBc), dt),
            brk_meta=jnp.zeros((NL, 3, NBc), I32),
            ovf=jnp.zeros(NL, bool), it=jnp.zeros((), I32))

    # pass 1's forward scan runs FUSED with pass 3 (both are serial
    # ~qlen-iteration per-read scans; one shared probe per iteration),
    # then pass 1's backward walks + emission
    c3 = _MachineConsts(L, MAXB, NP3, ITERS)
    st3 = dict(mode=jnp.zeros(B, I32), x=jnp.zeros(B, I32),
               i=jnp.zeros(B, I32), ik=jnp.zeros((B, 3), dt),
               mems=jnp.zeros((B, 4, NP3), dt), n_mem=jnp.zeros(B, I32),
               ovf=jnp.zeros(B, bool), it=jnp.zeros((), I32))
    s1, (mems3, n3, ovf3) = _p1p3_machine(
        dfm, L, NB, ITERS, q_flat, rid, qlen, fresh(B, NB), q, qlen,
        c3, min_seed_len, max_mem_intv, st3)
    mems1, n1, ovf_f1, ovf_p1 = _smem_pass_post(
        dfm, L, NB, q_flat, rid, jnp.ones(B, dt), min_seed_len, s1,
        PBUD1, CS)
    # ovf is an int32 bitmask of budget-exhaustion sources (diagnosable
    # in production; any nonzero bit routes the read to the host redo)
    ovf = ovf_f1.astype(I32) * OVF_P1_FWD + ovf_p1.astype(I32) * OVF_P1_POOL

    # pass 2: re-seed long low-occ SMEMs from the middle, min_intv = s+1;
    # tasks are independent -> lanes from a batch-global compacted task
    # pool (typical task count is ~1/read; a per-read task grid would
    # waste ~16x the forward-machine bandwidth)
    slot1 = jnp.arange(NB, dtype=I32)[None, :]
    ish = 16 if dt == I32 else 32
    start = (mems1[:, 3, :] >> ish).astype(I32)
    end = (mems1[:, 3, :] & ((1 << ish) - 1)).astype(I32)
    want = (slot1 < n1[:, None]) \
        & ((end - start) >= split_len) \
        & (mems1[:, 2, :] <= split_width.astype(dt))
    mid = ((start + end) >> 1).astype(I32)
    tsrc, _tdst, tv, tdrop = _compact(want.reshape(-1), TBUD)
    ovf = ovf | tdrop.reshape(B, NB).any(axis=1).astype(I32) * OVF_TASKPOOL
    rid2 = tsrc // NB                                  # owning read
    tx = jnp.where(tv, mid.reshape(-1)[tsrc], 0)
    tmi = jnp.where(tv, (mems1[:, 2, :] + 1).reshape(-1)[tsrc], dt.type(1))
    qx = _q_at(q_flat, rid2 * L + jnp.clip(tx, 0, L - 1))
    st2 = fresh(TBUD, NB2)
    st2.update(mode=jnp.where(tv, 1, 3), x=tx, i=tx + 1,
               ik=set_intv_batch(dfm, jnp.clip(qx, 0, 3)), ik_info=tx + 1)
    mems2l, n2l, ovf2f, ovf2p = _smem_pass(dfm, L, NB2, ITERS, q_flat,
                                           rid2, qlen[rid2], tmi,
                                           min_seed_len, st2,
                                           task_mode=True, PBUD=PBUD2,
                                           CS=CS)
    ovf2l = (ovf2f.astype(I32) * OVF_P2_FWD
             + ovf2p.astype(I32) * OVF_P2_POOL)
    ovf = ovf | jnp.zeros(B, I32).at[rid2].max(
        jnp.where(tv, ovf2l, 0), mode="drop")
    # merge task-lane emissions per read: lanes are read-major (compaction
    # preserves (read, slot) order) and dense-front, so the flat entry
    # order IS bwa's append order; scatter entries into a [B, M2] grid
    slot2 = jnp.arange(NB2, dtype=I32)[None, :]
    v2 = ((slot2 < n2l[:, None]) & tv[:, None]).reshape(-1)
    rid2e = jnp.repeat(rid2, NB2)                      # entry -> read
    v32 = v2.astype(I32)
    grank = jnp.cumsum(v32) - v32
    cnt2 = jnp.zeros(B, I32).at[rid2e].add(v32, mode="drop")
    base2 = jnp.cumsum(cnt2) - cnt2
    p2 = grank - base2[rid2e]                          # pos within read
    keep2 = v2 & (p2 < M2)
    ovf = ovf | jnp.zeros(B, I32).at[rid2e].max(
        (v2 & (p2 >= M2)).astype(I32) * OVF_P2_EMIT, mode="drop")
    dst2 = jnp.where(keep2, rid2e * M2 + p2, B * M2)
    # per-component flat scatters: four elementwise scatters with the
    # shared index vector in place of one row scatter ([TBUD*NB2, 4])
    cols = [jnp.zeros(B * M2, dt).at[dst2].set(
        mems2l[:, c, :].reshape(-1), mode="drop") for c in range(4)]
    mems2 = jnp.stack(cols, 0).reshape(4, B, M2).transpose(1, 0, 2)
    n2 = jnp.minimum(cnt2, M2)

    # pass 3 ran fused with pass 1 above (skipped if max_mem_intv <= 0)
    use3 = max_mem_intv > 0
    n3 = jnp.where(use3, n3, 0)
    ovf = ovf | (use3 & ovf3).astype(I32) * OVF_P3

    # concatenate in bwa append order (each section dense-front), then
    # final sort by info (ks_introsort mem_intv semantics)
    mems = jnp.concatenate([mems1, mems2, mems3], axis=2)
    valid_all = jnp.concatenate(
        [slot1 < n1[:, None],
         jnp.arange(M2, dtype=I32)[None, :] < n2[:, None],
         jnp.arange(NP3, dtype=I32)[None, :] < n3[:, None]], axis=1)
    n_mem = n1 + n2 + n3
    ovf = ovf | (n_mem > MAXM).astype(I32) * OVF_MEMS
    n_mem = jnp.minimum(n_mem, MAXM)
    key = jnp.where(valid_all, mems[:, 3, :], jnp.iinfo(dt).max)
    order = jnp.argsort(key, axis=1)
    mems = jnp.take_along_axis(mems, order[:, None, :], axis=2)[:, :, :MAXM]
    slot_i = jnp.arange(MAXM, dtype=I32)[None, :]

    # fused on-device SA resolution of the FULL occurrence enumeration:
    # probes land in a batch-global ragged pool (CAPO lanes) in exactly
    # sa_probe_layout's order (read-major, sorted-slot-major, occurrence
    # j at x0 + j*step with cnt = min(s, max_occ) sampling — bwa's
    # mem_chain occurrence rule). Covering EVERY read here removes the
    # separate SA probe program from the device queue entirely, which is
    # what lets batch N+1's seed program dispatch at iteration top and
    # keep the device 100% busy (a per-read [B, 64] budget left the ~6%
    # heaviest repeat reads on a dependent probe round trip).
    if dfm.sa_dense is not None or sa_intv_s > 0:
        # the big-budget redo variant serves the heaviest ~0.5% of reads:
        # give it a deep pool so redone reads never fall to the probe
        # path (a dependent device round trip that would queue behind
        # the next batch's seed program)
        per = CAPO_PER if dfm.sa_dense is not None else CAPO_PER_BIG
        CAPO = (per * 16 if big else per) * B
        valid = slot_i < n_mem[:, None]
        s_col = jnp.where(valid, mems[:, 2, :], 0)           # [B, MAXM]
        x0_col = mems[:, 0, :]
        over = s_col > max_occ
        cnt = jnp.where(over, max_occ.astype(dt), s_col).astype(I32)
        step = jnp.where(over, s_col // jnp.maximum(max_occ, 1),
                         dt.type(1))
        # int64 prefix sums: with -c (max_occ) in the thousands an int32
        # cumsum over B*MAXM slots wraps negative, silently zeroing every
        # fused SA value while early reads still pass the host-side
        # baseo+t<=CAPO fit check (advisor r4). Totals are clamped back
        # to int32 AFTER the segment math.
        cntf = cnt.reshape(-1).astype(jnp.int64)             # [B*MAXM]
        gcum = jnp.cumsum(cntf)
        gcum0 = gcum - cntf
        occ_total = jnp.clip(
            gcum.reshape(B, MAXM)[:, -1] - gcum0.reshape(B, MAXM)[:, 0],
            0, jnp.iinfo(I32).max).astype(I32)
        p = jnp.arange(CAPO, dtype=I32)
        # owning slot of each pool position: scatter each real slot's id
        # at its segment start, then a running max (distinct starts by
        # construction; in place of a searchsorted)
        sid = jnp.arange(B * MAXM, dtype=I32)
        starts = jnp.where(cntf > 0, jnp.minimum(gcum0, CAPO),
                           CAPO).astype(I32)
        marks = jnp.zeros(CAPO, I32).at[starts].max(sid + 1, mode="drop")
        seg = jnp.clip(jax.lax.cummax(marks) - 1, 0, B * MAXM - 1)
        ok = p < jnp.minimum(gcum[-1], CAPO).astype(I32)
        rows = (x0_col.reshape(-1)[seg]
                + (p - gcum0[seg]).astype(dt) * step.reshape(-1)[seg])
        if dfm.sa_dense is not None:
            idx = jnp.clip(jnp.where(ok, rows, 0), 0,
                           dfm.sa_dense.shape[0] - 1).astype(I32)
            occ_sa = jnp.where(ok, dfm.sa_dense[idx].astype(dt),
                               dt.type(0))
        else:
            # big-genome path (round-4 verdict task 2): the PHASED LF
            # walk against the resampled on-device SA resolves the
            # whole enumeration inside the seed program, instead of a
            # separate dependent probe program per batch.
            # A read whose walk blew the budget/pool (~1e-4) routes to
            # the redo path via OVF_SA. occ_total must NOT change here:
            # the host derives segment offsets from the totals, so they
            # have to match the pool layout for every read, flagged or
            # not (a -1 sentinel desynchronized every later read).
            rows_w = jnp.where(ok, rows, 0)
            vals, ovf_w = sa_batch(dfm, rows_w, 256, sa_intv_s)
            bad = jnp.zeros(B, I32).at[
                jnp.where(ok & ovf_w, seg // MAXM, B)].max(
                1, mode="drop")
            ovf = ovf | bad * OVF_SA
            occ_sa = jnp.where(ok, vals.astype(dt), dt.type(0))
    else:
        occ_sa = jnp.zeros(1, jnp.int64)
        occ_total = jnp.full((B,), -1, I32)   # sentinel: not resolved
    if pack_H:
        # fused narrow bundle: the host fetches ONE int32 array per batch
        # (one device->host copy instead of five)
        packed = _pack_ragged(mems, n_mem, ovf, occ_sa, occ_total, B)
        return mems, n_mem, ovf, occ_sa, occ_total, packed
    return mems, n_mem, ovf, occ_sa, occ_total


_OPT_CACHE: dict = {}


@jax.jit
def _pack_meta(n_mem, ovf, occ_total):
    return jnp.stack([n_mem.astype(I32), ovf.astype(I32), occ_total])


# ragged-bundle sizing: flat mem entries / fused-SA values per read
# (GLOBAL pools, so only the batch MEAN matters: measured on the
# repeat-realistic bench genome mean ~9.0 mems per read and ~26 SA
# occurrences per read with the FULL enumeration fused — reads past the
# pool fall back per-read to the probe path / dense refetch, a latency
# cliff, not a correctness one)
CAPM_PER = 14
CAPO_PER = 40
# big-genome (no dense SA) fused-walk pool: human-scale repeat genomes
# measure ~100+ occurrences/read (40/read covered only 65% of a 3.1 Gbp
# batch; the uncovered tail paid a dependent probe program). Capacity is
# cheap there: the phased walk skips all-dead 64k chunks, and the wide
# path ships no padded pool (meta fetches only the used prefix).
CAPO_PER_BIG = 144


def _pack_ragged(mems, n_mem, ovf, occ_sa, occ_total, B: int):
    """Bundle the batch's seeding result as ONE 1-D int32 array holding
    only the REAL entries (device-side compaction), instead of 32 padded
    mem slots + 64 padded SA values per read (~780 B/read). Layout:

      [0] total flat mem entries   [1] total flat SA values  [2..3] pad
      [4        .. 4+B)    n_mem          [4+B   .. 4+2B)  ovf bits
      [4+2B     .. 4+3B)   occ_total
      [hdr      .. +CAPM)  info (start<<16|end), per-read segments in
                           order; then x0 [CAPM], then s [CAPM]
      [..       .. +CAPO)  fused SA values, segments for reads with
                           0 <= occ_total <= MAXO

    If the batch's totals exceed the CAPM/CAPO pools ([0]/[1] report
    this), the host refetches the dense mems instead — a latency
    fallback, not a correctness one. Narrow machines only (the caller
    guards seq_len < 2^31, reads < 32768 bp)."""
    MAXM = mems.shape[2]
    CAPM = CAPM_PER * B
    # the SA pool rides at the MACHINE's size (deeper on the no-dense
    # fused-walk path); the host derives the same size from the handle
    CAPO = occ_sa.shape[0] if occ_sa.shape[0] > 1 else CAPO_PER * B
    slot_i = jnp.arange(MAXM, dtype=I32)[None, :]
    valid = slot_i < n_mem[:, None]
    base = jnp.cumsum(n_mem) - n_mem
    total_m = base[-1] + n_mem[-1]
    dstm = jnp.where(valid, base[:, None] + slot_i, CAPM).reshape(-1)

    def flat(vals):
        return jnp.zeros(CAPM, I32).at[dstm].set(
            vals.astype(I32).reshape(-1), mode="drop")

    info = mems[:, 3, :]
    if info.dtype != I32:
        info = (((info >> 32) << 16) | (info & 0xFFFF))
    fm_ie = flat(info)
    fm_k = flat(mems[:, 0, :])
    # x1 (the reverse-complement interval coordinate) is not consumed by
    # the host chain/SA stages, so it stays on device; the lists() view
    # (tests / Python fallbacks) refetches it from the dense mems
    fm_s = flat(mems[:, 2, :])
    # occ_sa is ALREADY the global ragged pool in transfer layout
    # (read-major segments of cumsum(occ_total)); only the total header
    # is needed for the host's per-read fit checks
    ocnt = jnp.where(occ_total >= 0, occ_total, 0)
    total_o = jnp.sum(ocnt)
    fo = occ_sa.astype(I32)
    if fo.shape[0] != CAPO:               # no-dense-SA sentinel shape
        fo = jnp.zeros(CAPO, I32)
    hdr = jnp.stack([total_m, total_o, jnp.zeros((), I32),
                     jnp.zeros((), I32)])
    return jnp.concatenate([hdr, n_mem.astype(I32), ovf.astype(I32),
                            occ_total.astype(I32), fm_ie, fm_k, fm_s,
                            fo])


def pad_reads(reads: list[np.ndarray], L: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Pad reads to a [B, L] uint8 batch (pad symbol 4), B a power-of-two
    bucket so read counts share compiled programs. uint8 keeps the
    host->device upload at 1 byte/base (the device widens on entry)."""
    B = 64
    while B < len(reads):
        B <<= 1
    q = np.full((B, L), 4, dtype=np.uint8)
    qlen = np.zeros(B, dtype=np.int32)
    for b, r in enumerate(reads):
        n = min(len(r), L)
        q[b, :n] = r[:n]
        qlen[b] = n
    return q, qlen


SEED_HEAD = 32  # slots fetched eagerly; reads rarely use more


@functools.partial(jax.jit, static_argnums=(1,))
def _mems_slice(mems, width: int):
    return mems[:, :, :width]


@functools.partial(jax.jit, static_argnums=(1,))
def _mems_slice1(arr, width: int):
    return arr[:width]


def _start_fetch(arr):
    try:
        arr.copy_to_host_async()
    except AttributeError:
        pass
    return arr


_NARROW_CACHE: dict = {}
_NARROW_MAX = 2


def narrow_cache_reserve(n: int) -> None:
    """Widen the narrow-view LRU for multi-device replication (one view
    per per-chip DeviceFM replica must stay cached)."""
    global _NARROW_MAX
    _NARROW_MAX = max(_NARROW_MAX, n)

# Test hook: force the wide (int64) machine even for sub-2^31 genomes so
# the human-scale path stays covered by small-genome unit tests.
FORCE_WIDE = False


def _narrow_dfm(dfm: DeviceFM) -> DeviceFM:
    """Cached int32-coordinate view of a sub-2^31 index (the astype ops
    are device executions; caching keeps them one-time per index, not
    per batch). Keyed by the DeviceFM itself (held in the cache, so ids
    stay unique): variants sharing fm_blocks but differing in other
    leaves must not be served each other's views."""
    from .fm_jax import _narrow_view
    key = id(dfm)
    got = _NARROW_CACHE.get(key)
    if got is None or got[0] is not dfm:
        got = (dfm, _narrow_view(dfm))
        _NARROW_CACHE[key] = got
        # bounded: keeping every DeviceFM ever narrowed would pin GBs of
        # device memory for process lifetime in index-reloading services;
        # a size-2 LRU covers the realistic case (old + new index during
        # a swap), widened for per-chip replicas (narrow_cache_reserve)
        while len(_NARROW_CACHE) > _NARROW_MAX:
            _NARROW_CACHE.pop(next(iter(_NARROW_CACHE)))
    return got[1]


def _opt_params(opt: MemOpt) -> tuple:
    key = (id(opt), opt.min_seed_len, opt.split_len, opt.split_width,
           opt.max_mem_intv, opt.max_occ)
    params = _OPT_CACHE.get(key)
    if params is None:
        params = (jnp.asarray(opt.min_seed_len, I32),
                  jnp.asarray(opt.split_len, I32),
                  jnp.asarray(opt.split_width, I32),
                  jnp.asarray(opt.max_mem_intv, I64),
                  jnp.asarray(opt.max_occ, I64))
        _OPT_CACHE[key] = params
    return params


def seed_dispatch(opt: MemOpt, fm: FMIndex, dfm: DeviceFM,
                  reads: list[np.ndarray], L: int = 256,
                  MAXB: int = 64, MAXM: int = 128,
                  iters_factor: int = 16, padded=None) -> dict:
    """Dispatch the device SMEM machine for a batch and START the
    device->host fetches of the meta row and the leading SEED_HEAD mem
    slots (the copies overlap the rest of the program); returns a handle
    for seed_collect. The padded read batch is kept in the handle so the
    extension stage can address it (descriptor-only waves)."""
    if padded is not None:
        q, qlen = padded
        q_dev, qlen_dev = q, qlen
    else:
        q, qlen = pad_reads(reads, L)
        q_dev, qlen_dev = jnp.asarray(q), jnp.asarray(qlen)
    params = _opt_params(opt)
    H = min(SEED_HEAD, MAXM)
    narrow = fm.seq_len < 2**31 and L < 32768 and not FORCE_WIDE
    # Gbp-class genomes are ~unique at seed length: nearly every SMEM
    # re-seeds in pass 2, so those loads get 4x-deep pass-2 pools
    p2x = 4 if fm.seq_len >= (1 << 28) else 1
    p2x = max(p2x, _ADAPT.get(id(fm), 1))
    # no dense SA (Gbp-scale): fuse the phased LF walk against the
    # (resampled) sampled SA into the seed program
    sa_s = int(fm.sa_intv) if (dfm.sa_dense is None
                               and fm.sa_intv <= 64) else 0
    out = collect_intv_device(
        _narrow_dfm(dfm) if narrow else dfm, L, MAXB, MAXM,
        L * iters_factor, q_dev, qlen_dev, *params,
        pack_H=H if narrow else 0, p2x=p2x, sa_intv_s=sa_s)
    h = dict(reads=reads, opt=opt, fm=fm, dfm=dfm, L=L, MAXB=MAXB,
             MAXM=MAXM, iters=L * iters_factor, q_dev=q_dev, mems=out[0],
             p2x=p2x)
    if narrow:
        # single narrow transfer for the whole seeding result
        h["packed"] = _start_fetch(out[5])
    else:
        mems, n_mem, ovf, occ_sa, occ_total = out
        h["meta"] = _start_fetch(_pack_meta(n_mem, ovf, occ_total))
        if occ_sa.shape[0] > 1:
            # fused pool present (wide machine): keep it on device; the
            # collect slices the USED prefix once the meta arrives (the
            # deep big-genome pool would cost MBs to ship padded)
            h["occ_sa_dev"] = occ_sa
        h["head"] = _start_fetch(_mems_slice(mems, H))
    return h


def seed_collect_batch(handle: dict, fetch=np.asarray
                       ) -> smem_golden.IntvBatch:
    """Finish a seed_dispatch as an ARRAY-NATIVE IntvBatch (no per-Intv
    Python objects; the native chain/wave stages consume the flat arrays
    directly). Overflowed reads are redone with the golden implementation
    (reference redo pattern, FPGAPipeline.cpp:706-714) and spliced in."""
    opt, fm, reads = handle["opt"], handle["fm"], handle["reads"]
    L, MAXM = handle["L"], handle["MAXM"]
    n = len(reads)
    H = min(SEED_HEAD, MAXM)
    packed = handle.get("packed")
    flats = None            # (k, l, s, st, en) flat arrays + entry owner
    occ_flat = None
    if packed is not None:
        pk = fetch(packed)
        Bp = handle["q_dev"].shape[0]
        CAPM = CAPM_PER * Bp
        CAPO = (CAPO_PER if handle["dfm"].sa_dense is not None
                else CAPO_PER_BIG) * Bp
        total_m, total_o = int(pk[0]), int(pk[1])
        o = 4
        n_mem = pk[o:o + Bp]
        o += Bp
        ovf = pk[o:o + Bp] != 0
        o += Bp
        occ_total = pk[o:o + Bp]
        o += Bp
        if total_m <= CAPM:
            fm_ie = pk[o:o + CAPM][:total_m]
            fm_k = pk[o + CAPM:o + 2 * CAPM][:total_m]
            fm_s = pk[o + 2 * CAPM:o + 3 * CAPM][:total_m]
            flats = (fm_k, np.zeros(total_m, np.int32), fm_s,
                     (fm_ie >> 16).astype(np.int32),
                     (fm_ie & 0xFFFF).astype(np.int32))
        # global ragged pool: reads whose segment fits inside CAPO are
        # fused even when the batch TOTAL overflows (per-read fit check
        # below); the tail past CAPO falls back to the probe path
        occ_flat = pk[o + 3 * CAPM:o + 3 * CAPM + CAPO]
    else:
        meta = fetch(handle["meta"])
        n_mem = meta[0]
        ovf = meta[1] != 0
        occ_total = meta[2]
    if flats is None:
        # wide genome, or the ragged mem pool overflowed (dense refetch)
        used = int(n_mem.max()) if len(n_mem) else 0
        width = H
        while width < used:
            width <<= 1
        width = min(width, MAXM)
        if packed is None and used <= H:
            mems = fetch(handle["head"])
        else:
            mems = fetch(_start_fetch(_mems_slice(handle["mems"], width)))
        W = mems.shape[2]
        ish = INFO_SHIFT[mems.dtype]      # narrow machine packs start<<16
        counts = np.minimum(n_mem[:n].astype(np.int64), W)
        redo = np.fromiter(
            (bool(ovf[b]) or len(reads[b]) > L for b in range(n)), bool, n)
        counts = np.where(redo, 0, counts)
        m = (np.arange(W)[None, :] < counts[:, None]).ravel()
        k_c = mems[:n, 0, :].ravel()[m]
        l_c = mems[:n, 1, :].ravel()[m]
        s_c = mems[:n, 2, :].ravel()[m]
        st_c = (mems[:n, 3, :] >> ish).astype(np.int32).ravel()[m]
        en_c = (mems[:n, 3, :] & ((1 << ish) - 1)).astype(
            np.int32).ravel()[m]
    else:
        counts = n_mem[:n].astype(np.int64)
        redo = np.fromiter(
            (bool(ovf[b]) or len(reads[b]) > L for b in range(n)), bool, n)
        # flat segments are read-major; the owner of each entry fully
        # determines the keep selection
        owner = np.repeat(np.arange(len(n_mem)), n_mem)
        keep = (owner < n) & ~np.pad(redo, (0, len(n_mem) - n))[owner]
        counts = np.where(redo, 0, counts)
        k_c, l_c, s_c, st_c, en_c = (c[keep] for c in flats)
        handle["_x1_elided"] = (n_mem, redo)
    iv_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=iv_off[1:])
    batch = smem_golden.IntvBatch(iv_off, k_c.astype(np.int64),
                                  l_c.astype(np.int64),
                                  s_c.astype(np.int64), st_c, en_c)
    # per-read fused SA values (device enumeration) or None when the read
    # must go through the probe path (redone on host / budget exceeded /
    # no dense SA)
    sa_vals: list = [None] * n
    occ_np = None
    ocnt = np.where(occ_total >= 0, occ_total, 0)
    baseo = np.cumsum(ocnt, dtype=np.int64) - ocnt
    CAPO_n = len(occ_flat) if occ_flat is not None else 0
    for b in np.nonzero(~redo)[0]:
        t = int(occ_total[b])
        if t >= 0:
            if occ_flat is not None:
                if baseo[b] + t <= CAPO_n:   # segment fully in the pool
                    sa_vals[b] = occ_flat[baseo[b]:baseo[b] + t]
            elif packed is None and handle.get("occ_sa_dev") is not None:
                if occ_np is None:
                    dev = handle["occ_sa_dev"]
                    total_o = int(ocnt.sum())
                    width = 1024
                    while width < min(total_o, dev.shape[0]):
                        width <<= 1
                    width = min(width, dev.shape[0])
                    occ_np = fetch(_start_fetch(
                        _mems_slice1(dev, width)))
                if baseo[b] + t <= len(occ_np):
                    sa_vals[b] = occ_np[baseo[b]:baseo[b] + t]
    handle["sa_vals"] = sa_vals
    if not redo.any():
        # no dependent device work: the post-dispatch callback (next
        # batch's seed program) can fire now
        cb = handle.pop("_post_redo_dispatch", None)
        if cb is not None:
            cb()
    if n and redo.sum() > ADAPT_THRESH * n:
        # overflow cliff on this index: escalate the pool profile for
        # every subsequent dispatch (novel-genome guard, verdict r4#10)
        cur = handle.get("p2x", 1)
        nxt_p2x = 4 if cur < 4 else 8
        if cur < 8 and _ADAPT.get(id(fm), 1) < nxt_p2x:
            _ADAPT[id(fm)] = nxt_p2x
            import sys as _sys
            print(f"[M::seed] {int(redo.sum())}/{n} reads overflowed "
                  f"the p2x={cur} pools; escalating to p2x={nxt_p2x} "
                  "for subsequent batches", file=_sys.stderr)
    if redo.any():
        # splice redone reads in (rare: budget overflow / long reads).
        # First retry: the big-budget DEVICE machine (the reference keeps
        # retries on the accelerator too, FPGAPipeline.cpp:29-130) —
        # far cheaper than the host golden on repeat-rich genomes.
        # Only reads that exhaust even the big budgets
        # (or exceed the padded length L) drop to the host golden.
        repl: dict = {}   # read -> {name: replacement array}
        todo = [int(b) for b in np.nonzero(redo)[0]]
        if DEVICE_REDO and handle.get("dfm") is not None:
            todo = _device_redo(handle, todo, repl, counts, sa_vals)
        cb = handle.pop("_post_redo_dispatch", None)
        if cb is not None:   # redo skipped the device (hook/long reads)
            cb()
        for b in todo:
            iv = smem_golden.collect_intv(opt, fm, reads[b])
            rb = smem_golden.IntvBatch.from_lists([iv])
            repl[b] = {name: getattr(rb, name)
                       for name in ("x0", "x1", "sv", "st", "en")}
            counts[b] = len(iv)
        batch = _splice_batch(batch, counts, repl, n)
    return batch


def _splice_batch(batch, counts, repl: dict, n: int):
    """Rebuild an IntvBatch with per-read replacement segments: bulk-copy
    the unchanged RUNS between redo reads (~#redo copies) instead of
    np.split/concatenate over every read (5 arrays x B views on the
    collect critical path)."""
    old_off = batch.iv_off
    iv_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=iv_off[1:])
    names = ("x0", "x1", "sv", "st", "en")
    outs = {name: np.empty(int(iv_off[-1]),
                           getattr(batch, name).dtype) for name in names}
    prev = 0
    for b in sorted(repl) + [n]:
        s_lo, s_hi = int(old_off[prev]), int(old_off[min(b, n)])
        d_lo = int(iv_off[prev])
        for name in names:
            outs[name][d_lo:d_lo + (s_hi - s_lo)] = \
                getattr(batch, name)[s_lo:s_hi]
        if b < n:
            d = int(iv_off[b])
            for name in names:
                seg = repl[b][name]
                outs[name][d:d + len(seg)] = seg
            prev = b + 1
    return smem_golden.IntvBatch(iv_off, *(outs[name] for name in names))


DEVICE_REDO = True   # test hook: False forces every overflow to golden
REDO_B = 512         # max reads per device-redo dispatch

# Adaptive budget escalation (round-5, verdict task 10): pool profiles
# are tuned per fixture class, and a NOVEL genome whose reads overflow
# the default pools would otherwise pay the device-redo cliff on every
# batch. seed_collect_batch tracks the overflow rate per index and
# permanently escalates the p2x profile (deeper pass-2 task/walk pools,
# wider NB2/M2) for subsequent dispatches once a batch overflows >5% —
# one-way, capped at p2x=8, so at most two extra compiles per index.
_ADAPT: dict[int, int] = {}
ADAPT_THRESH = 0.05


def _device_redo(handle: dict, idx: list, repl: dict, counts, sa_vals
                 ) -> list:
    """Re-run budget-overflowed reads with the big-budget device machine
    and record replacement segments in ``repl`` (_splice_batch). Returns
    the residue that must still go to the host golden. Compiles one
    program per pow2 batch bucket (>=8, <=REDO_B) — bounded, and
    persistent-cached like every other shape variant."""
    opt, fm, dfm, reads = (handle[k] for k in ("opt", "fm", "dfm", "reads"))
    L, MAXB = handle["L"], handle["MAXB"]
    # OVF_MEMS overflows need more mem slots, not just bigger pools
    MAXM = max(256, 2 * handle["MAXM"])
    fit = [b for b in idx if len(reads[b]) <= L]
    rest = [b for b in idx if len(reads[b]) > L]
    if not fit:
        return rest
    narrow = fm.seq_len < 2**31 and L < 32768 and not FORCE_WIDE
    d = _narrow_dfm(dfm) if narrow else dfm
    params = _opt_params(opt)
    # two-phase: dispatch every redo program async FIRST so the caller's
    # post-dispatch callback (the next batch's seed program) enqueues
    # right behind them instead of waiting for their results
    chunks = []
    for c0 in range(0, len(fit), REDO_B):
        sub = fit[c0:c0 + REDO_B]
        # pad_reads already pow2-buckets (>= 64): no extra padding, and
        # pool chunking relies on B being a power of two
        q, qlen = pad_reads([reads[b] for b in sub], L)
        sa_s = int(fm.sa_intv) if (dfm.sa_dense is None
                                   and fm.sa_intv <= 64) else 0
        out = collect_intv_device(d, L, MAXB, MAXM, handle["iters"],
                                  jnp.asarray(q), jnp.asarray(qlen),
                                  *params, pack_H=0, big=True,
                                  sa_intv_s=sa_s)
        for o in out:
            _start_fetch(o)
        chunks.append((sub, out))
    cb = handle.pop("_post_redo_dispatch", None)
    if cb is not None:
        cb()
    for sub, out in chunks:
        mems, n_mem, ovf, occ_sa, occ_total = (np.asarray(o) for o in out)
        ish = INFO_SHIFT[mems.dtype]
        ocnt_r = np.where(occ_total >= 0, occ_total, 0)
        baseo_r = np.cumsum(ocnt_r, dtype=np.int64) - ocnt_r
        for j, b in enumerate(sub):
            if ovf[j]:
                rest.append(b)
                continue
            c = int(n_mem[j])
            repl[b] = dict(
                x0=mems[j, 0, :c].astype(np.int64),
                x1=mems[j, 1, :c].astype(np.int64),
                sv=mems[j, 2, :c].astype(np.int64),
                st=(mems[j, 3, :c] >> ish).astype(np.int32),
                en=(mems[j, 3, :c] & ((1 << ish) - 1)).astype(np.int32))
            counts[b] = c
            t = int(occ_total[j])
            if (t >= 0 and occ_sa.ndim == 1 and len(occ_sa) > 1
                    and baseo_r[j] + t <= len(occ_sa)):
                sa_vals[b] = occ_sa[baseo_r[j]:baseo_r[j] + t]
    return rest


def seed_collect(handle: dict, fetch=np.asarray
                 ) -> list[list[smem_golden.Intv]]:
    """Finish a seed_dispatch as per-read Intv lists (Python-object view
    of seed_collect_batch, kept for the fallback/golden paths). The
    ragged bundle elides x1 (production never reads it); this view
    restores it from the device-resident dense mems."""
    batch = seed_collect_batch(handle, fetch)
    info = handle.pop("_x1_elided", None)
    if info is not None:
        n_mem, redo = info
        used = int(n_mem.max()) if len(n_mem) else 0
        # start the bucket search where seed_collect_batch does so the
        # refetch reuses existing _mems_slice shape variants instead of
        # compiling 1/2/4/8-wide ones no other path uses
        width = min(SEED_HEAD, handle["MAXM"])
        while width < max(used, 1):
            width <<= 1
        width = min(width, handle["MAXM"])
        mems = fetch(_start_fetch(_mems_slice(handle["mems"], width)))
        off = batch.iv_off
        x1 = batch.x1.copy()
        for r in np.nonzero(~redo)[0]:
            c = off[r + 1] - off[r]
            x1[off[r]:off[r + 1]] = mems[r, 1, :c]
        batch.x1 = x1
    return batch.lists()


def collect_intv_batch(opt: MemOpt, fm: FMIndex, dfm: DeviceFM,
                       reads: list[np.ndarray], L: int = 256,
                       MAXB: int = 64, MAXM: int = 128,
                       iters_factor: int = 16, padded=None
                       ) -> list[list[smem_golden.Intv]]:
    # the budget defaults stay at the reference's FPGA task shape
    # (SMemTask.cpp:26-28); they are not yet tuned for the GPU
    """Synchronous wrapper: seed_dispatch + seed_collect."""
    h = seed_dispatch(opt, fm, dfm, reads, L, MAXB, MAXM, iters_factor,
                      padded)
    return seed_collect(h)
