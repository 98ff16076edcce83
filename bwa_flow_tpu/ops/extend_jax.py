"""Device (JAX/XLA) banded Smith-Waterman seed extension — batched, exact.

Device replacement for the reference's hot kernel pair:
  - scalar/SSE2 ksw_extend2 (bwa/ksw.c:380-479)
  - the 20-PE HLS FPGA kernel (src/fpga/kernel/smithwaterman.cpp)

Unlike the FPGA kernel (which hardcodes scoring and only matches at flagstat
level), this implementation reproduces ksw_extend2's integer semantics
bit-for-bit: band clamping, h0-seeded first column, z-drop with del/ins
asymmetry, to-end gscore, last-argmax tie-breaking for (max_i, max_j), and
the post-row band shrink scan.

Formulation: one fused jit program per (B, QMAX, TMAX) shape bucket.
State is H/E rows of shape [B, QMAX+1] (int32) carried through a
`lax.fori_loop` over target rows; every per-lane scalar (band bounds, maxes,
done flags) is a [B] vector and early exits become freeze masks. The
intra-row F dependency is a decayed prefix max computed with `lax.cummax`
(log-depth), so each row is pure vector work — no scalar loops. XLA
compiles this as it stands for the GPU; it is the only extension kernel.

Output contract matches the reference task 6-tuple
(score, qle, tle, gtle, gscore, max_off) that the FPGA path packs as
5 shorts + score (/root/reference/src/fpga/FPGAPipeline.cpp:29-130).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 30)


def _row_gather(arr: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """arr[b, idx[b]] for arr [B, N], idx int32[B] (assumed in range)."""
    return jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]


def extend_core(qmax: int, tmax: int,
                query: jnp.ndarray, qlen: jnp.ndarray,
                target: jnp.ndarray, tlen: jnp.ndarray,
                h0: jnp.ndarray, mat: jnp.ndarray,
                o_del: jnp.ndarray, e_del: jnp.ndarray,
                o_ins: jnp.ndarray, e_ins: jnp.ndarray,
                w: jnp.ndarray, end_bonus: jnp.ndarray,
                zdrop: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Traceable batched ksw_extend2 (compose under an outer jit).

    query: [B, qmax], target: [B, tmax], qlen/tlen/h0: [B]; mat: [5, 5];
    `w` may be 0-d or per-lane [B] (the band-doubling retry passes 2w for
    selected lanes). Returns (score, qle, tle, gtle, gscore, max_off),
    each int32[B]; degenerate lanes give (h0, 0, 0, 0, -1, 0).
    """
    B = query.shape[0]
    i32 = jnp.int32
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    # per-lane band cap (bwa/ksw.c:399-407): double math, truncated to int
    max_sc = jnp.max(mat).astype(jnp.float64)
    qf = qlen.astype(jnp.float64)
    ebf = end_bonus.astype(jnp.float64)
    max_ins = (qf * max_sc + ebf - o_ins.astype(jnp.float64)) \
        / e_ins.astype(jnp.float64) + 1.0
    max_del = (qf * max_sc + ebf - o_del.astype(jnp.float64)) \
        / e_del.astype(jnp.float64) + 1.0
    wv = jnp.minimum(w, jnp.maximum(max_ins.astype(i32), 1))
    wv = jnp.minimum(wv, jnp.maximum(max_del.astype(i32), 1))

    # query profile for all 5 target symbols: qp[b, t, j] = mat[t, query[b, j]]
    qp = mat[:, :].astype(i32)[jnp.arange(5)[:, None], query[:, None, :]]
    # -> [B, 5, qmax] via broadcasting: mat[t, query[b, j]]

    jcol = jnp.arange(qmax + 1, dtype=i32)[None, :]       # [1, qmax+1]
    jq = jnp.arange(qmax, dtype=i32)[None, :]             # [1, qmax]

    # first row of H (bwa/ksw.c:390-396): ehH[0]=h0; ehH[j>=1] =
    # max(h0 - oe_ins - (j-1)*e_ins, 0) while the chain stays positive
    ehH0 = jnp.where(
        jcol == 0, h0[:, None],
        jnp.maximum(h0[:, None] - oe_ins - (jcol - 1) * e_ins, 0))
    ehH0 = jnp.where(jcol <= qlen[:, None], ehH0, 0).astype(i32)
    ehE0 = jnp.zeros((B, qmax + 1), dtype=i32)

    init = dict(
        ehH=ehH0, ehE=ehE0,
        beg=jnp.zeros(B, i32), end=qlen.astype(i32),
        maxv=h0.astype(i32), max_i=jnp.full(B, -1, i32),
        max_j=jnp.full(B, -1, i32), max_ie=jnp.full(B, -1, i32),
        gscore=jnp.full(B, -1, i32), max_off=jnp.zeros(B, i32),
        done=(qlen == 0) | (tlen == 0),
    )

    def row(i, st):
        active0 = (~st["done"]) & (i < tlen)
        beg = jnp.where(active0, jnp.maximum(st["beg"], i - wv), st["beg"])
        end = jnp.where(active0,
                        jnp.minimum(jnp.minimum(st["end"], i + wv + 1),
                                    qlen.astype(i32)),
                        st["end"])
        degenerate = beg >= end
        active = active0 & ~degenerate
        act2 = active[:, None]

        tb = jax.lax.dynamic_index_in_dim(
            target, jnp.minimum(i, tmax - 1), axis=1, keepdims=False)
        # q[b, j] = mat[tb[b], query[b, j]] via 5-way select (no gather)
        q = jnp.zeros((B, qmax), i32)
        for c in range(5):
            q = jnp.where((tb == c)[:, None], qp[:, c, :], q)

        band_j = (jq >= beg[:, None]) & (jq < end[:, None])  # [B, qmax]
        Hd = st["ehH"][:, :qmax]          # H(i-1, j-1) at band position j
        Ein = st["ehE"][:, :qmax]
        M = jnp.where(Hd != 0, Hd + q, 0)
        M = jnp.where(band_j, M, 0)
        Ein_b = jnp.where(band_j, Ein, 0)

        # F scan: F[beg] = 0; F[j] = max_{beg<=k<j} (max(M[k]-oe_ins,0)
        #                                            - (j-1-k)*e_ins)
        T_ins = jnp.maximum(M - oe_ins, 0)
        A = jnp.where(band_j, T_ins + jq * e_ins, NEG)
        run = jax.lax.cummax(A, axis=1)
        runs = jnp.concatenate(
            [jnp.full((B, 1), NEG, i32), run[:, :-1]], axis=1)
        F = jnp.maximum(runs - (jq - 1) * e_ins, NEG)
        F = jnp.where(jq == beg[:, None], 0, F)
        F = jnp.where(band_j, F, 0)
        F = jnp.maximum(F, 0)  # values from NEG sentinel clamp to 0

        H = jnp.maximum(jnp.maximum(M, Ein_b), F)
        H = jnp.where(band_j, H, 0)
        Eout = jnp.maximum(jnp.maximum(M - oe_del, 0), Ein_b - e_del)
        Eout = jnp.where(band_j, Eout, 0)

        h1_init = jnp.where(beg == 0,
                            jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0),
                            0).astype(i32)

        # write-back: ehH[beg]=h1_init; ehH[j]=H[j-1] for beg<j<=end;
        # ehE[j]=Eout[j] for beg<=j<end; ehE[end]=0
        Hshift = jnp.concatenate([jnp.zeros((B, 1), i32), H], axis=1)
        in_write = (jcol > beg[:, None]) & (jcol <= end[:, None])
        new_ehH = jnp.where(jcol == beg[:, None], h1_init[:, None],
                            jnp.where(in_write, Hshift, st["ehH"]))
        band_e = (jcol >= beg[:, None]) & (jcol < end[:, None])
        Epad = jnp.concatenate([Eout, jnp.zeros((B, 1), i32)], axis=1)
        new_ehE = jnp.where(band_e, Epad,
                            jnp.where(jcol == end[:, None], 0, st["ehE"]))

        h1 = _row_gather(Hshift, end)                      # H at j = end-1
        mrow = jnp.max(jnp.where(band_j, H, 0), axis=1)
        # mj: last band position attaining mrow (golden smem.py semantics);
        # when the row is all zeros, mj = end - 1
        att = band_j & (H == mrow[:, None])
        mj = jnp.max(jnp.where(att, jq, -1), axis=1)
        mj = jnp.where(mrow > 0, mj, end - 1)

        # collapsed-band rows still do the eh[end]/gscore bookkeeping
        # before m==0 breaks them (ksw.c:451-456 — the post-loop j is beg
        # when the inner loop never ran, end otherwise)
        j_after = jnp.where(degenerate, beg, end)
        h1_eff = jnp.where(degenerate, h1_init, h1)
        to_end = active0 & (j_after == qlen)
        upd_ie = to_end & (h1_eff >= st["gscore"])
        new_max_ie = jnp.where(upd_ie, i, st["max_ie"])
        new_gscore = jnp.where(to_end, jnp.maximum(st["gscore"], h1_eff),
                               st["gscore"])

        break_zero = mrow == 0
        improved = mrow > st["maxv"]
        new_maxv = jnp.where(improved, mrow, st["maxv"])
        new_max_i = jnp.where(improved, i, st["max_i"])
        new_max_j = jnp.where(improved, mj, st["max_j"])
        new_max_off = jnp.where(
            improved, jnp.maximum(st["max_off"], jnp.abs(mj - i)),
            st["max_off"])
        # z-drop (bwa/ksw.c:452-458), only when not improved
        di = i - st["max_i"]
        dj = mj - st["max_j"]
        zd = jnp.where(di > dj,
                       st["maxv"] - mrow - (di - dj) * e_del > zdrop,
                       st["maxv"] - mrow - (dj - di) * e_ins > zdrop)
        break_z = (~improved) & (zdrop > 0) & zd

        broke = break_zero | break_z
        # band shrink (bwa/ksw.c:460-466) on the post-write arrays,
        # only for lanes that did not break this row
        nz = (new_ehH != 0) | (new_ehE != 0)
        fwd_mask = nz & (jcol >= beg[:, None]) & (jcol < end[:, None])
        first_nz = jnp.min(jnp.where(fwd_mask, jcol, qmax + 2), axis=1)
        beg_s = jnp.minimum(first_nz, end)
        bwd_mask = nz & (jcol >= beg_s[:, None]) & (jcol <= end[:, None])
        last_nz = jnp.max(jnp.where(bwd_mask, jcol, beg_s[:, None] - 1),
                          axis=1)
        end_s = jnp.minimum(last_nz + 2, qlen.astype(i32))

        keep = active & ~broke
        deg2 = (active0 & degenerate)[:, None]
        at_end = jcol == end[:, None]
        out = dict(
            ehH=jnp.where(act2, new_ehH,
                          jnp.where(deg2 & at_end, h1_init[:, None],
                                    st["ehH"])),
            ehE=jnp.where(act2, new_ehE,
                          jnp.where(deg2 & at_end, 0, st["ehE"])),
            beg=jnp.where(keep, beg_s, beg),
            end=jnp.where(keep, end_s, end),
            maxv=jnp.where(active & ~break_zero, new_maxv, st["maxv"]),
            max_i=jnp.where(active & ~break_zero, new_max_i, st["max_i"]),
            max_j=jnp.where(active & ~break_zero, new_max_j, st["max_j"]),
            max_off=jnp.where(active & ~break_zero, new_max_off,
                              st["max_off"]),
            max_ie=jnp.where(active0, new_max_ie, st["max_ie"]),
            gscore=jnp.where(active0, new_gscore, st["gscore"]),
            done=st["done"] | (active0 & degenerate) | (active & broke),
        )
        return out

    st = jax.lax.fori_loop(0, tmax, row, init)
    # degenerate lanes (qlen==0 or tlen==0) run no rows and fall out with
    # (h0, 0, 0, 0, -1, 0), matching the golden degenerate path
    return (st["maxv"], st["max_j"] + 1, st["max_i"] + 1,
            st["max_ie"] + 1, st["gscore"], st["max_off"])


extend_batch = jax.jit(extend_core, static_argnums=(0, 1))


def extend_batch_np(query: np.ndarray, qlen: np.ndarray, target: np.ndarray,
                    tlen: np.ndarray, h0: np.ndarray, mat: np.ndarray,
                    o_del: int, e_del: int, o_ins: int, e_ins: int,
                    w: int, end_bonus: int, zdrop: int
                    ) -> tuple[np.ndarray, ...]:
    """NumPy-in/NumPy-out convenience wrapper (pads nothing; shapes must
    already be the padded [B, qmax]/[B, tmax] task buffers)."""
    qmax = query.shape[1]
    tmax = target.shape[1]
    args = [jnp.asarray(a, dtype=jnp.int32) for a in
            (query, qlen, target, tlen, h0, mat)]
    scal = [jnp.asarray(v, dtype=jnp.int32) for v in
            (o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop)]
    out = extend_batch(qmax, tmax, *args, *scal)
    return tuple(np.asarray(o) for o in out)
