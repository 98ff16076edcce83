"""Device (JAX/XLA) FM-index primitives — batched occ / extend / SA lookup.

Device formulation of the reference's FM machinery (bwa/bwt.c:107-287):
the index lives in HBM as the block layout of index/fmindex.py (one 32-byte
int32 row per 64 symbols: 4 counts + 4 packed words), and every primitive is
vectorized over a batch of probes:

  - one occ probe  = one row gather + popcount of xor-matched 2-bit slots
    (4 uint32 words, vector popcount — no per-symbol loop)
  - bwt_extend     = two all-symbol probes (k-1, k-1+s) + the bidirectional
    chain (bwa/bwt.c:262-275)
  - sa lookup      = batched LF-walk to a sampled row with a fixed iteration
    budget and an overflow mask (bwa/bwt.c:86-96); callers redo overflows on
    host, mirroring the reference's FPGA redo-on-overflow pattern
    (src/fpga/FPGAPipeline.cpp:706-714).

Row coordinates need 33 bits for human (seq_len = 2*l_pac ~ 6.2e9) so the
batch state is int64; block indices (k>>6 < 2^31) and occ counts
(per-symbol < 2^31) stay int32 where it matters for gather throughput.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import BLOCK, FMIndex


class DeviceFM(NamedTuple):
    """Device-resident FM-index (a pytree of jnp arrays).

    Mirrors FMIndex (index/fmindex.py) but jit-traceable. `seq_len`,
    `primary` are 0-d int64; `L2` is int64[5]; `fm_blocks` int32[n_blocks,8];
    `sa` int64[n_sa]; `sa_intv` 0-d int32 (power of two). `pac_words`
    packs the forward-strand 2-bit reference 16 symbols per int32 (byte
    order preserved: byte b of word w = pac[4w+b]) — the per-device
    reference upload of the reference design
    (/root/reference/src/fpga/BWAOCLEnv.h:67-114), used for on-device
    extension-window assembly. `l_pac` is 0-d int64.
    """

    seq_len: jnp.ndarray
    primary: jnp.ndarray
    L2: jnp.ndarray
    fm_blocks: jnp.ndarray
    sa_intv: jnp.ndarray
    sa: jnp.ndarray
    pac_words: jnp.ndarray
    l_pac: jnp.ndarray
    # densified SA (int32[seq_len], bucketed) for sub-2^31 genomes: SA
    # lookup becomes ONE gather instead of a ~sa_intv-step batched LF
    # walk. None for large genomes (pytree structure differs, so jitted
    # programs specialize on which variant they serve).
    sa_dense: jnp.ndarray | None = None

    @classmethod
    def from_host(cls, fm: FMIndex, dense_sa_max: int | None = None
                  ) -> "DeviceFM":
        if fm.bns is not None:
            pac = fm.bns.pac
            n_words = (len(pac) + 3) // 4
            padded = np.zeros(n_words * 4, dtype=np.uint8)
            padded[:len(pac)] = pac
            pw = padded.reshape(-1, 4).astype(np.uint32)
            pac_words = (pw[:, 0] | (pw[:, 1] << 8) | (pw[:, 2] << 16)
                         | (pw[:, 3] << 24)).astype(np.int64).astype(
                             np.uint32)
            l_pac = fm.bns.l_pac
        else:
            pac_words = np.zeros(1, dtype=np.uint32)
            l_pac = 0

        def bucket(arr, fill=0):
            """Pad the leading dim to a power-of-two bucket: kernel shapes
            then depend only on the bucket, so different genomes reuse
            compiled programs (a fresh genome otherwise recompiles
            every program). Above 2^27 rows, pad to a multiple of 2^20
            instead: Gbp-scale genomes never share shapes anyway, and
            power-of-two padding would waste ~2.6 GB of the human
            index's ~10 GB of device memory."""
            n = arr.shape[0]
            if n > (1 << 27):
                cap = -(-n // (1 << 20)) * (1 << 20)
            else:
                cap = 1024
                while cap < n:
                    cap <<= 1
            if cap == n:
                return arr
            out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[:n] = arr
            return out

        dfm = cls(
            seq_len=jnp.asarray(fm.seq_len, dtype=jnp.int64),
            primary=jnp.asarray(fm.primary, dtype=jnp.int64),
            L2=jnp.asarray(fm.L2, dtype=jnp.int64),
            fm_blocks=jnp.asarray(bucket(np.asarray(fm.fm_blocks)),
                                  dtype=jnp.int32),
            sa_intv=jnp.asarray(fm.sa_intv, dtype=jnp.int32),
            # SA values < seq_len: int32 halves the (Gbp-scale ~0.5 GB)
            # upload and the walk's final gather for sub-2^31 genomes
            sa=jnp.asarray(bucket(np.asarray(fm.sa)),
                           dtype=jnp.int32 if 0 < fm.seq_len < 2**31
                           else jnp.int64),
            pac_words=jnp.asarray(bucket(pac_words).view(np.int32)),
            l_pac=jnp.asarray(l_pac, dtype=jnp.int64),
        )
        import os
        if dense_sa_max is None:
            # 2^28 rows (~1 GB of int32 SA) is a size carried over from
            # a 16 GB part; to be re-tuned for an 80 GB card
            dense_sa_max = int(os.environ.get("BWA_TPU_DENSE_SA_MAX",
                                              1 << 28))
        if 0 < fm.seq_len <= min(dense_sa_max, (1 << 31) - 1):
            dense = _densify_sa(dfm, fm)
            dfm = dfm._replace(sa_dense=jnp.asarray(bucket(dense)))
        return dfm


def pac_sym_batch(dfm: DeviceFM, pos: jnp.ndarray) -> jnp.ndarray:
    """Reference base at forward-reverse coordinate pos (int64[...]) ->
    int32[...] in [0, 3]. Positions >= l_pac read the reverse-complement
    strand (bwa/bntseq.c get_seq semantics); out-of-range positions are
    clamped (callers mask)."""
    two_l = dfm.l_pac * 2
    posc = jnp.clip(pos, 0, two_l - 1)
    is_rev = posc >= dfm.l_pac
    fpos = jnp.where(is_rev, two_l - 1 - posc, posc)
    word = dfm.pac_words[(fpos >> 4).astype(jnp.int32)]
    uw = jax.lax.bitcast_convert_type(word, jnp.uint32)
    byte = (uw >> (8 * ((fpos >> 2) & 3)).astype(jnp.uint32)) & 0xFF
    sym = ((byte >> (6 - 2 * (fpos & 3)).astype(jnp.uint32)) & 3
           ).astype(jnp.int32)
    return jnp.where(is_rev, 3 - sym, sym)


_PAIR_MASK = np.uint32(0x55555555)


def _count_slots(words: jnp.ndarray, c: jnp.ndarray, within: jnp.ndarray
                 ) -> jnp.ndarray:
    """#matches of 2-bit symbol c among the first `within` symbols of a
    [..., 4]-word uint32 slab (16 symbols/word, first symbol in top bits).

    words: uint32[..., 4]; c: int32[...] in [0,3]; within: int32[...] in
    [0,64]. Returns int32[...].
    """
    pat = (c.astype(jnp.uint32) * _PAIR_MASK)[..., None]
    x = ~(words ^ pat)
    hits = x & (x >> 1) & _PAIR_MASK  # one bit per matching symbol slot
    # symbols t=0..15 sit at bit pair (15-t)*2: the first n symbols of a
    # word are its top 2n bits
    n_w = jnp.clip(within[..., None] - jnp.arange(4, dtype=jnp.int32) * 16,
                   0, 16)
    shift = jnp.minimum(2 * (16 - n_w), 31).astype(jnp.uint32)  # clamp: n_w=0
    keep = jnp.where(n_w == 0, jnp.uint32(0),
                     ~((jnp.uint32(1) << shift) - 1))
    masked = hits & keep
    return jax.lax.population_count(masked).sum(-1).astype(jnp.int32)


def _row_words(dfm: DeviceFM, blk: jnp.ndarray
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather fm block rows: returns (counts int32[...,4], words uint32[...,4])."""
    rows = dfm.fm_blocks[blk]  # [..., 8]
    counts = rows[..., :4]
    words = jax.lax.bitcast_convert_type(rows[..., 4:8], jnp.uint32)
    return counts, words


def _narrow_view(dfm: DeviceFM) -> DeviceFM:
    """An int32-coordinate view of a sub-2^31 index: the FM scalars the
    occ/extend chain touches (seq_len, primary, L2) become int32, so every
    derived coordinate/count op runs in int32 instead of int64 (half
    the bytes and ops on the hot probe chain). Callers
    must guard fm.seq_len < 2^31. jit traces specialize on the leaf
    dtypes, so narrow and wide programs coexist."""
    return dfm._replace(
        seq_len=dfm.seq_len.astype(jnp.int32),
        primary=dfm.primary.astype(jnp.int32),
        L2=dfm.L2.astype(jnp.int32),
        l_pac=dfm.l_pac.astype(jnp.int32))


def occ_batch(dfm: DeviceFM, k: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """occ(k, c) for row coords k in [-1, seq_len] (bwa/bwt.c:107-129).

    k: int64[...] (or int32 under a _narrow_view); c: int32[...].
    Returns the coordinate dtype[...]."""
    dt = k.dtype
    at_end = k == dfm.seq_len
    at_neg = k == -1
    kk = k - (k >= dfm.primary).astype(k.dtype)
    kk = jnp.clip(kk, 0, dfm.seq_len - 1)
    blk = (kk // BLOCK).astype(jnp.int32)
    within = (kk % BLOCK).astype(jnp.int32) + 1
    counts, words = _row_words(dfm, blk)
    # unrolled 4-way selects instead of a batched take_along_axis
    base = counts[..., 0]
    l2c = jnp.full_like(c.astype(dt), dfm.L2[0])
    l2c1 = jnp.full_like(c.astype(dt), dfm.L2[1])
    for cc in range(1, 4):
        base = jnp.where(c == cc, counts[..., cc], base)
        l2c = jnp.where(c == cc, dfm.L2[cc], l2c)
        l2c1 = jnp.where(c == cc, dfm.L2[cc + 1], l2c1)
    val = base.astype(dt) + _count_slots(words, c, within)
    end_val = l2c1 - l2c
    return jnp.where(at_neg, 0, jnp.where(at_end, end_val, val))


def occ4_batch(dfm: DeviceFM, k: jnp.ndarray) -> jnp.ndarray:
    """All-symbol occ at row coords k (bwa/bwt.c:169-186).

    k: int64[...] (or int32 under a _narrow_view). Returns dtype[..., 4]."""
    dt = k.dtype
    at_end = (k == dfm.seq_len)[..., None]
    at_neg = (k == -1)[..., None]
    kk = k - (k >= dfm.primary).astype(k.dtype)
    kk = jnp.clip(kk, 0, dfm.seq_len - 1)
    blk = (kk // BLOCK).astype(jnp.int32)
    within = (kk % BLOCK).astype(jnp.int32) + 1
    counts, words = _row_words(dfm, blk)
    c4 = jnp.arange(4, dtype=jnp.int32)
    cnt = _count_slots(words[..., None, :], jnp.broadcast_to(c4, kk.shape + (4,)),
                       within[..., None])
    val = counts.astype(dt) + cnt
    end_val = (dfm.L2[1:5] - dfm.L2[0:4]).astype(dt)
    return jnp.where(at_neg, 0, jnp.where(at_end, end_val, val))


def bwt_extend_batch(dfm: DeviceFM, ik: jnp.ndarray, is_back: bool
                     ) -> jnp.ndarray:
    """Bidirectional extension for a batch of intervals (bwa/bwt.c:262-275).

    ik: int64[..., 3] = (k, l, s); is_back is static. Returns
    ok: int64[..., 4, 3]: ok[c] = the interval after adding base c."""
    fwd = 0 if is_back else 1
    bwd = 1 - fwd
    x_f = ik[..., fwd]
    s = ik[..., 2]
    both = jnp.stack([x_f - 1, x_f - 1 + s], axis=-1)  # [..., 2]
    occ2 = occ4_batch(dfm, both)                        # [..., 2, 4]
    tk = occ2[..., 0, :]
    tl = occ2[..., 1, :]
    ok_fwd = dfm.L2[:4] + 1 + tk                        # [..., 4]
    ok_s = tl - tk
    crosses = ((x_f <= dfm.primary) & (x_f + s - 1 >= dfm.primary)
               ).astype(ik.dtype)
    b3 = ik[..., bwd] + crosses
    b2 = b3 + ok_s[..., 3]
    b1 = b2 + ok_s[..., 2]
    b0 = b1 + ok_s[..., 1]
    ok_bwd = jnp.stack([b0, b1, b2, b3], axis=-1)
    out = jnp.empty(ik.shape[:-1] + (4, 3), dtype=ik.dtype)
    out = out.at[..., fwd].set(ok_fwd)
    out = out.at[..., bwd].set(ok_bwd)
    out = out.at[..., 2].set(ok_s)
    return out


def set_intv_batch(dfm: DeviceFM, c: jnp.ndarray) -> jnp.ndarray:
    """Initial single-base intervals (bwa/bwt.h:80). c: int32[...] in [0,3].
    Returns [..., 3] in the index's coordinate dtype (dfm.L2's dtype)."""
    z = jnp.zeros_like(c, dtype=dfm.L2.dtype)
    l2c, l2c1, l2r = z + dfm.L2[0], z + dfm.L2[1], z + dfm.L2[3]
    for cc in range(1, 4):
        sel = c == cc
        l2c = jnp.where(sel, dfm.L2[cc], l2c)
        l2c1 = jnp.where(sel, dfm.L2[cc + 1], l2c1)
        l2r = jnp.where(sel, dfm.L2[3 - cc], l2r)
    return jnp.stack([l2c + 1, l2r + 1, l2c1 - l2c], axis=-1)


def bwt_b0_batch(dfm: DeviceFM, k: jnp.ndarray) -> jnp.ndarray:
    """Symbol at $-removed BWT position k (bwa/bwt.h:78). int64[...] -> int32."""
    blk = (k // BLOCK).astype(jnp.int32)
    off = (k % BLOCK).astype(jnp.int32)
    rows = dfm.fm_blocks[blk]
    words = jax.lax.bitcast_convert_type(rows[..., 4:8], jnp.uint32)
    wsel = off >> 4
    word = words[..., 0]
    for ww in range(1, 4):
        word = jnp.where(wsel == ww, words[..., ww], word)
    shift = ((15 - (off & 15)) << 1).astype(jnp.uint32)
    return ((word >> shift) & 3).astype(jnp.int32)


def _inv_psi_batch(dfm: DeviceFM, k: jnp.ndarray) -> jnp.ndarray:
    """LF-mapping step (bwa/bwt.c:53-59). int64[...] -> int64[...].

    Fused single-gather formulation: for k != primary the symbol position
    x = k - (k > primary) equals the occ row kk = k - (k >= primary), so
    ONE fm_blocks row gather yields both the BWT symbol c and occ(k, c)
    (the row's counts + a popcount over its first off+1 slots). The naive
    bwt_b0_batch + occ_batch pair costs two gathers per walk step, and
    gathered rows are the LF walk's main cost. k == seq_len also fuses:
    counting the
    whole final row equals the L2 end total. k == primary is overridden
    to 0 as in bwa; k == -1 never occurs in SA walks."""
    kk = k - (k >= dfm.primary).astype(k.dtype)
    kk = jnp.clip(kk, 0, dfm.seq_len - 1)
    blk = (kk // BLOCK).astype(jnp.int32)
    off = (kk % BLOCK).astype(jnp.int32)
    counts, words = _row_words(dfm, blk)
    # symbol at slot `off` of this row
    wsel = off >> 4
    word = words[..., 0]
    for ww in range(1, 4):
        word = jnp.where(wsel == ww, words[..., ww], word)
    shift = ((15 - (off & 15)) << 1).astype(jnp.uint32)
    c = ((word >> shift) & 3).astype(jnp.int32)
    # occ(k, c) = counts[c] + #c among the first off+1 slots; L2[c]
    base = counts[..., 0]
    l2 = jnp.full_like(k, dfm.L2[0])
    for cc in range(1, 4):
        base = jnp.where(c == cc, counts[..., cc], base)
        l2 = jnp.where(c == cc, dfm.L2[cc], l2)
    cnt = _count_slots(words, c, off + 1)
    lf = l2 + base.astype(k.dtype) + cnt
    return jnp.where(k == dfm.primary, 0, lf)


@functools.partial(jax.jit, static_argnums=(2, 3))
def sa_batch_packed(dfm: DeviceFM, k: jnp.ndarray, max_iters: int = 256,
                    intv: int = 0) -> jnp.ndarray:
    """sa_batch with both outputs stacked into one int64[2, B] array —
    a single device->host transfer per call."""
    sa, ovf = sa_batch(dfm, k, max_iters, intv)
    return jnp.stack([sa, ovf.astype(jnp.int64)])


def _lf_walk_fixed(dfm: DeviceFM, mask, kk, steps, T: int):
    """T fixed LF steps over every lane (dead lanes hold). Lanes are
    processed in 64k-lane CHUNKS via lax.scan with an all-dead skip:
    callers hand over pools whose LIVE lanes are front-packed (the
    fused enumeration is), so capacity beyond the live prefix costs one
    predicate per chunk instead of T probe rows per lane."""
    B = kk.shape[0]
    CS = 65536
    if B <= CS or B % CS != 0:
        def body(i, st):
            kk, steps = st
            live = (kk & mask) != 0
            kk2 = _inv_psi_batch(dfm, kk)
            kk = jnp.where(live, kk2, kk)
            return kk, steps + live.astype(steps.dtype)

        return jax.lax.fori_loop(0, T, body, (kk, steps))

    def chunk(carry, x):
        kc, sc = x

        def walk(args):
            kc, sc = args

            def body(i, st):
                kk, steps = st
                live = (kk & mask) != 0
                kk2 = _inv_psi_batch(dfm, kk)
                return (jnp.where(live, kk2, kk),
                        steps + live.astype(steps.dtype))

            return jax.lax.fori_loop(0, T, body, (kc, sc))

        kc, sc = jax.lax.cond(jnp.any((kc & mask) != 0), walk,
                              lambda a: a, (kc, sc))
        return carry, (kc, sc)

    NCH = B // CS
    _, (kk, steps) = jax.lax.scan(
        chunk, jnp.zeros((), jnp.int32),
        (kk.reshape(NCH, CS), steps.reshape(NCH, CS)))
    return kk.reshape(B), steps.reshape(B)


@functools.partial(jax.jit, static_argnums=(2, 3))
def sa_batch(dfm: DeviceFM, k: jnp.ndarray, max_iters: int = 256,
             intv: int = 0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Suffix-array values via batched LF-walk (bwa/bwt.c:86-96).

    k: int64[B] (or int32 under a narrow view). Walk lengths are
    geometric with mean sa_intv, so a single while-loop-to-max runs
    ~sa_intv*ln(B) iterations over EVERY lane (at 3.1 Gbp that walk
    dominated the batch). With `intv` passed
    statically (the resampled on-disk interval), the walk is PHASED:
    2*intv fixed steps over all lanes (covers ~e^-2 = 86%), survivors
    compact into a B/4 pool for 4*intv more (cumulative ~e^-6), then a
    B/16 pool runs a while loop to max_iters. Probe volume tracks the
    geometric tail instead of its max. Returns (sa int64[B], overflow
    bool[B]); overflow lanes (budget blown or pool overflow — both
    astronomically rare at the default budgets) redo on host."""
    if dfm.sa_dense is not None:
        idx = jnp.clip(k, 0, dfm.sa_dense.shape[0] - 1).astype(jnp.int32)
        return (dfm.sa_dense[idx].astype(jnp.int64),
                jnp.zeros(k.shape, bool))
    mask = (dfm.sa_intv - 1).astype(k.dtype)
    steps0 = jnp.zeros_like(k)
    B = k.shape[0]
    kk, steps = k, steps0
    if intv > 0 and B >= 64:
        kk, steps = _lf_walk_fixed(dfm, mask, kk, steps, 2 * intv)

        def compact_pool(kk, steps, CAP):
            live = (kk & mask) != 0
            l32 = live.astype(jnp.int32)
            rank = jnp.cumsum(l32) - l32
            dropped = live & (rank >= CAP)
            src = jnp.zeros(CAP, jnp.int32).at[
                jnp.where(live & ~dropped, rank, CAP)].set(
                jnp.arange(B, dtype=jnp.int32), mode="drop")
            return src

        # survivors (~e^-2) -> B/4 pool, 4*intv fixed steps
        src = compact_pool(kk, steps, B // 4)
        kp, sp = _lf_walk_fixed(dfm, mask, kk[src], steps[src], 4 * intv)
        kk = kk.at[src].set(kp, mode="drop")
        steps = steps.at[src].set(sp, mode="drop")
        # stragglers (~e^-6) -> B/16 pool, while loop to the budget
        src = compact_pool(kk, steps, B // 16)

        def cond(st):
            kp, sp, it = st
            return (it < max_iters) & jnp.any(kp & mask != 0)

        def body(st):
            kp, sp, it = st
            live = (kp & mask) != 0
            k2 = _inv_psi_batch(dfm, kp)
            return (jnp.where(live, k2, kp),
                    sp + live.astype(sp.dtype), it + 1)

        kp, sp, _ = jax.lax.while_loop(
            cond, body, (kk[src], steps[src], 0))
        kk = kk.at[src].set(kp, mode="drop")
        steps = steps.at[src].set(sp, mode="drop")
        # pool-dropped lanes never finish: flagged as overflow below
        overflow = (kk & mask) != 0
    else:
        def cond(state):
            kk, steps, it = state
            return (it < max_iters) & jnp.any(kk & mask != 0)

        def body(state):
            kk, steps, it = state
            live = (kk & mask) != 0
            kk2 = _inv_psi_batch(dfm, kk)
            kk = jnp.where(live, kk2, kk)
            steps = steps + live.astype(steps.dtype)
            return kk, steps, it + 1

        kk, steps, _ = jax.lax.while_loop(cond, body, (kk, steps0, 0))
        overflow = (kk & mask) != 0
    idx = kk // dfm.sa_intv.astype(k.dtype)
    idx = jnp.clip(idx, 0, dfm.sa.shape[0] - 1)
    return (steps + dfm.sa[idx]).astype(jnp.int64), overflow


def _densify_sa(dfm: DeviceFM, fm: FMIndex) -> np.ndarray:
    """Full int32 SA for a sub-2^31 genome, computed once at index-upload
    time by running the batched LF walk over every row in fixed-shape
    chunks (the device does in seconds what turns SA resolution from a
    ~sa_intv-step walk per probe into a single gather).

    Cached on disk beside the index artifacts (<prefix>.tpu.sadense.npy
    when load_index recorded a prefix): densification is a whole-genome
    LF walk that every fresh process would otherwise repeat at index
    load. Stragglers past the iteration budget re-walk in ONE deep
    device call (the per-row host fallback did millions of tiny
    memmapped reads)."""
    import os
    prefix = getattr(fm, "cache_prefix", None)
    cachef = f"{prefix}.tpu.sadense.npy" if prefix else None
    if cachef and os.path.exists(cachef):
        try:
            dense = np.load(cachef, mmap_mode="r")
            if dense.shape[0] == int(fm.seq_len) + 1:
                return dense
        except (OSError, ValueError):
            pass
    from . import fm as fmops
    # FM interval rows span [0, seq_len] INCLUSIVE (seq_len+1 values:
    # bwt_sa accepts k == seq_len), so densify one row past seq_len
    n = int(fm.seq_len) + 1
    CH = 1 << 20
    out = np.empty(n, np.int32)
    for off in range(0, n, CH):
        m = min(CH, n - off)
        pad = np.zeros(CH, dtype=np.int64)
        pad[:m] = np.arange(off, off + m, dtype=np.int64)
        packed = np.asarray(sa_batch_packed(dfm, jnp.asarray(pad), 1024,
                                             int(fm.sa_intv)))
        vals = packed[0, :m].astype(np.int32)
        ovf = np.nonzero(packed[1, :m] != 0)[0]
        if len(ovf) > 256:
            # one deep device redo for the straggler tail
            W = 1024
            while W < len(ovf):
                W <<= 1
            pad2 = np.zeros(W, dtype=np.int64)
            pad2[:len(ovf)] = off + ovf
            p2 = np.asarray(sa_batch_packed(dfm, jnp.asarray(pad2),
                                            16384, 0))
            vals[ovf] = p2[0, :len(ovf)].astype(np.int32)
            ovf = ovf[p2[1, :len(ovf)] != 0]
        for j in ovf:
            vals[j] = fmops.bwt_sa(fm, off + int(j))
        out[off:off + m] = vals
    if cachef:
        try:
            np.save(cachef, out)
        except OSError:
            pass
    return out
