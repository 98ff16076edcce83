"""Device coupled seed-extension tasks — the analog of the FPGA seed_proc.

One task = one seed of one chain: left extension (reversed query prefix vs
reversed reference window) then right extension seeded with the
left-extension score, each with bwa's 2-round band doubling
(mem_chain2aln, bwa/bwamem.c:716-779; FPGA seed_proc
/root/reference/src/fpga/kernel/smithwaterman.cpp:318-445). Unlike the FPGA
kernel (hardcoded scoring), this runs exact ksw_extend2 semantics via
ops/extend_jax.extend_core, four traced invocations fused in one jit:
left try0 -> masked left try1 (2w) -> right try0 -> masked right try1.

Outputs are the raw per-side 6-tuples plus the band width actually used;
the host applies the local/vs/to-end decision and absolute coordinates
(pipeline/batch.py), keeping bit-exact AlnReg construction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .extend_jax import extend_core

MAX_BAND_TRY = 2  # bwa/bwamem.c MAX_BAND_TRY

def _two_tries(qmax, tmax, q, ql, t, tl, h0, mat, o_del, e_del, o_ins,
               e_ins, w0, end_bonus, zdrop, prev0):
    """bwa band-doubling: try w, retry 2w when the score moved from its
    entry value (`prev0`: -1 for the left extension, the incoming score for
    the right) and max_off >= w/2+w/4 (bwamem.c:737-744).
    Returns the selected 6-tuple + aw."""
    r0 = extend_core(qmax, tmax, q, ql, t, tl, h0, mat, o_del, e_del,
                     o_ins, e_ins, w0, end_bonus, zdrop)
    aw0 = jnp.broadcast_to(w0, ql.shape)
    need = (r0[0] != prev0) & (r0[5] >= ((aw0 >> 1) + (aw0 >> 2)))
    aw1 = aw0 * 2
    r1 = extend_core(qmax, tmax, q, ql, t, tl, h0, mat, o_del, e_del,
                     o_ins, e_ins, aw1, end_bonus, zdrop)
    out = tuple(jnp.where(need, b, a) for a, b in zip(r0, r1))
    aw = jnp.where(need, aw1, aw0)
    return out, aw


def _coupled(qmax: int, tmax: int,
             ql_q, ql_n, tl_t, tl_n, qr_q, qr_n, tr_t, tr_n,
             h0, mat, o_del, e_del, o_ins, e_ins, w, pen_clip5,
             pen_clip3, zdrop) -> tuple[jnp.ndarray, ...]:
    """Traceable coupled left+right extension core (see seed_extend_batch)."""
    lres, aw0 = _two_tries(qmax, tmax, ql_q, ql_n, tl_t, tl_n, h0, mat,
                           o_del, e_del, o_ins, e_ins, w, pen_clip5, zdrop,
                           jnp.full_like(h0, -1))
    has_left = ql_n > 0
    # score entering the right extension: left score, or seed score
    lscore = jnp.where(has_left, lres[0], h0)
    aw0 = jnp.where(has_left, aw0, jnp.broadcast_to(w, aw0.shape))
    rres, aw1 = _two_tries(qmax, tmax, qr_q, qr_n, tr_t, tr_n, lscore, mat,
                           o_del, e_del, o_ins, e_ins, w, pen_clip3, zdrop,
                           lscore)
    has_right = qr_n > 0
    rscore = jnp.where(has_right, rres[0], lscore)
    aw1 = jnp.where(has_right, aw1, jnp.broadcast_to(w, aw1.shape))
    return (lscore, lres[1], lres[2], lres[3], lres[4], aw0,
            rscore, rres[1], rres[2], rres[3], rres[4], aw1)


@functools.partial(jax.jit, static_argnums=(0, 1))
def seed_extend_batch(qmax: int, tmax: int,
                      ql_q: jnp.ndarray, ql_n: jnp.ndarray,
                      tl_t: jnp.ndarray, tl_n: jnp.ndarray,
                      qr_q: jnp.ndarray, qr_n: jnp.ndarray,
                      tr_t: jnp.ndarray, tr_n: jnp.ndarray,
                      h0: jnp.ndarray, mat: jnp.ndarray,
                      o_del: jnp.ndarray, e_del: jnp.ndarray,
                      o_ins: jnp.ndarray, e_ins: jnp.ndarray,
                      w: jnp.ndarray, pen_clip5: jnp.ndarray,
                      pen_clip3: jnp.ndarray, zdrop: jnp.ndarray
                      ) -> tuple[jnp.ndarray, ...]:
    """Batched coupled seed extension from materialized arrays.

    ql_*/tl_*: reversed left query/target ([B, qmax]/[B, tmax] + lengths;
    length 0 = no left extension). qr_*/tr_*: right query/target.
    h0: seed_len * a. Returns
      (lscore, lqle, ltle, lgtle, lgscore, aw0,
       rscore, rqle, rtle, rgtle, rgscore, aw1)
    where lanes without a left extension report lscore = h0, aw0 = w (the
    host then applies bwamem.c:714-779 coordinate logic)."""
    return _coupled(qmax, tmax, ql_q, ql_n, tl_t, tl_n, qr_q, qr_n,
                    tr_t, tr_n, h0, mat, o_del, e_del, o_ins, e_ins, w,
                    pen_clip5, pen_clip3, zdrop)


def _pac_window_batch(dfm, start, step_down: bool, N: int) -> jnp.ndarray:
    """Decode N contiguous reference symbols per lane from the packed
    2-bit pac, by WORD gathers instead of per-symbol gathers: a tmax-wide
    window costs ~N/16+2 row gathers (~16x fewer), and the 2-bit unpack
    is pure vector work. start int64[T] is the first forward-reverse
    coordinate; step_down walks start-1-j (left windows), else start+j.

    Exploits bwa's invariant that an extension window never crosses the
    forward/reverse boundary (rmax clamped to rbeg's strand,
    bwa/bwamem.c:660-664), so one flip+complement covers the reverse
    strand. Out-of-range lanes read clipped words; callers mask by
    length."""
    T = start.shape[0]
    W = N // 16 + 2
    two_l = dfm.l_pac * 2
    pos0 = jnp.clip(start - 1 if step_down else start, 0, two_l - 1)
    is_rev = pos0 >= dfm.l_pac
    fstart = jnp.where(is_rev, two_l - 1 - pos0, pos0)
    # f-coordinate direction of the window walk
    down = is_rev ^ step_down
    lo = jnp.where(down, fstart - (N - 1), fstart)
    base = (lo >> 4).astype(jnp.int32)
    n_words = dfm.pac_words.shape[0]
    widx = jnp.clip(base[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :],
                    0, n_words - 1)
    words = jax.lax.bitcast_convert_type(
        dfm.pac_words[widx.reshape(-1)].reshape(T, W), jnp.uint32)
    # unpack 16 symbols/word: symbol s lives at bits 8*(s>>2)+6-2*(s&3)
    sh = np.fromiter((8 * (s >> 2) + 6 - 2 * (s & 3) for s in range(16)),
                     np.uint32, 16)
    syms = ((words[:, :, None] >> sh[None, None, :]) & 3).astype(
        jnp.int32).reshape(T, W * 16)
    # ascending-f window starts at lo&15: 16-way select of static slices
    off = (lo & 15).astype(jnp.int32)
    win = syms[:, 0:N]
    for p in range(1, 16):
        win = jnp.where(off[:, None] == p, syms[:, p:p + N], win)
    # down-walking lanes read fpos descending; complement reverse strand
    win = jnp.where(down[:, None], jnp.flip(win, axis=1), win)
    return jnp.where(is_rev[:, None], 3 - win, win)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def seed_extend_desc_batch(qmax: int, tmax: int, L_reads: int,
                           dfm, reads: jnp.ndarray, desc: jnp.ndarray,
                           mat: jnp.ndarray,
                           o_del, e_del, o_ins, e_ins, pen_clip5,
                           pen_clip3, zdrop) -> jnp.ndarray:
    """Coupled seed extension from task DESCRIPTORS: query and reference
    windows are assembled on device from the resident read batch and the
    packed reference (DeviceFM.pac_words) via flat 1-D gathers, so a wave
    transfers ~100 bytes/task instead of ~5 KB/task. This is the analog of
    the reference's one-time pac upload + per-task index packing
    (/root/reference/src/fpga/BWAOCLEnv.h:67-114, SWTask), improved: the
    windows never leave the device.

    reads: int32[B_reads, L_reads] (0..4, the seeding batch); desc is ONE
    int64[11, T] array (read_idx, qbeg, slen, l_query, rbeg, rmax0, rmax1,
    h0, wl, wr, skip_left rows — a single host->device transfer per wave).
    Each side runs ONE banded extension at its per-lane width; the rare
    bwa band-doubling retry (bwamem.c:737-744, triggered by max_off) is
    re-enqueued by the host driver into a later wave, so waves do half the
    device work of an unconditional two-try kernel. skip_left lanes are
    right-only retries: h0 carries the saved left score.
    Returns int32[12, T]: (lscore, lqle, ltle, lgtle, lgscore, lmax_off,
    rscore, rqle, rtle, rgtle, rgscore, rmax_off)."""
    from .fm_jax import pac_sym_batch

    T = desc.shape[1]
    i32 = jnp.int32
    read_idx = desc[0].astype(i32)
    qbeg = desc[1].astype(i32)
    slen = desc[2].astype(i32)
    l_query = desc[3].astype(i32)
    # genome coordinates compute in int64; the host narrows the whole
    # descriptor block to int32 when the genome fits (half the upload)
    rbeg = desc[4].astype(jnp.int64)
    rmax0 = desc[5].astype(jnp.int64)
    rmax1 = desc[6].astype(jnp.int64)
    h0 = desc[7].astype(i32)
    wl = desc[8].astype(i32)
    wr = desc[9].astype(i32)
    skip_left = desc[10] != 0
    jq = jnp.arange(qmax, dtype=i32)[None, :]
    jt = jnp.arange(tmax, dtype=i32)[None, :]
    reads_flat = reads.reshape(-1)

    def read_gather(pos):
        """reads[read_idx[t], pos[t, j]] via flat 1-D gather (reads
        upload as uint8; widen after the gather)."""
        idx = (read_idx[:, None] * L_reads
               + jnp.clip(pos, 0, L_reads - 1)).reshape(-1)
        return reads_flat[idx].reshape(T, -1).astype(i32)

    # left: query[qbeg-1-j], target pac[rbeg-1-j], lengths qbeg / rbeg-rmax0
    # Target spans are clamped to qlen_side + w + 1: the banded DP can
    # never reach target rows beyond qlen + w (the band collapses and
    # ksw_extend2 breaks with identical outputs, ops/ksw.py:146-151), so
    # the clamp is EXACT — and it lets chains spanning kb-scale repeat
    # elements (rmax windows far beyond tmax) still run on the device
    # instead of spilling to the host scalar kernel.
    ql_n = jnp.where(skip_left, 0, qbeg)
    ql_q = read_gather(qbeg[:, None] - 1 - jq)
    ql_q = jnp.where(jq < ql_n[:, None], ql_q, 0)
    tl_n = jnp.where(skip_left, 0,
                     jnp.minimum((rbeg - rmax0).astype(i32),
                                 jnp.minimum(qbeg + wl + 1, tmax)))
    tl_t = _pac_window_batch(dfm, rbeg, True, tmax)
    tl_t = jnp.where(jt < tl_n[:, None], tl_t, 0)
    # right: query[qe+j], target pac[rbeg+slen+j]
    qe = qbeg + slen
    qr_n = jnp.maximum(l_query - qe, 0)
    qr_q = read_gather(qe[:, None] + jq)
    qr_q = jnp.where(jq < qr_n[:, None], qr_q, 0)
    re_abs = rbeg + slen.astype(jnp.int64)
    tr_n = jnp.minimum(jnp.clip(rmax1 - re_abs, 0, tmax).astype(i32),
                       qr_n + wr + 1)
    tr_t = _pac_window_batch(dfm, re_abs, False, tmax)
    tr_t = jnp.where(jt < tr_n[:, None], tr_t, 0)

    lres = extend_core(qmax, tmax, ql_q, ql_n, tl_t, tl_n, h0, mat,
                       o_del, e_del, o_ins, e_ins, wl, pen_clip5, zdrop)
    has_left = ql_n > 0
    lscore = jnp.where(has_left, lres[0], h0)
    rres = extend_core(qmax, tmax, qr_q, qr_n, tr_t, tr_n, lscore, mat,
                       o_del, e_del, o_ins, e_ins, wr, pen_clip3, zdrop)
    has_right = qr_n > 0
    rscore = jnp.where(has_right, rres[0], lscore)
    out = (lscore, lres[1], lres[2], lres[3], lres[4], lres[5],
           rscore, rres[1], rres[2], rres[3], rres[4], rres[5])
    return jnp.stack([o.astype(i32) for o in out])


def narrow_desc(desc: np.ndarray) -> np.ndarray:
    """Halve a descriptor block's upload bytes when every value (in
    particular the genome coordinates in rows 4-6) fits int32 — true for
    any genome under 1 Gbp (seq_len = 2*l_pac < 2^31). The device kernel
    widens the coordinate rows back to int64."""
    if desc.dtype == np.int64 and int(desc.max(initial=0)) < 2**31 \
            and int(desc.min(initial=0)) > -(2**31):
        return desc.astype(np.int32)
    return desc


class DescTaskBuffer:
    """Descriptor-only task buffer: ~100 bytes/task crosses the host-device
    boundary; windows assemble on device (seed_extend_desc_batch)."""

    def __init__(self, cap: int, qmax: int, tmax: int):
        self.cap, self.qmax, self.tmax = cap, qmax, tmax
        self.desc = np.zeros((11, cap), np.int64)
        self.desc[7] = 1   # h0 must stay positive for padding lanes
        self.desc[8] = 1   # band widths positive for padding lanes
        self.desc[9] = 1
        self.n = 0

    def reset(self):
        self.n = 0
        self.desc[:] = 0
        self.desc[7] = 1
        self.desc[8] = 1
        self.desc[9] = 1

    def add(self, task, read_idx: int, wl: int, wr: int,
            skip_left: bool = False, h0: int | None = None) -> int:
        """Returns the slot, or -1 when the task exceeds device shapes or
        its read is not device-resident (host fallback). wl/wr are the
        per-side band widths for this try (the host driver re-enqueues
        band-doubling retries); skip_left + h0 enqueue a right-only retry
        seeded with the saved left score."""
        d = task
        # spans clamped to qlen_side + w + 1 (exact; see the kernel note)
        qr_side = d.l_query - (d.qbeg + d.slen)
        if (read_idx < 0 or self.n >= self.cap
                or d.qbeg > self.qmax
                or qr_side > self.qmax
                or min(d.rbeg - d.rmax0, d.qbeg + wl + 1) > self.tmax
                or min(d.rmax1 - (d.rbeg + d.slen),
                       qr_side + wr + 1) > self.tmax):
            return -1
        i = self.n
        self.desc[:, i] = (read_idx, d.qbeg, d.slen, d.l_query, d.rbeg,
                           d.rmax0, d.rmax1,
                           d.h0 if h0 is None else h0, wl, wr,
                           1 if skip_left else 0)
        self.n += 1
        return i

    def _params(self, opt):
        """Device-cached scoring constants (uploaded once, not per wave:
        each host->device transfer is a separate copy to enqueue)."""
        if getattr(self, "_params_cache", None) is None:
            import jax.numpy as jnp
            i32 = lambda v: jnp.asarray(v, jnp.int32)
            self._params_cache = (
                jnp.asarray(opt.mat[:5, :5], dtype=jnp.int32),
                i32(opt.o_del), i32(opt.e_del), i32(opt.o_ins),
                i32(opt.e_ins), i32(opt.pen_clip5),
                i32(opt.pen_clip3), i32(opt.zdrop))
        return self._params_cache

    def run(self, opt, dfm, reads_dev, L_reads: int) -> np.ndarray:
        """Returns int32[12, n_slots]: one transfer each way per wave."""
        return np.asarray(self.run_async(opt, dfm, reads_dev, L_reads))

    def run_async(self, opt, dfm, reads_dev, L_reads: int):
        """Dispatch the wave and start its device->host fetch; returns the
        jax array (np.asarray it later). The driver keeps two waves in
        flight (the reference's SWTask ping-pong, src/fpga/SWTask.cpp
        :106-244), so one wave's result copy overlaps the other's compute
        and it never blocks on a transfer it just started."""
        out = seed_extend_desc_batch(
            self.qmax, self.tmax, L_reads, dfm, reads_dev,
            jnp.asarray(narrow_desc(self.desc)), *self._params(opt))
        try:
            out.copy_to_host_async()
        except AttributeError:
            pass
        return out


class SeedExtendTaskBuffer:
    """Fixed-shape host-side packing buffer for seed-extension tasks
    (the SWTask analog, /root/reference/src/fpga/SWTask.cpp)."""

    def __init__(self, cap: int, qmax: int, tmax: int):
        self.cap, self.qmax, self.tmax = cap, qmax, tmax
        self.ql_q = np.zeros((cap, qmax), np.int32)
        self.ql_n = np.zeros(cap, np.int32)
        self.tl_t = np.zeros((cap, tmax), np.int32)
        self.tl_n = np.zeros(cap, np.int32)
        self.qr_q = np.zeros((cap, qmax), np.int32)
        self.qr_n = np.zeros(cap, np.int32)
        self.tr_t = np.zeros((cap, tmax), np.int32)
        self.tr_n = np.zeros(cap, np.int32)
        self.h0 = np.ones(cap, np.int32)
        self.n = 0

    def reset(self):
        self.n = 0
        self.ql_n[:] = 0
        self.tl_n[:] = 0
        self.qr_n[:] = 0
        self.tr_n[:] = 0
        self.h0[:] = 1

    def add(self, q_left: np.ndarray, t_left: np.ndarray,
            q_right: np.ndarray, t_right: np.ndarray, h0: int) -> int:
        """Sequences already direction-ordered (left ones reversed).
        Returns the task slot, or -1 if any piece exceeds the buffer shape
        (caller falls back to host, packReadData-style)."""
        if (len(q_left) > self.qmax or len(q_right) > self.qmax
                or len(t_left) > self.tmax or len(t_right) > self.tmax
                or self.n >= self.cap):
            return -1
        i = self.n
        self.ql_q[i, :len(q_left)] = q_left
        self.ql_n[i] = len(q_left)
        self.tl_t[i, :len(t_left)] = t_left
        self.tl_n[i] = len(t_left)
        self.qr_q[i, :len(q_right)] = q_right
        self.qr_n[i] = len(q_right)
        self.tr_t[i, :len(t_right)] = t_right
        self.tr_n[i] = len(t_right)
        self.h0[i] = h0
        self.n += 1
        return i

    def run(self, opt) -> tuple[np.ndarray, ...]:
        out = seed_extend_batch(
            self.qmax, self.tmax,
            jnp.asarray(self.ql_q), jnp.asarray(self.ql_n),
            jnp.asarray(self.tl_t), jnp.asarray(self.tl_n),
            jnp.asarray(self.qr_q), jnp.asarray(self.qr_n),
            jnp.asarray(self.tr_t), jnp.asarray(self.tr_n),
            jnp.asarray(self.h0),
            jnp.asarray(opt.mat[:5, :5], dtype=jnp.int32),
            jnp.asarray(opt.o_del, jnp.int32), jnp.asarray(opt.e_del, jnp.int32),
            jnp.asarray(opt.o_ins, jnp.int32), jnp.asarray(opt.e_ins, jnp.int32),
            jnp.asarray(opt.w, jnp.int32), jnp.asarray(opt.pen_clip5, jnp.int32),
            jnp.asarray(opt.pen_clip3, jnp.int32), jnp.asarray(opt.zdrop, jnp.int32))
        return tuple(np.asarray(o) for o in out)
