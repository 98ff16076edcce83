"""FM-index container with a device-friendly memory layout.

The reference keeps the classic bwa occ-interleaved BWT (128-symbol blocks:
4x uint64 counts + 8x uint32 packed symbols, bwa/bwt.h:66-78) and uploads it
per FPGA device (src/fpga/BWAOCLEnv.h:128-216). Here the on-disk format stays
bwa-compatible (index/io.py) but the in-memory/device layout is redesigned
for vectorized gathers:

  fm_blocks: int32[n_blocks, 8] -- one 32-byte row per 64 symbols:
      [cnt_A, cnt_C, cnt_G, cnt_T, w0, w1, w2, w3]
  where cnt_* are absolute occurrence counts of the $-removed BWT before the
  block (per-symbol counts stay < 2^31 even for human), and w* pack 16
  symbols each, first symbol in the top 2 bits (same packing as bwa so disk
  round-trips are cheap).

One occ probe = one row gather + popcount-style counting of at most 4 words.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK = 64          # symbols per fm block row
SYM_PER_WORD = 16   # 2-bit symbols per uint32


@dataclasses.dataclass
class Annotation:
    name: str
    anno: str
    offset: int
    len: int
    n_ambs: int
    gi: int = 0
    is_alt: int = 0


@dataclasses.dataclass
class Amb:
    offset: int
    len: int
    amb: str


@dataclasses.dataclass
class ReferenceMeta:
    """bntseq_t equivalent: contig table + ambiguity holes + packed ref."""

    l_pac: int
    anns: list  # list[Annotation]
    ambs: list  # list[Amb]
    pac: np.ndarray  # uint8, forward strand packed 2-bit (ceil(l_pac/4)(+pad) bytes)
    seed: int = 11

    # ------------------------------------------------------------------
    # coordinate helpers (bwa/bntseq.c:349-446)
    # ------------------------------------------------------------------
    def depos(self, pos: int) -> tuple[int, bool]:
        is_rev = pos >= self.l_pac
        return ((self.l_pac << 1) - 1 - pos, True) if is_rev else (pos, False)

    def pos2rid(self, pos_f: int) -> int:
        if pos_f >= self.l_pac:
            return -1
        offs = self._offsets()
        return int(np.searchsorted(offs, pos_f, side="right")) - 1

    def _offsets(self) -> np.ndarray:
        if not hasattr(self, "_offs"):
            self._offs = np.array([a.offset for a in self.anns], dtype=np.int64)
        return self._offs

    def intv2rid(self, rb: int, re: int) -> int:
        if rb < self.l_pac < re:
            return -2
        pos_b, _ = self.depos(rb)
        rid_b = self.pos2rid(pos_b)
        if rb < re:
            pos_e, _ = self.depos(re - 1)
            rid_e = self.pos2rid(pos_e)
        else:
            rid_e = rid_b
        return rid_b if rid_b == rid_e else -1

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Reference bases in [beg, end) of the forward-reverse coordinate
        space; reverse strand positions return complemented bases
        (bwa/bntseq.c:398-419). Empty if the range bridges the boundary."""
        if end < beg:
            beg, end = end, beg
        end = min(end, self.l_pac << 1)
        beg = max(beg, 0)
        if beg >= self.l_pac or end <= self.l_pac:
            if beg >= self.l_pac:  # reverse strand
                beg_f = (self.l_pac << 1) - end
                end_f = (self.l_pac << 1) - beg
                fw = unpack_pac(self.pac, beg_f, end_f)
                return (3 - fw)[::-1].copy()
            return unpack_pac(self.pac, beg, end)
        return np.empty(0, dtype=np.uint8)

    def fetch_seq(self, beg: int, mid: int, end: int) -> tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq (bwa/bntseq.c:421-446): clip [beg,end) to the contig
        containing mid (on mid's strand) and return (seq, rid, beg, end)."""
        if end < beg:
            beg, end = end, beg
        assert beg <= mid < end
        pos_f, is_rev = self.depos(mid)
        rid = self.pos2rid(pos_f)
        far_beg = self.anns[rid].offset
        far_end = far_beg + self.anns[rid].len
        if is_rev:
            far_beg, far_end = ((self.l_pac << 1) - far_end,
                                (self.l_pac << 1) - far_beg)
        beg = max(beg, far_beg)
        end = min(end, far_end)
        seq = self.get_seq(beg, end)
        assert len(seq) == end - beg
        return seq, rid, beg, end


def pack_pac(seq: np.ndarray) -> np.ndarray:
    """Pack 2-bit bases into bytes, first base in the top 2 bits
    (bwa/bntseq.c:224 _set_pac)."""
    n = len(seq)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = seq
    q = padded.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2 | q[:, 3]).astype(np.uint8)


def unpack_pac(pac: np.ndarray, beg: int, end: int) -> np.ndarray:
    """Unpack forward-strand bases [beg, end) from a packed pac array."""
    if end <= beg:
        return np.empty(0, dtype=np.uint8)
    b0 = beg >> 2
    b1 = (end + 3) >> 2
    chunk = pac[b0:b1]
    expand = np.empty(len(chunk) * 4, dtype=np.uint8)
    expand[0::4] = chunk >> 6
    expand[1::4] = (chunk >> 4) & 3
    expand[2::4] = (chunk >> 2) & 3
    expand[3::4] = chunk & 3
    off = beg - (b0 << 2)
    return expand[off:off + (end - beg)]


def pack_words(bwt: np.ndarray) -> np.ndarray:
    """Pack a symbol array into uint32 words, 16 symbols/word, first symbol
    in the top 2 bits (matches bwa's bwt word packing)."""
    n = len(bwt)
    n_words = (n + SYM_PER_WORD - 1) // SYM_PER_WORD
    padded = np.zeros(n_words * SYM_PER_WORD, dtype=np.uint32)
    padded[:n] = bwt
    q = padded.reshape(-1, SYM_PER_WORD)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    return (q << shifts[None, :]).sum(axis=1, dtype=np.uint32)


@dataclasses.dataclass
class FMIndex:
    """Bidirectional FM-index over the forward+reverse-complement sequence.

    seq_len = 2 * l_pac; primary/L2 as in bwa_t (bwa/bwt.h:46-58).
    """

    seq_len: int
    primary: int
    L2: np.ndarray            # int64[5], cumulative symbol counts
    fm_blocks: np.ndarray     # int32[n_blocks, 8] (see module docstring)
    sa_intv: int
    sa: np.ndarray            # int64[n_sa]; sa[0] == -1 sentinel (bwa/bwt.c:83)
    bns: ReferenceMeta | None = None
    # artifact path prefix when loaded from disk (load_index) — lets
    # derived device caches (.tpu.sadense.npy) persist beside the index
    cache_prefix: str | None = None

    @classmethod
    def from_bwt(cls, bwt: np.ndarray, primary: int, sa_intv: int,
                 sa_samples: np.ndarray, bns: ReferenceMeta | None = None
                 ) -> "FMIndex":
        seq_len = len(bwt)
        counts = np.bincount(bwt, minlength=4)[:4]
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = np.cumsum(counts)
        n_blocks = (seq_len + BLOCK - 1) // BLOCK + 1  # +1: final checkpoint row
        blocks = np.zeros((n_blocks, 8), dtype=np.int64)
        # per-block cumulative counts (padding uses symbol 4 so it is never
        # counted; probes additionally mask partial words)
        pad = np.full(n_blocks * BLOCK, 4, dtype=np.uint8)
        pad[:seq_len] = bwt
        per_blk = pad.reshape(n_blocks, BLOCK)
        for c in range(4):
            cnt = (per_blk == c).sum(axis=1)
            cum = np.zeros(n_blocks, dtype=np.int64)
            cum[1:] = np.cumsum(cnt)[:-1]
            blocks[:, c] = cum
        words = pack_words(bwt)
        wpad = np.zeros(n_blocks * 4, dtype=np.uint32)
        wpad[:len(words)] = words
        blocks[:, 4:8] = wpad.reshape(n_blocks, 4).astype(np.int64)
        assert blocks[:, :4].max() < 2**31, "per-symbol count overflow"
        fm = blocks.astype(np.int32)  # counts < 2^31; words bit-cast to int32
        return cls(seq_len=seq_len, primary=primary, L2=L2, fm_blocks=fm,
                   sa_intv=sa_intv, sa=sa_samples, bns=bns)

    # number of sa samples
    @property
    def n_sa(self) -> int:
        return (self.seq_len + self.sa_intv) // self.sa_intv

    def bwt_symbols(self) -> np.ndarray:
        """$-removed BWT as a uint8 symbol array (unpacked from fm_blocks)."""
        words = self.fm_blocks[:, 4:8].astype(np.int64).astype(np.uint32).reshape(-1)
        shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
        sym = ((words[:, None] >> shifts[None, :]) & 3).astype(np.uint8).reshape(-1)
        return sym[: self.seq_len]
