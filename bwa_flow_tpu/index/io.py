"""bwa-compatible index file IO (.bwt/.sa/.pac/.ann/.amb[/.alt]).

Formats follow bwa 0.7.x exactly (bwa/bwt.c:385-462, bwa/bntseq.c:66-206,
bwa/bwtindex.c:131-173) so indexes interoperate in both directions: stock
``bwa index`` output loads here, and indexes built by this package load in
the reference binaries.
"""

from __future__ import annotations

import os

import numpy as np

from .fmindex import Amb, Annotation, FMIndex, ReferenceMeta

OCC_INTERVAL = 128  # bwa/bwt.h:36

# genomes at or below this seq_len get a fully dense device SA instead
# (ops/fm_jax._densify_sa); only larger ones re-sample (tests lower it)
RESAMPLE_MIN = 1 << 28


_BYTE_LUT = np.empty((256, 4), dtype=np.uint8)
for _b in range(256):
    _BYTE_LUT[_b] = ((_b >> 6) & 3, (_b >> 4) & 3, (_b >> 2) & 3, _b & 3)


def _bwt_to_u8(seq_len: int, words: np.ndarray) -> np.ndarray:
    """Expand 16-symbols-per-uint32 packing into a uint8 symbol array.

    Byte-LUT expansion (first symbol sits in the top bits, i.e. the
    most significant byte of the little-endian word) — the broadcasted
    shift formulation takes minutes at Gbp scale."""
    by = words.view(np.uint8).reshape(-1, 4)[:, ::-1]
    sym = _BYTE_LUT[by].reshape(-1)
    return sym[:seq_len]


def write_bwt(path: str, fm_bwt_u8: np.ndarray, primary: int, L2: np.ndarray) -> None:
    """Dump .bwt with the classic 128-symbol occ interleave."""
    seq_len = len(fm_bwt_u8)
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    pad = np.zeros(n_blocks * OCC_INTERVAL, dtype=np.uint8)
    pad[:seq_len] = fm_bwt_u8
    per_blk = pad.reshape(n_blocks, OCC_INTERVAL)
    # cumulative counts before each block; padding symbols (0) beyond seq_len
    # are excluded by counting on the unpadded array
    cum = np.zeros((n_blocks + 1, 4), dtype=np.uint64)
    for c in range(4):
        cnt = (per_blk == c).sum(axis=1).astype(np.uint64)
        if seq_len % OCC_INTERVAL:
            tail = fm_bwt_u8[n_blocks * OCC_INTERVAL - OCC_INTERVAL:]
            cnt[-1] = np.uint64((tail == c).sum())
        cum[1:, c] = np.cumsum(cnt)
    # pack words, 16 symbols per uint32, first symbol in top bits
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    words_all = (per_blk.reshape(-1, 16).astype(np.uint32) << shifts[None, :]) \
        .sum(axis=1, dtype=np.uint32)
    n_words = (seq_len + 15) // 16
    # each block: its 4 uint64 counts, then its 8 words (the last block
    # only the words that hold symbols); built whole and written once
    body = np.empty((n_blocks, 16), dtype=np.uint32)
    body[:, :8] = cum[:n_blocks].view(np.uint32).reshape(n_blocks, 8)
    body[:, 8:] = words_all.reshape(n_blocks, 8)
    body = body.reshape(-1)[:16 * n_blocks - (8 * n_blocks - n_words)]
    with open(path, "wb") as f:
        np.uint64(primary).tofile(f)
        L2[1:5].astype(np.uint64).tofile(f)
        body.tofile(f)
        cum[n_blocks].tofile(f)


def read_bwt(path: str) -> tuple[np.ndarray, int, np.ndarray]:
    """Returns ($-removed bwt symbols uint8, primary, L2[5])."""
    raw = np.fromfile(path, dtype=np.uint8)
    primary = int(raw[:8].view(np.uint64)[0])
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = raw[8:40].view(np.uint64).astype(np.int64)
    seq_len = int(L2[4])
    body = raw[40:].view(np.uint32)
    n_words = (seq_len + 15) // 16
    words = np.empty(n_words, dtype=np.uint32)
    # every block is 8 count-u32s + 8 data words except a possibly
    # partial final block — one reshape covers the regular prefix
    # (a per-block Python loop takes minutes at Gbp scale)
    n_full = n_words // 8
    if n_full:
        words[:n_full * 8] = \
            body[:n_full * 16].reshape(n_full, 16)[:, 8:16].ravel()
    tail = n_words - n_full * 8
    if tail:
        off = n_full * 16 + 8
        words[n_full * 8:] = body[off:off + tail]
    return _bwt_to_u8(seq_len, words), primary, L2


def write_sa(path: str, fm: FMIndex) -> None:
    with open(path, "wb") as f:
        np.uint64(fm.primary).tofile(f)
        fm.L2[1:5].astype(np.uint64).tofile(f)
        np.uint64(fm.sa_intv).tofile(f)
        np.uint64(fm.seq_len).tofile(f)
        fm.sa[1:].astype(np.uint64).tofile(f)


def read_sa(path: str, seq_len: int, primary: int) -> tuple[int, np.ndarray]:
    raw = np.fromfile(path, dtype=np.uint64)
    assert int(raw[0]) == primary, "SA-BWT inconsistency: primary mismatch"
    sa_intv = int(raw[5])
    assert int(raw[6]) == seq_len, "SA-BWT inconsistency: seq_len mismatch"
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.empty(n_sa, dtype=np.int64)
    sa[0] = -1
    sa[1:] = raw[7:7 + n_sa - 1].astype(np.int64)
    return sa_intv, sa


def write_pac(path: str, bns: ReferenceMeta) -> None:
    with open(path, "wb") as f:
        n_bytes = (bns.l_pac >> 2) + (0 if bns.l_pac % 4 == 0 else 1)
        bns.pac[:n_bytes].tofile(f)
        if bns.l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([bns.l_pac % 4]))


def read_pac(path: str, l_pac: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    n_bytes = (l_pac + 3) // 4
    return raw[:n_bytes].copy()


def write_ann_amb(prefix: str, bns: ReferenceMeta) -> None:
    with open(prefix + ".ann", "w") as f:
        f.write(f"{bns.l_pac} {len(bns.anns)} {bns.seed}\n")
        for a in bns.anns:
            anno = a.anno if a.anno else "(null)"
            f.write(f"{a.gi} {a.name} {anno}\n")
            f.write(f"{a.offset} {a.len} {a.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{bns.l_pac} {len(bns.anns)} {len(bns.ambs)}\n")
        for h in bns.ambs:
            f.write(f"{h.offset} {h.len} {h.amb}\n")


def read_ann_amb(prefix: str) -> ReferenceMeta:
    anns: list[Annotation] = []
    with open(prefix + ".ann") as f:
        first = f.readline().split()
        l_pac, n_seqs, seed = int(first[0]), int(first[1]), int(first[2])
        for _ in range(n_seqs):
            hdr = f.readline().rstrip("\n").split(" ", 2)
            gi, name = int(hdr[0]), hdr[1]
            anno = hdr[2] if len(hdr) > 2 else ""
            if anno == "(null)":
                anno = ""
            meta = f.readline().split()
            anns.append(Annotation(name=name, anno=anno, offset=int(meta[0]),
                                   len=int(meta[1]), n_ambs=int(meta[2]), gi=gi))
    ambs: list[Amb] = []
    with open(prefix + ".amb") as f:
        first = f.readline().split()
        assert int(first[0]) == l_pac and int(first[1]) == n_seqs, \
            "inconsistent .ann and .amb files"
        for _ in range(int(first[2])):
            parts = f.readline().split()
            ambs.append(Amb(offset=int(parts[0]), len=int(parts[1]), amb=parts[2]))
    # NB: .alt marking is load_index's job (it honors ignore_alt / -j)
    pac = read_pac(prefix + ".pac", l_pac)
    bns = ReferenceMeta(l_pac=l_pac, anns=anns, ambs=ambs, pac=pac, seed=seed)
    return bns


def save_index(prefix: str, fm: FMIndex) -> None:
    """Write the full bwa-compatible artifact set for ``fm``."""
    write_bwt(prefix + ".bwt", fm.bwt_symbols(), fm.primary, fm.L2)
    write_sa(prefix + ".sa", fm)
    assert fm.bns is not None
    write_pac(prefix + ".pac", fm.bns)
    write_ann_amb(prefix, fm.bns)


def load_index(prefix: str, ignore_alt: bool = False) -> FMIndex:
    """Load stock ``bwa index`` output into an FMIndex.

    A ``<prefix>.alt`` file (bwa-postalt convention: SAM-ish lines whose
    QNAME column names ALT contigs) marks those contigs is_alt, exactly as
    bwa_idx_load_bns does; ``ignore_alt`` mirrors bwa mem -j.

    The device block layout is cached beside the artifacts as
    ``<prefix>.tpu.npz`` on first load (Gbp-scale conversion otherwise
    costs minutes); delete the file or set BWA_TPU_NO_INDEX_CACHE to
    rebuild."""
    cache = prefix + ".tpu.npz"
    blocks_f = prefix + ".tpu.blocks.npy"
    sa_f = prefix + ".tpu.sa.npy"
    meta_f = prefix + ".tpu.meta.npz"
    use_cache = not os.environ.get("BWA_TPU_NO_INDEX_CACHE")
    bwt_mtime = os.path.getmtime(prefix + ".bwt")

    def _fresh(p):
        return os.path.exists(p) and os.path.getmtime(p) >= bwt_mtime

    def _write_v2(fm):
        try:
            np.save(blocks_f, fm.fm_blocks)
            np.save(sa_f, fm.sa)
            np.savez(meta_f, seq_len=fm.seq_len, primary=fm.primary,
                     L2=fm.L2, sa_intv=fm.sa_intv)
        except OSError:
            pass  # read-only index dir: skip the cache

    if use_cache and _fresh(blocks_f) and _fresh(sa_f) and _fresh(meta_f):
        # v2 cache: fm_blocks/sa as raw .npy memmaps — the multi-GB
        # arrays stream straight from the page cache into the device
        # upload instead of being copied out of a zip container (human
        # 3.1 Gbp: host load 84 s -> ~0)
        d = np.load(meta_f)
        bns = read_ann_amb(prefix)
        fm = FMIndex(seq_len=int(d["seq_len"]), primary=int(d["primary"]),
                     L2=d["L2"],
                     fm_blocks=np.load(blocks_f, mmap_mode="r"),
                     sa_intv=int(d["sa_intv"]),
                     sa=np.load(sa_f, mmap_mode="r"), bns=bns)
        fm.cache_prefix = prefix
        _apply_alt(prefix, bns, ignore_alt)
        _resample_sa(fm, prefix, use_cache)
        return fm
    if use_cache and _fresh(cache):
        d = np.load(cache)
        bns = read_ann_amb(prefix)
        fm = FMIndex(seq_len=int(d["seq_len"]), primary=int(d["primary"]),
                     L2=d["L2"], fm_blocks=d["fm_blocks"],
                     sa_intv=int(d["sa_intv"]), sa=d["sa"], bns=bns)
        _write_v2(fm)   # migrate to the mmap layout for the next load
        fm.cache_prefix = prefix
        _apply_alt(prefix, bns, ignore_alt)
        _resample_sa(fm, prefix, use_cache)
        return fm
    bwt_u8, primary, L2 = read_bwt(prefix + ".bwt")
    seq_len = int(L2[4])
    sa_intv, sa = read_sa(prefix + ".sa", seq_len, primary)
    bns = read_ann_amb(prefix)
    _apply_alt(prefix, bns, ignore_alt)
    fm = FMIndex.from_bwt(bwt_u8, primary, sa_intv, sa, bns=bns)
    fm.cache_prefix = prefix
    assert fm.seq_len == seq_len and (fm.L2 == L2).all()
    if use_cache:
        _write_v2(fm)
    _resample_sa(fm, prefix, use_cache)
    return fm


def _resample_sa(fm: FMIndex, prefix: str | None, use_cache: bool) -> None:
    """Densify the sampled SA of a large genome in place (native
    LF-orbit enumeration, native/_native.cpp sa_resample).

    bwa ships sa_intv=32, so every SA lookup walks ~16 LF steps; at Gbp
    scale those walks dominate device seeding (each step is one HBM row
    gather, the measured unit of cost). Sub-2^28 genomes already get a
    fully dense device SA (ops/fm_jax._densify_sa); here the target
    interval is the smallest of 4/8/16 whose table fits
    BWA_TPU_SA_BYTES (default ~3.5 GB — 1 Gbp lands on intv 4 as int32,
    human scale on intv 16 as int64; a budget carried over from a 16 GB
    part, to be re-tuned for an 80 GB card). Set BWA_TPU_SA_BYTES=0 to
    disable.
    The result is cached beside the artifacts as <prefix>.tpu.sa<N>.npy.
    The denser table serves both the device walk and host fallbacks;
    stock-format .sa round-trips are unaffected (save_index writes
    whatever interval fm carries, and the format admits any power of 2).
    """
    budget = int(os.environ.get("BWA_TPU_SA_BYTES", 7 << 29))
    if budget <= 0 or fm.seq_len <= RESAMPLE_MIN:
        return
    try:
        from .. import _native
    except ImportError:
        return
    if not hasattr(_native, "sa_resample"):
        return
    itemsize = 4 if fm.seq_len < 2**31 else 8
    for intv in (4, 8, 16):
        if intv >= fm.sa_intv:
            return
        if (fm.seq_len // intv + 1) * itemsize <= budget:
            break
    else:
        return
    cachef = f"{prefix}.tpu.sa{intv}.npy" if prefix else None
    if (cachef and use_cache and os.path.exists(cachef)
            and os.path.getmtime(cachef) >= os.path.getmtime(
                prefix + ".bwt")):
        # mmap: int64 tables stay memmapped end-to-end; int32 tables
        # widen lazily at DeviceFM construction
        fm.sa = np.load(cachef, mmap_mode="r")
        fm.sa_intv = intv
        return
    import time
    t0 = time.time()
    raw = _native.sa_resample(
        np.ascontiguousarray(fm.fm_blocks),
        np.ascontiguousarray(fm.L2, np.int64), int(fm.primary),
        int(fm.seq_len), np.ascontiguousarray(fm.sa, np.int64),
        int(fm.sa_intv), intv, os.cpu_count() or 4)
    sa_new = np.frombuffer(raw, np.int64)
    import sys
    print(f"[M::index] resampled SA {fm.sa_intv} -> {intv} "
          f"({time.time()-t0:.1f}s)", file=sys.stderr)
    if cachef and use_cache:
        try:
            np.save(cachef, sa_new.astype(np.int32) if itemsize == 4
                    else sa_new)
        except OSError:
            pass
    fm.sa = sa_new.astype(np.int64, copy=False)
    fm.sa_intv = intv


def _apply_alt(prefix: str, bns: ReferenceMeta, ignore_alt: bool) -> None:
    alt_path = prefix + ".alt"
    if ignore_alt or not os.path.exists(alt_path):
        return
    alt_names = set()
    with open(alt_path) as f:
        for line in f:
            if line.startswith("@") or not line.strip():
                continue
            alt_names.add(line.split("\t", 1)[0].split()[0])
    for ann in bns.anns:
        if ann.name in alt_names:
            ann.is_alt = 1
