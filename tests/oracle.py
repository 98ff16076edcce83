"""Real-bwa oracle support for acceptance tests.

The reference's test strategy diffs against the genuine algorithm: its
golden model *is* the vendored C code (test/src/TestCommon.h:51-136) and
its acceptance suite diffs pipeline outputs (test/test.bats:49-55). This
module builds the vendored bwa (/root/reference/bwa) into a scratch
binary and exposes helpers so tests can assert byte-identical SAM against
the real implementation rather than against this repo's own golden model.

The build lands in .cache/oracle (gitignored); reference sources are
copied only into that scratch dir, never committed.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_BWA_SRC = pathlib.Path("/root/reference/bwa")
ORACLE_DIR = REPO / ".cache" / "oracle"
ORACLE_BIN = ORACLE_DIR / "bwa"

_STUB_SAM_H = (
    "#ifndef STUB_HTSLIB_SAM_H\n"
    "#define STUB_HTSLIB_SAM_H\n"
    "typedef struct bam1_t bam1_t;\n"
    "#endif\n"
)


def build_oracle() -> pathlib.Path | None:
    """Build the vendored bwa into .cache/oracle/bwa; None if impossible.

    The vendored tree's only htslib dependency is the ``bam1_t**`` member
    patched into bseq1_t (bwa/bwa.h:33-46); a forward-declaration stub
    satisfies it. -fcommon is needed for the pre-C17 tentative definition
    of rle_auxtab (bwa/rle.h).
    """
    if ORACLE_BIN.exists():
        return ORACLE_BIN
    if not REF_BWA_SRC.is_dir() or shutil.which("gcc") is None:
        return None
    src = ORACLE_DIR / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(REF_BWA_SRC, src)
    stub = src / "stub" / "htslib"
    stub.mkdir(parents=True)
    (stub / "sam.h").write_text(_STUB_SAM_H)
    r = subprocess.run(
        ["make", "-j8",
         "CFLAGS=-g -Wall -Wno-unused-function -O2 -fcommon",
         f"INCLUDES=-I{src / 'stub'}"],
        cwd=src, capture_output=True, text=True)
    if r.returncode != 0 or not (src / "bwa").exists():
        return None
    shutil.copy2(src / "bwa", ORACLE_BIN)
    return ORACLE_BIN


SAMBLASTER_BIN = ORACLE_DIR / "samblaster_oracle"


def build_samblaster() -> pathlib.Path | None:
    """Build the vendored samblaster library plus a thin stdin/stdout
    driver (tests/samblaster_driver.cpp) into .cache/oracle — the
    markdup counterpart of build_oracle() (round-4 verdict task 8)."""
    if SAMBLASTER_BIN.exists():
        return SAMBLASTER_BIN
    ref = pathlib.Path("/root/reference/src")
    if not (ref / "samblaster.cpp").exists() or shutil.which("g++") is None:
        return None
    d = ORACLE_DIR / "samblaster"
    d.mkdir(parents=True, exist_ok=True)
    for f in ("samblaster.cpp", "samblaster.h", "sbhash.cpp", "sbhash.h"):
        shutil.copy2(ref / f, d / f)
    # sbhash.h includes boost headers it never uses (all boost code is
    # commented out); strip them so the oracle builds without boost
    sb = (d / "sbhash.h").read_text()
    sb = "\n".join(ln for ln in sb.splitlines()
                   if not (ln.startswith("#include <boost/")
                           or ln.startswith("#include <glog/")))
    (d / "sbhash.h").write_text(sb)
    drv = REPO / "tests" / "samblaster_driver.cpp"
    r = subprocess.run(
        ["g++", "-O2", "-w", "-o", str(SAMBLASTER_BIN), str(drv),
         str(d / "samblaster.cpp"), str(d / "sbhash.cpp"), f"-I{d}"],
        capture_output=True, text=True)
    if r.returncode != 0 or not SAMBLASTER_BIN.exists():
        import sys
        print(r.stderr[-2000:], file=sys.stderr)
        return None
    return SAMBLASTER_BIN


def oracle_index(ref_fa: str | pathlib.Path) -> None:
    """Run the real `bwa index` on a FASTA (artifacts land beside it)."""
    bwa = build_oracle()
    assert bwa is not None, "oracle bwa unavailable"
    subprocess.run([str(bwa), "index", str(ref_fa)], check=True,
                   capture_output=True)


def oracle_mem(ref_fa, fastqs, opts: list[str] | None = None) -> list[str]:
    """Run the real `bwa mem`; returns SAM lines (no trailing newlines)."""
    bwa = build_oracle()
    assert bwa is not None, "oracle bwa unavailable"
    cmd = [str(bwa), "mem"] + (opts or []) + [str(ref_fa)] + \
        [str(f) for f in fastqs]
    r = subprocess.run(cmd, check=True, capture_output=True, text=True)
    return r.stdout.splitlines()


def cli_env(**extra) -> dict:
    """Environment for a CLI subprocess: the checkout on PYTHONPATH, the
    CPU backend, and the caller's PATH and HOME."""
    env = {"PYTHONPATH": str(REPO),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(REPO)),
           "JAX_PLATFORMS": "cpu"}
    env.update(extra)
    return env


def strip_pg(lines: list[str]) -> list[str]:
    """Drop @PG headers (program name/CL necessarily differ)."""
    return [l for l in lines if not l.startswith("@PG")]


def sam_diff(ours: list[str], oracle: list[str], limit: int = 10) -> str:
    """Human-readable first-differences report ('' when identical)."""
    a, b = strip_pg(ours), strip_pg(oracle)
    msgs = []
    for i in range(max(len(a), len(b))):
        la = a[i] if i < len(a) else "<missing>"
        lb = b[i] if i < len(b) else "<missing>"
        if la != lb:
            msgs.append(f"line {i}:\n  ours:   {la}\n  oracle: {lb}")
            if len(msgs) >= limit:
                break
    return "\n".join(msgs)


# ---------------------------------------------------------------- fixtures

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}


def make_ref(rng, contigs_spec, repeat_frac=0.0) -> list[tuple[str, bytes]]:
    """Random contigs: [(name, length)]; optional self-repeat insertion
    and N runs to exercise max_occ / ambiguity paths."""
    out = []
    for name, length in contigs_spec:
        seq = _BASES[rng.integers(0, 4, length)].copy()
        if repeat_frac > 0 and length > 600:
            # plant tandem copies of a segment to create multi-occurrence
            # seeds (chain-filter / max_occ territory)
            seg_len = max(80, int(length * repeat_frac / 4))
            src = int(rng.integers(0, length - seg_len))
            seg = seq[src:src + seg_len].copy()
            for _ in range(3):
                dst = int(rng.integers(0, length - seg_len))
                seq[dst:dst + seg_len] = seg
        if length > 400:
            start = int(rng.integers(50, length - 60))
            seq[start:start + int(rng.integers(3, 12))] = ord("N")
        out.append((name, seq.tobytes()))
    return out


def write_fasta(path, contigs, width=70) -> None:
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            s = seq.decode()
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")


def _revcomp(s: bytes) -> bytes:
    return bytes(_COMP.get(c, 78) for c in reversed(s))


def _mutate(rng, s: bytes, sub_p, indel_p) -> bytes:
    out = bytearray()
    i = 0
    while i < len(s):
        r = rng.random()
        if r < indel_p and len(out) > 5:
            if rng.random() < 0.5:      # deletion
                i += 1 + int(rng.integers(0, 3))
                continue
            for _ in range(1 + int(rng.integers(0, 3))):  # insertion
                out.append(int(_BASES[rng.integers(0, 4)]))
        c = s[i]
        if rng.random() < sub_p:
            c = int(_BASES[rng.integers(0, 4)])
        out.append(c)
        i += 1
    return bytes(out)


def sample_se(rng, contigs, n_reads, read_len=101, sub_p=0.01,
              indel_p=0.002) -> list[tuple[str, bytes, bytes]]:
    """(name, seq, qual) tuples sampled from the genome, both strands."""
    reads = []
    flat = [(name, seq) for name, seq in contigs]
    for k in range(n_reads):
        name, seq = flat[int(rng.integers(0, len(flat)))]
        if len(seq) <= read_len + 2:
            continue
        pos = int(rng.integers(0, len(seq) - read_len))
        frag = seq[pos:pos + read_len]
        if rng.random() < 0.5:
            frag = _revcomp(frag)
        frag = _mutate(rng, frag, sub_p, indel_p)[:read_len]
        if len(frag) < read_len:
            frag = frag + _BASES[rng.integers(0, 4, read_len - len(frag))]\
                .tobytes()
        qual = bytes(33 + int(q) for q in rng.integers(20, 40, len(frag)))
        reads.append((f"r{k:05d}", frag, qual))
    return reads


def sample_pe(rng, contigs, n_pairs, read_len=101, isize_mean=300,
              isize_std=40, sub_p=0.01, indel_p=0.002):
    """FR pairs: list of ((n, s, q), (n, s, q))."""
    pairs = []
    flat = [(name, seq) for name, seq in contigs]
    for k in range(n_pairs):
        name, seq = flat[int(rng.integers(0, len(flat)))]
        isize = max(read_len + 10,
                    int(rng.normal(isize_mean, isize_std)))
        if len(seq) <= isize + 2:
            continue
        pos = int(rng.integers(0, len(seq) - isize))
        frag = seq[pos:pos + isize]
        r1 = frag[:read_len]
        r2 = _revcomp(frag[-read_len:])
        if rng.random() < 0.5:
            r1, r2 = r2, r1  # swap which mate is forward
        def fin(s):
            s = _mutate(rng, s, sub_p, indel_p)[:read_len]
            if len(s) < read_len:
                s = s + _BASES[rng.integers(0, 4, read_len - len(s))]\
                    .tobytes()
            q = bytes(33 + int(x) for x in rng.integers(20, 40, len(s)))
            return s, q
        s1, q1 = fin(r1)
        s2, q2 = fin(r2)
        qname = f"p{k:05d}"
        pairs.append(((qname, s1, q1), (qname, s2, q2)))
    return pairs


def write_fastq(path, reads) -> None:
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq.decode()}\n+\n{qual.decode()}\n")


# ------------------------------------------------- real-ksw ctypes oracle

_KSW_LIB = ORACLE_DIR / "libksw.so"


def build_ksw_lib():
    """Compile the vendored ksw.c into a shared lib; returns a ctypes
    handle to the genuine ksw_extend2 (bwa/ksw.c:380-479) or None."""
    import ctypes
    if not _KSW_LIB.exists():
        if build_oracle() is None:   # ensures sources are in .cache/oracle
            return None
        src = ORACLE_DIR / "src"
        r = subprocess.run(
            ["gcc", "-O2", "-fPIC", "-shared", "-fcommon",
             str(src / "ksw.c"), "-o", str(_KSW_LIB)],
            capture_output=True, text=True)
        if r.returncode != 0:
            return None
    lib = ctypes.CDLL(str(_KSW_LIB))
    c_i, c_p = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.ksw_extend2.restype = c_i
    lib.ksw_extend2.argtypes = [
        c_i, u8p, c_i, u8p, c_i, i8p, c_i, c_i, c_i, c_i, c_i, c_i, c_i,
        c_i, c_p, c_p, c_p, c_p, c_p]
    return lib


def real_ksw_extend2(lib, query, target, mat, o_del, e_del, o_ins, e_ins,
                     w, end_bonus, zdrop, h0):
    """Call the genuine ksw_extend2; returns
    (score, qle, tle, gtle, gscore, max_off)."""
    import ctypes
    q = np.ascontiguousarray(query, dtype=np.uint8)
    t = np.ascontiguousarray(target, dtype=np.uint8)
    m8 = np.ascontiguousarray(mat, dtype=np.int8).reshape(-1)
    outs = [ctypes.c_int(0) for _ in range(5)]
    sc = lib.ksw_extend2(
        len(q), q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(t), t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        5, m8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0,
        *[ctypes.byref(o) for o in outs])
    return (sc,) + tuple(o.value for o in outs)
