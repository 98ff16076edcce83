"""BAM/BGZF encoding and bucket-sort merge (BamFileBuffer + BucketSort +
sort-merge pipeline analogs)."""

import gzip
import struct

import numpy as np
import pytest

import oracle as orc

from bwa_flow_tpu.io.bam import (BGZF_EOF, BamWriter, bgzf_compress,
                                 bgzf_decompress, decode_bam_records,
                                 sam_line_to_bam)
from bwa_flow_tpu.pipeline.sort import (BucketSort, merge_sorted_bam,
                                        sort_key_from_raw)


class _Ann:
    def __init__(self, name, length):
        self.name = name
        self.len = length


ANNS = [_Ann("chr1", 5000), _Ann("chr2", 3000)]


def test_bgzf_roundtrip_and_gzip_compat():
    data = bytes(range(256)) * 1000
    comp = bgzf_compress(data) + BGZF_EOF
    assert bgzf_decompress(comp) == data
    # BGZF must remain a valid multi-member gzip stream
    assert gzip.decompress(comp) == data


def test_sam_line_roundtrip():
    line = ("r1\t99\tchr1\t100\t60\t5S96M\t=\t400\t401\t" + "A" * 101
            + "\t" + "I" * 101 + "\tNM:i:2\tMD:Z:96\tAS:i:91\tRG:Z:rg1")
    raw = sam_line_to_bam(line, {"chr1": 0, "chr2": 1})
    hdr = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
    text, refs, recs = decode_bam_records(hdr + raw)
    r = recs[0]
    assert r["qname"] == "r1" and r["flag"] == 99 and r["tid"] == 0
    assert r["pos"] == 99 and r["mtid"] == 0 and r["mpos"] == 399
    assert r["tlen"] == 401 and r["l_seq"] == 101


def test_bucket_sort_merge(tmp_path):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(200):
        tid = int(rng.integers(0, 2))
        pos = int(rng.integers(1, ANNS[tid].len - 100))
        flag = int(rng.choice([0, 16]))
        lines.append(f"q{i}\t{flag}\tchr{tid+1}\t{pos}\t60\t50M\t*\t0\t0\t"
                     + "A" * 50 + "\t" + "I" * 50)
    # a couple of unmapped reads must land in the tail bucket
    lines.append("u1\t4\t*\t0\t0\t*\t*\t0\t0\tAAAA\tIIII")
    bs = BucketSort(ANNS, str(tmp_path / "tmp"), num_buckets=8)
    for l in lines:
        bs.write_sam_text(l + "\n")
    paths = bs.close()
    assert len(paths) == 9
    assert (tmp_path / "tmp" / "bucket-000003.bed").exists()
    out = tmp_path / "out.bam"
    merge_sorted_bam(paths, str(out), ANNS, "@HD\tVN:1.6\tSO:coordinate\n")
    data = gzip.decompress(out.read_bytes())
    text, refs, recs = decode_bam_records(data)
    assert refs == [("chr1", 5000), ("chr2", 3000)]
    assert len(recs) == 201
    keys = [sort_key_from_raw(r["raw"]) for r in recs]
    assert keys == sorted(keys)
    assert recs[-1]["tid"] == -1  # unmapped last
    assert "SO:coordinate" in text


def test_bucket_bed_intervals(tmp_path):
    bs = BucketSort(ANNS, str(tmp_path / "t2"), num_buckets=4)
    bs.close()
    # total 8000 bases over 4 buckets -> 2000 each; bucket 2 spans the
    # chr1/chr2 boundary (4000-6000 = chr1:4000-5000 + chr2:0-1000)
    bed = (tmp_path / "t2" / "bucket-000002.bed").read_text()
    assert bed == "chr1\t4000\t5000\nchr2\t0\t1000\n"


def test_cli_sorted_bam(tmp_path):
    """CLI --sort writes a samtools-grade sorted BAM with markdup flags."""
    import subprocess
    import sys
    rng = np.random.default_rng(0xB0)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 6000)].tobytes()
    (tmp_path / "ref.fa").write_text(
        ">c1\n" + "\n".join(g.decode()[i:i + 70]
                            for i in range(0, 6000, 70)) + "\n")
    with open(tmp_path / "se.fq", "w") as f:
        for i in range(6):
            p = 500 * i
            f.write(f"@s{i}\n{g[p:p+101].decode()}\n+\n{'I'*101}\n")
        # duplicate of s0
        f.write(f"@dup0\n{g[0:101].decode()}\n+\n{'I'*101}\n")
    env = orc.cli_env()
    for cmd in (["index", "ref.fa"],
                ["mem", "--no-device", "--sort", "-o", "out.bam",
                 "--temp-dir", "td", "ref.fa", "se.fq"]):
        r = subprocess.run([sys.executable, "-m", "bwa_flow_tpu"] + cmd,
                           capture_output=True, text=True,
                           cwd=str(tmp_path), env=env, timeout=400)
        assert r.returncode == 0, r.stderr[-1500:]
    data = gzip.decompress((tmp_path / "out.bam").read_bytes())
    text, refs, recs = decode_bam_records(data)
    assert len(recs) == 7
    keys = [sort_key_from_raw(r["raw"]) for r in recs]
    assert keys == sorted(keys)
    dups = [r for r in recs if r["flag"] & 0x400]
    assert len(dups) == 1 and dups[0]["qname"] == "dup0"


def test_native_bam_parity():
    """native/_bam.cpp must be byte-identical to the Python golden
    encoder (sam_line_to_bam) and BGZF writer on a varied fixture."""
    _bam = pytest.importorskip("bwa_flow_tpu._bam")
    rng = np.random.default_rng(7)
    names = {"chr1": 0, "chr2": 1}
    lines = []
    for i in range(200):
        l = int(rng.integers(20, 150))
        seq = "".join("ACGTNacgtn"[j] for j in rng.integers(0, 10, l))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, l))
        if i % 17 == 0:
            lines.append(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*")
            continue
        chrom = "chr1" if i % 3 else "chr2"
        pos = int(rng.integers(1, 2000))
        s = int(rng.integers(0, 5))
        cig = (f"{s}S" if s else "") + f"{l - s}M"
        flag = int(rng.choice([0, 16, 99, 147, 83, 1024, 256]))
        tags = "\tNM:i:3\tAS:i:77\tXA:Z:chr2,-5,10M,1;\tZb:B:s,-4,9"
        lines.append(f"r{i}\t{flag}\t{chrom}\t{pos}\t37\t{cig}\t=\t"
                     f"{pos + 7}\t{l}\t{seq}\t{qual}{tags}")
    sam = "@HD\tVN:1.6\n" + "\n".join(lines) + "\n"
    py = b"".join(sam_line_to_bam(l, names) for l in lines)
    nat = _bam.sam_to_bam(sam, b"chr1\x00chr2\x00")
    assert nat == py
    assert _bam.bgzf(py, 6, 3) == bgzf_compress(py)
    rows = np.frombuffer(_bam.scan_records(py), np.int64).reshape(-1, 5)
    assert len(rows) == len(lines)
    for off, ln, utid, pos1, rev in rows[:20]:
        assert sort_key_from_raw(py[off:off + ln]) == \
            (((int(utid) << 32) | int(pos1)) << 1) | int(rev)
    # bucketed encode routes identically to the Python BucketSort path
    acc = np.asarray([0, 5000, 8000], np.int64)
    chunks = _bam.sam_to_bam_bucketed(sam, b"chr1\x00chr2\x00",
                                      acc.tobytes(), 1000, 8, False, False)
    assert b"".join(chunks) != b""
    got = {}
    for b, raw in enumerate(chunks):
        for r in np.frombuffer(_bam.scan_records(raw),
                               np.int64).reshape(-1, 5):
            rec = raw[r[0]:r[0] + r[1]]
            tid, pos = struct.unpack_from("<ii", rec, 4)
            exp = 8 if tid < 0 else min((acc[tid] + pos) // 1000, 7)
            assert b == exp
            got[rec] = b
    assert len(got) == len(lines)
