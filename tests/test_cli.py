"""CLI end-to-end: index + mem over real files, SE and PE, SAM to file.
Device and --no-device outputs must be identical."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import oracle as orc


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    rng = np.random.default_rng(0xC11)
    d = tmp_path_factory.mktemp("cli")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, 8000)]
    with open(d / "ref.fa", "w") as f:
        f.write(">chrA test contig\n")
        s = genome.tobytes().decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    comp = bytes.maketrans(b"ACGT", b"TGCA")

    def fastq(path, reads):
        with open(path, "w") as f:
            for name, seq in reads:
                f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")

    se = []
    r1, r2 = [], []
    g = genome.tobytes()
    for i in range(12):
        pos = int(rng.integers(0, 8000 - 420))
        se.append((f"s{i}", g[pos:pos + 101].decode()))
        r1.append((f"p{i}/1", g[pos:pos + 101].decode()))
        mate = g[pos + 300:pos + 401]
        r2.append((f"p{i}/2", mate.translate(comp)[::-1].decode()))
    fastq(d / "se.fq", se)
    fastq(d / "r1.fq", r1)
    fastq(d / "r2.fq", r2)
    return d


def run_cli(args, cwd):
    env = orc.cli_env()
    r = subprocess.run([sys.executable, "-m", "bwa_flow_tpu"] + args,
                       capture_output=True, text=True, cwd=str(cwd),
                       env=env, timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_cli_index_and_mem(workdir):
    run_cli(["index", "ref.fa"], workdir)
    for ext in (".bwt", ".sa", ".pac", ".ann", ".amb"):
        assert (workdir / f"ref.fa{ext}").exists()
    run_cli(["mem", "-o", "se_dev.sam", "ref.fa", "se.fq"], workdir)
    sam = (workdir / "se_dev.sam").read_text()
    lines = [l for l in sam.splitlines() if not l.startswith("@")]
    assert len(lines) >= 12
    assert sam.startswith("@SQ\tSN:chrA\tLN:8000")
    # all clean reads map with MAPQ 60
    for l in lines:
        f = l.split("\t")
        assert f[2] == "chrA" and f[5] == "101M", l


def test_cli_device_equals_host(workdir):
    run_cli(["mem", "--no-device", "-o", "se_host.sam", "ref.fa", "se.fq"],
            workdir)
    dev = (workdir / "se_dev.sam").read_text().splitlines()
    host = (workdir / "se_host.sam").read_text().splitlines()
    # drop @PG (records the differing command line)
    dev = [l for l in dev if not l.startswith("@PG")]
    host = [l for l in host if not l.startswith("@PG")]
    assert dev == host


def test_cli_pe(workdir):
    run_cli(["mem", "-R", "@RG\\tID:rg1\\tSM:s", "-o", "pe.sam",
             "ref.fa", "r1.fq", "r2.fq"], workdir)
    sam = (workdir / "pe.sam").read_text()
    assert "@RG\tID:rg1\tSM:s" in sam
    lines = [l for l in sam.splitlines() if not l.startswith("@")]
    assert len(lines) >= 24
    # proper pairs: flag bit 0x2 set, mate name shared, RG tag present
    for l in lines:
        f = l.split("\t")
        assert int(f[1]) & 0x1, l
        assert "RG:Z:rg1" in l
    flags = [int(l.split("\t")[1]) for l in lines]
    assert all(fl & 0x2 for fl in flags)


def test_multiline_fastq(tmp_path):
    """kseq accepts multi-line sequence/quality records
    (bwa/kseq.h; ADVICE round 1)."""
    from bwa_flow_tpu.io import fastq
    p = tmp_path / "m.fq"
    p.write_text("@r1 c1\nACGT\nACGT\n+\n!!!!\n!!!!\n@r2\nAC\n+\n!!\n")
    reads = list(fastq.read_seqs(p))
    assert [len(r.seq) for r in reads] == [8, 2]
    assert reads[0].qual == "!" * 8 and reads[0].comment == "c1"
    p.write_text("@r1\nACGT\n+\n!!!!!\n")  # qual longer than seq
    import pytest
    with pytest.raises(ValueError):
        list(fastq.read_seqs(p))
