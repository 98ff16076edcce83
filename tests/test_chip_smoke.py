"""chip_smoke.py rehearsed on the CPU at a tiny size.

The script refuses to run without a GPU; these tests drive its phase
functions on the CPU backend (platform "cpu", 4 virtual devices) with a
200 kbp genome and 300 read pairs. That checks the fixture, the CLI runs,
the golden, wide-machine and extension-wave comparisons, the four-device
paths and the failure rules; only the GPU's compiler is left for the
card."""

import importlib.util
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

SIZES = dict(genome_len=200_000, n_pairs=300, n_subset=200)


def _env():
    return cs.child_env(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")


def test_one_card_phases_on_cpu(tmp_path):
    out = cs.run_smoke(tmp_path, _env(), "cpu", threads=2, **SIZES)
    assert out["fixture"]["n_pairs"] == 300
    assert out["bam_records"] == 600
    assert out["wide"]["records"] >= 200
    # 400 subset reads exceed the waves' host-drain threshold
    for tag in ("subset_waves", "subset_waves_warm"):
        assert out[tag]["stats"]["ext_tasks_device"] > 0
    for tag in ("main_sam", "main_sam_warm", "main_bam", "subset_host",
                "subset_waves", "subset_waves_warm", "subset_host_warm"):
        assert out[tag]["stats"]["device_errors"] == 0
        assert out[tag]["first_batch_s"] is not None


def test_four_device_phases_on_cpu(tmp_path):
    out = cs.run_four(tmp_path, _env(), "cpu", threads=2, **SIZES)
    assert len(out["ranks"]) == 4
    assert len(out["local_devices"]["peak_bytes_in_use"]) == 4
    # every rank aligned a share; together all 600 reads
    assert sum(r["stats"]["reads"] for r in out["ranks"]) == 600


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu_or_checkout(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path)
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script), "--workdir",
                        str(tmp_path / "w")], cwd=tmp_path, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert not (tmp_path / "w").exists()


GOOD = {"platform": "gpu", "device_ok": True,
        "stats": {"device_errors": 0, "reads": 10}}


@pytest.mark.parametrize("stderr,rep", [
    ("", dict(GOOD, stats={"device_errors": 1})),
    ("", dict(GOOD, device_ok=False)),
    ("", dict(GOOD, platform="cpu")),
    ("", None),
    ("[W::align] device path failed (RuntimeError()); falling back\n",
     GOOD),
])
def test_device_run_failure_rules(stderr, rep):
    with pytest.raises(cs.SmokeError):
        cs.check_device_run("t", stderr, rep, "gpu")
    cs.check_device_run("t", "", GOOD, "gpu")


def test_sam_comparison(tmp_path):
    hdr = "@SQ\tSN:chr1\tLN:100\n"
    rec = "r1\t0\tchr1\t5\t60\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII\n"
    a, b, c = tmp_path / "a.sam", tmp_path / "b.sam", tmp_path / "c.sam"
    a.write_text(hdr + "@PG\tID:x\tCL:one\n" + rec)
    b.write_text(hdr + "@PG\tID:x\tCL:two\n" + rec)
    c.write_text(hdr + rec.replace("\t5\t", "\t6\t"))
    cs.check_same_sam("pg only", a, b)
    with pytest.raises(cs.SmokeError):
        cs.check_same_sam("record", a, c)


def test_subset_records_of_full_run(tmp_path):
    hdr = "@SQ\tSN:chr1\tLN:100\n"
    r1 = "r1\t0\tchr1\t5\t60\t4M\t*\t0\t0\tACGT\tIIII\n"
    r1s = "r1\t2048\tchr1\t50\t60\t4M\t*\t0\t0\tACGT\tIIII\n"
    r2 = "r2\t0\tchr1\t9\t60\t4M\t*\t0\t0\tACGT\tIIII\n"
    full, sub, bad = (tmp_path / n for n in ("f.sam", "s.sam", "b.sam"))
    full.write_text(hdr + "@PG\tID:x\tCL:full\n" + r1 + r1s + r2)
    sub.write_text(hdr + r1 + r1s)
    cs.check_subset_records(full, sub)
    # a subset read's record that differs, or is missing, fails
    bad.write_text(hdr + r1 + r1s.replace("\t50\t", "\t51\t"))
    with pytest.raises(cs.SmokeError):
        cs.check_subset_records(full, bad)
    full.write_text(hdr + r1 + r2)
    with pytest.raises(cs.SmokeError):
        cs.check_subset_records(full, sub)
