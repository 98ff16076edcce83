"""Failure detection / graceful degradation (the FPGA validate + redo +
setUseAccx(false) pattern, /root/reference/src/fpga/FPGAPipeline.cpp)."""

import copy

import numpy as np

from bwa_flow_tpu.models import golden
from bwa_flow_tpu.pipeline.batch import BatchAligner
from bwa_flow_tpu.utils.opts import MemOpt
from bwa_flow_tpu.utils.trace import Tracer
from tests.test_pipeline_batch import _make_se_reads


def test_validation_clean_run(small_index, rng):
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 8)
    ba = BatchAligner(opt, fm, wave_cap=32, validate_every=1)
    ba.align_se(reads)
    assert ba.device_ok
    assert ba.stats["validations"] == 1


def test_device_exception_degrades_to_host(small_index, rng, monkeypatch):
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 6)
    want = copy.deepcopy(reads)
    golden.align_se(opt, fm, want)
    ba = BatchAligner(opt, fm, wave_cap=32)
    monkeypatch.setattr(ba, "seeds_dispatch",
                        lambda seqs: (_ for _ in ()).throw(
                            RuntimeError("device lost")))
    ba.align_se(reads)
    assert not ba.device_ok
    assert ba.stats["device_errors"] == 1
    for g, w in zip(reads, want):
        assert g.sam == w.sam
    # subsequent batches run host directly
    reads2 = _make_se_reads(rng, contigs, 4)
    want2 = copy.deepcopy(reads2)
    golden.align_se(opt, fm, want2, n_processed=0)
    ba.align_se(reads2, n_processed=0)
    for g, w in zip(reads2, want2):
        assert g.sam == w.sam


def test_validation_mismatch_degrades(small_index, rng, monkeypatch):
    """Corrupted device extension results must be caught by the validator
    and the batch redone on host, bit-identically."""
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 6)
    want = copy.deepcopy(reads)
    golden.align_se(opt, fm, want)
    ba = BatchAligner(opt, fm, wave_cap=32, validate_every=1,
                      validate_sample=6)
    real = ba.extend_waves
    real_packed = ba.extend_waves_packed

    def corrupted(seqs, chains):
        regs = real(seqs, chains)
        for rr in regs:
            for a in rr:
                a.score += 7  # wrong-result injection
        return regs

    def corrupted_packed(seqs, intvs, sa_flat, **kw):
        rows, frac, off = real_packed(seqs, intvs, sa_flat, **kw)
        rows = rows.copy()
        rows[:, 5] += 7  # wrong-result injection (score column)
        return rows, frac, off

    monkeypatch.setattr(ba, "extend_waves", corrupted)
    monkeypatch.setattr(ba, "extend_waves_packed", corrupted_packed)
    ba.align_se(reads)
    assert not ba.device_ok
    for g, w in zip(reads, want):
        assert g.sam == w.sam


def test_tracer_spans():
    tr = Tracer("t")
    with tr.span("stage_a"):
        pass
    with tr.span("stage_a"):
        pass
    with tr.span("stage_b"):
        pass
    assert tr.counts["stage_a"] == 2
    assert "stage_a" in tr.report()
    assert "stage_b" in tr.as_json()


def _pipe_run(pipe, reads):
    out = []
    pipe.run(iter([reads]), out.extend)
    return out


def test_dataflow_device_failure_midrun(small_index, rng, monkeypatch):
    """Production-path hardening (round-1 verdict task 3): a device
    exception mid-run must degrade AlignPipeline to the pooled host path
    with bit-identical output."""
    import copy
    from bwa_flow_tpu.pipeline.dataflow import AlignPipeline
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 10)
    want = copy.deepcopy(reads)
    golden.align_se(opt, fm, want)
    pipe = AlignPipeline(opt, fm, paired=False, n_workers=0)
    try:
        monkeypatch.setattr(
            pipe.ba, "extend_waves",
            lambda seqs, chains, **kw: (_ for _ in ()).throw(
                RuntimeError("device lost mid-run")))
        monkeypatch.setattr(
            pipe.ba, "extend_waves_packed",
            lambda seqs, intvs, sa_flat, **kw: (_ for _ in ()).throw(
                RuntimeError("device lost mid-run")))
        batches = [reads[:5], reads[5:]]
        done = []
        pipe.run(iter(batches), done.extend)
        assert not pipe.ba.device_ok
        assert pipe.ba.stats["device_errors"] == 1
        assert len(done) == len(reads)
        for g, w in zip(done, want):
            assert g.sam == w.sam
    finally:
        pipe.close()


def test_dataflow_validation_mismatch_degrades(small_index, rng,
                                               monkeypatch):
    """validate_every now runs on the production AlignPipeline path."""
    import copy
    from bwa_flow_tpu.pipeline.dataflow import AlignPipeline
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 8)
    want = copy.deepcopy(reads)
    golden.align_se(opt, fm, want)
    pipe = AlignPipeline(opt, fm, paired=False, n_workers=0,
                         aligner_kw=dict(validate_every=1,
                                         validate_sample=8))
    try:
        real = pipe.ba.extend_waves
        real_packed = pipe.ba.extend_waves_packed

        def corrupted(seqs, chains, **kw):
            regs = real(seqs, chains)
            for rr in regs:
                for a in rr:
                    a.score += 3
            return regs

        def corrupted_packed(seqs, intvs, sa_flat, **kw):
            rows, frac, off = real_packed(seqs, intvs, sa_flat, **kw)
            rows = rows.copy()
            rows[:, 5] += 3
            return rows, frac, off

        monkeypatch.setattr(pipe.ba, "extend_waves", corrupted)
        monkeypatch.setattr(pipe.ba, "extend_waves_packed",
                            corrupted_packed)
        done = []
        pipe.run(iter([reads]), done.extend)
        assert not pipe.ba.device_ok
        assert pipe.ba.stats["validations"] == 1
        for g, w in zip(done, want):
            assert g.sam == w.sam
    finally:
        pipe.close()


def test_structural_check_catches_corrupt_wave_by_default(small_index,
                                                          rng,
                                                          monkeypatch):
    """Round-2 verdict weak #7: with DEFAULT flags (validate_every=0) a
    corrupted device wave result must still be detected — the native
    driver range-checks every row against its task shape (the
    processOutput analog, FPGAPipeline.cpp:29-130) and the pipeline
    degrades to host with bit-identical output."""
    import copy
    from bwa_flow_tpu.ops import wave_native
    if not wave_native.available():
        import pytest
        pytest.skip("native wave driver not built")
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 8)
    want = copy.deepcopy(reads)
    golden.align_se(opt, fm, want)
    ba = BatchAligner(opt, fm, wave_cap=32, drain_max=0)  # wave mode; default validate_every=0
    real_fetch = ba.fetch

    def corrupt_fetch(arr):
        out = real_fetch(arr)
        if getattr(out, "ndim", 0) == 2 and out.shape[0] == 12:
            out = out.copy()
            out[1, :] = -3  # impossible qle: no kernel can emit this
        return out

    monkeypatch.setattr(ba, "fetch", corrupt_fetch)
    ba.align_se(reads)
    assert not ba.device_ok
    assert ba.stats["device_errors"] == 1
    for g, w in zip(reads, want):
        assert g.sam == w.sam


def test_structural_check_passes_clean_waves(small_index, rng):
    """The always-on row validator must never fire on honest results."""
    from bwa_flow_tpu.ops import wave_native
    if not wave_native.available():
        import pytest
        pytest.skip("native wave driver not built")
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 32)
    ba = BatchAligner(opt, fm, wave_cap=16, drain_max=0)  # force device
    ba.align_se(reads)
    assert ba.device_ok
    assert ba.stats["device_errors"] == 0


def test_tail_failure_raises_loudly(small_index, rng, monkeypatch):
    """Round-2 verdict weak #6: an exception in the async tail thread
    must propagate out of pipe.run, not leave .sam silently unset."""
    import pytest
    from bwa_flow_tpu.pipeline.dataflow import AlignPipeline
    from bwa_flow_tpu.ops import region_native
    fm, contigs = small_index
    opt = MemOpt()
    reads = _make_se_reads(rng, contigs, 6)
    pipe = AlignPipeline(opt, fm, paired=False, n_workers=0)
    try:
        def boom(*a, **kw):
            raise RuntimeError("native tail bug")
        monkeypatch.setattr(region_native, "se_tail_batch", boom)
        monkeypatch.setattr(region_native, "se_tail_ok",
                            lambda opt, batch: True)
        with pytest.raises(RuntimeError, match="native tail bug"):
            pipe.run(iter([reads]), lambda b: None)
    finally:
        pipe.close()
