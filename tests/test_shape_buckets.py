"""Index shape bucketing: different genomes must share compiled device
programs (a per-genome recompile of the seed machine costs minutes)."""

import numpy as np
import jax.numpy as jnp

from bwa_flow_tpu.index.build import build_index
from bwa_flow_tpu.ops import fm_jax, smem_jax, smem as sg
from bwa_flow_tpu.utils.opts import MemOpt


def _mk(rng, n):
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    return build_index([("c", "", g.tobytes())]), g


def test_same_bucket_shapes(rng):
    fm1, _ = _mk(rng, 6000)
    fm2, _ = _mk(rng, 9000)
    d1 = fm_jax.DeviceFM.from_host(fm1)
    d2 = fm_jax.DeviceFM.from_host(fm2)
    assert d1.fm_blocks.shape == d2.fm_blocks.shape
    assert d1.sa.shape == d2.sa.shape
    assert d1.pac_words.shape == d2.pac_words.shape


def test_padded_index_exactness(rng):
    """Padding must not perturb results: device SMEM on a padded index
    still matches golden exactly."""
    fm, g = _mk(rng, 7000)
    dfm = fm_jax.DeviceFM.from_host(fm)
    opt = MemOpt()
    CODE = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        CODE[c] = i
    reads = []
    for _ in range(12):
        p = int(rng.integers(0, len(g) - 101))
        r = CODE[g[p:p + 101]].astype(np.int32)
        m = rng.random(101) < 0.04
        r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        reads.append(r.astype(np.uint8))
    got = smem_jax.collect_intv_batch(opt, fm, dfm, reads, L=128)
    for b, r in enumerate(reads):
        want = sg.collect_intv(opt, fm, r)
        assert sorted((m.x0, m.x1, m.s, m.info) for m in got[b]) \
            == sorted((m.x0, m.x1, m.s, m.info) for m in want)
    # SA lookups against padded sa table
    ks = np.asarray([int(rng.integers(0, fm.seq_len)) for _ in range(64)],
                    dtype=np.int64)
    packed = np.asarray(fm_jax.sa_batch_packed(dfm, jnp.asarray(ks), 4096))
    from bwa_flow_tpu.ops import fm as fmops
    assert not packed[1].any()
    want = [fmops.bwt_sa(fm, int(k)) for k in ks]
    assert packed[0].tolist() == want
