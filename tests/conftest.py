"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The environment is set before jax is imported anywhere, so every test
runs on the CPU backend with 8 virtual devices (multi-device sharding is
checked without cards). The native host stages are built once, by the
controlling process, before any worker collects tests."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


def pytest_configure(config):
    # xdist workers carry `workerinput`; only the controller (or a
    # single-process run) builds, so all workers see the same modules
    if hasattr(config, "workerinput"):
        return
    from bwa_flow_tpu.native_build import build_native
    ok, msg = build_native()
    if not ok:
        # carry on: tests of the native stages skip as without a build
        print(f"[conftest] {msg}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xB3A)


def make_genome(rng, length, n_contigs=1, with_n=False):
    """Random multi-contig genome as FASTA-style contig tuples."""
    contigs = []
    per = length // n_contigs
    for i in range(n_contigs):
        bases = rng.integers(0, 4, size=per)
        seq = np.frombuffer(b"ACGT", dtype=np.uint8)[bases].copy()
        if with_n and per > 50:
            # sprinkle an N run
            start = int(rng.integers(10, per - 20))
            seq[start:start + 5] = ord("N")
        contigs.append((f"ctg{i}", "", seq.tobytes()))
    return contigs


@pytest.fixture(scope="session")
def small_index(rng):
    from bwa_flow_tpu.index.build import build_index
    contigs = make_genome(rng, 6000, n_contigs=2, with_n=True)
    return build_index(contigs), contigs
