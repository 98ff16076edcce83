"""Compile-cache placement, the CLI's device report, the native build
helper, and the extension path's imports."""

import json
import pathlib
import subprocess
import sys

import pytest

import oracle as orc

REPO = pathlib.Path(__file__).resolve().parent.parent

_CACHE = ("import jax; from bwa_flow_tpu.utils.devinfo import "
          "setup_compile_cache; d = setup_compile_cache(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


def _run(code, env):
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_compile_cache_default_is_in_checkout():
    got = _run(_CACHE, orc.cli_env())
    want = str(REPO / ".cache" / "jax_cache")
    assert got == [want, want]


def test_compile_cache_env_is_honoured(tmp_path):
    d = str(tmp_path / "cache")
    got = _run(_CACHE, orc.cli_env(JAX_COMPILATION_CACHE_DIR=d))
    assert got == [d, d]


def test_device_report_round_trip():
    from bwa_flow_tpu.utils.devinfo import device_report, parse_device_report

    class BA:
        device_ok = True
        stats = {"reads": 4, "device_errors": 0}

    line = device_report(BA())
    rep = parse_device_report("[M::mem] processed 4 reads\n" + line + "\n")
    assert rep["platform"] == "cpu" and rep["count"] >= 1
    assert rep["stats"] == BA.stats and rep["device_ok"] is True
    assert isinstance(rep["spans"], dict)
    assert len(rep["peak_bytes_in_use"]) == rep["count"]
    assert parse_device_report("no report here") is None


def test_native_build_helper():
    import shutil
    from bwa_flow_tpu.native_build import build_native, missing_modules
    if not any(shutil.which(c) for c in ("g++", "c++", "clang++")):
        pytest.skip("no C++ compiler on PATH")
    ok, msg = build_native()
    assert ok, msg
    assert missing_modules() == []


def test_extension_path_imports_no_removed_module():
    code = ("import sys, json; import bwa_flow_tpu.pipeline.dataflow, "
            "bwa_flow_tpu.ops.chain2aln_jax; print(json.dumps(sorted("
            "m for m in sys.modules if 'extend_pallas' in m or "
            "m.startswith('jax.experimental.pallas'))))")
    r = subprocess.run([sys.executable, "-c", code], env=orc.cli_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    assert not (REPO / "bwa_flow_tpu" / "ops" / "extend_pallas.py").exists()
