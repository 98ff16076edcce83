"""Build the native host stages from the committed sources.

    python -m bwa_flow_tpu.native_build

runs ``setup.py build_ext --inplace`` in the checkout, which compiles the
six C++ extensions (chain, wave driver, region/PE tail, markdup, BAM,
ksw/SA-IS) next to the Python package. Without them the pipeline falls
back to slower Python stages, so the test suite and ``chip_smoke.py``
build them first. Up-to-date objects are not rebuilt.
"""

from __future__ import annotations

import importlib
import os
import pathlib
import shutil
import subprocess
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
MODULES = ("_native", "_chain", "_region", "_markdup", "_wave", "_bam")


def build_native(jobs: int | None = None,
                 timeout: float = 900.0) -> tuple[bool, str]:
    """Compile the extensions in place; returns (ok, message). A missing
    compiler or a failed build is reported, not raised."""
    if not (CHECKOUT / "setup.py").exists():
        return False, f"no setup.py in {CHECKOUT}"
    if not any(shutil.which(c) for c in (os.environ.get("CXX", "g++"),
                                         "c++", "clang++")):
        return False, "no C++ compiler on PATH"
    jobs = jobs or min(8, os.cpu_count() or 1)
    cmd = [sys.executable, "setup.py", "build_ext", "--inplace",
           "-j", str(jobs)]
    try:
        r = subprocess.run(cmd, cwd=CHECKOUT, capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return False, f"native build exceeded {timeout:.0f}s"
    if r.returncode != 0:
        return False, "native build failed:\n" + r.stderr[-3000:]
    return True, "native extensions built"


def missing_modules() -> list[str]:
    """Extensions that do not import (unbuilt or broken)."""
    missing = []
    for m in MODULES:
        try:
            importlib.import_module(f"bwa_flow_tpu.{m}")
        except ImportError:
            missing.append(m)
    return missing


if __name__ == "__main__":
    ok, msg = build_native()
    print(msg, file=sys.stderr)
    bad = missing_modules()
    if bad:
        print("not importable: " + ", ".join(bad), file=sys.stderr)
    sys.exit(0 if ok and not bad else 1)
