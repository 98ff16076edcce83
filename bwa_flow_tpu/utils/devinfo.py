"""Device facts for reports, and the persistent compile cache's place.

Every device number this package prints names the device it came from:
`device_summary()` is JAX's view (platform, kind, count), `card_line()`
is the card's own name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess

# <checkout>/.cache/jax_cache: a fixed path (the cache key includes it,
# so a directory that moves never hits), listed in .gitignore
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".cache" / "jax_cache"


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    path is set here; otherwise the cache lives at DEFAULT_CACHE_DIR."""
    import jax
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = str(DEFAULT_CACHE_DIR)
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d


def device_summary() -> dict:
    """platform, kind and count of the devices JAX uses."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_bytes() -> list:
    """peak_bytes_in_use of each local device (None where the backend
    keeps no memory statistics, as on the CPU)."""
    import jax
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.local_devices()]


def device_report(ba) -> str:
    """One `[M::mem] device {json}` line: the devices, whether the device
    path stayed up, per-device peak memory, BatchAligner.stats and the
    pipeline's host span totals (seconds, utils/trace.py)."""
    from .trace import GLOBAL
    rep = dict(device_summary(), device_ok=bool(ba.device_ok),
               peak_bytes_in_use=peak_bytes(), stats=dict(ba.stats),
               spans={k: round(v, 4) for k, v in GLOBAL.totals.items()})
    return "[M::mem] device " + json.dumps(rep)


def parse_device_report(text: str) -> dict | None:
    """The last device report in a stderr text, or None."""
    rep = None
    for line in text.splitlines():
        if line.startswith("[M::mem] device {"):
            rep = json.loads(line[len("[M::mem] device "):])
    return rep


def card_line() -> str | None:
    """`name, power.limit` of each card, as nvidia-smi gives them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None
