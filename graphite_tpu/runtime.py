"""Set-up shared by the scripts that drive the card (bench.py,
chip_smoke.py, the examples): the persistent compilation cache, the
device guard, and the card's identity for every reported number.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

import jax

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache(default_dir: Optional[os.PathLike] = None) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    A large LM program takes minutes to compile cold, and the cache keeps
    the executable across processes. Where ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX reads it at import and nothing is set here. Otherwise the
    cache goes to ``default_dir`` (default: ``.jax_cache`` at the root of
    the checkout).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(default_dir or DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(count: int = 1):
    """The first ``count`` JAX devices, or SystemExit (non-zero) when JAX
    found no GPU or too few: a measurement never falls back to the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {devices[0].platform!r}")
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devices)}")
    return devices[:count]


def device_record(devices) -> dict:
    """The device as JAX reports it, for every printed result."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them (one
    line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
