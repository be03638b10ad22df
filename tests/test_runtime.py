"""The run-time set-up of the scripts that drive the card: the published
peak table, the compile-cache helper, and the device guard that keeps
chip_smoke.py and bench.py off the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from graphite_tpu import perf, runtime

REPO = Path(__file__).resolve().parents[1]


class _Device:
    def __init__(self, kind):
        self.device_kind = kind


def test_device_peak_h100():
    peak = perf.device_peak(_Device("NVIDIA H100 80GB HBM3"))
    assert peak == {"bf16": 989e12, "hbm_gbps": 3350.0}


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "cpu"])
def test_device_peak_unknown_kind_is_none(kind):
    """No rate is guessed for a device the table does not list (the PCIe
    H100 has other peaks than the SXM part)."""
    assert perf.device_peak(_Device(kind)) is None


def test_device_peak_of_the_cpu_backend_is_none():
    assert perf.device_peak() is None


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.DEFAULT_CACHE_DIR == REPO / ".jax_cache"
        assert runtime.enable_compile_cache(tmp_path) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_a_cpu_only_run(script):
    """Exit non-zero and print no result when JAX finds no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               GRAPHITE_TPU_BENCH_EXTRAS="0")
    r = subprocess.run([sys.executable, script, "ladybug"]
                       if script == "bench.py" else [sys.executable, script],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and "{" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails without printing a result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "{" not in r.stdout
