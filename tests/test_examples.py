"""Examples as smoke tests (the reference CI runs the circle example,
.github/workflows/testing.yaml:28-29)."""

import runpy
import sys

import pytest


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch, tmp_path):
    # the examples enable the persistent compile cache unless this is set;
    # JAX read it at import, so setting it now turns no caching on
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


def _run(path, argv):
    old = sys.argv
    sys.argv = [path] + argv
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


def test_circle_example():
    _run("examples/circle.py", ["--iterations", "40"])


def test_bal_example():
    _run("examples/bal.py", ["--synthetic", "mini", "--solver", "pcg-schur",
                             "--iterations", "8"])


def test_pose_graph_example():
    _run("examples/pose_graph.py", ["--synthetic", "circle2d",
                                    "--poses", "40", "--iterations", "10",
                                    "--solver", "sparse"])


def test_range_bearing_example():
    _run("examples/range_bearing_slam.py", ["--poses", "30",
                                            "--landmarks", "12",
                                            "--iterations", "12"])
