"""Rehearsal of chip_smoke.py on the CPU at a tiny size (3k x 16).

The phases run here exactly as on the card, with CPU results; only the
device check is relaxed. On the card the script runs at 1M x 128.
"""

import importlib.util
import os
import sys
from pathlib import Path

import jax
import pytest

from hnsw_slim_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke(chip_smoke):
    s = chip_smoke.Smoke(chip_smoke.Sizes(
        n=3000, dim=16, n_queries=64, n_insert=100, n_served=20,
        n_gt_check=16, n_cpu=32, n_prune=256, n_delete=3, slimq_n=2000,
        shard_n=1500,
    ))
    yield s
    s.shutdown()


def test_main_refuses_cpu_backend(chip_smoke, capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert "'cpu'" in out.err and out.out == ""


def test_phase_device(smoke):
    dev = smoke.device(require_gpu=False)
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="needs a GPU"):
        smoke.device()


def test_phase_data(smoke):
    smoke.data()
    assert smoke.base.shape == (3000, 16) and smoke.gt.shape == (64, 10)
    assert smoke.inserts.shape == (100, 16)


def test_phase_serve(smoke):
    smoke.serve()
    assert set(smoke.server.setup_seconds) == {
        "build", "convert", "prewarm", "layouts"}


def test_phase_update(smoke):
    smoke.update()
    assert smoke.server.hnsw.graph.n == 3100


def test_phase_cpu_check(smoke):
    smoke.cpu_check()


def test_phase_variants(smoke):
    smoke.variants()


def test_phase_memory(smoke, capsys):
    smoke.memory()
    assert "peak_bytes_in_use" in capsys.readouterr().out


def test_phase_multi(chip_smoke):
    chip_smoke.Smoke(chip_smoke.Sizes(
        dim=16, n_queries=64, shard_n=1500)).multi()


def test_prune_tie_margin(chip_smoke):
    import numpy as np

    vecs = np.float32([[0, 0], [1, 0], [0, 1], [3, 0]])
    # candidates 1 and 2 are equidistant from base 0: a tie, margin 0
    assert chip_smoke._prune_tie_margin(vecs, 0, np.int32([1, 2, -1])) == 0
    assert chip_smoke._prune_tie_margin(vecs, 0, np.int32([1, 3])) > 1e5


def test_compile_cache_respects_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.fspath(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
