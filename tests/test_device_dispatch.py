"""What decides where the solver runs: the kit dispatch predicate, the
block-sparse SpMM against NumPy, the compile-cache placement, and
``chip_smoke.py``'s refusal to run without a GPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cdmft_lanc_ed_tpu
from cdmft_lanc_ed_tpu.ops import large, spmv

B = large.B
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- kit dispatch ------------------------------------------------------------

def test_dispatch_cpu_keeps_complex_oracle(monkeypatch):
    monkeypatch.delenv("CDMFT_SPLIT_BACKEND", raising=False)
    assert jax.default_backend() == "cpu"
    assert not spmv.use_split_backend()


@pytest.mark.parametrize("backend", ["gpu", "cuda", "rocm"])
def test_dispatch_accelerator_takes_kits(monkeypatch, backend):
    monkeypatch.delenv("CDMFT_SPLIT_BACKEND", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert spmv.use_split_backend()


@pytest.mark.parametrize("env,want", [("1", True), ("0", False),
                                      ("false", False)])
def test_dispatch_env_override(monkeypatch, env, want):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("CDMFT_SPLIT_BACKEND", env)
    assert spmv.use_split_backend() is want


# -- block-sparse SpMM (XLA path) vs NumPy ------------------------------------

def _factor(blocks, nb, seed=0):
    """Dense [nb*B, nb*B] matrix populated on the given (row, col) blocks
    and its block-sparse factor."""
    rng = np.random.default_rng(seed)
    m = nb * B
    a = np.zeros((m, m))
    for i, j in blocks:
        a[i * B:(i + 1) * B, j * B:(j + 1) * B] = rng.normal(size=(B, B))
    r, c = np.nonzero(a)
    return a, large.block_factor_of_coo(m, r, c, a[r, c], True, np.float32)


@pytest.mark.parametrize("case", ["f32", "bf16", "empty_row_block",
                                  "ragged_columns"])
def test_blk_spmm_matches_numpy(case):
    blocks = [(0, 0), (0, 2), (2, 1), (3, 3), (3, 0)]
    if case == "empty_row_block":
        blocks = [(0, 1), (3, 2)]              # row blocks 1 and 2 empty
    a, f = _factor(blocks, nb=4)
    assert np.all(np.diff(f.row_blk) >= 0)     # tiles sorted by row block
    n = 100 if case == "ragged_columns" else 128
    x = np.random.default_rng(1).normal(size=(4 * B, n)).astype(np.float32)
    tdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    tiles = jnp.asarray(f.tiles, tdt)
    dense = np.zeros_like(a)
    for t, (i, j) in enumerate(zip(f.row_blk, f.col_blk)):
        dense[i * B:(i + 1) * B, j * B:(j + 1) * B] = np.asarray(
            tiles[t].astype(jnp.float32), np.float64)
    ref = dense @ x
    y = np.asarray(large._blk_spmm(
        jnp.asarray(f.row_blk), jnp.asarray(f.col_blk), tiles,
        jnp.asarray(x), 4))
    assert y.shape == ref.shape and y.dtype == np.float32
    # f32 sums of <= 2 tiles x 128 products of f32 (or bf16-exact) data
    np.testing.assert_allclose(y, ref, atol=1e-5 * np.abs(ref).max())
    if case == "empty_row_block":
        assert not y[B:3 * B].any()


def test_blk_spmm_bf16_tiles_upcast():
    """bf16 tiles are upcast to the x dtype (f32 for a bf16 x), so the
    product accumulates at f32: with tiles exact in bf16 the result
    equals the f32-tile product."""
    a, _ = _factor([(0, 0), (1, 1), (1, 0)], nb=2, seed=5)
    a = np.round(a)                  # small integers: exact in bf16
    r, c = np.nonzero(a)
    f = large.block_factor_of_coo(2 * B, r, c, a[r, c], True, np.float32)
    x = np.random.default_rng(3).normal(size=(2 * B, 24)).astype(np.float32)
    idx = (jnp.asarray(f.row_blk), jnp.asarray(f.col_blk))
    y16 = large._blk_spmm(*idx, jnp.asarray(f.tiles, jnp.bfloat16),
                          jnp.asarray(x), 2)
    y32 = large._blk_spmm(*idx, jnp.asarray(f.tiles), jnp.asarray(x), 2)
    assert y16.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(y16), np.asarray(y32))
    yb = large._blk_spmm(*idx, jnp.asarray(f.tiles, jnp.bfloat16),
                         jnp.asarray(x, jnp.bfloat16), 2)
    assert yb.dtype == jnp.float32


def test_blk_spmm_xla_matches_numpy_f64():
    a, f = _factor([(0, 0), (1, 2), (2, 2)], nb=3, seed=4)
    f64 = large.block_factor_of_coo(3 * B, *np.nonzero(a),
                                    a[np.nonzero(a)], True, np.float64)
    x = np.random.default_rng(2).normal(size=(3 * B, 37))
    y = large._blk_spmm_xla(jnp.asarray(f64.row_blk),
                            jnp.asarray(f64.col_blk),
                            jnp.asarray(f64.tiles), jnp.asarray(x), 3)
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.gpu
def test_f32_highest_is_not_tf32_on_gpu(gpu):
    """On the card an f32 product at HIGHEST keeps f32 accuracy (TF32
    would give ~1e-3): the mixed solver's Krylov stage relies on it."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(512, 512))
    x = rng.normal(size=(512, 512))
    y = jnp.matmul(jnp.asarray(a, jnp.float32), jnp.asarray(x, jnp.float32),
                   precision=jax.lax.Precision.HIGHEST)
    ref = a @ x
    assert np.abs(np.asarray(y) - ref).max() <= 1e-5 * np.abs(ref).max()


# -- compile cache ------------------------------------------------------------

def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cdmft_lanc_ed_tpu.compile_cache_dir() == want
    assert cdmft_lanc_ed_tpu.compile_cache_dir() == want   # never moves


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cdmft_lanc_ed_tpu.compile_cache_dir() == str(tmp_path)


# -- chip_smoke.py --------------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
