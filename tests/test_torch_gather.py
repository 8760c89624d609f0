"""Kernels I and J's plain versions (``ops/gather.py``) against ``jnp.take``
and a numpy ``take_along_axis`` loop, on the CPU, and the gather
microbenchmark's case lists against the TPU scripts'."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_torch.bench import gather as bench_gather
from instant_ngp_torch.ops.gather import (
    gather_cols_sum,
    gather_cols_sum_plain,
    take_rows,
    take_rows_plain,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    """A numpy array (f32 or ml_dtypes bf16) as a torch tensor of dtype."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_features", [4, 16, 32])
def test_take_rows_equals_jnp_take(n_features, dtype):
    np_dtype, torch_dtype = DTYPES[dtype]
    rng = np.random.default_rng(n_features)
    table = rng.standard_normal((1 << 12, n_features)).astype(np_dtype)
    idx = rng.integers(0, table.shape[0], 5000).astype(np.int32)
    ref = np.asarray(jax.jit(lambda t, i: jnp.take(t, i, axis=0))(table, idx))
    out = take_rows(_torch(table, torch_dtype), torch.from_numpy(idx))  # CPU: the plain version
    assert out.dtype == torch_dtype
    np.testing.assert_array_equal(out.float().numpy(), ref.astype(np.float32))


def _cols_loop(x: np.ndarray, idx: np.ndarray, reps: int) -> np.ndarray:
    """The Pallas kernel's loop in numpy, summed in x's type from zero."""
    acc = np.zeros_like(x)
    for k in range(reps):
        acc = (acc + np.take_along_axis(x, (idx + k) % x.shape[0], axis=0)).astype(x.dtype)
    return acc


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_rows", [8, 512])
def test_gather_cols_sum_equals_numpy_loop(n_rows, dtype):
    """The same adds in the same order: equal in f32, and in bf16, where
    both round to bf16 after every add."""
    np_dtype, torch_dtype = DTYPES[dtype]
    rng = np.random.default_rng(n_rows)
    x = rng.standard_normal((n_rows, 128)).astype(np_dtype)
    idx = rng.integers(0, n_rows, (n_rows, 128)).astype(np.int32)
    ref = _cols_loop(x, idx, 8)
    out = gather_cols_sum(_torch(x, torch_dtype), torch.from_numpy(idx), 8)
    assert out.dtype == torch_dtype
    np.testing.assert_array_equal(out.float().numpy(), ref.astype(np.float32))


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    table = torch.randn(16, 4)
    idx = torch.tensor([3, 0, 15], dtype=torch.int32)
    assert torch.equal(take_rows(table, idx), take_rows_plain(table, idx))
    x, ix = torch.randn(8, 4), torch.randint(0, 8, (8, 4), dtype=torch.int32)
    assert torch.equal(gather_cols_sum(x, ix, 3), gather_cols_sum_plain(x, ix, 3))


def _tpu_case_lists(script: str) -> list:
    """The list literals iterated by top-level for loops of a TPU script."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    return [node.iter for node in tree.body if isinstance(node, ast.For)]


def _dtype_of(node) -> str:
    return node.attr  # jnp.float32 / jnp.bfloat16


def test_bench_case_lists_are_the_tpu_scripts():
    take_lists = [[(ast.literal_eval(e.elts[0]), ast.literal_eval(e.elts[1]), _dtype_of(e.elts[2]))
                   for e in it.elts] for it in _tpu_case_lists("bench_gather_tpu.py")
                  if isinstance(it, ast.List)]
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    ours = [[(t, f, name[d]) for t, f, d in cases] for cases in
            (bench_gather.TAKE_LIBRARY_CASES, bench_gather.TAKE_KERNEL_CASES)]
    assert take_lists == ours
    onehot = [it for it in _tpu_case_lists("bench_gather_tpu.py") if isinstance(it, ast.Tuple)]
    assert [ast.literal_eval(onehot[0])] == [bench_gather.ONEHOT_LOG2_T]
    # bench_dyngather.py: run_one(T) for T in (8, ..., 32768), then run_one(4096, bf16)
    (loop,) = _tpu_case_lists("bench_dyngather.py")
    f32_cases = [(t, torch.float32) for t in ast.literal_eval(loop)]
    assert bench_gather.COL_CASES == f32_cases + [(4096, torch.bfloat16)]


def test_bench_fails_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_gather.run(iters=1, warmup=0)
