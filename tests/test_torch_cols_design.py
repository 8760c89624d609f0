"""Kernel J's design against the JAX package on the CPU.

The port's ``gather_cols_sum`` on CPU tensors (its plain version, which the
card's kernel is held to bit for bit) equals the Pallas kernel of
``scripts/bench_dyngather.py`` bit for bit, both as its jitted body and
through ``pl.pallas_call`` in interpret mode, in f32 and bf16, for indices in
[0, T), negative ones and ones within reps of 2^31 − 1, whose int32 sum with
k wraps. A numpy model of the kernel's index and tile arithmetic (the 32-bit
first row, the int32 wrap, the padded column copies, the 16-byte window loads
and each route's blocks, threads and outputs, as in ``csrc/gather.cu``)
writes every output exactly once and equals the plain version bit for bit at
ragged shapes."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from instant_ngp_torch.bench import gather as bench_gather
from instant_ngp_torch.ops import gather as port_gather

torch.set_num_threads(2)

REPS = 8
INT32_MAX = (1 << 31) - 1
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BITS = {np.dtype(np.float32): np.uint32, np.dtype(jnp.bfloat16): np.uint16}
# csrc/gather.cu's launch constants, read from the source the card builds
CU = {name: int(value) for name, value in re.findall(
    r"constexpr int (k\w+) = (\d+);",
    (Path(port_gather.__file__).parents[1] / "csrc" / "gather.cu").read_text())}
# an H100 SXM's SMs and shared memory (block opt-in, SM, reserve a block) and
# threads an SM, as ngp_gather_cols_limits reads them there
H100 = port_gather.ColsLimits(CU["kColsThreads"], 132, 232_448, 233_472, 1_024, 2_048)


def _indices(kind: str, shape, n_rows: int, rng) -> np.ndarray:
    """int32 indices: in [0, T), negative, within REPS of 2^31 − 1, or a
    third of each."""
    if kind == "mixed":
        parts = [_indices(k, shape, n_rows, rng) for k in ("range", "negative", "near_max")]
        return np.choose(rng.integers(0, 3, shape), parts).astype(np.int32)
    lo, hi = {"range": (0, n_rows - 1), "negative": (-(1 << 31), -1),
              "near_max": (INT32_MAX - REPS, INT32_MAX)}[kind]
    return rng.integers(lo, hi, shape, endpoint=True).astype(np.int32)


def _inputs(n_rows: int, n_cols: int, dtype: str, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, n_cols)).astype(DTYPES[dtype][0])
    return x, _indices(kind, (n_rows, n_cols), n_rows, rng)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _body(v, ix, n_rows: int, reps: int):
    """The Pallas kernel's body (scripts/bench_dyngather.py:34-40): reps
    gathers at (ix + k) % T, int32, summed into a carry from zeros."""
    def step(k, carry):
        return carry + jnp.take_along_axis(v, (ix + k) % n_rows, axis=0)
    return lax.fori_loop(0, reps, step, jnp.zeros_like(v))


def _jax_kernel(how: str, x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    n_rows = x.shape[0]
    if how == "jit_body":
        def fn(x, idx):
            return _body(x, idx, n_rows, REPS)
    else:
        def kernel(x_ref, idx_ref, out_ref):
            out_ref[:] = _body(x_ref[:], idx_ref[:], n_rows, REPS)

        def fn(x, idx):
            return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                                  interpret=True)(x, idx)
    return np.asarray(jax.jit(fn)(x, idx))


@pytest.mark.parametrize("how", ["jit_body", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["range", "negative", "near_max"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_cols", [4, 128])
@pytest.mark.parametrize("n_rows", [7, 8, 512])
def test_gather_cols_sum_equals_the_jax_kernel_bit_for_bit(n_rows, n_cols, dtype, kind, how):
    """The port's J on the CPU against the Pallas kernel, jitted: equal to
    the bit. Near 2^31 − 1 the int32 sum idx + k wraps to −2^31 before the
    modulo, which moves the row unless T divides 2^32 (T 7)."""
    x, idx = _inputs(n_rows, n_cols, dtype, kind, n_rows * n_cols)
    ref = _jax_kernel(how, x, idx)
    out = port_gather.gather_cols_sum(_to_torch(x, dtype), torch.from_numpy(idx), REPS)
    assert out.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(out.float().numpy(), ref.astype(np.float32))


def test_int32_wrap_at_a_t_that_does_not_divide_2_32():
    """The fault this design fixed: at T 7 and idx 2^31 − 3, idx + k wraps
    to −2^31 at k 3, so the JAX kernel reads rows 6, 0, 1, 5, 6, 0, 1, 2; a
    sum widened to int64 reads 6, 0, 1, 2, 3, 4, 5, 6."""
    x = np.arange(28, dtype=np.float32).reshape(7, 4)
    idx = np.full((7, 4), INT32_MAX - 2, np.int32)
    ref = _jax_kernel("jit_body", x, idx)
    np.testing.assert_array_equal(ref[0], [84, 92, 100, 108])
    out = port_gather.gather_cols_sum(torch.from_numpy(x), torch.from_numpy(idx), REPS)
    np.testing.assert_array_equal(out.numpy(), ref)
    widened = sum(x[(idx.astype(np.int64) + k) % 7, np.arange(4)] for k in range(REPS))
    np.testing.assert_array_equal(widened[0], [108, 116, 124, 132])


# --- a numpy model of csrc/gather.cu's kernel J ------------------------------


def _first_row(v: np.ndarray, n_rows: int) -> np.ndarray:
    """first_row: C's truncating remainder in int32, plus T where negative."""
    p = np.fmod(v.astype(np.int32), np.int32(n_rows))
    return np.where(p < 0, p + n_rows, p).astype(np.int64)


def _wrap_k(v: np.ndarray) -> np.ndarray:
    """wrap_k: the k at which int32 v + k wraps, 2^31 − v in uint32 for
    v > 0, else 2^32 − 1."""
    return np.where(v > 0, np.uint32(0x80000000) - v.astype(np.uint32),
                    np.uint32(0xFFFFFFFF)).astype(np.int64)


def _padded(x: np.ndarray, reps: int, stride: int) -> np.ndarray:
    """The (L, stride) column copies: entry p of column j is x[p mod T, j]
    for p < T + max(reps, 1) − 1; the rest holds NaN, which no window may
    read."""
    n_rows = x.shape[0]
    padded = n_rows + max(reps, 1) - 1
    cols = np.full((x.shape[1], stride), np.nan, x.dtype)
    cols[:, :padded] = x[np.arange(padded) % n_rows].T
    return cols


def _window_rows(v: np.ndarray, n_rows: int, reps: int) -> np.ndarray:
    """window_sum's entries: from first_row one a k, jumping to (−2^31) mod
    T at k = wrap_k (the wrapper's rw)."""
    p, kw = _first_row(v, n_rows), _wrap_k(v)
    rows = []
    for k in range(reps):
        p = np.where(kw == k, port_gather.INT32_MIN % n_rows, p)
        rows.append(p)
        p = p + 1
    return np.stack(rows, -1) if rows else np.zeros((*v.shape, 0), np.int64)


def _window_vec(col_bits: np.ndarray, p: np.ndarray) -> np.ndarray:
    """window_sum_vec's lanes: the 16-byte chunks of one column copy (its
    bits) holding entries p .. p + kVecReps − 1 loaded (only the nc needed, the rest
    zero), a funnel shift by half a word where an element is 16 bits, then
    selects by 1 and 2 words. Returns the (n, kVecReps) element bits."""
    reps = CU["kVecReps"]
    size = col_bits.dtype.itemsize
    per_word, v = 4 // size, 16 // size
    n_chunks = (reps + v - 2) // v + 1
    words = col_bits.view(np.uint32).astype(np.uint64)
    e0 = p % v
    nc = (e0 + reps - 1) // v + 1
    first_word = (p - e0) // per_word
    assert np.all((first_word + 4 * nc) <= words.shape[0]), "a load past the column"
    w = [np.where(m // 4 < nc, words[np.minimum(first_word + m, words.shape[0] - 1)], 0)
         for m in range(4 * n_chunks)]
    sw = e0
    if per_word == 2:
        sh = (16 * (e0 & 1)).astype(np.uint64)
        w = [((w[m + 1] << 32 | w[m]) >> sh) & 0xFFFFFFFF for m in range(len(w) - 1)] + w[-1:]
        sw = e0 >> 1
    w = [np.where(sw & 1, w[m + 1], w[m]) for m in range(len(w) - 1)] + w[-1:]
    w = [np.where(sw & 2, w[m + 2], w[m]) for m in range(len(w) - 2)] + w[-2:]
    lanes = [(w[k // per_word] >> (8 * size * (k % per_word))) & ((1 << 8 * size) - 1)
             for k in range(reps)]
    return np.stack(lanes, -1).astype(col_bits.dtype)


def _sum(values: np.ndarray, dtype) -> np.ndarray:
    """Σ over the last axis in dtype, in order from zero."""
    acc = np.zeros(values.shape[:-1], dtype)
    for k in range(values.shape[-1]):
        acc = (acc + values[..., k]).astype(dtype)
    return acc


def _grid(*sizes):
    """Every combination of the ranges, as flat int64 arrays."""
    return [a.ravel() for a in np.meshgrid(*[np.arange(s, dtype=np.int64) for s in sizes],
                                           indexing="ij")]


def _model_shared(x, idx, reps, plan, vec):
    """The shared route: stage each tile (thread-strided loads of V
    elements), then each split's outputs, kColsOuts a thread a block width
    apart. Returns (out, writes per output)."""
    n_rows, n_cols = x.shape
    threads, outs = CU["kColsThreads"], CU["kColsOuts"]
    c = plan.cols
    c_log2 = c.bit_length() - 1
    row_log2 = c_log2 - (vec.bit_length() - 1)
    padded = n_rows + max(reps, 1) - 1
    out = np.zeros_like(x)
    writes = np.zeros(x.shape, np.int64)
    assert plan.smem == c * plan.stride * x.dtype.itemsize <= H100.smem_per_block
    assert padded <= plan.stride
    for t in range(-(-n_cols // c)):
        j0 = t << c_log2
        tile = np.full((c, plan.stride), np.nan, x.dtype)
        staged = np.zeros((c, plan.stride), np.int64)
        n_e = padded << row_log2
        it, tid = _grid(-(-n_e // threads), threads)
        e = tid + it * threads
        e = e[e < n_e]
        p, jl = e >> row_log2, (e & ((1 << row_log2) - 1)) * vec
        keep = j0 + jl < n_cols
        p, jl = p[keep], jl[keep]
        for q in range(vec):
            np.add.at(staged, (jl + q, p), 1)
            tile[jl + q, p] = x[p % n_rows, j0 + jl + q]
        in_l = (j0 + np.arange(c) < n_cols)[:, None]
        np.testing.assert_array_equal(staged[:, :padded], np.broadcast_to(in_l, (c, padded)))
        assert not staged[:, padded:].any()
        for s in range(plan.splits):
            r0 = s * plan.rows
            n_out = (min(n_rows, r0 + plan.rows) - r0) << c_log2
            batch, u, tid = _grid(-(-n_out // (outs * threads)), outs, threads)
            o = batch * outs * threads + u * threads + tid
            jl = o & (c - 1)
            ok = (o < n_out) & (j0 + jl < n_cols)
            i, j = r0 + (o[ok] >> c_log2), j0 + jl[ok]
            rows = _window_rows(idx[i, j], n_rows, reps)
            assert rows.max(initial=0) < padded
            np.add.at(writes, (i, j), 1)
            out[i, j] = _sum(tile[j[:, None] - j0, rows], x.dtype)
    return out, writes


def _model_transpose(x, idx, reps, plan):
    """The transpose route: kTile² tiles of kTileRows-row threads write
    the scratch copies; then blocks of kScratchThreads threads sum
    kColsOuts outputs each, a block width apart, the column stepped by a
    compare-and-wrap, the windows as 16-byte chunks where reps is kVecReps
    and idx + k does not wrap. Returns (out, writes per output)."""
    n_rows, n_cols = x.shape
    tile_n, tile_rows = CU["kTile"], CU["kTileRows"]
    bits = BITS[x.dtype]
    padded = n_rows + max(reps, 1) - 1
    assert plan.stride >= padded and plan.stride % 8 == 0
    xt = np.full((n_cols, plan.stride), np.nan, x.dtype)
    written = np.zeros(xt.shape, np.int64)
    bx, by, ty, m, tx = _grid(-(-padded // tile_n), -(-n_cols // tile_n), tile_rows,
                              tile_n // tile_rows, tile_n)
    r = ty + m * tile_rows
    # load tile[r][tx] = x[(p0 + r) mod T, j0 + tx]; store xt[j0 + r, p0 + tx] = tile[tx][r]
    j, p = by * tile_n + r, bx * tile_n + tx
    ok = (p < padded) & (j < n_cols)
    np.add.at(written, (j[ok], p[ok]), 1)
    xt[j[ok], p[ok]] = x[p[ok] % n_rows, j[ok]]
    np.testing.assert_array_equal(written[:, :padded], 1)
    assert not written[:, padded:].any()
    np.testing.assert_array_equal(xt.view(bits), _padded(x, reps, plan.stride).view(bits))

    threads, outs, n_out = CU["kScratchThreads"], CU["kColsOuts"], x.size
    block, tid = _grid(-(-n_out // (threads * outs)), threads)
    first = block * threads * outs + tid
    step, j = threads % n_cols, first % n_cols
    out = np.zeros(x.size, x.dtype)
    writes = np.zeros(x.size, np.int64)
    for u in range(outs):
        o = first + u * threads
        ok = o < n_out
        np.testing.assert_array_equal(j[ok], o[ok] % n_cols)
        o_ok, j_ok = o[ok], j[ok]
        v = idx.ravel()[o_ok]
        vals = xt[j_ok[:, None], _window_rows(v, n_rows, reps)]
        if reps == CU["kVecReps"]:
            vec = _wrap_k(v) >= reps
            for col in np.unique(j_ok[vec]):
                at = vec & (j_ok == col)
                vals[at] = _window_vec(xt[col].view(bits), _first_row(v[at], n_rows)).view(x.dtype)
        np.add.at(writes, o_ok, 1)
        out[o_ok] = _sum(vals, x.dtype)
        j = j + step
        j = np.where(j >= n_cols, j - n_cols, j)
    return out.reshape(x.shape), writes.reshape(x.shape)


def _check_model(out, writes, x, idx, reps, dtype):
    np.testing.assert_array_equal(writes, 1)
    ref = port_gather.gather_cols_sum_plain(_to_torch(x, dtype), torch.from_numpy(idx), reps)
    np.testing.assert_array_equal(out.astype(np.float32), ref.float().numpy())


@pytest.mark.parametrize("n_rows,n_cols,dtype,reps", [
    (4095, 100, "float32", 8),  # T not a multiple of the split, L not of the tile's 8 columns
    (4096, 128, "bfloat16", 8),  # the microbenchmark's bf16 case: 16 splits of 8 tiles
    (1000, 13, "bfloat16", 8),  # rows of 26 bytes: one element a staging load
    (100, 64, "bfloat16", 11),
    (5, 3, "float32", 8),  # T and L smaller than one tile
    (1, 1, "float32", 8),
    (7, 4, "bfloat16", 0),
])
def test_shared_route_model_writes_each_output_once_and_equals_plain(n_rows, n_cols, dtype, reps):
    x, idx = _inputs(n_rows, n_cols, dtype, "mixed", n_rows + n_cols)
    plan = port_gather.cols_plan(n_rows, n_cols, reps, x.dtype.itemsize, H100)
    assert plan.route == "shared"
    vec = port_gather.staging_vec(n_cols, x.dtype.itemsize, plan.cols, aligned=True)
    _check_model(*_model_shared(x, idx, reps, plan, vec), x, idx, reps, dtype)


@pytest.mark.parametrize("n_rows,n_cols,dtype,reps", [
    (1030, 33, "float32", 8),  # T and L not multiples of the 32x32 tile
    (700, 40, "bfloat16", 8),
    (33, 100, "float32", 3),  # other reps: the one-element window loads
    (5, 3, "bfloat16", 8),  # T and L smaller than one tile
    (1, 7, "float32", 8),
])
def test_transpose_route_model_writes_each_output_once_and_equals_plain(n_rows, n_cols, dtype,
                                                                        reps):
    """The transpose route at small shapes, on its own plan (the wrapper
    takes it where the shared route's tile does not fit)."""
    x, idx = _inputs(n_rows, n_cols, dtype, "mixed", n_rows + n_cols)
    plan = port_gather.transpose_plan(n_rows, reps)
    _check_model(*_model_transpose(x, idx, reps, plan), x, idx, reps, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_rows", [1, 7, 4095])
def test_vector_window_loads_give_the_window(n_rows, dtype):
    """Every start in [0, T): the 16-byte chunks and shifts of
    window_sum_vec give entries p .. p + 7 of the padded copy, bit for bit,
    and load nothing past the column."""
    x, _ = _inputs(n_rows, 1, dtype, "range", n_rows)
    col = _padded(x, REPS, port_gather.transpose_plan(n_rows, REPS).stride)[0]
    bits = col.view(BITS[x.dtype])
    p = np.arange(n_rows)
    want = bits[p[:, None] + np.arange(REPS)]
    np.testing.assert_array_equal(_window_vec(bits, p), want)


def test_first_row_and_wrap_are_the_int32_arithmetic():
    """One 32-bit remainder and the wrap point give (v + k) wrapped to
    int32, floor mod T, at the edges of the int32 range."""
    v = np.array([-(1 << 31), -(1 << 31) + 1, -8, -1, 0, 1, 7, INT32_MAX - 8, INT32_MAX - 7,
                  INT32_MAX - 1, INT32_MAX], np.int32)
    for n_rows in (1, 2, 7, 8, 4095, 32768, 65537):
        padded_rows = _window_rows(v, n_rows, REPS) % n_rows  # the copy's entry p is row p mod T
        exact = [[((int(a) + k + (1 << 31)) % (1 << 32) - (1 << 31)) % n_rows for k in range(REPS)]
                 for a in v]
        np.testing.assert_array_equal(padded_rows, exact)


@pytest.mark.parametrize("t,dtype", bench_gather.COL_CASES)
def test_microbenchmark_cases_take_one_wave_on_the_expected_route(t, dtype):
    """T up to 4,096 stages its tiles in shared memory in one wave of
    blocks; T 32,768 does not fit and takes the transpose route."""
    size = torch.empty((), dtype=dtype).element_size()
    plan = port_gather.cols_plan(t, bench_gather.COLS, REPS, size, H100)
    if t > 4096:
        assert plan == port_gather.transpose_plan(t, REPS)
        return
    assert plan.route == "shared" and plan.smem <= H100.smem_per_block
    assert plan.cols * size == port_gather.SECTOR_BYTES
    per_sm = min(H100.threads_per_sm // H100.threads,
                 H100.smem_per_sm // (plan.smem + H100.smem_reserved))
    blocks = -(-bench_gather.COLS // plan.cols) * plan.splits
    assert blocks <= H100.n_sms * per_sm and (plan.splits - 1) * plan.rows < t <= plan.splits * plan.rows


def test_wrapper_does_not_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on the card raises: J runs
    its plain version for CPU tensors only."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        port_gather.gather_cols_sum(torch.zeros((16, 4), device=meta),
                                    torch.zeros((16, 4), dtype=torch.int32, device=meta), REPS)
