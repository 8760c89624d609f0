"""The premises of kernels E and F's Hopper design, on the CPU.

Kernel F (``csrc/mlp_bwd.cu``) runs every product of the MLP backward on
bf16 tensor cores. That is exact only because every inner cotangent is a
bf16 value, and because the f32 output cotangent g enters as three bf16
terms (``split_bf16``); both are checked here against the plain version
and ``jax.vjp``, and so is why two terms would not do. Kernel E (``csrc/hashgrid_bwd.cu``) adds whole rows with
vector atomics after summing equal rows within a warp: its host-side
draw offsets, row alignment and the row-add counts of its design are
checked here. Neither wrapper falls back to its plain version off the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from instant_ngp_tpu.ops import mlp as jax_mlp
from instant_ngp_torch.bench.bwd_kernels import row_add_counts, stratified
from instant_ngp_torch.config import load_network_config
from instant_ngp_torch.models.factory import autoconfig_grid_encoding
from instant_ngp_torch.ops import hashgrid as port_hg
from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd, fused_mlp_bwd_plain, split_bf16

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# test_torch_train_ops.py's two fox MLPs and the image MLP of configs/image/base.json
SHAPES = {"density": (32, 64, 16), "rgb": (32, 64, 64, 3), "image": (32, 64, 64, 3)}
N_ROWS = 777
TIE_ROW = 3  # an all-zero input row: every hidden pre-activation is exactly 0


def _mlp_case(shape: str, seed: int):
    dims = SHAPES[shape]
    rng = np.random.default_rng(seed)
    mlp = jax_mlp.MLP(dims[0], dims[-1], n_neurons=dims[1], n_hidden_layers=len(dims) - 2)
    ws = [np.asarray(w) for w in mlp.init(jax.random.PRNGKey(seed))]
    x = rng.standard_normal((N_ROWS, dims[0])).astype(np.float32)
    g = (rng.standard_normal((N_ROWS, dims[-1])) * 1e-2).astype(np.float32)
    x[TIE_ROW] = 0.0
    return mlp, ws, x, g


def _is_bf16(t: torch.Tensor) -> bool:
    return bool(torch.equal(t, t.to(torch.bfloat16).float()))


class _RecordProducts(TorchFunctionMode):
    """Records the result of every elementwise ``*`` taken inside the mode."""

    def __init__(self):
        super().__init__()
        self.products = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") in ("mul", "__mul__"):
            self.products.append(out)
        return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_inner_cotangents_are_bf16_values(shape):
    """Every dz = bf16(dh)·act' of the plain backward, but the output
    cotangent, is a bf16 value: a bf16 product on it is the f32 product."""
    _, ws, x, g = _mlp_case(shape, 11)
    record = _RecordProducts()
    with record:
        fused_mlp_bwd_plain([torch.tensor(w) for w in ws], torch.from_numpy(x), torch.from_numpy(g))
    # the first product is g·1 (output activation none); then one dz per hidden layer
    assert len(record.products) == len(ws)
    assert torch.equal(record.products[0], torch.from_numpy(g))
    assert not _is_bf16(record.products[0])
    for dz in record.products[1:]:
        assert _is_bf16(dz)
        assert bool((dz != 0).any())


def test_split_bf16_terms():
    """hi, mid and lo are bf16 values; hi + mid is g to 2^-17 relative and
    hi + mid + lo is g exactly."""
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(1 << 16).astype(np.float32))
    g[:3] = torch.tensor([0.0, 1.0, -3.0e-30])
    hi, mid, lo = split_bf16(g)
    assert _is_bf16(hi) and _is_bf16(mid) and _is_bf16(lo)
    assert torch.equal(hi, g.to(torch.bfloat16).float())
    assert bool((torch.abs(hi + mid - g) <= 2.0**-17 * torch.abs(g)).all())
    assert torch.equal(hi + mid + lo, g)


def _backward_vs_jax(shape: str, n_terms: int) -> list[float]:
    """The plain backward with g replaced by the sum of its first n_terms
    bf16 terms, against JAX's vjp on g at test_torch_train_ops's tolerance;
    returns the share of equal values of dX and each dW."""
    mlp, ws, x, g = _mlp_case(shape, 5)
    _, vjp = jax.vjp(lambda p, xx: mlp(p, xx), [jnp.asarray(w) for w in ws], jnp.asarray(x))
    ref_dws, ref_dx = vjp(jnp.asarray(g))
    g_split = sum(split_bf16(torch.from_numpy(g))[:n_terms])
    dx, dws = fused_mlp_bwd_plain([torch.tensor(w) for w in ws], torch.from_numpy(x), g_split)
    shares = []
    for out, ref in [(dx, ref_dx), *zip(dws, ref_dws)]:
        out, ref = out.numpy(), np.asarray(ref, np.float32)
        np.testing.assert_array_equal(out, out.astype(jnp.bfloat16).astype(np.float32))
        np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2 * float(np.abs(ref).max()))
        shares.append(float(np.mean(out == ref)))
    np.testing.assert_array_equal(dx.numpy()[TIE_ROW], np.asarray(ref_dx)[TIE_ROW])
    return shares


@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_cotangent_backward_equals_jax_vjp(shape):
    """The plain backward with g replaced by hi + mid + lo, the cotangent
    kernel F's products see, equals JAX's vjp: ≥ 95 % of values equal."""
    assert min(_backward_vs_jax(shape, 3)) > 0.95


def test_two_bf16_terms_are_not_enough():
    """With hi + mid alone (g to 2^-17 relative) the rgb MLP's backward
    stays within the tolerance, but the error flips intermediate bf16
    roundings of dh, and more than 5 % of the first layer's dW values
    differ from JAX's by a bf16 step."""
    shares = _backward_vs_jax("rgb", 2)
    assert shares[1] < 0.95
    print(f"rgb MLP, g as hi + mid: equal shares of dX, dW_0, dW_1, dW_2 {shares}")


def _image_levels(res: int):
    cfg = load_network_config(ROOT / "configs" / "image" / "base.json")["encoding"]
    cfg = autoconfig_grid_encoding(cfg, "image", image_resolution=(res, res))
    return port_hg.grid_encoding_from_config(cfg, 2, device="meta")


@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
def test_gradient_rows_fit_vector_atomics(n_features):
    """A row of F floats is one f32, float2 or float4 atomic (F = 8: two
    float4), so every level's rows of the image grids start on that width."""
    assert port_hg.row_alignment(n_features) == 4 * min(n_features, 4)
    for res in (8192, 16384):
        for lv in _image_levels(res).levels:
            assert (lv.offset * n_features * 4) % port_hg.row_alignment(n_features) == 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_draw_offsets_are_jax_offsets(k):
    """Kernel E's host table of per-(level, draw) offsets holds the JAX
    package's f32 offsets (``_hge_bwd``), and 0 past the k draws."""
    n_levels = 16
    offsets = np.frombuffer(port_hg._draw_offsets(n_levels, k), dtype=np.float32)
    offsets = offsets.reshape(n_levels, port_hg.MAX_DRAWS)
    for l in range(n_levels):
        for d in range(port_hg.MAX_DRAWS):
            want = np.float32(((l * 7 + d) * 0.6180339887) % 1.0) if d < k else np.float32(0.0)
            assert offsets[l, d] == want


def test_row_add_counts_equal_a_direct_count():
    """``row_add_counts`` (kernel E's row-adds before and after the warp
    sums, and the hottest row) against a count in Python on a small
    stratified batch of the image grid's first levels."""
    levels = _image_levels(8192).levels[:3]
    x = stratified(1 << 10, torch.Generator().manual_seed(0), "cpu")
    counts = row_add_counts(levels, "linear", x)
    for lv, c in zip(levels, counts):
        idx, _ = port_hg._level_corners(lv, "linear", x)
        rows = idx.numpy()
        assert c["adds"] == rows.size
        assert c["after_warp_sum"] == sum(len(set(rows[s, w:w + 32].tolist()))
                                          for s in range(rows.shape[0])
                                          for w in range(0, rows.shape[1], 32))
        assert c["after_warp_sum_any_slot"] == sum(len(set(rows[:, w:w + 32].reshape(-1).tolist()))
                                                   for w in range(0, rows.shape[1], 32))
        assert c["hottest_row"] == max(np.bincount(rows.reshape(-1)))
        assert c["after_warp_sum_any_slot"] <= c["after_warp_sum"] < c["adds"]


@pytest.mark.parametrize("which", ["E", "F"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor that is neither on the CPU nor on the card raises: the
    wrappers run their plain versions for CPU tensors only."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "E":
            enc = _image_levels(64)
            x = torch.zeros((8, 2), device=meta)
            g = torch.zeros((8, enc.n_output_dims), device=meta)
            port_hg.hashgrid_encode_bwd(enc.levels, "linear", x, g, enc.n_entries, 1)
        else:
            ws = [torch.zeros(a, b, device=meta) for a, b in zip((32, 64), (64, 16))]
            fused_mlp_bwd(ws, torch.zeros((8, 32), device=meta), torch.zeros((8, 16), device=meta))

