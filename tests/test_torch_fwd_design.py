"""The premises of kernels A and B's redesign, on the CPU: kernel A's
invariant-divisor multiply-shift and mask equal % at every level size the
port's grids have, kernel B's in-register bf16 rounding is torch's, the
wrappers run their plain versions for CPU tensors only, and the plain
encode and MLP on the grid update's own probe positions equal the JAX
package's ``GridEncoding`` and ``MLP.__call__``."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.config import load_network_config
from instant_ngp_torch.models.factory import autoconfig_grid_encoding
from instant_ngp_torch.models.nerf_network import params_to_numpy
from instant_ngp_torch.nerf import occupancy
from instant_ngp_torch.ops import hashgrid as port_hg
from instant_ngp_torch.ops.mlp_kernel import fused_mlp, fused_mlp_plain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
UINT32_MAX = (1 << 32) - 1
N_PROBES = 1 << 14


def _grid(name: str) -> port_hg.GridEncoding:
    """fox's grid (configs/nerf/base.json at aabb_scale 4), and the grids
    configs/image/base.json autoconfigures for an 8192^2 and a 16384^2
    image."""
    if name == "fox":
        cfg = load_network_config(ROOT / "configs" / "nerf" / "base.json")["encoding"]
        return port_hg.grid_encoding_from_config(
            autoconfig_grid_encoding(cfg, "nerf", aabb_scale=4), 3, device="meta")
    res = int(name.removeprefix("image"))
    cfg = load_network_config(ROOT / "configs" / "image" / "base.json")["encoding"]
    return port_hg.grid_encoding_from_config(
        autoconfig_grid_encoding(cfg, "image", image_resolution=(res, res)), 2, device="meta")


def _mod_by_magic(v: np.ndarray, size: int) -> np.ndarray:
    """v % size for uint32 values v as kernel A computes it (csrc/hashgrid.cu
    mod_size), in numpy, from the host's divisor_magic."""
    magic, shift = port_hg.divisor_magic(size)
    v = np.asarray(v, np.uint64)
    if magic == 0:
        return v & np.uint64(size - 1)
    t = (v * np.uint64(magic)) >> np.uint64(32)
    q = (t + ((v - t) >> np.uint64(1))) >> np.uint64(shift)
    return v - q * np.uint64(size)


def _operands(level: port_hg.GridLevelSpec, n_dims: int, rng) -> np.ndarray:
    """uint32 operands of a level's %: the edges (0, size − 1, size, the
    uint32 maximum), the dense and the hashed index (uint32 products with
    the tcnn primes) of random corners in [−2, res] and of every corner
    made of the edge values −2, −1, 0, 1, res − 1, res (corners below 0
    wrap), and random uint32s."""
    size, res = level.size, level.resolution
    edges = [0, 1, size - 1, size, size + 1, 2 * size - 1, 2 * size, UINT32_MAX, UINT32_MAX - 1,
             1 << 31, (1 << 31) - 1]
    c = np.stack(np.meshgrid(*[np.array([-2, -1, 0, 1, res - 1, res])] * n_dims), -1)
    c = np.concatenate([c.reshape(-1, n_dims), rng.integers(-2, res + 1, (1 << 16, n_dims))])
    c = c.astype(np.int64) & UINT32_MAX
    dense = np.zeros(c.shape[0], np.int64)
    hashed = np.zeros(c.shape[0], np.int64)
    for d in range(n_dims):
        dense = (dense + c[:, d] * (res**d & UINT32_MAX)) & UINT32_MAX
        hashed ^= (c[:, d] * port_hg._PRIMES[d]) & UINT32_MAX
    values = np.concatenate([np.asarray(edges, np.int64), dense, hashed,
                             rng.integers(0, 1 << 32, 1 << 16)])
    return values.astype(np.uint64)


@pytest.mark.parametrize("name", ["fox", "image8192", "image16384"])
def test_divisor_multiply_shift_equals_mod(name):
    """Kernel A's % size without a division, from the host's (magic,
    shift), equals % on every level of the grid."""
    grid = _grid(name)
    rng = np.random.default_rng(5)
    assert any(port_hg.divisor_magic(lv.size)[0] for lv in grid.levels)  # a size that is no 2^k
    for lv in grid.levels:
        v = _operands(lv, grid.n_dims, rng)
        np.testing.assert_array_equal(_mod_by_magic(v, lv.size), v % np.uint64(lv.size))
        magic, shift = port_hg.divisor_magic(lv.size)
        assert 0 <= magic < 1 << 32 and 0 <= shift < 32


@pytest.mark.parametrize("name", ["fox", "image8192", "image16384"])
def test_power_of_two_sizes_take_the_mask(name):
    """Every hashed level's size is a power of two, so kernel A masks; the
    mask equals % there, and divisor_magic gives (0, 0) exactly for powers
    of two."""
    grid = _grid(name)
    rng = np.random.default_rng(6)
    for lv in grid.levels:
        pow2 = lv.size & (lv.size - 1) == 0
        assert pow2 or not lv.hashed
        assert (port_hg.divisor_magic(lv.size) == (0, 0)) == pow2
        if pow2:
            v = _operands(lv, grid.n_dims, rng)
            np.testing.assert_array_equal(v & np.uint64(lv.size - 1), v % np.uint64(lv.size))


def test_multiply_shift_equals_mod_for_every_divisor_shape():
    """The formula over divisors of every bit length, 3 to 2^32 − 1."""
    rng = np.random.default_rng(7)
    divisors = [3, 5, 6, 7, 24, 4913, 35937, 1000003] + [
        int(d) for b in range(3, 33) for d in rng.integers(1 << (b - 1), (1 << b) - 1, 2)]
    v = np.concatenate([np.arange(0, 4096), [UINT32_MAX, UINT32_MAX - 1, 1 << 31],
                        rng.integers(0, 1 << 32, 1 << 14)]).astype(np.uint64)
    for d in divisors:
        np.testing.assert_array_equal(_mod_by_magic(v, d), v % np.uint64(d))


def _bf16_rne_bits(x: np.ndarray) -> np.ndarray:
    """The bf16 bits of f32 x by round to nearest even on the bit pattern,
    what cvt.rn.bf16x2.f32 (kernel B's __floats2bfloat162_rn) computes: no
    flush of subnormals, overflow to infinity, NaN kept NaN."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), np.uint16(0x7FC0) | (u >> 16).astype(np.uint16) & 0x8000, r)


def test_bf16_round_to_nearest_even_equals_torch():
    """Kernel B rounds the f32 input and weights to bf16 in registers, where
    the old wrapper called Tensor.to(torch.bfloat16): the two agree on ties
    (both parities), their neighbours, subnormals, overflow and signs."""
    rng = np.random.default_rng(8)
    hi = rng.integers(0, 1 << 16, 4096, dtype=np.uint64) << 16
    low = np.array([0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF, 0x0001], np.uint64)
    bits = (hi[:, None] | low[None, :]).reshape(-1)
    bits = bits[(bits >> 23 & 0xFF) != 0xFF]  # finite patterns; inf and NaN below
    sub = rng.integers(0, 1 << 23, 4096, dtype=np.uint64)  # subnormals, both signs
    sub = np.concatenate([sub, sub | (1 << 31), [0x00008000, 0x00018000, 0x807F8000]])
    specials = np.array([0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
                         0x80000000, 0x00000000], np.uint64)
    x = np.concatenate([bits, sub, specials]).astype(np.uint32).view(np.float32)
    ref = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(_bf16_rne_bits(x), ref)
    nan = np.array([np.nan, -np.nan], np.float32)
    assert torch.isnan(torch.from_numpy(nan).to(torch.bfloat16)).all()
    assert np.isnan((_bf16_rne_bits(nan).astype(np.uint32) << 16).view(np.float32)).all()


@pytest.mark.parametrize("which", ["A", "B"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor that is neither on the CPU nor on the card raises: the
    wrappers run their plain versions for CPU tensors only."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "A":
            grid = _grid("image8192")
            port_hg.hashgrid_encode(grid.levels, "linear",
                                    torch.zeros((grid.n_entries, 2), device=meta),
                                    torch.zeros((8, 2), device=meta))
        else:
            ws = [torch.zeros(a, b, device=meta) for a, b in ((32, 64), (64, 16))]
            fused_mlp(ws, torch.zeros((8, 32), device=meta))


def test_probe_encode_and_mlp_equal_jax():
    """The plain encode and the plain density MLP on a chunk of the grid
    update's own probes of the tiny fixture (uniform cells and the first
    occupied candidates, mapped into the aabb as update_grid_step maps
    them), against the jitted JAX GridEncoding and MLP.__call__.
    Tolerances: the encode has the same corners and weights,
    only the f32 sum order may differ (atol 1e-6 on features of the trained
    table); the MLP rounds to bf16 on both sides with f32 sums in another
    order (test_torch_mlp.py's rtol 1e-2, atol 1e-3)."""
    tb = port_testbed.Testbed("nerf", device="cpu")
    tb.load_snapshot(TINY)
    task = tb.task
    grid = task.state.grid
    draws = occupancy.draw_grid_update(torch.Generator().manual_seed(9), grid.density.shape[0],
                                       full=False)
    mips, idx = occupancy.probe_cells(grid, draws, full=False)
    half = idx.shape[0] // 2  # the uniform cells, then the candidates'
    sl = slice(half - N_PROBES // 2, half + N_PROBES // 2)
    pos_world = occupancy.probe_positions(mips[sl], idx[sl], draws.jitter[:, sl])
    aabb_min, aabb_max = task._aabb_t
    pos = ((pos_world - aabb_min) / (aabb_max - aabb_min)).contiguous()

    model = task.model
    enc = model.pos_encoding
    theirs = JaxNerfNetwork.from_config(task.config)
    tree = params_to_numpy(model)
    feats = port_hg.hashgrid_encode_plain(enc.levels, enc.interpolation, enc.table.detach(), pos)
    ref = np.asarray(jax.jit(lambda t, p: theirs.pos_encoding(t, p))(tree["pos_enc"], pos.numpy()))
    np.testing.assert_allclose(feats.numpy(), ref, rtol=0, atol=1e-6)

    ws = [w.detach() for w in model.density_network.weights]
    out = fused_mlp(ws, feats)  # CPU tensors: the plain version
    np.testing.assert_array_equal(out.numpy(), fused_mlp_plain(ws, feats).numpy())
    ref = np.asarray(jax.jit(lambda w, x: theirs.density_network(w, x))(tree["density_net"],
                                                                       feats.numpy()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("dims", [(32, 64, 16), (32, 64, 64, 3), (20, 32, 24)])
def test_recompute_record_is_the_truncated_forward(dims):
    """chip_smoke.py holds kernel B bit for bit against kernel F's recompute
    by running B through the first i layers with output activation none:
    on the CPU, mlp_recompute's layer i equals that truncated forward
    exactly, and its last layer is the MLP's output."""
    from instant_ngp_torch.ops.mlp_kernel import mlp_recompute

    rng = np.random.default_rng(10)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    x = torch.from_numpy(rng.standard_normal((257, dims[0])).astype(np.float32))
    zs = mlp_recompute(ws, x)
    assert [tuple(z.shape) for z in zs] == [(257, d) for d in dims[1:]]
    for i, z in enumerate(zs):
        assert torch.equal(z, fused_mlp(ws[:i + 1], x, "relu", "none"))
    assert torch.equal(zs[-1], fused_mlp(ws, x))
