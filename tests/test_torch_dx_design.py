"""The premises of kernel K's design (the end of ``csrc/hashgrid_bwd.cu``),
on the CPU.

K takes a block of ``kDxTile`` consecutive samples and every level: warps
take the levels in turn, a lane a sample; each (sample, level) writes its
term col · scale (D floats) into a shared (L, kDxTile, D) tile, and after one
barrier each of the block's outputs is summed over the tile in level order
from 0.0. The mirror below does the same with tensor ops (the corner indices
by kernel A's multiply-shift, not %) and must give the plain version bit for
bit, since that is the JAX package's order; the plain version is held
against ``jax.vjp`` in ``test_torch_sdf_dx.py``. The kernel's shared memory
and launch bounds, read from the source, must fit the blocks an SM is meant
to hold, and its launcher's argument types must match the C function."""

import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_tpu.ops import hashgrid as jax_hg
from instant_ngp_torch import cuda_lib
from instant_ngp_torch.common import fma
from instant_ngp_torch.ops import hashgrid as port_hg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "instant_ngp_torch" / "csrc" / "hashgrid_bwd.cu"
MASK32 = 0xFFFFFFFF
# the H100: shared memory of an SM, what the system keeps of it a block, and
# the registers of an SM
SM_SMEM_BYTES = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
SM_REGISTERS = 65536
BANKS = 32


def kernel_constants() -> dict:
    """The ``constexpr int kDx... = a * b;`` constants of the source."""
    return {name: math.prod(int(v) for v in expr.split("*"))
            for name, expr in re.findall(r"constexpr int (kDx\w+) = ([\d *]+);",
                                         SOURCE.read_text())}


K = kernel_constants()
TILE, WARPS = K["kDxTile"], K["kDxWarps"]


def smem_bytes(n_dims: int, n_levels: int) -> int:
    """``dx_smem_bytes``: the terms' tile of one block."""
    return 4 * n_levels * TILE * n_dims


def block_warps(n_levels: int) -> int:
    """The launcher's warps a block: as many as the busiest warp's levels
    need."""
    per_warp = math.ceil(n_levels / WARPS)
    return math.ceil(n_levels / per_warp)


def corner_index(lv, grid: np.ndarray, bits) -> np.ndarray:
    """Local row of a corner as the kernel forms it: uint32 hash or dense
    index, then % size by kernel A's multiply-shift (a mask where size is a
    power of two)."""
    c = [(grid[:, d] + bits[d]) & MASK32 for d in range(grid.shape[1])]
    if lv.hashed:
        primes = (1, 2654435761, 805459861)
        idx = np.zeros_like(c[0])
        for d in range(len(c)):
            idx ^= (c[d] * primes[d]) & MASK32
    else:
        idx = c[0]
        stride = lv.resolution
        for d in range(1, len(c)):
            idx = (idx + c[d] * (stride & MASK32)) & MASK32
            stride = (stride * lv.resolution) & MASK32
    magic, shift = port_hg.divisor_magic(lv.size)
    if magic == 0:
        return idx & (lv.size - 1)
    t = (idx * magic) >> 32
    q = ((t + ((idx - t) >> 1)) & MASK32) >> shift
    return (idx - q * lv.size) & MASK32


def level_term(lv, interpolation: str, table: torch.Tensor, x: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """One level's col · scale (n, D) of a lane's sample, in the kernel's
    order: every corner's row, the dots over f in order, the d-linear
    columns over the corners in order (or the simplex differences)."""
    n, n_dims = x.shape
    scale = float(np.float32(lv.scale))
    pos = fma(x, scale, 0.5)
    t = pos - torch.floor(pos)
    grid = torch.floor(pos).to(torch.int64).numpy()
    tab = table[lv.offset:lv.offset + lv.size]
    simplex = interpolation == "simplex" and lv.hashed and n_dims == 3
    if simplex:
        amax = torch.argmax(t, dim=-1)
        amin = torch.argmin(t, dim=-1)
        amin = torch.where(amin == amax, (amax + 1) % 3, amin)
        bits = [np.zeros((n, 3), np.int64), np.eye(3, dtype=np.int64)[amax.numpy()],
                1 - np.eye(3, dtype=np.int64)[amin.numpy()], np.ones((n, 3), np.int64)]
        corners = [[b[:, d] for d in range(3)] for b in bits]
    else:
        corners = [[(c >> d) & 1 for d in range(n_dims)] for c in range(1 << n_dims)]
    rows = [tab[torch.from_numpy(corner_index(lv, grid, b).astype(np.int64))] for b in corners]
    gf = []
    for row in rows:
        v = g[:, 0] * row[:, 0]
        for f in range(1, g.shape[1]):
            v = v + g[:, f] * row[:, f]
        gf.append(v)
    if simplex:
        axis = torch.arange(3)[None, :]
        dt = torch.where(axis == amax[:, None], (gf[1] - gf[0])[:, None],
                         torch.where(axis == amin[:, None], (gf[3] - gf[2])[:, None],
                                     (gf[2] - gf[1])[:, None]))
        return dt * scale
    cols = []
    for d in range(n_dims):
        col = None
        for c, v in enumerate(gf):
            prod = None
            for e in range(n_dims):
                if e != d:
                    a = t[:, e] if (c >> e) & 1 else 1.0 - t[:, e]
                    prod = a if prod is None else prod * a
            term = v * (prod if (c >> d) & 1 else -prod)
            col = term if col is None else col + term
        cols.append(col * scale)
    return torch.stack(cols, -1)


def mirror_dx(levels, interpolation: str, table, x, g) -> torch.Tensor:
    """K's design with tensor ops: per block of TILE samples, warp w's
    levels w, w + warps, … into the (L, TILE, D) tile, then each output
    summed over the tile in level order from 0.0."""
    n, n_dims = x.shape
    L, F = len(levels), table.shape[1]
    dx = torch.empty((n, n_dims))
    warps = block_warps(L)
    for s0 in range(0, n, TILE):
        xs, gs = x[s0:s0 + TILE], g[s0:s0 + TILE]
        if interpolation == "nearest":
            dx[s0:s0 + TILE] = 0.0
            continue
        tile = torch.full((L, xs.shape[0], n_dims), float("nan"))
        for w in range(warps):
            for l in range(w, L, warps):
                tile[l] = level_term(levels[l], interpolation, table, xs,
                                     gs[:, l * F:(l + 1) * F])
        acc = torch.zeros((xs.shape[0], n_dims))
        for l in range(L):
            acc = acc + tile[l]
        dx[s0:s0 + TILE] = acc
    return dx


def inputs(rng, n_dims: int, n_features: int, n_levels: int, n: int):
    """Levels from 4 cells at a growth of 1.5 into a 2^10 map (dense and
    hashed ones; non-power-of-two dense sizes), a table in [-1, 1], and
    positions: random, on cell corners of the levels and, in 3-D, on the
    simplex ranks' ties."""
    levels = port_hg.grid_levels(n_dims, n_levels, 10, 4, 1.5)
    n_entries = levels[-1].offset + levels[-1].size
    table = rng.uniform(-1, 1, (n_entries, n_features)).astype(np.float32)
    x = rng.random((n, n_dims), dtype=np.float32)
    q = n // 4
    if q:
        lv = levels[rng.integers(len(levels))]
        k = rng.integers(0, lv.resolution, (q, n_dims))
        x[:q] = np.clip((k - 0.5) / np.float32(lv.scale), 0.0, 1.0)
        if n_dims == 3:
            x[q:2 * q, 1] = x[q:2 * q, 0]
            x[q:q + q // 2, 2] = x[q:q + q // 2, 0]
    g = rng.standard_normal((n, n_levels * n_features)).astype(np.float32)
    return levels, torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(g)


@pytest.mark.parametrize("interpolation", ["linear", "simplex", "nearest"])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_mirror_equals_plain_bit_for_bit(n_dims, n_features, interpolation):
    """The design's order gives ``hashgrid_encode_dx_plain`` bit for bit at
    n = 0, 1, 31, 33 and 70 (short of, past and not a multiple of a tile),
    at 3, 14 and 32 levels."""
    rng = np.random.default_rng(100 * n_dims + 10 * n_features + len(interpolation))
    for n_levels in (3, 14, 32):
        for n in (0, 1, 31, 33, 70):
            levels, table, x, g = inputs(rng, n_dims, n_features, n_levels, n)
            assert not levels[0].hashed and (n_levels < 14 or levels[-1].hashed)
            ref = port_hg.hashgrid_encode_dx_plain(levels, interpolation, table, x, g)
            out = mirror_dx(levels, interpolation, table, x, g)
            assert out.shape == (n, n_dims)
            np.testing.assert_array_equal(out.numpy().view(np.int32), ref.numpy().view(np.int32),
                                          err_msg=f"L={n_levels} n={n}")


def test_multiply_shift_equals_mod_on_the_levels():
    """The mirror's corner rows (kernel A's multiply-shift) are the plain
    version's (%) on every level of the SDF config and of the contract's
    grids, at the extreme corners of the unit cube and past it."""
    from instant_ngp_torch.bench.bwd_kernels import sdf_encoding

    grids = [(3, sdf_encoding().levels)] + [(d, port_hg.grid_levels(d, 32, 10, 4, 1.5))
                                            for d in (2, 3)]
    for n_dims, levels in grids:
        for lv in levels:
            grid = np.array([[0] * n_dims, [lv.resolution] * n_dims, [lv.resolution + 7] * n_dims,
                             [3, lv.resolution - 1, 5][:n_dims]], np.int64)
            for c in range(1 << n_dims):
                bits = [(c >> d) & 1 for d in range(n_dims)]
                ours = corner_index(lv, grid, bits)
                ref = port_hg._corner_index(lv, torch.from_numpy(grid), bits).numpy()
                np.testing.assert_array_equal(ours, ref)


def test_mirror_against_jax_vjp():
    """The mirror against jax.vjp of the JAX package's encode at one shape
    (3-D, 14 levels × 2, dense and hashed, linear): the same corners and
    order, XLA's contractions aside (``test_torch_sdf_dx.py``'s 1e-5)."""
    rng = np.random.default_rng(7)
    levels, table, x, g = inputs(rng, 3, 2, 14, 200)
    cfg = {"otype": "HashGrid", "n_levels": 14, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5}
    theirs = jax_hg.grid_encoding_from_config(cfg, 3)
    assert [(lv.resolution, lv.size, lv.offset, lv.hashed) for lv in theirs.levels] == \
        [(lv.resolution, lv.size, lv.offset, lv.hashed) for lv in levels]
    tables = tuple(table[lv.offset:lv.offset + lv.size].numpy() for lv in levels)

    @jax.jit
    def jax_dx(tables, x, g):
        _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(theirs, tables, p), x)
        return vjp(g)[0]

    ref = np.asarray(jax_dx(tables, x.numpy(), g.numpy()))
    out = mirror_dx(levels, "linear", table, x, g).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


def test_every_level_is_taken_once_by_the_busiest_warps():
    """The launcher's warps a block cover every level once, and no warp
    takes more levels than the busiest must (ceil(L / kDxWarps))."""
    for n_levels in range(1, 33):
        warps = block_warps(n_levels)
        assert 1 <= warps <= WARPS
        taken = sorted(l for w in range(warps) for l in range(w, n_levels, warps))
        assert taken == list(range(n_levels))
        assert math.ceil(n_levels / warps) == math.ceil(n_levels / WARPS)


def test_shared_memory_and_registers_fit_the_blocks_an_sm_holds():
    """At the contract's largest block (L = 32, D = 3) the terms' tile is
    12 KB, and an SM holds kDxMinBlocks blocks of kDxWarps warps, 32 warps,
    each thread with the 64 registers the launch bounds leave it."""
    largest = smem_bytes(3, 32)
    assert largest == 12 * 1024
    assert max(smem_bytes(d, l) for d in (2, 3) for l in range(1, 33)) == largest
    blocks = K["kDxMinBlocks"]
    assert blocks * (largest + BLOCK_RESERVED_SMEM) <= SM_SMEM_BYTES
    assert blocks * WARPS >= 32
    assert SM_REGISTERS // (blocks * WARPS * 32) >= 64
    assert "__launch_bounds__(kDxWarps * 32, kDxMinBlocks)" in SOURCE.read_text()


@pytest.mark.parametrize("n_dims", [2, 3])
def test_the_sum_reads_the_tile_without_bank_conflicts(n_dims):
    """The ordered sum's threads (one a block output, 32·D of them) read
    one level's column of the (L, 32, D) tile at consecutive words, so each
    warp's read falls in 32 distinct banks; a level's writes take at most D
    (D = 2: 2) words a bank."""
    for level in range(32):
        for first in range(0, TILE * n_dims, 32):
            words = [level * TILE * n_dims + e for e in range(first, min(first + 32,
                                                                         TILE * n_dims))]
            assert len({w % BANKS for w in words}) == len(words)
        for d in range(n_dims):
            writes = [((level * TILE + lane) * n_dims + d) % BANKS for lane in range(32)]
            assert max(writes.count(b) for b in set(writes)) <= (2 if n_dims == 2 else 1)


def test_launcher_signature_matches_the_source():
    """K's launcher (``cuda_lib``) has as many argument types as its C
    function has parameters, the stream included, and the wrapper passes
    kernel A's magic and shift arrays."""
    m = re.search(r'extern "C" [\w ]+ ngp_hashgrid_encode_dx\(([^)]*)\)', SOURCE.read_text())
    params = [a.strip() for a in m.group(1).split(",") if a.strip()]
    assert len(params) == len(cuda_lib.SIGNATURES["hashgrid_encode_dx"])
    assert [p.split()[-1] for p in params][8:10] == ["magic", "shift"]


def test_wrapper_launches_or_raises_off_the_cpu(monkeypatch):
    """A CUDA-side call launches K with every argument the C function
    takes (cuda_lib.launch recorded on meta tensors), a g whose rows are not
    aligned for its vector loads is copied first, and such a table raises;
    nothing falls back to the plain version."""
    levels = port_hg.grid_levels(3, 14, 12, 16, 1.5)
    n_entries = levels[-1].offset + levels[-1].size
    meta = torch.device("meta")
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t, dtype=None: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(port_hg, "hashgrid_encode_dx_plain",
                        lambda *a: pytest.fail("the plain version ran off the CPU"))
    table = torch.zeros((n_entries, 2), device=meta)
    x, g = torch.zeros((5, 3), device=meta), torch.zeros((5, 28), device=meta)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 1 << 12)
    dx = port_hg.hashgrid_encode_dx(levels, "linear", table, x, g)
    assert dx.shape == (5, 3)
    assert [c[0] for c in calls] == ["hashgrid_encode_dx"]
    assert len(calls[0][1]) + 1 == len(cuda_lib.SIGNATURES["hashgrid_encode_dx"])
    offset = {}
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: (1 << 12) + offset.get(id(self), 0))
    offset[id(g)] = 4  # g off its vector loads' alignment: launched on a copy
    port_hg.hashgrid_encode_dx(levels, "linear", table, x, g)
    assert [c[0] for c in calls] == ["hashgrid_encode_dx"] * 2
    assert calls[1][1][2] == 1 << 12
    offset[id(table)] = 4  # the table's rows must be aligned
    with pytest.raises(ValueError, match="aligned"):
        port_hg.hashgrid_encode_dx(levels, "linear", table, x, g)
