"""The port's marching cubes and tetrahedra against the JAX package's numpy
versions on the CPU: vertices and faces bit for bit on random fields, a
sphere and fields with exact zeros on grid points; the premises of the
torch weld (one rounding of p_a ± t, first-emission positions); the case
tables; ``get_marching_cubes_res``; and the PNG slice sheet's pixels."""

import numpy as np
import pytest
import torch

from instant_ngp_tpu.geometry import marching_cubes as jax_mc
from instant_ngp_torch.geometry import marching_cubes as port_mc
from instant_ngp_torch.io.png import read_png

torch.set_num_threads(2)


def _sphere(n=24, r=0.9):
    g = (np.arange(n) - (n - 1) / 2 - 0.3) / (n / 3)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - r).astype(np.float32)


FIELDS = {
    "random": lambda rng: rng.standard_normal((13, 11, 9)).astype(np.float32),
    "random_cube": lambda rng: rng.standard_normal((20, 20, 20)).astype(np.float32),
    "sphere": lambda rng: _sphere(),
    # every third value exactly the iso: ties on the grid points, t of 0
    "exact_zeros": lambda rng: rng.integers(-2, 3, (10, 12, 14)).astype(np.float32),
    "tiny_differences": lambda rng: (rng.standard_normal((9, 9, 9)) * 1e-13).astype(np.float32),
    "empty": lambda rng: np.ones((6, 7, 8), np.float32),
}


@pytest.mark.parametrize("extractor", ["marching_cubes", "marching_tetrahedra"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_extractors_equal_numpy_bit_for_bit(field, extractor):
    values = FIELDS[field](np.random.default_rng(len(field)))
    v_ref, f_ref = getattr(jax_mc, extractor)(values, 0.0)
    v, f = getattr(port_mc, extractor)(torch.from_numpy(values), 0.0)
    assert v.dtype == torch.float32 and f.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy().view(np.int32), v_ref.view(np.int32))
    np.testing.assert_array_equal(f.numpy(), f_ref)
    if field != "empty":
        assert len(f_ref) > 0


@pytest.mark.parametrize("iso", [0.25, -0.5])
def test_marching_cubes_at_another_iso_equals_numpy(iso):
    values = FIELDS["random_cube"](np.random.default_rng(1))
    for name in ("marching_cubes", "marching_tetrahedra"):
        v_ref, f_ref = getattr(jax_mc, name)(values, iso)
        v, f = getattr(port_mc, name)(values, iso)
        np.testing.assert_array_equal(v.numpy().view(np.int32), v_ref.view(np.int32))
        np.testing.assert_array_equal(f.numpy(), f_ref)


def test_vertex_interpolation_is_one_rounding_as_numpys_f64():
    """numpy forms p_a + t·(p_b − p_a) with p_a int64 and t f32, so in f64,
    then rounds to f32; the port forms it in f32. With p_b − p_a in {−1, 0,
    1} the f32 product is exact and both round the exact p_a ± t once:
    equal on every t in [0, 1] and p_a up to 512, including f32 ties."""
    rng = np.random.default_rng(0)
    t = np.concatenate([rng.random(200000, dtype=np.float32),
                        np.float32(2.0) ** -np.arange(1, 40, dtype=np.float32),
                        1 - np.float32(2.0) ** -np.arange(1, 24, dtype=np.float32),
                        np.array([0, 1], np.float32)])
    pa = rng.integers(0, 513, t.shape[0])
    for step in (-1, 0, 1):
        ref = (pa + t.astype(np.float64) * step).astype(np.float32)
        got = (torch.from_numpy(pa).to(torch.float32)
               + torch.from_numpy(t) * torch.full(t.shape, float(step))).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_shared_edges_can_disagree_so_the_weld_keeps_the_first_emission():
    """Two cells sharing an edge may walk it in opposite directions (the
    tables' edges 2-3, 3-0, 6-7 and 7-4 run against the axes), and p_a ± t
    then differs in the last bit between them. So the weld takes each
    key's position from its first emission (``np.unique``'s
    return_index), not from any duplicate."""
    ours = port_mc._tables("cpu")
    step = (ours["corners"][ours["edge_b"]] - ours["corners"][ours["edge_a"]]).sum(-1)
    assert sorted(step.tolist()) == [-1] * 4 + [1] * 8
    rng = np.random.default_rng(1)
    va = rng.uniform(0.01, 1, 10000).astype(np.float32)
    vb = -rng.uniform(0.01, 1, 10000).astype(np.float32)
    t_fwd = (np.float32(0) - va) / (vb - va)
    t_bwd = (np.float32(0) - vb) / (va - vb)
    pa = rng.integers(0, 256, 10000).astype(np.float32)
    differ = (pa + t_fwd) != (pa + 1 - t_bwd)
    assert 0 < differ.mean() < 0.5


def test_case_tables_equal_the_jax_packages():
    assert port_mc._MC_CASES == jax_mc._MC_CASES
    assert port_mc._CASE_TRIS == jax_mc._CASE_TRIS
    assert port_mc.MC_MAX_TRIS == jax_mc.MC_MAX_TRIS


@pytest.mark.parametrize("box", [((0, 0, 0), (1, 1, 1)), ((-0.5, 0.1, 0.2), (1.5, 0.9, 0.7)),
                                 ((0.1, 0.2, 0.3), (0.35, 0.95, 0.4))])
@pytest.mark.parametrize("res", [16, 100, 256])
def test_get_marching_cubes_res_equals_jax(box, res):
    np.testing.assert_array_equal(port_mc.get_marching_cubes_res(res, *box),
                                  jax_mc.get_marching_cubes_res(res, *box))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 7)])
def test_png_sheet_pixels_equal_the_jax_sheet(tmp_path, shape, flip):
    """The sheet decoded from both files (the PNG encoders differ: the JAX
    package writes through imageio)."""
    import imageio.v2 as imageio

    d = np.random.default_rng(3).uniform(-3, 9, shape).astype(np.float32)
    jax_mc.save_density_grid_to_png(d, tmp_path / "j.png", thresh=2.5, density_range=4.0,
                                    flip_y_and_z_axes=flip)
    port_mc.save_density_grid_to_png(torch.from_numpy(d), tmp_path / "p.png", thresh=2.5,
                                     density_range=4.0, flip_y_and_z_axes=flip)
    ref = imageio.imread(tmp_path / "j.png")
    got = read_png(tmp_path / "p.png")
    got = got[..., 0] if got.ndim == 3 else got
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
