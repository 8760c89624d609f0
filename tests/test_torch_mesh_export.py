"""Mesh export of the port against the JAX package's, on the CPU:
``extract_mesh`` on the fox snapshot (NeRF) and on a small SDF trained by the
JAX package, ``optimise_mesh``, the OBJ/PLY writers byte for byte, and
``run --save_mesh``. The NeRF meshes are taken at res 32: the field is
sampled on the unit cube in model coordinates, as the JAX package samples
it, and fox's surface at density 2.5 lies there (the tiny snapshot's
untrained density stays near 1)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.geometry import marching_cubes as jax_mc
from instant_ngp_tpu.geometry import mesh_io as jax_io
from instant_ngp_tpu.sdf.task import SdfTask as JaxSdfTask
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import run
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.geometry import marching_cubes as port_mc
from instant_ngp_torch.geometry import mesh_io as port_io
from instant_ngp_torch.geometry.procedural import bumpy_torus
from instant_ngp_torch.models.network import params_from_jax
from instant_ngp_torch.sdf.task import SdfTask

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FOX = ROOT / "data" / "fox_1536.ingp"
RES = 32
COLOR_TOL = 4e-3
SDF_CONFIG = {"loss": {"otype": "Mape"},
              "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
                            "epsilon": 1e-15, "l2_reg": 1e-6},
              "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                           "log2_hashmap_size": 14, "base_resolution": 8},
              "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                          "output_activation": "None", "n_neurons": 32, "n_hidden_layers": 2}}


@pytest.fixture(scope="module")
def fox():
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(FOX)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(FOX))
    return ours.task, theirs.task


def _jax_nerf_field(task, res):
    """The field of the JAX package's extract_mesh (marching_cubes.py:408-422)."""
    xs = (np.arange(res) + 0.5) / res
    g = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack(g, -1).reshape(-1, 3).astype(np.float32)
    params = task.opt.inference_params(task.state.opt_state, task.state.params)
    vals = np.asarray(task.model.density(params, jnp.asarray(pts))[:, 0], np.float32)
    return 2.5 - np.exp(np.clip(vals, -15, 15)).reshape(res, res, res)


def test_extract_mesh_on_fox_matches_jax(fox):
    """The field within bf16 tolerance of JAX's (rtol 2e-2 of the density:
    both run the density network in bf16; 1.8e-6 of the largest density
    measured); JAX's own field through the port's marching cubes bit for
    bit JAX's mesh; the port's whole extraction the same topology here, its
    vertices within 2 % of a voxel (an edge between two near-equal values
    moves its vertex most: 1 % measured). Colours at JAX's vertices within
    4e-3 (the bf16 networks: 1.7e-3 measured); at the port's own, within
    that on ≥ 99 % of vertices (a moved vertex reads fox's finest levels
    elsewhere: 0.3 % differ more, measured)."""
    ours, theirs = fox
    field, iso = port_mc.sample_field(ours, RES)
    ref_field = _jax_nerf_field(theirs, RES)
    assert iso == 2.5
    np.testing.assert_allclose(2.5 - field.numpy(), 2.5 - ref_field, rtol=2e-2, atol=1e-3)
    v_ref, f_ref, c_ref = jax_mc.extract_mesh(theirs, res=RES)
    assert len(f_ref) > 1000
    v, f = port_mc.marching_cubes(torch.from_numpy(ref_field), 0.0)
    np.testing.assert_array_equal(((v + 0.5) / RES).numpy().view(np.int32), v_ref.view(np.int32))
    np.testing.assert_array_equal(f.numpy(), f_ref)
    v, f, c = port_mc.extract_mesh(ours, res=RES)
    assert v.shape == v_ref.shape and np.array_equal(f.numpy(), f_ref)
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=0, atol=0.02 / RES)
    np.testing.assert_allclose(port_mc.mesh_colors(ours, torch.from_numpy(v_ref)).numpy(), c_ref,
                               rtol=0, atol=COLOR_TOL)
    assert np.mean(np.abs(c.numpy() - c_ref).max(-1) <= COLOR_TOL) >= 0.99


def test_extract_mesh_with_tetrahedra_matches_jax(fox):
    ours, theirs = fox
    v_ref, f_ref, _ = jax_mc.extract_mesh(theirs, res=16, method="tets", with_colors=False)
    v, f, c = port_mc.extract_mesh(ours, res=16, method="tets", with_colors=False)
    assert c is None and v.shape == v_ref.shape and np.array_equal(f.numpy(), f_ref)
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def sdf():
    """A bumpy torus SDF the JAX package trains 30 steps; the port task
    takes its inference parameters (the EMA)."""
    v, f = bumpy_torus(48, 24, seed=3)
    theirs = JaxSdfTask(v[f], SDF_CONFIG, batch_size=4096)
    ours = SdfTask(v[f], SDF_CONFIG, device="cpu", batch_size=4096)
    for _ in range(30):
        pts, d = theirs.generate_training_batch()
        theirs.params, theirs.opt_state, _ = theirs._jit_step(theirs.params, theirs.opt_state,
                                                              jnp.asarray(pts), jnp.asarray(d))
    params_from_jax(ours.model, jax.tree.map(np.asarray, theirs.inference_params))
    yield ours, theirs
    theirs.stop_producer()
    ours.stop_producer()


def test_extract_mesh_on_an_sdf_matches_jax(sdf):
    """The distance field within 2e-3 (bf16 hidden layers, f32 sums in
    another order); JAX's field through the port's marching cubes bit for
    bit JAX's mesh; grey vertex colours."""
    ours, theirs = sdf
    res = 24
    field, iso = port_mc.sample_field(ours, res)
    xs = (np.arange(res) + 0.5) / res
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    ref_field = np.asarray(theirs.sdf(pts), np.float32).reshape(res, res, res)
    assert iso == 0.0
    np.testing.assert_allclose(field.numpy(), ref_field, rtol=0, atol=2e-3)
    v_ref, f_ref, _ = jax_mc.extract_mesh(theirs, res=res)
    assert len(f_ref) > 100
    v, f = port_mc.marching_cubes(torch.from_numpy(ref_field), 0.0)
    np.testing.assert_array_equal(((v + 0.5) / res).numpy().view(np.int32), v_ref.view(np.int32))
    np.testing.assert_array_equal(f.numpy(), f_ref)
    v, f, c = port_mc.extract_mesh(ours, res=res)
    assert abs(len(v) - len(v_ref)) <= 0.02 * len(v_ref)
    np.testing.assert_array_equal(c.numpy(), np.full((len(v), 3), 0.7, np.float32))


def test_optimise_mesh_from_jax_vertices_matches_jax(fox):
    """5 steps from JAX's res-32 fox mesh: the port's vertices within 2 %
    of the largest move JAX's make (0.56 % measured: the density gradient
    through bf16 networks, the 1-ring sums in another order)."""
    ours, theirs = fox
    v0, f0, _ = jax_mc.extract_mesh(theirs, res=RES, with_colors=False)
    ref = jax_mc.optimise_mesh(theirs, v0, f0, n_steps=5)
    got = port_mc.optimise_mesh(ours, v0, f0, n_steps=5).numpy()
    moved = np.abs(ref - v0).max()
    assert moved > 1e-4
    assert np.abs(got - ref).max() <= 0.02 * moved


def test_optimise_mesh_pulls_a_sphere_onto_its_isosurface():
    """tests/test_render.py's case on the port: an analytic density ball
    (logit (0.35² − |p − ½|²)·40), its res-20 tetrahedra mesh, 5 steps:
    the mean |σ − 2.5| over the vertices falls by at least 15 %."""
    task = port_testbed.Testbed("nerf", device="cpu")
    task.load_snapshot(ROOT / "tests" / "fixtures" / "tiny_nerf.ingp")
    task = task.task

    def logits(p, params=None):
        d2 = torch.sum((p - 0.5) ** 2, -1, keepdim=True)
        return torch.cat([(0.35 ** 2 - d2) * 40.0, torch.zeros((p.shape[0], 15))], -1)

    task.inference_density = logits
    res = 20
    pts = port_mc._unit_grid(res, "cpu")
    field = 2.5 - torch.exp(torch.clamp(logits(pts)[:, 0], -15, 15)).reshape(res, res, res)
    verts, faces = port_mc.marching_tetrahedra(field, 0.0)
    verts = (verts + 0.5) / res
    assert len(verts) > 100

    def iso_err(v):
        return float(torch.abs(torch.exp(torch.clamp(logits(v)[:, 0], -15, 15)) - 2.5).mean())

    v2 = port_mc.optimise_mesh(task, verts, faces, n_steps=5, thresh=2.5)
    assert torch.isfinite(v2).all()
    assert iso_err(v2) < 0.85 * iso_err(verts)


def test_compute_mesh_1ring_equals_numpy_in_f64():
    """The 1-ring sums by ``index_add_`` against ``np.add.at`` in f64: the
    centroid sums (the same f32 values in another order) within 1e-12; the
    normal sums within 1e-6 of the largest (torch's f32 cross product
    rounds its two products otherwise than numpy's: 4.6e-8 measured)."""
    rng = np.random.default_rng(1)
    v = rng.random((300, 3), dtype=np.float32)
    f = rng.integers(0, 300, (900, 3)).astype(np.int32)
    acc_ref, nrm_ref = jax_mc.compute_mesh_1ring(v, f)
    acc, nrm = port_mc.compute_mesh_1ring(torch.from_numpy(v), torch.from_numpy(f))
    np.testing.assert_allclose(acc.numpy(), acc_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(nrm.numpy(), nrm_ref, rtol=0, atol=1e-6 * np.abs(nrm_ref).max())


@pytest.mark.parametrize("with_colors", [True, False], ids=["colors", "plain"])
@pytest.mark.parametrize("writer", ["save_obj", "save_ply", "save_obj_unwrapped"])
def test_writers_write_the_jax_writers_bytes(tmp_path, writer, with_colors):
    """Each writer's file (and the unwrapped OBJ's .mtl) byte for byte the
    JAX package's, from numpy arrays and from tensors; the texture's pixels
    equal (the PNG encoders differ); the PLY read back."""
    import imageio.v2 as imageio

    from instant_ngp_torch.io.png import read_png

    rng = np.random.default_rng(4)
    v = rng.random((64, 3), dtype=np.float32)
    f = rng.integers(0, 64, (45, 3)).astype(np.int32)
    c = rng.random((64, 3), dtype=np.float32) if with_colors else None
    ext = ".ply" if writer == "save_ply" else ".obj"
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    getattr(jax_io, writer)(str(tmp_path / "j" / f"m{ext}"), v, f, c)
    getattr(port_io, writer)(tmp_path / "p" / f"m{ext}", torch.from_numpy(v), torch.from_numpy(f),
                             None if c is None else torch.from_numpy(c))
    names = [f"m{ext}"] + (["m.mtl"] if writer == "save_obj_unwrapped" else [])
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    if writer == "save_obj_unwrapped":
        np.testing.assert_array_equal(read_png(tmp_path / "p" / "m.png"),
                                      imageio.imread(tmp_path / "j" / "m.png"))
    if writer == "save_ply":
        rv, rf, rc = port_io.read_ply(tmp_path / "p" / "m.ply")
        np.testing.assert_array_equal(rv, v)
        np.testing.assert_array_equal(rf, f)
        assert (rc is None) == (c is None)


@pytest.mark.parametrize("case", ["obj", "ply_optimised"])
def test_run_save_mesh_writes_scripts_run_s_mesh(fox, tmp_path, capsys, case):
    """``run --save_mesh`` on the fox snapshot at res 32 against the JAX
    functions ``scripts/run.py:135-151`` calls: the printed line, the same
    faces, the vertices within 2 % of a voxel (as the extraction's test) and
    2 % of the optimisation's largest move where it ran, and the colours of
    ≥ 99 % of vertices within one 8-bit step (PLY) or 4e-3 (OBJ)."""
    _, theirs = fox
    path = tmp_path / ("mesh.obj" if case == "obj" else "mesh.ply")
    steps = 0 if case == "obj" else 3
    run.main(["--load_snapshot", str(FOX), "--n_steps", "0", "--save_mesh", str(path),
              "--marching_cubes_res", str(RES), "--optimize_mesh_steps", str(steps),
              "--device", "cpu"])
    v_ref, f_ref, c_ref = jax_mc.extract_mesh(theirs, res=RES)
    v0 = v_ref
    if steps:
        v_ref = jax_mc.optimise_mesh(theirs, v_ref, f_ref, n_steps=steps)
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"saved mesh {path} ({len(v_ref)} verts, {len(f_ref)} faces)"
    if case == "obj":
        soup = port_io.load_obj(path)
        np.testing.assert_allclose(soup, v_ref[f_ref], rtol=0, atol=0.02 / RES)
        colors = np.array([[float(t) for t in ln.split()[4:7]] for ln in
                           path.read_text().splitlines() if ln.startswith("v ")], np.float32)
        assert np.mean(np.abs(colors - c_ref).max(-1) <= COLOR_TOL) >= 0.99
    else:
        v, f, c = port_io.read_ply(path)
        np.testing.assert_array_equal(f, f_ref)
        tol = 0.02 / RES + 0.02 * np.abs(v_ref - v0).max()
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=tol)
        c_ref8 = np.clip(c_ref * 255.0 + 0.5, 0, 255).astype(np.uint8)
        assert np.mean(np.abs(c.astype(int) - c_ref8).max(-1) <= 1) >= 0.99
