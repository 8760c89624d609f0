"""The image primitive's building blocks against the JAX package on the CPU:
texture reads, the Halton and Sobol sequences, image files, network
configs and the scene-mode rule."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu import config as jax_config
from instant_ngp_tpu.image_fit import task as jax_task
from instant_ngp_tpu.io import image as jax_image
from instant_ngp_tpu.testbed import mode_from_scene as jax_mode_from_scene
from instant_ngp_torch import config as port_config
from instant_ngp_torch.image_fit import task as port_task
from instant_ngp_torch.io import image as port_image
from instant_ngp_torch.testbed import mode_from_scene

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _uv(rng, w, h):
    """Random positions, pixel centres and corners, and the edges of [0, 1]."""
    edges = np.array([0.0, 1e-7, 0.5 / w, 1.0 - 1e-7, 1.0], np.float32)
    eu, ev = np.meshgrid(edges, edges)
    centers = np.stack([(rng.integers(0, w, 500) + 0.5) / w,
                        (rng.integers(0, h, 500) + 0.5) / h], -1)
    corners = np.stack([rng.integers(0, w + 1, 500) / w, rng.integers(0, h + 1, 500) / h], -1)
    return np.concatenate([rng.random((3000, 2)), np.stack([eu.ravel(), ev.ravel()], -1),
                           centers, corners]).astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 53), (2, 2), (64, 16)])
def test_texture_reads_equal_jax(shape):
    """Both reads against the JAX functions as the jitted step runs them
    (XLA contracts uv * res - 0.5 into one FMA), at the edges and inside."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    tex = rng.random((h, w, 4), dtype=np.float32)
    uv = _uv(rng, w, h)
    table = torch.from_numpy(tex.reshape(h * w, 4))
    ours = port_task.bilinear_read(table, (w, h), torch.from_numpy(uv)).numpy()
    ref = np.asarray(jax.jit(jax_task.bilinear_read)(tex, uv))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    ours = port_task.snapped_read(table, (w, h), torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(jax_task.snapped_read)(tex, uv)))


def test_halton_and_sobol_equal_jax_bit_for_bit():
    """uint32 indices around the wrap, step 0 and late steps."""
    idx = np.concatenate([np.arange(4096), np.arange(2**32 - 2048, 2**32),
                          np.random.default_rng(0).integers(0, 2**32, 4096)]).astype(np.uint32)
    it = torch.from_numpy(idx.astype(np.int64))
    for base in (2, 3):
        ref = np.asarray(jax.jit(lambda i, b=base: jax_task.halton(i, b))(idx))
        np.testing.assert_array_equal(port_task.halton(it, base).numpy(), ref)
    ref0, ref1 = jax.jit(jax_task.sobol2d)(idx)
    x0, x1 = port_task.sobol2d(it)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(ref0))
    np.testing.assert_array_equal(x1.numpy(), np.asarray(ref1))


@pytest.mark.parametrize("suffix", [".exr", ".bin", ".png"])
def test_load_image_reads_jax_files(tmp_path, suffix):
    """Files written by the JAX package's save_image load to equal arrays
    (and to the same is_hdr) in both packages; the port writes what the
    JAX package reads."""
    rng = np.random.default_rng(4)
    img = rng.random((19, 23, 4), dtype=np.float32)
    path = tmp_path / f"img{suffix}"
    jax_image.save_image(path, img)
    ours, ours_hdr = port_image.load_image(path)
    ref, ref_hdr = jax_image.load_image(path)
    assert ours_hdr == ref_hdr
    assert ours.dtype == np.float32 and ours.shape == (19, 23, 4)
    np.testing.assert_array_equal(ours, ref)
    back = tmp_path / f"back{suffix}"
    port_image.save_image(back, ours)
    np.testing.assert_array_equal(jax_image.load_image(back)[0], ref)


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configs" / "image").glob("*.json")))
def test_image_configs_resolve_as_jax(name):
    path = ROOT / "configs" / "image" / name
    assert port_config.load_network_config(path) == jax_config.load_network_config(path)
    assert (port_config.load_network_config(name, mode="image")
            == jax_config.load_network_config(name, mode="image"))


def test_default_config_and_comments_equal_jax(tmp_path):
    assert port_config.default_config("image") == jax_config.default_config("image")
    child = tmp_path / "child.json"
    child.write_text('{\n  "parent": "%s", // the base\n  "loss": {"otype": "L1 // not a '
                     'comment"}\n}\n' % (ROOT / "configs" / "image" / "base.json"))
    assert port_config.load_network_config(child) == jax_config.load_network_config(child)


@pytest.mark.parametrize("path", ["a.exr", "b.BIN", "c.png", "d.jpg", "scene.json", "m.obj",
                                  "v.nvdb", "x.txt"])
def test_mode_from_scene_equals_jax(path):
    assert mode_from_scene(path).value == jax_mode_from_scene(path).value
