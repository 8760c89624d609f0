"""The port's web viewer, headless on the CPU: ``orbit_matrix`` against the
JAX package's, and the server on a free port in a thread over a CPU Testbed
holding ``tests/fixtures/tiny_nerf.ingp``: /api/state, a setting applied, a
camera-path add, scrub and remove, a snapshot saved, and a PNG frame decoded
and held against the JAX ``ViewerServer.render_image`` of the same view
(≥ 45 dB); a JPEG request without PIL raises."""

import json
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from instant_ngp_tpu import testbed as jax_testbed
from instant_ngp_tpu import viewer as jax_viewer
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch import viewer
from instant_ngp_torch.io.png import decode_png

torch.set_num_threads(2)

TINY = Path(__file__).resolve().parent / "fixtures" / "tiny_nerf.ingp"
W, H = 32, 24
MIN_PSNR = 45.0


@pytest.mark.parametrize("theta,phi,radius", [(0.0, 0.3, 2.0), (1.3, -0.7, 0.9),
                                               (-2.5, 1.5, 4.0), (0.4, np.pi / 2, 1.0)])
def test_orbit_matrix_equals_jax(theta, phi, radius):
    np.testing.assert_array_equal(viewer.orbit_matrix(theta, phi, radius),
                                  jax_viewer.orbit_matrix(theta, phi, radius))


@pytest.fixture(scope="module")
def served():
    """The port's viewer over a CPU Testbed on the tiny snapshot, serving
    from a thread on a free port of 127.0.0.1."""
    tb = port_testbed.Testbed(device="cpu")
    tb.load_snapshot(TINY)
    tb.shall_train = False
    v = viewer.ViewerServer(tb, port=0, host="127.0.0.1")
    server = v.make_server()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield v, base
    server.shutdown()
    server.server_close()
    thread.join(10)


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers, r.read()


def _json(url):
    status, _, body = _get(url)
    assert status == 200
    return json.loads(body)


def test_state_and_settings(served):
    v, base = served
    state = _json(base + "/api/state")
    assert state["step"] == v.testbed.training_step
    assert state["render_quality"] == "exact" and state["render_mode"] == "shade"
    applied = _json(base + "/api/set?exposure=0.5&fov=40&render_mode=depth")
    assert applied == {"exposure": 0.5, "fov": 40.0, "render_mode": "depth"}
    state = _json(base + "/api/state")
    assert (state["exposure"], state["fov"], state["render_mode"]) == (0.5, 40.0, "depth")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/set?render_quality=best")
    assert e.value.code == 400
    _json(base + "/api/set?exposure=0&fov=50.625&render_mode=shade")
    assert _json(base + "/api/level_stats")[0]["resolution"] > 0
    status, headers, page = _get(base + "/")
    assert status == 200 and b"instant-ngp-torch" in page


def test_camera_path_add_scrub_remove(served):
    v, base = served
    p = _json(base + "/api/path_add?theta=0&phi=0.3&r=2")
    p = _json(base + "/api/path_add?theta=1.0&phi=0.2&r=1.5")
    assert p["n"] == 2 and [k["timestamp"] for k in p["keyframes"]] == [0.5, 1.0]
    _, headers, a = _get(base + f"/screenshot?w={W}&h={H}&path_t=0")
    _, _, b = _get(base + f"/screenshot?w={W}&h={H}&path_t=1")
    assert headers["Content-Type"] == "image/png"
    assert decode_png(a).shape == (H, W, 3) and a != b
    # the keys are the orbit's cameras, and a scrub renders the path's camera
    np.testing.assert_allclose(p["keyframes"][1]["T"], viewer.orbit_matrix(1.0, 0.2, 1.5)[:, 3],
                               atol=1e-6)
    kf = v.testbed.camera_path.eval_camera_path(0.75)
    np.testing.assert_array_equal(v.camera(0.0, 0.0, 1.0, path_t=0.75),
                                  np.asarray(kf.to_matrix(), np.float32))
    assert _json(base + "/api/path_remove?i=0")["n"] == 1
    assert _json(base + "/api/path_clear")["n"] == 0


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def test_snapshot_saved(served, tmp_path, monkeypatch):
    v, base = served
    monkeypatch.chdir(tmp_path)
    path = _json(base + "/api/save_snapshot")["path"]
    assert (tmp_path / path).stat().st_size > 0
    tb = port_testbed.Testbed(device="cpu")
    tb.load_snapshot(tmp_path / path)
    assert tb.training_step == v.testbed.training_step


def test_png_frame_equals_jax_viewer(served):
    """/screenshot's PNG against the JAX viewer's ``render_image`` (PIL's
    PNG) of the same orbit view on the same snapshot."""
    v, base = served
    _, _, body = _get(base + f"/screenshot?w={W}&h={H}&theta=0.5&phi=0.2&r=1.8")
    ours = decode_png(body).astype(np.float64) / 255.0
    tb = jax_testbed.Testbed()
    tb.load_snapshot(str(TINY))
    from PIL import Image
    import io

    theirs = jax_viewer.ViewerServer(tb).render_image(0.5, 0.2, 1.8, W, H, fmt="PNG")
    theirs = np.asarray(Image.open(io.BytesIO(theirs)).convert("RGB"), np.float64) / 255.0
    assert ours.shape == theirs.shape == (H, W, 3)
    assert ours.std() > 0
    assert _psnr(ours, theirs) >= MIN_PSNR


def test_jpeg_without_pil_raises(served, monkeypatch):
    """A JPEG frame needs PIL; without it the request raises rather than
    sending a PNG."""
    v, _ = served
    frame = np.zeros((4, 4, 4), np.float32)
    assert viewer.encode_frame(frame, "JPEG")[:2] == b"\xff\xd8"
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        viewer.encode_frame(frame, "JPEG")
    with pytest.raises(ImportError):
        v.render_image(0.0, 0.3, 2.0, 8, 8, fmt="JPEG")
