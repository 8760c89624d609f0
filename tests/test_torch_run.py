"""``python -m instant_ngp_torch.run`` against ``scripts/run.py``, on the CPU.

``scripts/run.py`` runs as a subprocess under ``JAX_PLATFORMS=cpu``; the
port's ``run.main([..., "--device", "cpu"])`` runs in this process. On the
tiny snapshot and a scene of its own cameras (seeded 16² images; the
evaluation against ``scripts/run.py`` takes one view, ~60 s of its ray
generation's compiles on the CPU): the printed PSNR, SSIM and ꟻLIP agree to
the last printed digit (the renders agree at tests/test_torch_render.py's 45
dB), and the screenshot PNG within one 8-bit step. Then: the flags and their defaults, a 3-step
training run whose snapshot the JAX Testbed loads, the RFL modes' schedule
against ``scripts/run.py``'s, and a run in a child
process (with a mesh export) that imports neither jax nor the JAX package.
``--save_mesh`` against the JAX package is tests/test_torch_mesh_export.py's."""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import run
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.io.nerf_loader import load_nerf
from instant_ngp_torch.io.png import read_png, write_png
from instant_ngp_torch.models.nerf_network import params_to_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
VIEW = re.compile(r"view (\d+): psnr=(\S+) ssim=(\S+) flip=(\S+)")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A transforms.json of the tiny snapshot's two cameras (its scale,
    offset and intrinsics) and seeded RGBA images, with a tiny network config."""
    out = tmp_path_factory.mktemp("run")
    tb = port_testbed.Testbed(device="cpu")
    tb.load_snapshot(TINY)
    ds = tb.nerf_dataset
    w, h = ds.resolution
    rng = np.random.default_rng(0)
    frames = []
    for i in range(ds.n_images):
        write_png(out / f"v{i}.png", rng.integers(0, 256, (h, w, 4), np.uint8))
        m = np.eye(4)
        m[:3] = ds.ngp_matrix_to_nerf(ds.xforms_start[i])
        frames.append({"file_path": f"v{i}.png", "transform_matrix": m.tolist()})
    fl, pp = ds.focal_lengths[0], ds.principal_points[0]
    meta = {"fl_x": float(fl[0]), "fl_y": float(fl[1]), "cx": float(pp[0] * w),
            "cy": float(pp[1] * h), "w": w, "h": h, "scale": ds.scale,
            "offset": [float(v) for v in ds.offset], "aabb_scale": ds.aabb_scale,
            "frames": frames}
    (out / "transforms.json").write_text(json.dumps(meta))
    # the comparison's views: scripts/run.py compiles its ray generation
    # anew for every sample it renders with given intrinsics (~5 s on the
    # CPU), so the evaluation against it takes one view
    (out / "view1.json").write_text(json.dumps({**meta, "frames": frames[1:]}))
    np.testing.assert_allclose(load_nerf(out / "transforms.json").xforms_start, ds.xforms_start,
                               atol=1e-6)
    (out / "tiny.json").write_text(json.dumps(graft._tiny_nerf_config()))
    return out


def _views(text: str) -> list[tuple[float, ...]]:
    return [tuple(float(v) for v in m.groups()) for m in VIEW.finditer(text)]


def test_evaluation_and_screenshots_match_scripts_run(scene, tmp_path, capsys):
    transforms = str(scene / "view1.json")
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "run.py"), "--load_snapshot", str(TINY),
         "--n_steps", "0", "--test_transforms", transforms, "--screenshot_transforms",
         transforms, "--screenshot_dir", str(tmp_path / "jax")],
        cwd=tmp_path, env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=900)
    assert ref.returncode == 0, ref.stderr[-3000:]
    run.main(["--load_snapshot", str(TINY), "--n_steps", "0", "--test_transforms", transforms,
              "--screenshot_transforms", transforms, "--screenshot_dir", str(tmp_path / "port"),
              "--device", "cpu"])
    ours = capsys.readouterr().out
    theirs, mine = _views(ref.stdout), _views(ours)
    assert len(mine) == len(theirs) == 1
    (i, p, s, f), (j, q, t, g) = mine[0], theirs[0]
    assert i == j and abs(p - q) <= 0.01 and abs(s - t) <= 0.001 and abs(f - g) <= 0.0001
    assert re.search(r"^PSNR=\S+ \[min=\S+ max=\S+\] SSIM=\S+ FLIP=\S+$", ours, re.M)
    a = read_png(tmp_path / "port" / "0000.png").astype(int)
    b = read_png(tmp_path / "jax" / "0000.png").astype(int)
    assert a.shape == b.shape == (16, 16, 3) and np.abs(a - b).max() <= 1
    assert f"wrote {tmp_path / 'port' / '0000.png'}" in ours


def test_training_run_saves_a_snapshot_the_jax_testbed_loads(scene, tmp_path, capsys):
    snap = tmp_path / "trained.ingp"
    run.main(["--scene", str(scene), "--network", str(scene / "tiny.json"), "--n_steps", "3",
              "--batch_size", str(1 << 12), "--save_snapshot", str(snap), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "training 3 steps..."
    assert re.fullmatch(r"trained in \S+s final loss=\S+", out[1])
    assert np.isfinite(float(out[1].rsplit("=", 1)[1]))
    assert out[2] == f"saved snapshot {snap}"
    theirs = JaxTestbed()
    theirs.load_snapshot(str(snap))
    ours = port_testbed.Testbed(device="cpu")
    ours.load_snapshot(snap)
    assert theirs.task.training_step == ours.task.training_step == 3
    for a, b in zip(jax.tree.leaves(params_to_numpy(ours.task.model)),
                    jax.tree.leaves(theirs.task.state.params)):
        assert np.array_equal(a, np.asarray(b))


def _scripts_run_modes(monkeypatch, argv) -> list[str]:
    """The train mode of every frame that ``scripts/run.py``'s main loop
    asks for, on a Testbed stand-in that records ``task.train_mode`` at each
    ``frame()``."""
    import types

    spec = importlib.util.spec_from_file_location("scripts_run", ROOT / "scripts" / "run.py")
    scripts_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scripts_run)
    made = []

    class Recorder:
        def __init__(self):
            self.training_step, self.loss, self.mode = 0, 0.0, None
            self.task = types.SimpleNamespace(train_mode="nerf")
            self.modes = []
            made.append(self)

        def reload_network_from_file(self, path):
            pass

        def load_training_data(self, path):
            pass

        def frame(self):
            self.modes.append(self.task.train_mode)
            self.training_step += 1

    monkeypatch.setattr(scripts_run, "ngp", types.SimpleNamespace(
        Testbed=Recorder, TestbedMode=scripts_run.ngp.TestbedMode))
    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    scripts_run.main()
    return made[0].modes


@pytest.mark.parametrize("flags", [["--train_mode", "rfl", "--rfl_warmup_steps", "2"],
                                   ["--train_mode", "rflrelax", "--rflrelax_begin_step", "1",
                                    "--rflrelax_end_step", "3"]],
                         ids=["rfl", "rflrelax"])
def test_flags_of_later_slices_exit_before_anything_loads(flags, scene, monkeypatch, capsys):
    """The train-mode flags, which exited before anything loaded while the
    RFL modes waited for their slice, now train: a 5-step run on the scene
    whose printed mode switches (``train_mode=<mode> from step <n>``) are
    the schedule ``scripts/run.py``'s loop sets, frame by frame, and whose
    loss stays finite."""
    argv = ["--scene", str(scene), "--network", str(scene / "tiny.json"), "--n_steps", "5",
            "--batch_size", str(1 << 12), *flags]
    run.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    switches = [(m, int(n)) for m, n in re.findall(r"^train_mode=(\w+) from step (\d+)$", out,
                                                   re.M)]
    theirs = _scripts_run_modes(monkeypatch, argv)
    capsys.readouterr()
    want = [(m, i) for i, m in enumerate(theirs) if i == 0 or theirs[i - 1] != m]
    assert len(theirs) == 5 and len(want) >= 2 and switches == want
    assert np.isfinite(float(re.search(r"final loss=(\S+)", out).group(1)))


def test_flags_and_defaults_are_scripts_run_s(monkeypatch, capsys):
    source = (ROOT / "scripts" / "run.py").read_text()
    flags = set(re.findall(r'add_argument\(\s*"(--\w+)"(?:, "(--\w+)")?', source))
    names = {f for pair in flags for f in pair if f}
    assert len(re.findall(r"add_argument\(", source)) == 30
    with pytest.raises(SystemExit):
        run.parse_args(["--help"])
    listed = set(re.findall(r"(--\w+)", capsys.readouterr().out))
    assert names | {"--device", "--help"} == listed
    spec = importlib.util.spec_from_file_location("scripts_run", ROOT / "scripts" / "run.py")
    scripts_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scripts_run)
    monkeypatch.setattr(sys, "argv", ["run.py"])
    ours = vars(run.parse_args([]))
    assert ours.pop("device") == "cuda"  # the card unless asked otherwise
    assert ours == vars(scripts_run.parse_args())


def test_run_imports_neither_jax_nor_the_jax_package(scene, tmp_path):
    """A run that evaluates, exports an optimised mesh (its modules:
    geometry/marching_cubes.py, geometry/mesh_io.py) and renders imports
    neither jax nor the JAX package."""
    mesh = tmp_path / "mesh.ply"
    code = (
        "import runpy, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.argv = ['run', '--load_snapshot', {str(TINY)!r}, '--n_steps', '0',\n"
        f"            '--test_transforms', {str(scene / 'transforms.json')!r}, '--device', 'cpu',\n"
        f"            '--save_mesh', {str(mesh)!r}, '--marching_cubes_res', '16',\n"
        "            '--optimize_mesh_steps', '2']\n"
        "runpy.run_module('instant_ngp_torch.run', run_name='__main__', alter_sys=True)\n"
        "import instant_ngp_torch.geometry.marching_cubes, instant_ngp_torch.geometry.mesh_io\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'instant_ngp_tpu')"
        " or m == 'pyngp']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "clean" and "PSNR=" in proc.stdout
    assert f"saved mesh {mesh}" in proc.stdout and mesh.exists()
