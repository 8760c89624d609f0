"""Data parallelism over ``torch.distributed`` in the port, on the CPU: two
gloo processes (``torch_sharding_worker.py``) against the unsharded port and
the JAX package.

* tests/test_sharding.py's toy loss through the port's ``dp_value_and_grad``
  against the JAX package's on the conftest's 8-device mesh;
* a ``dp_render`` frame and a slab frame whose warp is pixel-sharded, against
  the unsharded frames (≥ 60 dB);
* one sharded NeRF training step against the unsharded one from the same
  state, with a sample capacity below the step's valid samples (the drop is
  the whole step's): the new parameters within 1e-5 of each leaf's max |ref|,
  the loss, the sample count and the error map;
* ``dryrun_multichip(2)`` ends in its OK line, and the dry run's functions
  default to the card;
* a mesh without a process group raises;
* the MLP backward's ``f32_dw`` (a sharded step's: every rank's f32 dW,
  summed before one rounding): the plain version's and through the MLP's
  autograd Function, and off the CPU both kernel routes (a mocked launch)."""

import inspect
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_tpu.parallel.mesh import make_mesh
from instant_ngp_tpu.parallel.sharding import dp_value_and_grad as jax_dp_value_and_grad
from instant_ngp_tpu.parallel.sharding import replicate as jax_replicate
from instant_ngp_tpu.parallel.sharding import shard_batch as jax_shard_batch
from instant_ngp_torch import cuda_lib
from instant_ngp_torch.ops import mlp_kernel as mk
from instant_ngp_torch.ops.mlp import MLP
from instant_ngp_torch.parallel import dryrun, sharding
from torch_sharding_worker import COMPACT, nerf_run

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
TOL_STEP = 1e-5  # new parameters per leaf, against its max |ref|
MIN_PSNR = 60.0


def _toy_inputs():
    """tests/test_sharding.py's parameters and batch."""
    return {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 16)) * 0.1),
            "v": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, 4)) * 0.1),
            "x": np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64, 8))),
            "y": np.asarray(jax.random.normal(jax.random.PRNGKey(3), (64, 4)))}


def _rays():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([[0.5, 0.5, -0.7]]), (64, 1))
    return {"o": o, "d": d.astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of the two-process run, and the same run unsharded
    in this process."""
    tmp = tmp_path_factory.mktemp("sharding")
    inputs = {**_toy_inputs(), **_rays()}
    np.savez(tmp / "inputs.npz", **inputs)
    init = f"tcp://127.0.0.1:{dryrun.free_port()}"
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_sharding_worker.py"), init, "2",
                               str(r), str(tmp / "inputs.npz"), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    sharded = dict(np.load(tmp / "rank0.npz"))
    plain = nerf_run(dryrun.tiny_task(2, torch.device("cpu")), None, inputs)
    return sharded, plain, inputs


def test_toy_loss_equals_jax_dp_value_and_grad(ranks):
    sharded, _, inputs = ranks
    assert len(jax.devices()) >= 8, "conftest must provision 8 CPU devices"
    mesh = make_mesh(8)

    def loss_fn(params, batch):
        pred = jax.numpy.tanh(batch["x"] @ params["w"]) @ params["v"]
        return jax.numpy.mean((pred - batch["y"]) ** 2)

    params = jax_replicate({"w": inputs["w"], "v": inputs["v"]}, mesh)
    batch = jax_shard_batch({"x": inputs["x"], "y": inputs["y"]}, mesh)
    loss, grads = jax.jit(jax_dp_value_and_grad(loss_fn, mesh))(params, batch)
    np.testing.assert_allclose(sharded["toy_loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(sharded["toy_dw"], grads["w"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sharded["toy_dv"], grads["v"], rtol=1e-4, atol=1e-6)


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.mark.parametrize("what", ["rgb", "slab"])
def test_sharded_frames_equal_unsharded(ranks, what):
    sharded, plain, _ = ranks
    assert sharded[what].shape == plain[what].shape
    assert _psnr(sharded[what], plain[what]) >= MIN_PSNR
    if what == "rgb":
        assert _psnr(sharded["alpha"], plain["alpha"]) >= MIN_PSNR
        assert float(np.abs(plain["alpha"]).max()) > 0


def test_sharded_step_equals_unsharded(ranks):
    sharded, plain, _ = ranks
    assert int(plain["measured"]) > COMPACT  # the capacity drop engaged
    assert int(sharded["measured"]) == int(plain["measured"])
    np.testing.assert_allclose(sharded["loss"], plain["loss"], rtol=1e-5)
    np.testing.assert_allclose(sharded["error_map"], plain["error_map"], rtol=0,
                               atol=1e-5 * np.abs(plain["error_map"]).max())
    keys = sorted(k for k in plain if k.startswith(("param", "moment")))
    assert len(keys) > 8
    for k in keys:
        np.testing.assert_allclose(sharded[k], plain[k], rtol=0,
                                   atol=TOL_STEP * np.abs(plain[k]).max(), err_msg=k)


def test_dryrun_multichip_two_processes(capsys):
    out = dryrun.dryrun_multichip(2, "cpu")
    assert "dryrun_multichip(2) OK: loss=" in out.splitlines()[-1]
    assert "all-reduces in 2 steps" in out


def test_a_mesh_without_a_process_group_raises():
    task = dryrun.tiny_task(1, torch.device("cpu"))
    task.mesh = object()
    with pytest.raises(RuntimeError, match="process group"):
        task.train(1)
    with pytest.raises(RuntimeError, match="process group"):
        sharding.shard_batch(torch.zeros(4), object())


def test_dryrun_defaults_to_the_card():
    """Only a caller who names the CPU gets the gloo run; on a host without
    a card the default raises (no CPU run in its place)."""
    for fn in (dryrun.dryrun_multichip, dryrun.run_worker):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 1 cards"):
            dryrun.dryrun_multichip(1)


@pytest.mark.parametrize("dims", [(32, 64, 64, 3), (72, 128, 128, 16)])
def test_mlp_backward_gives_the_f32_dw_where_asked(dims):
    """``f32_dw``: the plain backward's dW are the f32 sums, dX unchanged,
    and each rounds to bf16 as the default call's dW; the MLP's autograd
    Function hands the same to the weights' gradients."""
    rng = np.random.default_rng(5)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    x = torch.from_numpy(rng.uniform(-1, 1, (256, dims[0])).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((256, dims[-1])).astype(np.float32) / 256)
    dx, dws = mk.fused_mlp_bwd_plain(ws, x, g)
    dx32, dws32 = mk.fused_mlp_bwd_plain(ws, x, g, f32_dw=True)
    assert torch.equal(dx, dx32)
    assert any(not torch.equal(a, b) for a, b in zip(dws, dws32))  # not rounded yet
    assert all(torch.equal(mk._bf16(b), a) for a, b in zip(dws, dws32))
    mlp = MLP(dims[0], dims[-1], dims[1], len(dims) - 2)
    with torch.no_grad():
        for p, w in zip(mlp.weights, ws):
            p.copy_(w)
    for f32_dw, want in ((True, dws32), (False, dws)):
        grads = torch.autograd.grad(mlp(x, f32_dw), list(mlp.weights), grad_outputs=g)
        assert all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("dims,dw_launch", [((32, 64, 64, 3), None),
                                            ((72, 128, 128, 16), "fused_mlp_dw_wide")])
def test_f32_dw_reaches_both_kernel_routes(monkeypatch, dims, dw_launch):
    """Off the CPU (meta tensors, a mocked launch): the wide route's dW
    kernel is told to round (its round_bf16 argument 1) by default and not
    to with ``f32_dw``; the narrow route leaves its f32 sums unrounded."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t, dtype=None: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(cuda_lib, "query", lambda name, *args: 0)
    rounded = []
    monkeypatch.setattr(mk, "_bf16", lambda t: rounded.append(tuple(t.shape)) or t)
    meta = torch.device("meta")
    ws = [torch.zeros(a, b, device=meta) for a, b in zip(dims[:-1], dims[1:])]
    x, g = torch.zeros((64, dims[0]), device=meta), torch.zeros((64, dims[-1]), device=meta)
    try:
        for f32_dw in (False, True):
            calls.clear()
            rounded.clear()
            mk.fused_mlp_bwd(ws, x, g, f32_dw=f32_dw)
            if dw_launch is None:
                assert [name for name, _ in calls] == ["fused_mlp_bwd"]
                assert rounded == ([] if f32_dw else [(sum(w.numel() for w in ws),)])
            else:
                assert [name for name, _ in calls] == ["fused_mlp_bwd_wide", dw_launch]
                assert calls[1][1][-1] == (0 if f32_dw else 1)
                assert rounded == []
    finally:
        mk._wide_sizes.cache_clear()
