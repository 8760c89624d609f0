"""One rank of ``test_torch_sharding.py``'s two-process gloo group (no JAX
here): the toy loss through the port's ``dp_value_and_grad``, a ``dp_render``
frame and a slab frame with the group as ``task.mesh`` after one unsharded
step of the dry run's tiny NeRF, then one sharded step. Rank 0 writes what
it got to ``<out>/rank0.npz``.

    python tests/torch_sharding_worker.py INIT WORLD RANK INPUTS.npz OUT_DIR
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from instant_ngp_torch.parallel import sharding  # noqa: E402
from instant_ngp_torch.parallel.dryrun import tiny_task  # noqa: E402

COMPACT = 192  # the step's sample capacity: below its 256 valid samples, inside rank 1's share


def toy_loss(params, batch):
    """tests/test_sharding.py's toy loss."""
    pred = torch.tanh(batch["x"] @ params[0]) @ params[1]
    return torch.mean((pred - batch["y"]) ** 2)


def nerf_run(task, group, inputs):
    """One unsharded step, the frames (through ``group`` where given), then
    one more step (sharded where ``group`` is given)."""
    task.compact_samples = COMPACT
    task.train(1)
    o, d = (torch.from_numpy(inputs[k]) for k in ("o", "d"))
    render = lambda a, b: task._render_rays(a, b)[:3]  # noqa: E731
    if group is not None:
        render = sharding.dp_render(render, group)
    rgb, alpha, depth = render(o, d)
    task.mesh = group
    task.slab_res0, task.slab_res_outer = 32, 16
    slab = task.render(16, 16, task.dataset.xforms_start[0], focal_length=(20.0, 20.0),
                       render_quality="slab")
    loss = task.train(1)
    out = {"rgb": rgb, "alpha": alpha, "depth": depth, "slab": slab,
           "loss": np.float32(loss),
           "measured": task.last_stats["measured_samples"],
           "error_map": task.state.error_map}
    for i, p in enumerate(task.model.param_list()):
        out[f"param{i}"] = p
        out[f"moment{i}"] = task.state.opt_state["m"][i]  # Adam's m: the gradient's scale
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def main(init, world, rank, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank))
    try:
        group = dist.group.WORLD
        inp = dict(np.load(inputs))
        params = [torch.from_numpy(inp["w"]), torch.from_numpy(inp["v"])]
        batch = {"x": torch.from_numpy(inp["x"]), "y": torch.from_numpy(inp["y"])}
        loss, grads = sharding.dp_value_and_grad(toy_loss, group)(params, batch)
        out = {"toy_loss": loss.numpy(), "toy_dw": grads[0].numpy(), "toy_dv": grads[1].numpy()}
        task = tiny_task(int(world), torch.device("cpu"))
        out.update(nerf_run(task, group, inp))
        if int(rank) == 0:
            np.savez(Path(out_dir) / "rank0.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
