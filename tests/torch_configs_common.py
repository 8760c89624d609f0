"""What tests/test_torch_configs_{nerf,image,sdf}.py share: the shipped
configs of a mode, shrunk as tests/test_configs_smoke.py shrinks them (widths
16, ≤ 4 levels, tables ≤ 2^12: the structure, encodings and depths untouched),
and the comparison of one training step's Adam moment and new parameters
with the JAX package's."""

import copy

import jax
import numpy as np

from instant_ngp_tpu.config import CONFIGS_DIR
from instant_ngp_tpu.config import load_network_config as jax_load_network_config
from instant_ngp_torch.config import load_network_config

# The step's gradients, read back from Adam's first moment (m = (1 − β1)·g
# after one step from zero), per leaf against the leaf's largest value: MLP
# matrices at 1e-2 (bf16 compute on both sides: a hidden unit's bf16
# rounding can flip when f32 sums differ in order), encoding tables at 2e-2
# (the JAX package splats dense grid levels in bf16, the port in f32), as
# tests/test_torch_image_task.py holds them.
TOL_GRAD, TOL_TABLE = 1e-2, 2e-2
# New parameters where the moment is not tiny (|m| > 1e-3 of the leaf's
# largest): Adam's first step moves each by ~lr·sign(g), within 1e-3 of lr.
TOL_STEP = 1e-3


def config_names(mode: str) -> list[str]:
    return sorted(p.name for p in (CONFIGS_DIR / mode).glob("*.json"))


def shrink(cfg: dict) -> dict:
    """tests/test_configs_smoke.py's ``_shrink``."""
    def rec(d):
        if isinstance(d, dict):
            for k, v in d.items():
                if k == "log2_hashmap_size":
                    d[k] = min(int(v), 12)
                elif k == "n_levels":
                    d[k] = min(int(v), 4)
                elif k == "n_neurons":
                    d[k] = min(int(v), 16)
                else:
                    rec(v)
        elif isinstance(d, list):
            for v in d:
                rec(v)
    rec(cfg)
    return cfg


def load_shrunk(mode: str, name: str) -> dict:
    """The config as both packages load it (asserted equal), shrunk."""
    cfg = load_network_config(name, mode=mode)
    assert cfg == jax_load_network_config(name, mode=mode)
    return shrink(copy.deepcopy(cfg))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_step_matches(m_out, m_ref, new_out, new_ref, table_keys, lr: float) -> None:
    """Leaf by leaf (``jax.tree.leaves`` order of the JAX layout trees): the
    port's Adam first moment against the JAX package's, and the new
    parameters where the moment is not tiny. Leaves under ``table_keys`` are
    encoding tables; a key without leaves (a parameter-free encoding's None
    leaves) has nothing to compare."""
    for key in m_ref:
        tol = TOL_TABLE if key in table_keys else TOL_GRAD
        outs, refs = jax.tree.leaves(m_out[key]), jax.tree.leaves(m_ref[key])
        assert len(outs) == len(refs), key
        for out, ref in zip(outs, refs):
            np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())
        for out, ref, m in zip(jax.tree.leaves(new_out[key]), jax.tree.leaves(new_ref[key]), refs):
            big = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(out[big], ref[big], rtol=0, atol=TOL_STEP * lr)
