"""Fused bias-free MLP forward (port of the Pallas kernel
``instant_ngp_tpu/ops/pallas/mlp_kernel.py::fused_mlp``).

Contract, as ``MLP.__call__`` in the JAX package: a bf16 input and bf16
weights, f32 accumulation, each hidden activation rounded back to bf16, an
f32 output. On CUDA tensors ``fused_mlp`` launches kernel B
(``csrc/mlp.cu``), which keeps all weights in shared memory, runs the
products on tensor cores and takes any row count; on CPU tensors it runs
``fused_mlp_plain``. Forward only: the backward comes with the training
slice.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import cuda_lib

ACTIVATIONS = {"none": 0, "relu": 1}
MAX_WIDTH = 64  # widest layer kernel B holds in registers
MAX_LAYERS = 8
ROW_PAD = 8  # padding of each transposed weight row in shared memory (bank spread)


def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    name = name.lower()
    if name == "relu":
        return torch.clamp(h, min=0.0)
    if name == "none":
        return h
    if name in ("sigmoid", "logistic"):
        return torch.sigmoid(h)
    if name == "exponential":
        return torch.exp(h)
    raise NotImplementedError(name)


def fused_mlp_plain(ws: Sequence[torch.Tensor], x: torch.Tensor, activation: str = "relu",
                    output_activation: str = "none") -> torch.Tensor:
    """x (N, in), ws (in, out) each → (N, out) f32. Products of two bf16
    values are exact in f32, so only the order of the f32 sums differs
    from a bf16 matrix unit."""
    h = x.to(torch.bfloat16).float()
    for i, w in enumerate(ws):
        h = h @ w.to(torch.bfloat16).float()
        if i < len(ws) - 1:
            h = _act(activation, h).to(torch.bfloat16).float()
    return _act(output_activation, h)


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def fused_mlp(ws: Sequence[torch.Tensor], x: torch.Tensor, activation: str = "relu",
              output_activation: str = "none") -> torch.Tensor:
    """Forward through a bias-free MLP. CPU tensors run the plain version;
    CUDA tensors launch kernel B (activations relu and none, widths ≤ 64)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(ws, x, activation, output_activation)
    act, out_act = activation.lower(), output_activation.lower()
    if act not in ACTIVATIONS or out_act not in ACTIVATIONS:
        raise NotImplementedError(f"kernel B takes relu/none, got {activation}/{output_activation}")
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    if x.ndim != 2 or x.shape[1] != dims[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match the first layer {dims[0]}")
    if max(dims) > MAX_WIDTH or len(ws) > MAX_LAYERS:
        raise ValueError(f"kernel B takes widths ≤ {MAX_WIDTH} and ≤ {MAX_LAYERS} layers, got {dims}")
    # widths padded to multiples of 16 with zeros (the mma tile); each
    # layer stored transposed (out, in) with ROW_PAD extra values per row,
    # the shared-memory layout kernel B reads its B fragments from
    pdims = [_pad16(v) for v in dims]
    w_flat = torch.cat([
        F.pad(w.to(torch.bfloat16).T,
              (0, pdims[i] + ROW_PAD - w.shape[0], 0, pdims[i + 1] - w.shape[1])).reshape(-1)
        for i, w in enumerate(ws)
    ]).contiguous()
    xb = F.pad(x.to(torch.bfloat16), (0, pdims[0] - dims[0])).contiguous()
    cuda_lib.check_cuda(xb, w_flat, dtype=torch.bfloat16)
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    dims_c = (ctypes.c_int * len(pdims))(*pdims)
    if n > 0:
        cuda_lib.launch("fused_mlp", xb.data_ptr(), w_flat.data_ptr(), ctypes.addressof(dims_c),
                        len(ws), dims[-1], ACTIVATIONS[act], ACTIVATIONS[out_act], n,
                        out.data_ptr())
    return out
