"""Fused bias-free MLP, forward and backward (port of the Pallas kernel
``instant_ngp_tpu/ops/pallas/mlp_kernel.py::fused_mlp`` and of the
autodiff backward it gets from ``_reference_forward``).

Forward contract, as ``MLP.__call__`` in the JAX package: a bf16 input and
bf16 weights, f32 accumulation, each hidden activation rounded back to
bf16, an f32 output. On CUDA tensors ``fused_mlp`` launches kernel B
(``csrc/mlp.cu``), which keeps all weights in shared memory, runs the
products on tensor cores and takes any row count; on CPU tensors it runs
``fused_mlp_plain``.

Backward contract, as JAX's vjp of ``MLP.__call__``: every product takes
the f32 cotangent against a bf16 operand with f32 accumulation, and each
result (dh per layer, every dW, dX) is rounded to bf16; the ReLU mask
comes from the f32 pre-activation and is 0.5 where it is exactly 0 (the
derivative of ``jnp.maximum`` at a tie). ``fused_mlp_bwd`` launches
kernel F (``csrc/mlp_bwd.cu``) on CUDA tensors and runs
``fused_mlp_bwd_plain`` on CPU tensors. Kernel F runs every product on
bf16 tensor cores: every inner cotangent is a bf16 value, and g enters as
the three bf16 terms of ``split_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
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


def _act_grad(name: str, z: torch.Tensor) -> torch.Tensor:
    """d act / d z at the f32 pre-activation z, as JAX differentiates it."""
    name = name.lower()
    if name == "relu":
        return torch.where(z > 0.0, 1.0, torch.where(z == 0.0, 0.5, 0.0))
    if name == "none":
        return torch.ones_like(z)
    raise NotImplementedError(name)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def fused_mlp_bwd_plain(ws: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                        activation: str = "relu", output_activation: str = "none"):
    """Backward of ``fused_mlp_plain``: x (N, in), g (N, out) f32 cotangent
    → (dx (N, in) f32, [dW (in, out) f32 per layer]), each value
    bf16-representable. The hidden activations are recomputed."""
    wb = [_bf16(w) for w in ws]
    hs = [_bf16(x)]
    zs = []
    for i, w in enumerate(wb):
        z = hs[-1] @ w
        zs.append(z)
        if i < len(wb) - 1:
            hs.append(_bf16(_act(activation, z)))
    dz = g.float() * _act_grad(output_activation, zs[-1])
    dws = [None] * len(wb)
    dx = None
    for i in reversed(range(len(wb))):
        dws[i] = _bf16(hs[i].T @ dz)
        dh = _bf16(dz @ wb[i].T)
        if i > 0:
            dz = dh * _act_grad(activation, zs[i - 1])
        else:
            dx = dh
    return dx, dws


def split_bf16(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g as three bf16 terms (hi, mid, lo), f32 tensors: hi = bf16(g), mid
    = bf16(g − hi), lo = g − hi − mid. f32 has 24 significant bits and bf16
    8, so hi + mid + lo is g exactly; kernel F feeds the f32 output
    cotangent to its bf16 products this way."""
    g = g.float()
    hi = _bf16(g)
    mid = _bf16(g - hi)
    return hi, mid, g - hi - mid


def fused_mlp_bwd(ws: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                  activation: str = "relu", output_activation: str = "none"):
    """See ``fused_mlp_bwd_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel F (hidden activations relu/none, output none,
    widths ≤ 64), whose f32 dW sums are rounded to bf16 here."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(ws, x, g, activation, output_activation)
    act, out_act = activation.lower(), output_activation.lower()
    if act not in ACTIVATIONS or out_act != "none":
        raise NotImplementedError(f"kernel F takes relu/none hidden and none output, got "
                                  f"{activation}/{output_activation}")
    dims = (ws[0].shape[0], *[w.shape[1] for w in ws])
    n = x.shape[0]
    if x.ndim != 2 or x.shape[1] != dims[0] or tuple(g.shape) != (n, dims[-1]):
        raise ValueError(f"x {tuple(x.shape)}, g {tuple(g.shape)} do not match layers {dims}")
    if max(dims) > MAX_WIDTH or len(ws) > MAX_LAYERS:
        raise ValueError(f"kernel F takes widths ≤ {MAX_WIDTH} and ≤ {MAX_LAYERS} layers, "
                         f"got {dims}")
    # the kernel rounds x and the weights to bf16 and lays the weights out
    # itself: one launch and no copies (a small backward is bound by its
    # host overhead)
    wf = [w.to(torch.float32).contiguous() for w in ws]
    xf = x.to(torch.float32).contiguous()
    gf = g.to(torch.float32).contiguous()
    cuda_lib.check_cuda(xf, gf, *wf, dtype=torch.float32)
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=x.device)
    dw_flat = torch.zeros((sum(w.numel() for w in ws),), dtype=torch.float32, device=x.device)
    if n > 0:
        w_ptrs = (ctypes.c_void_p * len(wf))(*[w.data_ptr() for w in wf])
        cuda_lib.launch("fused_mlp_bwd", xf.data_ptr(), ctypes.addressof(w_ptrs), gf.data_ptr(),
                        ctypes.addressof(_dims_c(dims)), len(ws), ACTIVATIONS[act], n,
                        dx.data_ptr(), dw_flat.data_ptr())
    dws = [d.reshape(w.shape)
           for d, w in zip(torch.split(_bf16(dw_flat), [w.numel() for w in ws]), ws)]
    return dx, dws


@functools.lru_cache(maxsize=None)
def _dims_c(dims) -> ctypes.Array:
    """The widths as a host int array for a launch, one per shape (kept, so
    that a launch does not build it anew)."""
    return (ctypes.c_int * len(dims))(*dims)


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
