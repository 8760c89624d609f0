"""Fused bias-free MLP, forward and backward (port of the Pallas kernel
``instant_ngp_tpu/ops/pallas/mlp_kernel.py::fused_mlp`` and of the
autodiff backward it gets from ``_reference_forward``).

Forward contract, as ``MLP.__call__`` in the JAX package: a bf16 input and
bf16 weights, f32 accumulation, each hidden activation rounded back to
bf16, an f32 output; any widths and depth; relu, none, sigmoid or
exponential as the hidden and the output activation. On CUDA tensors
``fused_mlp`` launches kernel B, which rounds the f32 input and weights to
bf16 itself, runs the products on tensor cores and takes any row count:
``csrc/mlp.cu`` where every width is at most ``NARROW_WIDTH`` (64), there
are at most ``NARROW_LAYERS`` (8) matrices and both activations are relu or
none (its weights all in shared memory, two row blocks a warp), else
``csrc/mlp_wide.cu`` (widths up to ``MAX_WIDTH``, 256, any depth, every
activation; its weights streamed through shared memory a chunk at a time).
A wider layer raises. On CPU tensors it runs ``fused_mlp_plain``.

Backward contract, as JAX's vjp of ``MLP.__call__``: every product takes
the f32 cotangent against a bf16 operand with f32 accumulation, and each
result (dh per layer, every dW, dX) is rounded to bf16; the ReLU mask
comes from the f32 pre-activation and is 0.5 where it is exactly 0 (the
derivative of ``jnp.maximum`` at a tie); sigmoid's derivative is s·(1 − s)
and the exponential's e^z, of the f32 values. ``fused_mlp_bwd`` launches
kernel F on CUDA tensors (``csrc/mlp_bwd.cu`` within the narrow limits with
a none output activation, else ``csrc/mlp_wide.cu``) and runs
``fused_mlp_bwd_plain`` on CPU tensors. Kernel F runs every product of the
dh chain on bf16 tensor cores: an inner cotangent under a relu/none hidden
layer is a bf16 value, and an f32 one (g, or any under a sigmoid or
exponential layer) enters as the three bf16 terms of ``split_bf16``. The
narrow kernel also forms dW; the wide one keeps every h_i and dz_i in f32
and the wrapper forms dW_i = h_iᵀ·dz_i with one f32 matrix product a layer,
a product the JAX package too leaves to XLA (it raises unless
``torch.get_float32_matmul_precision()`` is "highest", PyTorch's default:
no TF32). Kernel F recomputes the forward with kernel B's products in kernel
B's order; ``mlp_recompute`` returns that recompute's pre-activations, to
hold the two kernels to the same network.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import cuda_lib

ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2, "logistic": 2, "exponential": 3}
NARROW_WIDTH = 64  # widest layer of csrc/mlp.cu and csrc/mlp_bwd.cu (weights all in shared memory)
NARROW_LAYERS = 8
MAX_WIDTH = 256  # widest layer of csrc/mlp_wide.cu (its two register-resident A fragment sets)


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
    if name in ("sigmoid", "logistic"):
        s = torch.sigmoid(z)
        return s * (1.0 - s)
    if name == "exponential":
        return torch.exp(z)
    raise NotImplementedError(name)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _forward_record(wb: Sequence[torch.Tensor], x: torch.Tensor, activation: str):
    """The plain forward with bf16-valued weights wb: (each layer's input
    h_i, bf16-valued; each layer's f32 pre-activation z_{i+1} = h_i·W_i)."""
    hs = [_bf16(x)]
    zs = []
    for i, w in enumerate(wb):
        z = hs[-1] @ w
        zs.append(z)
        if i < len(wb) - 1:
            hs.append(_bf16(_act(activation, z)))
    return hs, zs


def fused_mlp_bwd_plain(ws: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                        activation: str = "relu", output_activation: str = "none"):
    """Backward of ``fused_mlp_plain``: x (N, in), g (N, out) f32 cotangent
    → (dx (N, in) f32, [dW (in, out) f32 per layer]), each value
    bf16-representable. The hidden activations are recomputed."""
    wb = [_bf16(w) for w in ws]
    hs, zs = _forward_record(wb, x, activation)
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


def _activation_code(name: str) -> int:
    code = ACTIVATIONS.get(name.lower())
    if code is None:
        raise NotImplementedError(f"kernels B and F take relu/none/sigmoid/exponential, got {name}")
    return code


def _kernel_dims(ws: Sequence[torch.Tensor], x: torch.Tensor) -> tuple:
    """The widths (d_0, .., d_L) of ws, checked against x (N, d_0) and
    against ``MAX_WIDTH``."""
    dims = (ws[0].shape[0], *[w.shape[1] for w in ws])
    if x.ndim != 2 or x.shape[1] != dims[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match the first layer {dims[0]}")
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"kernels B and F take layer widths ≤ {MAX_WIDTH}, got {dims}")
    return dims


def is_narrow(dims, act: int, out_act: int, backward: bool) -> bool:
    """True where the narrow kernel (``csrc/mlp.cu`` forward,
    ``csrc/mlp_bwd.cu`` backward) takes the MLP: every width ≤ 64, ≤ 8
    matrices, relu/none (the backward: a none output activation)."""
    return (max(dims) <= NARROW_WIDTH and len(dims) - 1 <= NARROW_LAYERS
            and act in (0, 1) and (out_act == 0 if backward else out_act in (0, 1)))


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous f32 tensor; t itself where it is one (no op)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _w_ptrs(wf) -> ctypes.Array:
    """The weights' device pointers as a host array. The caller keeps it in a
    local until the launch returns: ``addressof`` does not keep it alive."""
    return (ctypes.c_void_p * len(wf))(*[w.data_ptr() for w in wf])


@functools.lru_cache(maxsize=None)
def _wide_scratch_bytes(dims) -> int:
    return int(cuda_lib.query("fused_mlp_wide_scratch", ctypes.addressof(_dims_c(dims)),
                              len(dims) - 1))


def _check_f32_matmul() -> None:
    """The wide F's dW products need full f32 matmuls: raise where the
    process lets cuBLAS round their inputs to TF32 or bf16."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("kernel F's wide route forms dW with f32 matrix products: it needs "
                           "torch.set_float32_matmul_precision('highest') (the default), got "
                           f"{torch.get_float32_matmul_precision()!r}")


def _launch_bwd(ws, x, g, dims, act: int, out_act: int, zf=None, narrow=None):
    """One launch of kernel F: (dx, [dW per layer], the f32 sums rounded to
    bf16); zf, where given, takes the recompute's pre-activations (n, d_1 +
    .. + d_L), layer by layer. ``narrow``: the route, by default the one
    ``is_narrow`` picks (the narrow route takes only what it picks)."""
    wf = [_f32(w) for w in ws]
    xf, gf = _f32(x), _f32(g)
    cuda_lib.check_cuda(xf, gf, *wf, dtype=torch.float32)
    n = x.shape[0]
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=x.device)
    zf_ptr = None if zf is None else zf.data_ptr()
    w_ptrs = _w_ptrs(wf)
    if narrow is None:
        narrow = is_narrow(dims, act, out_act, backward=True)
    if narrow:
        dw_flat = torch.zeros((sum(w.numel() for w in ws),), dtype=torch.float32, device=x.device)
        if n > 0:
            cuda_lib.launch("fused_mlp_bwd", xf.data_ptr(), ctypes.addressof(w_ptrs),
                            gf.data_ptr(), ctypes.addressof(_dims_c(dims)), len(ws), act, n,
                            dx.data_ptr(), dw_flat.data_ptr(), zf_ptr)
        return dx, [d.reshape(w.shape)
                    for d, w in zip(torch.split(_bf16(dw_flat), [w.numel() for w in ws]), ws)]
    _check_f32_matmul()
    hbuf = torch.empty((n * sum(dims[:-1]),), dtype=torch.float32, device=x.device)
    dzbuf = torch.empty((n * sum(dims[1:]),), dtype=torch.float32, device=x.device)
    if n > 0:
        scratch = torch.empty((_wide_scratch_bytes(dims),), dtype=torch.uint8, device=x.device)
        cuda_lib.launch("fused_mlp_bwd_wide", xf.data_ptr(), ctypes.addressof(w_ptrs),
                        gf.data_ptr(), ctypes.addressof(_dims_c(dims)), len(ws), act, out_act, n,
                        scratch.data_ptr(), dx.data_ptr(), hbuf.data_ptr(), dzbuf.data_ptr(),
                        zf_ptr)
    dws, h0, z0 = [], 0, 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        h = hbuf[h0 * n:(h0 + d_in) * n].view(n, d_in)
        dz = dzbuf[z0 * n:(z0 + d_out) * n].view(n, d_out)
        dws.append(_bf16(h.T @ dz))
        h0, z0 = h0 + d_in, z0 + d_out
    return dx, dws


def fused_mlp_bwd(ws: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                  activation: str = "relu", output_activation: str = "none"):
    """See ``fused_mlp_bwd_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel F (widths ≤ ``MAX_WIDTH``), whose f32 dW sums are
    rounded to bf16 here."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(ws, x, g, activation, output_activation)
    act, out_act = _activation_code(activation), _activation_code(output_activation)
    dims = _kernel_dims(ws, x)
    if tuple(g.shape) != (x.shape[0], dims[-1]):
        raise ValueError(f"g {tuple(g.shape)} does not match x {tuple(x.shape)} and layers {dims}")
    # the kernel rounds x and the weights to bf16 and lays the weights out
    # itself: no copies (a small backward is bound by its host overhead)
    return _launch_bwd(ws, x, g, dims, act, out_act)


def mlp_recompute(ws: Sequence[torch.Tensor], x: torch.Tensor, activation: str = "relu",
                  output_activation: str = "none") -> list[torch.Tensor]:
    """The f32 pre-activations z_{i+1} = h_i·W_i (N, d_{i+1}) of every layer
    that the backward's forward recompute forms on x (N, d_0): kernel F's
    own on CUDA tensors (its record mode, a zero cotangent, on the route
    ``fused_mlp_bwd`` takes for these activations), the plain version's on
    CPU tensors."""
    if x.device.type == "cpu":
        return _forward_record([_bf16(w) for w in ws], x, activation)[1]
    act, out_act = _activation_code(activation), _activation_code(output_activation)
    dims = _kernel_dims(ws, x)
    n = x.shape[0]
    zf = torch.empty((n * sum(dims[1:]),), dtype=torch.float32, device=x.device)
    _launch_bwd(ws, x, torch.zeros((n, dims[-1]), dtype=torch.float32, device=x.device), dims,
                act, out_act, zf)
    out, start = [], 0
    for d in dims[1:]:
        out.append(zf[start:start + n * d].reshape(n, d))
        start += n * d
    return out


@functools.lru_cache(maxsize=None)
def _dims_c(dims) -> ctypes.Array:
    """The widths as a host int array for a launch, one per shape (kept, so
    that a launch does not build it anew)."""
    return (ctypes.c_int * len(dims))(*dims)


def fused_mlp(ws: Sequence[torch.Tensor], x: torch.Tensor, activation: str = "relu",
              output_activation: str = "none") -> torch.Tensor:
    """Forward through a bias-free MLP. CPU tensors run the plain version;
    CUDA tensors launch kernel B (widths ≤ ``MAX_WIDTH``, any depth, the four
    activations): one launch on x and the weights as they are (f32,
    contiguous), which the kernel rounds to bf16 and lays out itself (the
    wide route packs them first, one small launch a layer)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(ws, x, activation, output_activation)
    act, out_act = _activation_code(activation), _activation_code(output_activation)
    dims = _kernel_dims(ws, x)
    return _launch_fwd(ws, x, dims, act, out_act, is_narrow(dims, act, out_act, backward=False))


def _launch_fwd(ws, x, dims, act: int, out_act: int, narrow: bool) -> torch.Tensor:
    """One launch of kernel B on the narrow or the wide route (the narrow
    one takes only what ``is_narrow`` picks)."""
    wf = [_f32(w) for w in ws]
    xf = _f32(x)
    cuda_lib.check_cuda(xf, *wf, dtype=torch.float32)
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    w_ptrs = _w_ptrs(wf)
    if narrow:
        cuda_lib.launch("fused_mlp", xf.data_ptr(), ctypes.addressof(w_ptrs),
                        ctypes.addressof(_dims_c(dims)), len(ws), act, out_act, n, out.data_ptr())
    else:
        scratch = torch.empty((_wide_scratch_bytes(dims),), dtype=torch.uint8, device=x.device)
        cuda_lib.launch("fused_mlp_wide", xf.data_ptr(), ctypes.addressof(w_ptrs),
                        ctypes.addressof(_dims_c(dims)), len(ws), act, out_act, n,
                        scratch.data_ptr(), out.data_ptr())
    return out
