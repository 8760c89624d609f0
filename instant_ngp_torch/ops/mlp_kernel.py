"""Fused bias-free MLP, forward and backward (port of the Pallas kernel
``instant_ngp_tpu/ops/pallas/mlp_kernel.py::fused_mlp`` and of the
autodiff backward it gets from ``_reference_forward``).

Forward contract, as ``MLP.__call__`` in the JAX package: a bf16 input and
bf16 weights, f32 accumulation, each hidden activation rounded back to
bf16, an f32 output; any widths and depth; relu, none, sigmoid,
exponential, leakyrelu, sine, squareplus, softplus or tanh as the hidden
and the output activation (the last five are ``MLP.__call__``'s XLA path in
the JAX package; its Pallas kernel takes the first four). On CUDA tensors
``fused_mlp`` launches kernel B, which rounds the f32 input and weights to
bf16 itself, runs the products on tensor cores and takes any row count:
``csrc/mlp.cu`` where every width is at most ``NARROW_WIDTH`` (64), there
are at most ``NARROW_LAYERS`` (8) matrices and both activations are relu or
none (its weights all in shared memory, two row blocks a warp), else
``csrc/mlp_wide.cu`` (widths up to ``MAX_WIDTH``, 256, any depth, every
activation compiled into the kernel that runs it, one instantiation a kind
picked per layer: its kernels take relu, sigmoid, exponential or none as the
hidden activation, those of ``csrc/mlp_wide*_generic.cu`` the other five;
each takes any output activation, one its hidden layers do not take through
a loop over the output; its weights streamed through shared memory a chunk
at a time).
A wider layer raises. On CPU tensors it runs ``fused_mlp_plain``.

Backward contract, as JAX's vjp of ``MLP.__call__``: every product takes
the f32 cotangent against a bf16 operand with f32 accumulation, and each
result (dh per layer, every dW, dX) is rounded to bf16; the ReLU mask
comes from the f32 pre-activation and is 0.5 where it is exactly 0 (the
derivative of ``jnp.maximum`` at a tie); sigmoid's derivative is s·(1 − s)
and the exponential's e^z, of the f32 values; leakyrelu's is 1 above 0 and
0.01 at and below it (``jnp.where`` takes the false branch at 0), sine's
cos z, squareplus's (1 + z/√(z² + 4))/2, softplus's e^(z − softplus(z))
(the custom jvp of ``jnp.logaddexp``) and tanh's (1 + t)(1 − t). ``fused_mlp_bwd`` launches
kernel F on CUDA tensors (``csrc/mlp_bwd.cu`` within the narrow limits with
a none output activation, else ``csrc/mlp_wide_bwd.cu`` and its dW launch,
``csrc/mlp_wide_dw.cu``) and runs
``fused_mlp_bwd_plain`` on CPU tensors. Kernel F runs every product of the
dh chain on bf16 tensor cores: an inner cotangent under a relu/none hidden
layer is a bf16 value, and an f32 one (g, or any under a sigmoid or
exponential layer) enters as the three bf16 terms of ``split_bf16``. The
narrow kernel also forms dW; the wide one writes every h_i and dz_i in bf16
(dz_i as its three terms where it is an f32 value) and a second kernel forms
dW_i = h_iᵀ·dz_i from them, split over ranges of ``DW_SPLIT_ROWS`` rows whose
f32 partials are summed in order and rounded once (``mlp_dw_plain``): no
library product, and no dependence on PyTorch's matmul precision. Kernel F
recomputes the forward with kernel B's products in kernel B's order;
``mlp_recompute`` returns that recompute's pre-activations, to hold the two
kernels to the same network.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import cuda_lib

ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2, "logistic": 2, "exponential": 3,
               "leakyrelu": 4, "sine": 5, "squareplus": 6, "softplus": 7, "tanh": 8}
NARROW_WIDTH = 64  # widest layer of csrc/mlp.cu and csrc/mlp_bwd.cu (weights all in shared memory)
NARROW_LAYERS = 8
MAX_WIDTH = 256  # widest layer of csrc/mlp_wide.cu (its register-resident accumulators)
DW_SPLIT_ROWS = 4096  # rows of one f32 partial of the wide F's dW (a multiple of 64)


def _softplus(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``jnp.logaddexp(h, 0)``: max(h, 0) +
    log1p(exp(−|h|)) (no threshold, unlike ``torch.nn.functional.softplus``)."""
    return torch.clamp(h, min=0.0) + torch.log1p(torch.exp(-torch.abs(h)))


def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    """The activation as the JAX package's ``activation_fn`` computes it."""
    name = name.lower()
    if name == "relu":
        return torch.clamp(h, min=0.0)
    if name == "none":
        return h
    if name in ("sigmoid", "logistic"):
        return torch.sigmoid(h)
    if name == "exponential":
        return torch.exp(h)
    if name == "leakyrelu":
        return torch.where(h > 0.0, h, 0.01 * h)
    if name == "sine":
        return torch.sin(h)
    if name == "squareplus":
        return 0.5 * (h + torch.sqrt(h * h + 4.0))
    if name == "softplus":
        return _softplus(h)
    if name == "tanh":
        return torch.tanh(h)
    raise ValueError(f"unknown activation {name!r}")


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
    if name == "leakyrelu":
        return torch.where(z > 0.0, 1.0, 0.01)
    if name == "sine":
        return torch.cos(z)
    if name == "squareplus":
        return 0.5 * (1.0 + z / torch.sqrt(z * z + 4.0))
    if name == "softplus":
        return torch.exp(z - _softplus(z))
    if name == "tanh":
        t = torch.tanh(z)
        return (1.0 + t) * (1.0 - t)
    raise ValueError(f"unknown activation {name!r}")


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
                        activation: str = "relu", output_activation: str = "none",
                        f32_dw: bool = False):
    """Backward of ``fused_mlp_plain``: x (N, in), g (N, out) f32 cotangent
    → (dx (N, in) f32, [dW (in, out) f32 per layer]), each value
    bf16-representable. The hidden activations are recomputed. ``f32_dw``:
    the dW are the f32 sums, not yet rounded to bf16 (a data-parallel step
    sums them over its ranks first, then rounds once)."""
    wb = [_bf16(w) for w in ws]
    hs, zs = _forward_record(wb, x, activation)
    dz = g.float() * _act_grad(output_activation, zs[-1])
    dws = [None] * len(wb)
    dx = None
    for i in reversed(range(len(wb))):
        dws[i] = hs[i].T @ dz
        dh = _bf16(dz @ wb[i].T)
        if i > 0:
            dz = dh * _act_grad(activation, zs[i - 1])
        else:
            dx = dh
    return dx, dws if f32_dw else [_bf16(d) for d in dws]


def mlp_dw_plain(h: torch.Tensor, dz: torch.Tensor, split_rows: int = DW_SPLIT_ROWS) -> torch.Tensor:
    """dW = hᵀ·dz (d_in, d_out) as the wide F's dW kernel forms it: h (N,
    d_in) bf16-valued, dz (N, d_out) f32 as its three ``split_bf16`` terms;
    one f32 partial per range of ``split_rows`` rows (the terms added in
    turn), the partials summed in the order of the ranges, then rounded to
    bf16. Within a range the f32 sums run in another order than the
    kernel's."""
    h, terms = h.float(), split_bf16(dz)
    total = None
    for r0 in range(0, max(h.shape[0], 1), split_rows):
        hs = h[r0:r0 + split_rows].T
        part = hs @ terms[0][r0:r0 + split_rows]
        for t in terms[1:]:
            part = part + hs @ t[r0:r0 + split_rows]
        total = part if total is None else total + part
    return _bf16(total)


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
        raise ValueError(f"kernels B and F take {sorted(ACTIVATIONS)}, got {name}")
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


@functools.lru_cache(maxsize=256)
def _wide_sizes(dims, act: int, n: int) -> tuple:
    """(scratch bytes, h buffer and dz buffer values, per-thread scratch
    values, dW partial values, splits) of a wide call: what the kernels
    take for these widths, hidden activation and rows."""
    out = (ctypes.c_longlong * 6)()
    err = cuda_lib.query("fused_mlp_wide_sizes", ctypes.addressof(_dims_c(dims)), len(dims) - 1,
                         act, n, DW_SPLIT_ROWS, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fused_mlp_wide_sizes failed for {dims}: cudaError {err}")
    return tuple(int(v) for v in out)


def _launch_wide_f(ws, x, g, dims, act: int, out_act: int, zf=None):
    """The first launch of the wide F: (dx, the h buffer, the dz buffer,
    the scratch that holds the widths and packed weights)."""
    wf = [_f32(w) for w in ws]
    xf, gf = _f32(x), _f32(g)
    cuda_lib.check_cuda(xf, gf, *wf, dtype=torch.float32)
    n, dev = x.shape[0], x.device
    sizes = _wide_sizes(dims, act, n)
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=dev)
    scratch = torch.empty((sizes[0],), dtype=torch.uint8, device=dev)
    hbuf = torch.empty((sizes[1],), dtype=torch.bfloat16, device=dev)
    dzbuf = torch.empty((sizes[2],), dtype=torch.bfloat16, device=dev)
    gscr = torch.empty((sizes[3],), dtype=torch.float32, device=dev) if sizes[3] else None
    w_ptrs = _w_ptrs(wf)
    cuda_lib.launch("fused_mlp_bwd_wide", xf.data_ptr(), ctypes.addressof(w_ptrs), gf.data_ptr(),
                    ctypes.addressof(_dims_c(dims)), len(ws), act, out_act, n, scratch.data_ptr(),
                    dx.data_ptr(), hbuf.data_ptr(), dzbuf.data_ptr(),
                    None if gscr is None else gscr.data_ptr(), None if zf is None else zf.data_ptr())
    return dx, hbuf, dzbuf, scratch


def _launch_wide_dw(hbuf, dzbuf, scratch, dims, act: int, n: int,
                    f32_dw: bool = False) -> list[torch.Tensor]:
    """The dW launch of the wide F on its first launch's buffers: every
    layer's dW (d_i, d_{i+1}), f32 tensors of bf16 values (``f32_dw``: the
    f32 sums, unrounded)."""
    sizes = _wide_sizes(dims, act, n)
    partials = torch.empty((sizes[4],), dtype=torch.float32, device=hbuf.device)
    shapes = list(zip(dims[:-1], dims[1:]))
    dw_flat = torch.empty((sum(a * b for a, b in shapes),), dtype=torch.float32,
                          device=hbuf.device)
    cuda_lib.launch("fused_mlp_dw_wide", hbuf.data_ptr(), dzbuf.data_ptr(),
                    ctypes.addressof(_dims_c(dims)), len(dims) - 1, act, n, DW_SPLIT_ROWS,
                    scratch.data_ptr(), partials.data_ptr(), dw_flat.data_ptr(), int(not f32_dw))
    return [d.view(a, b) for d, (a, b) in zip(torch.split(dw_flat, [a * b for a, b in shapes]),
                                               shapes)]


def untile(buf: torch.Tensor, n: int, tile_width: int, col: int, width: int) -> torch.Tensor:
    """Columns [col, col + width) of an (n, tile_width) array the wide F
    wrote in its dW operand layout, as an (n, width) f32 tensor: per 64-row
    tile, element (r, c) at ((c // 8)·8 + r // 8)·64 + (r % 8)·8 + c % 8
    (8 x 8 blocks of 128 bytes, transposed core matrices), tiles in turn."""
    n_t = -(-n // 64)
    w8 = -(-width // 8)
    t = buf[:n_t * 64 * tile_width].view(n_t, 64 * tile_width)[:, 64 * col:64 * (col + 8 * w8)]
    t = t.reshape(n_t, w8, 8, 8, 8)  # (tile, c // 8, r // 8, r % 8, c % 8)
    t = t.permute(0, 2, 3, 1, 4).reshape(n_t * 64, w8 * 8)
    return t[:n, :width].float()


def wide_layout(dims, act: str) -> list[dict]:
    """Per layer, where the wide F puts h_i and dz_i in its buffers (a
    mirror of csrc/mlp_wide.cuh's layer_records): h_i at column ``hcol`` of
    an h tile ``hw`` columns wide; dz_i's ``terms`` planes, ``nz`` columns
    each, from column ``zcol`` of a dz tile ``zw`` wide."""
    def wgn(v):
        return max(16, 1 << (v - 1).bit_length())

    code = _activation_code(act)
    out, hcol, zcol = [], 0, 0
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        terms = 3 if i == len(dims) - 2 or code >= 2 else 1
        out.append({"hcol": hcol, "zcol": zcol, "nz": wgn(d_out), "terms": terms})
        hcol += -(-d_in // 64) * 64
        zcol += wgn(d_out) * terms
    for v in out:
        v["hw"], v["zw"] = hcol, zcol
    return out


def wide_intermediates(ws: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                       activation: str = "relu", output_activation: str = "none"):
    """The wide F's first launch on CUDA tensors and what the dW kernel
    reads from it: ([h_i (N, d_i)], [dz_i (N, d_{i+1}), f32: the sum of its
    bf16 terms], (hbuf, dzbuf, scratch)); for holding the dW kernel against
    ``mlp_dw_plain`` on the same values."""
    act, out_act = _activation_code(activation), _activation_code(output_activation)
    dims = _kernel_dims(ws, x)
    n = x.shape[0]
    _, hbuf, dzbuf, scratch = _launch_wide_f(ws, x, g, dims, act, out_act)
    hs, dzs = [], []
    for v, d_in, d_out in zip(wide_layout(dims, activation), dims[:-1], dims[1:]):
        hs.append(untile(hbuf, n, v["hw"], v["hcol"], d_in))
        planes = [untile(dzbuf, n, v["zw"], v["zcol"] + q * v["nz"], d_out)
                  for q in range(v["terms"])]
        dzs.append(functools.reduce(torch.add, planes))
    return hs, dzs, (hbuf, dzbuf, scratch)


def wide_dw(bufs, dims, activation: str, n: int) -> list[torch.Tensor]:
    """The dW kernel on ``wide_intermediates``' buffers."""
    return _launch_wide_dw(*bufs, dims, _activation_code(activation), n)


def _launch_bwd(ws, x, g, dims, act: int, out_act: int, zf=None, narrow=None,
                f32_dw: bool = False):
    """One call of kernel F: (dx, [dW per layer], the f32 sums rounded to
    bf16, or left unrounded where ``f32_dw``); zf, where given, takes the
    recompute's pre-activations (n, d_1 + .. + d_L), layer by layer (the wide
    route then forms no dW). ``narrow``: the route, by default the one
    ``is_narrow`` picks (the narrow route takes only what it picks)."""
    n = x.shape[0]
    if narrow is None:
        narrow = is_narrow(dims, act, out_act, backward=True)
    if narrow:
        wf = [_f32(w) for w in ws]
        xf, gf = _f32(x), _f32(g)
        cuda_lib.check_cuda(xf, gf, *wf, dtype=torch.float32)
        dx = torch.empty((n, dims[0]), dtype=torch.float32, device=x.device)
        w_ptrs = _w_ptrs(wf)
        dw_flat = torch.zeros((sum(w.numel() for w in ws),), dtype=torch.float32, device=x.device)
        if n > 0:
            cuda_lib.launch("fused_mlp_bwd", xf.data_ptr(), ctypes.addressof(w_ptrs),
                            gf.data_ptr(), ctypes.addressof(_dims_c(dims)), len(ws), act, n,
                            dx.data_ptr(), dw_flat.data_ptr(),
                            None if zf is None else zf.data_ptr())
        if not f32_dw:
            dw_flat = _bf16(dw_flat)
        return dx, [d.reshape(w.shape)
                    for d, w in zip(torch.split(dw_flat, [w.numel() for w in ws]), ws)]
    if n == 0:
        return (torch.empty((0, dims[0]), dtype=torch.float32, device=x.device),
                [torch.zeros(tuple(w.shape), dtype=torch.float32, device=x.device) for w in ws])
    dx, hbuf, dzbuf, scratch = _launch_wide_f(ws, x, g, dims, act, out_act, zf)
    if zf is not None:
        return dx, None
    return dx, _launch_wide_dw(hbuf, dzbuf, scratch, dims, act, n, f32_dw)


def fused_mlp_bwd(ws: Sequence[torch.Tensor], x: torch.Tensor, g: torch.Tensor,
                  activation: str = "relu", output_activation: str = "none",
                  f32_dw: bool = False):
    """See ``fused_mlp_bwd_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel F (widths ≤ ``MAX_WIDTH``), whose f32 dW sums are
    rounded to bf16 (the narrow route's here, the wide route's by its dW
    kernel) unless ``f32_dw``."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(ws, x, g, activation, output_activation, f32_dw)
    act, out_act = _activation_code(activation), _activation_code(output_activation)
    dims = _kernel_dims(ws, x)
    if tuple(g.shape) != (x.shape[0], dims[-1]):
        raise ValueError(f"g {tuple(g.shape)} does not match x {tuple(x.shape)} and layers {dims}")
    # the kernel rounds x and the weights to bf16 and lays the weights out
    # itself: no copies (a small backward is bound by its host overhead)
    return _launch_bwd(ws, x, g, dims, act, out_act, f32_dw=f32_dw)


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
        scratch = torch.empty((_wide_sizes(dims, act, n)[0],), dtype=torch.uint8, device=x.device)
        cuda_lib.launch("fused_mlp_wide", xf.data_ptr(), ctypes.addressof(w_ptrs),
                        ctypes.addressof(_dims_c(dims)), len(ws), act, out_act, n,
                        scratch.data_ptr(), out.data_ptr())
    return out


def wgmma_rounding_probe(device) -> dict:
    """Whether a wgmma m64n128k16 chain over k = 256 (csrc/mlp_wide.cu's
    products) rounds exactly like kernel B's mma.sync m16n8k16 chains (k
    blocks ascending from zero) on the same bf16 operands: x (64, 256) and W
    (256, 128) with exponents spread over 2^±6, seeded. Returns the rows and
    values that differ and each product's largest error against the plain
    product in float64."""
    gen = torch.Generator(device="cpu").manual_seed(12)

    def vals(*shape):
        e = torch.randint(-6, 7, shape, generator=gen).float()
        return _bf16(torch.randn(shape, generator=gen) * 2.0 ** e).to(device)

    x, w = vals(64, 256), vals(256, 128)
    zw = torch.empty((64, 128), dtype=torch.float32, device=device)
    zm = torch.empty_like(zw)
    scratch = torch.empty((_wide_sizes((256, 128), 1, 64)[0],), dtype=torch.uint8, device=device)
    err = cuda_lib.query("mlp_wgmma_probe", x.data_ptr(), w.data_ptr(), scratch.data_ptr(),
                         zw.data_ptr(), zm.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the wgmma probe failed to launch: cudaError {err}")
    torch.cuda.synchronize()
    ref = x.double() @ w.double()
    scale = float(ref.abs().max())
    return {"bit_equal": bool(torch.equal(zw, zm)), "values_differ": int((zw != zm).sum()),
            "wgmma_rel_err": float((zw.double() - ref).abs().max()) / scale,
            "mma_rel_err": float((zm.double() - ref).abs().max()) / scale}
