"""Input encodings (port of ``instant_ngp_tpu/ops/encodings.py``):
Identity, SphericalHarmonics, OneBlob, Frequency, TriangleWave and
Composite, with the JAX package's output widths and feature order. Dense
elementwise featurizers, XLA compositions there: plain torch here, no
kernel. Every encoding takes ``max_level`` (used by the grids only), so a
model calls them alike.

The parameters of any encoding tree (a grid's flat table, Takikawa's vertex
table, a Composite's nested ones) are handled by ``encoding_tables``,
``encoding_tree`` and ``encoding_flat``, which convert between the port's
flat list and the JAX package's parameter tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class Identity(nn.Module):
    def __init__(self, n_dims_to_encode: int = 3, scale: float = 1.0, offset: float = 0.0):
        super().__init__()
        self.n_dims_to_encode = n_dims_to_encode
        self.scale = scale
        self.offset = offset

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        return x * self.scale + self.offset


class SphericalHarmonics(nn.Module):
    """Real SH basis up to ``degree`` 4. The input is expected *warped* to
    [0,1]^3 (warp_direction) and is unwarped internally, as in tcnn."""

    def __init__(self, degree: int = 4, n_dims_to_encode: int = 3):
        super().__init__()
        if degree > 4:
            raise NotImplementedError("SH degree > 4 not yet implemented")
        self.degree = degree
        self.n_dims_to_encode = n_dims_to_encode

    @property
    def n_output_dims(self) -> int:
        return self.degree**2

    def forward(self, d: torch.Tensor, max_level=None) -> torch.Tensor:
        d = d * 2.0 - 1.0
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        x2, y2, z2 = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out = [torch.full_like(x, 0.28209479177387814)]
        if self.degree >= 2:
            out += [
                -0.48860251190291987 * y,
                0.48860251190291992 * z,
                -0.48860251190291987 * x,
            ]
        if self.degree >= 3:
            out += [
                1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (x2 - y2),
            ]
        if self.degree >= 4:
            out += [
                0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2),
            ]
        return torch.stack(out, dim=-1)


def _quartic_cdf(u: torch.Tensor) -> torch.Tensor:
    """CDF of the quartic kernel 15/16 (1-u^2)^2 on [-1, 1]."""
    u = torch.clamp(u, -1.0, 1.0)
    return 15.0 / 16.0 * (u - 2.0 * u**3 / 3.0 + u**5 / 5.0) + 0.5


class OneBlob(nn.Module):
    """One-blob encoding: per dim, the quartic kernel centred on x integrated
    over ``n_bins`` bins of [0, 1]; (N, D·n_bins), dim-major."""

    def __init__(self, n_bins: int = 16, n_dims_to_encode: int = 3):
        super().__init__()
        self.n_bins = n_bins
        self.n_dims_to_encode = n_dims_to_encode

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_bins

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        n = self.n_bins
        edges = torch.arange(n + 1, dtype=torch.float32, device=x.device) / n
        cdf = _quartic_cdf((edges - x[..., None]) * n)  # (N, D, n + 1)
        return (cdf[..., 1:] - cdf[..., :-1]).reshape(*x.shape[:-1], -1)


class Frequency(nn.Module):
    """NeRF's frequency encoding: sin and cos of x·2^k·π, k < n_frequencies;
    (N, D·F·2), ordered (dim, frequency, sin/cos)."""

    def __init__(self, n_frequencies: int = 12, n_dims_to_encode: int = 3):
        super().__init__()
        self.n_frequencies = n_frequencies
        self.n_dims_to_encode = n_dims_to_encode

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_frequencies * 2

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(self.n_frequencies, dtype=torch.float32, device=x.device)
        ang = x[..., None] * freqs * math.pi  # (N, D, F)
        return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*x.shape[:-1], -1)


class TriangleWave(nn.Module):
    """Triangle waves of x·2^k, k < n_frequencies, in [-1, 1]; (N, D·F),
    dim-major."""

    def __init__(self, n_frequencies: int = 12, n_dims_to_encode: int = 3):
        super().__init__()
        self.n_frequencies = n_frequencies
        self.n_dims_to_encode = n_dims_to_encode

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_frequencies

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(self.n_frequencies, dtype=torch.float32, device=x.device)
        y = x[..., None] * freqs
        u = 2.0 * (y - torch.floor(y)) - 1.0
        # |u| with jnp.abs's derivative, +1 at u = 0 (torch.abs takes 0 there)
        return (torch.where(u >= 0.0, u, -u) * 2.0 - 1.0).reshape(*x.shape[:-1], -1)


class Composite(nn.Module):
    """Nested encodings over slices of the input dims. Slices are
    consecutive by default; ``begins`` gives explicit (possibly
    overlapping) starts, the tcnn ``dims_to_encode_begin`` key."""

    def __init__(self, nested, begins: tuple | None = None):
        super().__init__()
        self.nested = nn.ModuleList(nested)
        self.begins = begins

    @property
    def n_dims_to_encode(self) -> int:
        if self.begins is not None:
            return max(b + e.n_dims_to_encode for b, e in zip(self.begins, self.nested))
        return sum(e.n_dims_to_encode for e in self.nested)

    @property
    def n_output_dims(self) -> int:
        return sum(e.n_output_dims for e in self.nested)

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        outs = []
        d0 = 0
        for i, e in enumerate(self.nested):
            b = self.begins[i] if self.begins is not None else d0
            outs.append(e(x[..., b: b + e.n_dims_to_encode], max_level=max_level))
            d0 = b + e.n_dims_to_encode
        return torch.cat(outs, dim=-1)


def encoding_from_config(cfg: dict, n_dims: int, device=None) -> nn.Module:
    """Build an encoding from a tcnn-style JSON config."""
    from .hashgrid import grid_encoding_from_config

    otype = cfg.get("otype", "Identity").lower()
    if "grid" in otype:
        return grid_encoding_from_config(cfg, n_dims, device=device)
    if otype == "identity":
        return Identity(n_dims, float(cfg.get("scale", 1.0)), float(cfg.get("offset", 0.0)))
    if otype == "sphericalharmonics":
        return SphericalHarmonics(int(cfg.get("degree", 4)), n_dims)
    if otype == "oneblob":
        return OneBlob(int(cfg.get("n_bins", 16)), n_dims)
    if otype == "frequency":
        return Frequency(int(cfg.get("n_frequencies", 12)), n_dims)
    if otype == "trianglewave":
        return TriangleWave(int(cfg.get("n_frequencies", 12)), n_dims)
    if otype == "composite":
        nested = []
        begins = []
        cursor = 0
        explicit = False
        specs = cfg.get("nested", [])
        for i, sub in enumerate(specs):
            begin = sub.get("dims_to_encode_begin")
            if begin is not None:
                explicit = True
            b = int(begin) if begin is not None else cursor
            nd = int(sub.get("n_dims_to_encode", 0))
            if nd == 0:
                # tcnn gives unset dims to the last nested encoding only
                if i != len(specs) - 1:
                    raise ValueError(
                        "Composite: n_dims_to_encode must be set on all "
                        "nested encodings except the last"
                    )
                nd = n_dims - b
            nd = min(nd, n_dims - b)
            if nd <= 0:
                continue  # degenerate slice (e.g. no extra dims) → no-op
            sub = dict(sub, n_dims_to_encode=nd)
            nested.append(encoding_from_config(sub, nd, device=device))
            begins.append(b)
            cursor = b + nd
        if cursor > n_dims:
            raise ValueError(f"Composite: nested n_dims_to_encode exceed input dims ({n_dims})")
        return Composite(tuple(nested), tuple(begins) if explicit else None)
    raise ValueError(f"unknown encoding otype: {cfg.get('otype')}")


# --- the parameters of an encoding tree ---


def _nested(enc: nn.Module) -> list:
    return list(enc.nested) if isinstance(enc, Composite) else []


def encoding_tables(enc: nn.Module) -> list[nn.Parameter]:
    """The encoding's parameters in packing order: a grid's or Takikawa's
    ``table``, a Composite's nested ones in order; none for the others."""
    if isinstance(enc, Composite):
        return [t for e in enc.nested for t in encoding_tables(e)]
    table = getattr(enc, "table", None)
    return [table] if isinstance(table, nn.Parameter) else []


def encoding_tree(enc: nn.Module, flat: list):
    """The JAX package's parameter tree of the encoding from ``flat`` (arrays
    in ``encoding_tables`` order, consumed from the front): a grid's tuple of
    per-level tables, Takikawa's (n_entries, F) table, a Composite's list of
    its nested trees; None for an encoding without parameters."""
    if isinstance(enc, Composite):
        return [encoding_tree(e, flat) for e in enc.nested]
    if not encoding_tables(enc):
        return None
    table = flat.pop(0)
    return tuple(enc.unpack_params(table)) if hasattr(enc, "unpack_params") else table


def encoding_flat(enc: nn.Module, tree) -> list[np.ndarray]:
    """The inverse of ``encoding_tree``: f32 arrays in ``encoding_tables``
    order from the JAX package's tree."""
    if isinstance(enc, Composite):
        return [a for e, sub in zip(enc.nested, tree) for a in encoding_flat(e, sub)]
    if not encoding_tables(enc):
        return []
    if hasattr(enc, "unpack_params"):
        return [np.concatenate([np.asarray(t, np.float32) for t in tree], axis=0)]
    return [np.array(tree, np.float32)]


def init_encoding(enc: nn.Module, generator: torch.Generator) -> None:
    """Fresh tables in place for every encoding of the tree that has one."""
    for e in [enc, *_nested(enc)]:
        if encoding_tables(e) and not isinstance(e, Composite):
            e.init(generator)


def set_encoding_kernels(enc: nn.Module, flag: bool) -> None:
    """Route every grid of the tree through its kernels (True) or its plain
    versions."""
    for e in [enc, *_nested(enc)]:
        if hasattr(e, "use_kernel"):
            e.use_kernel = flag
