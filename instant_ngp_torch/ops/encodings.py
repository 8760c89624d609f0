"""Input encodings of the NeRF path (port of the SphericalHarmonics,
Identity and Composite encodings of ``instant_ngp_tpu/ops/encodings.py``).
Dense elementwise featurizers: plain torch, no kernel."""

from __future__ import annotations

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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

    def forward(self, d: torch.Tensor) -> torch.Tensor:
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        d0 = 0
        for i, e in enumerate(self.nested):
            b = self.begins[i] if self.begins is not None else d0
            outs.append(e(x[..., b: b + e.n_dims_to_encode]))
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
    raise NotImplementedError(f"encoding otype {cfg.get('otype')!r} is not ported yet")
