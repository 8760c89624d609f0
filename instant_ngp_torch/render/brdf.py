"""Disney-style BRDF shading of the SDF primitive (port of
``instant_ngp_tpu/render/brdf.py``; reference evaluate_shading,
testbed_sdf.cu:57-154, and BRDFParams' defaults, sdf_device.cuh:30-40).
Plain torch: elementwise over a frame's hit positions.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class BRDFParams:
    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 0.5
    specular_tint: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    basecolor: tuple = (0.8, 0.8, 0.8)
    ambientcolor: tuple = (0.0, 0.0, 0.0)


def _schlick(u: torch.Tensor) -> torch.Tensor:
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _g1(ndoth: torch.Tensor, a: float) -> torch.Tensor:
    if a >= 1.0:
        return torch.full_like(ndoth, 1.0 / math.pi)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return (a2 - 1.0) / (math.pi * math.log(max(a2, 1e-8)) * t)


def _g2(ndoth: torch.Tensor, a: float) -> torch.Tensor:
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (math.pi * t * t)


def _smith_ggx(ndotv: torch.Tensor, alpha_g: float) -> torch.Tensor:
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(torch.clamp(a + b - a * b, min=1e-12)))


def _rows(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).expand(like.shape)


def evaluate_shading(base_color, ambient_color, light_color, brdf: BRDFParams, L, V,
                     N: torch.Tensor) -> torch.Tensor:
    """Shade (n, 3) unit normals N for the unit light direction L and view
    direction V, each (3,) or (n, 3); colours (3,) or (n, 3). → (n, 3)."""
    L, V = _rows(L, N), _rows(V, N)
    base = _rows(base_color, N)
    amb_c = _rows(ambient_color, N)
    light = torch.as_tensor(light_color, dtype=torch.float32, device=N.device)

    ndl = torch.sum(N * L, -1, keepdim=True)
    ndv = torch.sum(N * V, -1, keepdim=True)
    H = L + V
    H = H / torch.clamp(torch.linalg.vector_norm(H, dim=-1, keepdim=True), min=1e-9)
    ndh = torch.sum(N * H, -1, keepdim=True)
    ldh = torch.sum(L * H, -1, keepdim=True)

    fl, fv = _schlick(ndl), _schlick(ndv)
    amb = amb_c * (0.2 + (fv - 0.2) * brdf.metallic) * base

    lum = torch.sum(base * torch.tensor([0.3, 0.6, 0.1], device=N.device), -1, keepdim=True)
    ctint = base / (lum + 1e-5)
    cspec0 = (((1.0 - brdf.specular_tint) + ctint * brdf.specular_tint)
              * brdf.specular * 0.08 * (1.0 - brdf.metallic) + base * brdf.metallic)
    csheen = (1.0 - brdf.sheen_tint) + ctint * brdf.sheen_tint

    fd90 = 0.5 + 2.0 * ldh * ldh * brdf.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)

    fss90 = ldh * ldh * brdf.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ndl + ndv, min=1e-6) - 0.5) + 0.5)

    a = max(0.001, brdf.roughness ** 2)
    ds = _g2(ndh, a)
    fh = _schlick(ldh)
    fs = cspec0 + (1.0 - cspec0) * fh
    gs = _smith_ggx(ndl, a) * _smith_ggx(ndv, a)

    fsheen = fh * brdf.sheen * csheen

    dr = _g1(ndh, 0.1 + (0.001 - 0.1) * brdf.clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = _smith_ggx(ndl, 0.25) * _smith_ggx(ndv, 0.25)
    ccs = 0.25 * brdf.clearcoat * gr * fr * dr

    diffuse = (1.0 / math.pi) * (fd + (ss - fd) * brdf.subsurface) * base
    out = (diffuse + fsheen) * (1.0 - brdf.metallic) + gs * fs * ds + ccs
    lit = out * light * ndl + amb
    return torch.where((ndl < 0.0) | (ndv < 0.0), amb, lit)
