"""The slab-sweep renderer (port of ``instant_ngp_tpu/nerf/slab.py``).

1. The field is baked into dense per-level voxel volumes (``bake_dense``):
   activated [σ·r, σ·g, σ·b, σ] (and optional deferred-shading features
   σ·f) at voxel centres, bf16, occupancy-masked, the next-inner level's
   region zeroed. Colour is stored σ-premultiplied, so empty voxels weigh
   nothing under resampling; the sweep divides after interpolating.
2. A frame sweeps each level slab by slab along the dominant axis of a
   group of pixels' rays, front to back in depth octaves. Slab k maps onto
   the octave's baseplane by an epipolar scale about the eye, an affine
   resample computed as two matrix products with interpolation matrices
   (``torch.matmul``, outside any kernel, as the JAX package leaves them to
   XLA). What follows the products in a slab — σ, colour and features over
   σ, the sample's distance, α, the front/back split at the next-inner
   level's entry, the six carries — is kernel P (``slab_step``, Triton).
3. Octaves merge far to near, and the levels' front and back layers fold
   onto the finest level's baseplane (``resample_layer``,
   ``composite_layers``), or stay apart (``merge_layers=False``).
4. The last step is the per-pixel warp from the baseplanes to the screen,
   one quad-packed row (a 2×2 texel neighbourhood) a layer, composited
   front to back: kernel O (``warp_composite``, ``csrc/slab.cu``; the row
   read in 16- or 8-byte words, the pixels' directions and outputs staged
   through shared memory, bit for bit its plain version).

Groups: pixels split by the dominant axis and sign of their ray (up to 6
groups), each with its own sweep. The plan of the groups is host numpy for
an undistorted perspective camera (``plan_groups_host``), else one device
reduction (``group_stats``).

The two products' output stays f32, as the JAX package's
``preferred_element_type=f32``: both take bf16-valued f32 operands (the
first product's result is rounded to bf16 in between, as there). On the
card they run in TF32 (``_product_precision``): TF32 holds every bf16 value
exactly, so a product of bf16-valued operands is the f32 product up to the
order of its sums, at the tensor cores' rate.

The host planning (``clipmap_boxes``, ``plan_groups_host``, the octave plans
and ladders) is the JAX package's numpy, bit for bit. Slabs that the JAX
sweep masks out (outside the volume, or not ahead of the eye) change no
carry there, so the sweep here skips them. ``warp_composite`` and
``slab_step`` launch their kernels on CUDA tensors and run their plain
versions (``warp_composite_plain``, ``slab_step_plain``) on CPU tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from .. import cuda_lib
from ..common import NERF_GRIDSIZE, network_to_density, network_to_rgb, warp_direction
from ..parallel import sharding
from .baked import FIXED_BAKE_DIR

G = NERF_GRIDSIZE

# channels carried per layer: premultiplied rgb, transmittance, weighted depth
LAYER_CH = 5
# slabs a sweep step takes at once: the products of that many slabs are one
# batched product, and kernel P walks them in one launch
SLAB_CHUNK = 16
BAKE_CHUNK = 1 << 19  # voxels a bake evaluates at once
_PERMS = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
# body-diagonal sub-voxel offsets of the transmittance-corrected σ bake
_SIGMA_TAPS = np.float32([
    [-0.25, -0.25, -0.25], [0.25, 0.25, 0.25],
    [-0.25, 0.25, -0.25], [0.25, -0.25, 0.25],
])


@dataclasses.dataclass
class DenseVolumes:
    """Nested dense levels: volumes[m] is (n_m, n_m, n_m, 4 + F) bf16
    [σ·r, σ·g, σ·b, σ, σ·f…] at voxel centres of the world box boxes[m]
    (boxes[m-1] inside boxes[m]); without boxes, the scene-centred cascade
    extents. vt_cache: per sweep axis, the volumes with that axis first (made
    at the first frame that needs them, dropped with the cache). feat_proj:
    (mu (16,), sd (16,), P (16, F)) numpy, the features' PCA basis."""

    volumes: list
    res: list
    n_cascades: int
    boxes: np.ndarray | None = None
    vt_cache: dict | None = None
    feat_proj: tuple | None = None

    @property
    def n_feat(self) -> int:
        return int(self.volumes[0].shape[-1]) - 4

    @property
    def layer_ch(self) -> int:
        """Swept-layer channels: [rgb, T, depth, features…]."""
        return LAYER_CH + self.n_feat

    def box(self, m: int):
        if self.boxes is not None:
            return (np.asarray(self.boxes[m][0], np.float32),
                    np.asarray(self.boxes[m][1], np.float32))
        lo, hi = cascade_extent(m)
        return np.full(3, lo, np.float32), np.full(3, hi, np.float32)


def volumes_from_numpy(volumes, res, n_cascades: int, device, boxes=None,
                       feat_proj=None) -> DenseVolumes:
    """DenseVolumes from numpy arrays in the JAX package's layout (a JAX
    ``DenseVolumes``'s volumes through ``np.asarray``: their bf16 values
    carry over exactly)."""
    vols = [torch.as_tensor(np.asarray(v).astype(np.float32), device=device).to(torch.bfloat16)
            for v in volumes]
    fp = None if feat_proj is None else tuple(np.asarray(a, np.float32) for a in feat_proj)
    return DenseVolumes(volumes=vols, res=[int(r) for r in res], n_cascades=int(n_cascades),
                        boxes=None if boxes is None else np.asarray(boxes, np.float32),
                        feat_proj=fp)


def cascade_extent(m: int):
    half = 0.5 * (2.0 ** m)
    return 0.5 - half, 0.5 + half


def clipmap_boxes(eye, aabb_min, aabb_max, finest_extent: float = 0.25) -> np.ndarray:
    """Eye-centred nested clipmap boxes (slab.py:113-145): extents ×2 from
    ``finest_extent`` up to the scene aabb (the outermost box), each centred
    as near the eye as nesting in its parent allows, centres snapped to an
    extent/8 lattice so that small camera moves reuse a bake."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    eye = np.asarray(eye, np.float32)
    outer_extent = float(np.max(aabb_max - aabb_min))
    n_levels = max(1, int(np.round(np.log2(outer_extent / finest_extent))) + 1)
    boxes = np.zeros((n_levels, 2, 3), np.float32)
    boxes[n_levels - 1, 0] = aabb_min
    boxes[n_levels - 1, 1] = aabb_max
    for m in range(n_levels - 2, -1, -1):
        half = 0.5 * finest_extent * (2.0 ** m)
        quantum = max(finest_extent * 2.0 ** m / 8.0, 1e-3)
        lo_p, hi_p = boxes[m + 1]
        c = np.clip(eye, lo_p + half, hi_p - half)
        c = np.round(c / quantum) * quantum
        c = np.clip(c, lo_p + half, hi_p - half)  # the snap can leave the parent
        boxes[m, 0] = c - half
        boxes[m, 1] = c + half
    return boxes


# ---------------------------------------------------------------------------
# bake


def occupied_voxels(bitfield: torch.Tensor, max_mip: int, box_lo, box_hi, n: int,
                    inner=None) -> torch.Tensor:
    """Flat indices (ascending) of the n³ voxels of the box whose centres
    are occupied (slab.py:187-228, computed on the bitfield's device in the
    JAX package's numpy precision): a world position is occupied iff its
    scene cascade's bitfield cell is set; with ``inner`` = (lo, hi), voxels
    whose centres lie strictly inside that box are left out."""
    dev = bitfield.device
    Gb = bitfield.shape[1]
    cs = [float(box_lo[a]) + _div(torch.arange(n, dtype=torch.float32, device=dev) + 0.5, n)
          * float(np.float32(box_hi[a] - box_lo[a])) for a in range(3)]
    P = torch.stack(torch.meshgrid(*cs, indexing="ij"), -1).reshape(-1, 3)
    maxval = torch.amax(torch.abs(P - 0.5), dim=-1)
    _, e = torch.frexp(torch.clamp(maxval, min=1e-30))
    mip = torch.clamp(e + 1, 0, max_mip).to(torch.int64)
    # numpy's exp2 of the int mip is f64: the cell coordinate is computed there
    pm = (P - 0.5).to(torch.float64) * torch.exp2(-mip.to(torch.float64))[:, None] + 0.5
    i = torch.floor(pm * Gb).to(torch.int64)
    inb = torch.all((i >= 0) & (i < Gb), dim=-1)
    i = torch.clamp(i, 0, Gb - 1)
    occ = bitfield[mip, i[:, 0], i[:, 1], i[:, 2]] & inb
    if inner is not None:
        ilo = torch.as_tensor(np.asarray(inner[0], np.float32), device=dev)
        ihi = torch.as_tensor(np.asarray(inner[1], np.float32), device=dev)
        occ &= ~torch.all((P > ilo) & (P < ihi), dim=-1)
    return torch.nonzero(occ).squeeze(1)


def voxel_records(density_fn, rgb_fn, cells: torch.Tensor, box_lo, box_size, n: int,
                  aabb_min: torch.Tensor, aabb_max: torch.Tensor, origin_or_dir: torch.Tensor,
                  use_origin: bool, rgb_activation, density_activation,
                  feat_proj=None) -> torch.Tensor:
    """Voxel-centre records (slab.py:273-350): (C, 4 + F) f32 [σ_eff·rgb,
    σ_eff, σ_eff·((f − mu)/sd)@P]. ``density_fn(pos (n, 3) in the unit cube)
    → (n, 16)`` density-MLP outputs, ``rgb_fn(features (n, 16), warped
    directions (n, 3)) → (n, 3)`` rgb logits. σ_eff is transmittance
    corrected: −log(mean of exp(−σ·dz) over the centre and 4 sub-voxel taps)
    / dz, so that one step of a voxel's size keeps its mean transmittance."""
    dev = cells.device
    f32 = dict(dtype=torch.float32, device=dev)
    box_lo = torch.as_tensor(np.asarray(box_lo, np.float32), **f32)
    box_size = torch.as_tensor(np.asarray(box_size, np.float32), **f32)
    nf = float(n)
    cf = cells.to(torch.float32)
    world = box_lo + _div(cf + 0.5, nf) * box_size
    pos_w = (world - aabb_min) / (aabb_max - aabb_min)
    if use_origin:
        d = world - origin_or_dir
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    else:
        d = origin_or_dir.expand(world.shape)
    d_out = density_fn(pos_w).to(torch.float32)
    rgb = network_to_rgb(rgb_fn(d_out, warp_direction(d))[:, :3].to(torch.float32),
                         rgb_activation)
    sigma_c = network_to_density(d_out[:, 0], density_activation)
    dz = box_size[0] / nf
    sigmas = [sigma_c]
    for tap in _SIGMA_TAPS:
        world_t = box_lo + _div(cf + 0.5 + torch.as_tensor(tap, **f32), nf) * box_size
        pos_t = (world_t - aabb_min) / (aabb_max - aabb_min)
        sigmas.append(network_to_density(density_fn(pos_t)[:, 0].to(torch.float32),
                                          density_activation))
    trans = torch.mean(torch.stack([torch.exp(-s * dz) for s in sigmas]), dim=0)
    sigma_eff = -torch.log(torch.clamp(trans, min=1e-20)) / dz
    out = [rgb * sigma_eff[:, None], sigma_eff[:, None]]
    if feat_proj is not None:
        mu, sd, Pm = (torch.as_tensor(np.asarray(a, np.float32), **f32) for a in feat_proj)
        f = (d_out - mu) / sd @ Pm
        out.append(f * sigma_eff[:, None])
    return torch.cat(out, -1)


@torch.no_grad()
def bake_dense(density_fn, rgb_fn, bitfield: torch.Tensor, n_cascades: int, aabb_min, aabb_max,
               rgb_activation, density_activation, origin=None, res0: int = 256,
               res_outer: int = G, boxes=None, feat_proj=None) -> DenseVolumes:
    """Bake the model into dense per-level volumes on the bitfield's device
    (slab.py:148-259). Only occupied voxels are evaluated; the rest stay
    zero, and so do the voxels of level m > 0 whose centres lie inside level
    m − 1's box (the finer level owns them). bitfield: (≥ n_cascades, G, G,
    G) bool. boxes: per-level world boxes (an eye-centred clipmap may have
    more levels than the scene has cascades), else the cascade extents."""
    dev = bitfield.device
    f32 = dict(dtype=torch.float32, device=dev)
    C = 4 + (0 if feat_proj is None else int(np.shape(feat_proj[2])[1]))
    aabb = (torch.as_tensor(np.asarray(aabb_min, np.float32), **f32),
            torch.as_tensor(np.asarray(aabb_max, np.float32), **f32))
    origin_d = torch.as_tensor(np.asarray(FIXED_BAKE_DIR if origin is None else origin,
                                          np.float32), **f32)
    n_levels = len(boxes) if boxes is not None else n_cascades

    def level_box(m):
        if boxes is None:
            lo_c, hi_c = cascade_extent(m)
            return np.full(3, lo_c, np.float32), np.full(3, hi_c, np.float32)
        return np.asarray(boxes[m][0], np.float32), np.asarray(boxes[m][1], np.float32)

    volumes, res_list = [], []
    for m in range(n_levels):
        n = res0 if m == 0 else res_outer
        box_lo, box_hi = level_box(m)
        flat = occupied_voxels(bitfield, n_cascades - 1, box_lo, box_hi, n,
                               inner=level_box(m - 1) if m > 0 else None)
        vol = torch.zeros((n * n * n, C), dtype=torch.bfloat16, device=dev)
        for s in range(0, flat.shape[0], BAKE_CHUNK):
            f = flat[s:s + BAKE_CHUNK]
            cells = torch.stack([f // (n * n), (f // n) % n, f % n], -1).to(torch.int32)
            vol[f] = voxel_records(density_fn, rgb_fn, cells, box_lo, box_hi - box_lo, n, *aabb,
                                   origin_d, origin is not None, rgb_activation,
                                   density_activation, feat_proj).to(torch.bfloat16)
        volumes.append(vol.reshape(n, n, n, C))
        res_list.append(n)
    return DenseVolumes(volumes=volumes, res=res_list, n_cascades=n_levels, boxes=boxes,
                        feat_proj=feat_proj)


# ---------------------------------------------------------------------------
# sweep


def interp_matrix(sample_idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., B) fractional texel coordinates → (..., B, n) linear-interpolation
    weights; a coordinate outside [−1, n] gives a zero row."""
    j = torch.arange(n, dtype=torch.float32, device=sample_idx.device)
    return torch.clamp(1.0 - torch.abs(sample_idx[..., None] - j), min=0.0)


def _div(x: torch.Tensor, v) -> torch.Tensor:
    """x / v by IEEE division (PyTorch divides a CUDA tensor by a host
    scalar as a product with its reciprocal)."""
    return x / torch.full((), float(v), dtype=x.dtype, device=x.device)


def ray_box_entry(o, dirs: torch.Tensor, lo, hi) -> torch.Tensor:
    """The entry t of rays o + t·dir into the box [lo, hi] (host f32
    vectors o, lo, hi); +inf where they miss, 0 where o is inside."""
    o, lo, hi = (np.asarray(a, np.float32) for a in (o, lo, hi))
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12,
                            torch.where(dirs >= 0, 1e-12, -1e-12).to(dirs.dtype), dirs)
    t0 = torch.stack([inv[..., a] * float(lo[a] - o[a]) for a in range(3)], -1)
    t1 = torch.stack([inv[..., a] * float(hi[a] - o[a]) for a in range(3)], -1)
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    return torch.where(hit, torch.clamp(tmin, min=0.0), torch.inf)


@contextlib.contextmanager
def _product_precision(device):
    """TF32 for the slab products on the card: exact for their bf16-valued
    operands."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def slab_products(vol_t: torch.Tensor, ksl: torch.Tensor, Wu: torch.Tensor,
                  Wv: torch.Tensor) -> torch.Tensor:
    """The resampled slabs ksl of vol_t onto the baseplane: (L, B, n)
    interpolation matrices Wu, Wv and the (L, n, n, C) bf16 slabs give
    slab[l, u, v, c] = Σ_j Wv[l, v, j] · bf16(Σ_i Wu[l, u, i] · S[l, i, j, c]),
    each sum in f32 (slab.py:440-446). Returned as an (L, B, C, B) f32
    tensor, [l, u, c, v]: v runs fastest, as kernel P reads it."""
    L, B, n = Wu.shape
    S = vol_t.index_select(0, ksl).to(torch.float32).reshape(L, n, -1)
    C = S.shape[-1] // n
    with _product_precision(S.device):
        tmp = torch.bmm(Wu.to(torch.bfloat16).to(torch.float32), S).to(torch.bfloat16)
        t2 = torch.empty((L, B, C, n), dtype=torch.float32, device=S.device)
        t2.copy_(tmp.reshape(L, B, n, C).permute(0, 1, 3, 2))
        out = torch.bmm(t2.reshape(L, B * C, n),
                        Wv.to(torch.bfloat16).to(torch.float32).transpose(1, 2))
    return out.reshape(L, B, C, B)


def slab_step_plain(slab: torch.Tensor, a_k: torch.Tensor, dz: float, q: torch.Tensor,
                    t_inner: torch.Tensor, front: torch.Tensor, back: torch.Tensor) -> None:
    """Kernel P's plain version (slab.py:447-472): composite the resampled
    slabs (L, B, C, B) [l, u, c, v] front to back into the layers front and
    back (B, B, LAYER_CH + F) [rgb, T, Σw·t, features…], in place. Per slab
    l and pixel: σ = max(σ̃, 0); colour max(c̃, 0)/σ and features f̃/σ (σ at
    least 1e-8); the sample's distance t = a_k[l]·q; α = 1 − exp(−σ·dz·q);
    the sample goes to the front layer where t < t_inner, else the back.
    a_k[l] = (z_k − eye)·sign is the slab's axial distance ahead of the eye;
    q (B, B) the ray length a unit of axial distance."""
    for l in range(slab.shape[0]):
        s = slab[l].permute(0, 2, 1)  # (B, B, C) [u, v, c]
        sigma = torch.clamp(s[..., 3], min=0.0)
        inv_s = 1.0 / torch.clamp(sigma, min=1e-8)
        vals = torch.cat([torch.clamp(s[..., :3], min=0.0), s[..., 4:]], -1) * inv_s[..., None]
        t_k = a_k[l] * q
        alpha = 1.0 - torch.exp(-sigma * dz * q)
        mf = t_k < t_inner
        for lay, a in ((front, torch.where(mf, alpha, 0.0)), (back, torch.where(mf, 0.0, alpha))):
            T = lay[..., 3].clone()
            w = T * a
            lay[..., :3] = lay[..., :3] + w[..., None] * vals[..., :3]
            lay[..., 5:] = lay[..., 5:] + w[..., None] * vals[..., 3:]
            lay[..., 4] = lay[..., 4] + w * t_k
            lay[..., 3] = T * (1.0 - a)


@functools.lru_cache(maxsize=None)
def _slab_step_kernel():
    """Kernel P, built by Triton at its first launch."""
    import triton
    import triton.language as tl

    try:
        from triton.language.extra import libdevice
    except ImportError:  # older Triton
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def slab_step_kernel(slab_ptr, s_l, s_u, s_c, a_ptr, q_ptr, tin_ptr, front_ptr, back_ptr,
                         n_slabs, dz, B, NV: tl.constexpr, CL: tl.constexpr, VP: tl.constexpr,
                         BLOCK: tl.constexpr):
        # Kernel P: the slab step. Replaces the body of
        # instant_ngp_tpu/nerf/slab.py::sweep_octave after its two products
        # (slab.py:447-472); plain version slab_step_plain, in its order.
        # One program a block of BLOCK baseplane pixels p = u·B + v; it walks
        # the n_slabs slabs in order, the six carries (front and back: value
        # channels, T, Σw·t) in registers, read once and written once.
        pid = tl.program_id(0)
        p = pid * BLOCK + tl.arange(0, BLOCK)
        pm = p < B * B
        u = p // B
        v = p % B
        vc = tl.arange(0, VP)
        vmask = pm[:, None] & (vc < NV)[None, :]
        lch = tl.where(vc < 3, vc, vc + 2)  # value channel → layer channel
        sch = tl.where(vc < 3, vc, vc + 1)  # value channel → slab channel
        lay_off = p[:, None] * CL + lch[None, :]
        val_f = tl.load(front_ptr + lay_off, mask=vmask, other=0.0)
        val_b = tl.load(back_ptr + lay_off, mask=vmask, other=0.0)
        T_f = tl.load(front_ptr + p * CL + 3, mask=pm, other=1.0)
        T_b = tl.load(back_ptr + p * CL + 3, mask=pm, other=1.0)
        dw_f = tl.load(front_ptr + p * CL + 4, mask=pm, other=0.0)
        dw_b = tl.load(back_ptr + p * CL + 4, mask=pm, other=0.0)
        q = tl.load(q_ptr + p, mask=pm, other=1.0)
        tin = tl.load(tin_ptr + p, mask=pm, other=0.0)
        pix = u * s_u + v
        for l in range(n_slabs):
            base = slab_ptr + l * s_l + pix
            sigma = tl.maximum(tl.load(base + 3 * s_c, mask=pm, other=0.0), 0.0)
            sv = tl.load(base[:, None] + sch[None, :] * s_c, mask=vmask, other=0.0)
            inv_s = 1.0 / tl.maximum(sigma, 1e-8)
            vals = tl.where((vc < 3)[None, :], tl.maximum(sv, 0.0), sv) * inv_s[:, None]
            t_k = tl.load(a_ptr + l) * q
            alpha = 1.0 - libdevice.exp(-sigma * dz * q)
            mf = t_k < tin
            a_f = tl.where(mf, alpha, 0.0)
            a_b = tl.where(mf, 0.0, alpha)
            w_f = T_f * a_f
            w_b = T_b * a_b
            val_f = val_f + w_f[:, None] * vals
            dw_f = dw_f + w_f * t_k
            T_f = T_f * (1.0 - a_f)
            val_b = val_b + w_b[:, None] * vals
            dw_b = dw_b + w_b * t_k
            T_b = T_b * (1.0 - a_b)
        tl.store(front_ptr + lay_off, val_f, mask=vmask)
        tl.store(back_ptr + lay_off, val_b, mask=vmask)
        tl.store(front_ptr + p * CL + 3, T_f, mask=pm)
        tl.store(back_ptr + p * CL + 3, T_b, mask=pm)
        tl.store(front_ptr + p * CL + 4, dw_f, mask=pm)
        tl.store(back_ptr + p * CL + 4, dw_b, mask=pm)

    return triton, slab_step_kernel


SLAB_STEP_BLOCK = 256


def slab_step(slab: torch.Tensor, a_k: torch.Tensor, dz: float, q: torch.Tensor,
              t_inner: torch.Tensor, front: torch.Tensor, back: torch.Tensor) -> None:
    """See ``slab_step_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel P (Triton; one program a block of pixels, the
    slabs walked in order, the carries in registers; built without FMA
    contraction and with the accurate exp, in the plain version's order)."""
    if slab.device.type == "cpu":
        slab_step_plain(slab, a_k, dz, q, t_inner, front, back)
        return
    L, B, C, B2 = slab.shape
    CL = front.shape[-1]
    cuda_lib.check_cuda(a_k, q, t_inner, front, back, dtype=torch.float32)
    if (B2 != B or slab.dtype != torch.float32 or slab.stride(3) != 1 or slab.stride(1) != C * B
            or slab.stride(2) != B or CL != C + 1 or tuple(front.shape) != (B, B, CL)
            or back.shape != front.shape or q.shape != (B, B) or t_inner.shape != (B, B)
            or a_k.shape != (L,)):
        raise ValueError(f"slab step of slabs {tuple(slab.shape)} {slab.stride()} into layers "
                         f"{tuple(front.shape)}")
    if L == 0:
        return
    triton, kernel = _slab_step_kernel()
    NV = C - 1
    grid = (triton.cdiv(B * B, SLAB_STEP_BLOCK),)
    kernel[grid](slab, slab.stride(0), slab.stride(1), slab.stride(2), a_k, q, t_inner, front,
                 back, L, float(dz), B, NV=NV, CL=CL, VP=triton.next_power_of_2(NV),
                 BLOCK=SLAB_STEP_BLOCK, num_warps=4, enable_fp_fusion=False)
    cuda_lib.count("slab_step")


def _f32(x) -> np.float32:
    return np.float32(x)


def sweep_octave(vol_t: torch.Tensor, e_p, sign: float, lo_p, hi_p, k_first: int, z_base,
                 bp_lo, bp_hi, inner_lo_p, inner_hi_p, *, n: int, B: int, L: int,
                 use_kernel: bool = True):
    """Sweep L consecutive slabs (one depth octave) front to back
    (slab.py:378-485) → (front, back) layers, each (B, B, LAYER_CH + F)
    f32 [premultiplied rgb, T, Σw·t, features…]. vol_t: (n, n, n, 4 + F)
    bf16 with the sweep axis first; e_p, lo_p, hi_p, inner_*: (3,) in
    permuted coordinates (inner at +inf for the finest level); sign ±1;
    k_first: the physical index of the octave's nearest slab; z_base and
    the window bp_lo..bp_hi: the baseplane. Scalars are f32 on the host, as
    the JAX package's traced scalars are."""
    dev = vol_t.device
    e_p, lo_p, hi_p = (np.asarray(a, np.float32) for a in (e_p, lo_p, hi_p))
    bp_lo, bp_hi = np.asarray(bp_lo, np.float32), np.asarray(bp_hi, np.float32)
    z_base, sign = _f32(z_base), _f32(sign)
    CV = vol_t.shape[-1]
    CL = LAYER_CH + CV - 4
    dz = (hi_p[0] - lo_p[0]) / _f32(n)
    ar = _div(torch.arange(B, dtype=torch.float32, device=dev) + 0.5, B)
    u0 = float(bp_lo[0]) + ar * float(bp_hi[0] - bp_lo[0])
    v0 = float(bp_lo[1]) + ar * float(bp_hi[1] - bp_lo[1])
    uu, vv = torch.meshgrid(u0, v0, indexing="ij")
    zb_rel = z_base - e_p[0]
    du, dv = uu - float(e_p[1]), vv - float(e_p[2])
    dist = torch.sqrt(du * du + dv * dv + float(zb_rel * zb_rel))
    q = _div(dist, abs(zb_rel)).contiguous()
    dirs = torch.stack([torch.full_like(uu, float(zb_rel)), du, dv], -1) / dist[..., None]
    t_inner = ray_box_entry(e_p, dirs, inner_lo_p, inner_hi_p).contiguous()
    front = torch.zeros((B, B, CL), dtype=torch.float32, device=dev)
    front[..., 3] = 1.0
    back = front.clone()
    # JAX's mask (in the volume and ahead of the eye) leaves every carry as
    # it is where it is false; the slabs it keeps are a run j0 <= j < j1 (the
    # axial distance grows with j), found on the host in the same f32
    # arithmetic as the device's below
    sgn_i = 1 if sign > 0 else -1
    ksl_raw = k_first + sgn_i * np.arange(L)
    valid_k = (ksl_raw >= 0) & (ksl_raw < n)
    ksl = np.clip(ksl_raw, 0, n - 1)
    z_k = lo_p[0] + (ksl.astype(np.float32) + _f32(0.5)) * dz
    ahead = ((z_k - e_p[0]) * sign > _f32(0.49) * dz) & valid_k
    keep = np.nonzero(ahead)[0]
    if len(keep) == 0:
        return front, back
    j0, j1 = int(keep[0]), int(keep[-1]) + 1
    step = slab_step if use_kernel else slab_step_plain
    span_u, span_v = hi_p[1] - lo_p[1], hi_p[2] - lo_p[2]
    for s in range(j0, j1, SLAB_CHUNK):
        ksl_d = k_first + sgn_i * torch.arange(s, min(s + SLAB_CHUNK, j1), device=dev)
        zk_d = float(lo_p[0]) + (ksl_d.to(torch.float32) + 0.5) * float(dz)
        a_k = (zk_d - float(e_p[0])) * float(sign)
        sk = _div(zk_d - float(e_p[0]), zb_rel)[:, None]
        ui = _div(float(e_p[1]) + (u0 - float(e_p[1])) * sk - float(lo_p[1]), span_u) * n - 0.5
        vi = _div(float(e_p[2]) + (v0 - float(e_p[2])) * sk - float(lo_p[2]), span_v) * n - 0.5
        slab = slab_products(vol_t, ksl_d, interp_matrix(ui, n), interp_matrix(vi, n))
        step(slab, a_k, float(dz), q, t_inner, front, back)
    return front, back


# ---------------------------------------------------------------------------
# merge: resample a layer between two baseplanes of a group, composite


def resample_layer(layer: torch.Tensor, e_p, z_src, src_lo, src_hi, z_dst, dst_lo, dst_hi, *,
                   B_out: int) -> torch.Tensor:
    """Epipolar-rescale a (B, B, C) layer from baseplane z_src (window
    src_lo..src_hi) onto z_dst (window dst_lo..dst_hi) at B_out
    (slab.py:493-518); outside the source window the layer is empty (T 1,
    the rest 0). The products are f32."""
    B, C = layer.shape[0], layer.shape[-1]
    dev = layer.device
    e_p = np.asarray(e_p, np.float32)
    src_lo, src_hi, dst_lo, dst_hi = (np.asarray(a, np.float32)
                                      for a in (src_lo, src_hi, dst_lo, dst_hi))
    s = float((_f32(z_src) - e_p[0]) / (_f32(z_dst) - e_p[0]))
    ar = _div(torch.arange(B_out, dtype=torch.float32, device=dev) + 0.5, B_out)
    u_d = float(dst_lo[0]) + ar * float(dst_hi[0] - dst_lo[0])
    v_d = float(dst_lo[1]) + ar * float(dst_hi[1] - dst_lo[1])
    ui = _div(float(e_p[1]) + (u_d - float(e_p[1])) * s - float(src_lo[0]),
              src_hi[0] - src_lo[0]) * B - 0.5
    vi = _div(float(e_p[2]) + (v_d - float(e_p[2])) * s - float(src_lo[1]),
              src_hi[1] - src_lo[1]) * B - 0.5
    Wu, Wv = interp_matrix(ui, B), interp_matrix(vi, B)
    empty = torch.zeros((C,), dtype=torch.float32, device=dev)
    empty[3] = 1.0
    delta = layer - empty
    tmp = (Wu @ delta.reshape(B, B * C)).reshape(B_out, B, C)  # [u, j, c]
    out = (tmp.permute(0, 2, 1).reshape(B_out * C, B) @ Wv.T).reshape(B_out, C, B_out)
    return out.permute(0, 2, 1) + empty


def composite_layers(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a over b, (…, C) layers: channel 3 (T) multiplies, the others add
    weighted by a's T."""
    Ta = a[..., 3:4]
    return torch.cat([a[..., :3] + Ta * b[..., :3], Ta * b[..., 3:4], a[..., 4:] + Ta * b[..., 4:]],
                     -1)


# ---------------------------------------------------------------------------
# quad packing and the screen warp


def quad_pack(layers: torch.Tensor) -> torch.Tensor:
    """(…, B, B, C) → (prod(…)·B·B, 4·C) bf16 rows: row i·B + j of each
    layer holds [(i, j), (i, j+1), (i+1, j), (i+1, j+1)], clamped at the
    layer's own edges."""
    r1 = torch.cat([layers[..., :, 1:, :], layers[..., :, -1:, :]], -2)
    r2 = torch.cat([layers[..., 1:, :, :], layers[..., -1:, :, :]], -3)
    r3 = torch.cat([r2[..., :, 1:, :], r2[..., :, -1:, :]], -2)
    packed = torch.cat([layers, r1, r2, r3], -1)
    return packed.reshape(-1, packed.shape[-1]).to(torch.bfloat16)


def _bilinear_rows(rows: torch.Tensor, fu: torch.Tensor, fv: torch.Tensor) -> torch.Tensor:
    C = rows.shape[-1] // 4
    r = rows.to(torch.float32).reshape(-1, 4, C)
    w00 = (1 - fu) * (1 - fv)
    w01 = (1 - fu) * fv
    w10 = fu * (1 - fv)
    w11 = fu * fv
    return (w00[:, None] * r[:, 0] + w01[:, None] * r[:, 1] + w10[:, None] * r[:, 2]
            + w11[:, None] * r[:, 3])


def _cell(ui: torch.Tensor, B: int):
    i0 = torch.clamp(torch.floor(ui).to(torch.int64), 0, B - 1)
    return i0, torch.clamp(ui - i0.to(torch.float32), 0.0, 1.0)


def _empty_like_rows(out: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    empty = torch.zeros((out.shape[-1],), dtype=torch.float32, device=out.device)
    empty[3] = 1.0
    return torch.where(inside[:, None], out, empty)


def sample_packed(packed: torch.Tensor, B: int, ui: torch.Tensor, vi: torch.Tensor):
    """Bilinear sample of a quad-packed layer at fractional texel
    coordinates (ui, vi) (1-D), the empty layer outside it."""
    i0, fu = _cell(ui, B)
    j0, fv = _cell(vi, B)
    out = _bilinear_rows(packed[i0 * B + j0], fu, fv)
    inside = (ui >= -0.5) & (ui <= B - 0.5) & (vi >= -0.5) & (vi <= B - 0.5)
    return _empty_like_rows(out, inside)


def warp_rows(dirs, eye, zb_tab, win_lo_tab, win_hi_tab, *, B0: int, Bo: int, nc: int):
    """Each pixel's layers in composite order, as kernel O finds them: yields
    (li, outer (bool: the layer lies in the outer stack), the row of its
    quad-packed stack (N,) int64, fu, fv (N,), inside (N,) bool) for li = 0
    … 2·nc − 2 (slab.py:713-771)."""
    e = [float(x) for x in np.asarray(eye, np.float32)]
    d0, d1, d2 = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    a0, a1, a2 = torch.abs(d0), torch.abs(d1), torch.abs(d2)
    is0 = (a0 >= a1) & (a0 >= a2)
    is1 = (~is0) & (a1 >= a2)

    def sel(x, y, z):
        return torch.where(is0, x, torch.where(is1, y, z))

    d_a, du, dv = sel(d0, d1, d2), sel(d1, d2, d0), sel(d2, d0, d1)
    ones = torch.ones_like(d0)
    e_a, e_u, e_v = (sel(ones * e[i], ones * e[j], ones * e[k])
                     for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)))
    g = (torch.where(is0, 0, torch.where(is1, 2, 4)) + (d_a < 0).to(torch.int64)).to(torch.int64)
    n_layers = 2 * nc - 1
    mid = nc - 1
    for li in range(n_layers):
        if li == mid:
            B, row_base = B0, g * (B0 * B0)
        else:
            oi = li if li < mid else li - 1
            B, row_base = Bo, (g * (n_layers - 1) + oi) * (Bo * Bo)
        zb = zb_tab[g, li]
        lo, hi = win_lo_tab[g, li], win_hi_tab[g, li]
        s = (zb - e_a) / d_a
        u = e_u + du * s
        v = e_v + dv * s
        ui = (u - lo[:, 0]) / (hi[:, 0] - lo[:, 0]) * B - 0.5
        vi = (v - lo[:, 1]) / (hi[:, 1] - lo[:, 1]) * B - 0.5
        i0, fu = _cell(ui, B)
        j0, fv = _cell(vi, B)
        inside = (ui >= -0.5) & (ui <= B - 0.5) & (vi >= -0.5) & (vi <= B - 0.5)
        yield li, li != mid, row_base + i0 * B + j0, fu, fv, inside


def warp_composite_plain(dirs, eye, outer_pk, l_pk, zb_tab, win_lo_tab, win_hi_tab, bg, *,
                         B0: int, Bo: int, nc: int) -> torch.Tensor:
    """Kernel O's plain version (slab.py:697-790): the per-pixel screen warp
    of the 2·nc − 1 layers and their composite. dirs (N, 3) unit rays; eye
    (3,) numpy; outer_pk ((6·(2nc − 2)·Bo², 4C) bf16, per group [F_{nc−1} …
    F_1, B_1 … B_{nc−1}]) and l_pk ((6·B0², 4C), the innermost layer);
    zb_tab (6, 2nc − 1), win_*_tab (6, 2nc − 1, 2) f32 tensors in composite
    order [F_{nc−1} … F_1, L0, B_1 … B_{nc−1}]; bg (4,) f32 tensor. Returns
    (N, 5) [premultiplied rgb, α, depth] or, with features (C > 5), (N, C +
    1) [rgb, α, depth, T, features…]."""
    out = None
    for _, outer, row, fu, fv, inside in warp_rows(dirs, eye, zb_tab, win_lo_tab, win_hi_tab,
                                                    B0=B0, Bo=Bo, nc=nc):
        lay = _empty_like_rows(_bilinear_rows((outer_pk if outer else l_pk)[row], fu, fv), inside)
        out = lay if out is None else composite_layers(out, lay)
    rgb = out[:, :3] + out[:, 3:4] * bg[:3] * bg[3]
    alpha = 1.0 - out[:, 3] * (1.0 - bg[3])
    if out.shape[-1] > LAYER_CH:
        return torch.cat([rgb, alpha[:, None], out[:, 4:5], out[:, 3:4], out[:, 5:]], -1)
    return torch.cat([rgb, alpha[:, None], out[:, 4:5]], -1)


def warp_composite(dirs, eye, outer_pk, l_pk, zb_tab, win_lo_tab, win_hi_tab, bg, *, B0: int,
                   Bo: int, nc: int) -> torch.Tensor:
    """See ``warp_composite_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel O (one thread a pixel), which reads a quad row in
    16-byte words at C 6 and 8 and in 8-byte words at C 5 and 7: the packed
    layers must be so aligned."""
    if dirs.device.type == "cpu":
        return warp_composite_plain(dirs, eye, outer_pk, l_pk, zb_tab, win_lo_tab, win_hi_tab, bg,
                                    B0=B0, Bo=Bo, nc=nc)
    dirs = dirs.contiguous()
    C = l_pk.shape[-1] // 4
    n_layers = 2 * nc - 1
    cuda_lib.check_cuda(dirs, zb_tab, win_lo_tab, win_hi_tab, bg, dtype=torch.float32)
    cuda_lib.check_cuda(outer_pk, l_pk, dtype=torch.bfloat16)
    if (not 5 <= C <= 8 or outer_pk.shape[-1] != 4 * C or l_pk.shape[0] != 6 * B0 * B0
            or tuple(zb_tab.shape) != (6, n_layers) or tuple(win_lo_tab.shape) != (6, n_layers, 2)
            or win_hi_tab.shape != win_lo_tab.shape or (nc > 1 and outer_pk.shape[0]
                                                         != 6 * (n_layers - 1) * Bo * Bo)):
        raise ValueError(f"slab warp of layers {tuple(l_pk.shape)}, {tuple(outer_pk.shape)} with "
                         f"tables {tuple(zb_tab.shape)} (nc {nc}; kernel O takes 5 to 8 channels)")
    word = 16 if C % 2 == 0 else 8
    if outer_pk.data_ptr() % word or l_pk.data_ptr() % word:
        raise ValueError(f"kernel O reads C {C} quad rows in {word}-byte words: the packed layers "
                         f"must start {word}-byte aligned")
    N = dirs.shape[0]
    out = torch.empty((N, C + 1 if C > LAYER_CH else LAYER_CH), dtype=torch.float32,
                      device=dirs.device)
    if N > 0:
        e = [float(x) for x in np.asarray(eye, np.float32)]
        cuda_lib.launch("slab_warp", dirs.data_ptr(), N, *e, outer_pk.data_ptr(), l_pk.data_ptr(),
                        zb_tab.data_ptr(), win_lo_tab.data_ptr(), win_hi_tab.data_ptr(),
                        bg.data_ptr(), B0, Bo, nc, C, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# planning


def _clip_halfplane(poly, c):
    """Sutherland–Hodgman clip of a convex polygon [(x, y), …] to the
    half-plane c[0]·x + c[1]·y + c[2] ≥ 0."""
    out = []
    n = len(poly)
    for i in range(n):
        P, Q = poly[i], poly[(i + 1) % n]
        fp = c[0] * P[0] + c[1] * P[1] + c[2]
        fq = c[0] * Q[0] + c[1] * Q[1] + c[2]
        if fp >= 0:
            out.append(P)
        if (fp < 0) != (fq < 0):
            t = fp / (fp - fq)
            out.append((P[0] + t * (Q[0] - P[0]), P[1] + t * (Q[1] - P[1])))
    return out


def plan_groups_host(xform, wh, fl, pp):
    """The exact per-group (du, dv) extremes of an undistorted perspective
    camera, on the host (slab.py:601-656): a group's pixels are a convex
    polygon of the image rectangle, and du, dv, linear-fractional in the
    pixel, take their extremes at its vertices. Returns (groups, duv_lo (6,
    2) f32, duv_hi (6, 2) f32)."""
    Rm = np.asarray(xform, np.float64)[:, :3]
    W, H = float(wh[0]), float(wh[1])
    fx, fy = float(fl[0]), float(fl[1])
    cx, cy = float(pp[0]), float(pp[1])
    M = Rm @ np.array([[W / fx, 0.0, -cx * W / fx],
                       [0.0, H / fy, -cy * H / fy],
                       [0.0, 0.0, 1.0]])
    x0, x1 = 0.5 / W, 1.0 - 0.5 / W
    y0, y1 = 0.5 / H, 1.0 - 0.5 / H
    rect = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    big = 1e9
    duv_lo = np.full((6, 2), big, np.float32)
    duv_hi = np.full((6, 2), -big, np.float32)
    groups = []
    for g in range(6):
        a = g // 2
        s = 1.0 if g % 2 == 0 else -1.0
        pa, pu, pv = s * M[a], M[(a + 1) % 3], M[(a + 2) % 3]
        poly = rect
        for c in (pa - pu, pa + pu, pa - pv, pa + pv):
            poly = _clip_halfplane(poly, c)
            if len(poly) < 3:
                break
        if len(poly) < 3:
            continue
        V = np.array([[x, y, 1.0] for x, y in poly])
        den = V @ pa
        if np.any(den <= 1e-12):
            if np.all(den <= 1e-12):
                continue
            den = np.maximum(den, 1e-12)
        du = (V @ pu) / den * s
        dv = (V @ pv) / den * s
        duv_lo[g] = [du.min(), dv.min()]
        duv_hi[g] = [du.max(), dv.max()]
        groups.append(g)
    return groups, duv_lo, duv_hi


def group_stats(dirs: torch.Tensor):
    """The per-group plan reduced on the rays' device (slab.py:659-677):
    (counts (6,), lo (6, 2), hi (6, 2)) numpy, lo/hi the extremes of (du,
    dv) = (d_u/d_a, d_v/d_a) over each dominant-axis-and-sign group (1e9 and
    −1e9 for an empty group)."""
    ax = torch.argmax(torch.abs(dirs), dim=-1)
    d_a = torch.gather(dirs, 1, ax[:, None])[:, 0]
    g = ax * 2 + (d_a < 0).to(torch.int64)
    du = torch.gather(dirs, 1, ((ax + 1) % 3)[:, None])[:, 0] / d_a
    dv = torch.gather(dirs, 1, ((ax + 2) % 3)[:, None])[:, 0] / d_a
    counts = torch.bincount(g, minlength=6)
    duv = torch.stack([du, dv], -1)
    lo = torch.full((6, 2), 1e9, dtype=torch.float32, device=dirs.device)
    hi = torch.full((6, 2), -1e9, dtype=torch.float32, device=dirs.device)
    gi = g[:, None].expand(-1, 2)
    lo = lo.scatter_reduce(0, gi, duv, "amin")
    hi = hi.scatter_reduce(0, gi, duv, "amax")
    stats = torch.cat([counts.to(torch.float32)[:, None], lo, hi], 1).cpu().numpy()
    return stats[:, 0].astype(np.int64), stats[:, 1:3].copy(), stats[:, 3:5].copy()


def static_ladder(n: int) -> tuple:
    """Octave lengths (8, 8, 16, 32, …) until they cover n slabs, the same
    for every camera."""
    out, c, length = [], 0, 8
    while c < n:
        out.append(length)
        c += length
        if len(out) >= 2:
            length *= 2
    return tuple(out)


def _plan_octaves(e_p0, n, lo, hi, sign):
    """One (group, level) sweep cut into depth octaves (slab.py:933-974):
    [(k_first, L, z_base)], offsets [0, 8), [8, 16), [16, 32), … from the
    first slab ahead of the eye, each octave's baseplane at its far edge."""
    dz = (hi - lo) / n
    if sign > 0:
        k0 = max(int(np.ceil((e_p0 + 0.49 * dz - lo) / dz - 0.5)), 0)
        m_ahead = n - k0
    else:
        k0 = min(int(np.floor((e_p0 - 0.49 * dz - lo) / dz - 0.5)), n - 1)
        m_ahead = k0 + 1
    if m_ahead <= 0:
        return []
    out = []
    c = 0
    length = 8
    while c < m_ahead:
        L = min(length, max(m_ahead - c, 1))
        L_static = length
        k_first = k0 + (c if sign > 0 else -c)
        k_last_off = c + L - 1
        if sign > 0:
            z_base = lo + (k0 + k_last_off + 1) * dz
        else:
            z_base = lo + (k0 - k_last_off) * dz
        out.append((k_first, L_static, float(z_base)))
        c += L
        if len(out) >= 2:
            length *= 2
    return out


def _host_k0(e0: float, n: int, lo: float, hi: float, sign: float) -> int:
    """The first slab at or ahead of the eye along the sweep axis."""
    dz = (hi - lo) / n
    if sign > 0:
        k0 = int(np.ceil((e0 + 0.49 * dz - lo) / dz - 0.5))
        return int(np.clip(max(k0, 0), -1, n))
    k0 = int(np.floor((e0 - 0.49 * dz - lo) / dz - 0.5))
    return int(np.clip(min(k0, n - 1), -1, n))


def _footprint_f32(e_p, z_b, dz, duv_lo, duv_hi):
    """A group's ray footprint on plane z_b padded by 2 voxels, in f32 (the
    fused sweep's traced arithmetic, slab.py:875-884)."""
    s = z_b - e_p[0]
    us = np.float32([duv_lo[0] * s, duv_hi[0] * s])
    vs = np.float32([duv_lo[1] * s, duv_hi[1] * s])
    pad = _f32(2) * dz
    wlo = np.float32([e_p[1] + us.min() - pad, e_p[2] + vs.min() - pad])
    whi = np.float32([e_p[1] + us.max() + pad, e_p[2] + vs.max() + pad])
    return wlo, np.maximum(whi, wlo + _f32(1e-4))


def _fold(merged, front, back, e_p, z_b, wlo, whi, B):
    """Composite the farther merged pair behind this octave's layers, on
    this octave's baseplane."""
    if merged is None:
        return (front, back, z_b, wlo, whi)
    mf, mb, z_far, lo_far, hi_far = merged
    args = (e_p, z_far, lo_far, hi_far, z_b, wlo, whi)
    mf = resample_layer(mf, *args, B_out=B)
    mb = resample_layer(mb, *args, B_out=B)
    return (composite_layers(front, mf), composite_layers(back, mb), z_b, wlo, whi)


def sweep_group_merged(vols_t, e_p, sign, boxes_p, k0s, duv_lo, duv_hi, *, specs, B0: int,
                       Bo: int, use_kernel: bool = True):
    """One group's sweep of every level's static octave ladder, octaves
    merged far to near, each level's front and back folded onto the finest
    level's nearest baseplane (slab.py:848-930) → (layer (B0, B0, C), z0,
    wlo0, whi0). specs: ((n_m, ladder_m), …). Scalars are f32 on the host."""
    e_p = np.asarray(e_p, np.float32)
    sign = _f32(sign)
    boxes_p = np.asarray(boxes_p, np.float32)
    k0s = np.asarray(k0s, np.int32)
    inf3 = np.full((3,), np.inf, np.float32)
    sgn_i = 1 if sign > 0 else -1
    per_level = []
    for m, (n, ladder) in enumerate(specs):
        blo_p, bhi_p = boxes_p[m, 0], boxes_p[m, 1]
        dz = (bhi_p[0] - blo_p[0]) / _f32(n)
        ilo = boxes_p[m - 1, 0] if m > 0 else inf3
        ihi = boxes_p[m - 1, 1] if m > 0 else inf3
        B = B0 if m == 0 else Bo
        plans, off = [], 0
        for L in ladder:
            k_first = int(k0s[m]) + sgn_i * off
            k_last = off + L - 1
            k0f = _f32(k0s[m])
            if sign > 0:
                z_base = blo_p[0] + (k0f + _f32(k_last) + _f32(1)) * dz
            else:
                z_base = blo_p[0] + (k0f - _f32(k_last)) * dz
            plans.append((k_first, L, z_base))
            off += L
        merged = None
        for k_first, L, z_b in reversed(plans):
            wlo, whi = _footprint_f32(e_p, z_b, dz, duv_lo, duv_hi)
            front, back = sweep_octave(vols_t[m], e_p, sign, blo_p, bhi_p, k_first, z_b, wlo,
                                       whi, ilo, ihi, n=n, B=B, L=L, use_kernel=use_kernel)
            merged = _fold(merged, front, back, e_p, z_b, wlo, whi, B)
        per_level.append(merged)
    f0, b0, z0, wlo0, whi0 = per_level[0]
    layer = composite_layers(f0, b0)
    for m in range(1, len(specs)):
        fm, bm, zm, wlom, whim = per_level[m]
        args = (e_p, zm, wlom, whim, z0, wlo0, whi0)
        fm = resample_layer(fm, *args, B_out=B0)
        bm = resample_layer(bm, *args, B_out=B0)
        layer = composite_layers(fm, composite_layers(layer, bm))
    return layer, z0, wlo0, whi0


def _empty_layer(B: int, C: int, device) -> torch.Tensor:
    lay = torch.zeros((B, B, C), dtype=torch.float32, device=device)
    lay[..., 3] = 1.0
    return lay


def _tables(zb_tab, win_lo_tab, win_hi_tab, background, device):
    return (torch.as_tensor(zb_tab, device=device), torch.as_tensor(win_lo_tab, device=device),
            torch.as_tensor(win_hi_tab, device=device),
            torch.as_tensor(np.asarray(background, np.float32), device=device))


def _render_fused(dvols, eye, dirs, groups, duv_lo, duv_hi, vol_t, background, B0, Bo,
                  use_kernels, group=None):
    """The merged frame (slab.py:988-1054): one merged sweep a present group,
    then one warp of one layer a group."""
    nc = dvols.n_cascades
    dev = dirs.device
    specs = tuple((dvols.res[m], static_ladder(dvols.res[m])) for m in range(nc))
    zb_tab = np.zeros((6, 1), np.float32)
    win_lo_tab = np.ones((6, 1, 2), np.float32)
    win_hi_tab = np.full((6, 1, 2), 2.0, np.float32)  # degenerate
    layers = {}
    for g in groups:
        g = int(g)
        a, sgn = g // 2, (-1.0 if g % 2 else 1.0)
        perm = _PERMS[a]
        e_p = eye[list(perm)]
        boxes_p = np.zeros((nc, 2, 3), np.float32)
        k0s = np.zeros(nc, np.int32)
        for m in range(nc):
            blo, bhi = dvols.box(m)
            boxes_p[m, 0] = blo[list(perm)]
            boxes_p[m, 1] = bhi[list(perm)]
            k0s[m] = _host_k0(float(e_p[0]), dvols.res[m], float(boxes_p[m, 0, 0]),
                              float(boxes_p[m, 1, 0]), sgn)
        dlo, dhi = duv_lo[g], duv_hi[g]
        layer, _, _, _ = sweep_group_merged(vol_t[a], e_p, sgn, boxes_p, k0s, dlo, dhi,
                                            specs=specs, B0=B0, Bo=Bo, use_kernel=use_kernels)
        layers[g] = layer
        # the host mirror of level 0's first-octave baseplane and window
        n0 = dvols.res[0]
        lo0, hi0 = float(boxes_p[0, 0, 0]), float(boxes_p[0, 1, 0])
        dz0 = (hi0 - lo0) / n0
        L0 = specs[0][1][0]
        if sgn > 0:
            z0 = lo0 + (k0s[0] + L0) * dz0
        else:
            z0 = lo0 + (k0s[0] - (L0 - 1)) * dz0
        s = z0 - float(e_p[0])
        us = np.float32([dlo[0] * s, dhi[0] * s])
        vs = np.float32([dlo[1] * s, dhi[1] * s])
        pad = 2 * dz0
        wlo = np.float32([e_p[1] + us.min() - pad, e_p[2] + vs.min() - pad])
        whi = np.float32([e_p[1] + us.max() + pad, e_p[2] + vs.max() + pad])
        whi = np.maximum(whi, wlo + 1e-4)
        zb_tab[g, 0] = z0
        win_lo_tab[g, 0] = wlo
        win_hi_tab[g, 0] = whi
    empty = _empty_layer(B0, dvols.layer_ch, dev)
    l_pk = quad_pack(torch.stack([layers.get(g, empty) for g in range(6)]))
    outer_pk = torch.zeros((1, 4 * dvols.layer_ch), dtype=torch.bfloat16, device=dev)
    warp = _warp(use_kernels, group)
    return warp(dirs, eye, outer_pk, l_pk, *_tables(zb_tab, win_lo_tab, win_hi_tab, background,
                                                   dev), B0=B0, Bo=Bo, nc=1)


def transposed_volumes(dvols: DenseVolumes, axes) -> dict:
    """The volumes with each sweep axis of ``axes`` first, made once a bake
    (``vt_cache``)."""
    if dvols.vt_cache is None:
        dvols.vt_cache = {}
    for a in axes:
        if a not in dvols.vt_cache:
            perm = _PERMS[a]
            dvols.vt_cache[a] = [v.permute(*perm, 3).contiguous() for v in dvols.volumes]
    return dvols.vt_cache


def _warp(use_kernels: bool, group=None):
    """Kernel O (or its plain version); over a process group, pixel-sharded
    (slab.py:680-695, ``_warp_sharded``): each rank warps its contiguous
    slice of the rays, the packed layers and tables replicated, and the
    frame is gathered."""
    warp = warp_composite if use_kernels else warp_composite_plain
    if group is None:
        return warp

    def sharded(dirs, *args, **kw):
        return sharding.dp_render(lambda d: warp(d, *args, **kw), group)(dirs)

    return sharded


@torch.no_grad()
def render_frame(dvols: DenseVolumes, eye, dirs: torch.Tensor, background=(0.0, 0.0, 0.0, 0.0),
                 B0: int = 512, Bo: int = 256, merge_layers: bool = True, plan=None,
                 use_kernels: bool = True, group=None) -> torch.Tensor:
    """Render unit ray directions dirs (N, 3) from ``eye`` through the dense
    volumes (slab.py:1057-1244) → (N, 5) [premultiplied rgb, α, depth] (or
    with features (N, C + 1), see ``warp_composite_plain``) on the rays'
    device. Per (group, level) the volume is swept in depth octaves merged
    far to near; ``merge_layers`` folds every level onto the finest one's
    baseplane before a one-layer warp (the static ladder of every level,
    one compiled-shape plan for all cameras), else the warp composites the
    2·nc − 1 per-level-side layers (each level's own octave plan). plan:
    ``plan_groups_host``'s result, else ``group_stats`` on the device.
    ``use_kernels`` False runs P and O's plain versions on any device.
    ``group``: a process group over which the final warp is pixel-sharded
    (``_warp``); the sweeps run on every rank."""
    eye = np.asarray(eye, np.float32)
    dev = dirs.device
    nc = dvols.n_cascades
    n_layers = 1 if merge_layers else 2 * nc - 1
    mid = 0 if merge_layers else nc - 1
    if plan is not None:
        groups, duv_lo, duv_hi = plan
    else:
        counts, duv_lo, duv_hi = group_stats(dirs)
        groups = np.nonzero(counts > 0)[0]
    vol_t = transposed_volumes(dvols, sorted({int(g) // 2 for g in groups}))
    if merge_layers:
        return _render_fused(dvols, eye, dirs, groups, duv_lo, duv_hi, vol_t, background, B0, Bo,
                             use_kernels, group)

    zb_tab = np.zeros((6, n_layers), np.float32)
    win_lo_tab = np.ones((6, n_layers, 2), np.float32)
    win_hi_tab = np.full((6, n_layers, 2), 2.0, np.float32)  # degenerate
    Cl = dvols.layer_ch
    l_dev = _empty_layer(B0, Cl, dev)[None].repeat(6, 1, 1, 1)
    outer_dev = None
    if nc > 1:
        outer_dev = _empty_layer(Bo, Cl, dev)[None, None].repeat(6, n_layers - 1, 1, 1, 1)
    inf3 = np.full(3, np.inf, np.float32)
    for g in groups:
        a, sgn = int(g // 2), (-1.0 if g % 2 else 1.0)
        perm = _PERMS[a]
        e_p = eye[list(perm)]
        dlo, dhi = duv_lo[g], duv_hi[g]

        def footprint(z_b, dz):
            s = z_b - e_p[0]
            us = np.float32([dlo[0] * s, dhi[0] * s])
            vs = np.float32([dlo[1] * s, dhi[1] * s])
            pad = 2 * dz
            wlo = np.float32([e_p[1] + us.min() - pad, e_p[2] + vs.min() - pad])
            whi = np.float32([e_p[1] + us.max() + pad, e_p[2] + vs.max() + pad])
            return wlo, np.maximum(whi, wlo + 1e-4)

        per_cascade = []
        for m in range(nc):
            n = dvols.res[m]
            box_lo, box_hi = dvols.box(m)
            blo_p = box_lo[list(perm)]
            bhi_p = box_hi[list(perm)]
            lo, hi = float(blo_p[0]), float(bhi_p[0])
            dz = (hi - lo) / n
            if m == 0:
                ilo, ihi = inf3, inf3
            else:
                in_lo, in_hi = dvols.box(m - 1)
                ilo = in_lo[list(perm)]
                ihi = in_hi[list(perm)]
            B = B0 if m == 0 else Bo
            merged = None
            for k_first, L, z_b in reversed(_plan_octaves(float(e_p[0]), n, lo, hi, sgn)):
                wlo, whi = footprint(z_b, dz)
                front, back = sweep_octave(vol_t[a][m], e_p, sgn, blo_p, bhi_p, k_first, z_b, wlo,
                                           whi, ilo, ihi, n=n, B=B, L=L, use_kernel=use_kernels)
                merged = _fold(merged, front, back, e_p, z_b, wlo, whi, B)
            if merged is None:  # the eye beyond the far face: no slabs
                z_fake = float(e_p[0] + sgn)
                wlo, whi = footprint(z_fake, dz)
                empty = _empty_layer(B, Cl, dev)
                merged = (empty, empty, z_fake, wlo, whi)
            per_cascade.append(merged)
        f0, b0, z0, wlo0, whi0 = per_cascade[0]
        zb_tab[g, mid] = z0
        win_lo_tab[g, mid] = wlo0
        win_hi_tab[g, mid] = whi0
        l_dev[g] = composite_layers(f0, b0)
        for m in range(1, nc):
            fm, bm, zm, wlom, whim = per_cascade[m]
            for li, lay in ((mid - m, fm), (mid + m, bm)):
                zb_tab[g, li] = zm
                win_lo_tab[g, li] = wlom
                win_hi_tab[g, li] = whim
                outer_dev[g, li if li < mid else li - 1] = lay
    l_pk = quad_pack(l_dev)
    outer_pk = (quad_pack(outer_dev) if outer_dev is not None
                else torch.zeros((1, 4 * Cl), dtype=torch.bfloat16, device=dev))
    warp = _warp(use_kernels, group)
    return warp(dirs, eye, outer_pk, l_pk, *_tables(zb_tab, win_lo_tab, win_hi_tab, background,
                                                   dev), B0=B0, Bo=Bo, nc=nc)


def deferred_decode(out: torch.Tensor, dirs: torch.Tensor, rgb_fn, feat_proj,
                    rgb_activation) -> torch.Tensor:
    """The per-pixel deferred view-dependent decode (slab.py:793-832): the
    warp's [rgb, α, depth, T, feat(F)] → [rgb, α, depth]. The composited
    feature over the content opacity W = 1 − T, reconstructed through the
    PCA basis, goes through the rgb MLP (``rgb_fn``, kernel B) at the
    pixel's direction and at the bake's fixed direction; W times their
    difference is added to the baked colour."""
    mu, sd, Pm = (torch.as_tensor(np.asarray(a, np.float32), device=out.device)
                  for a in feat_proj)
    W = 1.0 - out[:, 5]
    fbar = out[:, 6:] / torch.clamp(W, min=1e-6)[:, None]
    recon = (fbar @ Pm.T * sd + mu).to(torch.bfloat16).to(torch.float32)
    d_fixed = torch.as_tensor(FIXED_BAKE_DIR, device=out.device).expand(dirs.shape)

    def head(d):
        return network_to_rgb(rgb_fn(recon, warp_direction(d))[:, :3].to(torch.float32),
                              rgb_activation)

    spec = head(dirs) - head(d_fixed)
    rgb = out[:, :3] + W[:, None] * spec
    return torch.cat([rgb, out[:, 3:5]], -1)
