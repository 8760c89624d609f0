"""Quality metrics: MSE/PSNR/SSIM/L1/MAPE/SMAPE and LDR-ꟻLIP (port of
``instant_ngp_tpu/metrics.py``, a copy: numpy in, numpy out).

The evaluation protocol of the reference's scripts/common.py:175-253 (the
PSNR/SSIM/ꟻLIP of ``run --test_transforms``) and
Testbed::compute_image_mse (testbed_image.cu:490-547). The evaluation runs
on the host over frames the card has rendered.
"""

from __future__ import annotations

import numpy as np


def mse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def mse_to_psnr(x: float) -> float:
    return -10.0 * np.log(max(x, 1e-30)) / np.log(10.0)


def psnr(a, b) -> float:
    return mse_to_psnr(mse(a, b))


def l1(a, b):
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def mape(ref, img):
    ref, img = np.asarray(ref, np.float64), np.asarray(img, np.float64)
    return float(np.mean(np.abs(img - ref) / (np.abs(ref) + 1e-2)))


def smape(ref, img):
    ref, img = np.asarray(ref, np.float64), np.asarray(img, np.float64)
    return float(np.mean(2.0 * np.abs(img - ref) / (np.abs(ref) + np.abs(img) + 1e-2)))


# ---------------------------------------------------------------------------
# Exact LDR-ꟻLIP (Andersson, Nilsson, Akenine-Möller, Oskarsson, Åström,
# Fairchild — "FLIP: A Difference Evaluator for Alternating Images", HPG
# 2020). Numerically matches the evaluator the reference vendors at
# scripts/flip/ (used by scripts/run.py --test_transforms); all constants
# are the published algorithm's. Implemented HWC with separable 1-D
# convolutions (the paper's CSF kernels are sums of separable Gaussians,
# and its edge/point detectors factor as h(x)·g(y)), so the hot path is
# scipy.ndimage.convolve1d instead of dense 2-D convolution.
# ---------------------------------------------------------------------------

# sRGB→XYZ (D65) — exact rational form of the sRGB standard matrix
_RGB2XYZ = np.array([
    [10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
    [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
    [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382],
])
_WHITE = _RGB2XYZ.sum(1)  # XYZ of linear-RGB (1,1,1)

# CSF parameters per opponent channel: (a1, b1, a2, b2) — the paper's
# fitted sums of two Gaussians for achromatic / red-green / blue-yellow
_CSF = {
    "A": (1.0, 0.0047, 0.0, 1e-5),
    "RG": (1.0, 0.0053, 0.0, 1e-5),
    "BY": (34.1, 0.04, 13.5, 0.025),
}


def _srgb_to_linear(c):
    c = np.asarray(c, np.float64)
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linear_to_ycxcz(rgb):
    xyz = rgb @ _RGB2XYZ.T / _WHITE
    y = 116.0 * xyz[..., 1] - 16.0
    cx = 500.0 * (xyz[..., 0] - xyz[..., 1])
    cz = 200.0 * (xyz[..., 1] - xyz[..., 2])
    return np.stack([y, cx, cz], -1)


def _ycxcz_to_linear(ycc):
    y = (ycc[..., 0] + 16.0) / 116.0
    x = y + ycc[..., 1] / 500.0
    z = y - ycc[..., 2] / 200.0
    xyz = np.stack([x, y, z], -1) * _WHITE
    return xyz @ np.linalg.inv(_RGB2XYZ).T


def _linear_to_lab(rgb):
    xyz = rgb @ _RGB2XYZ.T / _WHITE
    delta, limit = 6.0 / 29.0, 0.00885
    f = np.where(xyz > limit, np.cbrt(xyz),
                 xyz / (3.0 * delta * delta) + 4.0 / 29.0)
    l_ = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([l_, a, b], -1)


def _hunt(lab):
    """Hunt adjustment: chroma scaled by 0.01·L (paper eq. for
    perceptually uniform space)."""
    l_ = lab[..., 0]
    return np.stack([l_, 0.01 * l_ * lab[..., 1], 0.01 * l_ * lab[..., 2]], -1)


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.hypot(d[..., 1], d[..., 2])


def _conv_sep(img, kx, ky):
    """2-D convolution by separable 1-D kernels with edge ('nearest')
    padding, matching the paper code's edge-padded convolve2d."""
    from scipy.ndimage import convolve1d

    out = convolve1d(img, kx, axis=1, mode="nearest")
    return convolve1d(out, ky, axis=0, mode="nearest")


def _csf_filtered(ycc, ppd):
    """Per-channel CSF filtering in YCxCz, then clamp in linear RGB —
    the paper's spatial_filter. Kernel radius is shared across channels
    (set by the widest scale parameter, b=0.04)."""
    r = int(np.ceil(3.0 * np.sqrt(0.04 / (2.0 * np.pi**2)) * ppd))
    x = np.arange(-r, r + 1, dtype=np.float64) / ppd
    out = np.empty_like(ycc)
    for ch, name in enumerate(("A", "RG", "BY")):
        a1, b1, a2, b2 = _CSF[name]
        # each term a·sqrt(pi/b)·exp(-pi²(x²+y²)/b) factors into
        # 1-D Gaussians; the final kernel is normalized by its total sum
        g1 = np.exp(-np.pi**2 * x**2 / b1)
        g2 = np.exp(-np.pi**2 * x**2 / b2)
        w1 = a1 * np.sqrt(np.pi / b1)
        w2 = a2 * np.sqrt(np.pi / b2)
        total = w1 * g1.sum() ** 2 + w2 * g2.sum() ** 2
        f = (w1 * _conv_sep(ycc[..., ch], g1, g1)
             + w2 * _conv_sep(ycc[..., ch], g2, g2))
        out[..., ch] = f / total
    return np.clip(_ycxcz_to_linear(out), 0.0, 1.0)


def _features(y, ppd, kind):
    """Edge / point feature maps of the achromatic channel: the paper's
    Gaussian-derivative detectors with positive and negative lobes
    separately normalized (they factor over x/y since the lobe sign
    depends on x alone). Returns (H, W) feature magnitude."""
    w = 0.082
    sd = 0.5 * w * ppd
    r = int(np.ceil(3.0 * sd))
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sd * sd))
    h = -x * g if kind == "edge" else (x**2 / (sd * sd) - 1.0) * g
    hn = np.where(h < 0, h / max(-h[h < 0].sum(), 1e-30),
                  h / max(h[h > 0].sum(), 1e-30))
    gn = g / g.sum()
    fx = _conv_sep(y, hn, gn)
    fy = _conv_sep(y, gn, hn)
    return np.hypot(fx, fy)


def flip_map(reference, test, ppd: float | None = None) -> np.ndarray:
    """Per-pixel LDR-ꟻLIP error map for sRGB images in [0,1] (H, W, 3+).

    ppd defaults to the paper's viewing conditions (0.7 m distance,
    0.7 m-wide 3840-px monitor → ~67 pixels per degree)."""
    if ppd is None:
        ppd = 0.7 * (3840 / 0.7) * (np.pi / 180.0)
    qc, qf, pc, pt = 0.7, 0.5, 0.4, 0.95

    ref = _linear_to_ycxcz(_srgb_to_linear(
        np.clip(np.asarray(reference, np.float64)[..., :3], 0, 1)))
    tst = _linear_to_ycxcz(_srgb_to_linear(
        np.clip(np.asarray(test, np.float64)[..., :3], 0, 1)))

    # --- color pipeline: CSF filter → Lab+Hunt → HyAB → redistribute
    ref_h = _hunt(_linear_to_lab(_csf_filtered(ref, ppd)))
    tst_h = _hunt(_linear_to_lab(_csf_filtered(tst, ppd)))
    delta_c = _hyab(ref_h, tst_h) ** qc
    green = _hunt(_linear_to_lab(np.array([[[0.0, 1.0, 0.0]]])))
    blue = _hunt(_linear_to_lab(np.array([[[0.0, 0.0, 1.0]]])))
    cmax = float((_hyab(green, blue) ** qc).item())
    pccmax = pc * cmax
    delta_c = np.where(
        delta_c < pccmax, (pt / pccmax) * delta_c,
        pt + ((delta_c - pccmax) / (cmax - pccmax)) * (1.0 - pt))

    # --- feature pipeline on normalized luminance
    y_ref = (ref[..., 0] + 16.0) / 116.0
    y_tst = (tst[..., 0] + 16.0) / 116.0
    delta_f = np.maximum(
        np.abs(_features(y_ref, ppd, "edge") - _features(y_tst, ppd, "edge")),
        np.abs(_features(y_tst, ppd, "point") - _features(y_ref, ppd, "point")))
    delta_f = (delta_f / np.sqrt(2.0)) ** qf

    return delta_c ** (1.0 - delta_f)


def flip(reference, test, ppd: float | None = None) -> float:
    """Mean LDR-ꟻLIP error (see flip_map)."""
    return float(np.mean(flip_map(reference, test, ppd)))


def ssim(a, b, data_range: float = 1.0) -> float:
    """Mean SSIM with an 11×11 Gaussian window (σ=1.5), per channel —
    the standard formulation scripts/common.py relies on via skimage."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]

    # 11-tap Gaussian
    r = 5
    x = np.arange(-r, r + 1)
    g = np.exp(-(x**2) / (2 * 1.5**2))
    g /= g.sum()

    def blur(img):
        out = img
        out = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 0, out)
        out = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 1, out)
        return out

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = blur(a), blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = blur(a * a) - mu_aa
    s_bb = blur(b * b) - mu_bb
    s_ab = blur(a * b) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / ((mu_aa + mu_bb + c1) * (s_aa + s_bb + c2))
    return float(np.mean(ssim_map))
