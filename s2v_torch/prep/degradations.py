"""Training-data degradation pipeline, the full GPEN/GFPGAN kernel zoo (a
copy of s2v_tpu/prep/degradations.py's numpy/scipy code; reference:
third_part/GPEN/training/data_loader/degradations.py:16-765 and
dataset_face.py:14-71 GFPGAN_degradation).

Kernel families (degradations.py):
- bivariate (an)isotropic Gaussian          :84-109
- bivariate generalized Gaussian (beta pow) :112-144
- bivariate plateau 1/(1+x^beta)            :147-176
- random_* samplers with multiplicative
  kernel noise                              :179-325
- random_mixed_kernels dispatch             :327-388
- circular_lowpass_kernel (2-D sinc)        :392-417

Noise (degradations.py):
- Gaussian (+gray, +rounds)                 :420-459, 516-534
- Poisson / shot (+gray, +rounds)           :560-607, 686-706
- JPEG compression                          :732-765

All stochastic functions take an explicit ``np.random.Generator``; from the
same seed every function gives s2v_tpu's output bit for bit, so every
random draw s2v_tpu makes is made here too, in the same order, even where
its probability is 0. Host-side numpy: degradation synthesis is
data-pipeline work beside the device step.

JPEG uses Pillow, imported only when that step runs (``jpeg_range=None``
skips it; the card's machine has no Pillow). Channel order is RGB
throughout (the reference operates on cv2's BGR and flips at the end,
dataset_face.py:105-106).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from s2v_torch.utils import trace

# ---------------------------------------------------------------------------
# kernel synthesis
# ---------------------------------------------------------------------------


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    """degradations.py:16-29."""
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size: int):
    """degradations.py:32-47."""
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack(
        (xx.reshape(kernel_size * kernel_size, 1),
         yy.reshape(kernel_size * kernel_size, 1))
    ).reshape(kernel_size, kernel_size, 2)
    return xy, xx, yy


def pdf2(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Unnormalized bivariate Gaussian pdf on the grid (degradations.py:50-63)."""
    inverse_sigma = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum(np.dot(grid, inverse_sigma) * grid, 2))


def cdf2(d_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Skewed standard-bivariate-Gaussian CDF (degradations.py:66-81)."""
    from scipy.stats import multivariate_normal

    rv = multivariate_normal([0, 0], [[1, 0], [0, 1]])
    return rv.cdf(np.dot(grid, d_matrix))


def bivariate_gaussian(kernel_size: int, sig_x: float, sig_y: float,
                       theta: float, isotropic: bool = True) -> np.ndarray:
    """degradations.py:84-109."""
    grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    kernel = pdf2(sigma, grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_gaussian(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    """exp(-0.5 * (x^T S^-1 x)^beta); beta=1 is Gaussian
    (degradations.py:112-144)."""
    grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    inverse_sigma = np.linalg.inv(sigma)
    kernel = np.exp(
        -0.5 * np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    """1 / ((x^T S^-1 x)^beta + 1) plateau kernel (degradations.py:147-176)."""
    grid, _, _ = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = sigma_matrix2(sig_x, sig_y, theta)
    inverse_sigma = np.linalg.inv(sigma)
    kernel = np.reciprocal(
        np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def circular_lowpass_kernel(cutoff: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2-D sinc filter via the first-order Bessel function
    (degradations.py:392-417). ``cutoff`` in radians (pi = Nyquist)."""
    from scipy import special

    assert kernel_size % 2 == 1, "Kernel size must be an odd number."
    c = (kernel_size - 1) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = np.fromfunction(
            lambda x, y: cutoff
            * special.j1(cutoff * np.sqrt((x - c) ** 2 + (y - c) ** 2))
            / (2 * np.pi * np.sqrt((x - c) ** 2 + (y - c) ** 2)),
            [kernel_size, kernel_size],
        )
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = (
        cutoff ** 2 / (4 * np.pi))
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# ---------------------------------------------------------------------------
# random kernel samplers
# ---------------------------------------------------------------------------


def _sample_sigmas(rng, sigma_x_range, sigma_y_range, rotation_range,
                   isotropic):
    sigma_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0.0
    return (sigma_x, rng.uniform(*sigma_y_range),
            rng.uniform(*rotation_range))


def _sample_beta(rng, beta_range):
    # the reference assumes beta_range straddles 1 and splits 50/50 below
    # and above it (degradations.py:260-264, 312-316)
    if rng.uniform() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def _apply_kernel_noise(rng, kernel, noise_range):
    if noise_range is not None:
        kernel = kernel * rng.uniform(*noise_range, size=kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_gaussian(
    rng: np.random.Generator, kernel_size: int,
    sigma_x_range: Tuple[float, float],
    sigma_y_range: Tuple[float, float],
    rotation_range: Tuple[float, float],
    noise_range: Optional[Tuple[float, float]] = None,
    isotropic: bool = True,
) -> np.ndarray:
    """degradations.py:179-221 (with optional multiplicative kernel noise)."""
    assert kernel_size % 2 == 1, "Kernel size must be an odd number."
    sx, sy, rot = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                 rotation_range, isotropic)
    kernel = bivariate_gaussian(kernel_size, sx, sy, rot, isotropic)
    return _apply_kernel_noise(rng, kernel, noise_range)


def random_bivariate_generalized_gaussian(
    rng: np.random.Generator, kernel_size: int,
    sigma_x_range: Tuple[float, float],
    sigma_y_range: Tuple[float, float],
    rotation_range: Tuple[float, float],
    beta_range: Tuple[float, float],
    noise_range: Optional[Tuple[float, float]] = None,
    isotropic: bool = True,
) -> np.ndarray:
    """degradations.py:223-273."""
    assert kernel_size % 2 == 1, "Kernel size must be an odd number."
    sx, sy, rot = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                 rotation_range, isotropic)
    beta = _sample_beta(rng, beta_range)
    kernel = bivariate_generalized_gaussian(kernel_size, sx, sy, rot, beta,
                                            isotropic)
    return _apply_kernel_noise(rng, kernel, noise_range)


def random_bivariate_plateau(
    rng: np.random.Generator, kernel_size: int,
    sigma_x_range: Tuple[float, float],
    sigma_y_range: Tuple[float, float],
    rotation_range: Tuple[float, float],
    beta_range: Tuple[float, float],
    noise_range: Optional[Tuple[float, float]] = None,
    isotropic: bool = True,
) -> np.ndarray:
    """degradations.py:275-325."""
    assert kernel_size % 2 == 1, "Kernel size must be an odd number."
    sx, sy, rot = _sample_sigmas(rng, sigma_x_range, sigma_y_range,
                                 rotation_range, isotropic)
    beta = _sample_beta(rng, beta_range)
    kernel = bivariate_plateau(kernel_size, sx, sy, rot, beta, isotropic)
    return _apply_kernel_noise(rng, kernel, noise_range)


def random_mixed_kernels(
    rng: np.random.Generator,
    kernel_list: Sequence[str],
    kernel_prob: Sequence[float],
    kernel_size: int = 21,
    sigma_x_range: Tuple[float, float] = (0.6, 5),
    sigma_y_range: Tuple[float, float] = (0.6, 5),
    rotation_range: Tuple[float, float] = (-np.pi, np.pi),
    betag_range: Tuple[float, float] = (0.5, 8),
    betap_range: Tuple[float, float] = (0.5, 8),
    noise_range: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """The mixed-kernel dispatch (degradations.py:327-388): draw a kernel
    type from ``kernel_list`` with ``kernel_prob`` then sample it. Types:
    iso | aniso | generalized_iso | generalized_aniso | plateau_iso |
    plateau_aniso. Plateau kernels never get kernel noise (the reference
    hard-codes noise_range=None there, degradations.py:383-387)."""
    p = np.asarray(kernel_prob, np.float64)
    kernel_type = kernel_list[int(rng.choice(len(kernel_list), p=p / p.sum()))]
    if kernel_type == "iso":
        return random_bivariate_gaussian(
            rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            noise_range=noise_range, isotropic=True)
    if kernel_type == "aniso":
        return random_bivariate_gaussian(
            rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            noise_range=noise_range, isotropic=False)
    if kernel_type == "generalized_iso":
        return random_bivariate_generalized_gaussian(
            rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, noise_range=noise_range, isotropic=True)
    if kernel_type == "generalized_aniso":
        return random_bivariate_generalized_gaussian(
            rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, noise_range=noise_range, isotropic=False)
    if kernel_type == "plateau_iso":
        return random_bivariate_plateau(
            rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betap_range, noise_range=None, isotropic=True)
    if kernel_type == "plateau_aniso":
        return random_bivariate_plateau(
            rng, kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betap_range, noise_range=None, isotropic=False)
    raise ValueError(f"unknown kernel type {kernel_type!r}")


def random_mixed_kernel(
    rng: np.random.Generator,
    kernel_size: int = 41,
    sigma_range: Tuple[float, float] = (0.6, 10.0),
    isotropic_prob: float = 0.5,
) -> np.ndarray:
    """Back-compat shorthand for the GFPGAN iso/aniso 50/50 configuration
    (dataset_face.py:16-17)."""
    iso = rng.uniform() < isotropic_prob
    sig_x = rng.uniform(*sigma_range)
    if iso:
        return bivariate_gaussian(kernel_size, sig_x, sig_x, 0.0, True)
    sig_y = rng.uniform(sigma_range[0], sig_x)
    theta = rng.uniform(-np.pi, np.pi)
    return bivariate_gaussian(kernel_size, sig_x, sig_y, theta, False)


# ---------------------------------------------------------------------------
# image-space ops
# ---------------------------------------------------------------------------


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D equivalent (reflect-101 border), [H,W,C] float."""
    from scipy.ndimage import convolve

    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[:, :, c] = convolve(img[:, :, c], kernel, mode="mirror")
    return out


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, [H,W,3] RGB -> [H,W] (cv2.cvtColor COLOR_RGB2GRAY)."""
    return (img[..., 0] * 0.299 + img[..., 1] * 0.587
            + img[..., 2] * 0.114).astype(img.dtype)


def _round_clip(out: np.ndarray, clip: bool, rounds: bool) -> np.ndarray:
    """The reference's clip/rounds postprocess grid (degradations.py:451-458)."""
    if clip and rounds:
        return np.clip((out * 255.0).round(), 0, 255) / 255.0
    if clip:
        return np.clip(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.0
    return out


# ----------------------------- Gaussian noise ------------------------------


def generate_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                            sigma: float = 10.0,
                            gray_noise: bool = False) -> np.ndarray:
    """degradations.py:420-436. sigma measured in 0..255 range."""
    if gray_noise:
        noise = rng.standard_normal(img.shape[:2]).astype(np.float32)
        noise = np.repeat(noise[:, :, None], img.shape[2], axis=2)
    else:
        noise = rng.standard_normal(img.shape).astype(np.float32)
    return noise * (sigma / 255.0)


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       sigma: float = 10.0, clip: bool = True,
                       rounds: bool = False,
                       gray: bool = False) -> np.ndarray:
    """degradations.py:439-459. img [H,W,C] in [0, 1]."""
    out = img + generate_gaussian_noise(img, rng, sigma, gray)
    return _round_clip(out, clip, rounds)


def random_add_gaussian_noise(
    img: np.ndarray, rng: np.random.Generator,
    sigma_range: Tuple[float, float] = (0, 10.0), gray_prob: float = 0.0,
    clip: bool = True, rounds: bool = False,
) -> np.ndarray:
    """degradations.py:516-534."""
    sigma = rng.uniform(*sigma_range)
    gray = rng.uniform() < gray_prob
    return add_gaussian_noise(img, rng, sigma, clip, rounds, gray)


# ------------------------------ Poisson noise ------------------------------


def generate_poisson_noise(img: np.ndarray, rng: np.random.Generator,
                           scale: float = 1.0,
                           gray_noise: bool = False) -> np.ndarray:
    """Shot noise: poisson-resample the image at its quantization depth
    (degradations.py:560-584; skimage random_noise semantics). img [H,W,C]
    in [0, 1]."""
    if gray_noise:
        img = rgb_to_gray(img)
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = len(np.unique(img))
    vals = 2 ** np.ceil(np.log2(vals))
    out = np.float32(rng.poisson(img * vals) / float(vals))
    noise = out - img
    if gray_noise:
        noise = np.repeat(noise[:, :, np.newaxis], 3, axis=2)
    return noise * scale


def add_poisson_noise(img: np.ndarray, rng: np.random.Generator,
                      scale: float = 1.0, clip: bool = True,
                      rounds: bool = False,
                      gray_noise: bool = False) -> np.ndarray:
    """degradations.py:587-607."""
    out = img + generate_poisson_noise(img, rng, scale, gray_noise)
    return _round_clip(out, clip, rounds)


def random_add_poisson_noise(
    img: np.ndarray, rng: np.random.Generator,
    scale_range: Tuple[float, float] = (0, 1.0), gray_prob: float = 0.0,
    clip: bool = True, rounds: bool = False,
) -> np.ndarray:
    """degradations.py:686-706."""
    scale = rng.uniform(*scale_range)
    gray = rng.uniform() < gray_prob
    return add_poisson_noise(img, rng, scale, clip, rounds, gray)


# --------------------------------- JPEG ------------------------------------


def add_jpg_compression(img: np.ndarray, quality: int = 90) -> np.ndarray:
    """degradations.py:732-749 via PIL. img [H,W,3] in [0, 1]."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.clip(img * 255.0, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=int(quality)
    )
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32) / 255.0


def random_add_jpg_compression(
    img: np.ndarray, rng: np.random.Generator,
    quality_range: Tuple[float, float] = (90, 100),
) -> np.ndarray:
    """degradations.py:751-765."""
    return add_jpg_compression(img, int(rng.uniform(*quality_range)))


def resize_area(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize (half-pixel centres, edges clamped, torch
    align_corners=False) of a [0, 1] image quantised to uint8, back to
    [0, 1] float32: the arithmetic of s2v_tpu's native
    ``s2v_crop_resize_u8f32``, in the same f32 order, so the results are
    equal bit for bit."""
    src = np.clip(img * 255, 0, 255).astype(np.uint8).astype(np.float32)
    oh, ow = out_hw

    def taps(n_in, n_out):
        s = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
        i0 = np.minimum(s.astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), (s - i0).astype(np.float32)

    r0, r1, wy = taps(src.shape[0], oh)
    c0, c1, wx = taps(src.shape[1], ow)
    wx, wy = wx[None, :, None], wy[:, None, None]

    def row(r):
        a, b = src[r][:, c0], src[r][:, c1]
        return a + wx * (b - a)

    top, bot = row(r0), row(r1)
    return (top + wy * (bot - top)) * np.float32(1.0 / 255.0)


# ---------------------------------------------------------------------------
# the GFPGAN/GPEN training chain
# ---------------------------------------------------------------------------


def degrade(
    img: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    blur_kernel_size: int = 41,
    blur_sigma: Tuple[float, float] = (0.1, 10.0),
    downsample_range: Tuple[float, float] = (0.8, 8.0),
    noise_range: Optional[Tuple[float, float]] = (0.0, 20.0),
    jpeg_range: Optional[Tuple[int, int]] = (60, 100),
    kernel_list: Sequence[str] = ("iso", "aniso"),
    kernel_prob: Sequence[float] = (0.5, 0.5),
) -> np.ndarray:
    """The BFR degradation chain (dataset_face.py:46-71 degrade_process /
    GFPGAN ffhq_degradation_dataset.py:160-190): mixed-kernel blur ->
    downsample -> gaussian noise -> jpeg -> round/clip -> resize back.
    img [H,W,3] in [0, 1]."""
    rng = rng or np.random.default_rng(0)
    h, w = img.shape[:2]
    kernel = random_mixed_kernels(
        rng, kernel_list, kernel_prob, blur_kernel_size,
        blur_sigma, blur_sigma, (-np.pi, np.pi))
    lq = filter2d(img, kernel)
    scale = rng.uniform(*downsample_range)
    lq = resize_area(lq, (max(int(h // scale), 8), max(int(w // scale), 8)))
    if noise_range is not None:
        lq = random_add_gaussian_noise(lq, rng, noise_range)
    if jpeg_range is not None:
        lq = random_add_jpg_compression(lq, rng, jpeg_range)
    lq = np.clip((lq * 255.0).round(), 0, 255) / 255.0
    return resize_area(lq, (h, w))


class GFPGANDegrader:
    """dataset_face.py:14-71 GFPGAN_degradation: the full per-image GT+LQ
    synthesis — random hflip, color jitter, random grayscale, then the
    ``degrade`` chain. Returns (img_gt, img_lq), both [H,W,3] in [0,1] RGB
    (the GT itself is modified by flip/jitter/grayscale, so both are
    returned, matching degrade_process)."""

    def __init__(self, kernel_list=("iso", "aniso"), kernel_prob=(0.5, 0.5),
                 blur_kernel_size: int = 41,
                 blur_sigma: Tuple[float, float] = (0.1, 10.0),
                 downsample_range: Tuple[float, float] = (0.8, 8.0),
                 noise_range: Optional[Tuple[float, float]] = (0.0, 20.0),
                 jpeg_range: Optional[Tuple[int, int]] = (60, 100),
                 gray_prob: float = 0.2, color_jitter_prob: float = 0.0,
                 shift: float = 20.0 / 255.0):
        self.kernel_list = tuple(kernel_list)
        self.kernel_prob = tuple(kernel_prob)
        self.blur_kernel_size = blur_kernel_size
        self.blur_sigma = blur_sigma
        self.downsample_range = downsample_range
        self.noise_range = noise_range
        self.jpeg_range = jpeg_range
        self.gray_prob = gray_prob
        self.color_jitter_prob = color_jitter_prob
        self.shift = shift

    def __call__(self, img_gt: np.ndarray, rng: np.random.Generator):
        if rng.uniform() < 0.5:  # random hflip (dataset_face.py:29-30)
            img_gt = img_gt[:, ::-1]
        if rng.uniform() < self.color_jitter_prob:  # :34-37
            jitter = rng.uniform(-self.shift, self.shift, 3).astype(np.float32)
            img_gt = np.clip(img_gt + jitter, 0, 1)
        if rng.uniform() < self.gray_prob:  # :40-42
            img_gt = np.tile(rgb_to_gray(img_gt)[:, :, None], (1, 1, 3))
        img_gt = np.ascontiguousarray(img_gt, np.float32)
        img_lq = degrade(
            img_gt, rng, self.blur_kernel_size, self.blur_sigma,
            self.downsample_range, self.noise_range, self.jpeg_range,
            self.kernel_list, self.kernel_prob)
        return img_gt, img_lq


def face_batches(images_u8: np.ndarray, batch_size: int,
                 rng: Optional[np.random.Generator] = None,
                 degrader: Optional[GFPGANDegrader] = None,
                 steps: Optional[int] = None):
    """FaceDataset-equivalent batch generator (dataset_face.py:74-110):
    sample HQ faces, degrade, yield dict(lq, hq) in [-1, 1] float32 — the
    batch contract of train.gan.make_gan_trainer. ``images_u8``
    [N,H,W,3] uint8 RGB. Each batch is made inside span
    ``data.face_batches`` (``s2v_torch.utils.trace``)."""
    rng = rng or np.random.default_rng(0)
    degrader = degrader or GFPGANDegrader()
    n = 0
    while steps is None or n < steps:
        # the span closes before the yield: the consumer's work is not the batch's
        with trace.span("data.face_batches"):
            idx = rng.integers(0, len(images_u8), size=batch_size)
            gts, lqs = [], []
            for i in idx:
                gt, lq = degrader(images_u8[int(i)].astype(np.float32) / 255.0,
                                  rng)
                gts.append(gt)
                lqs.append(lq)
            batch = {
                "hq": (np.stack(gts) - 0.5) / 0.5,
                "lq": (np.stack(lqs) - 0.5) / 0.5,
            }
        yield batch
        n += 1
