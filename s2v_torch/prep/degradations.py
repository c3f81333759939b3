"""The training-data degradation chain that ``face_batches`` runs (a copy of
s2v_tpu/prep/degradations.py's numpy/scipy code; reference:
third_part/GPEN/training/data_loader/degradations.py and dataset_face.py
GFPGAN_degradation).

Per image: random hflip, random grayscale, then ``degrade``: an isotropic or
anisotropic Gaussian blur, a bilinear downsample, Gaussian noise, JPEG
(Pillow, imported only when the step runs; ``jpeg_range=None`` skips it),
round/clip, and the resize back. The ranges are the chain's defaults, kept
as constants; the reference's other kernel types and options have no caller
here yet.

All stochastic functions take an explicit ``np.random.Generator``; from the
same seed the chain gives the JAX package's batches bit for bit, so every
random draw the JAX package makes is made here too, in the same order, even
where its probability is 0. Host-side numpy: degradation synthesis is
data-pipeline work beside the device step. Channel order is RGB throughout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

BLUR_KERNEL_SIZE = 41
BLUR_SIGMA = (0.1, 10.0)
DOWNSAMPLE_RANGE = (0.8, 8.0)
NOISE_RANGE = (0.0, 20.0)  # sigma, on the 0..255 scale
JPEG_RANGE = (60, 100)
GRAY_PROB = 0.2

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


def random_mixed_kernels(rng: np.random.Generator) -> np.ndarray:
    """The mixed-kernel draw (degradations.py:179-221, 327-388) as the chain
    runs it: an isotropic or anisotropic Gaussian, half and half, sigmas in
    ``BLUR_SIGMA``, any rotation, no kernel noise."""
    isotropic = int(rng.choice(2, p=np.array([0.5, 0.5]))) == 0
    sigma_x = rng.uniform(*BLUR_SIGMA)
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    else:
        sigma_y, theta = rng.uniform(*BLUR_SIGMA), rng.uniform(-np.pi, np.pi)
    kernel = bivariate_gaussian(BLUR_KERNEL_SIZE, sigma_x, sigma_y, theta,
                                isotropic)
    return kernel / np.sum(kernel)  # the reference normalises twice

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


def random_add_gaussian_noise(img: np.ndarray,
                              rng: np.random.Generator) -> np.ndarray:
    """degradations.py:420-459, 516-534 as the chain runs it: colour noise
    with sigma drawn from ``NOISE_RANGE``, clipped to [0, 1], not rounded.
    img [H,W,C] in [0, 1]."""
    sigma = rng.uniform(*NOISE_RANGE)
    rng.uniform()  # the gray-noise draw; its probability is 0
    noise = rng.standard_normal(img.shape).astype(np.float32) * (sigma / 255.0)
    return np.clip(img + noise, 0, 1)


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
    jpeg_range: Optional[Tuple[int, int]] = JPEG_RANGE,
) -> np.ndarray:
    """The BFR degradation chain (dataset_face.py:46-71 degrade_process /
    GFPGAN ffhq_degradation_dataset.py:160-190): mixed-kernel blur ->
    downsample -> gaussian noise -> jpeg -> round/clip -> resize back.
    img [H,W,3] in [0, 1]."""
    rng = rng or np.random.default_rng(0)
    h, w = img.shape[:2]
    lq = filter2d(img, random_mixed_kernels(rng))
    scale = rng.uniform(*DOWNSAMPLE_RANGE)
    lq = resize_area(lq, (max(int(h // scale), 8), max(int(w // scale), 8)))
    lq = random_add_gaussian_noise(lq, rng)
    if jpeg_range is not None:  # degradations.py:751-765
        lq = add_jpg_compression(lq, int(rng.uniform(*jpeg_range)))
    lq = np.clip((lq * 255.0).round(), 0, 255) / 255.0
    return resize_area(lq, (h, w))


class GFPGANDegrader:
    """dataset_face.py:14-71 GFPGAN_degradation: the full per-image GT+LQ
    synthesis — random hflip, random grayscale, then the ``degrade`` chain.
    Returns (img_gt, img_lq), both [H,W,3] in [0,1] RGB (the GT itself is
    modified by flip/grayscale, so both are returned, matching
    degrade_process)."""

    def __init__(self, jpeg_range: Optional[Tuple[int, int]] = JPEG_RANGE):
        self.jpeg_range = jpeg_range

    def __call__(self, img_gt: np.ndarray, rng: np.random.Generator):
        if rng.uniform() < 0.5:  # random hflip (dataset_face.py:29-30)
            img_gt = img_gt[:, ::-1]
        rng.uniform()  # the colour-jitter draw (:34-37); its probability is 0
        if rng.uniform() < GRAY_PROB:  # :40-42
            img_gt = np.tile(rgb_to_gray(img_gt)[:, :, None], (1, 1, 3))
        img_gt = np.ascontiguousarray(img_gt, np.float32)
        return img_gt, degrade(img_gt, rng, self.jpeg_range)


def face_batches(images_u8: np.ndarray, batch_size: int,
                 rng: Optional[np.random.Generator] = None,
                 degrader: Optional[GFPGANDegrader] = None,
                 steps: Optional[int] = None):
    """FaceDataset-equivalent batch generator (dataset_face.py:74-110):
    sample HQ faces, degrade, yield dict(lq, hq) in [-1, 1] float32 — the
    batch contract of train.gan.make_gan_trainer. ``images_u8``
    [N,H,W,3] uint8 RGB."""
    rng = rng or np.random.default_rng(0)
    degrader = degrader or GFPGANDegrader()
    n = 0
    while steps is None or n < steps:
        idx = rng.integers(0, len(images_u8), size=batch_size)
        gts, lqs = [], []
        for i in idx:
            gt, lq = degrader(images_u8[int(i)].astype(np.float32) / 255.0,
                              rng)
            gts.append(gt)
            lqs.append(lq)
        yield {
            "hq": (np.stack(gts) - 0.5) / 0.5,
            "lq": (np.stack(lqs) - 0.5) / 0.5,
        }
        n += 1
