"""The port's degradation chain (s2v_torch.prep.degradations) bit-equal to
the JAX package's: every kernel family, sampler and noise kind from the same
``np.random.default_rng`` seed (one parametrised test), and the
``GFPGANDegrader`` / ``face_batches`` chain with every option away from its
default. tests/test_torch_train.py holds the default chain."""

import numpy as np
import pytest

from s2v_torch.prep import degradations as TD
from s2v_tpu.prep import degradations as JD

KINDS = ("iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
         "plateau_aniso")
RANGES = dict(sigma_x_range=(0.6, 4.0), sigma_y_range=(0.4, 3.0),
              rotation_range=(-np.pi, np.pi))


def _img(seed=1, size=24):
    return np.random.RandomState(seed).rand(size, size, 3).astype(np.float32)


CASES = {
    # kernel families, direct
    "cdf2": lambda m, rng: m.cdf2(np.array([[1.0, 0.3], [0.2, 0.8]]),
                                  m.mesh_grid(3)[0]),
    "generalized_gaussian": lambda m, rng: m.bivariate_generalized_gaussian(
        11, 2.0, 1.2, 0.4, 0.7, isotropic=False),
    "generalized_gaussian_iso": lambda m, rng: m.bivariate_generalized_gaussian(
        11, 2.0, 2.0, 0.0, 3.0),
    "plateau": lambda m, rng: m.bivariate_plateau(11, 2.0, 1.2, -0.6, 1.5, isotropic=False),
    "plateau_iso": lambda m, rng: m.bivariate_plateau(11, 1.5, 1.5, 0.0, 0.8),
    "sinc": lambda m, rng: m.circular_lowpass_kernel(np.pi / 3, 13),
    "sinc_padded": lambda m, rng: m.circular_lowpass_kernel(np.pi / 2, 9, pad_to=21),
    # samplers, with and without kernel noise
    "random_gaussian": lambda m, rng: m.random_bivariate_gaussian(
        rng, 15, **RANGES, noise_range=(0.75, 1.25), isotropic=False),
    "random_generalized": lambda m, rng: m.random_bivariate_generalized_gaussian(
        rng, 15, **RANGES, beta_range=(0.5, 4.0), noise_range=(0.75, 1.25)),
    "random_plateau": lambda m, rng: m.random_bivariate_plateau(
        rng, 15, **RANGES, beta_range=(1.0, 2.0), isotropic=False),
    "kernel_noise": lambda m, rng: m._apply_kernel_noise(rng, m.bivariate_gaussian(
        9, 1.0, 1.0, 0.0), (0.5, 1.5)),
    **{f"mixed_{k}": (lambda m, rng, k=k: m.random_mixed_kernels(
        rng, [k], [1.0], 17, (0.5, 3.0), (0.5, 3.0), (-np.pi, np.pi), (0.5, 4.0),
        (1.0, 2.0), noise_range=(0.8, 1.2))) for k in KINDS},
    "mixed_draw": lambda m, rng: np.stack([m.random_mixed_kernels(
        rng, KINDS, (0.3, 0.2, 0.15, 0.15, 0.1, 0.1), 13) for _ in range(8)]),
    "mixed_shorthand": lambda m, rng: np.stack([m.random_mixed_kernel(rng, 21)
                                                for _ in range(4)]),
    # noise
    "gaussian": lambda m, rng: m.add_gaussian_noise(_img(), rng, 15.0, rounds=True),
    "gaussian_gray": lambda m, rng: m.add_gaussian_noise(_img(), rng, 8.0, clip=False,
                                                         gray=True),
    "random_gaussian_noise": lambda m, rng: m.random_add_gaussian_noise(
        _img(), rng, (2.0, 20.0), gray_prob=0.5, rounds=True),
    "poisson": lambda m, rng: m.add_poisson_noise(_img(), rng, 2.0),
    "poisson_gray": lambda m, rng: m.add_poisson_noise(_img(), rng, 1.0, rounds=True,
                                                       gray_noise=True),
    "random_poisson_noise": lambda m, rng: np.stack([m.random_add_poisson_noise(
        _img(), rng, (0.05, 3.0), gray_prob=0.5, clip=False) for _ in range(4)]),
    "random_jpeg": lambda m, rng: m.random_add_jpg_compression(_img(size=32), rng,
                                                               (30, 95)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_degradation_is_bit_equal_to_jax(case):
    got = CASES[case](TD, np.random.default_rng(11))
    want = CASES[case](JD, np.random.default_rng(11))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


FULL = dict(kernel_list=KINDS, kernel_prob=(0.3, 0.2, 0.15, 0.15, 0.1, 0.1),
            blur_kernel_size=21, blur_sigma=(0.2, 3.0), downsample_range=(1.0, 4.0),
            noise_range=(0.0, 10.0), jpeg_range=(70, 90), gray_prob=0.5,
            color_jitter_prob=0.5, shift=0.05)


def test_full_option_chain_is_bit_equal_to_jax():
    imgs = (np.random.RandomState(2).rand(5, 32, 32, 3) * 255).astype(np.uint8)
    got = list(TD.face_batches(imgs, 3, np.random.default_rng(3), TD.GFPGANDegrader(**FULL),
                               steps=3))
    want = list(JD.face_batches(imgs, 3, np.random.default_rng(3), JD.GFPGANDegrader(**FULL),
                                steps=3))
    for g, w in zip(got, want, strict=True):
        for k in ("hq", "lq"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    img = imgs[0].astype(np.float32) / 255.0
    for _ in range(4):
        for g, w in zip(TD.GFPGANDegrader(**FULL)(img, rng_t),
                        JD.GFPGANDegrader(**FULL)(img, rng_j)):
            assert np.array_equal(g, w)
    kw = {k: FULL[k] for k in ("blur_kernel_size", "blur_sigma", "downsample_range",
                               "noise_range", "jpeg_range", "kernel_list", "kernel_prob")}
    assert np.array_equal(TD.degrade(img, np.random.default_rng(5), **kw),
                          JD.degrade(img, np.random.default_rng(5), **kw))
