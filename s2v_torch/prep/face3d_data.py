"""face3d training-data preparation (reference:
third_part/face3d/data_preparation.py + util/{detect_lm68,skin_mask,
generate_list}.py; a copy of s2v_tpu/prep/face3d_data.py's numpy code, f64,
so its masks and files are s2v_tpu's bit for bit).

The reference pipeline per image folder: detect 68 landmarks (a frozen
TensorFlow .pb detector — replaced by an injected callable, such as the
port's S3FD+FAN ``extract_landmarks``), compute a GMM skin-probability
attention mask, and write datalist files (landmarks.txt / images.txt /
masks.txt). The GMM likelihood is one vectorized einsum over the pixels
instead of the reference's per-pixel Python loop (skin_mask.py:23-39).
Pillow reads and writes the images, imported only inside
``prepare_dataset``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence, Tuple

import numpy as np

# GMM parameters (skin_mask.py:57-82)
_SKIN_W = np.array([0.24063933, 0.16365987, 0.26034665, 0.33535415])
_SKIN_MU = np.array([
    [113.71862, 103.39613, 164.08226],
    [150.19858, 105.18467, 155.51428],
    [183.92976, 107.62468, 152.71820],
    [114.90524, 113.59782, 151.38217]])
_SKIN_COV_DET = np.array([5692842.5, 5851930.5, 2329131.0, 1585971.0])
_SKIN_COV_INV = np.array([
    [[0.0019472069, 0.0020450759, -0.00060243998],
     [0.0020450759, 0.017700525, 0.0051420014],
     [-0.00060243998, 0.0051420014, 0.0081308950]],
    [[0.0027110141, 0.0011036990, 0.0023122299],
     [0.0011036990, 0.010707724, 0.010742856],
     [0.0023122299, 0.010742856, 0.017481629]],
    [[0.0048026871, 0.00022935172, 0.0077668377],
     [0.00022935172, 0.011729696, 0.0081661865],
     [0.0077668377, 0.0081661865, 0.025374353]],
    [[0.0011989699, 0.0022453172, -0.0010748957],
     [0.0022453172, 0.047758564, 0.020332102],
     [-0.0010748957, 0.020332102, 0.024502251]]])
_NONSKIN_W = np.array([0.12791070, 0.31130761, 0.34245777, 0.21832393])
_NONSKIN_MU = np.array([
    [99.200851, 112.07533, 140.20602],
    [110.91392, 125.52969, 130.19237],
    [129.75864, 129.96107, 126.96808],
    [112.29587, 128.85121, 129.05431]])
_NONSKIN_COV_DET = np.array([458703648.0, 6466488.0, 90611376.0, 133097.63])
_NONSKIN_COV_INV = np.array([
    [[0.00085371657, 0.00071197288, 0.00023958916],
     [0.00071197288, 0.0025935620, 0.00076557708],
     [0.00023958916, 0.00076557708, 0.0015042332]],
    [[0.00024650150, 0.00045542428, 0.00015019422],
     [0.00045542428, 0.026412144, 0.018419769],
     [0.00015019422, 0.018419769, 0.037497383]],
    [[0.00037054974, 0.00038146760, 0.00040408765],
     [0.00038146760, 0.0085505722, 0.0079136286],
     [0.00040408765, 0.0079136286, 0.010982352]],
    [[0.00013709733, 0.00051228428, 0.00012777430],
     [0.00051228428, 0.28237113, 0.10528370],
     [0.00012777430, 0.10528370, 0.23468947]]])
_PRIOR_SKIN = 0.8


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """skin_mask.py:40-50 (digital YCbCr, 0..255 inputs)."""
    m = np.array([[65.481, 128.553, 24.966],
                  [-37.797, -74.203, 112.0],
                  [112.0, -93.786, -18.214]])
    out = rgb.astype(np.float64) @ (m.T / 255.0)
    out[..., 0] += 16.0
    out[..., 1:] += 128.0
    return out


def _gmm_likelihood(data: np.ndarray, w, mu, cov_det, cov_inv) -> np.ndarray:
    """Vectorized GMM likelihood: data [..., 3] -> [...]. One einsum per
    component set instead of the reference's per-pixel Python loop."""
    d = data[..., None, :] - mu  # [..., K, 3]
    power = -0.5 * np.einsum("...ki,kij,...kj->...k", d, cov_inv, d)
    factor = (2 * np.pi) ** 1.5 * np.sqrt(cov_det)  # dim=3
    return np.sum(np.exp(power) / factor * w, axis=-1)


def skin_mask(images_rgb: np.ndarray) -> np.ndarray:
    """[.., H, W, 3] uint8 RGB -> skin posterior [.., H, W] uint8
    (skin_mask.py:89-110; the reference takes BGR — converted here)."""
    ycbcr = rgb_to_ycbcr(images_rgb)
    lh_skin = _gmm_likelihood(ycbcr, _SKIN_W, _SKIN_MU, _SKIN_COV_DET,
                              _SKIN_COV_INV)
    lh_non = _gmm_likelihood(ycbcr, _NONSKIN_W, _NONSKIN_MU,
                             _NONSKIN_COV_DET, _NONSKIN_COV_INV)
    t1 = _PRIOR_SKIN * lh_skin
    t2 = (1.0 - _PRIOR_SKIN) * lh_non
    post = t1 / np.maximum(t1 + t2, 1e-300)
    return np.round(post * 255.0).astype(np.uint8)


def prepare_dataset(
    img_folders: Sequence[str],
    extract_landmarks: Callable[[np.ndarray], np.ndarray],
    mode: str = "train",
    save_folder: str = "datalist",
    exts: Tuple[str, ...] = (".jpg", ".jpeg", ".png"),
) -> Tuple[List[str], List[str], List[str]]:
    """data_preparation.py:22-41 with the framework's own landmarker.

    For each folder: write landmarks/<img>.txt ([68, 2] rows) and
    mask/<img>.png (skin posterior), then the datalist triple under
    save_folder/mode/ (generate_list.py:7-18). Returns the checked lists.
    """
    from PIL import Image

    lms_list, imgs_list, msks_list = [], [], []
    for folder in img_folders:
        names = sorted(n for n in os.listdir(folder)
                       if os.path.splitext(n)[1].lower() in exts
                       and os.path.isfile(os.path.join(folder, n)))
        if not names:
            continue
        os.makedirs(os.path.join(folder, "landmarks"), exist_ok=True)
        os.makedirs(os.path.join(folder, "mask"), exist_ok=True)
        for name in names:
            img = np.asarray(Image.open(os.path.join(folder, name)).convert("RGB"))
            lm = np.asarray(extract_landmarks(img[None]))[0]  # [68, 2]
            stem = os.path.splitext(name)[0]
            lm_path = os.path.join(folder, "landmarks", stem + ".txt")
            np.savetxt(lm_path, lm, fmt="%.6f")
            mask = skin_mask(img)
            msk_path = os.path.join(folder, "mask", name)
            Image.fromarray(np.repeat(mask[..., None], 3, axis=-1)).save(msk_path)
            lms_list.append(lm_path)
            imgs_list.append(os.path.join(folder, name))
            msks_list.append(msk_path)

    # check_list + write_list (generate_list.py:7-34)
    keep = [i for i in range(len(lms_list))
            if os.path.isfile(lms_list[i]) and os.path.isfile(imgs_list[i])
            and os.path.isfile(msks_list[i])]
    lms_list = [lms_list[i] for i in keep]
    imgs_list = [imgs_list[i] for i in keep]
    msks_list = [msks_list[i] for i in keep]
    out = os.path.join(save_folder, mode)
    os.makedirs(out, exist_ok=True)
    for fname, rows in (("landmarks.txt", lms_list), ("images.txt", imgs_list),
                        ("masks.txt", msks_list)):
        with open(os.path.join(out, fname), "w") as f:
            f.writelines(r + "\n" for r in rows)
    return lms_list, imgs_list, msks_list
