"""Basel Face Model parametric head and a software rasterizer (reference:
third_part/face3d/models/bfm.py ParametricFaceModel and
third_part/face3d/util/nvdiffrast.py MeshRenderer; s2v_tpu/models/bfm.py).

The coefficient-to-geometry math (shape and texture bases, SH lighting,
Euler rotations, perspective projection) is s2v_tpu's, with the bases as
buffers of an ``nn.Module`` on an explicit device. ``rasterize`` computes
what s2v_tpu's barycentric z-buffer computes without its ``[F, H * W]``
grid: at the published BFM size (70,789 faces at 224^2) one such f32 array
is 14.2 GB an image.

The BFM data (.mat bases) ships separately, as in the reference; the
module takes plain numpy arrays, so tests and the smoke use synthetic
bases.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.device import resolve_device
from s2v_torch.pipeline.utils import split_coeff

# SH constants (bfm.py:19-22)
_SH_A = (np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0))
_SH_C = (1 / np.sqrt(4 * np.pi), np.sqrt(3.0) / np.sqrt(4 * np.pi),
         3 * np.sqrt(5.0) / np.sqrt(12 * np.pi))


@dataclass
class FaceModelData:
    """BFM arrays (bfm.py:40-66). Shapes: mean_shape [3N], id_base [3N,80],
    exp_base [3N,64], mean_tex [3N], tex_base [3N,80], face_buf [F,3] int,
    point_buf [N,8] int (F pads: the zero normal), keypoints [68] int."""

    mean_shape: np.ndarray
    id_base: np.ndarray
    exp_base: np.ndarray
    mean_tex: np.ndarray
    tex_base: np.ndarray
    face_buf: np.ndarray
    point_buf: np.ndarray
    keypoints: np.ndarray

    @classmethod
    def from_mat(cls, bfm_folder: str, recenter: bool = True):
        from scipy.io import loadmat

        m = loadmat(os.path.join(bfm_folder, "BFM_model_front.mat"))
        mean_shape = m["meanshape"].astype(np.float32).reshape(-1)
        if recenter:
            ms = mean_shape.reshape(-1, 3)
            mean_shape = (ms - ms.mean(0, keepdims=True)).reshape(-1)
        return cls(
            mean_shape=mean_shape,
            id_base=m["idBase"].astype(np.float32),
            exp_base=m["exBase"].astype(np.float32),
            mean_tex=m["meantex"].astype(np.float32).reshape(-1),
            tex_base=m["texBase"].astype(np.float32),
            face_buf=m["tri"].astype(np.int64) - 1,
            point_buf=m["point_buf"].astype(np.int64) - 1,
            keypoints=np.squeeze(m["keypoints"]).astype(np.int64) - 1,
        )


class ParametricFaceModel(nn.Module):
    """bfm.py:26-290: 257 coefficients -> camera-space vertices, albedo,
    lit colour and the 68 projected landmarks. ``device`` defaults to the
    card and raises without one; pass ``"cpu"`` to run on the CPU on
    purpose. ``d`` keeps the numpy arrays."""

    def __init__(self, data: FaceModelData, camera_distance: float = 10.0,
                 focal: float = 1015.0, center: float = 112.0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.d = data
        self.camera_distance = camera_distance
        for name in ("mean_shape", "id_base", "exp_base", "mean_tex", "tex_base"):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(getattr(data, name), np.float32), device=dev))
        for name in ("face_buf", "point_buf", "keypoints"):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(getattr(data, name), np.int64), device=dev))
        # perspective_projection (bfm.py:11-17): p @ P^T convention
        self.register_buffer("persc_proj", torch.tensor(
            np.array([[focal, 0, center], [0, focal, center], [0, 0, 1]], np.float32).T,
            device=dev))
        self.register_buffer("init_lit", torch.tensor(
            [0.8, 0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.float32, device=dev).reshape(1, 1, 9))

    def compute_shape(self, id_coeff, exp_coeff):
        out = (torch.einsum("ij,aj->ai", self.id_base, id_coeff)
               + torch.einsum("ij,aj->ai", self.exp_base, exp_coeff)
               + self.mean_shape[None])
        return out.reshape(id_coeff.shape[0], -1, 3)

    def compute_texture(self, tex_coeff, normalize: bool = True):
        out = torch.einsum("ij,aj->ai", self.tex_base, tex_coeff) + self.mean_tex[None]
        if normalize:
            out = out / 255.0
        return out.reshape(tex_coeff.shape[0], -1, 3)

    def compute_norm(self, face_shape):
        fb = self.face_buf
        v1, v2, v3 = face_shape[:, fb[:, 0]], face_shape[:, fb[:, 1]], face_shape[:, fb[:, 2]]
        face_norm = torch.linalg.cross(v1 - v2, v2 - v3, dim=-1)
        # sqrt(sum + eps) keeps the gradient of a degenerate triangle finite
        # (plain x / (||x|| + eps) has a NaN gradient at exactly zero)
        face_norm = face_norm * torch.rsqrt(torch.sum(face_norm * face_norm, -1, keepdim=True)
                                            + 1e-12)
        face_norm = torch.cat([face_norm, face_norm.new_zeros(face_shape.shape[0], 1, 3)], 1)
        vn = torch.sum(face_norm[:, self.point_buf], dim=2)
        return vn * torch.rsqrt(torch.sum(vn * vn, -1, keepdim=True) + 1e-12)

    def compute_color(self, face_texture, face_norm, gamma):
        b = gamma.shape[0]
        a, c = _SH_A, _SH_C
        gamma = (gamma.reshape(b, 3, 9) + self.init_lit).permute(0, 2, 1)
        n = face_norm
        y = torch.cat([
            a[0] * c[0] * torch.ones_like(n[..., :1]),
            -a[1] * c[1] * n[..., 1:2],
            a[1] * c[1] * n[..., 2:],
            -a[1] * c[1] * n[..., :1],
            a[2] * c[2] * n[..., :1] * n[..., 1:2],
            -a[2] * c[2] * n[..., 1:2] * n[..., 2:],
            0.5 * a[2] * c[2] / np.sqrt(3.0) * (3 * n[..., 2:] ** 2 - 1),
            -a[2] * c[2] * n[..., :1] * n[..., 2:],
            0.5 * a[2] * c[2] * (n[..., :1] ** 2 - n[..., 1:2] ** 2),
        ], dim=-1)
        rgb = torch.stack([(y @ gamma[..., i:i + 1])[..., 0] for i in range(3)], dim=-1)
        return rgb * face_texture

    def compute_rotation(self, angles):
        b = angles.shape[0]
        x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
        cx, sx, cy, sy, cz, sz = x.cos(), x.sin(), y.cos(), y.sin(), z.cos(), z.sin()
        o, zr = torch.ones_like(x), torch.zeros_like(x)
        rx = torch.stack([o, zr, zr, zr, cx, -sx, zr, sx, cx], 1).reshape(b, 3, 3)
        ry = torch.stack([cy, zr, sy, zr, o, zr, -sy, zr, cy], 1).reshape(b, 3, 3)
        rz = torch.stack([cz, -sz, zr, sz, cz, zr, zr, zr, o], 1).reshape(b, 3, 3)
        return (rz @ ry @ rx).permute(0, 2, 1)

    def to_camera(self, face_shape):
        return torch.cat([face_shape[..., :2], self.camera_distance - face_shape[..., 2:]], -1)

    def to_image(self, face_shape):
        proj = face_shape @ self.persc_proj
        return proj[..., :2] / proj[..., 2:]

    def transform(self, face_shape, rot, trans):
        return face_shape @ rot + trans[:, None]

    def compute_for_render(self, coeffs):
        """bfm.py:270-290: coeffs [B, 257] -> (vertices, texture, color,
        landmarks)."""
        c = split_coeff(coeffs)
        shape = self.compute_shape(c["id"], c["exp"])
        rot = self.compute_rotation(c["angle"])
        vertex = self.to_camera(self.transform(shape, rot, c["trans"]))
        landmark = self.to_image(vertex)[:, self.keypoints]
        texture = self.compute_texture(c["tex"])
        norm_rot = self.compute_norm(shape) @ rot
        color = self.compute_color(texture, norm_rot, c["gamma"])
        return vertex, texture, color, landmark


# Pass 1 of ``rasterize`` tests each face against the pixels of its box
# widened by a margin. A face's f32 barycentrics differ from the exact ones
# of its f32 vertices by at most about (48 R + 8 W) u W / |det| (u = 2^-24,
# W the box's larger side, R the pixel's distance to the face's vertices: a
# few roundings of products of coordinate differences, over |det|), and a
# pixel D px outside the box has an exact barycentric below -D / (3 W). So
# once |det| >= 408 u W^2 no rounding lets a pixel pass further out than
# 456 u W^3 / |det| px. SLACK is about 4x both: the margin is
# SLACK W^3 / |det|, at least MARGIN px; a face thinner than SLACK W^2, or
# with |det| < 1e-9 (whose sign s2v_tpu's clamp may flip, and which can pass
# on a whole line of pixels, or on all of them), takes the whole image.
MARGIN = 2.0 ** -4
SLACK = 2.0 ** -13
# pass 1 tests about this many pixel-face pairs at a time (~150 B each)
CANDIDATES = 1 << 23
_EMPTY = torch.iinfo(torch.int64).max
_UNHIT = torch.iinfo(torch.int64).min  # a NaN or -inf depth: s2v_tpu's min is not finite


def _barycentrics(e0x, e0y, e1x, e1y, ax, ay, cx, cy, det, xs, ys):
    """s2v_tpu's expressions (bfm.py:220-225) in its f32 order, det clamped."""
    det = torch.where(det.abs() < 1e-9, 1e-9, det)
    w0 = (e0x * (xs - cx) + e0y * (ys - cy)) / det
    w1 = (e1x * (xs - ax) + e1y * (ys - ay)) / det
    return w0, w1, 1.0 - w0 - w1


def _ordered_bits(z: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 whose order is the floats' (-0 folded into +0)."""
    bits = (z + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


@torch.no_grad()
def _nearest_faces(px, py, z, tri, size: int):
    """Pass 1: each pixel's nearest covering face, s2v_tpu's
    ``argmin(zpix, 0)`` and ``isfinite(min(zpix, 0))``, without its grid.
    Returns (best [B, P] face index, 0 where not hit; hit [B, P])."""
    b, f = px.shape[0], tri.shape[0]
    p, dev = size * size, px.device
    corners = [(px[:, tri[:, k]], py[:, tri[:, k]], z[:, tri[:, k]]) for k in range(3)]
    (ax, ay, az), (bx, by, bz), (cx, cy, cz) = corners
    det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    xs3, ys3 = torch.stack([ax, bx, cx]), torch.stack([ay, by, cy])
    xmin, xmax, ymin, ymax = xs3.amin(0), xs3.amax(0), ys3.amin(0), ys3.amax(0)
    side = torch.maximum(xmax - xmin, ymax - ymin)
    # a NaN det (a vertex at the camera plane) makes every barycentric NaN
    # there, so that face never passes the test
    valid = det.isfinite() & side.isfinite()
    boxed = valid & (det.abs() >= 1e-9) & (det.abs() >= SLACK * side * side)
    margin = torch.clamp(SLACK * side * side * side / det.abs(), min=MARGIN)

    def span(lo, hi):  # first pixel and count along one axis; thin faces: all
        lo = torch.where(boxed, torch.ceil(lo - margin), 0.0).clamp(0, size).long().reshape(-1)
        hi = torch.where(boxed, torch.floor(hi + margin), size - 1.0).clamp(-1, size - 1)
        return lo, (hi.long().reshape(-1) - lo + 1).clamp(min=0)

    x0, wid = span(xmin, xmax)
    y0, hei = span(ymin, ymax)
    counts = torch.where(valid.reshape(-1), wid * hei, 0)
    # per face (b, f): the terms s2v_tpu broadcasts over the pixels
    table = torch.stack([by - cy, cx - bx, cy - ay, ax - cx, ax, ay, cx, cy, det, az, bz, cz],
                        -1).reshape(b * f, 12)

    ends = counts.cumsum(0)
    starts = ends - counts
    total = int(ends[-1]) if ends.numel() else 0
    keys = torch.full((b * p,), _EMPTY, dtype=torch.int64, device=dev)
    budget = max(CANDIDATES, p)
    cuts = torch.searchsorted(starts, torch.arange(1, -(-total // budget), device=dev) * budget)
    bounds = [0] + [i for i in cuts.tolist() if i < b * f] + [b * f]
    offsets = (starts[torch.tensor(bounds[:-1], device=dev)].tolist() if total else [0]) + [total]
    for (i0, i1), (c0, c1) in zip(zip(bounds, bounds[1:]), zip(offsets, offsets[1:])):
        if c1 == c0:
            continue
        inst = torch.repeat_interleave(torch.arange(i0, i1, device=dev), counts[i0:i1],
                                       output_size=c1 - c0)
        local = torch.arange(c0, c1, device=dev) - starts[inst]
        w = wid[inst]
        x, y = x0[inst] + local % w, y0[inst] + local // w
        e0x, e0y, e1x, e1y, fax, fay, fcx, fcy, fdet, faz, fbz, fcz = table[inst].unbind(-1)
        w0, w1, w2 = _barycentrics(e0x, e0y, e1x, e1y, fax, fay, fcx, fcy, fdet,
                                   x.float(), y.float())
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        zpix = w0 * faz + w1 * fbz + w2 * fcz
        # depth in the high 32 bits, the face in the low: amin takes the
        # nearest face, and of equal depths the lowest index, which is the
        # one jnp.argmin returns (its first minimum)
        key = (_ordered_bits(zpix) << 32) | (inst % f)
        key = torch.where(inside & zpix.isfinite(), key, _EMPTY)
        key = torch.where(inside & (zpix.isnan() | (zpix == -math.inf)), _UNHIT, key)
        keys.scatter_reduce_(0, (inst // f) * p + y * size + x, key, "amin")
    hit = (keys != _EMPTY) & (keys != _UNHIT)
    best = torch.where(hit, keys & 0xFFFFFFFF, 0)
    return best.reshape(b, p), hit.reshape(b, p)


def rasterize(
    vertices: torch.Tensor,    # [B, N, 3] camera-space (z = distance)
    faces,                     # [F, 3] int, numpy or tensor
    attributes: torch.Tensor,  # [B, N, C] per-vertex colours
    image_size: int = 224,
    focal: float = 1015.0,
    center: float = 112.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """s2v_tpu's barycentric z-buffer rasterizer (bfm.py:184-242, the
    nvdiffrast RasterizeGLContext replacement): (image [B, H, W, C], mask
    [B, H, W, 1]), NHWC as there.

    Its output depends on its ``[F, P]`` argmin only through the chosen
    face, and the choice carries no gradient, so this works in two passes
    and allocates nothing that scales with F x P:

    1. under ``no_grad``, each face is tested against the pixels of its box
       widened by the margin that rounding needs (``MARGIN``, ``SLACK``)
       with s2v_tpu's inside test in its f32 order, about ``CANDIDATES``
       pairs at a time, and a ``scatter_reduce("amin")`` of a 64-bit key
       (depth bits, then face index) keeps each pixel's nearest face;
    2. the winning face's barycentrics are recomputed at each pixel by
       s2v_tpu's expression, so the gradients to the vertices and the
       attributes are its gradients.
    """
    b = vertices.shape[0]
    size = image_size
    tri = torch.as_tensor(faces, dtype=torch.int64, device=vertices.device)
    xy = vertices[..., :2] * focal / vertices[..., 2:] + center
    px = xy[..., 0]
    py = (size - 1.0) - xy[..., 1]  # flip v
    best, hit = _nearest_faces(px.detach(), py.detach(), vertices[..., 2].detach(), tri, size)

    fb = tri[best]  # [B, P, 3]
    (ax, ay), (bx, by), (cx, cy) = [(px.gather(1, fb[..., k]), py.gather(1, fb[..., k]))
                                    for k in range(3)]
    det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    grid = torch.arange(size * size, device=vertices.device)
    xs, ys = (grid % size).float(), (grid // size).float()
    w0, w1, w2 = _barycentrics(by - cy, cx - bx, cy - ay, ax - cx, ax, ay, cx, cy, det, xs, ys)
    c = attributes.shape[-1]
    va = attributes.gather(1, fb.reshape(b, -1, 1).expand(-1, -1, c)).reshape(b, -1, 3, c)
    img = torch.einsum("bpk,bpkc->bpc", torch.stack([w0, w1, w2], -1), va)
    img = torch.where(hit[..., None], img, 0.0)
    return (img.reshape(b, size, size, c),
            hit.reshape(b, size, size, 1).to(attributes.dtype))
