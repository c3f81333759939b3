"""ctypes bindings for the native loader, ``s2v_torch/io/native/s2v_loader.cpp``
(s2v_tpu/io/native.py): a threaded ring-buffer reader of raw RGB24 clips
and a uint8 -> float32 crop + bilinear resize.

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout (listed in ``.gitignore``); its file name carries
a hash of the source and flags, so an edited source rebuilds. A failed
build raises with the compiler's output: nothing falls back to Python.
``crop_resize_u8f32_plain`` is the same arithmetic in numpy, the version
the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "s2v_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = "g++"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libs2v_loader-{digest[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [COMPILER, *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"s2v_loader: cannot run {COMPILER}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"s2v_loader: {' '.join(cmd)} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.s2v_crop_resize_u8f32.restype = None
            lib.s2v_crop_resize_u8f32.argtypes = (
                [ctypes.c_void_p] + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
                + [ctypes.c_int64] * 2 + [ctypes.c_float])
            lib.s2v_loader_open.restype = ctypes.c_void_p
            lib.s2v_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
            lib.s2v_loader_next.restype = ctypes.c_int
            lib.s2v_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.s2v_loader_close.restype = None
            lib.s2v_loader_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def crop_resize_u8f32(frame: np.ndarray, box: Tuple[int, int, int, int],
                      out_hw: Tuple[int, int], scale: float = 1.0) -> np.ndarray:
    """[H, W, C] uint8, box (y0, y1, x0, x1) -> [oh, ow, C] float32 times
    ``scale``, bilinear with torch's align_corners=False semantics (the
    source coordinate clamped at 0), in the library."""
    y0, y1, x0, x1 = box
    oh, ow = out_hw
    frame = np.ascontiguousarray(frame, np.uint8)
    out = np.empty((oh, ow, frame.shape[2]), np.float32)
    get_lib().s2v_crop_resize_u8f32(
        frame.ctypes.data_as(ctypes.c_void_p), frame.shape[0], frame.shape[1],
        frame.shape[2], y0, y1, x0, x1, out.ctypes.data_as(ctypes.c_void_p), oh, ow, scale)
    return out


def crop_resize_u8f32_plain(frame: np.ndarray, box: Tuple[int, int, int, int],
                            out_hw: Tuple[int, int], scale: float = 1.0) -> np.ndarray:
    """``crop_resize_u8f32``'s arithmetic in numpy."""
    y0, y1, x0, x1 = box
    oh, ow = out_hw
    crop = np.asarray(frame, np.uint8)[y0:y1, x0:x1].astype(np.float32)
    ch, cw = crop.shape[:2]

    def weights(n_in, n_out):
        s = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0)
        i0 = np.minimum(s.astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), (s - i0).astype(np.float32)

    r0, r1, wy = weights(ch, oh)
    c0, c1, wx = weights(cw, ow)
    wx, wy = wx[None, :, None], wy[:, None, None]

    def row(r):  # top + wx * (right - left), as the library rounds it
        left, right = crop[r][:, c0], crop[r][:, c1]
        return left + wx * (right - left)

    top, bot = row(r0), row(r1)
    return (top + wy * (bot - top)) * np.float32(scale)


class NativeClipReader:
    """Threaded ring-buffer raw-RGB24 clip reader (the producer thread in
    C++, ``slots`` frames ahead). Reads .raw files, or fifos fed by ffmpeg
    ``-f rawvideo``. Iterates [h, w, c] uint8 frames; ``close`` stops the
    thread."""

    def __init__(self, path: str, h: int, w: int, c: int = 3, slots: int = 8):
        self.shape = (h, w, c)
        self._lib = get_lib()
        self._handle = self._lib.s2v_loader_open(os.fsencode(path), h * w * c, slots)
        if not self._handle:
            raise FileNotFoundError(path)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        out = np.empty(self.shape, np.uint8)
        if not self._lib.s2v_loader_next(self._handle, out.ctypes.data_as(ctypes.c_void_p)):
            raise StopIteration
        return out

    def close(self):
        if self._handle is not None:
            self._lib.s2v_loader_close(self._handle)
            self._handle = None
