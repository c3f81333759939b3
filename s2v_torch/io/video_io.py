"""Video IO with pluggable backends (a copy of s2v_tpu/io/video_io.py).

The reference uses cv2.VideoCapture / cv2.VideoWriter + an ffmpeg subprocess
for muxing (inference.py:66-79, 246-249, 335-336). The backends are
probed in order:

1. ffmpeg binary (rawvideo pipe, zero-copy into numpy)
2. imageio (if a video plugin is installed)
3. ``.npy``/``.npz`` clips — [N, H, W, 3] uint8 arrays, the codec-free
   interchange format used by tests and benchmarks

Readers yield RGB uint8 frames; writers accept the same.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_FFMPEG = shutil.which("ffmpeg")
_FFPROBE = shutil.which("ffprobe")


class VideoReader:
    def __init__(self, path: str):
        self.path = path
        self._frames: Optional[np.ndarray] = None
        self.fps: float = 25.0
        if path.endswith((".npy", ".npz")):
            data = np.load(path, allow_pickle=False)
            if isinstance(data, np.lib.npyio.NpzFile):
                self._frames = data["frames"]
                self.fps = float(data["fps"]) if "fps" in data else 25.0
            else:
                self._frames = data
            self.shape = self._frames.shape[1:3]
        elif _FFMPEG is not None:
            self.fps, self.shape = self._probe(path)
        else:
            try:
                import imageio

                self._reader = imageio.get_reader(path)
                meta = self._reader.get_meta_data()
                self.fps = float(meta.get("fps", 25.0))
                first = self._reader.get_data(0)
                self.shape = first.shape[:2]
                self._imageio = True
                return
            except Exception as e:
                raise RuntimeError(
                    f"cannot decode {path!r}: no ffmpeg binary, no imageio "
                    "video plugin. Convert the clip to .npz "
                    "(frames=[N,H,W,3] uint8, fps=float) first."
                ) from e
        self._imageio = False

    @staticmethod
    def _probe(path: str) -> Tuple[float, Tuple[int, int]]:
        out = subprocess.run(
            [_FFPROBE or "ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height,r_frame_rate",
             "-of", "csv=p=0", path],
            capture_output=True, text=True, check=True,
        ).stdout.strip().split(",")
        w, h = int(out[0]), int(out[1])
        num, den = out[2].split("/")
        return float(num) / float(den), (h, w)

    def read_all(self) -> np.ndarray:
        """[N, H, W, 3] RGB uint8."""
        if self._frames is not None:
            return self._frames
        if getattr(self, "_imageio", False):
            return np.stack([f[..., :3] for f in self._reader])
        h, w = self.shape
        out = subprocess.run(
            [_FFMPEG, "-loglevel", "error", "-i", self.path, "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-"],
            capture_output=True, check=True,
        )
        return np.frombuffer(out.stdout, np.uint8).reshape(-1, h, w, 3)


class VideoWriter:
    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int]):
        self.path = path
        self.fps = fps
        self.size_hw = size_hw
        self._frames = []
        self._proc = None
        if not path.endswith((".npy", ".npz")) and _FFMPEG is not None:
            h, w = size_hw
            self._proc = subprocess.Popen(
                [_FFMPEG, "-loglevel", "error", "-y", "-f", "rawvideo",
                 "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps),
                 "-i", "-", "-pix_fmt", "yuv420p", path],
                stdin=subprocess.PIPE,
            )

    def write(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame.astype(np.uint8))
        if self._proc is not None:
            self._proc.stdin.write(frame.tobytes())
        else:
            self._frames.append(frame)

    def close(self):
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
        elif self._frames:
            path = self.path
            if not path.endswith((".npy", ".npz")):
                path = path + ".npz"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # uncompressed: zlib on a full clip costs seconds of single-core
            # host time in the write path (the codec-backed branch above is
            # the real product writer; .npz is the headless surrogate)
            np.savez(path, frames=np.stack(self._frames), fps=self.fps)
            self.path = path


def mux_audio(video_path: str, audio_path: str, out_path: str):
    """ffmpeg audio mux (inference.py:335-336); no-op copy without ffmpeg."""
    if _FFMPEG is not None and not video_path.endswith(".npz"):
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        subprocess.run(
            [_FFMPEG, "-loglevel", "error", "-y", "-i", audio_path, "-i",
             video_path, "-strict", "-2", "-q:v", "1", out_path],
            check=True,
        )
    else:
        if not out_path.endswith(".npz"):
            out_path = out_path + ".npz"
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        shutil.copy(video_path, out_path)
    return out_path
