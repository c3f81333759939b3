"""Training artifact dumps (reference: third_part/emb/utils/artifacts.py
:36-103, periodic figures/wavs; ganimation_replicate/visualizer.py and
face3d/util/visualizer.py image dashboards; s2v_tpu/utils/artifacts.py).

Dependency-light: image grids as PNGs (Pillow, imported by ``image_grid``
alone), wavs through the standard library, loss curves and embedding
scatters as self-contained HTML/SVG, all keyed by step under an artifacts
directory. Inputs are numpy arrays (or anything ``np.asarray`` takes: a
tensor on the card goes through ``.cpu()`` first).
"""

from __future__ import annotations

import json
import os
import wave
from typing import Dict, List, Optional, Sequence

import numpy as np


class ArtifactWriter:
    def __init__(self, directory: str, every: int = 1000):
        self.directory = directory
        self.every = every
        self._history: Dict[str, List] = {}

    def _path(self, step: int, name: str) -> str:
        d = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def should_write(self, step: int) -> bool:
        return self.every > 0 and step % self.every == 0

    def image_grid(self, step: int, name: str, images: np.ndarray,
                   ncol: int = 4, value_range=(0.0, 1.0)) -> str:
        """[N, H, W, 3] float -> one PNG grid."""
        from PIL import Image

        lo, hi = value_range
        imgs = np.clip((np.asarray(images, np.float32) - lo) / (hi - lo), 0, 1)
        imgs = (imgs * 255).astype(np.uint8)
        n, h, w, c = imgs.shape
        ncol = min(ncol, n)
        nrow = -(-n // ncol)
        grid = np.zeros((nrow * h, ncol * w, c), np.uint8)
        for i in range(n):
            r, col = divmod(i, ncol)
            grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = imgs[i]
        path = self._path(step, f"{name}.png")
        Image.fromarray(grid).save(path)
        return path

    def audio(self, step: int, name: str, wav_data: np.ndarray,
              sr: int = 16000) -> str:
        """mono float [-1, 1] -> 16-bit wav (artifacts.py wav dumps)."""
        path = self._path(step, f"{name}.wav")
        data = np.clip(np.asarray(wav_data, np.float32), -1, 1)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes((data * 32767).astype(np.int16).tobytes())
        return path

    def scalars(self, step: int, values: Dict[str, float]):
        """Accumulate loss curves; render with ``curves()``."""
        for k, v in values.items():
            self._history.setdefault(k, []).append((step, float(v)))

    def curves(self, name: str = "curves") -> str:
        """Self-contained SVG-in-HTML loss curves (visualizer analogue)."""
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"{name}.html")
        w, h, pad = 800, 300, 40
        parts = ["<html><body>"]
        for key, pts in self._history.items():
            if len(pts) < 2:
                continue
            xs = np.asarray([p[0] for p in pts], np.float64)
            ys = np.asarray([p[1] for p in pts], np.float64)
            x0, x1 = xs.min(), max(xs.max(), xs.min() + 1)
            y0, y1 = ys.min(), max(ys.max(), ys.min() + 1e-9)
            px = pad + (xs - x0) / (x1 - x0) * (w - 2 * pad)
            py = h - pad - (ys - y0) / (y1 - y0) * (h - 2 * pad)
            poly = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
            parts.append(
                f"<h3>{key} (last={ys[-1]:.5g}, min={y0:.5g})</h3>"
                f"<svg width={w} height={h} style='border:1px solid #ccc'>"
                f"<polyline fill='none' stroke='#27f' stroke-width='1.5' "
                f"points='{poly}'/></svg>"
            )
        parts.append("</body></html>")
        with open(path, "w") as f:
            f.write("".join(parts))
        json_path = os.path.join(self.directory, f"{name}.json")
        with open(json_path, "w") as f:
            json.dump(self._history, f)
        return path

    def webpage(self, title: str = "experiment") -> str:
        """Render ``index.html``: the training dashboard — loss curves at
        the top, then every dumped step directory (newest first) with its
        images/SVGs inlined. The face3d/util/visualizer.py HTML webpage +
        ganimation visdom dashboard equivalent (Visualizer.
        display_current_results, visualizer.py:82-115), rebuilt as a static
        self-contained page (no visdom server / tensorboard daemon — a TPU
        job just writes files; open over any file share)."""
        os.makedirs(self.directory, exist_ok=True)
        self.curves()
        parts = [f"<html><head><title>{title}</title></head><body>",
                 f"<h1>{title}</h1>",
                 "<p><a href='curves.html'>loss curves</a> | "
                 "<a href='curves.json'>raw scalars</a></p>"]
        steps = sorted((d for d in os.listdir(self.directory)
                        if d.startswith("step_")), reverse=True)
        for d in steps:
            files = sorted(os.listdir(os.path.join(self.directory, d)))
            imgs = "".join(
                f"<figure style='display:inline-block;margin:4px'>"
                f"<img src='{d}/{f}' style='max-width:320px'>"
                f"<figcaption>{f}</figcaption></figure>"
                for f in files if f.endswith((".png", ".svg")))
            extra = ", ".join(f"<a href='{d}/{f}'>{f}</a>"
                              for f in files
                              if not f.endswith((".png", ".svg")))
            parts.append(f"<h2>{d}</h2>{imgs}"
                         + (f"<p>{extra}</p>" if extra else ""))
        parts.append("</body></html>")
        path = os.path.join(self.directory, "index.html")
        with open(path, "w") as f:
            f.write("".join(parts))
        return path

    def embedding_scatter(self, step: int, name: str,
                          embeddings: np.ndarray,
                          labels: Optional[Sequence] = None) -> str:
        """2-D embedding projection scatter as a self-contained SVG
        (emb/utils/artifacts.py t-SNE figure; PCA projection here, which needs
        no sklearn and keeps the dump deterministic)."""
        x = np.asarray(embeddings, np.float64)
        x = x - x.mean(0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        p = x @ vt[:2].T  # [N, 2]
        lo, hi = p.min(0), p.max(0)
        span = np.maximum(hi - lo, 1e-9)
        w, h, pad = 480, 480, 20
        px = pad + (p[:, 0] - lo[0]) / span[0] * (w - 2 * pad)
        py = h - pad - (p[:, 1] - lo[1]) / span[1] * (h - 2 * pad)
        if labels is None:
            labels = np.zeros(len(p), int)
        uniq = {l: i for i, l in enumerate(dict.fromkeys(labels))}
        colors = ["#27f", "#f42", "#2a2", "#a2a", "#fa0", "#0aa", "#888"]
        dots = "".join(
            f"<circle cx='{a:.1f}' cy='{b:.1f}' r='3' "
            f"fill='{colors[uniq[l] % len(colors)]}'/>"
            for a, b, l in zip(px, py, labels)
        )
        path = self._path(step, f"{name}.svg")
        with open(path, "w") as f:
            f.write(f"<svg xmlns='http://www.w3.org/2000/svg' width='{w}' "
                    f"height='{h}' style='background:#fff'>{dots}</svg>")
        return path
