"""The port's ``ArtifactWriter`` (s2v_torch/utils/artifacts.py) against
s2v_tpu's (tests/test_artifacts.py): the image grid, the wav and the loss
curves, the ``index.html`` dashboard, and the same files as s2v_tpu's
writer on the same inputs: the embedding scatter's SVG, the curves' HTML
and JSON, and the wav byte for byte, the grid's pixels equal."""

import os

import numpy as np
import pytest

from s2v_torch.utils.artifacts import ArtifactWriter
from s2v_tpu.utils.artifacts import ArtifactWriter as JaxArtifactWriter

RNG = np.random.RandomState(301)


def test_image_grid(tmp_path):
    w = ArtifactWriter(str(tmp_path), every=100)
    assert w.should_write(200) and not w.should_write(150)
    imgs = RNG.rand(6, 16, 20, 3).astype(np.float32)
    path = w.image_grid(200, "samples", imgs, ncol=3)
    from PIL import Image

    grid = np.asarray(Image.open(path))
    assert grid.shape == (2 * 16, 3 * 20, 3)
    want = JaxArtifactWriter(str(tmp_path / "jax"), every=100).image_grid(200, "samples", imgs,
                                                                         ncol=3)
    np.testing.assert_array_equal(grid, np.asarray(Image.open(want)))


def test_audio_and_curves(tmp_path):
    w = ArtifactWriter(str(tmp_path / "port"))
    jw = JaxArtifactWriter(str(tmp_path / "jax"))
    t = np.arange(1600) / 16000
    tone = np.sin(2 * np.pi * 440 * t)
    path = w.audio(100, "probe", tone)
    assert os.path.getsize(path) > 3000
    with open(path, "rb") as f, open(jw.audio(100, "probe", tone), "rb") as g:
        assert f.read() == g.read()
    for step in range(0, 100, 10):
        for writer in (w, jw):
            writer.scalars(step, {"loss": 1.0 / (step + 1), "l1": 0.5})
    html = w.curves()
    content = open(html).read()
    assert "<svg" in content and "loss" in content
    assert os.path.isfile(html.replace(".html", ".json"))
    jhtml = jw.curves()
    for a, b in ((html, jhtml), (html.replace(".html", ".json"), jhtml.replace(".html", ".json"))):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


def test_webpage_dashboard(tmp_path):
    w = ArtifactWriter(str(tmp_path), every=1)
    w.scalars(1, {"loss": 1.0})
    w.scalars(2, {"loss": 0.5})
    w.image_grid(2, "fakes", np.random.rand(4, 8, 8, 3))
    w.audio(2, "sample", np.zeros(160), 16000)
    path = w.webpage("exp-1")
    html = open(path).read()
    assert "curves.html" in html and "step_00000002" in html
    assert "fakes.png" in html and "sample.wav" in html
    assert os.path.exists(os.path.join(str(tmp_path), "curves.html"))


@pytest.mark.parametrize("labels", [None, "groups"])
def test_embedding_scatter_svg_is_byte_equal(tmp_path, labels):
    emb = RNG.randn(40, 16).astype(np.float32)
    lab = None if labels is None else list(RNG.randint(0, 9, 40))
    got = ArtifactWriter(str(tmp_path / "port")).embedding_scatter(3, "emb", emb, lab)
    want = JaxArtifactWriter(str(tmp_path / "jax")).embedding_scatter(3, "emb", emb, lab)
    with open(got, "rb") as f, open(want, "rb") as g:
        svg = f.read()
        assert svg == g.read()
    assert svg.count(b"<circle") == 40
