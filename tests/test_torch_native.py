"""The port's native loader (s2v_torch/io/native.py with its own copy of
s2v_loader.cpp) against s2v_tpu's (tests/test_native_io.py):

- the library builds with g++ into build/native/;
- ``crop_resize_u8f32`` equals its numpy version ``crop_resize_u8f32_plain``
  bit for bit and agrees with s2v_tpu's device-side ``resize_bilinear``
  within 1e-4 (as s2v_tpu's test holds its own library; that library is
  not called here: it builds in place, and tests/test_native_io.py may be
  building it in another worker);
- ``prep.degradations.resize_area`` equals the native output bit for bit
  on the quantised image;
- the ring reader streams every frame of a raw clip, bit-equal, through a
  ring smaller than the clip;
- a compiler that fails raises with its output; nothing falls back.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from s2v_torch.io import native
from s2v_torch.prep.degradations import resize_area
from s2v_tpu.ops.image import resize_bilinear

RNG = np.random.RandomState(161)


def test_native_lib_builds():
    so = native.build()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.get_lib() is not None


@pytest.mark.parametrize("box,out_hw", [((10, 90, 5, 77), (64, 48)),
                                        ((0, 120, 0, 100), (37, 23)),
                                        ((30, 40, 20, 26), (64, 80))],
                         ids=["down", "odd", "up"])
def test_crop_resize_matches_plain_and_the_jax_package(box, out_hw):
    frame = (RNG.rand(120, 100, 3) * 255).astype(np.uint8)
    got = native.crop_resize_u8f32(frame, box, out_hw, scale=1.0 / 255.0)
    np.testing.assert_array_equal(got, native.crop_resize_u8f32_plain(frame, box, out_hw,
                                                                      scale=1.0 / 255.0))
    crop = frame[box[0]:box[1], box[2]:box[3]][None].astype(np.float32)
    want = np.asarray(resize_bilinear(jnp.asarray(crop), out_hw))[0] / 255.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_resize_area_equals_the_native_output():
    img = RNG.rand(50, 60, 3).astype(np.float32)
    u8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(resize_area(img, (37, 23)),
                                  native.crop_resize_u8f32(u8, (0, 50, 0, 60), (37, 23),
                                                           scale=1.0 / 255.0))


def test_ring_loader_streams_all_frames(tmp_path):
    h, w = 24, 16
    frames = (RNG.rand(13, h, w, 3) * 255).astype(np.uint8)
    raw = tmp_path / "clip.raw"
    raw.write_bytes(frames.tobytes())
    reader = native.NativeClipReader(str(raw), h, w, slots=4)
    got = list(reader)
    reader.close()
    assert len(got) == 13
    np.testing.assert_array_equal(np.stack(got), frames)
    with pytest.raises(FileNotFoundError):
        native.NativeClipReader(str(tmp_path / "missing.raw"), h, w)


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "COMPILER", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build()
    assert not list((tmp_path / "native").glob("*.so"))
