"""The port's EnCodec (s2v_torch.models.encodec), dataset tools
(s2v_torch.prep.tools) and g2p (s2v_torch.prep.g2p) against s2v_tpu's on
the CPU, f32, inputs from numpy seeds.

- ``causal_pad`` bit-equal at every kernel/stride/dilation the codec uses,
  on inputs shorter than the padding too (the zero pre-pad).
- Two stacked LSTMs with the skip (``SLSTM``) against s2v_tpu's two
  ``LSTM`` modules within 1e-5 of scale.
- A slim SEANet encoder and decoder (8 filters, 16-d) from the same random
  weights through ``encodec_from_jax``: outputs within 1e-4 of their scale.
- The full-width ``EncodecModel`` (32 filters, 128-d, n_q 32): latents
  within 1e-4 of scale; codes equal wherever every stage's top-2 distance
  margin exceeds the bound that the measured latent difference puts on a
  distance, which must cover at least 90% of the frames; ``decode_codes``
  within 1e-4 of scale.
- ``encodec_from_jax`` round trips: the port's state_dict, written in
  Meta's weight-norm layout, through s2v_tpu's ``convert_encodec`` gives
  back the flax tree within 1e-6 relative. transformers' random
  ``EncodecModel`` (both its layout and Meta's) loads strictly and agrees
  with ``convert_encodec``'s tree within 1e-6, and the port's latents and
  codes match transformers' own encoder (2e-4, as tests/test_encodec.py).
- ``frame_windows``, ``audio_to_codes`` with ``EncodecCodec`` against
  ``JaxEncodecCodec`` (resampling 16 kHz input), the text normalisers,
  ``video_to_audio``'s error without ffmpeg and g2p's rule-based fallback:
  equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models import encodec as TE
from s2v_torch.prep import g2p as TG2P
from s2v_torch.prep import tools as TT
from s2v_torch.utils.weights import encodec_from_jax
from s2v_tpu.models import encodec as JE
from s2v_tpu.prep import g2p as JG2P
from s2v_tpu.prep import tools as JT
from s2v_tpu.utils.weights import convert_encodec
from torch_parity import one_torch_thread, random_variables

SLIM = dict(n_filters=8, dimension=16, lstm_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


@pytest.fixture(scope="module")
def full():
    """The full-width model from random flax variables, both packages."""
    wav = np.zeros((1, 640, 1), np.float32)
    variables = random_variables(JE.EncodecModel(), wav.shape, seed=3)
    # random_variables draws codebooks at 0.1 scale; spread them like
    # trained ones (N(0, 1), s2v_tpu's init) so the codes vary
    cb = np.random.RandomState(4).randn(*variables["params"]["quantizer"]["codebooks"].shape)
    variables["params"]["quantizer"]["codebooks"] = cb.astype(np.float32)
    port = TE.EncodecModel().eval()
    port.load_state_dict(encodec_from_jax(variables), strict=True)
    return variables, port


def test_causal_pad_matches_jax_on_short_inputs_too():
    rng = np.random.RandomState(0)
    for length in (1, 2, 3, 5, 9, 50, 321):
        x = rng.randn(2, length, 3).astype(np.float32)
        for k, s, d in [(7, 1, 1), (3, 1, 1), (1, 1, 1), (4, 2, 1), (8, 4, 1), (10, 5, 1),
                        (16, 8, 1), (3, 1, 2)]:
            want = np.asarray(JE.causal_pad(jnp.asarray(x), k, s, d))
            got = TE.causal_pad(torch.from_numpy(x.transpose(0, 2, 1)), k, s, d)
            np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1), want)


def test_stacked_lstm_with_skip_matches_jax():
    rng = np.random.RandomState(1)
    c, t = 12, 9
    x = rng.randn(2, t, c).astype(np.float32)
    params = [random_variables(JE.LSTM(c), x.shape, seed=10 + l)["params"] for l in range(2)]
    h = jnp.asarray(x)
    for p in params:
        h = JE.LSTM(c).apply({"params": p}, h)
    want = np.asarray(h) + x
    port = TE.SLSTM(c, 2)
    sd = {}
    for l, p in enumerate(params):
        sd[f"lstm.weight_ih_l{l}"] = torch.from_numpy(np.asarray(p["weight_ih"]).T.copy())
        sd[f"lstm.weight_hh_l{l}"] = torch.from_numpy(np.asarray(p["weight_hh"]).T.copy())
        sd[f"lstm.bias_ih_l{l}"] = torch.from_numpy(np.asarray(p["bias_ih"]))
        sd[f"lstm.bias_hh_l{l}"] = torch.from_numpy(np.asarray(p["bias_hh"]))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    close(got, want, 1e-5)


def test_slim_encoder_and_decoder_match_jax():
    rng = np.random.RandomState(2)
    wav = (rng.randn(2, 3190, 1) * 0.3).astype(np.float32)  # not a hop multiple
    enc_vars = random_variables(JE.SEANetEncoder(**SLIM), wav.shape, seed=5)
    want = np.asarray(JE.SEANetEncoder(**SLIM).apply(enc_vars, jnp.asarray(wav)))
    enc = TE.SEANetEncoder(**SLIM)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in
                         encodec_from_jax({"params": {"encoder": enc_vars["params"]}}).items()},
                        strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(wav.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, 10, 16)
    close(got, want, 1e-4)

    z = rng.randn(2, 10, 16).astype(np.float32)
    dec_vars = random_variables(JE.SEANetDecoder(**SLIM), z.shape, seed=6)
    want = np.asarray(JE.SEANetDecoder(**SLIM).apply(dec_vars, jnp.asarray(z)))
    dec = TE.SEANetDecoder(**SLIM)
    dec.load_state_dict({k[len("decoder."):]: v for k, v in
                         encodec_from_jax({"params": {"decoder": dec_vars["params"]}}).items()},
                        strict=True)
    with torch.no_grad():
        got = dec(torch.from_numpy(z.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, 3200, 1)
    close(got, want, 1e-4)


def decidable(z, codebooks, codes, delta):
    """[B, T] mask of the frames whose every stage's top-2 distance margin
    exceeds what a latent difference of ``delta`` (max abs) can move a
    distance: |d(r, c)| changes by at most 2 (|r| + |c|) sqrt(D) delta for
    each of the two codewords. ``z`` [B, D, T] and ``codes`` [B, n_q, T]
    from one side; the residuals follow its codes."""
    r = np.asarray(z, np.float64).transpose(0, 2, 1)
    ok = np.ones(r.shape[:2], bool)
    cmax = max(np.linalg.norm(cb, axis=-1).max() for cb in codebooks)
    for q, cb in enumerate(codebooks):
        d2 = ((r[..., None, :] - cb) ** 2).sum(-1)
        two = np.sort(d2, -1)[..., :2]
        bound = 2 * 2 * (np.linalg.norm(r, axis=-1) + cmax) * np.sqrt(r.shape[-1]) * delta
        ok &= (two[..., 1] - two[..., 0]) > bound
        r = r - cb[codes[:, q]]
    return ok


def test_full_model_latents_codes_and_decode_match_jax(full):
    variables, port = full
    rng = np.random.RandomState(7)
    wav = (rng.randn(1, 4800, 1) * 0.3).astype(np.float32)  # 0.2 s: 15 frames
    model = JE.EncodecModel()
    want_z = np.asarray(model.apply(variables, jnp.asarray(wav),
                                    method=lambda m, w: m.encoder(w)))
    want_codes = np.asarray(model.apply(variables, jnp.asarray(wav), method=JE.EncodecModel.encode))
    x = torch.from_numpy(wav.transpose(0, 2, 1))
    with torch.no_grad():
        z = port.encoder(x)
        codes = port.encode(x)
    delta = close(z.numpy().transpose(0, 2, 1), want_z, 1e-4)
    assert codes.shape == want_codes.shape == (1, 32, 15)
    assert len(np.unique(want_codes)) > 20  # guard against vacuity
    cbs = [port.quantizer.codebook(q).numpy() for q in range(32)]
    ok = decidable(want_z.transpose(0, 2, 1), cbs, want_codes, max(delta, 1e-7))
    assert ok.mean() >= 0.9, ok.mean()
    np.testing.assert_array_equal(codes.numpy().transpose(0, 2, 1)[ok], want_codes.transpose(0, 2, 1)[ok])

    want_wav = np.asarray(model.apply(variables, jnp.asarray(want_codes),
                                      method=JE.EncodecModel.decode_codes))
    with torch.no_grad():
        got_wav = port.decode_codes(torch.from_numpy(want_codes.astype(np.int64)))
    assert got_wav.shape == (1, 1, 15 * TE.HOP)
    close(got_wav.numpy().transpose(0, 2, 1), want_wav, 1e-4)


def to_meta_weight_norm(sd):
    """The port's state_dict in Meta's layout, each conv weight as a
    trivial weight-norm pair (v = w, g = ||w|| over all but axis 0)."""
    out = {}
    for k, v in sd.items():
        v = v.numpy()
        if k.endswith(".weight") and (".conv.conv." in k or ".convtr.convtr." in k):
            out[k + "_v"] = v
            out[k + "_g"] = np.sqrt((v.astype(np.float64) ** 2).sum((1, 2), keepdims=True)
                                    ).astype(np.float32)
        else:
            out[k] = v
    return out


def test_encodec_from_jax_round_trips_through_convert_encodec(full):
    variables, port = full
    back = convert_encodec(to_meta_weight_norm(port.state_dict()))["params"]
    flat_a = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_a.keys() == flat_b.keys()
    for path, leaf in flat_a.items():
        np.testing.assert_allclose(flat_b[path], leaf, rtol=1e-6, atol=1e-6 * np.abs(leaf).max(),
                                   err_msg=str(path))


def test_reference_layouts_load_strictly_and_match_transformers():
    from transformers import EncodecConfig
    from transformers import EncodecModel as HFEncodec

    torch.manual_seed(17)
    hf = HFEncodec(EncodecConfig()).eval()
    with torch.no_grad():  # HF random-init codebooks are zeros
        for q in range(32):
            hf.quantizer.layers[q].codebook.embed.normal_(0, 1.0)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    meta = {}
    for k, v in sd.items():  # tests/test_encodec.py's layout rewrite
        mk = k.replace("encoder.layers.", "encoder.model.").replace("decoder.layers.", "decoder.model.")
        mk = mk.replace("quantizer.layers.", "quantizer.vq.layers.").replace(".codebook.", "._codebook.")
        if mk.startswith("decoder.model.") and ".block." not in mk and ".shortcut." not in mk \
                and ".lstm." not in mk and int(mk.split(".")[2]) not in (0, 15):
            mk = mk.replace(".conv.", ".convtr.convtr.", 1)
        else:
            mk = mk.replace(".conv.", ".conv.conv.", 1)
        mk = mk.replace(".parametrizations.weight.original0", ".weight_g")
        mk = mk.replace(".parametrizations.weight.original1", ".weight_v")
        meta[mk] = v
    want = encodec_from_jax(convert_encodec(sd))
    ports = []
    for layout in (sd, meta):
        port = TE.EncodecModel().eval()
        port.load_state_dict(TE.reference_state_dict(layout), strict=True)
        got = port.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(v.abs().max()), err_msg=k)
        ports.append(port)

    wav = (np.random.RandomState(8).randn(2, 1, 3190) * 0.3).astype(np.float32)
    x = torch.from_numpy(wav)
    with torch.no_grad():
        lat = hf.encoder(x)
        codes_hf = hf.encode(x, bandwidth=24.0).audio_codes[0]
        for port in ports:
            np.testing.assert_allclose(port.encoder(x).numpy(), lat.numpy(), rtol=0, atol=2e-4)
            np.testing.assert_array_equal(port.encode(x).numpy(), codes_hf.numpy())


def test_audio_to_codes_with_the_port_codec_matches_jax(full):
    variables, port = full
    rng = np.random.RandomState(9)
    sr, fps, n = 16000, 25.0, 3
    wav = (rng.randn(int(sr * n / fps) + 800) * 0.2).astype(np.float32)
    np.testing.assert_array_equal(TT.frame_windows(wav, sr, n, fps), JT.frame_windows(wav, sr, n, fps))
    want = JT.audio_to_codes(wav, sr, n, fps, codec=JE.JaxEncodecCodec(variables))
    got = TT.audio_to_codes(wav, sr, n, fps, codec=TE.EncodecCodec(port, device="cpu"))
    assert got.shape == want.shape == (n, 32, 15)
    assert TE.frame_codes_per_video_frame(torch.from_numpy(got)) == (32, 15)
    # every window's codes, where the margins allow (as the full-model test)
    chunks = TT.frame_windows(wav, sr, n, fps)
    from s2v_torch.io.audio_io import resample

    cbs = [port.quantizer.codebook(q).numpy() for q in range(32)]
    model = JE.EncodecModel()
    for i, chunk in enumerate(chunks):
        x = resample(chunk, sr, 24000)[None, :, None]
        want_z = np.asarray(model.apply(variables, jnp.asarray(x), method=lambda m, w: m.encoder(w)))
        with torch.no_grad():
            z = port.encoder(torch.from_numpy(x.transpose(0, 2, 1)))
        delta = close(z.numpy().transpose(0, 2, 1), want_z, 1e-4)
        ok = decidable(want_z.transpose(0, 2, 1), cbs, want[i][None], max(delta, 1e-7))[0]
        assert ok.mean() >= 0.9, ok.mean()
        np.testing.assert_array_equal(got[i][:, ok], want[i][:, ok])


def test_text_tools_ffmpeg_error_and_g2p_match_jax(tmp_path, monkeypatch):
    texts = ["SPEAKER 1: Hello there, world!\nsecond line\n", "a:b:c\nd", "x: \n"]
    for t in texts:
        assert TT.remove_header(t) == JT.remove_header(t)
        assert TT.normalize_text(t) == JT.normalize_text(t)
    for bad in ("header only:", "no header\nx"):  # nothing after the header
        for mod in (TT, JT):
            with pytest.raises(ValueError):
                mod.normalize_text(bad)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    for i, t in enumerate(texts):
        p = tmp_path / f"t{i}.txt"
        p.write_text(t)
        outs = [mod.normalize_text_file(str(p), str(tmp_path / d))
                for mod, d in ((TT, "port"), (JT, "jax"))]
        assert open(outs[0]).read() == open(outs[1]).read() == JT.normalize_text(t)
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    errs = []
    for mod in (TT, JT):
        with pytest.raises(RuntimeError) as e:
            mod.video_to_audio(str(tmp_path / "clip.mp4"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    for text in ("The quick brown fox's phone, which chimes!", "Queen thought; ring-a-ding.",
                 "xyz 42 OOH aye?"):
        assert TG2P.encode(text) == JG2P.encode(text)
        assert TG2P._simple_letter_to_sound(text) == JG2P._simple_letter_to_sound(text)
