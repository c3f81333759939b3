"""Weights for the port's modules.

- ``load_reference(module, state_dict)``: load a reference torch checkpoint
  as it is. Spectral-normalised convs (LNet's blocks) arrive as
  ``weight_orig`` / ``weight_u`` / ``weight_v``; they fold into
  ``weight = weight_orig / sigma``, sigma = u . (W v), as torch computes in
  eval mode.
- ``*_from_jax(variables)``: s2v_tpu's flax variable trees (numpy leaves)
  -> the port module's ``state_dict``, the inverse of s2v_tpu's
  ``convert_*`` (conv HWIO -> OIHW, dense [in, out] -> [out, in],
  LayerNorm2d (C,) -> (C, 1, 1), modulated conv HWIO -> (1, O, I, k, k),
  transposed conv HWOI -> IOHW, conv1d [k, in, out] -> [out, in, k]).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.models.gpen import BLUR_TAPS, make_kernel
from s2v_torch.ops.convs import (conv1d_weight_from_kio, conv_transpose_weight_from_hwoi,
                                 conv_weight_from_hwio, linear_weight_from_dense)

StateDict = Dict[str, torch.Tensor]


def fold_spectral_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_orig"):
            base = k[: -len("_orig")]
            w = torch.as_tensor(v).float()
            u = torch.as_tensor(sd[base + "_u"]).float()
            vv = torch.as_tensor(sd[base + "_v"]).float()
            sigma = torch.dot(u, w.reshape(w.shape[0], -1) @ vv)
            out[base] = w / sigma
        elif not (k.endswith(".weight_u") or k.endswith(".weight_v")):
            out[k] = torch.as_tensor(v)
    return out


def load_torch_checkpoint(path: str, key: Optional[str] = "state_dict") -> StateDict:
    """A reference checkpoint file -> its flat state_dict of CPU tensors
    (s2v_tpu's ``load_torch_checkpoint``, models/__init__.py:12-27): the
    entry under ``key`` when the file holds one, ``module.`` prefixes
    stripped. Reference files pickle more than tensors (optimizer state,
    epoch counters), so this loads with ``weights_only=False``: read only
    files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if key and isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    return {k.removeprefix("module."): t.detach() for k, t in ckpt.items()}


def merge_enet_lnet(enet_sd: StateDict, lnet_sd: StateDict) -> StateDict:
    """ENet.pth + LNet.pth -> one ENet state_dict, as the reference loads
    them (models/__init__.py:29-35; s2v_tpu's ``convert_enet``): ENet's own
    ``low_res`` keys are skipped and LNet.pth fills the wrapped LNet."""
    sd = {k: v for k, v in enet_sd.items() if not k.startswith("low_res.")}
    sd.update({f"low_res.{k}": v for k, v in lnet_sd.items()})
    return sd


def load_reference(module: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a reference checkpoint's state_dict (strict), folding spectral
    norm first and dropping the ``module.`` prefix that DataParallel
    checkpoints carry (``RetinaFace-R50.pth``; retinaface_detection.py
    strips it too)."""
    module.load_state_dict(fold_spectral_norm(
        {k.removeprefix("module."): v for k, v in sd.items()}))
    return module


# --- flax -> torch -----------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv(d, prefix: str, sd: StateDict) -> None:
    """flax conv {weight HWIO[, bias]} -> ``prefix.weight`` OIHW[, .bias]."""
    sd[f"{prefix}.weight"] = _t(conv_weight_from_hwio(d["weight"]))
    if "bias" in d:
        sd[f"{prefix}.bias"] = _t(d["bias"])


def _linear(d, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(linear_weight_from_dense(d["weight"]))
    if "bias" in d:
        sd[f"{prefix}.bias"] = _t(d["bias"])


def _bn(p, s, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(p["weight"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["running_mean"])
    sd[f"{prefix}.running_var"] = _t(s["running_var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _ln2d(d, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(d["weight"]).reshape(-1, 1, 1))
    sd[f"{prefix}.bias"] = _t(np.asarray(d["bias"]).reshape(-1, 1, 1))


def _norm_block(d, prefix: str, sd: StateDict) -> None:
    _conv(d["conv"], f"{prefix}.model.0", sd)
    _ln2d(d["norm"], f"{prefix}.model.1", sd)


def _adain(d, prefix: str, sd: StateDict) -> None:
    _linear(d["mlp_shared"], f"{prefix}.mlp_shared.0", sd)
    _linear(d["mlp_gamma"], f"{prefix}.mlp_gamma", sd)
    _linear(d["mlp_beta"], f"{prefix}.mlp_beta", sd)


def lnet_from_jax(variables, prefix: str = "") -> StateDict:
    """s2v_tpu LNet variables -> LNet state_dict (keys under ``prefix``)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    enc = p["encoder"]
    for name, blk in enc.items():
        if name.startswith(("first_", "inp_down", "ref_down")):
            _norm_block(blk, f"{prefix}encoder.{name}", sd)
        elif name.startswith("ca"):
            depth = sum(1 for k in blk if k.startswith("attn"))
            for d in range(depth):
                lay = f"{prefix}encoder.{name}.layers.{d}"
                sd[f"{lay}.0.normx.weight"] = _t(blk[f"normx{d}"]["weight"])
                sd[f"{lay}.0.normx.bias"] = _t(blk[f"normx{d}"]["bias"])
                sd[f"{lay}.0.normy.weight"] = _t(blk[f"normy{d}"]["weight"])
                sd[f"{lay}.0.normy.bias"] = _t(blk[f"normy{d}"]["bias"])
                for q in ("to_q", "to_k", "to_v"):
                    _linear(blk[f"attn{d}"][q], f"{lay}.0.fn.{q}", sd)
                if "to_out" in blk[f"attn{d}"]:
                    _linear(blk[f"attn{d}"]["to_out"], f"{lay}.0.fn.to_out.0", sd)
                sd[f"{lay}.1.norm.weight"] = _t(blk[f"normf{d}"]["weight"])
                sd[f"{lay}.1.norm.bias"] = _t(blk[f"normf{d}"]["bias"])
                _linear(blk[f"ff{d}"]["fc1"], f"{lay}.1.fn.net.0", sd)
                _linear(blk[f"ff{d}"]["fc2"], f"{lay}.1.fn.net.3", sd)
    ae, ae_s = p["audio_encoder"], s["audio_encoder"]
    for k in range(len(ae)):
        blk = f"{prefix}audio_encoder.{k}.conv_block"
        _conv(ae[f"conv{k}"]["conv"], f"{blk}.0", sd)
        _bn(ae[f"conv{k}"]["bn"], ae_s[f"conv{k}"]["bn"], f"{blk}.1", sd)
    dec, dec_s = p["decoder"], s["decoder"]
    for name, lvl in dec.items():
        if name.startswith(("up", "jump")):
            _norm_block(lvl, f"{prefix}decoder.{name}", sd)
        elif name.startswith("res"):
            for j, blk in lvl.items():
                for cname in ("conv1", "conv2"):
                    lama, lama_s = blk[cname], dec_s[name][j][cname]
                    pre = f"{prefix}decoder.{name}.{j}.{cname}"
                    ffc, ffc_s = lama["ffc"], lama_s["ffc"]["convg2g"]
                    for c in ("convl2l", "convl2g", "convg2l"):
                        _conv(ffc[c], f"{pre}.ffc.{c}", sd)
                    g2g = ffc["convg2g"]
                    _conv(g2g["conv1"], f"{pre}.ffc.convg2g.conv1.0", sd)
                    _bn(g2g["conv1_bn"], ffc_s["conv1_bn"], f"{pre}.ffc.convg2g.conv1.1", sd)
                    _conv(g2g["fu"]["conv_layer"], f"{pre}.ffc.convg2g.fu.conv_layer", sd)
                    _bn(g2g["fu"]["bn"], ffc_s["fu"]["bn"], f"{pre}.ffc.convg2g.fu.bn", sd)
                    _conv(g2g["conv2"], f"{pre}.ffc.convg2g.conv2", sd)
                    _adain(lama["bn_l"], f"{pre}.bn_l", sd)
                    _adain(lama["bn_g"], f"{pre}.bn_g", sd)
    _conv(dec["final"]["conv"], f"{prefix}decoder.final.model.0", sd)
    return sd


def _modconv(d, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(conv_weight_from_hwio(d["weight"])[None])  # (1,O,I,k,k)
    _linear(d["modulation"], f"{prefix}.modulation", sd)


def _styleconv_from_jax(d, prefix: str, sd: StateDict) -> None:
    _modconv(d["modulated_conv"], f"{prefix}.modulated_conv", sd)
    sd[f"{prefix}.weight"] = _t(d["noise_weight"])
    sd[f"{prefix}.bias"] = _t(np.asarray(d["bias"]).reshape(1, -1, 1, 1))


def _torgb_from_jax(d, prefix: str, sd: StateDict) -> None:
    _modconv(d["modulated_conv"], f"{prefix}.modulated_conv", sd)
    sd[f"{prefix}.bias"] = _t(np.asarray(d["bias"]).reshape(1, 3, 1, 1))


def enet_from_jax(variables) -> StateDict:
    """s2v_tpu ENet variables (with the wrapped LNet under ``low_res``) ->
    ENet state_dict."""
    p = variables["params"]
    se = p["style_encoder"]
    sd: StateDict = {}
    _conv(se["conv_body_first"], "conv_body_first", sd)
    n_down = sum(1 for k in se if k.startswith("conv_body_down"))
    for i in range(n_down):
        for c in ("conv1", "conv2", "skip"):
            _conv(se[f"conv_body_down{i}"][c], f"conv_body_down.{i}.{c}", sd)
    _conv(se["final_conv"], "final_conv", sd)
    _linear(se["final_linear"], "final_linear", sd)
    for k in range(4):
        _styleconv_from_jax(p[f"style_conv{k}"], f"style_convs.{k}", sd)
    for k in range(2):
        _torgb_from_jax(p[f"to_rgb{k}"], f"to_rgbs.{k}", sd)
    low = {"params": p["low_res"],
           "batch_stats": variables.get("batch_stats", {}).get("low_res", {})}
    sd.update(lnet_from_jax(low, prefix="low_res."))
    return sd


def _gpen_styledconv(d, prefix: str, sd: StateDict) -> None:
    _modconv(d["conv"], f"{prefix}.conv", sd)
    sd[f"{prefix}.noise.weight"] = _t(d["noise_weight"])
    sd[f"{prefix}.activate.bias"] = _t(d["act_bias"])


def gpen_from_jax(variables) -> StateDict:
    """s2v_tpu FullGenerator or FullGeneratorSR variables -> the port
    module's state_dict (the reference FullGenerator / FullGenerator_SR
    layout: the encoder's depth is read from the tree), including the blur
    FIR buffers the reference registers."""
    p = variables["params"]
    sd: StateDict = {}
    blur = _t(make_kernel(BLUR_TAPS))
    n_ecd = sum(1 for k in p if k.startswith("ecd"))
    for i in range(n_ecd):
        d = p[f"ecd{i}"]
        base = f"ecd{i}.0.{1 if i else 0}"
        if i:
            sd[f"ecd{i}.0.0.kernel"] = blur.clone()
        sd[f"{base}.weight"] = _t(conv_weight_from_hwio(d["conv"]["weight"]))
        sd[f"ecd{i}.0.{2 if i else 1}.bias"] = _t(d["act_bias"])
    _linear(p["final_linear"], "final_linear.0", sd)
    g = p["generator"]
    n_mlp = sum(1 for k in g if k.startswith("style") and k[5:].isdigit())
    for i in range(n_mlp):
        _linear(g[f"style{i}"], f"generator.style.{i + 1}", sd)
    sd["generator.input.input"] = _t(np.transpose(np.asarray(g["constant_input"]), (0, 3, 1, 2)))
    _gpen_styledconv(g["conv1"], "generator.conv1", sd)
    _modconv(g["to_rgb1"]["conv"], "generator.to_rgb1.conv", sd)
    sd["generator.to_rgb1.bias"] = _t(np.asarray(g["to_rgb1"]["bias"]).reshape(1, 3, 1, 1))
    n_rgb = sum(1 for k in g if k.startswith("to_rgbs"))
    for k in range(n_rgb):
        for j in (2 * k, 2 * k + 1):
            _gpen_styledconv(g[f"convs{j}"], f"generator.convs.{j}", sd)
        sd[f"generator.convs.{2 * k}.conv.blur.kernel"] = blur * 4
        rgb = f"generator.to_rgbs.{k}"
        _modconv(g[f"to_rgbs{k}"]["conv"], f"{rgb}.conv", sd)
        sd[f"{rgb}.bias"] = _t(np.asarray(g[f"to_rgbs{k}"]["bias"]).reshape(1, 3, 1, 1))
        sd[f"{rgb}.upsample.kernel"] = blur * 4
    return sd


def _gpen_convlayer(d, prefix: str, sd: StateDict, downsample: bool) -> None:
    """JAX ConvLayer {conv: {weight}[, act_bias]} -> the reference's
    Sequential ``[Blur,] EqualConv2d[, FusedLeakyReLU]``."""
    i = 0
    if downsample:
        sd[f"{prefix}.0.kernel"] = _t(make_kernel(BLUR_TAPS))
        i = 1
    _conv(d["conv"], f"{prefix}.{i}", sd)
    if "act_bias" in d:
        sd[f"{prefix}.{i + 1}.bias"] = _t(d["act_bias"])


def gpen_disc_from_jax(variables) -> StateDict:
    """s2v_tpu GPEN Discriminator variables -> Discriminator state_dict
    (reference key layout, blur FIR buffers included)."""
    p = variables["params"]
    sd: StateDict = {}
    _gpen_convlayer(p["conv0"], "convs.0", sd, downsample=False)
    n_res = sum(1 for k in p if k.startswith("res"))
    for i in range(n_res):
        r, pre = p[f"res{i}"], f"convs.{i + 1}"
        _gpen_convlayer(r["conv1"], f"{pre}.conv1", sd, downsample=False)
        _gpen_convlayer(r["conv2"], f"{pre}.conv2", sd, downsample=True)
        _gpen_convlayer(r["skip"], f"{pre}.skip", sd, downsample=True)
    _gpen_convlayer(p["final_conv"], "final_conv", sd, downsample=False)
    _linear(p["final_linear0"], "final_linear.0", sd)
    _linear(p["final_linear1"], "final_linear.1", sd)
    return sd


def _parse_convlayer(p, s, prefix: str, sd: StateDict) -> None:
    _conv(p["conv2d"], f"{prefix}.conv2d", sd)
    if "norm" in p:
        _bn(p["norm"], s["norm"], f"{prefix}.norm.norm", sd)


def _parse_resblock(p, s, prefix: str, sd: StateDict) -> None:
    for name, tname in (("conv1", "conv1"), ("conv2", "conv2"),
                        ("shortcut", "shortcut_func")):
        if name in p:
            _parse_convlayer(p[name], s.get(name, {}), f"{prefix}.{tname}", sd)


def parsenet_from_jax(variables) -> StateDict:
    """s2v_tpu ParseNet variables -> ParseNet state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    for name in p:
        for group in ("encoder", "body", "decoder"):
            idx = name[len(group):]
            if name.startswith(group) and idx.isdigit():
                conv = _parse_convlayer if name == "encoder0" else _parse_resblock
                conv(p[name], s.get(name, {}), f"{group}.{idx}", sd)
    for name in ("out_img_conv", "out_mask_conv"):
        _parse_convlayer(p[name], s.get(name, {}), name, sd)
    return sd


def rrdbnet_from_jax(variables) -> StateDict:
    """s2v_tpu RRDBNet variables -> RRDBNet state_dict."""
    p = variables["params"]
    sd: StateDict = {}
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr",
                 "conv_last"):
        _conv(p[name], name, sd)
    n_block = sum(1 for k in p if k.startswith("body") and k[4:].isdigit())
    for i in range(n_block):
        for j in (1, 2, 3):
            for k in range(1, 6):
                _conv(p[f"body{i}"][f"rdb{j}"][f"conv{k}"], f"body.{i}.rdb{j}.conv{k}", sd)
    return sd


def s3fd_from_jax(variables) -> StateDict:
    """s2v_tpu S3FD variables -> S3FD state_dict (net_s3fd.py names)."""
    p = variables["params"]
    sd: StateDict = {}
    for name, d in p.items():
        if name.endswith("_norm"):
            sd[f"{name}.weight"] = _t(d["weight"])
        else:
            _conv(d, name, sd)
    return sd


def _fan_convblock(p, s, prefix: str, sd: StateDict) -> None:
    for i in (1, 2, 3):
        _bn(p[f"bn{i}"], s[f"bn{i}"], f"{prefix}.bn{i}", sd)
        _conv(p[f"conv{i}"], f"{prefix}.conv{i}", sd)
    if "downsample_bn" in p:
        _bn(p["downsample_bn"], s["downsample_bn"], f"{prefix}.downsample.0", sd)
        _conv(p["downsample_conv"], f"{prefix}.downsample.2", sd)


def fan_from_jax(variables) -> StateDict:
    """s2v_tpu FAN variables -> FAN state_dict (face_alignment names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for name, d in p.items():
        if name in ("conv2", "conv3", "conv4") or name.startswith("top_m_"):
            _fan_convblock(d, s[name], name, sd)
        elif name.startswith("m") and name[1:].isdigit():  # hourglasses
            for blk, bd in d.items():
                _fan_convblock(bd, s[name][blk], f"{name}.{blk}", sd)
        elif name.startswith("bn"):  # bn1, bn_end*
            _bn(d, s[name], name, sd)
        else:  # conv1, conv_last*, l*, bl*, al*
            _conv(d, name, sd)
    return sd


def _resnet(bb, bs, prefix: str, sd: StateDict) -> None:
    """s2v_tpu ResNet (``layer{stage}_{block}`` trees) -> torchvision names
    under ``prefix`` (none when empty)."""
    prefix = f"{prefix}." if prefix else ""
    _conv(bb["conv1"], f"{prefix}conv1", sd)
    _bn(bb["bn1"], bs["bn1"], f"{prefix}bn1", sd)
    for name, d in bb.items():
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_")
        pre = f"{prefix}layer{stage}.{block}"
        for i in (1, 2, 3):
            _conv(d[f"conv{i}"], f"{pre}.conv{i}", sd)
            _bn(d[f"bn{i}"], bs[name][f"bn{i}"], f"{pre}.bn{i}", sd)
        if "downsample_conv" in d:
            _conv(d["downsample_conv"], f"{pre}.downsample.0", sd)
            _bn(d["downsample_bn"], bs[name]["downsample_bn"], f"{pre}.downsample.1", sd)


def recon_from_jax(variables) -> StateDict:
    """s2v_tpu ReconNet variables -> ReconNet state_dict (the ``net_recon``
    layout: torchvision ``backbone.*`` + ``final_layers.*``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    _resnet(p["backbone"], s["backbone"], "backbone", sd)
    for name, d in p.items():
        if name.startswith("head"):
            _conv(d, f"final_layers.{name[len('head'):]}", sd)
    return sd


def resnet_depth_from_jax(variables) -> StateDict:
    """s2v_tpu ResNetDepth variables -> ResNetDepth state_dict (the
    ``depth.pth`` layout of face_detection/models.py)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    _resnet(p["backbone"], s["backbone"], "", sd)
    _linear({"weight": p["fc_weight"], "bias": p["fc_bias"]}, "fc", sd)
    return sd


def _conv_transpose(d, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(conv_transpose_weight_from_hwoi(d["weight"]))
    sd[f"{prefix}.bias"] = _t(d["bias"])


def dnet_from_jax(variables) -> StateDict:
    """s2v_tpu DNet variables -> DNet state_dict (DNet.pt's names,
    ``warpping_net`` included)."""
    p = variables["params"]
    sd: StateDict = {}
    for name, w in p["mapping_net"].items():
        if name.endswith("_weight"):
            base = name[:-len("_weight")]
            key = "mapping_net.first.0" if base == "first" else f"mapping_net.{base}.1"
            sd[f"{key}.weight"] = _t(conv1d_weight_from_kio(w))
            sd[f"{key}.bias"] = _t(p["mapping_net"][f"{base}_bias"])
    wp = p["warpping_net"]
    hg = "warpping_net.hourglass"
    for name, blk in wp["hourglass"].items():
        if name == "input_layer":
            _conv(blk, f"{hg}.encoder.input_layer", sd)
            continue
        pre = f"{hg}.{'encoder' if name.startswith('encoder') else 'decoder'}.{name}"
        for part, d in blk.items():
            if part.startswith("norm"):
                _adain(d, f"{pre}.{part}", sd)
            elif part == "conv_0" or name.startswith("encoder"):
                _conv(d, f"{pre}.{part}", sd)
            else:  # the decoder's transposed conv_1 and conv_s
                _conv_transpose(d, f"{pre}.{part}", sd)
    _ln2d(wp["flow_norm"], "warpping_net.flow_out.0", sd)
    _conv(wp["flow_conv"], "warpping_net.flow_out.2", sd)
    ed = p["editing_net"]
    for name, blk in ed["encoder"].items():
        _norm_block(blk, f"editing_net.encoder.{name}", sd)
    for name, blk in ed["decoder"].items():
        pre = f"editing_net.decoder.{name}"
        if name == "final":
            _conv(blk["conv"], f"{pre}.model.0", sd)
        elif name.startswith("res"):
            for j, res in blk.items():
                for part, d in res.items():
                    (_adain if part.startswith("norm") else _conv)(d, f"{pre}.{j}.{part}", sd)
        else:  # up*, jump*
            _norm_block(blk, pre, sd)
    return sd


def _conv_bn(p, s, prefix: str, sd: StateDict) -> None:
    """s2v_tpu ConvBN {conv, bn} -> the reference's Sequential(conv, bn, ...)."""
    _conv(p["conv"], f"{prefix}.0", sd)
    _bn(p["bn"], s["bn"], f"{prefix}.1", sd)


def retinaface_from_jax(variables) -> StateDict:
    """s2v_tpu RetinaFace variables, either body (cfg_re50's ResNet50 or
    cfg_mnet's MobileNetV1) -> RetinaFace state_dict: the inverse of
    ``convert_retinaface`` / ``convert_retinaface_mnet``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    bb, bs = p["body"], s["body"]
    if "stage1_0" in bb:
        for name, d in bb.items():
            stage, block = name[len("stage"):].split("_")
            pre = f"body.stage{stage}.{block}"
            if "conv" in d:  # the stem's conv_bn
                _conv_bn(d, bs[name], pre, sd)
                continue
            _conv(d["dw"], f"{pre}.0", sd)
            _bn(d["dw_bn"], bs[name]["dw_bn"], f"{pre}.1", sd)
            _conv(d["pw"], f"{pre}.3", sd)
            _bn(d["pw_bn"], bs[name]["pw_bn"], f"{pre}.4", sd)
    else:
        _resnet(bb, bs, "body", sd)
    for group in ("fpn", "ssh1", "ssh2", "ssh3"):
        for name, d in p[group].items():
            _conv_bn(d, s[group][name], f"{group}.{name}", sd)
    for i in range(3):
        for head in ("BboxHead", "ClassHead", "LandmarkHead"):
            _conv(p[f"{head}{i}"], f"{head}.{i}.conv1x1", sd)
    return sd


def gfpgan_clean_from_jax(variables) -> StateDict:
    """s2v_tpu GFPGANv1Clean variables -> GFPGANv1Clean state_dict (the
    reference's key names), the inverse of ``convert_gfpgan_clean``.

    s2v_tpu's converter drops two parts of the checkpoint that inference
    never runs: the U-Net's ``toRGB.{i}`` heads and the decoder's
    ``stylegan_decoder.noises.noise{i}`` buffers. They come back here as
    zeros of their reference shapes, so that the load is strict."""
    p = variables["params"]
    sd: StateDict = {}
    for name in ("conv_body_first", "final_conv"):
        _conv(p[name], name, sd)
    _linear(p["final_linear"], "final_linear", sd)
    n = sum(1 for k in p if k.startswith("conv_body_down"))
    for i in range(n):
        for part in ("down", "up"):
            for c in ("conv1", "conv2", "skip"):
                _conv(p[f"conv_body_{part}{i}"][c], f"conv_body_{part}.{i}.{c}", sd)
        for kind in ("scale", "shift"):
            for j in (0, 2):
                _conv(p[f"condition_{kind}{i}_{j}"], f"condition_{kind}.{i}.{j}", sd)
        cout = np.asarray(p[f"conv_body_up{i}"]["conv2"]["weight"]).shape[-1]
        sd[f"toRGB.{i}.weight"] = torch.zeros(3, cout, 1, 1)
        sd[f"toRGB.{i}.bias"] = torch.zeros(3)
    dec, pre = p["stylegan_decoder"], "stylegan_decoder"
    sd[f"{pre}.constant_input.weight"] = _t(
        np.transpose(np.asarray(dec["constant_input"]), (0, 3, 1, 2)))
    _styleconv_from_jax(dec["style_conv1"], f"{pre}.style_conv1", sd)
    _torgb_from_jax(dec["to_rgb1"], f"{pre}.to_rgb1", sd)
    n_mlp = sum(1 for k in dec if k.startswith("style_mlp"))
    for i in range(n_mlp):
        _linear(dec[f"style_mlp{i}"], f"{pre}.style_mlp.{2 * i + 1}", sd)
    for k in range(2 * n):
        _styleconv_from_jax(dec[f"style_convs{k}"], f"{pre}.style_convs.{k}", sd)
    for k in range(n):
        _torgb_from_jax(dec[f"to_rgbs{k}"], f"{pre}.to_rgbs.{k}", sd)
    for i in range(2 * n + 1):
        res = 2 ** ((i + 5) // 2)
        sd[f"{pre}.noises.noise{i}"] = torch.zeros(1, 1, res, res)
    return sd


def syncnet_from_jax(variables) -> StateDict:
    """s2v_tpu SyncNet variables -> wav2lip SyncNet_color's key names
    (``face_encoder.{i}`` / ``audio_encoder.{i}.conv_block.{0 conv, 1 BN}``),
    the inverse of ``convert_syncnet``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for enc, n, name in (("face_encoder", 15, "face"), ("audio_encoder", 14, "audio")):
        for i in range(n):
            blk = f"{enc}.{i}.conv_block"
            _conv(p[f"{name}{i}"]["conv"], f"{blk}.0", sd)
            _bn(p[f"{name}{i}"]["bn"], s[f"{name}{i}"]["bn"], f"{blk}.1", sd)
    return sd


def vgg16_from_jax(variables) -> StateDict:
    """s2v_tpu VGG16Features variables (``conv{N}``, N the torchvision layer
    index) -> torchvision's ``features.N.weight/bias``, the inverse of
    ``convert_vgg16_features``."""
    sd: StateDict = {}
    for name, d in variables["params"].items():
        _conv(d, f"features.{name[len('conv'):]}", sd)
    return sd


def irse_from_jax(variables) -> StateDict:
    """s2v_tpu BackboneIRSE variables -> model_ir_se50.pth's key names
    (GPEN model_irse.py Backbone), the inverse of ``convert_irse``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    _conv(p["input_conv"], "input_layer.0", sd)
    _bn(p["input_bn"], s["input_bn"], "input_layer.1", sd)
    sd["input_layer.2.weight"] = _t(p["input_prelu"]["alpha"])
    n = sum(1 for k in p if k.startswith("body"))
    for i in range(n):
        b, bs, pre = p[f"body{i}"], s[f"body{i}"], f"body.{i}"
        _bn(b["bn1"], bs["bn1"], f"{pre}.res_layer.0", sd)
        _conv(b["conv1"], f"{pre}.res_layer.1", sd)
        sd[f"{pre}.res_layer.2.weight"] = _t(b["prelu"]["alpha"])
        _conv(b["conv2"], f"{pre}.res_layer.3", sd)
        _bn(b["bn2"], bs["bn2"], f"{pre}.res_layer.4", sd)
        if "se" in b:
            _conv(b["se"]["fc1"], f"{pre}.res_layer.5.fc1", sd)
            _conv(b["se"]["fc2"], f"{pre}.res_layer.5.fc2", sd)
        if "shortcut_conv" in b:
            _conv(b["shortcut_conv"], f"{pre}.shortcut_layer.0", sd)
            _bn(b["shortcut_bn"], bs["shortcut_bn"], f"{pre}.shortcut_layer.1", sd)
    _bn(p["output_bn"], s["output_bn"], "output_layer.0", sd)
    _linear({"weight": p["linear_weight"], "bias": p["linear_bias"]}, "output_layer.3", sd)
    _bn({"weight": p["head_weight"], "bias": p["head_bias"]},
        {"running_mean": s["head_mean"], "running_var": s["head_var"]}, "output_layer.4", sd)
    return sd


def component_disc_from_jax(variables) -> StateDict:
    """s2v_tpu FacialComponentDiscriminator variables -> basicsr's key names
    (``convN.[0.kernel,] .weight``, the activation's ``.bias``;
    ``final_conv.0.weight/bias``). s2v_tpu has no converter for this
    module, so there is no round trip to hold it to."""
    p = variables["params"]
    sd: StateDict = {}
    for name, down in (("conv1", False), ("conv2", True), ("conv3", False),
                       ("conv4", True), ("conv5", False), ("final_conv", False)):
        _gpen_convlayer(p[name], name, sd, downsample=down)
    return sd


def ganimation_from_jax(variables) -> StateDict:
    """s2v_tpu SplitGenerator variables -> the reference's ``model.N`` /
    ``color_top.0`` / ``au_top.0`` keys, the inverse of
    ``convert_ganimation``."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(p["head"], "model.0", sd)
    _conv(p["down0"], "model.3", sd)
    _conv(p["down1"], "model.6", sd)
    n = sum(1 for k in p if k.startswith("res"))
    for i in range(n):
        _conv(p[f"res{i}"]["conv1"], f"model.{9 + i}.conv_block.0", sd)
        _conv(p[f"res{i}"]["conv2"], f"model.{9 + i}.conv_block.3", sd)
    _conv_transpose(p["up0"], f"model.{9 + n}", sd)
    _conv_transpose(p["up1"], f"model.{12 + n}", sd)
    _conv(p["color_top"], "color_top.0", sd)
    _conv(p["au_top"], "au_top.0", sd)
    return sd


def _bsr_styleconv(d, prefix: str, sd: StateDict, upsample: bool) -> None:
    """JAX StyledConv (isconcat=False) -> basicsr's StyleConv keys."""
    _modconv(d["conv"], f"{prefix}.modulated_conv", sd)
    if upsample:
        sd[f"{prefix}.modulated_conv.smooth.kernel"] = _t(make_kernel(BLUR_TAPS) * 4)
    sd[f"{prefix}.weight"] = _t(np.asarray(d["noise_weight"]).reshape(1))
    sd[f"{prefix}.activate.bias"] = _t(d["act_bias"])


def _bsr_torgb(d, prefix: str, sd: StateDict, upsample: bool) -> None:
    _modconv(d["conv"], f"{prefix}.modulated_conv", sd)
    sd[f"{prefix}.bias"] = _t(np.asarray(d["bias"]).reshape(1, 3, 1, 1))
    if upsample:
        sd[f"{prefix}.upsample.kernel"] = _t(make_kernel(BLUR_TAPS) * 4)


def gfpgan_v1_from_jax(variables) -> StateDict:
    """s2v_tpu GFPGANv1 (the original arch) variables -> GFPGANv1 state_dict
    with basicsr's key names, the inverse of ``convert_gfpgan_v1``. The FIR
    buffers are the fixed blur taps; the decoder's ``noises.noise{j}``,
    which the converter drops, come back as zeros of their reference
    shapes, so that the load is strict."""
    p = variables["params"]
    sd: StateDict = {}
    _gpen_convlayer(p["conv_body_first"], "conv_body_first", sd, downsample=False)
    _gpen_convlayer(p["final_conv"], "final_conv", sd, downsample=False)
    _linear(p["final_linear"], "final_linear", sd)
    n = sum(1 for k in p if k.startswith("conv_body_down"))
    for i in range(n):
        down, pre = p[f"conv_body_down{i}"], f"conv_body_down.{i}"
        _gpen_convlayer(down["conv1"], f"{pre}.conv1", sd, downsample=False)
        _gpen_convlayer(down["conv2"], f"{pre}.conv2", sd, downsample=True)
        _gpen_convlayer(down["skip"], f"{pre}.skip", sd, downsample=True)
        up, pre = p[f"conv_body_up{i}"], f"conv_body_up.{i}"
        _gpen_convlayer(up["conv1"], f"{pre}.conv1", sd, downsample=False)
        _conv(up["conv2"]["conv"], f"{pre}.conv2", sd)
        sd[f"{pre}.conv2.activation.bias"] = _t(up["conv2"]["act_bias"])
        _conv(up["skip"]["conv"], f"{pre}.skip", sd)
        for kind in ("scale", "shift"):
            for j, idx in ((0, 0), (1, 2)):
                _conv(p[f"condition_{kind}{i}_{j}"], f"condition_{kind}.{i}.{idx}", sd)
        _conv(p[f"toRGB{i}"], f"toRGB.{i}", sd)
    dec, pre = p["stylegan_decoder"], "stylegan_decoder"
    sd[f"{pre}.constant_input.weight"] = _t(
        np.transpose(np.asarray(dec["constant_input"]), (0, 3, 1, 2)))
    n_mlp = sum(1 for k in dec if k.startswith("style") and k[5:].isdigit())
    for i in range(n_mlp):
        _linear(dec[f"style{i}"], f"{pre}.style_mlp.{i + 1}", sd)
    _bsr_styleconv(dec["style_conv1"], f"{pre}.style_conv1", sd, upsample=False)
    _bsr_torgb(dec["to_rgb1"], f"{pre}.to_rgb1", sd, upsample=False)
    for k in range(2 * n):
        _bsr_styleconv(dec[f"style_convs{k}"], f"{pre}.style_convs.{k}", sd,
                       upsample=k % 2 == 0)
    for k in range(n):
        _bsr_torgb(dec[f"to_rgbs{k}"], f"{pre}.to_rgbs.{k}", sd, upsample=True)
    for j in range(2 * n + 1):
        res = 2 ** ((j + 5) // 2)
        sd[f"{pre}.noises.noise{j}"] = torch.zeros(1, 1, res, res)
    return sd


def iresnet_from_jax(variables) -> StateDict:
    """s2v_tpu IResNet variables -> arcface_torch's iresnet key names
    (``layerS.B.{bn1,conv1,bn2,prelu,conv2,bn3,downsample.0/1}``, ``fc``, the
    feature BatchNorm1d ``features``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    _conv(p["conv1"], "conv1", sd)
    _bn(p["bn1"], s["bn1"], "bn1", sd)
    sd["prelu.weight"] = _t(p["prelu"]["alpha"])
    for name in sorted((k for k in p if k.startswith("layer")),
                       key=lambda k: tuple(int(v) for v in k[5:].split("_"))):
        stage, b = name[5:].split("_")
        blk, bs, pre = p[name], s[name], f"layer{stage}.{b}"
        for bn in ("bn1", "bn2", "bn3"):
            _bn(blk[bn], bs[bn], f"{pre}.{bn}", sd)
        _conv(blk["conv1"], f"{pre}.conv1", sd)
        _conv(blk["conv2"], f"{pre}.conv2", sd)
        sd[f"{pre}.prelu.weight"] = _t(blk["prelu"]["alpha"])
        if "downsample_conv" in blk:
            _conv(blk["downsample_conv"], f"{pre}.downsample.0", sd)
            _bn(blk["downsample_bn"], bs["downsample_bn"], f"{pre}.downsample.1", sd)
    _bn(p["bn2"], s["bn2"], "bn2", sd)
    _linear(p["fc"], "fc", sd)
    _bn({"weight": p["features_weight"], "bias": p["features_bias"]},
        {"running_mean": s["features_mean"], "running_var": s["features_var"]}, "features", sd)
    return sd


def mobilefacenet_from_jax(variables) -> StateDict:
    """s2v_tpu MobileFaceNet variables -> arcface_torch's mobilefacenet key
    names (``layers.N`` blocks of ``layers`` Sequentials, ``conv_sep``, the
    GDC head ``features.layers.{0,2,3}``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}

    def block(pp, ss, pre, prelu=True):  # ConvBlock / LinearBlock
        _conv(pp["conv"], f"{pre}.layers.0", sd)
        _bn(pp["bn"], ss["bn"], f"{pre}.layers.1", sd)
        if prelu:
            sd[f"{pre}.layers.2.weight"] = _t(pp["prelu"]["alpha"])

    def depthwise(name, pre):
        for i, part in enumerate(("pw", "dw", "proj")):
            block(p[name][part], s[name][part], f"{pre}.layers.{i}", prelu=part != "proj")

    block(p["l0"], s["l0"], "layers.0")
    block(p["l1"], s["l1"], "layers.1")
    for idx, name, n in ((3, "l3", 4), (5, "l5", 6), (7, "l7", 2)):
        depthwise(f"l{idx - 1}", f"layers.{idx - 1}")
        for j in range(n):
            depthwise(f"{name}_{j}", f"layers.{idx}.layers.{j}")
    block(p["conv_sep"], s["conv_sep"], "conv_sep")
    block(p["gdc_dw"], s["gdc_dw"], "features.layers.0", prelu=False)
    _linear({"weight": p["gdc_weight"]}, "features.layers.2", sd)
    _bn({"weight": p["head_weight"], "bias": p["head_bias"]},
        {"running_mean": s["head_mean"], "running_var": s["head_var"]}, "features.layers.3", sd)
    return sd


def _wn_conv1d(d, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(conv1d_weight_from_kio(d["weight"]))
    sd[f"{prefix}.bias"] = _t(d["bias"])


def _seanet_from_jax(p, section: str, sd: StateDict, decoder: bool) -> None:
    """One SEANet half: conv_in, res{i} with down{i} (encoder) or up{i}
    (decoder), the LSTM layers, conv_out -> Meta's ``{section}.model.{i}``."""
    n = sum(1 for k in p if k.startswith("res"))
    lstm = 1 if decoder else 1 + 3 * n
    _wn_conv1d(p["conv_in"], f"{section}.model.0.conv.conv", sd)
    for i in range(n):
        res = 4 + 3 * i if decoder else 1 + 3 * i
        for name, key in (("conv1", "block.1"), ("conv2", "block.3"), ("shortcut", "shortcut")):
            _wn_conv1d(p[f"res{i}"][name], f"{section}.model.{res}.{key}.conv.conv", sd)
        if decoder:  # [k, out, in] -> ConvTranspose1d [in, out, k]
            pre = f"{section}.model.{3 + 3 * i}.convtr.convtr"
            sd[f"{pre}.weight"] = _t(np.ascontiguousarray(
                np.transpose(np.asarray(p[f"up{i}_weight"]), (2, 1, 0))))
            sd[f"{pre}.bias"] = _t(p[f"up{i}_bias"])
        else:
            _wn_conv1d(p[f"down{i}"], f"{section}.model.{3 + 3 * i}.conv.conv", sd)
    layers = sorted(k for k in p if k.startswith("lstm"))
    for l, name in enumerate(layers):
        for w in ("weight_ih", "weight_hh"):
            sd[f"{section}.model.{lstm}.lstm.{w}_l{l}"] = _t(linear_weight_from_dense(p[name][w]))
        for bias in ("bias_ih", "bias_hh"):
            sd[f"{section}.model.{lstm}.lstm.{bias}_l{l}"] = _t(p[name][bias])
    _wn_conv1d(p["conv_out"], f"{section}.model.{3 * n + 3}.conv.conv", sd)


def encodec_from_jax(variables) -> StateDict:
    """s2v_tpu EncodecModel variables (or a SEANet half's, under
    ``encoder`` / ``decoder``) -> Meta's EnCodec key names with plain conv
    weights (``s2v_torch.models.encodec``), the inverse of
    ``convert_encodec`` once weight norm is folded."""
    p = variables["params"]
    sd: StateDict = {}
    for section in ("encoder", "decoder"):
        if section in p:
            _seanet_from_jax(p[section], section, sd, decoder=section == "decoder")
    if "quantizer" in p:
        for q, cb in enumerate(np.asarray(p["quantizer"]["codebooks"])):
            sd[f"quantizer.vq.layers.{q}._codebook.embed"] = _t(cb)
    return sd
