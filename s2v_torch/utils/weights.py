"""Weights for the port's modules.

- ``load_reference(module, state_dict)``: load a reference torch checkpoint
  as it is. Spectral-normalised convs (LNet's blocks) arrive as
  ``weight_orig`` / ``weight_u`` / ``weight_v``; they fold into
  ``weight = weight_orig / sigma``, sigma = u . (W v), as torch computes in
  eval mode.
- ``*_from_jax(variables)``: s2v_tpu's flax variable trees (numpy leaves)
  -> the port module's ``state_dict``, the inverse of s2v_tpu's
  ``convert_*`` (conv HWIO -> OIHW, dense [in, out] -> [out, in],
  LayerNorm2d (C,) -> (C, 1, 1), modulated conv HWIO -> (1, O, I, k, k)).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.models.gpen import BLUR_TAPS, make_kernel
from s2v_torch.ops.convs import conv_weight_from_hwio, linear_weight_from_dense

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


def load_reference(module: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a reference checkpoint's state_dict (strict), folding spectral
    norm first."""
    module.load_state_dict(fold_spectral_norm(sd))
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
        sc = p[f"style_conv{k}"]
        _modconv(sc["modulated_conv"], f"style_convs.{k}.modulated_conv", sd)
        sd[f"style_convs.{k}.weight"] = _t(sc["noise_weight"])
        sd[f"style_convs.{k}.bias"] = _t(np.asarray(sc["bias"]).reshape(1, -1, 1, 1))
    for k in range(2):
        rgb = p[f"to_rgb{k}"]
        _modconv(rgb["modulated_conv"], f"to_rgbs.{k}.modulated_conv", sd)
        sd[f"to_rgbs.{k}.bias"] = _t(np.asarray(rgb["bias"]).reshape(1, 3, 1, 1))
    low = {"params": p["low_res"],
           "batch_stats": variables.get("batch_stats", {}).get("low_res", {})}
    sd.update(lnet_from_jax(low, prefix="low_res."))
    return sd


def _gpen_styledconv(d, prefix: str, sd: StateDict) -> None:
    _modconv(d["conv"], f"{prefix}.conv", sd)
    sd[f"{prefix}.noise.weight"] = _t(d["noise_weight"])
    sd[f"{prefix}.activate.bias"] = _t(d["act_bias"])


def gpen_from_jax(variables) -> StateDict:
    """s2v_tpu FullGenerator variables -> FullGenerator state_dict,
    including the blur FIR buffers the reference registers."""
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

