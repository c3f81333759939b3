"""DNet, the 3DMM-coefficient-driven face stabiliser (reference:
models/DNet.py, a PIRenderer-style reenactment net), NCHW.

- MappingNet (DNet.py:30-54): 1-D convs over the window of 73-d
  coefficient vectors -> descriptor (k7, then three dilated k3 convs whose
  skip is the pre-activation tensor, then the mean over the window).
- WarpingNet (DNet.py:56-90): ADAIN hourglass conditioned on the descriptor
  -> 2-channel flow at 64^2 -> deformation grid -> bilinear warp of the
  256^2 source.
- EditingNet (DNet.py:93-118): encoder over (source | warped) -> FineDecoder
  with ADAIN residual blocks -> the edited image (tanh).

Module names follow the reference (``warpping_net`` included), so DNet.pt's
``state_dict`` loads as it is.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from s2v_torch.models.layers import ADAINHourglass, FineDecoder, FineEncoder, LayerNorm2d
from s2v_torch.ops.warp import convert_flow_to_deformation, warp_image


class MappingNet(nn.Module):
    """DNet.py:30-54. Input [B, 73, window] (coefficients, frames)."""

    def __init__(self, coeff_nc: int = 73, descriptor_nc: int = 256, layer: int = 3):
        super().__init__()
        self.layer = layer
        self.first = nn.Sequential(nn.Conv1d(coeff_nc, descriptor_nc, 7))
        for i in range(layer):
            setattr(self, f"encoder{i}", nn.Sequential(
                nn.LeakyReLU(0.1), nn.Conv1d(descriptor_nc, descriptor_nc, 3, dilation=3)))

    def forward(self, coeff_window):
        out = self.first(coeff_window)
        for i in range(self.layer):
            # the skip is the PRE-activation tensor (DNet.py:52)
            out = getattr(self, f"encoder{i}")(out) + out[:, :, 3:-3]
        return out.mean(dim=2)  # AdaptiveAvgPool1d(1) -> [B, descriptor_nc]


class WarpingNet(nn.Module):
    """DNet.py:56-90."""

    def __init__(self, image_nc: int = 3, descriptor_nc: int = 256, base_nc: int = 32,
                 max_nc: int = 256, encoder_layer: int = 5, decoder_layer: int = 3):
        super().__init__()
        self.hourglass = ADAINHourglass(image_nc, descriptor_nc, base_nc, max_nc,
                                        encoder_layer, decoder_layer)
        nc = self.hourglass.output_nc
        self.flow_out = nn.Sequential(LayerNorm2d(nc), nn.LeakyReLU(0.1),
                                      nn.Conv2d(nc, 2, 7, 1, 3))

    def forward(self, image, descriptor) -> Dict[str, torch.Tensor]:
        flow = self.flow_out(self.hourglass(image, descriptor))
        deformation = convert_flow_to_deformation(flow.float())
        return {"flow_field": flow, "warp_image": warp_image(image, deformation)}


class EditingNet(nn.Module):
    """DNet.py:93-118."""

    def __init__(self, image_nc: int = 3, descriptor_nc: int = 256, layer: int = 3,
                 base_nc: int = 64, max_nc: int = 256, num_res_blocks: int = 2):
        super().__init__()
        self.encoder = FineEncoder(image_nc * 2, base_nc, max_nc, layer)
        self.decoder = FineDecoder(image_nc, descriptor_nc, base_nc, max_nc, layer,
                                   num_res_blocks)

    def forward(self, input_image, warped, descriptor):
        return self.decoder(self.encoder(torch.cat([input_image, warped], 1)), descriptor)


class DNet(nn.Module):
    """DNet.py:13-28. input_image [B, 3, 256, 256] in [-1, 1];
    driving_source [B, 73, window] coefficients. Returns a dict with
    flow_field, warp_image and (unless ``stage == "warp"``) fake_image.

    Width knobs, production defaults = the reference geometry:
    ``descriptor_nc``, ``warp_base_nc`` / ``edit_base_nc`` (stem widths of
    the hourglass and the editing net) and ``max_nc`` (channel cap).
    """

    def __init__(self, descriptor_nc: int = 256, warp_base_nc: int = 32,
                 edit_base_nc: int = 64, max_nc: int = 256):
        super().__init__()
        self.mapping_net = MappingNet(descriptor_nc=descriptor_nc)
        self.warpping_net = WarpingNet(descriptor_nc=descriptor_nc, base_nc=warp_base_nc,
                                       max_nc=max_nc)
        self.editing_net = EditingNet(descriptor_nc=descriptor_nc, base_nc=edit_base_nc,
                                      max_nc=max_nc)

    def forward(self, input_image, driving_source, stage: Optional[str] = None):
        descriptor = self.mapping_net(driving_source)
        output = self.warpping_net(input_image, descriptor)
        if stage != "warp":
            output["fake_image"] = self.editing_net(input_image, output["warp_image"],
                                                    descriptor)
        return output
