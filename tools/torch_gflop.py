"""GFLOP a frame of the port's mouth-tail models at their production
widths, counted by ``torch.utils.flop_counter.FlopCounterMode`` (every conv
and matmul, a multiply-add as 2) on the meta device: no weights, no card.

    python tools/torch_gflop.py

Prints one JSON object: GFPGANv1Clean(512) on a 512^2 crop, ParseNet on a
512^2 crop, RetinaFace-R50 on a 512^2 frame, each with its parameter count.
"""

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from s2v_torch.models.gfpgan import GFPGANv1Clean  # noqa: E402
from s2v_torch.models.parsenet import ParseNet  # noqa: E402
from s2v_torch.models.retinaface import RetinaFace  # noqa: E402


def gflop(model, shape):
    model = model.to("meta").eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.empty(shape, device="meta"))
    return counter.get_total_flops() / 1e9


def main():
    out = {}
    for name, model, shape in (("gfpgan_clean_512", GFPGANv1Clean(), (1, 3, 512, 512)),
                               ("parsenet_512", ParseNet(), (1, 3, 512, 512)),
                               ("retinaface_r50_512", RetinaFace(), (1, 3, 512, 512))):
        params = sum(p.numel() for p in model.parameters())
        out[name] = dict(gflop_per_frame=round(gflop(model, shape), 2),
                         params_m=round(params / 1e6, 2))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
