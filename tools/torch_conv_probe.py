"""Device ms a frame of the mouth tail's two f32 networks on the card under
the cuDNN settings that could speed them up, at the chain's shapes (7
frames at 512^2), random weights from a fixed seed:

- RetinaFace-R50 in full f32: the 7 frames as one batch (as the tail runs
  it), in 7 batches of 1 (as the final stage runs its 1024^2 pass), and as
  one batch with ``cudnn.benchmark`` (cuDNN times its algorithms first);
- ParseNet in full f32 (as the tail runs it), with TF32 allowed, and under
  bf16 autocast (as the enhancers run it).

    python tools/torch_conv_probe.py

Times are CUDA events around 5 calls after 2 warm-up calls (which also let
``cudnn.benchmark`` choose). Prints the card's name and power limit, then
one JSON object. Needs a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from s2v_torch.device import full_f32  # noqa: E402
from s2v_torch.models.parsenet import ParseNet  # noqa: E402
from s2v_torch.models.retinaface import RetinaFace  # noqa: E402


def device_ms(fn, iters=5, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        print("torch_conv_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    torch.manual_seed(0)
    retina, parse = RetinaFace().cuda().eval(), ParseNet().cuda().eval()
    x = torch.rand(7, 3, 512, 512, device="cuda") * 255 - 110
    y = torch.rand(7, 3, 512, 512, device="cuda") * 2 - 1
    n = len(x)
    res = {}
    with torch.no_grad():
        with full_f32():
            res["retinaface_batch7"] = device_ms(lambda: retina(x)) / n
            res["retinaface_7x1"] = device_ms(lambda: [retina(x[i:i + 1]) for i in range(n)]) / n
            torch.backends.cudnn.benchmark = True
            res["retinaface_batch7_benchmark"] = device_ms(lambda: retina(x)) / n
            torch.backends.cudnn.benchmark = False
            res["parsenet_f32"] = device_ms(lambda: parse(y)) / n
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        res["parsenet_tf32"] = device_ms(lambda: parse(y)) / n
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.autocast("cuda", dtype=torch.bfloat16):
            res["parsenet_bf16"] = device_ms(lambda: parse(y)) / n
    print(json.dumps({"ms_per_frame": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
