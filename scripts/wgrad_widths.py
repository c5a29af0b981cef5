"""Times gemm_wgrad at both C tile widths (128 and 256 columns) on the
merged ViT-B/16 backward's four weight-gradient products at bs256
(R = 50,432 rows), beside the width ``wgrad_plan`` picks, on one NVIDIA
card. It is the measurement behind that choice. Usage::

    python3 scripts/wgrad_widths.py

Each product is timed with CUDA events (20 launches after a warm-up) at
widths 128, 256, 256, 128 in turns; prints one JSON line per product
(the ms of each run, the plan's width, each width's units and splits) and
one with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 256 * 197
PRODUCTS = {"dwqkv": (768, 2304, True), "dwo": (768, 768, False), "dw1": (768, 3072, False),
            "dw2": (3072, 768, True)}


def cuda_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgrad_widths: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from peekvit_torch.ops.cuda import fused_layer_vjp as lv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (k, n, colsum) in PRODUCTS.items():
        a = (torch.randn(ROWS, k, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        b = (torch.randn(ROWS, n, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        runs = {128: [], 256: []}
        with torch.inference_mode():
            for bn in (128, 256, 256, 128):
                runs[bn].append(cuda_ms(torch, lambda: lv._gemm_wgrad(a, b, colsum, bn)))
        plans = {bn: lv.wgrad_plan(ROWS, k, n, bn) for bn in runs}
        print(json.dumps({"product": name, "k": k, "n": n, "colsum": colsum, "ms": runs,
                          "plan_bn": lv.wgrad_plan(ROWS, k, n).bn,
                          "units": {bn: len(p.units) for bn, p in plans.items()},
                          "splits": {bn: p.splits for bn, p in plans.items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
