"""Times the port's end-to-end paths in this checkout and in another one
(normally the parent commit) on one card, in turns.

A PR that redesigns kernels moves every path that runs them. This script
gives each path's time from both builds in one call on one card, so the
two can be compared. It needs one NVIDIA card and nvcc. Usage::

    mkdir -p workspace/parent
    git archive <parent commit> | tar -x -C workspace/parent
    python3 scripts/path_times.py --other workspace/parent

Each checkout is timed twice, in the order parent, this, this, parent: a
child process imports that checkout's ``peekvit_torch``, builds its
kernels into that checkout's ``build/`` and times, with CUDA events after
a warm-up:

- the ViT-B/16 ``InferenceEngine`` (bf16, seeded weights) at 1, 8 and 256
  images (ms per forward, the least of three means of 20 forwards), and at
  1 and 8 images the kernels' device time per forward (torch.profiler);
- the ViT-B/16 train step at 256 images, ``make_fused_train_step`` with
  AdamW(1e-4), split (``merged="auto"``) and merged (``merged=True``);
- the ResidualViT-B/16 fine-tune step at 256 images, ``Trainer(Adam(1e-3),
  clip_grad_norm=1.0, train_backbone=False)`` with
  configs/loss/crossentropy_mse.yaml's losses on the fused residual path;
- the int8 (w8a8, dynamic scales) ViT-B/16 engine and the int8 RankViT-B/16
  (layers 3/6/9, the exact drop at budget 0.5) at 256 images;
- the ResidualViT-B/16 engine at budget 0.5 and 256 images, exact (the
  masked layer on all 198 tokens) and with ``compact=0.5`` (the split
  masked sublayers on 107 tokens);
- the PCT engine at ModelNet40 width (1024 points, d 128, 4 heads, 4
  layers) at 128 clouds.

The parent process prints one JSON line per run and a summary line with
each path's two times per checkout and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B16 = dict(image_size=224, patch_size=16, num_layers=12, num_heads=12, hidden_dim=768,
           mlp_dim=3072, num_classes=1000)
RESIDUALVIT_B16 = dict(B16, residual_layers=["attention+mlp"] * 12, gate_temp=1,
                       add_input=False, gate_type="sigmoid", gate_threshold=0.5, gate_bias=0,
                       add_budget_token="learnable", attention_dropout=0.0, dropout=0.0)
CROSSENTROPY_MSE = {"mse": {"_target_": "peekvit.utils.losses.MSELoss", "weight": 0.01,
                            "strict": False, "budget": None, "per_layer": False,
                            "skip_layers": [0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11]}}
RANKVIT_B16 = dict(B16, rankvit_layers=[3, 6, 9])
PCT_M40 = dict(num_points=1024, num_layers=4, num_heads=4, hidden_dim=128, mlp_dim=512,
               num_classes=40)
EVAL_BATCHES = (1, 8, 256)
TRAIN_BATCH = 256
PCT_BATCH = 128


def _cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, reps: int = 5) -> float:
    """Device time per call: the kernels' time under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                for e in prof.key_averages() if e.device_type == cuda)
    return total / reps / 1e3


def _seeded(torch, build_model, name, args):
    """The model with its head and class token re-drawn at std 0.02
    (zero-initialised, they would make every logit 0)."""
    model = build_model(name, args, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in (model.head.kernel, model.class_tokens):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def child(root: str) -> dict:
    """Times every path on the checkout at ``root``: {path: ms}."""
    root = os.path.realpath(root)
    sys.path.insert(0, root)
    import torch

    import peekvit_torch
    from peekvit_torch import InferenceEngine, Trainer, build_model
    from peekvit_torch.inference import rankvit_forward_quant
    from peekvit_torch.models.adapters import live_params
    from peekvit_torch.ops.cuda import _build
    from peekvit_torch.training.fused import make_fused_train_step
    from peekvit_torch.training.optim import Adam, AdamW
    from peekvit_torch.utils.losses import LossCompose

    here = os.path.realpath(os.path.dirname(peekvit_torch.__file__))
    if not here.startswith(root + os.sep):
        raise RuntimeError(f"imported peekvit_torch from {here}, not from {root}")
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    size = B16["image_size"]

    def batch(b, classes):
        return (torch.randn(b, size, size, 3, generator=gen, device=dev),
                torch.randint(0, classes, (b,), generator=gen, device=dev))

    times = {}
    model = _seeded(torch, build_model, "vit", B16)
    engine = InferenceEngine(model, device="cuda")
    with torch.inference_mode():
        for b in EVAL_BATCHES:
            images = batch(b, 1)[0]
            # the least of three means of 20: a forward at 1 or 8 images is a
            # chain of launches, and the host's hiccups land in one mean
            times[f"vit_eval.bs{b}"] = min(_cuda_ms(torch, lambda: engine(images), 20)
                                           for _ in range(3))
            if b < 256:  # a launch chain: how much of it the card spends in kernels
                times[f"vit_eval.bs{b}.device"] = _device_ms(torch, lambda: engine(images))
        qengine = InferenceEngine(model, device="cuda", quantized=True)
        images = batch(256, 1)[0]
        times["vit_int8_eval.bs256"] = min(_cuda_ms(torch, lambda: qengine(images), 10)
                                           for _ in range(3))
        rank = InferenceEngine(_seeded(torch, build_model, "rankvit", RANKVIT_B16),
                               device="cuda", quantized=True)
        times["rankvit_int8_exact0.5.bs256"] = min(_cuda_ms(
            torch, lambda: rankvit_forward_quant(rank.params, images, budget=0.5,
                                                 **rank._forward), 10) for _ in range(3))
        residual = _seeded(torch, build_model, "residualvit", RESIDUALVIT_B16)
        for name, kw in (("exact", {}), ("compact0.5", {"compact": 0.5})):
            reng = InferenceEngine(residual, device="cuda", **kw)
            times[f"residualvit_{name}.budget0.5.bs256"] = min(
                _cuda_ms(torch, lambda: reng(images, budget=0.5), 10) for _ in range(3))
        del residual, reng
        pct = InferenceEngine(build_model("pct", PCT_M40, seed=0, device="cuda"), device="cuda")
        clouds = torch.randn(PCT_BATCH, PCT_M40["num_points"], 3, generator=gen, device=dev)
        times[f"pct_eval.bs{PCT_BATCH}"] = min(_cuda_ms(torch, lambda: pct(clouds), 10)
                                               for _ in range(3))
    del engine, qengine, rank, pct
    params = live_params(model)
    opt = AdamW(lr=1e-4).build(params)
    x, y = batch(TRAIN_BATCH, B16["num_classes"])
    for kind, merged in (("split", "auto"), ("merged", True)):
        step = make_fused_train_step(model, opt, merged=merged)
        times[f"vit_train_{kind}.bs{TRAIN_BATCH}"] = _cuda_ms(torch, lambda: step(x, y), 5)
    del model, params, opt, step
    torch.cuda.empty_cache()
    rmodel = _seeded(torch, build_model, "residualvit", RESIDUALVIT_B16)
    trainer = Trainer(rmodel, Adam(lr=1e-3), clip_grad_norm=1.0, train_backbone=False,
                      loss_compose=LossCompose(CROSSENTROPY_MSE), device="cuda")
    x, y = batch(TRAIN_BATCH, RESIDUALVIT_B16["num_classes"])
    times[f"residualvit_finetune.bs{TRAIN_BATCH}"] = _cuda_ms(
        torch, lambda: trainer.train_step(x, y), 5)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with (the parent)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    if not args.other:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    roots = {"this": REPO, "other": os.path.abspath(args.other)}
    runs = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[label]],
                              capture_output=True, text=True, cwd=roots[label], timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{label} checkout failed with exit {proc.returncode}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(times)
        print(json.dumps({"checkout": label, "ms": times, "card": smi}), flush=True)
    paths = runs["this"][0].keys()
    print(json.dumps({"ms_this": {p: [r[p] for r in runs["this"]] for p in paths},
                      "ms_other": {p: [r.get(p) for r in runs["other"]] for p in paths},
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
