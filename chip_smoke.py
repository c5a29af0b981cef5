#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and
prints no final result):

1. device: requires a CUDA card; prints its name, count and power limit;
2. build: compiles peekvit_torch/csrc/*.cu with nvcc (one process per
   source, in parallel); prints the seconds and ptxas's register and
   shared-memory lines;
3. kernel checks: every kernel against its plain PyTorch version on the
   card at the ViT-B/16 bs256 shapes (all four GEMM epilogues, both norm
   modes), with the tolerance and its reason;
4. engine: build_model("vit", ViT-B/16) with seeded weights (head and
   class tokens randomised, else every logit is 0) serves three requests
   (8, 64, 256 images) through InferenceEngine; the launch counts are
   zeroed just before and read just after, and must be 84 per forward;
   the logits are held against the plain-version path on the card (bf16
   and fp32); then the split path (vit_forward_fused(fused_mlp=False) over
   the engine's params) serves one request;
5. timing (CUDA events, after warm-up) at bs256: images/s, FLOPs/image
   and share of the bf16 peak, and per kernel its time, its plain
   version's time, its bound and one PyTorch library call's time;
6. trainable block: attention_block_trainable (save_qkv True and False)
   against attention_block_trainable_ref on the card, the output and all
   seven gradients;
7. train: a ViT-B/16 Trainer(AdamW, clip_grad_norm=1.0) on the fused path
   takes five steps on one bs-64 batch (counts zeroed just before, read
   just after: 108 launches per step, every training kernel launched;
   losses finite and falling); one bs-16 step's gradients against the
   same step on the plain versions; one remat=True step (the recompute
   backward) against the default step, with its launch count;
8. train timing at bs256 (fwd + bwd + AdamW, CUDA events): ms per step,
   images/s, share of the bf16 peak (3 x forward FLOPs), peak memory,
   each training kernel's time, bound, plain and library time, the
   step's breakdown, and one step under torch.profiler (device time by
   kernel group, busy share);
9. the {"kernels": [...]} line, then the card's nvidia-smi line, then
   {"ok": true, "device": {...}} as the last line.

Imports nothing of JAX or of peekvit_tpu.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
B16 = dict(image_size=224, patch_size=16, num_layers=12, num_heads=12,
           hidden_dim=768, mlp_dim=3072, num_classes=1000)
BATCH = 256
REQUESTS = (8, 64, 256)
EPS = 1e-5
DEVICE = "cuda"
REPLACES = "peekvit_tpu/ops/pallas/fused_attention.py"
REPLACES_VJP = "peekvit_tpu/ops/pallas/fused_attention_vjp.py"
BLOCK_BATCH = 32       # trainable-block check
TRAIN_BATCH = 64       # the Trainer's fixed labelled batch
TRAIN_STEPS = 5
GRAD_BATCH = 16        # gradients against the plain versions
TRAIN_LR = 1e-4
GRAD_NAMES = ("dx", "dln_scale", "dln_bias", "dw_qkv", "db_qkv", "dw_out", "db_out")
# Launches per layer of one fused train step (save_qkv, the default): the
# forward's ln_rows, qkv GEMM, attention and out-proj GEMM; the backward's
# ln_rows (the emitted LN), g Wo^T, attention backward, dqkv Wqkv^T and
# the LN backward.
TRAIN_PER_LAYER = {"ln_rows": 2, "gemm_bias_epilogue.bias": 1, "attn_softmax_fwd": 1,
                   "gemm_bias_epilogue.residual": 1, "gemm_nt.none": 1,
                   "attn_softmax_bwd": 1, "gemm_nt.none_f32": 1, "ln_bwd_rows": 1}
# remat=True: the checkpointed forward, its recompute in the backward, then
# the recompute backward (which also recomputes qkv).
REMAT_PER_LAYER = {"ln_rows": 3, "gemm_bias_epilogue.bias": 3, "attn_softmax_fwd": 2,
                   "gemm_bias_epilogue.residual": 2, "gemm_nt.none": 1,
                   "attn_softmax_bwd": 1, "gemm_nt.none_f32": 1, "ln_bwd_rows": 1}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def rel_l2(torch, got: dict, want: dict) -> dict:
    """Per leaf ||got - want|| / ||want|| in fp32."""
    out = {}
    for name, w in want.items():
        w = w.float()
        out[name] = ((got[name].float() - w).norm() / w.norm().clamp_min(1e-30)).item()
    return out


def train_phases(torch, F, dev, smi, args, macs_per_image) -> dict:
    """Phases 7 and 8: a ViT-B/16 Trainer on the fused path, one step's
    gradients against the plain versions and against the remat path, and
    the bs256 step's time. Returns the main run's launch counts and the
    step time."""
    from peekvit_torch import Trainer, build_model
    from peekvit_torch.models.adapters import live_params, tree_leaves
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.training.fused import trainable_forward_fn
    from peekvit_torch.training.optim import AdamW

    layers = args["num_layers"]
    model = build_model("vit", args, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # zero-initialised head and class tokens: re-drawn as in phase 4
        model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
        model.class_tokens.copy_(torch.randn(model.class_tokens.shape, generator=cpu_gen) * 0.02)
    trainer = Trainer(model, AdamW(lr=TRAIN_LR), clip_grad_norm=1.0, device=DEVICE)
    if trainer._fused_kind() != "vit":
        raise AssertionError(f"Trainer resolved to {trainer._fused_kind()!r}, not the fused path")
    gen = torch.Generator(device=dev).manual_seed(3)
    size = args["image_size"]

    def batch(b):
        return (torch.randn(b, size, size, 3, generator=gen, device=dev),
                torch.randint(0, args["num_classes"], (b,), generator=gen, device=dev))

    x64, y64 = batch(TRAIN_BATCH)
    fa.reset_launch_counts()
    losses, per_step = [], []
    for i in range(TRAIN_STEPS):
        before = sum(fa.LAUNCHES.values())
        losses.append(trainer.train_step(x64, y64, step_idx=i)["total_loss"])
        per_step.append(sum(fa.LAUNCHES.values()) - before)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    losses = [float(v) for v in losses]
    step_launches = sum(TRAIN_PER_LAYER.values()) * layers
    emit({"phase": "train", "kind": trainer._train_kind, "batch": TRAIN_BATCH,
          "steps": TRAIN_STEPS, "optimizer": f"AdamW(lr={TRAIN_LR}), clip_grad_norm=1.0",
          "losses": losses, "launches_per_step": per_step, "counts": counts, "card": smi})
    want = {k: v * layers * TRAIN_STEPS for k, v in TRAIN_PER_LAYER.items()}
    if trainer._train_kind != "fused_vit" or per_step != [step_launches] * TRAIN_STEPS \
            or counts != want:
        raise AssertionError(f"train launches {per_step} {counts}, want {want}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")

    # One step's gradients at GRAD_BATCH: kernels, plain versions, remat.
    # Tolerance per leaf, ||kernel - plain|| / ||plain||: the two paths
    # round at the same points; flips from fp32 sums in another order
    # (2^-8 relative each) spread through 12 layers forward and back:
    # 3e-2, the repo's bf16 tolerance (tests/test_pallas.py:42).
    tol_grad = 3e-2
    params = live_params(model)
    xg, yg = batch(GRAD_BATCH)

    def grads(**kwargs):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(trainable_forward_fn(model, **kwargs)(params, xg), yg)
        loss.backward()
        return float(loss.detach()), {name: p.grad.detach().clone()
                                      for name, p in tree_leaves(params)}

    loss_k, g_k = grads()
    loss_p, g_p = grads(plain=True)
    fa.reset_launch_counts()
    loss_r, g_r = grads(remat=True)
    torch.cuda.synchronize()
    remat_counts = dict(fa.LAUNCHES)
    model.zero_grad(set_to_none=True)
    err_plain, err_remat = rel_l2(torch, g_k, g_p), rel_l2(torch, g_r, g_k)
    emit({"phase": "train_grads", "batch": GRAD_BATCH, "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_remat": loss_r, "leaves": len(g_k),
          "rel_l2_vs_plain": err_plain, "max_rel_l2_vs_plain": max(err_plain.values()),
          "rel_l2_remat_vs_default": err_remat,
          "max_rel_l2_remat_vs_default": max(err_remat.values()),
          "remat_bit_identical": all(torch.equal(g_r[k], g_k[k]) for k in g_k),
          "remat_launches": remat_counts, "remat_launches_total": sum(remat_counts.values()),
          "tolerance_rel_l2": tol_grad,
          "tolerance_reason": "same rounding points; bf16 flips from fp32 sums in another "
                              "order through 12 layers; the repo's bf16 tolerance",
          "card": smi})
    if max(err_plain.values()) > tol_grad or max(err_remat.values()) > tol_grad:
        raise AssertionError("train gradients out of tolerance")
    if remat_counts != {k: v * layers for k, v in REMAT_PER_LAYER.items()}:
        raise AssertionError(f"remat launches {remat_counts}")

    # ------------------------------------------------------------ 8. timing
    xb, yb = batch(BATCH)
    for _ in range(2):
        trainer.train_step(xb, yb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: trainer.train_step(xb, yb), iters=5)
    flops_img = 3 * 2.0 * macs_per_image  # fwd + bwd, the 3 x forward convention
    emit({"phase": "timing_train", "batch": BATCH, "ms_per_step": step_ms,
          "images_per_s": BATCH / step_ms * 1e3, "flops_per_image": flops_img,
          "achieved_tflops": flops_img * BATCH / step_ms / 1e9,
          "share_of_bf16_peak": flops_img * BATCH / (step_ms / 1e3) / PEAK_BF16_FLOPS,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches_per_step": step_launches, "card": smi})
    profile_step(torch, smi, lambda: trainer.train_step(xb, yb), step_ms)
    return {"counts": counts, "step_ms": step_ms, "layers": layers}


def _kernel_group(name: str) -> str:
    if "multi_tensor_apply" in name or "foreach" in name.lower() or "adam" in name.lower():
        return "optimizer (AdamW, clipping)"
    if name.removeprefix("void ").startswith("(anonymous namespace)::"):
        return "port CUDA kernels"  # peekvit_torch/csrc: PyTorch's own sit in at::
    if any(s in name.lower() for s in ("gemm", "xmma", "nvjet", "cutlass", "sm90_")):
        return "cuBLAS matmuls (MLP, weight grads, embed, head)"
    if "reduce" in name.lower():
        return "reductions (LN statistics, bias sums, norms)"
    return "elementwise and copies (casts, LN, gelu, bias, residual)"


def profile_step(torch, smi, step, step_ms) -> None:
    """Device time by kernel over one profiled train step (torch.profiler,
    CUPTI): the breakdown of what the kernels' event timing leaves as
    'other', and the device's busy share against the unprofiled step time.
    Where the trace holds no device time, says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # device-side events less annotation spans (the optimizer's
    # "Optimizer.step#AdamW.step" covers kernels already counted)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("Optimizer.")
               and not getattr(e, "is_user_annotation", False)]
    total_us = sum(e.self_device_time_total for e in kernels)
    groups: dict = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
    emit({"phase": "profile_train_step", "batch": BATCH,
          "device_ms": total_us / 1e3 if total_us else "not measured",
          "busy_share_of_step": total_us / 1e3 / step_ms if total_us else "not measured",
          "device_ms_by_group": groups, "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:120], "count": e.count,
                           "ms": e.self_device_time_total / 1e3} for e in top],
          "card": smi})


def train_kernel_entries(torch, F, fa, vjp, smi, checks, train, kernel_ms, x, qkv, dattn_in,
                         g_rows, dqkv_in, dln_in, attn_in, ln_s, w_qkv, w_out, b_out, d, h,
                         n, rows) -> list:
    """Phase 8 per kernel: each training kernel's time at bs256 beside its
    plain version, its bound and one library call; then the step's
    breakdown. Returns the kernels' JSON entries."""
    bf, f4 = 2, 4
    hd = d // h
    parts = -(-rows // vjp.ROWS_PER_PARTIAL)
    sdpa_in = [qkv[..., i * d:(i + 1) * d].reshape(BATCH, n, h, hd).transpose(1, 2).contiguous()
               for i in range(3)]
    sdpa_leaves = [t.detach().clone().requires_grad_() for t in sdpa_in]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_leaves)
    sdpa_dout = dattn_in.reshape(BATCH, n, h, hd).transpose(1, 2).contiguous()
    ln_leaves = [x.detach().clone().requires_grad_(), ln_s.detach().clone().requires_grad_(),
                 torch.zeros_like(ln_s, requires_grad=True)]
    ln_out = F.layer_norm(ln_leaves[0], (d,), ln_leaves[1], ln_leaves[2], EPS)
    ln_dout = g_rows.clone()
    src = "peekvit_torch/csrc/"
    both_bwd = (f"{REPLACES_VJP}:364 _trainable_bwd_saved (_attn_bwd_kernel_saved :172) "
                f"and :318 _trainable_bwd (_attn_bwd_kernel :93)")
    # name, count key, source, replaces, kernel, plain, library, flops, bytes
    timed = [
        ("attn_softmax_fwd", "attn_softmax_fwd", src + "attn_softmax_fwd.cu",
         f"{REPLACES_VJP}:261 _fwd_call (_attn_fwd_kernel :49, :65-82)",
         lambda: vjp.attn_softmax_fwd(qkv, h), lambda: vjp.attn_softmax_fwd_ref(qkv, h),
         lambda: F.scaled_dot_product_attention(*sdpa_in),
         4.0 * BATCH * h * n * n * hd, BATCH * n * (3 * d + d) * bf),
        ("attn_softmax_bwd", "attn_softmax_bwd", src + "attn_softmax_bwd.cu",
         f"{both_bwd}: per-head core :117-156 / :202-236",
         lambda: vjp.attn_softmax_bwd(qkv, dattn_in, h),
         lambda: vjp.attn_softmax_bwd_ref(qkv, dattn_in, h),
         lambda: torch.autograd.grad(sdpa_out, sdpa_leaves, sdpa_dout, retain_graph=True),
         10.0 * BATCH * h * n * n * hd, BATCH * n * (3 * d + d + 3 * d) * bf),
        ("ln_bwd_rows", "ln_bwd_rows", src + "ln_bwd_rows.cu",
         f"{both_bwd}: LN backward :158-169 / :238-245",
         lambda: vjp.ln_bwd_rows(x, dln_in, g_rows, ln_s, EPS),
         lambda: vjp.ln_bwd_rows_ref(x, dln_in, g_rows, ln_s, EPS),
         lambda: torch.autograd.grad(ln_out, ln_leaves, ln_dout, retain_graph=True),
         20.0 * rows * d, rows * d * (bf + f4 + bf + bf) + d * bf + 2 * parts * d * f4),
        ("gemm_nt.none", "gemm_nt.none", src + "gemm_bias_epilogue.cu",
         f"{both_bwd}: dattn = g Wo^T :111-115 / :196-200",
         lambda: fa.gemm_nt(g_rows, w_out, "none"), lambda: fa.gemm_nt_ref(g_rows, w_out, "none"),
         lambda: torch.matmul(g_rows, w_out.t()),
         2.0 * rows * d * d, (rows * d + d * d + rows * d) * bf),
        ("gemm_nt.none_f32", "gemm_nt.none_f32", src + "gemm_bias_epilogue.cu",
         f"{both_bwd}: dln = dqkv Wqkv^T :159-161 / :238-240",
         lambda: fa.gemm_nt(dqkv_in, w_qkv, "none_f32"),
         lambda: fa.gemm_nt_ref(dqkv_in, w_qkv, "none_f32"),
         lambda: torch.matmul(dqkv_in, w_qkv.t()).float(),
         2.0 * rows * 3 * d * d, (rows * 3 * d + 3 * d * d) * bf + rows * d * f4),
        ("gemm_bias_epilogue.residual.bf16_residual", "gemm_bias_epilogue.residual",
         src + "gemm_bias_epilogue.cu",
         f"{REPLACES_VJP}:85-87 out-proj of _attn_fwd_kernel :49 (and {REPLACES}:238 "
         "_attn_block_kernel's)",
         lambda: fa.gemm_bias_epilogue(attn_in, w_out, b_out, "residual", residual=x),
         lambda: fa.gemm_bias_epilogue_ref(attn_in, w_out, b_out, "residual", residual=x),
         lambda: (torch.addmm(b_out, attn_in, w_out) + x).to(torch.bfloat16),
         2.0 * rows * d * d, (rows * d + d * d + d) * bf + rows * d * (bf + bf)),
    ]
    entries = []
    ms_by_key = {"ln_rows": kernel_ms["ln_rows"],
                 "gemm_bias_epilogue.bias": kernel_ms["gemm_bias_epilogue.bias"]}
    for name, key, source, replaces, kfn, pfn, lfn, flops, nbytes in timed:
        with torch.inference_mode():
            ms = cuda_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=5)
        lib_ms = cuda_ms(torch, lfn)
        ms_by_key[key] = ms
        bnd, by = bound_ms(flops, nbytes)
        launches = train["counts"].get(key, 0)
        if launches == 0:
            raise AssertionError(f"{name}: never launched on the training path")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": checks[name], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                 "path": "train (fused ViT step)", "shape_batch": BATCH, "count_key": key}
        if name == "ln_bwd_rows":
            entry["max_abs_err_partials"] = checks["ln_bwd_rows.partials"]
        emit({"phase": "timing_kernel", **{k: v for k, v in entry.items() if k != "count_key"},
              "share_of_bound": bnd / ms,
              "launches_per_step": launches // TRAIN_STEPS, "card": smi})
        entries.append(entry)
    kernels_ms = sum(ms_by_key[k] * v * train["layers"] for k, v in TRAIN_PER_LAYER.items())
    emit({"phase": "timing_breakdown_train", "kernels_ms_per_step": kernels_ms,
          "kernel_ms_per_step_by_kernel": {k: ms_by_key[k] * v * train["layers"]
                                           for k, v in TRAIN_PER_LAYER.items()},
          "step_ms": train["step_ms"], "other_ms": train["step_ms"] - kernels_ms,
          "other": "eager MLP half, weight-gradient products, embed/classify, AdamW",
          "card": smi})
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from peekvit_torch import InferenceEngine, build_model
    from peekvit_torch.inference import prepare_engine_params, vit_forward_fused, vit_forward_plain
    from peekvit_torch.models.adapters import module_params
    from peekvit_torch.ops.cuda import _build
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.ops.cuda import fused_attention_vjp as vjp
    from peekvit_torch.utils.flops_count import analytic_macs

    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---------------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ----------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "card": smi,
          "kernels": info})

    # --------------------------------------------------------- 3. kernel checks
    d, m, h = B16["hidden_dim"], B16["mlp_dim"], B16["num_heads"]
    n = (B16["image_size"] // B16["patch_size"]) ** 2 + 1
    rows = BATCH * n
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)
        return (t * scale + shift).to(dtype)

    x = randn(rows, d, scale=1.5, shift=0.3)                      # layer input, bf16
    y = randn(rows, d, dtype=torch.float32, scale=1.5, shift=0.3)  # mid residual, fp32
    ln_s, ln_b = randn(d, scale=0.2, shift=1.0), randn(d, scale=0.1)
    qkv = randn(BATCH, n, 3 * d)
    gemms = {  # name -> (a, w, bias, epilogue, residual)
        "qkv": (randn(rows, d), randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1),
                "bias", None),
        "out_proj": (randn(rows, d), randn(d, d, scale=d ** -0.5), randn(d, scale=0.1),
                     "residual_f32", x),
        "fc1": (randn(rows, d), randn(d, m, scale=d ** -0.5), randn(m, scale=0.1),
                "gelu", None),
        "fc2": (randn(rows, m), randn(m, d, scale=m ** -0.5), randn(d, scale=0.1),
                "residual", y),
    }
    # Tolerances, as a fraction of max|plain|:
    # - bf16 outputs: the kernel and the plain version take their fp32 sums
    #   in different orders, so a value near a rounding boundary can round
    #   to the neighbouring bf16 value: one bf16 step is <= 2^-7 of the
    #   value; 2^-6 leaves a factor of two;
    # - the fp32 out-proj output: tensor-core fp32 accumulation against
    #   cuBLAS fp32 in another order over K = 768: 1e-3;
    # - attention: the logits are rounded to bf16 before exp2; a logit on a
    #   rounding boundary moves one key's weight by up to 2^-5 relative, on
    #   top of the bf16 output step: 2e-2.
    tol_bf16, tol_f32, tol_attn = 2.0 ** -6, 1e-3, 2e-2
    checks = {}

    def check(name, got, want, tol, reason):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        rec = {"phase": "kernel_check", "kernel": name, "shape": list(got.shape),
               "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
               "mean_abs_err": (got - want).abs().mean().item(), "max_abs_ref": scale,
               "tolerance_rel": tol, "reason": reason, "card": smi}
        emit(rec)
        if err > tol * scale:
            raise AssertionError(f"{name}: max abs err {err} > {tol} * {scale}")
        checks[name] = err

    with torch.inference_mode():
        check("norm_rows.bf16", fa.norm_rows(x, EPS, torch.bfloat16),
              fa.norm_rows_ref(x, EPS, torch.bfloat16), tol_bf16, "bf16 output rounding")
        check("norm_rows.f32", fa.norm_rows(y, EPS, torch.bfloat16),
              fa.norm_rows_ref(y, EPS, torch.bfloat16), tol_bf16, "bf16 output rounding")
        check("ln_rows", fa.ln_rows(x, ln_s, ln_b, EPS), fa.ln_rows_ref(x, ln_s, ln_b, EPS),
              tol_bf16, "bf16 output rounding")
        for gname, (a, w, b, epi, res) in gemms.items():
            tol = tol_f32 if epi == "residual_f32" else tol_bf16
            check(f"gemm_bias_epilogue.{epi}",
                  fa.gemm_bias_epilogue(a, w, b, epi, residual=res),
                  fa.gemm_bias_epilogue_ref(a, w, b, epi, residual=res), tol,
                  "fp32 sums in another order" + ("" if epi == "residual_f32"
                                                  else ", bf16 output rounding"))
        check("attn_scores_pv", fa.attn_scores_pv(qkv, h), fa.attn_scores_pv_ref(qkv, h),
              tol_attn, "bf16 rounding of logits before exp2, bf16 output rounding")

        # The training path's kernels at the same shapes. The attention
        # kernels round P (forward) and P and dZ * scale (backward) to bf16
        # where Pallas does; fp32 sums in another order can flip one of
        # those roundings (2^-8 relative), and a flipped term feeds a sum
        # over 197 keys: 2e-2, as attn_scores_pv. The LN-grad partials are
        # fp32 column sums over 50,432 rows in another order: 1e-3.
        w_qkv, b_qkv = gemms["qkv"][1], gemms["qkv"][2]
        w_out, b_out = gemms["out_proj"][1], gemms["out_proj"][2]
        g_rows = randn(rows, d, scale=0.05)               # the block output's cotangent
        dattn_in = randn(BATCH, n, d, scale=0.05)         # the attention output's cotangent
        dqkv_in = randn(rows, 3 * d, scale=0.05)
        dln_in = randn(rows, d, dtype=torch.float32, scale=0.05)
        attn_in = gemms["out_proj"][0]
        check("gemm_bias_epilogue.residual.bf16_residual",
              fa.gemm_bias_epilogue(attn_in, w_out, b_out, "residual", residual=x),
              fa.gemm_bias_epilogue_ref(attn_in, w_out, b_out, "residual", residual=x),
              tol_bf16, "fp32 sums in another order, bf16 output rounding")
        check("gemm_nt.none", fa.gemm_nt(g_rows, w_out, "none"),
              fa.gemm_nt_ref(g_rows, w_out, "none"), tol_bf16,
              "fp32 sums in another order, bf16 output rounding")
        check("gemm_nt.none_f32", fa.gemm_nt(dqkv_in, w_qkv, "none_f32"),
              fa.gemm_nt_ref(dqkv_in, w_qkv, "none_f32"), tol_f32,
              "tensor-core fp32 accumulation against cuBLAS fp32 over K = 2304")
        check("attn_softmax_fwd", vjp.attn_softmax_fwd(qkv, h), vjp.attn_softmax_fwd_ref(qkv, h),
              tol_attn, "bf16 rounding of the normalised P, bf16 output rounding")
        check("attn_softmax_bwd", vjp.attn_softmax_bwd(qkv, dattn_in, h),
              vjp.attn_softmax_bwd_ref(qkv, dattn_in, h), tol_attn,
              "bf16 rounding of P and dZ * scale, bf16 output rounding")
        dx_k, pw_k, pb_k = vjp.ln_bwd_rows(x, dln_in, g_rows, ln_s, EPS)
        dx_p, pw_p, pb_p = vjp.ln_bwd_rows_ref(x, dln_in, g_rows, ln_s, EPS)
        check("ln_bwd_rows", dx_k, dx_p, tol_bf16, "bf16 output rounding")
        check("ln_bwd_rows.partials", torch.cat([pw_k.sum(0), pb_k.sum(0)]),
              torch.cat([pw_p[0], pb_p[0]]), tol_f32,
              "fp32 column sums over 50,432 rows in another order")
        torch.cuda.synchronize()

    # ------------------------------------------------------------------ 4. engine
    # Built outside inference mode: its weights are ordinary parameters.
    model = build_model("vit", B16, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
        model.class_tokens.copy_(torch.randn(model.class_tokens.shape, generator=cpu_gen) * 0.02)
    engine = InferenceEngine(model, device=DEVICE)  # bf16 on the card
    with torch.inference_mode():
        fwd = dict(patch_size=model.patch_size, num_heads=model.num_heads,
                   num_class_tokens=model.num_class_tokens,
                   num_registers=model.num_registers, ln_eps=model.ln_eps)
        params32 = prepare_engine_params(module_params(model), torch.float32, fold_ln=True)
        img_gen = torch.Generator(device=dev).manual_seed(2)
        requests = [torch.randn(b, B16["image_size"], B16["image_size"], 3, generator=img_gen,
                                device=dev) for b in REQUESTS]

        fa.reset_launch_counts()
        outputs, per_forward = [], []
        for images in requests:
            before = sum(fa.LAUNCHES.values())
            outputs.append(engine(images))
            per_forward.append(sum(fa.LAUNCHES.values()) - before)
        torch.cuda.synchronize()
        main_counts = dict(fa.LAUNCHES)
        main_keys = ("norm_rows.bf16", "norm_rows.f32", "gemm_bias_epilogue.bias",
                     "gemm_bias_epilogue.gelu", "gemm_bias_epilogue.residual_f32",
                     "gemm_bias_epilogue.residual", "attn_scores_pv")
        emit({"phase": "engine_launches", "per_forward": per_forward, "counts": main_counts,
              "card": smi})
        want_per_layer = B16["num_layers"] * len(REQUESTS)
        if per_forward != [7 * B16["num_layers"]] * len(REQUESTS) or any(
                main_counts.get(k, 0) != want_per_layer for k in main_keys):
            raise AssertionError(f"launch counts {main_counts}, per forward {per_forward}")

        for images, got in zip(requests, outputs):
            if got.shape != (images.shape[0], B16["num_classes"]) or not torch.isfinite(got).all():
                raise AssertionError(f"engine output shape {tuple(got.shape)} or non-finite")
            plain16 = vit_forward_plain(engine.params, images, compute_dtype=torch.bfloat16, **fwd)
            plain32 = vit_forward_plain(params32, images, compute_dtype=torch.float32, **fwd)
            rec = {"phase": "engine_check", "batch": images.shape[0], "card": smi}
            for ref_name, ref, rtol, atol in (("plain_bf16", plain16, 3e-2, 3e-2),
                                              ("plain_fp32", plain32, 0.1, 0.05)):
                delta = (got - ref).abs()
                srt = ref.sort(dim=-1).values
                decided = (srt[:, -1] - srt[:, -2]) > 2 * delta.max()
                agree = got.argmax(-1) == ref.argmax(-1)
                rec[ref_name] = {
                    "max_abs_delta": delta.max().item(), "logit_spread": ref.abs().max().item(),
                    "top1_agreement": agree.float().mean().item(),
                    "decided": int(decided.sum()), "rtol": rtol, "atol": atol}
                if not torch.all(delta <= atol + rtol * ref.abs()):
                    raise AssertionError(f"engine vs {ref_name}: {rec[ref_name]}")
                if not agree[decided].all():
                    raise AssertionError(f"engine top-1 differs on a decided image: {rec}")
            rec["tolerance_reason"] = (
                "plain_bf16: same rounding points, sums in another order; the repo's bf16 "
                "kernel tolerance (tests/test_pallas.py:42). plain_fp32: bf16 activations "
                "over 12 layers; the repo's bf16 engine tolerance (tests/test_inference.py:54)")
            emit(rec)

        fa.reset_launch_counts()
        got_split = vit_forward_fused(engine.params, requests[0], fused_mlp=False,
                                      compute_dtype=torch.bfloat16, **fwd)
        torch.cuda.synchronize()
        split_counts = dict(fa.LAUNCHES)
        plain32 = vit_forward_plain(params32, requests[0], compute_dtype=torch.float32, **fwd)
        delta = (got_split - plain32).abs()
        emit({"phase": "split_path", "counts": split_counts,
              "max_abs_delta_vs_plain_fp32": delta.max().item(), "rtol": 0.1, "atol": 0.05,
              "card": smi})
        if (sum(split_counts.values()) != 4 * B16["num_layers"]
                or split_counts.get("ln_rows") != B16["num_layers"]):
            raise AssertionError(f"split path launch counts {split_counts}")
        if not torch.all(delta <= 0.05 + 0.1 * plain32.abs()):
            raise AssertionError("split path logits out of tolerance")

        # -------------------------------------------------------------- 5. timing
        images = requests[-1]
        fwd_ms = cuda_ms(torch, lambda: engine(images), iters=10)
        flops_img = 2.0 * analytic_macs(model)
        emit({"phase": "timing_engine", "batch": BATCH, "ms_per_forward": fwd_ms,
              "images_per_s": BATCH / fwd_ms * 1e3, "flops_per_image": flops_img,
              "achieved_tflops": flops_img * BATCH / fwd_ms / 1e9,
              "share_of_bf16_peak": flops_img * BATCH / (fwd_ms / 1e3) / PEAK_BF16_FLOPS,
              "card": smi})

        sdpa_q, sdpa_k, sdpa_v = (qkv[..., i * d:(i + 1) * d].reshape(BATCH, n, h, d // h)
                                  .transpose(1, 2).contiguous() for i in range(3))
        bf, f4 = 2, 4
        timed = []  # (key, path, launches, kernel fn, plain fn, library fn or None, flops, bytes)
        timed.append(("norm_rows.bf16", "main", lambda: fa.norm_rows(x, EPS, torch.bfloat16),
                      lambda: fa.norm_rows_ref(x, EPS, torch.bfloat16),
                      lambda: F.layer_norm(x, (d,), eps=EPS), 5 * rows * d, rows * d * (bf + bf)))
        timed.append(("norm_rows.f32", "main", lambda: fa.norm_rows(y, EPS, torch.bfloat16),
                      lambda: fa.norm_rows_ref(y, EPS, torch.bfloat16),
                      lambda: F.layer_norm(y, (d,), eps=EPS), 5 * rows * d, rows * d * (f4 + bf)))
        timed.append(("ln_rows", "split", lambda: fa.ln_rows(x, ln_s, ln_b, EPS),
                      lambda: fa.ln_rows_ref(x, ln_s, ln_b, EPS),
                      lambda: F.layer_norm(x, (d,), ln_s, ln_b, EPS), 8 * rows * d,
                      rows * d * (bf + bf) + 2 * d * bf))
        library = {
            "bias": lambda a, w, b, r: torch.addmm(b, a, w),
            "gelu": lambda a, w, b, r: F.gelu(torch.addmm(b, a, w), approximate="tanh"),
            "residual_f32": lambda a, w, b, r: torch.addmm(b, a, w).float() + r,
            "residual": lambda a, w, b, r: (torch.addmm(b, a, w) + r).to(torch.bfloat16),
        }
        for gname, (a, w, b, epi, res) in gemms.items():
            mm, kk = a.shape
            nn_ = w.shape[1]
            out_b = f4 if epi == "residual_f32" else bf
            res_b = 0 if res is None else res.element_size()
            timed.append((f"gemm_bias_epilogue.{epi}", "main",
                          lambda a=a, w=w, b=b, epi=epi, res=res:
                              fa.gemm_bias_epilogue(a, w, b, epi, residual=res),
                          lambda a=a, w=w, b=b, epi=epi, res=res:
                              fa.gemm_bias_epilogue_ref(a, w, b, epi, residual=res),
                          lambda a=a, w=w, b=b, res=res, f=library[epi]: f(a, w, b, res),
                          2.0 * mm * kk * nn_,
                          (mm * kk + kk * nn_ + nn_) * bf + mm * nn_ * (out_b + res_b)))
        timed.append(("attn_scores_pv", "main", lambda: fa.attn_scores_pv(qkv, h),
                      lambda: fa.attn_scores_pv_ref(qkv, h),
                      lambda: F.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v),
                      4.0 * BATCH * h * n * n * (d // h), BATCH * n * (3 * d + d) * bf))

        sources = {"norm_rows": "peekvit_torch/csrc/norm_rows.cu",
                   "ln_rows": "peekvit_torch/csrc/norm_rows.cu",
                   "gemm_bias_epilogue": "peekvit_torch/csrc/gemm_bias_epilogue.cu",
                   "attn_scores_pv": "peekvit_torch/csrc/attn_scores_pv.cu"}
        replaces = {"norm_rows": f"{REPLACES}:583 _norm_rows (in _layer_kernel :616)",
                    "ln_rows": f"{REPLACES}:253 LN of _attn_block_kernel :238",
                    "gemm_bias_epilogue": f"{REPLACES}:616 _layer_kernel matmuls "
                                          "(:680, :698, :711, :714)",
                    "attn_scores_pv": f"{REPLACES}:46 _attn_scores_pv"}
        kernels, per_forward_ms, kernel_ms = [], 0.0, {}
        for key, path, kfn, pfn, lfn, flops, nbytes in timed:
            ms = cuda_ms(torch, kfn)
            kernel_ms[key] = ms
            plain_ms = cuda_ms(torch, pfn, iters=5)
            lib_ms = cuda_ms(torch, lfn) if lfn is not None else None
            bnd, by = bound_ms(flops, nbytes)
            base = key.split(".")[0]
            launches = (main_counts if path == "main" else split_counts).get(key, 0)
            if path == "main":
                per_forward_ms += ms * B16["num_layers"]
            entry = {"name": key, "route": "cuda", "source": sources[base],
                     "replaces": replaces[base], "launches": launches,
                     "max_abs_err": checks[key], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                     "path": "main" if path == "main" else "split (fused_mlp=False)",
                     "shape_batch": BATCH}
            emit({"phase": "timing_kernel", **entry, "share_of_bound": bnd / ms,
                  "launches_per_forward": launches // (len(REQUESTS) if path == "main" else 1),
                  "card": smi})
            kernels.append(entry)
        emit({"phase": "timing_breakdown", "kernels_ms_per_forward": per_forward_ms,
              "forward_ms": fwd_ms, "other_ms": fwd_ms - per_forward_ms, "card": smi})
        missing = [k for k in main_keys if main_counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: {missing}")

    # ----------------------------------------------------- 6. trainable block
    # Tolerance, as a fraction of max|plain|: the kernels and the plain
    # versions round at the same points; fp32 sums in another order flip a
    # bf16 rounding now and then (2^-8 relative), and the flips feed the
    # backward's sums over 197 keys and the weight-gradient products over
    # 6,304 rows: 2e-2, the attention kernels' tolerance.
    tol_block = 2e-2
    xb = randn(BLOCK_BATCH, n, d, scale=1.5, shift=0.3)
    gb = randn(BLOCK_BATCH, n, d, scale=0.05)
    block_args = (xb, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out)
    for save_qkv in (True, False):
        results = []
        for fn in (vjp.attention_block_trainable, vjp.attention_block_trainable_ref):
            leaves = [t.detach().clone().requires_grad_() for t in block_args]
            out = fn(*leaves, h, EPS, save_qkv)
            out.backward(gb)
            results.append([out.detach()] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        for name, got, want in zip(("out",) + GRAD_NAMES, *results):
            check(f"block.save_qkv={save_qkv}.{name}", got, want, tol_block,
                  "bf16 roundings flipped by fp32 sums in another order, through one backward")

    # ------------------------------------------------------------------ 7. train
    train = train_phases(torch, F, dev, smi, B16, analytic_macs(model))
    entries = train_kernel_entries(torch, F, fa, vjp, smi, checks, train, kernel_ms, x, qkv,
                                   dattn_in, g_rows, dqkv_in, dln_in, attn_in, ln_s, w_qkv,
                                   w_out, b_out, d, h, n, rows)
    for entry in kernels:
        name = entry["name"]
        # The split and training paths' residual GEMM is the bf16-residual
        # variant, which has its own entry; fc2's residual is fp32.
        other_variant = name == "gemm_bias_epilogue.residual"
        entry["launches_by_path"] = {
            "engine": main_counts.get(name, 0),
            "split": 0 if other_variant else split_counts.get(name, 0),
            "train": 0 if other_variant else train["counts"].get(name, 0)}
    for entry in entries:  # none of them runs on the engine's path
        key = entry.pop("count_key")
        entry["launches_by_path"] = {"engine": 0, "split": split_counts.get(key, 0),
                                     "train": train["counts"].get(key, 0)}
    kernels += entries

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
