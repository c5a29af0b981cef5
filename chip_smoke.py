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
6. the {"kernels": [...]} line, then the card's nvidia-smi line, then
   {"ok": true, "device": {...}} as the last line.

Imports nothing of JAX or of peekvit_tpu.
"""

from __future__ import annotations

import json
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
        kernels, per_forward_ms = [], 0.0
        for key, path, kfn, pfn, lfn, flops, nbytes in timed:
            ms = cuda_ms(torch, kfn)
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

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
