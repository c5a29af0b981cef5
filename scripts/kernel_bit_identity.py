"""Holds the port's older CUDA kernel modes bit for bit against the same
modes built from another checkout of the repo (normally the parent commit).

A change that adds a mode to a kernel source (a template argument, a new
operand type) must leave the modes that were there giving the same bits.
The tolerance checks in chip_smoke.py hold a kernel against its plain
version and would not catch a drift inside that tolerance; this script
does. It needs one NVIDIA card and nvcc. Usage::

    mkdir -p workspace/parent
    git archive <parent commit> | tar -x -C workspace/parent
    python3 scripts/kernel_bit_identity.py --other workspace/parent

For each checkout (this one, then --other) a child process imports that
checkout's ``peekvit_torch``, builds its kernels into that checkout's
``build/``, runs every mode below on the same seeded inputs (drawn on the
card from one seed), and prints a SHA-256 of each output's bytes and the
launch counts. The parent process prints one JSON line per mode and a
summary line, and exits 1 if any mode differs or did not launch its kernel.

A mode in REDESIGNED is one whose kernel was rewritten and may change its
bits: ``attn_softmax_bwd`` at up to 256 tokens (wgmma on TMA-fed shared
memory, P kept in registers through phase A), every mode of the GEMM
``gemm_bias_epilogue`` (its 12 epilogues, ``gemm_nt`` and ``partial_f32``
among them: wgmma on a TMA-fed ring, persistent CTAs), every mode of
``attn_scores_pv`` (plain, kweight, kmask, head dims 32 and 48: wgmma with
the head's K and V resident in shared memory; head dim 48 in three
16-column boxes a tile) and of the int8 GEMM
``gemm_s8_epilogue`` (its six epilogues: s8 wgmma on a TMA-fed ring,
persistent CTAs). All keep the earlier kernels' operations and summing
order, so their bits come out the same, and the report says so
(``bit_identical``). Such a mode is reported as ``redesigned`` and held
against the other build's output at its plain tolerance: 2e-2 of max|.|
for the attention kernels (bf16 P and dZ, bf16 outputs), 2^-6 for a bf16
GEMM's bf16 output and 1e-3 for its fp32 output and partials, 2^-7 for an
int8 GEMM's bf16 output and 2^-20 for its fp32 output (its s32 sums are
exact). Each child also times every redesigned mode at the ViT-B/16
bs256 shapes, ``attn_scores_pv.hd32`` at PCT's (128 clouds of 1024
points, d 128, 4 heads) and ``attn_scores_pv`` at head dim 48 in its
four modes at the EncDec decoder's (tag ``encdec_bs512``: 512 images of
400 tokens, d 192, 4 heads), with CUDA events (20 launches after a
warm-up), so one call gives the old and the new time on one card. The
``edges``
modes hold both kernels at the token counts and GEMM shapes where the new
kernels change their padding, chunking or tiling. The outputs of the
redesigned modes are kept under each checkout's ``build/bit_identity/``
for the comparison. ``attn_softmax_bwd.kept`` (300 tokens, the kernel
kept past 256) is not redesigned and must keep its bits.

A mode in RETIMED is timed by a third child in one process with the other
checkout's library of its kernel and with this one's, in turns (other,
this, this, other), each from a CUDA graph of 20 launches, so the
wrapper's Python between launches is not timed; those C entry points are
unchanged. ``attn_scores_pv`` is timed so at PCT's and the EncDec
decoder's shapes (the old and the new head-dim-48 kernel in one
process). ``norm_rows.cu`` in every mode and ``arpe_tokens`` were
rewritten with their bits kept and are held bit for bit like any other
mode, timed at their shapes (ViT-B/16, ResidualViT-B/16 N = 198 and 107,
A-ViT-S/16, PCT). ``attn_softmax_fwd`` and ``attn_softmax_bwd`` are timed
at the Trainer's shapes (tag ``attn_bs128``: bs128, width 256, head dim
32 at 401 tokens and head dim 64 at 402, the forward also at 768), which
take the key-tiled kernels: those routes are redesigned (``TILED_TOL``,
below). Its ``edges`` modes: every ``norm_rows.cu`` mode at widths 128,
200, 384, 768 and 1,024 (one to four chunks a lane) and 1,280 (the
one-warp-a-row kernel kept for wider rows) and 1, 7, 27,392 and 50,688
rows, masks holding zeros and fractions; ``arpe_tokens`` at 1, 33, 1,000
and 1,024 points and k from 1 to N, on clouds drawn at random, tripled
(ties at the k-th distance), piled 40 deep (more than 32 equal
distances) and of one point, bf16 tokens at d 128 and fp32 at d 256,
with the kNN threshold and count.

Modes: ``norm_rows`` (bf16 and fp32 in, masked, A-ViT), ``ln_rows``
(bf16, fp32 in, masked), ``gemm_bias_epilogue`` (epilogues 0-3 and 6-11:
bias, gelu, residual_f32, residual with an fp32 and a bf16 residual,
masked_residual_f32, masked_residual, masked_rowdot, gelu_hpre, NT
gelu_grad, partial_f32), ``gemm_nt`` (none, none_f32),
``attn_scores_pv`` (plain, kweight, kmask, head dims 32 and 48; at 48
every mode at EDGE_TOKENS_HD48 on 2 images and at HD48_BATCHED, where
each head takes one CTA),
``attn_softmax_fwd`` (packed qkv, separate q, k, v, kmask),
``attn_softmax_bwd``, ``gemm_wgrad`` (the merged backward's four
products), ``ln_bwd_rows`` (bf16 and fp32 g, masked, fp32 y),
``quant_rows`` (LN, dynamic and static, masked), ``gemm_s8_epilogue``
(its six epilogues) and ``arpe_tokens``, at ViT-B/16 bs256 shapes and at
a small ragged shape. A mode only this checkout has is reported as new
and must launch; it is held against its plain version by chip_smoke.py,
and here too where it has one: ``gemm_s8_epilogue.bias_f32`` (epilogue 6,
the int8 MoE experts' linear) at EDGE_GEMMS and BIAS_F32_GEMMS, dynamic
and static scales (``_bias_f32_modes``). The summary line counts the
modes whose bits are the other build's (``bit_identical``) and names the
others (``not_bit_identical``).

The trainable attention's route edges (``_softmax_modes``, at width 256):
``attn_softmax_fwd`` (packed and separate), ``attn_softmax_bwd`` and the
key-masked forward at head dim 64 on the routes that keep their bits (the
wgmma kernels up to 256 tokens, the kept backward from 257 to 384), bit
for bit; and on the key-tiled routes (head dim 32 at any N, head dim 64
past 256 keys forward and past 384 backward), redesigned with wgmma on a
TMA-fed ring, exp2, one reciprocal a row and the backward's online D:
each such mode (``edges/`` and ``attn_bs128/``) is held against the other
build's output within TILED_TOL and against its plain version within
NEW_PLAIN_TOL (2e-2 of max|.|: bf16 P and dZ, bf16 outputs).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# redesigned mode prefix -> tolerance against the other build, of max|.|,
# by output dtype
_GEMM_TOL = {"torch.bfloat16": 2.0 ** -6, "torch.float32": 1e-3}
REDESIGNED = {"attn_softmax_bwd": {"torch.bfloat16": 2e-2},
              "gemm_bias_epilogue": _GEMM_TOL, "gemm_nt": _GEMM_TOL,
              "attn_scores_pv": {"torch.bfloat16": 2e-2},
              "gemm_s8_epilogue": {"torch.bfloat16": 2.0 ** -7, "torch.float32": 2.0 ** -20}}
# modes under a redesigned prefix that keep their bits (the earlier backward
# kernel, past 256 tokens)
KEPT = ("attn_softmax_bwd.kept", "attn_softmax_bwd.hd64.N257", "attn_softmax_bwd.hd64.N384")
# the key-tiled kernels' routes of the trainable attention (head dim 32 at
# any N; head dim 64 past 256 keys forward and past 384 tokens backward),
# redesigned (wgmma on a TMA-fed ring, exp2 and one reciprocal a row, the
# online D): held against the other build's output and against their plain
# versions at these tolerances
TILED_TOL = {"torch.bfloat16": 2e-2}
# kernels timed with both builds' libraries in one process (their C entry
# points are unchanged): mode prefix -> source. norm_rows, ln_rows and
# arpe_tokens were rewritten with their bits kept; attn_softmax_fwd and
# attn_softmax_bwd keep their bits outside the key-tiled routes
RETIMED = {"norm_rows": "norm_rows", "ln_rows": "norm_rows", "arpe_tokens": "arpe_tokens",
           "attn_softmax_fwd": "attn_softmax_fwd", "attn_softmax_bwd": "attn_softmax_bwd",
           "attn_scores_pv": "attn_scores_pv"}
TIMED_TAGS = ("vit_b16_bs256", "pct_bs128", "residual_bs256", "avit_bs256", "attn_bs128",
              "encdec_bs512")
# the edges: attn_scores_pv at these token counts (head dim 64 and 32), the
# s8 GEMM at these (M, N, K)
EDGE_TOKENS = (1, 17, 64, 65, 148, 208, 257, 786)
# attn_scores_pv at head dim 48 (d 192 over 4 heads, the EncDec decoder's) in
# every mode, 2 images: the 16-key slice and 64-key tile edges, the decoder's
# 400 tokens, and the wgmma kernel's route edges (two CTAs an SM to 512, four
# warpgroups to 1,024, two to 1,088, the mma.sync kernel from 1,089)
EDGE_TOKENS_HD48 = (1, 17, 64, 65, 400, 401, 512, 513, 1024, 1025, 1088, 1089)
# (images, tokens) at head dim 48 where each head takes one CTA, whose
# warpgroups then take several query tiles each (the batch the card is
# filled by); the decoder's bs512, N 400 (tag "encdec_bs512") is also timed
HD48_BATCHED = ((512, 400), (132, 512), (66, 1024), (66, 1088))
EDGE_GEMMS = ((1, 8, 16), (129, 136, 144), (300, 264, 784))
# GEMM s8 bias_f32 (the int8 MoE experts' linear) at the MoE ViT's expert fc1 / fc2
# (d 256, mlp 768) on 4 images of 401 tokens, beside EDGE_GEMMS
BIAS_F32_GEMMS = ((1604, 768, 256), (1604, 256, 768))
# the row kernels (norm_rows.cu) at these widths and row counts; arpe_tokens
# at these (points, ks)
NORM_EDGE_WIDTHS = (128, 200, 384, 768, 1024, 1280)
NORM_EDGE_ROWS = (1, 7, 27392, 50688)
ARPE_EDGES = ((1, (1,)), (33, (1, 16, 33)), (1000, (1, 16, 64, 1000)), (1024, (1, 16, 64, 1024)))
# the trainable attention (attn_softmax_fwd.cu / attn_softmax_bwd.cu) at head
# dim 64 on the routes that keep their bits (the wgmma forward and backward
# up to 256, the kept backward from 257 to 384): bit for bit
SOFTMAX_KEPT_EDGES = {"fwd": (1, 17, 256), "bwd": (1, 17, 256, 257, 384),
                      "kmask": ((50, 200), (99, 198))}
# the key-tiled routes (redesigned, TILED_TOL against the other build, and
# NEW_PLAIN_TOL against their plain versions): head dim 32 at any N (128 /
# 129 the two-warpgroup CTA's edge), head dim 64 past the kept reach, the
# key-masked forward past 256 keys
SOFTMAX_TILED_EDGES = {32: (1, 17, 128, 129, 401, 785, 1024),
                       64: (257, 385, 402, 704, 768, 769, 786, 1024)}
SOFTMAX_TILED_KMASK = ((32, 201, 402), (64, 130, 260), (64, 300, 704), (64, 300, 705),
                       (64, 512, 1024))
# the key-tiled kernels at the Trainer's shapes, bs128, width 256 (tag
# "attn_bs128", timed with both builds' libraries in turns, RETIMED):
# (head dim, tokens, forward and / or backward): vit_tiny / rankvit at 160
# px, residualvit at 160 px, and the 768-key forward
SOFTMAX_TIMED = ((32, 401, ("fwd", "bwd")), (64, 402, ("fwd", "bwd")), (64, 768, ("fwd",)))
NEW_PLAIN_TOL = 2e-2
# name -> (images, tokens, width, heads, mlp width)
SHAPES = {"vit_b16_bs256": (256, 197, 768, 12, 3072), "ragged": (3, 50, 128, 2, 256)}
EPS = 1e-6


def _digest(t) -> str:
    import torch

    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def _tiled_route(name: str) -> bool:
    """Whether a trainable-attention mode ("attn_softmax_{fwd,bwd}[.sub].hd<H>.N<n>"
    or "...hd<H>.<nq>x<nk>") takes a key-tiled kernel."""
    import re

    found = re.match(r"attn_softmax_(fwd|bwd)[a-z.]*\.hd(\d+)\.(?:N(\d+)|\d+x(\d+))$", name)
    if not found:
        return False
    n = int(found.group(3) or found.group(4))
    return found.group(2) == "32" or n > (384 if found.group(1) == "bwd" else 256)


def _redesigned(mode: str):
    """The tolerances (by output dtype) of a redesigned mode ("<tag>/<name>"),
    else None."""
    name = mode.split("/", 1)[1]
    if name in KEPT:
        return None
    if _tiled_route(name):
        return TILED_TOL
    return next((tol for key, tol in REDESIGNED.items() if name.split(".")[0] == key), None)


def _graph_ms(torch, fn, iters: int = 20) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed, so the wrapper's Python between launches is not
    timed (a kernel of a few tens of microseconds is shorter than it)."""
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _retimed(mode: str):
    """The source of a rewritten mode at a timed shape, else None."""
    tag, name = mode.split("/", 1)
    return RETIMED.get(name.split(".")[0]) if tag in TIMED_TAGS else None


def _cuda_ms(torch, fn, iters: int = 20) -> float:
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(root: str) -> dict:
    """Runs every mode on the checkout at ``root``; returns
    {mode: {"sha256": [...], "launches": {...}}}, with "ms" for a
    redesigned mode at TIMED_TAG. Saves each redesigned mode's outputs
    to ``root``/build/bit_identity/."""
    root = os.path.realpath(root)
    sys.path.insert(0, root)
    import torch

    import peekvit_torch
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.ops.cuda import fused_attention_vjp as vjp
    from peekvit_torch.ops.cuda import fused_layer_vjp as lv
    from peekvit_torch.ops.cuda import pct_embed as pe
    from peekvit_torch.ops.cuda import quant_blocks as tq

    here = os.path.realpath(os.path.dirname(peekvit_torch.__file__))
    if not here.startswith(root + os.sep):
        raise RuntimeError(f"imported peekvit_torch from {here}, not from {root}")
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    out = {}
    for tag, (b, n, d, h, m) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(7)

        def randn(*shape, scale=1.0, dtype=bf16):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        rows = b * n
        x = randn(rows, d, scale=1.5)
        scale, shift = randn(d, scale=0.2) + 1, randn(d, scale=0.1)
        w1, b1 = randn(d, m, scale=0.03), randn(m, scale=0.1)
        wo, bo = randn(d, d, scale=0.03), randn(d, scale=0.1)
        bq8 = randn(3 * d, scale=0.1)
        res_f32 = randn(rows, d, dtype=torch.float32)
        res_bf16 = randn(rows, d)
        a_nt, w_nt = randn(rows, d), randn(m, d, scale=0.03)
        qkv = randn(b, n, 3 * d)
        dln, g = randn(rows, d, scale=0.05, dtype=torch.float32), randn(rows, d, scale=0.05)
        mask = (torch.rand(rows, generator=gen, device=dev) > 0.3).to(bf16)
        rowdot = randn(rows, 3, scale=0.05, dtype=torch.float32)
        w_nt2, hpre = randn(m, d, scale=0.03), randn(rows, m, dtype=torch.float32)
        q_sep, k_sep, v_sep = (randn(b, n, d) for _ in range(3))
        qkv_local = randn(b, (n + 1) // 2, 3 * d)
        kv = randn(b, n, 2 * d)
        kmask = (torch.rand(b, n, generator=gen, device=dev) > 0.4).float()
        kmask[:, 0] = 1.0
        dattn = randn(b, n, d, scale=0.05)
        qkv_kept = randn(2, 300, 3 * d)
        dattn_kept = randn(2, 300, d, scale=0.05)
        kmask16 = (torch.rand(b, n, generator=gen, device=dev) > 0.4).to(bf16)
        kmask16[:, 0] = 1
        qkv32 = randn(b, n, 3 * d)
        frac = torch.rand(rows, generator=gen, device=dev).to(bf16)
        y32 = randn(rows, d, dtype=torch.float32)
        s8 = {}
        for name, (kk, nn) in (("qkv", (d, 3 * d)), ("out", (d, d)), ("fc1", (d, m)),
                               ("fc2", (m, d))):
            wq8, sw8 = tq.quantize_linear(randn(kk, nn, scale=0.03))
            s8[name] = (tq.kernel_layout(wq8), sw8)
        pts = torch.randn(2, 256, 3, generator=gen, device=dev)
        pack = [torch.randn(*shape, generator=gen, device=dev) * 0.3
                for shape in ((3, 6), (3, 6), (6,), (6, 128), (128,))]
        # gemm_wgrad's four merged-backward products at these rows
        wgrad_in = {f"{k}x{nn}": (randn(rows, k, scale=0.5), randn(rows, nn, scale=0.05), cs)
                    for k, nn, cs in ((d, 3 * d, True), (d, d, False), (d, m, False),
                                      (m, d, True))}
        modes = {
            "ln_rows": lambda: fa.ln_rows(x, scale, shift, EPS),
            "gemm_bias_epilogue.bias": lambda: fa.gemm_bias_epilogue(x, w1, b1, "bias"),
            "gemm_bias_epilogue.gelu": lambda: fa.gemm_bias_epilogue(x, w1, b1, "gelu"),
            "gemm_bias_epilogue.residual_f32": lambda: fa.gemm_bias_epilogue(
                x, wo, bo, "residual_f32", residual=res_bf16),
            "gemm_bias_epilogue.residual": lambda: fa.gemm_bias_epilogue(
                x, wo, bo, "residual", residual=res_f32),
            "gemm_bias_epilogue.residual.bf16_residual": lambda: fa.gemm_bias_epilogue(
                x, wo, bo, "residual", residual=res_bf16),
            "gemm_bias_epilogue.masked_residual_f32": lambda: fa.gemm_bias_epilogue(
                x, wo, bo, "masked_residual_f32", residual=res_f32, mask=mask),
            "gemm_bias_epilogue.masked_residual": lambda: fa.gemm_bias_epilogue(
                x, wo, bo, "masked_residual", residual=res_bf16, mask=mask),
            "gemm_bias_epilogue.masked_rowdot": lambda: fa.gemm_masked_rowdot(x, wo, bo, g, mask),
            "gemm_bias_epilogue.gelu_hpre": lambda: fa.gemm_gelu_hpre(x, w1, b1),
            "gemm_nt.gelu_grad": lambda: fa.gemm_nt_gelu_grad(g, w_nt2, hpre),
            "gemm_nt.none": lambda: fa.gemm_nt(a_nt, w_nt, "none"),
            "gemm_nt.none_f32": lambda: fa.gemm_nt(a_nt, w_nt, "none_f32"),
            "attn_softmax_fwd": lambda: vjp.attn_softmax_fwd(qkv, h),
            "attn_softmax_fwd.separate": lambda: fa.fused_attention(q_sep, k_sep, v_sep, h),
            "ln_bwd_rows": lambda: vjp.ln_bwd_rows(x, dln, g, scale, EPS),
            "ln_bwd_rows.masked": lambda: vjp.ln_bwd_rows_masked(x, dln, g, scale, shift, mask,
                                                                 rowdot, EPS),
        }
        a_codes, a_scale = tq.quant_rows(x, None, scale, shift, EPS)
        h_codes, h_scale = tq.quant_rows(randn(rows, m, dtype=torch.float32))
        modes.update({
            "norm_rows.bf16": lambda: fa.norm_rows(x, EPS, bf16),
            "norm_rows.f32": lambda: fa.norm_rows(y32, EPS, bf16),
            "norm_rows.masked.bf16": lambda: fa.norm_rows(x, EPS, bf16, scale, shift, frac),
            "norm_rows.avit.bf16": lambda: fa.norm_rows(x, EPS, bf16, scale, shift, frac,
                                                        premask=True),
            "ln_rows.f32": lambda: fa.ln_rows(y32, scale, shift, EPS, out_dtype=bf16),
            "ln_rows.masked": lambda: fa.ln_rows(x, scale, shift, EPS, mask=frac),
            "attn_scores_pv": lambda: fa.attn_scores_pv(qkv, h),
            "attn_scores_pv.kweight": lambda: fa.attn_scores_pv(qkv, h, 0, 0.5),
            "attn_scores_pv.kmask": lambda: fa.attn_scores_pv(qkv, h, kmask=kmask16),
            "attn_scores_pv.hd32": lambda: fa.attn_scores_pv(qkv32, d // 32),
            "attn_softmax_bwd": lambda: vjp.attn_softmax_bwd(qkv, dattn, h),
            "attn_softmax_bwd.kept": lambda: vjp.attn_softmax_bwd(qkv_kept, dattn_kept, h),
            "ln_bwd_rows.g_f32": lambda: vjp.ln_bwd_rows(x, dln, y32, scale, EPS),
            "ln_bwd_rows.f32": lambda: vjp.ln_bwd_rows_f32(y32, dln, g, scale, EPS),
            "quant_rows.ln.bf16": lambda: tq.quant_rows(x, None, scale, shift, EPS),
            "quant_rows.ln.bf16.static": lambda: tq.quant_rows(x, 4.0, scale, shift, EPS),
            "quant_rows.ln.f32.masked": lambda: tq.quant_rows(y32, None, scale, shift, EPS,
                                                              mask=frac),
            "quant_rows.f32": lambda: tq.quant_rows(y32),
            "gemm_s8_epilogue.bias": lambda: tq.gemm_s8_epilogue(
                a_codes, a_scale, *s8["qkv"], bq8, "bias"),
            "gemm_s8_epilogue.residual_f32": lambda: tq.gemm_s8_epilogue(
                a_codes, a_scale, *s8["out"], bo, "residual_f32", residual=x),
            "gemm_s8_epilogue.gelu_f32": lambda: tq.gemm_s8_epilogue(
                a_codes, a_scale, *s8["fc1"], b1, "gelu_f32"),
            "gemm_s8_epilogue.residual": lambda: tq.gemm_s8_epilogue(
                h_codes, h_scale, *s8["fc2"], bo, "residual", residual=y32),
            "gemm_s8_epilogue.masked_residual_f32": lambda: tq.gemm_s8_epilogue(
                a_codes, a_scale, *s8["out"], bo, "masked_residual_f32", residual=y32,
                mask=frac),
            "gemm_s8_epilogue.masked_residual": lambda: tq.gemm_s8_epilogue(
                a_codes, a_scale, *s8["out"], bo, "masked_residual", residual=x, mask=frac),
            "arpe_tokens": lambda: pe.arpe_tokens(pts, *pack, 16, torch.bfloat16),
        })
        if hasattr(fa, "gemm_partial_f32"):  # added after the earlier modes
            modes["gemm_bias_epilogue.partial_f32"] = lambda: fa.gemm_partial_f32(x, w1)
        if hasattr(lv, "attn_softmax_fwd_kmask"):
            modes["attn_softmax_fwd.kmask"] = lambda: lv.attn_softmax_fwd_kmask(
                qkv_local[..., :d], kv[..., :d], kv[..., d:], kmask, h)
        if hasattr(lv, "gemm_wgrad"):
            for shape, (a, bb, cs) in wgrad_in.items():
                modes[f"gemm_wgrad.{shape}"] = (
                    lambda a=a, bb=bb, cs=cs: lv.gemm_wgrad(a, bb, colsum=cs)[:1 + cs])
        for name, fn in modes.items():
            fa.reset_launch_counts()
            with torch.inference_mode():
                got = fn()
            torch.cuda.synchronize()
            got = tuple(torch.as_tensor(t) for t in (got if isinstance(got, tuple) else (got,)))
            mode = f"{tag}/{name}"
            out[mode] = {"sha256": [_digest(t) for t in got], "launches": dict(fa.LAUNCHES)}
            if _redesigned(mode) is not None:
                torch.save([t.cpu() for t in got], _saved(root, mode))
                if tag in TIMED_TAGS:
                    out[mode]["ms"] = _cuda_ms(torch, fn)
    extra = _extra_modes(torch, dev, fa, tq, pe)
    softmax = {**_softmax_modes(torch, dev, fa, vjp, lv), **_bias_f32_modes(torch, dev, tq)}
    for mode, fn in {**extra, **{m: fn for m, (fn, _) in softmax.items()}}.items():
        fa.reset_launch_counts()
        with torch.inference_mode():
            got = fn()
        torch.cuda.synchronize()
        got = tuple(got if isinstance(got, tuple) else (got,))
        out[mode] = {"sha256": [_digest(t) for t in got], "launches": dict(fa.LAUNCHES)}
        ref = softmax.get(mode, (None, None))[1]
        if ref is not None:  # a shape only this build takes: its plain version is the yardstick
            with torch.inference_mode():
                want = ref()
            out[mode]["plain_rel"] = ((got[0].float() - want.float()).abs().max()
                                      / want.float().abs().max().clamp_min(1e-30)).item()
        if _redesigned(mode) is not None:
            torch.save([t.cpu() for t in got], _saved(root, mode))
            if mode.split("/")[0] in TIMED_TAGS:
                out[mode]["ms"] = _cuda_ms(torch, fn)
    return out


def child_ab(root: str, other: str) -> dict:
    """Times every rewritten mode at a timed shape (RETIMED) in one
    process, on the same inputs, with the other checkout's library of its
    kernel and with this one's in turns: other, this, this, other (20
    launches in a CUDA graph each, _graph_ms). Both builds must exist (the
    children built them). Returns {mode: {"other": [ms, ms], "this": [ms,
    ms]}}."""
    import ctypes
    import importlib.util

    root, other = os.path.realpath(root), os.path.realpath(other)
    sys.path.insert(0, root)
    import torch

    from peekvit_torch.ops.cuda import _build
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.ops.cuda import pct_embed as pe
    from peekvit_torch.ops.cuda import quant_blocks as tq

    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(other, "peekvit_torch", "ops", "cuda", "_build.py"))
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    libs = {}
    for src in sorted(set(RETIMED.values())):
        symbol, argtypes = _build._SIGNATURES[src]
        if other_build._SIGNATURES[src][0] != symbol:
            raise RuntimeError(f"{src}: the other build's entry point differs")
        fn = getattr(ctypes.CDLL(other_build._target(src)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[src] = {"this": _build.library(src), "other": fn}
    from peekvit_torch.ops.cuda import fused_attention_vjp as vjp
    from peekvit_torch.ops.cuda import fused_layer_vjp as lv

    dev = torch.device("cuda")
    modes = _extra_modes(torch, dev, fa, tq, pe)
    modes.update({m: fn for m, (fn, _) in _softmax_modes(torch, dev, fa, vjp, lv).items()})
    out = {}
    for mode, fn in modes.items():
        src = _retimed(mode)
        if src is None:
            continue
        out[mode] = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            _build._libs[src] = libs[src][which]
            out[mode][which].append(_graph_ms(torch, fn))
        _build._libs[src] = libs[src]["this"]
    return out


def _norm_modes(fa, x, y32, scale, shift, mask, eps) -> dict:
    """Every mode of norm_rows.cu on bf16 rows x and fp32 rows y32."""
    bf16 = x.dtype
    return {
        "norm_rows.bf16": lambda: fa.norm_rows(x, eps, bf16),
        "norm_rows.f32": lambda: fa.norm_rows(y32, eps, bf16),
        "norm_rows.masked.bf16": lambda: fa.norm_rows(x, eps, bf16, scale, shift, mask),
        "norm_rows.masked.f32": lambda: fa.norm_rows(y32, eps, bf16, scale, shift, mask),
        "norm_rows.avit.bf16": lambda: fa.norm_rows(x, eps, bf16, scale, shift, mask,
                                                    premask=True),
        "norm_rows.avit.f32": lambda: fa.norm_rows(y32, eps, bf16, scale, shift, mask,
                                                   premask=True),
        "ln_rows": lambda: fa.ln_rows(x, scale, shift, eps),
        "ln_rows.f32": lambda: fa.ln_rows(y32, scale, shift, eps, out_dtype=bf16),
        "ln_rows.masked": lambda: fa.ln_rows(x, scale, shift, eps, mask=mask),
    }


def _arpe_clouds(torch, gen, n: int, dev):
    """Five clouds of n points: two normal draws (one scaled), each point
    tripled (ties at the k-th distance), each point 40 times (more than
    32 equal distances) and one point n times (every distance 0)."""
    base = torch.randn(5, n, 3, generator=gen, device=dev)
    base[1] *= 7.0
    base[2] = base[2, :(n + 2) // 3].repeat_interleave(3, dim=0)[:n]
    base[3] = base[3, :(n + 39) // 40].repeat_interleave(40, dim=0)[:n]
    base[4] = base[4, 0].clone().expand(n, 3)
    return base.contiguous()


def _extra_modes(torch, dev, fa, tq, pe) -> dict:
    """attn_scores_pv.hd32, arpe_tokens and norm_rows at PCT's shape, the
    masked row norms at ResidualViT-B/16's (N = 198 and, split, 107) and
    norm_rows.avit at A-ViT-S/16's (all timed), and the edges: of the two
    redesigned kernels, attn_scores_pv in its four modes at EDGE_TOKENS
    and the s8 GEMM's six epilogues at EDGE_GEMMS; of the two rewritten
    with their bits kept, every norm_rows.cu mode at NORM_EDGE_WIDTHS x
    NORM_EDGE_ROWS (masks with zeros) and arpe_tokens at ARPE_EDGES on
    _arpe_clouds, bf16 tokens at d 128 and fp32 at d 256, with knn_stats."""
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def row_mask(rows):  # zeros, and fractions in (0, 1)
        keep = torch.rand(rows, generator=gen, device=dev) > 0.3
        return (keep * torch.rand(rows, generator=gen, device=dev)).to(bf16)

    qkv_pct = randn(128, 1024, 3 * 128)
    modes = {"pct_bs128/attn_scores_pv.hd32": lambda: fa.attn_scores_pv(qkv_pct, 4)}
    pct_pts = torch.randn(128, 1024, 3, generator=gen, device=dev)
    pct_pack = [torch.randn(*shape, generator=gen, device=dev) * 0.3
                for shape in ((3, 6), (3, 6), (6,), (6, 128), (128,))]
    modes["pct_bs128/arpe_tokens"] = lambda: pe.arpe_tokens(pct_pts, *pct_pack, 64, bf16)
    modes["pct_bs128/arpe_tokens.knn_stats"] = lambda: pe.arpe_tokens(
        pct_pts, *pct_pack, 64, bf16, knn_stats=True)
    # (tag, rows, width, the modes timed there)
    vit_names = ("norm_rows.bf16", "norm_rows.f32", "norm_rows.masked.bf16",
                 "norm_rows.masked.f32", "norm_rows.avit.bf16", "norm_rows.avit.f32", "ln_rows",
                 "ln_rows.f32", "ln_rows.masked")
    for tag, rows, d, names in (
            ("vit_b16_bs256", 256 * 197, 768, vit_names),
            ("pct_bs128", 128 * 1024, 128, ("norm_rows.bf16", "norm_rows.f32")),
            ("residual_bs256", 256 * 198, 768, ("norm_rows.masked.bf16", "norm_rows.masked.f32")),
            ("residual_bs256", 256 * 107, 768, ("ln_rows.masked",)),
            ("avit_bs256", 256 * 197, 384, ("norm_rows.avit.bf16", "norm_rows.avit.f32"))):
        x, y32 = randn(rows, d, scale=1.5), randn(rows, d, dtype=torch.float32)
        scale, shift = randn(d, scale=0.2) + 1, randn(d, scale=0.1)
        every = _norm_modes(fa, x, y32, scale, shift, row_mask(rows), EPS)
        for name in names:
            modes[f"{tag}/{name}.rows{rows}"] = every[name]
    for d in NORM_EDGE_WIDTHS:
        scale, shift = randn(d, scale=0.2) + 1, randn(d, scale=0.1)
        for rows in NORM_EDGE_ROWS:
            x, y32 = randn(rows, d, scale=1.5), randn(rows, d, dtype=torch.float32)
            for name, fn in _norm_modes(fa, x, y32, scale, shift, row_mask(rows), EPS).items():
                modes[f"edges/{name}.d{d}.rows{rows}"] = fn
    for n, ks in ARPE_EDGES:
        pts = _arpe_clouds(torch, gen, n, dev)
        for d, out_dtype in ((128, bf16), (256, torch.float32)):
            pack = [torch.randn(*shape, generator=gen, device=dev) * 0.3
                    for shape in ((3, 6), (3, 6), (6,), (6, d), (d,))]
            for k in ks:
                modes[f"edges/arpe_tokens.n{n}.k{k}.d{d}"] = (
                    lambda pts=pts, pack=pack, k=k, dt=out_dtype:
                    pe.arpe_tokens(pts, *pack, k, dt, knn_stats=True))
    for n in EDGE_TOKENS:
        qkv, qkv32 = randn(2, n, 3 * 128), randn(2, n, 3 * 128)
        km = (torch.rand(2, n, generator=gen, device=dev) > 0.4).to(bf16)
        km[:, 0] = 1
        bad = km == 0  # excluded keys' k and v poisoned
        qkv_km = qkv.clone()
        qkv_km[..., 128:][bad] = float("nan")
        modes.update({
            f"edges/attn_scores_pv.N{n}": lambda q=qkv: fa.attn_scores_pv(q, 2),
            f"edges/attn_scores_pv.kweight.N{n}": lambda q=qkv, n=n: fa.attn_scores_pv(
                q, 2, n - 1, 45.0),
            f"edges/attn_scores_pv.kmask.N{n}": lambda q=qkv_km, k=km: fa.attn_scores_pv(
                q, 2, kmask=k),
            f"edges/attn_scores_pv.hd32.N{n}": lambda q=qkv32: fa.attn_scores_pv(q, 4),
        })
    for m, n, k in EDGE_GEMMS:
        wq, sw = tq.quantize_linear(randn(k, n, scale=0.03))
        w8 = tq.kernel_layout(wq)
        codes, scale = tq.quant_rows(randn(m, k))
        bias, frac = randn(n, scale=0.1), torch.rand(m, generator=gen, device=dev).to(bf16)
        r32, r16 = randn(m, n, dtype=torch.float32), randn(m, n)
        for epi, res, mask in (("bias", None, None), ("gelu_f32", None, None),
                               ("residual_f32", r16, None), ("residual", r32, None),
                               ("masked_residual_f32", r32, frac), ("masked_residual", r16, frac)):
            modes[f"edges/gemm_s8_epilogue.{epi}.{m}x{n}x{k}"] = (
                lambda e=epi, r=res, mk=mask, c=codes, s=scale, w=w8, sw=sw, b=bias:
                tq.gemm_s8_epilogue(c, s, w, sw, b, e, residual=r, mask=mk))
        modes[f"edges/gemm_s8_epilogue.bias.static.{m}x{n}x{k}"] = (
            lambda c=codes, w=w8, sw=sw, b=bias: tq.gemm_s8_epilogue(c, 0.02, w, sw, b, "bias"))
    if 48 in fa.HEAD_DIMS:  # head dim 48, from its own seed
        gen48 = torch.Generator(device=dev).manual_seed(48)
        shapes = [(2, n, "edges", "") for n in EDGE_TOKENS_HD48] + [
            (b, n, "encdec_bs512" if b == 512 else "edges", "" if b == 512 else f".b{b}")
            for b, n in HD48_BATCHED]
        for b, n, tag, suffix in shapes:
            q48 = torch.randn(b, n, 3 * 192, generator=gen48, device=dev).to(bf16)
            km = (torch.rand(b, n, generator=gen48, device=dev) > 0.4).to(bf16)
            km[:, 0] = 1
            q48_km = q48.clone()
            q48_km[..., 192:][km == 0] = float("nan")  # excluded keys' k and v poisoned
            at = f".hd48.N{n}{suffix}"
            modes[f"{tag}/attn_scores_pv{at}"] = lambda q=q48: fa.attn_scores_pv(q, 4)
            for mult in ((45.0,) if n == 1 else (0.0, 45.0)):  # mult 0 alone: 0 / 0
                modes[f"{tag}/attn_scores_pv.kweight{mult:g}{at}"] = (
                    lambda q=q48, n=n, m=mult: fa.attn_scores_pv(q, 4, n - 1, m))
            modes[f"{tag}/attn_scores_pv.kmask{at}"] = (
                lambda q=q48_km, k=km: fa.attn_scores_pv(q, 4, kmask=k))
    return modes


def _bias_f32_modes(torch, dev, tq) -> dict:
    """GEMM s8 ``bias_f32`` (epilogue 6, the int8 MoE experts' linear),
    where this build has it, at EDGE_GEMMS and at BIAS_F32_GEMMS, dynamic
    and static scales, with its plain version. {mode: (fn, plain fn)}."""
    if "bias_f32" not in getattr(tq, "_EPILOGUES", {}):
        return {}
    gen = torch.Generator(device=dev).manual_seed(6)
    modes = {}
    for m, n, k in EDGE_GEMMS + BIAS_F32_GEMMS:
        wq, sw = tq.quantize_linear(torch.randn(k, n, generator=gen, device=dev) * k ** -0.5)
        w8 = tq.kernel_layout(wq)
        codes, scale = tq.quant_rows(torch.randn(m, k, generator=gen, device=dev).to(
            torch.bfloat16))
        bias = (torch.randn(n, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        for label, sa in (("", scale), (".static", 0.02)):
            modes[f"edges/gemm_s8_epilogue.bias_f32{label}.{m}x{n}x{k}"] = (
                lambda c=codes, s=sa, w=w8, sw=sw, b=bias:
                    tq.gemm_s8_epilogue(c, s, w, sw, b, "bias_f32"),
                lambda c=codes, s=sa, w=w8, sw=sw, b=bias:
                    tq.gemm_s8_epilogue_ref(c, s, w, sw, b, "bias_f32"))
    return modes


def _softmax_modes(torch, dev, fa, vjp, lv) -> dict:
    """The trainable attention at its route edges, 2 images at width 256:
    attn_softmax_fwd (packed, separate), attn_softmax_bwd and the masked
    mode at SOFTMAX_KEPT_EDGES (head dim 64, 4 heads; both builds), the
    packed forward at SOFTMAX_TIMED_TOKENS (128 images; both builds), and,
    where this build has the key-tiled kernels (``fa.softmax_route``), at
    SOFTMAX_TILED_EDGES and SOFTMAX_TILED_KMASK with each mode's plain
    version. {mode: (fn, plain fn or None)}."""
    gen = torch.Generator(device=dev).manual_seed(13)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf16)

    def kmask_for(nk):
        km = (torch.rand(2, nk, generator=gen, device=dev) > 0.5).float()
        km[:, 0] = 1.0
        km[1, :min(64, nk - 1)] = 0.0  # a whole key tile excluded
        km[1, nk - 1] = 1.0
        return km

    modes = {}

    def attn_modes(hd, n, which, plain):
        heads = 256 // hd
        qkv, da = randn(2, n, 768), randn(2, n, 256, scale=0.05)
        q, k, v = (qkv[..., i * 256:(i + 1) * 256].contiguous() for i in range(3))
        tag = f"edges/attn_softmax_{{}}.hd{hd}.N{n}"
        if "fwd" in which:
            modes[tag.format("fwd")] = (lambda: vjp.attn_softmax_fwd(qkv, heads),
                                        (lambda: vjp.attn_softmax_fwd_ref(qkv, heads))
                                        if plain else None)
            modes[tag.format("fwd.separate")] = (
                lambda: fa.fused_attention(q, k, v, heads),
                (lambda: fa.fused_attention_ref(q, k, v, heads)) if plain else None)
        if "bwd" in which:
            modes[tag.format("bwd")] = (lambda: vjp.attn_softmax_bwd(qkv, da, heads),
                                        (lambda: vjp.attn_softmax_bwd_ref(qkv, da, heads))
                                        if plain else None)

    def kmask_mode(hd, nq, nk, plain):
        heads = 256 // hd
        q, kv, km = randn(2, nq, 768)[..., :256], randn(2, nk, 512), kmask_for(nk)
        modes[f"edges/attn_softmax_fwd.kmask.hd{hd}.{nq}x{nk}"] = (
            lambda: lv.attn_softmax_fwd_kmask(q, kv[..., :256], kv[..., 256:], km, heads),
            (lambda: lv.attn_softmax_fwd_kmask_ref(q, kv[..., :256], kv[..., 256:], km, heads))
            if plain else None)

    for n in sorted(set(SOFTMAX_KEPT_EDGES["fwd"]) | set(SOFTMAX_KEPT_EDGES["bwd"])):
        which = [w for w in ("fwd", "bwd") if n in SOFTMAX_KEPT_EDGES[w]]
        attn_modes(64, n, which, plain=False)
    for nq, nk in SOFTMAX_KEPT_EDGES["kmask"]:
        kmask_mode(64, nq, nk, plain=False)
    for hd, n, which in SOFTMAX_TIMED:
        heads = 256 // hd
        qkv_t, da_t = randn(128, n, 768), randn(128, n, 256, scale=0.05)
        if "fwd" in which:
            modes[f"attn_bs128/attn_softmax_fwd.hd{hd}.N{n}"] = (
                lambda qkv_t=qkv_t, h=heads: vjp.attn_softmax_fwd(qkv_t, h),
                lambda qkv_t=qkv_t, h=heads: vjp.attn_softmax_fwd_ref(qkv_t, h))
        if "bwd" in which:
            modes[f"attn_bs128/attn_softmax_bwd.hd{hd}.N{n}"] = (
                lambda qkv_t=qkv_t, da_t=da_t, h=heads: vjp.attn_softmax_bwd(qkv_t, da_t, h),
                lambda qkv_t=qkv_t, da_t=da_t, h=heads: vjp.attn_softmax_bwd_ref(qkv_t, da_t, h))
    if hasattr(fa, "softmax_route"):  # a build with the key-tiled kernels
        for hd, tokens in SOFTMAX_TILED_EDGES.items():
            for n in tokens:
                which = [w for w in ("fwd", "bwd")
                         if fa.softmax_route(hd, n, backward=w == "bwd") == "tiled"]
                attn_modes(hd, n, which, plain=True)
        for hd, nq, nk in SOFTMAX_TILED_KMASK:
            kmask_mode(hd, nq, nk, plain=True)
    return modes


def _saved(root: str, mode: str) -> str:
    folder = os.path.join(root, "build", "bit_identity")
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, mode.replace("/", "__") + ".pt")


def _against_other(mode: str, roots: dict, tol: float) -> dict:
    """A redesigned mode's outputs against the other build's: the largest
    difference over max|other| of each output."""
    import torch

    this, other = (torch.load(_saved(roots[k], mode)) for k in ("this", "other"))
    rel, tols = [], []
    for a, b in zip(this, other):
        tols.append(tol[str(a.dtype)])
        a, b = a.float(), b.float()
        rel.append(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   if b.numel() and a.shape == b.shape else float("inf"))
    return {"max_rel_diff": rel, "tolerance_rel": tols,
            "within": len(this) == len(other) and all(r <= t for r, t in zip(rel, tols))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with (the parent)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--ab", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    if args.ab:
        print(json.dumps(child_ab(args.ab, args.other)))
        return 0
    if not args.other:
        ap.error("--other is required")
    runs = {}
    roots = {"this": REPO, "other": os.path.abspath(args.other)}
    for label, root in roots.items():
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{label} checkout ({root}) failed with exit {proc.returncode}")
        runs[label] = json.loads(proc.stdout.strip().splitlines()[-1])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab", REPO, "--other",
                           roots["other"]], capture_output=True, text=True, cwd=REPO, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        raise SystemExit(f"the old-against-new timing failed with exit {proc.returncode}")
    ab = json.loads(proc.stdout.strip().splitlines()[-1])
    failed, new = [], []
    for mode, this in runs["this"].items():
        other = runs["other"].get(mode)
        if other is None:  # a mode this checkout adds: nothing to compare with
            new.append(mode)
            plain = this.get("plain_rel")
            print(json.dumps({"mode": mode, "new_in_this": True, "launches": this["launches"],
                              "max_rel_diff_vs_plain": plain, "tolerance_rel": NEW_PLAIN_TOL}))
            if not sum(this["launches"].values()) or (plain is not None
                                                        and not plain <= NEW_PLAIN_TOL):
                failed.append(mode)
            continue
        same = this["sha256"] == other["sha256"]
        launched = sum(this["launches"].values()) > 0 and sum(other["launches"].values()) > 0
        turns = {}
        if mode in ab:  # the mean of the two turns of each build
            turns = {"graph_ms": sum(ab[mode]["this"]) / 2,
                     "other_graph_ms": sum(ab[mode]["other"]) / 2, "turns_ms": ab[mode]}
        tol = _redesigned(mode)
        if tol is not None:  # meant to change its bits: held at the plain tolerance
            held = _against_other(mode, roots, tol)
            plain = this.get("plain_rel")
            print(json.dumps({"mode": mode, "redesigned": True, "bit_identical": same, **held,
                              "max_rel_diff_vs_plain": plain, "ms": this.get("ms"),
                              "other_ms": other.get("ms"), **turns,
                              "launches": this["launches"],
                              "other_launches": other["launches"]}))
            if not (held["within"] and launched and (plain is None or plain <= NEW_PLAIN_TOL)):
                failed.append(mode)
            continue
        times = {}
        if turns:
            times = {"ms": turns["graph_ms"], "other_ms": turns["other_graph_ms"],
                     "turns_ms": ab[mode]}
        print(json.dumps({"mode": mode, "bit_identical": same, "outputs": len(this["sha256"]),
                          **times, "launches": this["launches"],
                          "other_launches": other["launches"]}))
        if not (same and launched):
            failed.append(mode)
    missing = sorted(set(runs["other"]) - set(runs["this"]))
    redesigned = [m for m in runs["this"] if m not in new and _redesigned(m) is not None]
    differ = [m for m in runs["this"] if m not in new
              and runs["this"][m]["sha256"] != runs["other"][m]["sha256"]]
    print(json.dumps({"modes": len(runs["this"]) - len(new), "redesigned": redesigned,
                      "bit_identical": len(runs["this"]) - len(new) - len(differ),
                      "not_bit_identical": differ, "new_in_this": new,
                      "missing_in_this": missing, "differ_or_not_launched": failed}))
    failed += missing
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
