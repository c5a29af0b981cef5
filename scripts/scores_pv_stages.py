"""Which stage of the attention kernel (``csrc/attn_scores_pv.cu``) sets its
pace: the kernel built whole and with one stage taken out, timed in turns
on the same inputs beside SDPA. It needs one NVIDIA card and nvcc::

    python3 scripts/scores_pv_stages.py

The wgmma kernel runs, per 64-key chunk of a query tile, S = Q K^T on the
tensor cores, a wait, the exp2 terms and the rowsum in registers, then
O += P V. Each variant is a copy of the source with one of them removed
(text patches, each required to apply; the copies go under
``build/scores_pv_stages/``): ``no_s`` issues no S products (the terms
then run on zero logits), ``no_terms`` packs the logits as P in place of
their exp2 terms, ``no_pv`` issues no PV products, ``terms_only`` neither
product. Their outputs are wrong by design and are not checked; the whole
build is the port's kernel. A stage whose removal saves the most time is
the one the others wait on. Shapes: the EncDec decoder's (head dim 48,
bs512, N 400, 4 heads), ViT-B/16's (head dim 64, bs256, N 197, 12 heads)
and PCT's (head dim 32, bs128, N 1024, 4 heads). Each time is the mean of
two turns (whole, the variants, SDPA, then back), each 20 launches
replayed from one CUDA graph. Prints one JSON line per shape, with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "scores_pv_stages")
# (tag, images, tokens, head dim, heads)
SHAPES = (("encdec_decoder", 512, 400, 48, 4), ("vit_b16", 256, 197, 64, 12),
          ("pct", 128, 1024, 32, 4))
# the chunk loop's lines each variant guards with its macro
_S_FULL = "          hopper::wgmma_m64n64k16_rs<0>(s, qa[kk], k_desc<HD>(kc + kk * G::KSTEP));"
_S_PART = "              hopper::wgmma_m64n16k16_rs<0>(\n"
_TERMS = ("          uint32_t p0 = exp2_terms(s[4 * j], s[4 * j + 1]);      // row g\n"
          "          uint32_t p1 = exp2_terms(s[4 * j + 2], s[4 * j + 3]);  // row g + 8")
_PV = ("            hopper::wgmma_m64n64k16_rs<1>(o, pa[sl], vd);",
       "            hopper::wgmma_m64n32k16_rs<1>(o, pa[sl], vd);",
       "            hopper::wgmma_m64n48k16_rs<1>(o, pa[sl], vd);")
VARIANTS = {"whole": {}, "no_s": {"NO_S": 1}, "no_terms": {"NO_TERMS": 1}, "no_pv": {"NO_PV": 1},
            "terms_only": {"NO_S": 1, "NO_PV": 1}}


def probe_source(src: str) -> str:
    """The kernel source with each stage behind its macro (0 = kept)."""
    reps = [(_S_FULL, "          if (!NO_S) " + _S_FULL.lstrip()),
            (_S_PART, "              if (!NO_S) " + _S_PART.lstrip()),
            (_TERMS, "          uint32_t p0 = NO_TERMS ? pack_bf16(s[4 * j], s[4 * j + 1])\n"
                     "                                 : exp2_terms(s[4 * j], s[4 * j + 1]);\n"
                     "          uint32_t p1 = NO_TERMS ? pack_bf16(s[4 * j + 2], s[4 * j + 3])\n"
                     "                                 : exp2_terms(s[4 * j + 2], s[4 * j + 3]);")]
    reps += [(line, "            { if (!NO_PV) " + line.lstrip() + " }") for line in _PV]
    for old, new in reps:
        if src.count(old) != 1:
            raise RuntimeError(f"the probe's patch no longer applies to attn_scores_pv.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build() -> dict:
    sys.path.insert(0, REPO)
    from peekvit_torch.ops.cuda import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "attn_scores_pv_probe.cu")
    with open(os.path.join(_build.CSRC, "attn_scores_pv.cu")) as f:
        text = probe_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    procs = {}
    for name, macros in VARIANTS.items():
        flags = [f"-D{k}={macros.get(k, 0)}" for k in ("NO_S", "NO_TERMS", "NO_PV")]
        target = os.path.join(OUT, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, *flags, "-o", target, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), target)
    symbol, argtypes = _build._SIGNATURES["attn_scores_pv"]
    fns = {}
    for name, (proc, target) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{output[-4000:]}")
        fn = getattr(ctypes.CDLL(target), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(torch, fn, iters: int = 20) -> float:
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("scores_pv_stages: needs an NVIDIA card", file=sys.stderr)
        return 1
    fns = build()
    from peekvit_torch.ops.cuda import fused_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    card = card.stdout.strip().splitlines()[0] if card.returncode == 0 else "not read"
    gen = torch.Generator(device="cuda").manual_seed(19)
    with torch.inference_mode():
        for tag, b, n, hd, heads in SHAPES:
            d = hd * heads
            qkv = torch.randn(b, n, 3 * d, generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty(b, n, d, dtype=torch.bfloat16, device="cuda")
            sdpa = [qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, hd).transpose(1, 2)
                    .contiguous() for i in range(3)]

            def call(name):
                err = fns[name](qkv.data_ptr(), out.data_ptr(), None, b, n, d, heads, hd,
                                fa._qscale(hd), -1, 0.0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")

            order = list(VARIANTS) + ["sdpa"]
            times = {k: [] for k in order}
            for turn in order + order[::-1]:
                fn = ((lambda: F.scaled_dot_product_attention(*sdpa)) if turn == "sdpa"
                      else (lambda t=turn: call(t)))
                times[turn].append(graph_ms(torch, fn))
            mean = {k: sum(v) / len(v) for k, v in times.items()}
            print(json.dumps({"shape": tag, "images": b, "tokens": n, "head_dim": hd,
                              "heads": heads, "device_ms": mean,
                              "saved_ms": {k: mean["whole"] - mean[k] for k in VARIANTS
                                           if k != "whole"},
                              "turns_ms": times, "plan": fa.attn_scores_pv_plan(b, n, heads, hd),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
