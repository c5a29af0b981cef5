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
   version's time, its bound and one PyTorch library call's time. Every
   timing phase takes a kernel's time twice: over 20 launches from
   Python (ms) and over 10 launches replayed from one CUDA graph
   (device_ms: the card's time, where a kernel of a few tens of
   microseconds is shorter than its wrapper's host work);
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
9. residual kernel checks: the masked variants (masked norm from bf16 and
   fp32, masked two-pass LN, both masked-residual GEMMs, attention with
   the phantom key weight at N = 155 and 107) against their plain versions
   at ResidualViT-B/16 bs256 shapes;
10. residual engine: build_model("residualvit", ResidualViT-B/16) with
   seeded weights serves 8 and 256 images at budgets 0.25, 0.5 and 1.0
   (counts zeroed just before and read just after: 84 launches per
   forward), held against residualvit_forward_plain (bf16 and fp32), each
   layer's share of kept image tokens; one ee_outputs=True request on an
   eeresidualvit (13 outputs); compact=0.75 (merged layer with the
   phantom) and compact=0.5 (split sublayers) at budget 0.5, 84 launches
   each, held against the plain twin on the images whose survivors fit
   the capacity, top-1 agreement with the exact engine;
11. residual timing at bs256: the exact engine at each budget, the two
   compact modes, each new kernel variant's time, plain time, bound and
   library yardstick, and one profiled exact forward;
12. masked trainable block: the two new kernel variants (GEMM epilogue
   masked_rowdot, ln_bwd_rows.masked) against their plain versions at
   ResidualViT-B/16 bs256 shapes, then masked_attention_block_trainable
   (save_qkv True and False) against its plain twin at bs32, N = 198: the
   output and all eight gradients, the mask's included;
13. residual train: build_model("residualvit", ResidualViT-B/16) under
   Trainer(Adam(lr=1e-3), clip_grad_norm=1.0, train_backbone=False,
   loss_compose=configs/loss/crossentropy_mse.yaml's losses), budgets
   drawn per sample: five fused_residual steps on one bs-64 batch (counts
   zeroed just before, read just after: 108 launches per step, every
   kernel of the path launched; losses finite and falling; the mse metric;
   the frozen leaves unchanged); one bs-16 step's gradients against the
   plain versions and the save_qkv=False step against the default; one
   bs-8 module-path step of an eeresidualvit with ee_weights (13 outputs);
14. residual train timing at bs256: ms per step, images/s, share of the
   bf16 peak, peak memory, each new kernel's time, plain time, bound and
   library yardstick, the step's breakdown, one profiled step;
15. RankViT kernel checks at bs256 shapes: attn_scores_pv.kmask,
   keymasked_layer_block_folded and keymasked_attention_block at N = 148
   (the max_budget=0.75 buffer after layer 3) with about half of each
   image's keys excluded and the excluded rows poisoned with NaN and Inf
   (valid rows compared, finite, and bit-identical to a clean input's),
   fused_mlp_block and fused_attention_block at N = 99 (the exact drop at
   budget 0.5) and fused_layer_block_folded at N = 197, against their
   plain versions;
16. RankViT serving: build_model("rankvit", RankViT-B/16) with seeded
   weights (head and class token re-drawn) serves 8 and 256 images, the
   exact drop at budgets 0.25/0.5/0.75/1.0 and max_budget=0.75 at
   0.25/0.5/0.75 (counts zeroed just before, read just after: 84 launches
   per forward, every kernel of each path), each held against its plain
   twin on the engine's kept tokens (bf16 and fp32), with the share of
   images whose kept sets a free-running plain twin picks too; the padded
   against the exact drop;
17. RankViT timing at bs256: each path and budget (ms, images/s, share of
   the bf16 peak from analytic_macs), attn_scores_pv.kmask and the three
   compositions beside their plain versions, bounds and library
   yardsticks, one profiled exact forward at budget 0.5;
18. int8 kernel checks at ViT-B/16 bs256 shapes: quant_rows (LN from
   bf16 x, the bf16 attention output, LN from the fp32 y, the fp32 gelu
   output; dynamic and static) with codes within 1 on at most 1e-3 of
   the elements and scales within 1e-6; the four s8 GEMM epilogues (bias,
   residual_f32, gelu_f32, residual) and a static row scale, exact s32
   sums; quant_layer_block at N = 197 (dynamic and static caps),
   quant_keymasked_layer_block at N = 148 with the excluded rows poisoned
   (valid rows finite and bit-identical to a clean input's),
   quant_attention_block and quant_mlp_block at N = 99;
19. int8 serving: ViT-B/16 with dynamic scales and with SmoothQuant +
   static caps from 32 seeded calibration images (bench.py:213-250's
   recipe), RankViT-B/16 exact at 0.25/0.5/1.0 and max_budget=0.75 at
   0.25/0.5, at 8 and 256 images (counts zeroed before and read after
   each forward: 108 launches, the expected keys, every new variant
   launched), logits against each path's plain twin (bf16, 5e-2 of
   max|logit|, top-1 on decided images; the RankViT twins fed the
   engine's kept indices), top-1 agreement with the bf16 engine reported;
20. int8 timing at bs256: each path beside the bf16 engine (ms, images/s,
   share of the int8 and of the bf16 peak), each new kernel's time,
   launches, bound, plain time and library yardstick (torch._int_mm +
   dequant; amax/round/clamp), the merged int8 layer, one profiled ViT
   int8 forward;
21. residual int8 kernel checks at ResidualViT-B/16 bs256 shapes:
   quant_rows with the row mask (LN from bf16 x and from the fp32 y,
   dynamic and static; masks of zeros, ones and fractions: a masked row
   gets zero codes and the 1e-12 floor), the two masked-residual s8
   epilogues (exact s32), quant_masked_layer_block at N = 198 (dynamic
   and static caps), quant_masked_attention_block and
   quant_masked_mlp_block at N = 107;
22. residual int8 serving: build_model("residualvit", ResidualViT-B/16)
   with InferenceEngine(quantized=True), dynamic and with SmoothQuant +
   static caps from 32 seeded images, at budgets 0.25/0.5/1.0 and 8 and
   256 images, and one ee_outputs=True request on an eeresidualvit (13
   outputs); counts zeroed before and read after each forward (108
   launches, the expected keys, every new variant); logits against
   residualvit_forward_quant_plain (5e-2 of max|logit|, top-1 on decided
   images); top-1 agreement with the bf16 engine; then the split int8
   sublayers (sites 15-16) once through their compositions, counted;
23. A-ViT: norm_rows.avit (0/1 and fractional masks) and avit_layer_block
   against their plain versions at A-ViT-S/16 bs256 shapes; then
   build_model("adavit", A-ViT-S/16) at 8 and 256 images, at the config's
   gates and at gate_scale=5, gate_center=0 (84 launches per forward),
   logits against adavit_forward_plain fed the engine's halting
   decisions, each layer's active share, the free-running twin's depth
   agreement;
24. timing at bs256: the int8 ResidualViT at each budget beside the bf16
   engine, A-ViT-S/16 beside a ViT-S/16 bf16 engine, each new variant's
   time, launches, bound, plain time and library yardstick, the two new
   compositions, one profiled forward of each path;
25. PCT kernel checks at ModelNet40 bs128 shapes (1024 points, d = 128, 4
   heads): arpe_tokens against arpe_tokens_ref on clouds sampled on simple
   surfaces, 8 of them with tied points (every row's kNN threshold
   bit-equal and its neighbour count equal; fp32 tokens within 1e-5, bf16
   tokens), attn_scores_pv at head dim 32 at N = 1024, N = 64 and with
   every logit at the clamp, fused_layer_block_folded at N = 1024;
26. PCT / RankPCT serving: build_model("pct") and build_model("rankpct")
   with ranking on, at configs/model/pct.yaml's widths and 1024 points,
   seeded weights and BatchNorm statistics, serve 8 and 128 clouds
   (RankPCT at budgets 0.25/0.5/1.0 and with none); counts zeroed before
   and read after each forward: 29 launches (arpe_tokens, 4 x 7, among
   them attn_scores_pv.hd32); logits against pct_forward_plain /
   rankpct_forward_plain (bf16 and fp32, the RankPCT twins fed the
   engine's kept indices), the free-running twin's kept-set agreement;
27. PCT timing at bs128: each path and budget (ms, clouds/s), both new
   kernels' time, launches, bound, plain time and library yardstick (the
   ARPE bound from the kernel's own operations on this run's neighbour
   sets, the counting bisection's beside it), the exp2 count beside the
   SFU's rate, the ARPE share of the forward, the folded layer at N =
   1024, one profiled forward of each path;
28. merged-layer kernel checks at ViT-B/16 bs256 shapes: ln_rows on the
   fp32 y, the GEMM epilogues gelu_hpre (h and the fp32 hpre) and NT
   gelu_grad (dhpre and the db1 partials), gemm_wgrad on the merged
   backward's four shapes (dWqkv, dWo, dW1, dW2; the column sums of dqkv
   and g; a rerun bit-identical), ln_bwd_rows.f32 and ln_bwd_rows.g_f32,
   attn_softmax_fwd on separate q, k, v (bit-identical to the packed
   mode); the wgmma kernels at their edges: attn_softmax_fwd (N 1-768,
   .kmask), gemm_wgrad (0-50,432 rows), attn_softmax_bwd (N 1-384, with
   the kernel each N takes) and every gemm_bias_epilogue epilogue in both
   layouts (M 1-50,688, N 8-3,072, K 128 and 3,072), reruns bit-identical;
   then layer_block_trainable and layer_block_hybrid against their
   _ref twins at bs32, N = 197 (output and 13 gradients, rel-L2 3e-2; two
   runs of each backward bit-identical);
29. merged training: a ViT-B/16 make_fused_train_step(AdamW(1e-4),
   merged=True) takes five steps on one bs-64 batch, then merged="hybrid"
   from the same weights (counts zeroed just before each step and read
   just after: 288 and 84 launches per step, every new kernel launched;
   losses finite and falling); one bs-16 step's gradients of each against
   the same step on the plain versions (rel-L2 per leaf 3e-2);
30. merged timing at bs256: the split, merged and hybrid steps in turns on
   one model and one AdamW (ms per step, images/s, peak memory), each new
   kernel's time, launches, bound, plain time and one PyTorch call
   (gemm_wgrad: a.t() @ b, bf16 out), one profiled merged step (warmed
   window); attn_softmax_bwd and every GEMM mode at ViT-B/16, PCT and
   A-ViT-S/16 shapes beside their bounds, plain versions and PyTorch
   calls, with the schedule each took, and ptxas's registers and spills of
   both sources (a spill fails the run);
31. the module path: the seeded ViT-B/16 module in eval mode, bf16, under
   set_attention_impl("pallas") serves 8 and 256 images (12
   attn_scores_pv launches per forward, logits against the same module
   under "xla" at 3e-2 of max|logit|, top-1 on decided images, both timed);
   the grad guard and the fp32 guard raise; fused_mhsa and
   fused_attention at (256, 197, 768) against their plain versions, timed
   beside SDPA;
32. tensor-parallel kernel checks at ViT-B/16 widths: the GEMM epilogue
   partial_f32 at the four partial shapes (out-projection and fc2 for
   n_model 2 and 4) and GEMM bias at N = 576; sites 25-28
   (tp_attention_partial, tp_masked_attention_partial,
   tp_masked_mlp_partial, tp_mlp_partial) on layer 0's shard-0 slices of
   the seeded models, cut by the port's prepare functions, for n_model 2
   and 4 at 8 and 256 images, against their plain versions; the Megatron
   identity (every shard's partials summed, plus bias and residual, against
   the single-device layer on the kernels) at 8 images;
33. tensor-parallel serving: n_model ranks (2, then 4), one spawned process
   each, all on cuda:0 over a gloo group (n_data 1; every library built
   before the first rank starts), serve ViT-B/16, RankViT-B/16 (0.5 and
   1.0), ResidualViT-B/16 (0.5) and the EE ResidualViT at
   configs/model/eeresidualvit.yaml's widths (its exit tuple) at 8 images
   through InferenceEngine(mesh=make_mesh(1, n_model)): counts zeroed just
   before each forward and read just after (7 launches per layer on every
   rank), every rank's outputs bit-identical, logits against the
   single-device engine (bf16 3e-2, top-1 on decided images); the ViT-B/16
   TP forward per rank at 1 and 8 images beside the single-device engine
   (gloo through the host: not NCCL across cards); each partial and
   partial_f32 timed per shard at 8 and 256 images beside its bound, plain
   version and a PyTorch yardstick;
34. sequence-parallel kernel checks at ViT-B/16 widths for 2 and 4 ranks
   (n_local 99 / 50 against n_pad 198 / 200 keys) at 8 and 256 images:
   attn_softmax_fwd.kmask and sp_tail_block (site 12, the SP tail) against
   their plain versions, q a slice of a local qkv, k and v of a gathered
   kv buffer, a key mask from a RankViT budget of 0.5 plus the padding and
   one image's first 64-key tile all excluded; the tail's gradients after
   the kernel forward equal the plain tail's; then each timed beside its
   bound, plain version and a PyTorch yardstick (SDPA with the boolean
   key mask, addmm chains); the old modes' bit identity is
   scripts/kernel_bit_identity.py's;
35. sequence-parallel training: S ranks (2, then 4), one spawned process
   each, all on cuda:0 over gloo (every library built before the first
   rank starts, joined with a deadline, a rank's exception failing the
   run), train the seeded ViT-B/16 and RankViT-B/16 at budget 0.5 through
   Trainer(AdamW, clip 1.0, sequence_parallel_devices=S) at bs8:
   parallel_kernels="auto" resolves to the tail kernel; one gradient of
   the step on every rank, which rank 0 holds against the same forward on
   sp_tail_block_ref with no collective, fed the run's kept tokens (loss
   rel 1e-2, rel-L2 per leaf 3e-2); three steps with the counts zeroed
   just before each and read just after (5 tail launches per layer per
   rank, 12 attn_softmax_fwd.kmask per forward); every rank's losses and
   final parameters bit-identical; ms per step per rank (gloo through the
   host: not NCCL across cards);
36. attn_scores_pv (head dims 64, 32 and 48) and gemm_s8_epilogue at
   their edges (see scores_pv_s8_edge_checks);
37. ptxas's registers and spills of arpe_tokens.cu and norm_rows.cu
   (none may spill);
38. the training attention at every shipped shape (see
   tiled_kernel_checks): attn_softmax_fwd (packed, separate, kmask) and
   attn_softmax_bwd at head dims 32 and 64 at every route, stage, ring and
   query-tile edge (1-1024 tokens) against their plain versions, each
   call's launch key
   and the C entry points' routes against the documented reach, the
   backward rerun bit-identical; ptxas of both sources (none may spill);
39. the shipped training configs (vit_tiny, rankvit, residualvit at full
   width and depth) under Trainer(Adam(1e-3), clip 1.0, fused="auto") at
   bs128 (see shipped_train_phases): at 160 px the fused path, one step's
   gradients against the plain versions (rel-L2 3e-2; 0.2 on a leaf that
   bf16 rounding alone moves past 3e-2), five counted
   steps (every launch key at its per-layer count; the attention on the
   key-tiled kernels where the shape takes them), finite losses, ms per
   step beside the module path's; at 224 px (785 / 786 tokens) one
   counted step each and the gradients at bs32;
40. the key-tiled kernels' times at the Trainer's shapes beside their
   bounds, plain versions and SDPA, and the tiled backward at head dim
   64 one token past the kept backward's reach beside it (see
   tiled_timing);
41. the reconstruction decoders (see recon_phases): the EncDec
   ResidualViT (configs/model/residualvitwithdecoder.yaml: its decoder at
   d 192 over 4 heads, attn_scores_pv.hd48) and the MAE ViT
   (configs/model/maevit.yaml) at 160 px serve 8 and 512 images through
   InferenceEngine(recon_outputs=True), counted per forward and held
   against their plain twins; attn_scores_pv.hd48 (the wgmma kernel,
   required by its plan) timed at bs512 beside its bound, plain version
   and SDPA; both engines logits-only and with the decoder; ptxas of the
   head-dim-48 instances of both kernels (none may spill);
42. the MoE ViT (see moe_phases): configs/model/moevit.yaml at 160 px
   served at 8 and 256 images by four engines (dense bf16, routed at
   capacity 2.0 and 1.0, int8), every forward counted key by key, the
   dense and int8 logits held against their plain twins fed the engine's
   expert choices, routed 2.0 against dense; GEMM s8 bias_f32 (the int8
   experts' linear) bit for bit against its plain version and timed at
   the experts' fc1 / fc2 shapes; ptxas of its instances (none may
   spill);
43. the closing lines, printed after 44 and 45 (below);
44. family training (see family_train_phases): A-ViT-S/16 at 224 px with
   the A-ViT losses, the MAE and the EncDec (reconstruction_weight 1.0)
   at 160 px and moevit.yaml at 160 px take three Trainer(AdamW) steps at
   bs128 on the module path (ms per step, peak memory, finite metrics, no
   port kernel launched); each trained model then serves 64 images
   through its InferenceEngine on the kernels (the recon engines with
   recon_outputs=True), counted key by key and held against its plain
   twin at 3e-2 of max|plain|;
45. noise on the engines (see noise_phases): ViT-B/16, ResidualViT-B/16,
   RankViT-B/16 (noise at its first ranked layer) and moevit.yaml built
   with noise_args, gaussian at 10 dB and token drop at 0.1, bf16 and
   int8: each noisy forward counted (the same launches as without
   noise), held against its plain twin fed the same realization, and
   timed beside the same engine without noise;
46. the entry points (see cli_phases): python -m peekvit_torch.cli.train
   and cli.test as a user runs them, on the repo's configs: vit_tiny and
   residualvit (loss=crossentropy_mse) train one epoch on synthetic data
   at 160 px (4 steps of bs128, the fused paths, each step's launches
   phase 39's); cli.test serves each checkpoint (the residualvit at three
   budgets with a retrofitted gaussian NoiseBlock at layer 2) and
   ViT-B/16 from a seeded torchvision-grammar .pth at 224 px
   (model=vit_b_16_pretrained), every engine forward counted (28 / 28 /
   84 launches) and each sweep held against the engine's plain twin on
   the same batches; epoch, loader and prefetch ms, wall and device
   images/s;
47. quantization-aware training (see qat_phases): ViT-B/16 at 224 px takes
   three Trainer(qat=True) steps at bs64, is calibrated on 64 images
   (collect_qat_calibration) and takes three qat="static" steps with the
   caps and SmoothQuant vectors (ms a step beside the same model's
   module-path step without QAT, peak memory, finite losses, no port
   kernel launched); ResidualViT-B/16 is calibrated through the residual
   collector at budget 0.5 (collect_qat_caps) and takes three
   qat="static" steps; each trained model is served by its calibrated
   int8 engine (InferenceEngine(quantized=True, calib_images=the same 64,
   calib_static_caps=True)), counted (108 launches a forward) and held
   against its plain twin within 5e-2 of max|logit|, top-1 on every
   decided image, with the agreement of the module's fake-quant eval
   forward with the engine printed; then cli.train model=vit_tiny
   training.qat=static for one epoch and cli.test on its checkpoint with
   test.quantized=true test.calib_images=64 test.calib_static_caps=true,
   every engine forward counted and the sweep held against the int8 plain
   twin;
48. serving bundles and the micro-batching host (see serving_phases):
   ViT-B/16 at 224 px saved as a bucketed bundle (1, 8, 64, 256) and
   reloaded (bytes of all and of the live leaves, seconds to save and
   from load to the first served batch beside building the engine), each
   bucket's forward counted (84 launches) and bit-identical to the live
   engine's; every other family's bundle against its live engine, bit
   for bit; the MicroBatcher with 1-256 closed-loop clients and the HTTP
   host with 1-64 urllib clients (images/s, p50 / p99, the batching
   counters), every reply held against its own image's plain twin; then
   cli.test's bundle export and python -m peekvit_torch.serving on it;
49. training with dropout and data parallelism (see dropout_phases and
   dp_phases): a ViT-B/16 Trainer at dropout = attention_dropout = 0.1
   takes 5 module-path steps at bs64 (finite, falling losses; every
   site's keep share within 5 sigma of 0.9; the time to draw one step's
   masks; ms a step and peak memory beside the same model's module step
   at rate 0), A-ViT-S/16, MoE and MAE one step each at 0.1; then 2
   spawned ranks on cuda:0 over gloo (a (2, 1) data mesh) serve ViT-B/16,
   a ResidualViT-B/16 with a constant budget token at 0.4 / 0.9 and int8
   ViT-B/16 at a global bs256 through InferenceEngine(mesh=) and train
   the fused ViT-B/16 and ResidualViT-B/16 steps and a ZeRO-1 step for 3
   steps at a global bs64 through Trainer(mesh=): every rank bit-identical,
   each rank's launches a forward and a step the single-device ones, the
   logits, losses and updates against the single-device engine and step
   of the same seed, ms per rank ("gloo through the host, 2 processes
   sharing one card: not NCCL"), ZeRO-1's optimizer bytes a rank;
50. sharded training and the native image decoder (see shard_phases and
   native_phase): 2 spawned ranks on cuda:0 over gloo train ViT-B/16 at 4
   of its 12 layers (SHARD_B16) with
   Trainer(fsdp_sharded_params=True) on a (2, 1) mesh and with
   Trainer(tensor_parallel=True) on (1, 2), and moevit.yaml at 160 px with
   its experts split on (1, 2) (the module step, global bs64, SGD momentum
   0.9, 3 steps); 4 ranks train the ViT-B/16 SP step with ZeRO-1 on a
   (2, 2) mesh (global bs16, 2 steps) beside the same step without ZeRO:
   every rank bit-identical, each rank's launches the unsharded step's,
   losses and updates against rank 0's single-device step (FSDP and TP at
   fp32 limits on every leaf, SHARD_TOLERANCES), ms a step,
   parameter and optimizer bytes held and peak memory per rank against the
   single device's; then the native decoder's available() and
   build_error(), and 64 PIL-written JPEGs through the loader's native and
   PIL paths (or, where it did not build, the fallback's batches against
   PIL's);
51. pipeline-parallel training (see pipe_phases): 4 spawned ranks on
   cuda:0 over gloo train ViT-B/16 pipelined on a (1, 4) stage mesh
   (global bs32, M = 8, parallel_kernels "auto", which must resolve to
   the trainable attention kernels, AdamW; and the fp32 "xla" form) and
   dp x pp on (2, 2) (M = 4), and the gated residualvit_b_16.yaml
   pipelined and sequence-parallel (bs16, budget 0.6, l1 sparsity, fp32):
   every rank bit-identical, each rank's launches a step the predicted
   count (PIPE_PER_LAYER x layers a stage x M), losses and updates
   against rank 0's single-device step within PIPE_TOLERANCES, ms a step
   a rank, the bubble, peak memory;
and then, as 43, the {"kernels": [...]} line (launches_by_path gains
"family_serve", "noise", "cli_train", "cli_test", "qat_serve",
"qat_cli_test", "serving", "dp_serve", "dp_train", "fsdp_train",
"tp_train", "zero_sp_train" and "pipeline_train"), the card's nvidia-smi
line, and
{"ok": true, "device": {...}} as the last line.

Imports nothing of JAX or of peekvit_tpu.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
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
# configs/model/residualvit_b_16.yaml at image 224 and 1000 classes, less
# its torch_pretrained_weights (seeded weights here)
RESIDUALVIT_B16 = dict(B16, residual_layers=["attention+mlp"] * 12, gate_temp=1,
                       add_input=False, gate_type="sigmoid", gate_threshold=0.5, gate_bias=0,
                       add_budget_token="learnable", attention_dropout=0.0, dropout=0.0)
RESIDUAL_REQUESTS = (8, 256)
BUDGETS = (0.25, 0.5, 1.0)
COMPACT = (0.75, 0.5)
COMPACT_BUDGET = 0.5
EE_REQUEST = 8
BLOCK_EPS = 1e-6  # ResidualViT block LN
RESIDUAL_TRAIN_BATCH = 64
RESIDUAL_TRAIN_LR = 1e-3
EE_TRAIN_BATCH = 8
# configs/loss/crossentropy_mse.yaml's additional_losses
CROSSENTROPY_MSE = {"mse": {"_target_": "peekvit.utils.losses.MSELoss", "weight": 0.01,
                            "strict": False, "budget": None, "per_layer": False,
                            "skip_layers": [0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11]}}
MASKED_GRAD_NAMES = ("dx", "dmask", "dln_scale", "dln_bias", "dw_qkv", "db_qkv", "dw_out",
                     "db_out")
# Launches per layer of one fused ResidualViT train step (save_qkv): the
# masked block's forward (masked LN, qkv GEMM, attention, masked out-proj
# GEMM) and backward (rowdot GEMM, g Wo^T, attention backward, dqkv Wqkv^T,
# masked LN backward); save_qkv=False adds the qkv GEMM to the backward.
RESIDUAL_TRAIN_PER_LAYER = {"ln_rows.masked": 1, "gemm_bias_epilogue.bias": 1,
                            "attn_softmax_fwd": 1, "gemm_bias_epilogue.masked_residual": 1,
                            "gemm_bias_epilogue.masked_rowdot": 1, "gemm_nt.none": 1,
                            "attn_softmax_bwd": 1, "gemm_nt.none_f32": 1,
                            "ln_bwd_rows.masked": 1}
RESIDUAL_RECOMPUTE_PER_LAYER = dict(RESIDUAL_TRAIN_PER_LAYER, **{"gemm_bias_epilogue.bias": 2})
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


def graph_ms(torch, fn, iters: int = 10) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, replayed once to warm up and once timed with CUDA events. No
    Python runs between the launches, so this is the card's time even
    where a kernel is shorter than its wrapper's host work (a few tens of
    microseconds), which cuda_ms then times instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


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
        return "cuBLAS matmuls (train: MLP, weight grads; both: embed, gates, heads)"
    if "reduce" in name.lower():
        return "reductions (LN statistics, bias sums, norms)"
    return "elementwise and copies (casts, concatenations, LN, gelu, bias, residual)"


def profile_step(torch, smi, step, step_ms, phase="profile_train_step", batch=BATCH,
                 warmup: bool = False) -> None:
    """Device time by kernel over one profiled call of ``step`` (a train
    step, or a forward) with torch.profiler (CUPTI): the breakdown of what
    the kernels' event timing leaves as 'other', and the device's busy
    share against the unprofiled time. Where the trace holds no device
    time, says so. A window opened cold can miss the first kernels of the
    call; ``warmup`` (forwards only: the step runs twice) traces one call
    first and keeps the second (torch.profiler's schedule)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for _ in range(2 if warmup else 1):
            step()
            torch.cuda.synchronize()
            prof.step()
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
    emit({"phase": phase, "batch": batch,
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
            dev_ms = graph_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=5)
        lib_ms = cuda_ms(torch, lfn)
        ms_by_key[key] = kernel_ms[name] = ms
        bnd, by = bound_ms(flops, nbytes)
        launches = train["counts"].get(key, 0)
        if launches == 0:
            raise AssertionError(f"{name}: never launched on the training path")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": checks[name], "ms": ms, "device_ms": dev_ms,
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


# Launches per layer of the ResidualViT paths: the exact masked layer (and
# compact=0.75, 155 tokens, the same layer with the phantom key weight) and
# compact=0.5 (107 tokens < 128: the split masked sublayers).
RESIDUAL_PER_LAYER = {"norm_rows.masked.bf16": 1, "norm_rows.masked.f32": 1,
                      "gemm_bias_epilogue.bias": 1, "attn_scores_pv": 1,
                      "gemm_bias_epilogue.masked_residual_f32": 1, "gemm_bias_epilogue.gelu": 1,
                      "gemm_bias_epilogue.residual": 1}
MERGED_PHANTOM_PER_LAYER = dict(RESIDUAL_PER_LAYER, **{"attn_scores_pv": 0,
                                                       "attn_scores_pv.kweight": 1})
SPLIT_PER_LAYER = {"ln_rows.masked": 2, "gemm_bias_epilogue.bias": 1, "attn_scores_pv.kweight": 1,
                   "gemm_bias_epilogue.masked_residual": 1, "gemm_bias_epilogue.gelu": 1,
                   "gemm_bias_epilogue.residual": 1}


def compact_geometry(capacity: float) -> tuple[int, int, float]:
    """(tokens, phantom index, phantom multiplier) of a ResidualViT-B/16
    layer under compact=capacity: the engine's capacity rule
    (ceil(c * 196) rounded up to 8), one class token, the phantom slot and
    the budget token."""
    n_img = (RESIDUALVIT_B16["image_size"] // RESIDUALVIT_B16["patch_size"]) ** 2
    cap = min(n_img, -8 * (-math.ceil(capacity * n_img) // 8))
    return 1 + cap + 2, 1 + cap, float(n_img - cap)


def compare_logits(torch, name, got, refs, mask=None) -> dict:
    """Logits against reference logits [(name, ref, rtol, atol)], optionally
    on the rows ``mask`` selects: max |delta|, top-1 agreement, and top-1
    agreement on every decided row (top-2 margin > 2 max |delta|). Raises
    when a check fails."""
    rec = {}
    for ref_name, ref, rtol, atol in refs:
        g, r = (got, ref) if mask is None else (got[mask], ref[mask])
        if g.shape[0] == 0:
            rec[ref_name] = {"rows": 0}
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite logits")
        delta = (g - r).abs()
        srt = r.sort(dim=-1).values
        decided = (srt[:, -1] - srt[:, -2]) > 2 * delta.max()
        agree = g.argmax(-1) == r.argmax(-1)
        rec[ref_name] = {"rows": int(g.shape[0]), "max_abs_delta": delta.max().item(),
                         "logit_spread": r.abs().max().item(),
                         "top1_agreement": agree.float().mean().item(),
                         "decided": int(decided.sum()), "rtol": rtol, "atol": atol}
        if not torch.all(delta <= atol + rtol * r.abs()):
            raise AssertionError(f"{name} vs {ref_name}: {rec[ref_name]}")
        if not agree[decided].all():
            raise AssertionError(f"{name}: top-1 differs on a decided image: {rec[ref_name]}")
    return rec


def residual_kernel_checks(torch, fa, check, randn, w_out, b_out, d, h) -> dict:
    """Phase 9: the masked variants against their plain versions at
    ResidualViT-B/16 bs256 shapes. Returns their inputs for phase 11."""
    tol_bf16, tol_f32, tol_attn = 2.0 ** -6, 1e-3, 2e-2
    n_exact = 1 + (RESIDUALVIT_B16["image_size"] // RESIDUALVIT_B16["patch_size"]) ** 2 + 1
    (n_m, idx_m, mult_m), (n_s, idx_s, mult_s) = (compact_geometry(c) for c in COMPACT)
    rows_e, rows_s = BATCH * n_exact, BATCH * n_s

    def gate_mask(rows):  # gate-like: a third exactly 0, the rest in (0, 1]
        return torch.clamp(randn(rows, dtype=torch.float32, scale=0.5, shift=0.2), 0.0,
                           1.0).to(torch.bfloat16)

    ins = {"xe": randn(rows_e, d, scale=1.5, shift=0.3),
           "ye": randn(rows_e, d, dtype=torch.float32, scale=1.5, shift=0.3),
           "ae": randn(rows_e, d), "me": gate_mask(rows_e),
           "xs": randn(rows_s, d, scale=1.5, shift=0.3), "as": randn(rows_s, d),
           "ms": gate_mask(rows_s), "s": randn(d, scale=0.2, shift=1.0), "b": randn(d, scale=0.1),
           "w_out": w_out, "b_out": b_out, "rows_e": rows_e, "rows_s": rows_s,
           "qkv_m": randn(BATCH, n_m, 3 * d), "qkv_s": randn(BATCH, n_s, 3 * d),
           "attn_m": (n_m, idx_m, mult_m), "attn_s": (n_s, idx_s, mult_s)}
    x, y, xs = ins["xe"], ins["ye"], ins["xs"]
    me, ms, ln_s, ln_b = ins["me"], ins["ms"], ins["s"], ins["b"]
    bf16 = torch.bfloat16
    with torch.inference_mode():
        check("norm_rows.masked.bf16", fa.norm_rows(x, BLOCK_EPS, bf16, ln_s, ln_b, me),
              fa.norm_rows_ref(x, BLOCK_EPS, bf16, ln_s, ln_b, me), tol_bf16,
              "bf16 output rounding")
        check("norm_rows.masked.f32", fa.norm_rows(y, BLOCK_EPS, bf16, ln_s, ln_b, me),
              fa.norm_rows_ref(y, BLOCK_EPS, bf16, ln_s, ln_b, me), tol_bf16,
              "bf16 output rounding")
        check("ln_rows.masked", fa.ln_rows(xs, ln_s, ln_b, BLOCK_EPS, ms),
              fa.ln_rows_ref(xs, ln_s, ln_b, BLOCK_EPS, ms), tol_bf16, "bf16 output rounding")
        check("gemm_bias_epilogue.masked_residual_f32",
              fa.gemm_bias_epilogue(ins["ae"], w_out, b_out, "masked_residual_f32", residual=x,
                                    mask=me),
              fa.gemm_bias_epilogue_ref(ins["ae"], w_out, b_out, "masked_residual_f32",
                                        residual=x, mask=me), tol_f32,
              "tensor-core fp32 accumulation against cuBLAS fp32 in another order over K = 768")
        check("gemm_bias_epilogue.masked_residual",
              fa.gemm_bias_epilogue(ins["as"], w_out, b_out, "masked_residual", residual=xs,
                                    mask=ms),
              fa.gemm_bias_epilogue_ref(ins["as"], w_out, b_out, "masked_residual", residual=xs,
                                        mask=ms), tol_bf16,
              "fp32 sums in another order, bf16 output rounding")
        for tag, qkv, (n, idx, mult) in (("m", ins["qkv_m"], ins["attn_m"]),
                                         ("s", ins["qkv_s"], ins["attn_s"])):
            check(f"attn_scores_pv.kweight.n{n}", fa.attn_scores_pv(qkv, h, idx, mult),
                  fa.attn_scores_pv_ref(qkv, h, idx, mult), tol_attn,
                  f"phantom key {idx} weighted by {mult:g}; bf16 rounding of logits before "
                  "exp2 and of the weighted term, bf16 output rounding")
        torch.cuda.synchronize()
    return ins


def seeded_residual_model(torch, name: str, args=None, noise_args=None):
    """build_model(name, ResidualViT-B/16 or ``args``, seed=0, with the
    NoiseBlock of ``noise_args``) on the card with its head and class
    token(s) re-drawn at std 0.02 (zero-initialised, they would make every
    logit 0), and any early-exit heads re-drawn the same way, so that
    every output has the final logits' scale."""
    from peekvit_torch import build_model

    model = build_model(name, args or RESIDUALVIT_B16, noise_args=noise_args, seed=0,
                        device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    cls = model.class_token if hasattr(model, "class_token") else model.class_tokens  # MoE: one
    kernels = [model.head.kernel, cls] + [
        p for k, p in model.named_parameters() if k.startswith("encoder.early_exit_heads_")
        and k.endswith("_head.kernel")]
    with torch.no_grad():
        for p in kernels:
            p.copy_(torch.randn(p.shape, generator=cpu_gen) * 0.02)
    return model


def counted(torch, fa, fn):
    """fn()'s result and the kernel launches it made (counts zeroed just
    before, read just after)."""
    fa.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fa.LAUNCHES)


def residual_phases(torch, fa, dev, smi) -> dict:
    """Phase 10: the ResidualViT-B/16 engine on the card (exact path at
    three budgets, early exits, two compact modes), each held against the
    plain twin. Returns what phase 11 times and the launch counts."""
    from peekvit_torch import InferenceEngine
    from peekvit_torch.inference import prepare_engine_params, residualvit_forward_plain
    from peekvit_torch.models.adapters import module_params

    layers = RESIDUALVIT_B16["num_layers"]
    bf16, f32 = torch.bfloat16, torch.float32
    # models built outside inference mode: their weights are ordinary parameters
    model = seeded_residual_model(torch, "residualvit")
    ee_model = seeded_residual_model(torch, "eeresidualvit")
    engine = InferenceEngine(model, device=DEVICE)  # bf16 on the card
    fwd = dict(patch_size=model.patch_size, num_heads=model.num_heads,
               num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
               gate_temp=model.gate_temp, gate_bias=model.gate_bias,
               budget_token=model.add_budget_token)
    params32 = prepare_engine_params(module_params(model), f32)
    img_gen = torch.Generator(device=dev).manual_seed(4)
    size = RESIDUALVIT_B16["image_size"]
    requests = [torch.randn(b, size, size, 3, generator=img_gen, device=dev)
                for b in RESIDUAL_REQUESTS]
    tol_reason = ("plain_bf16: same rounding points, sums in another order; the repo's bf16 "
                  "kernel tolerance (tests/test_pallas.py:42). plain_fp32: bf16 activations and "
                  "gates on bf16 tokens over 12 layers; the repo's bf16 engine tolerance "
                  "(tests/test_inference.py:54)")

    def refs(params16, images, budget, masks=None, **kw):
        p16 = residualvit_forward_plain(params16, images, budget, compute_dtype=bf16,
                                        masks=masks, **fwd, **kw)
        p32 = residualvit_forward_plain(params32, images, budget, compute_dtype=f32, **fwd, **kw)
        return p16, p32

    with torch.inference_mode():
        def serve():
            outs, per_forward = {}, []
            for images in requests:
                for budget in BUDGETS:
                    before = sum(fa.LAUNCHES.values())
                    outs[(images.shape[0], budget)] = engine(images, budget=budget)
                    per_forward.append(sum(fa.LAUNCHES.values()) - before)
            return outs, per_forward

        (outputs, per_forward), res_counts = counted(torch, fa, serve)
        emit({"phase": "residual_launches", "per_forward": per_forward, "counts": res_counts,
              "requests": list(RESIDUAL_REQUESTS), "budgets": list(BUDGETS), "card": smi})
        forwards = len(RESIDUAL_REQUESTS) * len(BUDGETS)
        want = {k: v * layers * forwards for k, v in RESIDUAL_PER_LAYER.items()}
        if per_forward != [7 * layers] * forwards or res_counts != want:
            raise AssertionError(f"residual launches {res_counts}, per forward {per_forward}, "
                                 f"want {want}")

        masks_by_budget = {}
        for images in requests:
            b = images.shape[0]
            for budget in BUDGETS:
                masks = {}
                p16, p32 = refs(engine.params, images, budget, masks)
                rec = compare_logits(torch, f"residual b{b} budget {budget}",
                                     outputs[(b, budget)],
                                     [("plain_bf16", p16, 3e-2, 3e-2), ("plain_fp32", p32, 0.1, 0.05)])
                kept = [(masks[f"layer_{i}"] > 0).float().mean().item() for i in range(layers)]
                emit({"phase": "residual_check", "batch": b, "budget": budget, **rec,
                      "kept_image_token_share_by_layer": kept,
                      "tolerance_reason": tol_reason, "card": smi})
                if b == BATCH:
                    masks_by_budget[budget] = masks
        low, high = outputs[(BATCH, BUDGETS[0])], outputs[(BATCH, BUDGETS[-1])]
        budget_delta = (low - high).abs().max().item()
        emit({"phase": "residual_budget_effect", "batch": BATCH, "budgets": [BUDGETS[0], BUDGETS[-1]],
              "max_abs_logit_delta": budget_delta,
              "top1_agreement": (low.argmax(-1) == high.argmax(-1)).float().mean().item(),
              "card": smi})
        if not budget_delta > 0.05:  # above the fp32 check's atol
            raise AssertionError(f"the budget barely changes the logits: {budget_delta}")

        # ---- early exits
        ee_engine = InferenceEngine(ee_model, device=DEVICE, ee_outputs=True)
        ee_images = requests[0][:EE_REQUEST]
        ee_out, ee_counts = counted(torch, fa, lambda: ee_engine(ee_images, budget=COMPACT_BUDGET))
        ee32 = prepare_engine_params(module_params(ee_model), f32)
        ee_p16 = residualvit_forward_plain(ee_engine.params, ee_images, COMPACT_BUDGET,
                                           compute_dtype=bf16, early_exits=True, **fwd)
        ee_p32 = residualvit_forward_plain(ee32, ee_images, COMPACT_BUDGET, compute_dtype=f32,
                                           early_exits=True, **fwd)
        if len(ee_out) != layers + 1 or sum(ee_counts.values()) != 7 * layers:
            raise AssertionError(f"ee outputs {len(ee_out)}, launches {ee_counts}")
        ee_recs = [compare_logits(torch, f"ee output {i}", g,
                                  [("plain_bf16", r16, 3e-2, 3e-2), ("plain_fp32", r32, 0.1, 0.05)])
                   for i, (g, r16, r32) in enumerate(zip(ee_out, ee_p16, ee_p32))]
        emit({"phase": "residual_ee", "batch": EE_REQUEST, "budget": COMPACT_BUDGET,
              "outputs": len(ee_out), "launches": ee_counts,
              "max_abs_delta_vs_plain_bf16": max(r["plain_bf16"]["max_abs_delta"] for r in ee_recs),
              "max_abs_delta_vs_plain_fp32": max(r["plain_fp32"]["max_abs_delta"] for r in ee_recs),
              "card": smi})

        # ---- compaction at budget 0.5 on the bs256 request
        images = requests[-1]
        exact = outputs[(BATCH, COMPACT_BUDGET)]
        compact_engines, compact_counts = {}, {}
        for capacity in COMPACT:
            eng = InferenceEngine(model, device=DEVICE, compact=capacity)
            caps = eng.compact_caps(COMPACT_BUDGET)
            n, idx, mult = compact_geometry(capacity)
            got, counts = counted(torch, fa, lambda: eng(images, budget=COMPACT_BUDGET))
            per_layer = MERGED_PHANTOM_PER_LAYER if n >= 128 else SPLIT_PER_LAYER
            want = {k: v * layers for k, v in per_layer.items() if v}
            if caps != (idx - 1,) * layers or counts != want:
                raise AssertionError(f"compact={capacity}: caps {caps}, launches {counts}, "
                                     f"want {want}")
            masks = {}
            p16 = residualvit_forward_plain(eng.params, images, COMPACT_BUDGET, compute_dtype=bf16,
                                            compact_caps=caps, masks=masks, **fwd)
            # kept image tokens per image and layer, as the compacted run's
            # gates decided them before each gather
            survivors = torch.stack([(masks[f"layer_{i}"][..., 0] > 0).sum(1)
                                     for i in range(layers)], dim=1)
            covered = (survivors <= caps[0]).all(dim=1)
            rec = compare_logits(torch, f"compact={capacity}", got,
                                 [("plain_bf16", p16, 3e-2, 3e-2)], mask=covered)
            emit({"phase": "compact_check", "capacity": capacity, "caps": list(caps),
                  "tokens": n, "phantom_idx": idx, "phantom_mult": mult,
                  "path": "merged masked layer" if n >= 128 else "split masked sublayers",
                  "launches": counts, "launches_per_forward": sum(counts.values()),
                  "images_covered": int(covered.sum()), "images": BATCH,
                  "max_survivors_by_layer": survivors.max(0).values.tolist(), **rec,
                  "top1_agreement_with_exact_engine":
                      (got.argmax(-1) == exact.argmax(-1)).float().mean().item(),
                  "max_abs_delta_vs_exact_engine": (got - exact).abs().max().item(),
                  "tolerance_reason": "held against the plain twin on the images whose "
                                      "survivors fit the capacity at every layer (the plain "
                                      "twin's gates); elsewhere the two may keep different "
                                      "tokens",
                  "card": smi})
            compact_engines[capacity] = (eng, caps)
            compact_counts[capacity] = counts
    return {"model": model, "engine": engine, "images": images, "masks": masks_by_budget,
            "compact": compact_engines, "counts": res_counts, "compact_counts": compact_counts,
            "ee_counts": ee_counts}


def residual_timing(torch, F, fa, smi, checks, ins, res, kernel_ms, d, h) -> list:
    """Phase 11: the exact engine at each budget and the compact modes at
    bs256, then each new kernel variant beside its plain version, bound and
    library yardstick. Returns the new kernels' JSON entries."""
    from peekvit_torch.utils.flops_count import analytic_macs, compact_macs

    model, engine, images = res["model"], res["engine"], res["images"]
    layers = RESIDUALVIT_B16["num_layers"]
    dense = 2.0 * analytic_macs(model)
    with torch.inference_mode():
        forward_ms = {}
        for budget in BUDGETS:
            ms = cuda_ms(torch, lambda: engine(images, budget=budget), iters=10)
            forward_ms[budget] = ms
            aware = 2.0 * analytic_macs(model, {"masks": res["masks"][budget]})
            emit({"phase": "timing_residual", "path": "exact", "batch": BATCH, "budget": budget,
                  "ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
                  "flops_per_image_dense": dense, "flops_per_image_mask_aware": aware,
                  "share_of_bf16_peak": dense * BATCH / (ms / 1e3) / PEAK_BF16_FLOPS,
                  "card": smi})
        for capacity, (eng, caps) in res["compact"].items():
            ms = cuda_ms(torch, lambda: eng(images, budget=COMPACT_BUDGET), iters=10)
            flops = 2.0 * compact_macs(model, caps)
            emit({"phase": "timing_residual", "path": f"compact={capacity}", "batch": BATCH,
                  "budget": COMPACT_BUDGET, "caps": list(caps), "ms_per_forward": ms,
                  "images_per_s": BATCH / ms * 1e3, "flops_per_image_from_caps": flops,
                  "share_of_bf16_peak": flops * BATCH / (ms / 1e3) / PEAK_BF16_FLOPS,
                  "speedup_vs_exact": forward_ms[COMPACT_BUDGET] / ms, "card": smi})

        bf, f4 = 2, 4
        bf16 = torch.bfloat16
        x, y, xs, ae, as_ = ins["xe"], ins["ye"], ins["xs"], ins["ae"], ins["as"]
        me, ms_, ln_s, ln_b = ins["me"], ins["ms"], ins["s"], ins["b"]
        w_out, b_out = ins["w_out"], ins["b_out"]
        rows_e, rows_s = ins["rows_e"], ins["rows_s"]

        affine = {dt: (ln_s.to(dt), ln_b.to(dt)) for dt in (bf16, torch.float32)}

        def ln_lib(t, m):  # F.layer_norm takes the affine in the input's dtype
            return F.layer_norm(t, (d,), *affine[t.dtype], BLOCK_EPS) * m[:, None]

        def sdpa_phantom(qkv, n, idx, mult):
            q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(BATCH, n, h, d // h).transpose(1, 2)
                       .contiguous() for i in range(3))
            bias = torch.zeros(1, n, dtype=bf16, device=qkv.device)  # log(mult) at the phantom key
            bias[0, idx] = math.log(mult)
            return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

        src = "peekvit_torch/csrc/"
        # name, count key, source, replaces, kernel, plain, library, flops, bytes
        timed = [
            ("norm_rows.masked.bf16", "norm_rows.masked.bf16", src + "norm_rows.cu",
             f"{REPLACES}:672-678 mask * _ln_f32_rows (:578) in _layer_kernel mode 'masked' :616",
             lambda: fa.norm_rows(x, BLOCK_EPS, bf16, ln_s, ln_b, me),
             lambda: fa.norm_rows_ref(x, BLOCK_EPS, bf16, ln_s, ln_b, me),
             lambda: ln_lib(x, me), 9.0 * rows_e * d, rows_e * d * (bf + bf) + rows_e * bf + 2 * d * bf),
            ("norm_rows.masked.f32", "norm_rows.masked.f32", src + "norm_rows.cu",
             f"{REPLACES}:707-710 mask * _ln_f32_rows (:578) of the fp32 y in _layer_kernel :616",
             lambda: fa.norm_rows(y, BLOCK_EPS, bf16, ln_s, ln_b, me),
             lambda: fa.norm_rows_ref(y, BLOCK_EPS, bf16, ln_s, ln_b, me),
             lambda: ln_lib(y, me), 9.0 * rows_e * d, rows_e * d * (f4 + bf) + rows_e * bf + 2 * d * bf),
            ("ln_rows.masked", "ln_rows.masked", src + "norm_rows.cu",
             f"{REPLACES}:389-395 and :427-432 two-pass mask * LN of _masked_attn_kernel :378 / "
             "_masked_mlp_kernel :422",
             lambda: fa.ln_rows(xs, ln_s, ln_b, BLOCK_EPS, ms_),
             lambda: fa.ln_rows_ref(xs, ln_s, ln_b, BLOCK_EPS, ms_),
             lambda: ln_lib(xs, ms_), 10.0 * rows_s * d, rows_s * d * (bf + bf) + rows_s * bf + 2 * d * bf),
            ("gemm_bias_epilogue.masked_residual_f32", "gemm_bias_epilogue.masked_residual_f32",
             src + "gemm_bias_epilogue.cu",
             f"{REPLACES}:698-702 masked out-proj + fp32 residual of _layer_kernel mode 'masked' :616",
             lambda: fa.gemm_bias_epilogue(ae, w_out, b_out, "masked_residual_f32", residual=x, mask=me),
             lambda: fa.gemm_bias_epilogue_ref(ae, w_out, b_out, "masked_residual_f32", residual=x,
                                               mask=me),
             lambda: torch.addmm(b_out, ae, w_out).float() * me[:, None] + x,
             2.0 * rows_e * d * d, (rows_e * d + d * d + d) * bf + rows_e * d * (f4 + bf) + rows_e * bf),
            ("gemm_bias_epilogue.masked_residual", "gemm_bias_epilogue.masked_residual",
             src + "gemm_bias_epilogue.cu",
             f"{REPLACES}:417-419 masked out-proj + residual of _masked_attn_kernel :378",
             lambda: fa.gemm_bias_epilogue(as_, w_out, b_out, "masked_residual", residual=xs, mask=ms_),
             lambda: fa.gemm_bias_epilogue_ref(as_, w_out, b_out, "masked_residual", residual=xs,
                                               mask=ms_),
             lambda: (torch.addmm(b_out, as_, w_out) * ms_[:, None] + xs).to(bf16),
             2.0 * rows_s * d * d, (rows_s * d + d * d + d) * bf + rows_s * d * (bf + bf) + rows_s * bf),
        ]
        for qkv, (n, idx, mult) in ((ins["qkv_m"], ins["attn_m"]), (ins["qkv_s"], ins["attn_s"])):
            timed.append((f"attn_scores_pv.kweight.n{n}", "attn_scores_pv.kweight",
                          src + "attn_scores_pv.cu", f"{REPLACES}:46 _attn_scores_pv with kweight "
                          f"(:98-99), in _layer_kernel :616 / _masked_attn_kernel :378",
                          lambda qkv=qkv, idx=idx, mult=mult: fa.attn_scores_pv(qkv, h, idx, mult),
                          lambda qkv=qkv, idx=idx, mult=mult: fa.attn_scores_pv_ref(qkv, h, idx, mult),
                          sdpa_phantom(qkv, n, idx, mult),
                          4.0 * BATCH * h * n * n * (d // h), BATCH * n * (3 * d + d) * bf))
        compact_by_n = {compact_geometry(c)[0]: c for c in COMPACT}
        entries = []
        for name, key, source, replaces, kfn, pfn, lfn, flops, nbytes in timed:
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            kernel_ms[name] = ms
            plain_ms = cuda_ms(torch, pfn, iters=5)
            lib_ms = cuda_ms(torch, lfn)
            bnd, by = bound_ms(flops, nbytes)
            if key == "attn_scores_pv.kweight":
                capacity = compact_by_n[int(name.rsplit("n", 1)[1])]
                launches, path = res["compact_counts"][capacity].get(key, 0), f"compact={capacity}"
            elif key in res["counts"]:
                launches, path = res["counts"][key], "residual (exact)"
            else:
                launches, path = res["compact_counts"][COMPACT[-1]].get(key, 0), \
                    f"compact={COMPACT[-1]}"
            if launches == 0:
                raise AssertionError(f"{name}: never launched on the residual path")
            entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, "max_abs_err": checks[name], "ms": ms,
                     "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                     "path": path, "shape_batch": BATCH, "count_key": key}
            emit({"phase": "timing_kernel", **{k: v for k, v in entry.items() if k != "count_key"},
                  "share_of_bound": bnd / ms, "card": smi})
            entries.append(entry)
        profile_step(torch, smi, lambda: engine(images, budget=COMPACT_BUDGET),
                     forward_ms[COMPACT_BUDGET], phase="profile_residual_forward")
    # exact path per forward: this phase's masked kernels plus the ViT
    # phase's times of the unchanged GEMMs and attention (N = 197 there)
    per_layer_ms = {k: kernel_ms[k] for k in RESIDUAL_PER_LAYER}
    kernels_ms = sum(per_layer_ms.values()) * layers
    emit({"phase": "timing_breakdown_residual", "budget": 1.0,
          "kernels_ms_per_forward": kernels_ms,
          "kernel_ms_per_forward_by_kernel": {k: v * layers for k, v in per_layer_ms.items()},
          "forward_ms": forward_ms[1.0], "other_ms": forward_ms[1.0] - kernels_ms,
          "other": "embed, gates, budget token, classify, launch gaps", "card": smi})
    return entries


def masked_block_checks(torch, fa, vjp, check, randn, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out,
                        d, h) -> dict:
    """Phase 12: the masked block's two new kernel variants against their
    plain versions at ResidualViT-B/16 bs256 shapes (N = 198), then the
    block (both backwards) against its plain twin at BLOCK_BATCH images.
    Returns the variants' inputs for phase 14."""
    tol_bf16, tol_f32, tol_block = 2.0 ** -6, 1e-3, 2e-2
    n = 1 + (RESIDUALVIT_B16["image_size"] // RESIDUALVIT_B16["patch_size"]) ** 2 + 1
    rows = BATCH * n

    def gate_mask(*shape):  # gate-like: a third exactly 0, the rest in (0, 1]
        return torch.clamp(randn(*shape, dtype=torch.float32, scale=0.5, shift=0.2), 0.0,
                           1.0).to(torch.bfloat16)

    ins = {"attn": randn(rows, d), "g": randn(rows, d, scale=0.05), "m": gate_mask(rows),
           "x": randn(rows, d, scale=1.5, shift=0.3),
           "ds1": randn(rows, d, dtype=torch.float32, scale=0.05), "rows": rows, "n": n}
    attn, g, m, x, ds1 = ins["attn"], ins["g"], ins["m"], ins["x"], ins["ds1"]
    with torch.inference_mode():
        dproj_k, parts = fa.gemm_masked_rowdot(attn, w_out, b_out, g, m)
        dproj_p, rowdot_p = fa.gemm_masked_rowdot_ref(attn, w_out, b_out, g, m)
        check("gemm_bias_epilogue.masked_rowdot", dproj_k, dproj_p, tol_bf16,
              "bf16(g * mask): one rounding of the same fp32 product")
        check("gemm_bias_epilogue.masked_rowdot.rowdot", parts.sum(-1), rowdot_p.sum(-1), tol_f32,
              "tensor-core fp32 proj against cuBLAS fp32, row sums over 768 columns in another "
              "order")
        ins["parts"] = parts
        got = vjp.ln_bwd_rows_masked(x, ds1, g, ln_s, ln_b, m, parts, BLOCK_EPS)
        want = vjp.ln_bwd_rows_masked_ref(x, ds1, g, ln_s, ln_b, m, parts, BLOCK_EPS)
        check("ln_bwd_rows.masked", got[0], want[0], tol_bf16, "bf16 output rounding")
        check("ln_bwd_rows.masked.dm", got[1], want[1], tol_bf16,
              "fp32 row sums in another order, bf16 output rounding")
        check("ln_bwd_rows.masked.partials", torch.cat([got[2].sum(0), got[3].sum(0)]),
              torch.cat([want[2][0], want[3][0]]), tol_f32,
              f"fp32 column sums over {rows:,} rows in another order")
        torch.cuda.synchronize()

    # The block: the kernels and the plain versions round at the same
    # points; fp32 sums in another order flip a bf16 rounding now and then,
    # and the flips feed the backward's sums over 198 keys and the weight
    # products over 6,336 rows: 2e-2, phase 6's trainable-block tolerance.
    xb = randn(BLOCK_BATCH, n, d, scale=1.5, shift=0.3)
    mb = gate_mask(BLOCK_BATCH, n, 1)
    gb = randn(BLOCK_BATCH, n, d, scale=0.05)
    block_args = (xb, mb, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out)
    for save_qkv in (True, False):
        results = []
        for fn in (vjp.masked_attention_block_trainable, vjp.masked_attention_block_trainable_ref):
            leaves = [t.detach().clone().requires_grad_() for t in block_args]
            out = fn(*leaves, h, BLOCK_EPS, save_qkv)
            out.backward(gb)
            results.append([out.detach()] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        for name, got_t, want_t in zip(("out",) + MASKED_GRAD_NAMES, *results):
            check(f"masked_block.save_qkv={save_qkv}.{name}", got_t, want_t, tol_block,
                  "bf16 roundings flipped by fp32 sums in another order, through one backward")
    return ins


def residual_train_phases(torch, F, fa, dev, smi, macs_per_image) -> dict:
    """Phases 13 and 14 (the step): a ResidualViT-B/16 Trainer on the fused
    residual path as configs/training/finetune.yaml with
    configs/loss/crossentropy_mse.yaml; one step's gradients against the
    plain versions and the recompute backward; an early-exit module-path
    step; the bs256 step's time. Returns the main run's counts, the step
    time and the trainer."""
    from peekvit_torch import Trainer
    from peekvit_torch.models.adapters import tree_leaves
    from peekvit_torch.training.fused import residual_forward_fn, sample_budgets
    from peekvit_torch.training.optim import Adam
    from peekvit_torch.training.trainer import param_filter_mask, step_generator
    from peekvit_torch.utils.losses import LossCompose

    layers = RESIDUALVIT_B16["num_layers"]
    model = seeded_residual_model(torch, "residualvit")
    trainer = Trainer(model, Adam(lr=RESIDUAL_TRAIN_LR), clip_grad_norm=1.0, train_backbone=False,
                      loss_compose=LossCompose(CROSSENTROPY_MSE), device=DEVICE)
    if trainer._fused_kind() != "residual":
        raise AssertionError(f"Trainer resolved to {trainer._fused_kind()!r}, not 'residual'")
    trainable = dict(tree_leaves(param_filter_mask(trainer.params)))
    frozen = {k: p.detach().clone() for k, p in tree_leaves(trainer.params) if not trainable[k]}
    moving = {k: p.detach().clone() for k, p in tree_leaves(trainer.params) if trainable[k]}
    gen = torch.Generator(device=dev).manual_seed(5)
    size = RESIDUALVIT_B16["image_size"]

    def batch(b):
        return (torch.randn(b, size, size, 3, generator=gen, device=dev),
                torch.randint(0, RESIDUALVIT_B16["num_classes"], (b,), generator=gen, device=dev))

    x64, y64 = batch(RESIDUAL_TRAIN_BATCH)
    fa.reset_launch_counts()
    metrics, per_step = [], []
    for i in range(TRAIN_STEPS):
        before = sum(fa.LAUNCHES.values())
        metrics.append(trainer.train_step(x64, y64, step_idx=i))
        per_step.append(sum(fa.LAUNCHES.values()) - before)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    losses = [m["total_loss"] for m in metrics]
    unchanged = all(torch.equal(p, frozen[k]) for k, p in tree_leaves(trainer.params)
                    if k in frozen)
    moved = sorted(k for k, p in tree_leaves(trainer.params)
                   if k in moving and not torch.equal(p, moving[k]))
    step_launches = sum(RESIDUAL_TRAIN_PER_LAYER.values()) * layers
    emit({"phase": "residual_train", "kind": trainer._train_kind, "batch": RESIDUAL_TRAIN_BATCH,
          "steps": TRAIN_STEPS, "optimizer": f"Adam(lr={RESIDUAL_TRAIN_LR}), clip_grad_norm=1.0, "
          "train_backbone=False", "loss_compose": CROSSENTROPY_MSE, "metrics": metrics,
          "launches_per_step": per_step, "counts": counts, "frozen_leaves": len(frozen),
          "frozen_unchanged": unchanged, "trainable_leaves": len(moving),
          "trainable_moved": len(moved), "card": smi})
    want = {k: v * layers * TRAIN_STEPS for k, v in RESIDUAL_TRAIN_PER_LAYER.items()}
    if trainer._train_kind != "fused_residual" or per_step != [step_launches] * TRAIN_STEPS \
            or counts != want:
        raise AssertionError(f"residual train launches {per_step} {counts}, want {want}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"residual train losses not finite and falling: {losses}")
    if not all("mse" in m for m in metrics) or not unchanged or not moved:
        raise AssertionError(f"mse metric, frozen leaves unchanged ({unchanged}) or trainable "
                             f"leaves moved ({moved})")

    # One step's gradients at GRAD_BATCH with one drawn budget vector:
    # kernels, plain versions, recompute backward. Tolerance per leaf as
    # phase 7 (3e-2); a leaf whose plain gradient is exactly 0 (a gate
    # whose relu is off everywhere) must be exactly 0 through the kernels.
    tol_grad = 3e-2
    params = trainer.params
    xg, yg = batch(GRAD_BATCH)
    bvec = sample_budgets(model, GRAD_BATCH, step_generator(0, 7), dev)

    def grads(**kwargs):
        model.zero_grad(set_to_none=True)
        logits, aux = residual_forward_fn(model, **kwargs)(params, xg, bvec)
        loss = F.cross_entropy(logits, yg) + trainer.loss_compose.compute(
            aux, budget=bvec.mean(), return_dict=False)
        loss.backward()
        return float(loss.detach()), {k: (p.grad.detach().clone() if p.grad is not None
                                          else torch.zeros_like(p))
                                      for k, p in tree_leaves(params)}

    loss_k, g_k = grads()
    loss_p, g_p = grads(plain=True)
    fa.reset_launch_counts()
    loss_r, g_r = grads(save_qkv=False)
    torch.cuda.synchronize()
    recompute_counts = dict(fa.LAUNCHES)
    model.zero_grad(set_to_none=True)
    err_plain, err_recompute = rel_l2(torch, g_k, g_p), rel_l2(torch, g_r, g_k)
    zero_leaves = sorted(k for k, v in g_p.items() if not v.abs().max() > 0)
    zero_kept = all(not g_k[k].abs().max() > 0 for k in zero_leaves)
    emit({"phase": "residual_train_grads", "batch": GRAD_BATCH, "budgets": bvec.tolist(),
          "loss_kernels": loss_k, "loss_plain": loss_p, "loss_recompute": loss_r,
          "leaves": len(g_k), "max_rel_l2_vs_plain": max(err_plain.values()),
          "rel_l2_vs_plain": err_plain, "zero_plain_leaves": len(zero_leaves),
          "zero_leaves_zero_through_kernels": zero_kept,
          "max_rel_l2_recompute_vs_default": max(err_recompute.values()),
          "recompute_bit_identical": all(torch.equal(g_r[k], g_k[k]) for k in g_k),
          "recompute_launches": recompute_counts, "tolerance_rel_l2": tol_grad,
          "tolerance_reason": "same rounding points; bf16 flips from fp32 sums in another "
                              "order through 12 layers; the repo's bf16 tolerance",
          "card": smi})
    if max(err_plain.values()) > tol_grad or max(err_recompute.values()) > tol_grad \
            or not zero_kept:
        raise AssertionError("residual train gradients out of tolerance")
    if recompute_counts != {k: v * layers for k, v in RESIDUAL_RECOMPUTE_PER_LAYER.items()}:
        raise AssertionError(f"recompute launches {recompute_counts}")

    # One early-exit module-path step (output_format 'early_exits' is never fused).
    ee_model = seeded_residual_model(torch, "eeresidualvit")
    ee_trainer = Trainer(ee_model, Adam(lr=RESIDUAL_TRAIN_LR), clip_grad_norm=1.0,
                         train_backbone=False, loss_compose=LossCompose(CROSSENTROPY_MSE),
                         ee_weights=[float(i + 1) for i in range(layers + 1)], device=DEVICE)
    x8, y8 = batch(EE_TRAIN_BATCH)
    with torch.no_grad():
        outs, _ = ee_model(x8, train=True, generator=step_generator(0, 0))
    ee_metrics, ee_counts = counted(torch, fa, lambda: ee_trainer.train_step(x8, y8, step_idx=0))
    ee_metrics = {k: float(v) for k, v in ee_metrics.items()}
    emit({"phase": "residual_train_ee", "kind": ee_trainer._train_kind, "batch": EE_TRAIN_BATCH,
          "ce_terms": len(outs), "metrics": ee_metrics, "launches": ee_counts, "card": smi})
    if ee_trainer._train_kind != "module" or len(outs) != layers + 1 \
            or not all(math.isfinite(v) for v in ee_metrics.values()):
        raise AssertionError(f"early-exit module step: {ee_trainer._train_kind}, {len(outs)} "
                             f"outputs, {ee_metrics}")
    del ee_trainer, ee_model

    # ------------------------------------------------------------ 14. timing
    xb, yb = batch(BATCH)
    for i in range(2):
        trainer.train_step(xb, yb, step_idx=100 + i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: trainer.train_step(xb, yb), iters=5)
    flops_img = 3 * 2.0 * macs_per_image  # fwd + bwd, the 3 x dense forward convention
    emit({"phase": "timing_residual_train", "batch": BATCH, "ms_per_step": step_ms,
          "images_per_s": BATCH / step_ms * 1e3, "flops_per_image": flops_img,
          "achieved_tflops": flops_img * BATCH / step_ms / 1e9,
          "share_of_bf16_peak": flops_img * BATCH / (step_ms / 1e3) / PEAK_BF16_FLOPS,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches_per_step": step_launches, "card": smi})
    profile_step(torch, smi, lambda: trainer.train_step(xb, yb), step_ms,
                 phase="profile_residual_train_step")
    return {"counts": counts, "step_ms": step_ms, "layers": layers}


def residual_train_entries(torch, F, fa, vjp, smi, checks, rtrain, kernel_ms, ins, res_ins,
                           ln_s, ln_b, w_out, b_out, d) -> list:
    """Phase 14 per kernel: the two new variants' time at bs256 beside their
    plain versions, bounds and library yardsticks; then the step's
    breakdown. Returns the new kernels' JSON entries."""
    bf, f4 = 2, 4
    bf16 = torch.bfloat16
    attn, g, m, x, ds1, parts = (ins[k] for k in ("attn", "g", "m", "x", "ds1", "parts"))
    rows = ins["rows"]
    ln_leaves = [x.detach().clone().requires_grad_(), ln_s.detach().clone().requires_grad_(),
                 ln_b.detach().clone().requires_grad_()]
    ln_out = F.layer_norm(ln_leaves[0], (d,), ln_leaves[1], ln_leaves[2], BLOCK_EPS)
    ln_f32 = ln_out.detach().float()
    ds1_bf16 = ds1.to(bf16)

    def rowdot_lib():  # addmm + mul + row-sum
        proj = torch.addmm(b_out, attn, w_out)
        return g * m[:, None], (g.float() * proj.float()).sum(-1)

    def ln_bwd_lib():  # F.layer_norm backward + the row dots
        grads = torch.autograd.grad(ln_out, ln_leaves, ds1_bf16, retain_graph=True)
        return grads, (ds1 * ln_f32).sum(-1) + parts.sum(-1)

    src = "peekvit_torch/csrc/"
    both = (f"{REPLACES_VJP}:753 _masked_trainable_bwd_saved (_masked_bwd_kernel_saved :550) "
            f"and :703 _masked_trainable_bwd (_masked_bwd_kernel :445)")
    n_parts = -(-d // fa.ROWDOT_TILE)
    ln_parts = -(-rows // vjp.ROWS_PER_PARTIAL)
    timed = [
        ("gemm_bias_epilogue.masked_rowdot", src + "gemm_bias_epilogue.cu",
         f"{both}: proj, dproj = g * mask and sum(g * proj) :575-583 / :488-498",
         lambda: fa.gemm_masked_rowdot(attn, w_out, b_out, g, m),
         lambda: fa.gemm_masked_rowdot_ref(attn, w_out, b_out, g, m), rowdot_lib,
         2.0 * rows * d * d,
         (rows * d + d * d + d + rows * d + rows + rows * d) * bf + rows * n_parts * f4),
        ("ln_bwd_rows.masked", src + "ln_bwd_rows.cu",
         f"{both}: LN backward and dm :621-631 / :536-547",
         lambda: vjp.ln_bwd_rows_masked(x, ds1, g, ln_s, ln_b, m, parts, BLOCK_EPS),
         lambda: vjp.ln_bwd_rows_masked_ref(x, ds1, g, ln_s, ln_b, m, parts, BLOCK_EPS),
         ln_bwd_lib, 25.0 * rows * d,
         rows * d * (bf + f4 + bf + bf) + rows * n_parts * f4 + 2 * rows * bf + 2 * d * bf
         + 2 * ln_parts * d * f4),
    ]
    entries = []
    for name, source, replaces, kfn, pfn, lfn, flops, nbytes in timed:
        with torch.inference_mode():
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=5)
        lib_ms = cuda_ms(torch, lfn)
        kernel_ms[name] = ms
        bnd, by = bound_ms(flops, nbytes)
        launches = rtrain["counts"].get(name, 0)
        if launches == 0:
            raise AssertionError(f"{name}: never launched on the residual train path")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": checks[name], "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                 "path": "residual train (fused ResidualViT step)", "shape_batch": BATCH}
        emit({"phase": "timing_kernel", **entry, "share_of_bound": bnd / ms,
              "launches_per_step": launches // TRAIN_STEPS, "card": smi})
        entries.append(entry)
    # the masked forward kernels at N = 198 (phases 9-11 time them at the
    # compact=0.5 shapes), for the breakdown only
    with torch.inference_mode():
        kernel_ms["ln_rows.masked.n198"] = cuda_ms(
            torch, lambda: fa.ln_rows(res_ins["xe"], ln_s, ln_b, BLOCK_EPS, res_ins["me"]))
        kernel_ms["gemm_bias_epilogue.masked_residual.n198"] = cuda_ms(
            torch, lambda: fa.gemm_bias_epilogue(res_ins["ae"], w_out, b_out, "masked_residual",
                                                 residual=res_ins["xe"], mask=res_ins["me"]))
    by_key = {"ln_rows.masked": "ln_rows.masked.n198",
              "gemm_bias_epilogue.masked_residual": "gemm_bias_epilogue.masked_residual.n198",
              "gemm_bias_epilogue.bias": "gemm_bias_epilogue.bias"}
    per_step = {k: kernel_ms[by_key.get(k, k)] * v * rtrain["layers"]
                for k, v in RESIDUAL_TRAIN_PER_LAYER.items()}
    kernels_ms = sum(per_step.values())
    emit({"phase": "timing_breakdown_residual_train", "kernels_ms_per_step": kernels_ms,
          "kernel_ms_per_step_by_kernel": per_step, "step_ms": rtrain["step_ms"],
          "other_ms": rtrain["step_ms"] - kernels_ms,
          "other": "gates, concatenations, eager MLP half, weight-gradient products, "
                   "embed/classify, regularizer, Adam",
          "note": "qkv GEMM, attention and NT GEMM times from the ViT phases (N = 197)",
          "card": smi})
    return entries


# RankViT serving: configs/model/rankvit_b_16.yaml at image 224 and 1000
# classes, less its torch_pretrained_weights (seeded weights here)
RANKVIT_B16 = dict(B16, rankvit_layers=[3, 6, 9])
RANK_REQUESTS = (8, 256)
RANK_BUDGETS = (0.25, 0.5, 0.75, 1.0)          # the exact drop
RANK_MAX_BUDGET = 0.75
RANK_PADDED_BUDGETS = (0.25, 0.5, 0.75)        # max_budget=0.75: one set of shapes
RANK_PROFILE_BUDGET = 0.5
RANK_RUNS = ([("exact", b) for b in RANK_BUDGETS]
             + [("padded", b) for b in RANK_PADDED_BUDGETS])
# Launches per layer of the RankViT paths: the folded layer (128 tokens or
# more on the exact path, and before the first ranked layer on the padded
# one), its key-masked form (the padded path from the first ranked layer
# on) and the split sublayers (the exact path below 128 tokens).
RANK_PER_LAYER = {
    "merged": {"norm_rows.bf16": 1, "norm_rows.f32": 1, "gemm_bias_epilogue.bias": 1,
               "attn_scores_pv": 1, "gemm_bias_epilogue.residual_f32": 1,
               "gemm_bias_epilogue.gelu": 1, "gemm_bias_epilogue.residual": 1},
    "split": {"ln_rows": 2, "gemm_bias_epilogue.bias": 1, "attn_scores_pv": 1,
              "gemm_bias_epilogue.residual": 2, "gemm_bias_epilogue.gelu": 1},
}
RANK_PER_LAYER["keymasked"] = dict(RANK_PER_LAYER["merged"], **{"attn_scores_pv": 0,
                                                                "attn_scores_pv.kmask": 1})


def rank_layer_paths(budget: float, max_budget=None) -> list:
    """'merged', 'split' or 'keymasked' for each layer of a RankViT-B/16
    forward, from the engine's keep counts (inference.rank_schedule)."""
    from peekvit_torch.inference import rank_schedule

    width = (RANKVIT_B16["image_size"] // RANKVIT_B16["patch_size"]) ** 2
    schedule = rank_schedule(width, tuple(RANKVIT_B16["rankvit_layers"]), budget, max_budget)
    paths, masked = [], False
    for i in range(RANKVIT_B16["num_layers"]):
        if i in schedule:
            width, masked = schedule[i][0], max_budget is not None
        paths.append("keymasked" if masked else "merged"
                     if max_budget is not None or 1 + width >= 128 else "split")
    return paths


def rank_counts(paths_list) -> dict:
    """The launches the forwards with these per-layer paths make."""
    total: dict = {}
    for paths in paths_list:
        for path in paths:
            for key, v in RANK_PER_LAYER[path].items():
                if v:
                    total[key] = total.get(key, 0) + v
    return total


def rank_kernel_checks(torch, fa, check, randn, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, w1, b1,
                       w2, b2, d, h, smi) -> dict:
    """Phase 15: attn_scores_pv.kmask, keymasked_layer_block_folded and
    keymasked_attention_block at N = 148 (the max_budget=0.75 buffer after
    layer 3) with about half of each image's keys excluded and the excluded
    rows poisoned with NaN and Inf, and fused_mlp_block at N = 99 (the
    exact drop at budget 0.5 after layer 3), against their plain versions
    at bs256 shapes; then the earlier slices' fused_attention_block (N =
    99) and fused_layer_block_folded (N = 197), which the exact drop runs.
    Returns the inputs phase 17 times."""
    tol_bf16, tol_attn = 2.0 ** -6, 2e-2
    n_img = (RANKVIT_B16["image_size"] // RANKVIT_B16["patch_size"]) ** 2
    n_pad, n_split = 1 + math.ceil(n_img * RANK_MAX_BUDGET), 1 + math.ceil(n_img * 0.5)
    bf16 = torch.bfloat16
    keep = randn(BATCH, n_pad, dtype=torch.float32) > 0.0  # about half
    keep[:, 0] = True  # the class token is always a key
    excluded = ~keep
    kmask = keep.to(bf16)

    def poison(t):
        """t with the excluded rows NaN (even rows) and Inf (odd rows)."""
        t = t.clone()
        rows = excluded.nonzero()
        bad = torch.where(rows[:, 1] % 2 == 0, float("nan"), float("inf")).to(t.dtype)
        t[rows[:, 0], rows[:, 1]] = bad[:, None]
        return t

    qkv = randn(BATCH, n_pad, 3 * d)
    x = randn(BATCH, n_pad, d, scale=1.5, shift=0.3)
    ins = {"qkv": poison(qkv), "x": poison(x), "km": kmask, "km3": kmask[:, None, :],
           "xs": randn(BATCH, n_split, d, scale=1.5, shift=0.3), "n_pad": n_pad,
           "n_split": n_split, "kept_keys": keep.float().sum(1).mean().item()}
    layer_w = (w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2)
    attn_w = (ln_s, ln_b, w_qkv, b_qkv, w_out, b_out)
    with torch.inference_mode():
        cases = {
            "attn_scores_pv.kmask": (
                lambda q: fa.attn_scores_pv(q, h, kmask=kmask),
                lambda q: fa.attn_scores_pv_ref(q, h, kmask=kmask), qkv, ins["qkv"], tol_attn,
                "bf16 rounding of logits before exp2, bf16 output rounding"),
            "keymasked_layer_block_folded": (
                lambda t: fa.keymasked_layer_block_folded(t, ins["km3"], *layer_w, h, EPS),
                lambda t: fa.keymasked_layer_block_folded_ref(t, ins["km3"], *layer_w, h, EPS),
                x, ins["x"], tol_attn,
                "seven launches; bf16 roundings flipped by fp32 sums in another order, the "
                "attention kernel's tolerance"),
            "keymasked_attention_block": (
                lambda t: fa.keymasked_attention_block(t, ins["km3"], *attn_w, h, EPS),
                lambda t: fa.keymasked_attention_block_ref(t, ins["km3"], *attn_w, h, EPS),
                x, ins["x"], tol_attn,
                "four launches; bf16 roundings flipped by fp32 sums in another order, the "
                "attention kernel's tolerance"),
        }
        for name, (kfn, pfn, clean, bad, tol, reason) in cases.items():
            got, want = kfn(bad), pfn(bad)
            # only the valid rows (queries) are compared; they must be finite
            check(name, got[keep], want[keep], tol,
                  f"valid rows of {int(keep.sum())} with {int(excluded.sum())} excluded rows "
                  f"poisoned with NaN/Inf; {reason}")
            unchanged = torch.equal(got[keep], kfn(clean)[keep])
            emit({"phase": "kmask_inert", "kernel": name, "tokens": n_pad,
                  "excluded_rows": int(excluded.sum()), "valid_rows": int(keep.sum()),
                  "valid_rows_bit_identical_to_clean_input": unchanged, "card": smi})
            if not unchanged:
                raise AssertionError(f"{name}: garbage in excluded rows changed a valid row")
        check("fused_mlp_block", fa.fused_mlp_block(ins["xs"], ln_s, ln_b, w1, b1, w2, b2, EPS),
              fa.fused_mlp_block_ref(ins["xs"], ln_s, ln_b, w1, b1, w2, b2, EPS), tol_bf16,
              "three launches; fp32 sums in another order, bf16 roundings of LN and gelu "
              "output")
        # the two compositions of earlier slices that the exact drop runs,
        # whole against their plain twins: the split attention sublayer
        # below 128 tokens and the folded layer at 197
        check("fused_attention_block", fa.fused_attention_block(ins["xs"], *attn_w, h, EPS),
              fa.fused_attention_block_ref(ins["xs"], *attn_w, h, EPS), tol_attn,
              "four launches; bf16 roundings flipped by fp32 sums in another order, the "
              "attention kernel's tolerance")
        x197 = randn(BATCH, 1 + n_img, d, scale=1.5, shift=0.3)
        check("fused_layer_block_folded", fa.fused_layer_block_folded(x197, *layer_w, h, EPS),
              fa.fused_layer_block_folded_ref(x197, *layer_w, h, EPS), tol_attn,
              "seven launches; bf16 roundings flipped by fp32 sums in another order, the "
              "attention kernel's tolerance")
        torch.cuda.synchronize()
    return ins


def kept_set_agreement(torch, kept: dict, other: dict, schedule: dict) -> dict:
    """{ranked layer: share of images whose valid kept tokens are the same
    set in both index dicts at that layer and every ranked layer before}.
    Each layer's indices point into the previous layer's gathered buffer
    (in descending-norm order), so they are composed into the original
    patch positions first."""
    out, agree, ids_a, ids_b = {}, None, None, None
    for i, (_, n_valid) in schedule.items():
        ids_a = kept[i] if ids_a is None else torch.gather(ids_a, 1, kept[i])
        ids_b = other[i] if ids_b is None else torch.gather(ids_b, 1, other[i])
        same = (torch.sort(ids_a[:, :n_valid], dim=1).values
                == torch.sort(ids_b[:, :n_valid], dim=1).values).all(dim=1)
        agree = same if agree is None else agree & same
        out[i] = agree.float().mean().item()
    return out


def rank_phases(torch, fa, dev, smi) -> dict:
    """Phase 16: RankViT-B/16 served at 8 and 256 images, the exact drop at
    four budgets and max_budget=0.75 at three (84 launches per forward,
    every kernel of the path launched), each forward held against its plain
    twin on the engine's kept tokens (bf16 and fp32); the share of images
    whose kept sets a free-running plain twin picks too; the padded against
    the exact drop."""
    from peekvit_torch import InferenceEngine, build_model
    from peekvit_torch.inference import (
        prepare_engine_params,
        rank_schedule,
        rankvit_forward_fused,
        rankvit_forward_padded,
        rankvit_forward_padded_plain,
        rankvit_forward_plain,
    )
    from peekvit_torch.models.adapters import module_params

    bf16, f32 = torch.bfloat16, torch.float32
    model = build_model("rankvit", RANKVIT_B16, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # zero-initialised head and class token: re-drawn as in phase 4
        model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
        model.class_tokens.copy_(torch.randn(model.class_tokens.shape, generator=cpu_gen) * 0.02)
    engines = {"exact": InferenceEngine(model, device=DEVICE),
               "padded": InferenceEngine(model, device=DEVICE, max_budget=RANK_MAX_BUDGET)}
    fwd = dict(engines["exact"]._forward)
    del fwd["compute_dtype"]
    params32 = prepare_engine_params(module_params(model), f32, fold_ln=True)
    img_gen = torch.Generator(device=dev).manual_seed(6)
    size = RANKVIT_B16["image_size"]
    requests = [torch.randn(b, size, size, 3, generator=img_gen, device=dev)
                for b in RANK_REQUESTS]
    n_img = (size // RANKVIT_B16["patch_size"]) ** 2
    ranked = tuple(RANKVIT_B16["rankvit_layers"])

    def forwards(mode, budget):
        """(kernel forward, plain twin) with the mode's arguments bound."""
        if mode == "exact":
            return (lambda p, x, **kw: rankvit_forward_fused(p, x, budget=budget, **fwd, **kw),
                    lambda p, x, **kw: rankvit_forward_plain(p, x, budget=budget, **fwd, **kw))
        return (lambda p, x, **kw: rankvit_forward_padded(
                    p, x, budget, max_budget=RANK_MAX_BUDGET, **fwd, **kw),
                lambda p, x, **kw: rankvit_forward_padded_plain(
                    p, x, budget, max_budget=RANK_MAX_BUDGET, **fwd, **kw))

    with torch.inference_mode():
        def serve():
            outs, per_forward = {}, []
            for images in requests:
                for mode, budget in RANK_RUNS:
                    before = sum(fa.LAUNCHES.values())
                    outs[(images.shape[0], mode, budget)] = engines[mode](images, budget=budget)
                    per_forward.append(sum(fa.LAUNCHES.values()) - before)
            return outs, per_forward

        (outputs, per_forward), counts = counted(torch, fa, serve)
        paths = {(mode, b): rank_layer_paths(b, RANK_MAX_BUDGET if mode == "padded" else None)
                 for mode, b in RANK_RUNS}
        want = rank_counts([paths[run] for _ in requests for run in RANK_RUNS])
        emit({"phase": "rank_launches", "per_forward": per_forward, "counts": counts,
              "requests": list(RANK_REQUESTS), "runs": [list(r) for r in RANK_RUNS],
              "layer_paths": {f"{m} {b}": p for (m, b), p in paths.items()}, "card": smi})
        layers = RANKVIT_B16["num_layers"]
        if per_forward != [7 * layers] * len(per_forward) or counts != want:
            raise AssertionError(f"rank launches {counts}, per forward {per_forward}, "
                                 f"want {want}")
        tol_reason = ("both sides on the engine's kept tokens. plain_bf16: same rounding "
                      "points, sums in another order; the repo's bf16 kernel tolerance "
                      "(tests/test_pallas.py:42). plain_fp32: bf16 activations over 12 layers; "
                      "the repo's bf16 engine tolerance (tests/test_inference.py:54)")
        for images in requests:
            b = images.shape[0]
            for mode, budget in RANK_RUNS:
                kfn, pfn = forwards(mode, budget)
                kept, free = {}, {}
                got = outputs[(b, mode, budget)]
                if not torch.equal(kfn(engines[mode].params, images, kept_out=kept), got):
                    raise AssertionError(f"rank {mode} {budget}: a second forward differs")
                p16 = pfn(engines[mode].params, images, kept_idx=kept, compute_dtype=bf16)
                p32 = pfn(params32, images, kept_idx=kept, compute_dtype=f32)
                pfn(engines[mode].params, images, kept_out=free, compute_dtype=bf16)
                schedule = rank_schedule(n_img, ranked, budget,
                                         RANK_MAX_BUDGET if mode == "padded" else None)
                agree = kept_set_agreement(torch, kept, free, schedule)
                rec = compare_logits(torch, f"rank {mode} b{b} budget {budget}", got,
                                     [("plain_bf16", p16, 3e-2, 3e-2),
                                      ("plain_fp32", p32, 0.1, 0.05)])
                emit({"phase": "rank_check", "mode": mode, "batch": b, "budget": budget,
                      "max_budget": RANK_MAX_BUDGET if mode == "padded" else None,
                      "keep_by_ranked_layer": {i: list(v) for i, v in schedule.items()},
                      "layer_paths": paths[(mode, budget)], **rec,
                      "free_running_kept_set_agreement_by_layer": agree,
                      "tolerance_reason": tol_reason, "card": smi})
        big = {run: outputs[(BATCH,) + run] for run in RANK_RUNS}
        for budget in RANK_PADDED_BUDGETS:
            padded, exact = big[("padded", budget)], big[("exact", budget)]
            emit({"phase": "rank_padded_vs_exact", "batch": BATCH, "budget": budget,
                  "max_budget": RANK_MAX_BUDGET,
                  "max_abs_delta": (padded - exact).abs().max().item(),
                  "top1_agreement": (padded.argmax(-1) == exact.argmax(-1)).float().mean().item(),
                  "note": "numerics differ below 128 tokens (the padded path runs the folded "
                          "layer: one-pass LN, fp32 mid residual; the exact path the split "
                          "sublayers), and bf16 ties may keep other tokens",
                  "card": smi})
        low, high = big[("exact", RANK_BUDGETS[0])], big[("exact", 1.0)]
        budget_delta = (low - high).abs().max().item()
        emit({"phase": "rank_budget_effect", "batch": BATCH, "budgets": [RANK_BUDGETS[0], 1.0],
              "max_abs_logit_delta": budget_delta,
              "top1_agreement": (low.argmax(-1) == high.argmax(-1)).float().mean().item(),
              "card": smi})
        if not budget_delta > 0.0:
            raise AssertionError("the budget does not change the RankViT logits")
    return {"model": model, "engines": engines, "images": requests[-1], "counts": counts,
            "paths": paths}


def _schedule_masks(torch, schedule: dict, n_img: int, which: int) -> dict:
    """aux-style (1, n_img, 1) masks keeping the first count tokens, which=0
    the buffer's count, 1 the valid count, for analytic_macs."""
    masks = {}
    for i, counts in schedule.items():
        m = torch.zeros(1, n_img, 1)
        m[:, :counts[which]] = 1.0
        masks[f"layer_{i}"] = m
    return {"masks": masks}


def rank_timing(torch, F, fa, smi, checks, ins, rank, kernel_ms, ln_s, ln_b, w_qkv, b_qkv,
                w_out, b_out, w1, b1, w2, b2, d, h, m) -> list:
    """Phase 17: each path and budget at bs256 (ms, images/s, share of the
    bf16 peak from analytic_macs), the new kernel and compositions beside
    their plain versions, bounds and library yardsticks, and one profiled
    exact forward at budget 0.5. Returns the JSON entries."""
    from peekvit_torch.inference import rank_schedule
    from peekvit_torch.utils.flops_count import analytic_macs

    model, engines, images = rank["model"], rank["engines"], rank["images"]
    n_img = (RANKVIT_B16["image_size"] // RANKVIT_B16["patch_size"]) ** 2
    ranked = tuple(RANKVIT_B16["rankvit_layers"])
    dense = 2.0 * analytic_macs(model)
    forward_ms = {}
    with torch.inference_mode():
        for mode, budget in RANK_RUNS:
            ms = cuda_ms(torch, lambda: engines[mode](images, budget=budget), iters=10)
            forward_ms[(mode, budget)] = ms
            schedule = rank_schedule(n_img, ranked, budget,
                                     RANK_MAX_BUDGET if mode == "padded" else None)
            run = 2.0 * analytic_macs(model, _schedule_masks(torch, schedule, n_img, 0))
            useful = 2.0 * analytic_macs(model, _schedule_masks(torch, schedule, n_img, 1))
            emit({"phase": "timing_rank", "path": mode, "batch": BATCH, "budget": budget,
                  "max_budget": RANK_MAX_BUDGET if mode == "padded" else None,
                  "ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
                  "flops_per_image_dense": dense, "flops_per_image_run": run,
                  "flops_per_image_budget": useful,
                  "share_of_bf16_peak_run": run * BATCH / (ms / 1e3) / PEAK_BF16_FLOPS,
                  "share_of_bf16_peak_budget": useful * BATCH / (ms / 1e3) / PEAK_BF16_FLOPS,
                  "card": smi})

        bf, bf16 = 2, torch.bfloat16
        n_pad, n_split, qkv, x, xs = ins["n_pad"], ins["n_split"], ins["qkv"], ins["x"], ins["xs"]
        km, km3 = ins["km"], ins["km3"]
        rows_p, rows_s, hd = BATCH * n_pad, BATCH * n_split, d // h
        kept_keys = ins["kept_keys"]
        key_bool = (km > 0)[:, None, None, :]

        def heads(t):
            return t.reshape(BATCH, n_pad, h, hd).transpose(1, 2)

        sq, sk, sv = (heads(qkv[..., i * d:(i + 1) * d]).contiguous() for i in range(3))

        def sdpa_mask(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=key_bool)

        def mlp_lib(t):  # F.layer_norm + addmm + gelu + addmm + add
            t2 = t.reshape(-1, d)
            z = F.layer_norm(t2, (d,), ln_s, ln_b, EPS)
            z = F.gelu(torch.addmm(b1, z, w1), approximate="tanh")
            return torch.addmm(b2, z, w2) + t2

        def layer_lib(t):  # the key-masked layer from PyTorch calls, SDPA with the key mask
            t2 = t.reshape(-1, d)
            z = F.layer_norm(t2, (d,), eps=EPS)
            q, k, v = (heads(c) for c in torch.addmm(b_qkv, z, w_qkv).split(d, dim=-1))
            a = sdpa_mask(q, k, v).transpose(1, 2).reshape(-1, d)
            y = torch.addmm(b_out, a, w_out).float() + t2
            z = F.gelu(torch.addmm(b1, F.layer_norm(y, (d,), eps=EPS).to(bf16), w1),
                       approximate="tanh")
            return torch.addmm(b2, z, w2) + y

        def attn_block_lib(t):
            t2 = t.reshape(-1, d)
            z = F.layer_norm(t2, (d,), ln_s, ln_b, EPS)
            q, k, v = (heads(c) for c in torch.addmm(b_qkv, z, w_qkv).split(d, dim=-1))
            return torch.addmm(b_out, sdpa_mask(q, k, v).transpose(1, 2).reshape(-1, d),
                               w_out) + t2

        # attention work on the attended keys only (the data decide it)
        attn_flops = 4.0 * BATCH * h * n_pad * kept_keys * hd
        weights_b = (4 * d * d + 2 * d * m + 3 * d + d + m + d) * bf
        counts, paths = rank["counts"], rank["paths"]
        split_layers = sum(p.count("split") for p in paths.values()) * len(RANK_REQUESTS)
        masked_layers = counts.get("attn_scores_pv.kmask", 0)
        src = "peekvit_torch/"
        # name, source, replaces, kernel, plain, library, flops, bytes, launches, calls
        timed = [
            ("attn_scores_pv.kmask", src + "csrc/attn_scores_pv.cu",
             f"{REPLACES}:46 _attn_scores_pv with kmask (:80-97), in _layer_kernel mode "
             "'keymasked' :616 and _keymasked_attn_kernel :494",
             lambda: fa.attn_scores_pv(qkv, h, kmask=km),
             lambda: fa.attn_scores_pv_ref(qkv, h, kmask=km),
             lambda: sdpa_mask(sq, sk, sv), attn_flops,
             BATCH * n_pad * (3 * d + d + 1) * bf, masked_layers, masked_layers),
            ("keymasked_layer_block_folded", src + "ops/cuda/fused_attention.py",
             f"{REPLACES}:887 keymasked_layer_block_folded (_merged_call :737, _layer_kernel "
             "mode 'keymasked' :616)",
             lambda: fa.keymasked_layer_block_folded(x, km3, w_qkv, b_qkv, w_out, b_out, w1, b1,
                                                     w2, b2, h, EPS),
             lambda: fa.keymasked_layer_block_folded_ref(x, km3, w_qkv, b_qkv, w_out, b_out, w1,
                                                         b1, w2, b2, h, EPS),
             lambda: layer_lib(x),
             2.0 * rows_p * (4 * d * d + 2 * d * m) + attn_flops,
             2 * rows_p * d * bf + BATCH * n_pad * bf + weights_b,
             7 * masked_layers, masked_layers),
            ("fused_mlp_block", src + "ops/cuda/fused_attention.py",
             f"{REPLACES}:352 fused_mlp_block (_mlp_block_kernel :317)",
             lambda: fa.fused_mlp_block(xs, ln_s, ln_b, w1, b1, w2, b2, EPS),
             lambda: fa.fused_mlp_block_ref(xs, ln_s, ln_b, w1, b1, w2, b2, EPS),
             lambda: mlp_lib(xs), 4.0 * rows_s * d * m,
             2 * rows_s * d * bf + (2 * d * m + m + 3 * d) * bf, 3 * split_layers,
             split_layers),
        ]
        entries = []
        for name, source, replaces, kfn, pfn, lfn, flops, nbytes, launches, calls in timed:
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            kernel_ms[name] = ms
            plain_ms = cuda_ms(torch, pfn, iters=5)
            lib_ms = cuda_ms(torch, lfn)
            bnd, by = bound_ms(flops, nbytes)
            if launches == 0:
                raise AssertionError(f"{name}: never launched on the RankViT path")
            entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, "max_abs_err": checks[name], "ms": ms,
                     "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                     "library_ms": lib_ms, "path": "rankvit", "shape_batch": BATCH}
            emit({"phase": "timing_kernel", **entry, "share_of_bound": bnd / ms,
                  "calls_on_path": calls,
                  "note": None if name == "attn_scores_pv.kmask" else
                  "a composition of the port's kernels; launches = its kernel launches on "
                  "the path; library = the same function from PyTorch calls",
                  "card": smi})
            entries.append(entry)
        # site 7: tests reach it, the engine does not; its four kernels run on the path
        def kmab():
            return fa.keymasked_attention_block(x, km3, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, h,
                                                EPS)

        ms = cuda_ms(torch, kmab)
        bnd, by = bound_ms(2.0 * rows_p * 4 * d * d + attn_flops,
                           2 * rows_p * d * bf + BATCH * n_pad * bf + (4 * d * d + 6 * d) * bf)
        emit({"phase": "timing_composition", "name": "keymasked_attention_block", "ms": ms,
              "device_ms": graph_ms(torch, kmab),
              "plain_ms": cuda_ms(torch, lambda: fa.keymasked_attention_block_ref(
                  x, km3, ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, h, EPS), iters=5),
              "library_ms": cuda_ms(torch, lambda: attn_block_lib(x)), "bound_ms": bnd,
              "bound_by": by, "max_abs_err": checks["keymasked_attention_block"],
              "launches_on_path": 0, "tokens": n_pad, "batch": BATCH,
              "replaces": f"{REPLACES}:548 keymasked_attention_block (_keymasked_attn_kernel "
                          ":494)", "card": smi})
        profile_step(torch, smi, lambda: engines["exact"](images, budget=RANK_PROFILE_BUDGET),
                     forward_ms[("exact", RANK_PROFILE_BUDGET)], phase="profile_rank_forward")
    return entries


# ------------------------------------------------------------------ int8 (w8a8)

REPLACES_Q = "peekvit_tpu/ops/pallas/quant_blocks.py"
QUANT_REQUESTS = (8, 256)
QUANT_CALIB = 32  # calibration images, bench.py:213-250's recipe
QUANT_RANK_EXACT = (0.25, 0.5, 1.0)
QUANT_RANK_MAX_BUDGET = 0.75
QUANT_RANK_PADDED = (0.25, 0.5)
QUANT_RUNS = ([("vit", None), ("vit_static", None)]
              + [("rank", b) for b in QUANT_RANK_EXACT]
              + [("rank_padded", b) for b in QUANT_RANK_PADDED])
# static caps for the kernel checks: ((attn LN, attn out), (mlp LN, gelu h))
QUANT_CAPS = ((4.0, 1.5), (4.0, 2.5))
QUANT_ROWS_KEYS = ("quant_rows.ln.bf16", "quant_rows.bf16", "quant_rows.ln.f32", "quant_rows.f32")
GEMM_S8_KEYS = tuple(f"gemm_s8_epilogue.{e}" for e in ("bias", "residual_f32", "gelu_f32",
                                                       "residual"))


def quant_layer_counts(path: str, static: bool) -> dict:
    """The launches of one int8 layer: the merged layer (its key-masked
    form with ``attn_scores_pv.kmask``) or the split sublayers; nine each."""
    sfx = ".static" if static else ""
    attn = "attn_scores_pv.kmask" if path == "keymasked" else "attn_scores_pv"
    out = {attn: 1, f"quant_rows.bf16{sfx}": 1, f"quant_rows.f32{sfx}": 1,
           "gemm_s8_epilogue.bias": 1, "gemm_s8_epilogue.gelu_f32": 1}
    if path == "split":  # LN2 from the bf16 sublayer output, a bf16 residual out-proj
        out.update({f"quant_rows.ln.bf16{sfx}": 2, "gemm_s8_epilogue.residual": 2})
    else:
        out.update({f"quant_rows.ln.bf16{sfx}": 1, f"quant_rows.ln.f32{sfx}": 1,
                    "gemm_s8_epilogue.residual_f32": 1, "gemm_s8_epilogue.residual": 1})
    return out


def quant_run_counts(name: str, budget) -> dict:
    """The launches one int8 forward of a QUANT_RUNS entry makes."""
    if name.startswith("vit"):
        paths = ["merged"] * B16["num_layers"]
    else:
        paths = rank_layer_paths(budget, QUANT_RANK_MAX_BUDGET if name == "rank_padded" else None)
    total: dict = {}
    for p in paths:
        for k, v in quant_layer_counts(p, name == "vit_static").items():
            total[k] = total.get(k, 0) + v
    return total


def quant_kernel_checks(torch, F, tq, check, checks, randn, ln_s, ln_b, w_qkv, b_qkv, w_out,
                        b_out, w1, b1, w2, b2, d, h, m, smi) -> dict:
    """Phase 18: quant_rows in its four modes, dynamic and static, and the
    four s8 GEMM epilogues against their plain versions at ViT-B/16 bs256
    shapes; then quant_layer_block (N = 197, dynamic and static caps),
    quant_keymasked_layer_block (N = 148, about half the keys excluded,
    the excluded rows poisoned with NaN/Inf) and quant_attention_block +
    quant_mlp_block (N = 99). Returns the inputs phase 20 times."""
    f32 = torch.float32
    n_img = (B16["image_size"] // B16["patch_size"]) ** 2
    rows = BATCH * (1 + n_img)
    ins = {"x": randn(rows, d, scale=1.5, shift=0.3), "attn": randn(rows, d, scale=0.5),
           "y": randn(rows, d, dtype=f32, scale=1.5, shift=0.3),
           "h": F.gelu(randn(rows, m, dtype=f32), approximate="tanh")}
    q = {}
    for name, w in (("qkv", w_qkv), ("out", w_out), ("fc1", w1), ("fc2", w2)):
        wq, sw = tq.quantize_linear(w)
        q[name] = (tq.kernel_layout(wq), sw)
    ins["q"] = q
    ln = (ln_s, ln_b)
    modes = {"quant_rows.ln.bf16": ("x", ln, QUANT_CAPS[0][0]),
             "quant_rows.bf16": ("attn", None, QUANT_CAPS[0][1]),
             "quant_rows.ln.f32": ("y", ln, QUANT_CAPS[1][0]),
             "quant_rows.f32": ("h", None, QUANT_CAPS[1][1])}
    ins["modes"] = modes
    codes = {}
    with torch.inference_mode():
        # codes may differ by 1 where v / s lies within an ulp of a .5
        # boundary: the LN's sums run in another order and rsqrtf is not
        # correctly rounded; the dynamic scale is absmax / 127 of the same
        # values, so it differs only where the row's absmax does
        for key, (src, aff, cap) in modes.items():
            for c in (None, cap):
                name = key + ("" if c is None else ".static")
                kc, ks = tq.quant_rows(ins[src], c, *(aff or (None, None)), EPS)
                pc, ps = tq.quant_rows_ref(ins[src], c, *(aff or (None, None)), EPS)
                diff = (kc.int() - pc.int()).abs()
                share = (diff > 0).float().mean().item()
                rel = ((ks - ps).abs() / ps).max().item() if c is None else abs(ks - ps) / ps
                rec = {"phase": "kernel_check", "kernel": name, "shape": list(kc.shape),
                       "max_abs_err": int(diff.max().item()), "code_mismatch_share": share,
                       "saturated_share": (kc.abs() == 127).float().mean().item(),
                       "scale_max_rel_err": rel, "tolerance": "codes within 1 on at most 1e-3 "
                       "of elements; scales within 1e-6 relative", "card": smi}
                emit(rec)
                if rec["max_abs_err"] > 1 or share > 1e-3 or rel > 1e-6:
                    raise AssertionError(f"{name}: {rec}")
                checks[name] = float(rec["max_abs_err"])
                if c is None:
                    codes[key] = (kc, ks)
        ins["codes"] = codes
        # The GEMMs: s32 sums exact on both sides; the dequant, bias and
        # residual steps are the same IEEE operations in the same order
        # (no FMA contraction in the kernel's epilogue), so fp32 outputs
        # agree bit for bit except gelu (tanhf against torch's tanh, a few
        # ulps) and bf16 outputs within one rounding: 2^-20 and 2^-7 of max.
        gemms = {"bias": ("ln.bf16", "qkv", b_qkv, None),
                 "residual_f32": ("bf16", "out", b_out, ins["x"]),
                 "gelu_f32": ("ln.f32", "fc1", b1, None),
                 "residual": ("f32", "fc2", b2, ins["y"])}
        ins["gemms"] = gemms
        for epi, (src, wname, b, res) in gemms.items():
            a, sa = codes[f"quant_rows.{src}"]
            w, sw = q[wname]
            got = tq.gemm_s8_epilogue(a, sa, w, sw, b, epi, residual=res)
            want = tq.gemm_s8_epilogue_ref(a, sa, w, sw, b, epi, residual=res)
            tol = 2.0 ** -20 if got.dtype == f32 else 2.0 ** -7
            check(f"gemm_s8_epilogue.{epi}", got, want, tol,
                  "s32 sums exact; FMA contraction off in the epilogue (__f*_rn); "
                  + ("tanhf ulps" if epi == "gelu_f32" else "same IEEE steps")
                  + ("" if got.dtype == f32 else ", bf16 output rounding"))
            emit({"phase": "gemm_s8_bits", "epilogue": epi,
                  "bit_identical_share": (got == want).float().mean().item(), "card": smi})
        a, _ = codes["quant_rows.ln.bf16"]
        s_static = tq.static_scale(QUANT_CAPS[0][0])
        check("gemm_s8_epilogue.bias.static_scale",
              tq.gemm_s8_epilogue(a, s_static, *q["qkv"], b_qkv, "bias"),
              tq.gemm_s8_epilogue_ref(a, s_static, *q["qkv"], b_qkv, "bias"), 2.0 ** -7,
              "one static row scale; bf16 output rounding")

        qw = (ln_s, ln_b, *q["qkv"], b_qkv, *q["out"], b_out, ln_s, ln_b, *q["fc1"], b1,
              *q["fc2"], b2)
        ins["qw"] = qw
        reason = ("nine launches; bf16 roundings of qkv and the attention output flipped by "
                  "fp32 sums in another order, requantized; the bf16 kernel tolerance "
                  "(tests/test_pallas.py:42)")
        x197 = randn(BATCH, 1 + n_img, d, scale=1.5, shift=0.3)
        ins["x197"] = x197
        for caps in (None, QUANT_CAPS):
            check("quant_layer_block" + ("" if caps is None else ".static"),
                  tq.quant_layer_block(x197, *qw, h, EPS, caps=caps),
                  tq.quant_layer_block_ref(x197, *qw, h, EPS, caps=caps), 3e-2, reason)
        n_pad, n_split = 1 + math.ceil(n_img * RANK_MAX_BUDGET), 1 + math.ceil(n_img * 0.5)
        keep = randn(BATCH, n_pad, dtype=f32) > 0.0
        keep[:, 0] = True
        km3 = keep.to(torch.bfloat16)[:, None, :]
        x148 = randn(BATCH, n_pad, d, scale=1.5, shift=0.3)
        bad = x148.clone()
        rows_bad = (~keep).nonzero()
        bad[rows_bad[:, 0], rows_bad[:, 1]] = torch.where(
            rows_bad[:, 1] % 2 == 0, float("nan"), float("inf")).to(bad.dtype)[:, None]
        got = tq.quant_keymasked_layer_block(bad, km3, *qw, h, EPS)
        check("quant_keymasked_layer_block", got[keep],
              tq.quant_keymasked_layer_block_ref(bad, km3, *qw, h, EPS)[keep], 3e-2,
              f"valid rows of {int(keep.sum())} with {int((~keep).sum())} excluded rows "
              f"poisoned with NaN/Inf; {reason}")
        unchanged = torch.equal(got[keep],
                                tq.quant_keymasked_layer_block(x148, km3, *qw, h, EPS)[keep])
        emit({"phase": "kmask_inert", "kernel": "quant_keymasked_layer_block", "tokens": n_pad,
              "excluded_rows": int((~keep).sum()), "valid_rows": int(keep.sum()),
              "valid_rows_bit_identical_to_clean_input": unchanged, "card": smi})
        if not unchanged:
            raise AssertionError("quant_keymasked_layer_block: garbage in excluded rows "
                                 "changed a valid row")
        ins.update(x148=x148, km3=km3, kept_keys=keep.float().sum(1).mean().item())
        x99 = randn(BATCH, n_split, d, scale=1.5, shift=0.3)
        ins["x99"] = x99
        check("quant_attention_block", tq.quant_attention_block(x99, *qw[:8], h, EPS),
              tq.quant_attention_block_ref(x99, *qw[:8], h, EPS), 3e-2,
              "five launches; " + reason)
        check("quant_mlp_block", tq.quant_mlp_block(x99, *qw[8:], EPS),
              tq.quant_mlp_block_ref(x99, *qw[8:], EPS), 2.0 ** -6,
              "four launches; no attention: codes flipped by LN sums in another order")
        torch.cuda.synchronize()
    return ins


def quant_phases(torch, fa, dev, smi) -> dict:
    """Phase 19: int8 serving of ViT-B/16 (dynamic, and SmoothQuant +
    static caps from 32 seeded calibration images) and RankViT-B/16
    (exact drop at 0.25/0.5/1.0, max_budget=0.75 at 0.25/0.5) at 8 and 256
    images; counts zeroed before and read after each forward (108 launches,
    the expected keys); logits against each path's plain twin (the RankViT
    twins fed the engine's kept indices); top-1 agreement with the bf16
    engine reported."""
    from peekvit_torch import InferenceEngine, build_model
    from peekvit_torch.inference import (
        rankvit_forward_padded_quant,
        rankvit_forward_padded_quant_plain,
        rankvit_forward_quant,
        rankvit_forward_quant_plain,
        vit_forward_quant_plain,
    )

    bf16 = torch.bfloat16
    cpu_gen = torch.Generator().manual_seed(1)
    models = {"vit": build_model("vit", B16, seed=0, device=DEVICE),
              "rank": build_model("rankvit", RANKVIT_B16, seed=0, device=DEVICE)}
    with torch.no_grad():  # zero-initialised head and class token: re-drawn as in phase 4
        for model in models.values():
            model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
            model.class_tokens.copy_(torch.randn(model.class_tokens.shape,
                                                 generator=cpu_gen) * 0.02)
    img_gen = torch.Generator(device=dev).manual_seed(7)
    size = B16["image_size"]
    calib = torch.randn(QUANT_CALIB, size, size, 3, generator=img_gen, device=dev)
    requests = [torch.randn(b, size, size, 3, generator=img_gen, device=dev)
                for b in QUANT_REQUESTS]
    t0 = time.perf_counter()
    engines = {"vit": InferenceEngine(models["vit"], device=DEVICE, quantized=True)}
    t1 = time.perf_counter()
    engines["vit_static"] = InferenceEngine(models["vit"], device=DEVICE, quantized=True,
                                            calib_images=calib, calib_static_caps=True)
    t2 = time.perf_counter()
    engines["rank"] = InferenceEngine(models["rank"], device=DEVICE, quantized=True)
    engines["rank_padded"] = InferenceEngine(models["rank"], device=DEVICE, quantized=True,
                                             max_budget=QUANT_RANK_MAX_BUDGET)
    emit({"phase": "int8_build", "quantize_s": t1 - t0, "calibrate_and_quantize_s": t2 - t1,
          "calib_images": QUANT_CALIB, "caps_layer0": engines["vit_static"].caps[0],
          "card": smi})
    bf16_engines = {"vit": InferenceEngine(models["vit"], device=DEVICE),
                    "rank": InferenceEngine(models["rank"], device=DEVICE),
                    "rank_padded": InferenceEngine(models["rank"], device=DEVICE,
                                                   max_budget=QUANT_RANK_MAX_BUDGET)}

    def call(name, images, budget, **kw):
        e = engines[name]
        if name.startswith("vit"):
            return e(images)
        if name == "rank":
            return rankvit_forward_quant(e.params, images, budget=budget, **e._forward, **kw)
        return rankvit_forward_padded_quant(e.params, images, budget,
                                            max_budget=QUANT_RANK_MAX_BUDGET, **e._forward, **kw)

    def plain(name, images, budget, kept):
        e = engines[name]
        fwd = dict(e._forward, compute_dtype=bf16)
        if name.startswith("vit"):
            return vit_forward_quant_plain(e.params, images, caps=e.caps, **fwd)
        if name == "rank":
            return rankvit_forward_quant_plain(e.params, images, budget=budget, kept_idx=kept,
                                               **fwd)
        return rankvit_forward_padded_quant_plain(e.params, images, budget,
                                                  max_budget=QUANT_RANK_MAX_BUDGET,
                                                  kept_idx=kept, **fwd)

    totals: dict = {}
    per_forward = []
    outputs = {}
    layers = B16["num_layers"]
    with torch.inference_mode():
        for images in requests:
            b = images.shape[0]
            for name, budget in QUANT_RUNS:
                kept = {}
                if name.startswith("vit"):
                    got, counts = counted(torch, fa, lambda: engines[name](images))
                else:
                    got, counts = counted(torch, fa, lambda: engines[name](images, budget=budget))
                    again = call(name, images, budget, kept_out=kept)
                    if not torch.equal(again, got):
                        raise AssertionError(f"int8 {name} {budget}: a second forward differs")
                want_counts = quant_run_counts(name, budget)
                per_forward.append(sum(counts.values()))
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                if counts != want_counts or sum(counts.values()) != 9 * layers:
                    raise AssertionError(f"int8 {name} {budget}: launches {counts}, want "
                                         f"{want_counts}")
                outputs[(b, name, budget)] = got
                if got.shape != (b, B16["num_classes"]):
                    raise AssertionError(f"int8 {name}: output shape {tuple(got.shape)}")
                ref = plain(name, images, budget, kept)
                rec = compare_logits(torch, f"int8 {name} b{b} budget {budget}", got,
                                     [("plain_bf16", ref, 0.0, 5e-2 * ref.abs().max().item())])
                base = bf16_engines["vit" if name.startswith("vit") else name]
                bf = base(images) if name.startswith("vit") else base(images, budget=budget)
                emit({"phase": "int8_check", "path": name, "batch": b, "budget": budget,
                      "launches": sum(counts.values()), "counts": counts, **rec,
                      "top1_agreement_with_bf16_engine":
                          (got.argmax(-1) == bf.argmax(-1)).float().mean().item(),
                      "max_abs_delta_vs_bf16_engine": (got - bf).abs().max().item(),
                      "tolerance_reason": "the plain twin on the same int8 tree (the RankViT "
                      "twins fed the engine's kept indices): same rounding points, sums in "
                      "another order; a flipped bf16 rounding of qkv or the attention output "
                      "is requantized (it can move a row's scale and every code of the row) "
                      "and runs on through 12 layers: 5e-2 of max|logit|, not of each logit "
                      "(the port against the JAX int8 engine on the CPU: up to 3.1% of max from "
                      "the same flips, tests/test_torch_quant_engine.py). The bf16 engine: "
                      "reported only (random weights)", "card": smi})
    new_keys = (QUANT_ROWS_KEYS + tuple(k + ".static" for k in QUANT_ROWS_KEYS) + GEMM_S8_KEYS
                + ("attn_scores_pv", "attn_scores_pv.kmask"))
    emit({"phase": "int8_launches", "per_forward": per_forward, "counts": totals,
          "requests": list(QUANT_REQUESTS), "runs": [list(r) for r in QUANT_RUNS], "card": smi})
    missing = [k for k in new_keys if not totals.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the int8 paths: {missing}")
    return {"models": models, "engines": engines, "bf16_engines": bf16_engines,
            "images": requests[-1], "counts": totals}


def quant_timing(torch, F, tq, smi, checks, ins, quant, d, h, m) -> list:
    """Phase 20 at bs256: each int8 path's ms per forward beside the bf16
    engine's (images/s, share of the int8 and of the bf16 peak), each new
    kernel's time, launches, bound, plain time and library yardstick, the
    merged int8 layer's time, one profiled ViT int8 forward. Returns the
    JSON entries."""
    from peekvit_torch.inference import rank_schedule
    from peekvit_torch.utils.flops_count import analytic_macs

    engines, bf16_engines, images = quant["engines"], quant["bf16_engines"], quant["images"]
    n_img = (B16["image_size"] // B16["patch_size"]) ** 2
    ranked = tuple(RANKVIT_B16["rankvit_layers"])
    forward_ms = {}
    with torch.inference_mode():
        for name, budget in QUANT_RUNS:
            kw = {} if name.startswith("vit") else {"budget": budget}
            ms = cuda_ms(torch, lambda: engines[name](images, **kw), iters=10)
            base = bf16_engines["vit" if name.startswith("vit") else name]
            bf_ms = cuda_ms(torch, lambda: base(images, **kw), iters=10)
            forward_ms[(name, budget)] = ms
            model = quant["models"]["vit" if name.startswith("vit") else "rank"]
            if name.startswith("vit"):
                flops = 2.0 * analytic_macs(model)
            else:
                schedule = rank_schedule(n_img, ranked, budget, QUANT_RANK_MAX_BUDGET
                                         if name == "rank_padded" else None)
                flops = 2.0 * analytic_macs(model, _schedule_masks(torch, schedule, n_img, 0))
            rate = flops * BATCH / (ms / 1e3)
            emit({"phase": "timing_int8", "path": name, "batch": BATCH, "budget": budget,
                  "ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
                  "bf16_engine_ms_per_forward": bf_ms, "int8_over_bf16_time": ms / bf_ms,
                  "flops_per_image_run": flops, "share_of_int8_peak": rate / PEAK_INT8_OPS,
                  "share_of_bf16_peak": rate / PEAK_BF16_FLOPS,
                  "note": "FLOPs of every matmul (int8 GEMMs and the bf16 attention) over one "
                          "peak: the int8 peak (1,979 TOP/s) and the bf16 peak (989 TFLOP/s)",
                  "card": smi})

        rows = ins["x"].shape[0]
        codes, q, gemms, modes = ins["codes"], ins["q"], ins["gemms"], ins["modes"]
        counts = quant["counts"]
        entries = []

        def entry(name, source, replaces, kfn, pfn, lfn, ops, peak, nbytes, library):
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=5)
            lib_ms = cuda_ms(torch, lfn)
            t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            bnd, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
            launches = counts.get(name, 0)
            if launches == 0:
                raise AssertionError(f"{name}: never launched on the int8 paths")
            e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": checks[name], "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                 "path": "int8", "shape_batch": BATCH}
            emit({"phase": "timing_kernel", **e, "share_of_bound": bnd / ms, "library": library,
                  "card": smi})
            entries.append(e)

        def lib_quant(t, aff, cap):
            v = t.float() if aff is None else F.layer_norm(
                t.float(), (t.shape[-1],), aff[0].float(), aff[1].float(), EPS)
            s = (v.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12) if cap is None \
                else tq.static_scale(cap)
            return torch.round(v / s).clamp(-127, 127).to(torch.int8), s

        for key, (src, aff, cap) in modes.items():
            t = ins[src]
            width = t.shape[-1]
            for c in (None, cap):
                name = key + ("" if c is None else ".static")
                nbytes = rows * width * (t.element_size() + 1) + (0 if c else rows * 4) + (
                    4 * width if aff else 0)
                entry(name, "peekvit_torch/csrc/quant_rows.cu",
                      f"{REPLACES_Q}:42 _quant_rows" + (" after :73 _ln_f32" if aff else "")
                      + " (in _q_layer_kernel :359)",
                      lambda t=t, aff=aff, c=c: tq.quant_rows(t, c, *(aff or (None, None)), EPS),
                      lambda t=t, aff=aff, c=c: tq.quant_rows_ref(t, c, *(aff or (None, None)),
                                                                  EPS),
                      lambda t=t, aff=aff, c=c: lib_quant(t, aff, c),
                      (12 if aff else 4) * rows * width, PEAK_FP32_FLOPS, nbytes,
                      ("F.layer_norm + " if aff else "") + "amax, round, clamp")
        for epi, (src, wname, b, res) in gemms.items():
            a, sa = codes[f"quant_rows.{src}"]
            w, sw = q[wname]
            kk, nn_ = w.shape
            out_b = 4 if epi in ("gelu_f32", "residual_f32") else 2
            res_b = 0 if res is None else res.element_size()

            w_lib = int_mm_operand(torch, a, w)

            def lib(a=a, sa=sa, w=w_lib, sw=sw, b=b, res=res, epi=epi):
                v = torch._int_mm(a, w).float() * sa * sw + b.float()
                if epi == "gelu_f32":
                    return F.gelu(v, approximate="tanh")
                if res is not None:
                    v = v + res.float()
                return v if epi == "residual_f32" else v.to(torch.bfloat16)

            entry(f"gemm_s8_epilogue.{epi}", "peekvit_torch/csrc/gemm_s8_epilogue.cu",
                  f"{REPLACES_Q}:63 _qmatmul and its epilogue in _q_layer_kernel :359",
                  lambda a=a, sa=sa, w=w, sw=sw, b=b, res=res, epi=epi:
                      tq.gemm_s8_epilogue(a, sa, w, sw, b, epi, residual=res),
                  lambda a=a, sa=sa, w=w, sw=sw, b=b, res=res, epi=epi:
                      tq.gemm_s8_epilogue_ref(a, sa, w, sw, b, epi, residual=res),
                  lib, 2.0 * rows * kk * nn_, PEAK_INT8_OPS,
                  rows * kk + kk * nn_ + rows * 4 + nn_ * 6 + rows * nn_ * (out_b + res_b),
                  "torch._int_mm + the dequant and epilogue in torch ops")
        qw, x197 = ins["qw"], ins["x197"]
        ms = cuda_ms(torch, lambda: tq.quant_layer_block(x197, *qw, h, EPS))
        dev_ms = graph_ms(torch, lambda: tq.quant_layer_block(x197, *qw, h, EPS))
        wbytes = 4 * d * d + 2 * d * m
        t_ops = 2.0 * rows * (4 * d * d + 2 * d * m) / PEAK_INT8_OPS * 1e3
        t_attn = 4.0 * rows * (1 + n_img) * d / PEAK_BF16_FLOPS * 1e3
        wlib = int_mm_weights(torch, ins)
        emit({"phase": "timing_composition", "name": "quant_layer_block", "ms": ms,
              "device_ms": dev_ms,
              "plain_ms": cuda_ms(torch, lambda: tq.quant_layer_block_ref(x197, *qw, h, EPS),
                                  iters=3),
              "library_ms": cuda_ms(torch, lambda: library_quant_layer(torch, F, x197, None, qw,
                                                                       h, EPS, wlib)),
              "library": "the layer from PyTorch calls: F.layer_norm, amax/round/clamp, "
                         "torch._int_mm + dequant, SDPA (dynamic scales)",
              "launches_per_call": 9, "tokens": 1 + n_img, "batch": BATCH,
              "int8_ops_ms_bound": t_ops, "attention_ops_ms_bound": t_attn,
              "weight_bytes": wbytes, "max_abs_err": checks["quant_layer_block"],
              "replaces": f"{REPLACES_Q}:465 quant_layer_block (_q_layer_call :424, "
                          "_q_layer_kernel :359)", "card": smi})
        profile_step(torch, smi, lambda: engines["vit"](images), forward_ms[("vit", None)],
                     phase="profile_int8_forward")
    return entries


# -------------------------------------------- ResidualViT int8 and A-ViT (21-24)

RESIDUAL_INT8_RUNS = [(name, b) for name in ("dynamic", "static") for b in BUDGETS]
RESIDUAL_INT8_PROFILE = ("dynamic", COMPACT_BUDGET)
# configs/model/avit_s_16_224.yaml at image 224 and 1000 classes; "mixed"
# is the setting of tests/test_inference.py:388, where tokens halt at
# mixed depths (with random weights and the config's gates no token
# halts before the last layer)
AVIT_S16 = dict(image_size=224, patch_size=16, num_layers=12, num_heads=6, hidden_dim=384,
                mlp_dim=1536, num_classes=1000)
AVIT_GATES = {"config": (10.0, 30.0), "mixed": (5.0, 0.0)}
AVIT_REQUESTS = (8, 256)
AVIT_PER_LAYER = {"norm_rows.avit.bf16": 1, "norm_rows.avit.f32": 1,
                  "gemm_bias_epilogue.bias": 1, "attn_scores_pv": 1,
                  "gemm_bias_epilogue.residual_f32": 1, "gemm_bias_epilogue.gelu": 1,
                  "gemm_bias_epilogue.residual": 1}
RQ_ROWS_KEYS = ("quant_rows.ln.bf16.masked", "quant_rows.ln.bf16.static.masked",
                "quant_rows.ln.f32.masked", "quant_rows.ln.f32.static.masked")


def residual_int8_layer_counts(static: bool) -> dict:
    """The nine launches of one merged int8 ResidualViT layer."""
    sfx = ".static" if static else ""
    return {f"quant_rows.ln.bf16{sfx}.masked": 1, f"quant_rows.bf16{sfx}": 1,
            f"quant_rows.ln.f32{sfx}.masked": 1, f"quant_rows.f32{sfx}": 1,
            "gemm_s8_epilogue.bias": 1, "gemm_s8_epilogue.masked_residual_f32": 1,
            "gemm_s8_epilogue.gelu_f32": 1, "gemm_s8_epilogue.residual": 1, "attn_scores_pv": 1}


def gate_like_mask(torch, randn, rows):
    """(rows,) bf16: a third exactly 0, a third exactly 1, a third
    fractions in (0, 1), interleaved."""
    m = torch.sigmoid(randn(rows, dtype=torch.float32))
    idx = torch.arange(rows, device=m.device) % 3
    return torch.where(idx == 0, 0.0, torch.where(idx == 1, 1.0, m)).to(torch.bfloat16)


def residual_int8_kernel_checks(torch, tq, check, checks, randn, quant_ins, ln_s, ln_b, b_out,
                                d, h, smi) -> dict:
    """Phase 21: quant_rows with the row mask (LN from bf16 x and from the
    fp32 y, dynamic and static; masks of zeros, ones and fractions), the
    two masked-residual s8 epilogues, quant_masked_layer_block (N = 198,
    dynamic and static caps), quant_masked_attention_block and
    quant_masked_mlp_block (N = 107) against their plain versions at
    ResidualViT-B/16 bs256 shapes. Returns the inputs phase 24 times."""
    f32 = torch.float32
    n_exact = 1 + (RESIDUALVIT_B16["image_size"] // RESIDUALVIT_B16["patch_size"]) ** 2 + 1
    n_split = compact_geometry(COMPACT[1])[0]
    rows, rows_s = BATCH * n_exact, BATCH * n_split
    m = gate_like_mask(torch, randn, rows)
    ms = gate_like_mask(torch, randn, rows_s)
    ins = {"x": randn(rows, d, scale=1.5, shift=0.3),
           "y": randn(rows, d, dtype=f32, scale=1.5, shift=0.3), "m": m,
           "xs": randn(rows_s, d, scale=1.5, shift=0.3), "ms": ms, "rows": rows,
           "rows_s": rows_s, "n_exact": n_exact, "n_split": n_split,
           "modes": {"quant_rows.ln.bf16": ("x", QUANT_CAPS[0][0]),
                     "quant_rows.ln.f32": ("y", QUANT_CAPS[1][0])}}
    zero = m == 0
    with torch.inference_mode():
        for key, (src, cap) in ins["modes"].items():
            for c in (None, cap):
                name = key + ("" if c is None else ".static") + ".masked"
                kc, ks = tq.quant_rows(ins[src], c, ln_s, ln_b, BLOCK_EPS, mask=m)
                pc, ps = tq.quant_rows_ref(ins[src], c, ln_s, ln_b, BLOCK_EPS, mask=m)
                diff = (kc.int() - pc.int()).abs()
                share = (diff > 0).float().mean().item()
                rel = ((ks - ps).abs() / ps).max().item() if c is None else abs(ks - ps) / ps
                zero_ok = bool((kc[zero] == 0).all()) and (
                    c is not None or bool((ks[zero] == 1e-12).all()))
                rec = {"phase": "kernel_check", "kernel": name, "shape": list(kc.shape),
                       "max_abs_err": int(diff.max().item()), "code_mismatch_share": share,
                       "saturated_share": (kc.abs() == 127).float().mean().item(),
                       "scale_max_rel_err": rel, "mask": "a third 0, a third 1, a third in (0, 1)",
                       "masked_rows_zero_codes_and_floor_scale": zero_ok,
                       "tolerance": "codes within 1 on at most 1e-3 of elements; scales within "
                       "1e-6 relative; a row of mask 0: zero codes and the 1e-12 floor",
                       "card": smi}
                emit(rec)
                if rec["max_abs_err"] > 1 or share > 1e-3 or rel > 1e-6 or not zero_ok:
                    raise AssertionError(f"{name}: {rec}")
                checks[name] = float(rec["max_abs_err"])
        # the out-projections' input codes: a bf16 attention output, quantized
        ins["ac"], ins["acs"] = tq.quant_rows(randn(rows, d)), tq.quant_rows(randn(rows_s, d))
        w_out, s_out = quant_ins["q"]["out"]
        epis = {"masked_residual_f32": (ins["ac"], ins["x"], m, 2.0 ** -20),
                "masked_residual": (ins["acs"], ins["xs"], ms, 2.0 ** -7)}
        for epi, ((a, sa), res, mk, tol) in epis.items():
            got = tq.gemm_s8_epilogue(a, sa, w_out, s_out, b_out, epi, residual=res, mask=mk)
            want = tq.gemm_s8_epilogue_ref(a, sa, w_out, s_out, b_out, epi, residual=res, mask=mk)
            check(f"gemm_s8_epilogue.{epi}", got, want, tol,
                  "s32 sums exact; FMA contraction off in the epilogue (__f*_rn); the same "
                  "IEEE steps" + ("" if got.dtype == f32 else ", bf16 output rounding"))
            emit({"phase": "gemm_s8_bits", "epilogue": epi,
                  "bit_identical_share": (got == want).float().mean().item(), "card": smi})

        qw = quant_ins["qw"]
        reason = ("nine launches; bf16 roundings of qkv and the attention output flipped by "
                  "fp32 sums in another order, requantized; the bf16 kernel tolerance "
                  "(tests/test_pallas.py:42)")
        x3, m3 = ins["x"].reshape(BATCH, n_exact, d), m.reshape(BATCH, n_exact, 1)
        xs3, ms3 = ins["xs"].reshape(BATCH, n_split, d), ms.reshape(BATCH, n_split, 1)
        ins.update(x3=x3, m3=m3, xs3=xs3, ms3=ms3)
        for caps in (None, QUANT_CAPS):
            check("quant_masked_layer_block" + ("" if caps is None else ".static"),
                  tq.quant_masked_layer_block(x3, m3, *qw, h, BLOCK_EPS, caps=caps),
                  tq.quant_masked_layer_block_ref(x3, m3, *qw, h, BLOCK_EPS, caps=caps), 3e-2,
                  reason)
        check("quant_masked_attention_block",
              tq.quant_masked_attention_block(xs3, ms3, *qw[:8], h, BLOCK_EPS),
              tq.quant_masked_attention_block_ref(xs3, ms3, *qw[:8], h, BLOCK_EPS), 3e-2,
              "five launches; " + reason)
        check("quant_masked_mlp_block", tq.quant_masked_mlp_block(xs3, ms3, *qw[8:], BLOCK_EPS),
              tq.quant_masked_mlp_block_ref(xs3, ms3, *qw[8:], BLOCK_EPS), 2.0 ** -6,
              "four launches; no attention: codes flipped by LN sums in another order")
        torch.cuda.synchronize()
    return ins


def residual_int8_phases(torch, fa, tq, dev, smi, rq_ins, qw, h) -> dict:
    """Phase 22: the int8 ResidualViT-B/16 engine, dynamic and with
    SmoothQuant + static caps from 32 seeded images, at budgets 0.25, 0.5
    and 1.0 and 8 and 256 images, then one ee_outputs=True request on an
    eeresidualvit (counts zeroed before and read after each forward: 108
    launches, the expected keys), each held against
    residualvit_forward_quant_plain; top-1 agreement with the bf16
    engine; then sites 15-16 (the split sublayers, which no engine path
    takes) once through their compositions, counted."""
    from peekvit_torch import InferenceEngine
    from peekvit_torch.inference import residualvit_forward_quant_plain

    bf16 = torch.bfloat16
    layers = RESIDUALVIT_B16["num_layers"]
    model = seeded_residual_model(torch, "residualvit")
    ee_model = seeded_residual_model(torch, "eeresidualvit")
    img_gen = torch.Generator(device=dev).manual_seed(9)
    size = RESIDUALVIT_B16["image_size"]
    calib = torch.randn(QUANT_CALIB, size, size, 3, generator=img_gen, device=dev)
    requests = [torch.randn(b, size, size, 3, generator=img_gen, device=dev)
                for b in RESIDUAL_REQUESTS]
    t0 = time.perf_counter()
    engines = {"dynamic": InferenceEngine(model, device=DEVICE, quantized=True)}
    t1 = time.perf_counter()
    engines["static"] = InferenceEngine(model, device=DEVICE, quantized=True, calib_images=calib,
                                        calib_static_caps=True)
    t2 = time.perf_counter()
    bf16_engine = InferenceEngine(model, device=DEVICE)
    emit({"phase": "residual_int8_build", "quantize_s": t1 - t0,
          "calibrate_and_quantize_s": t2 - t1, "calib_images": QUANT_CALIB,
          "caps_layer0": engines["static"].caps[0], "card": smi})
    fwd = dict(patch_size=model.patch_size, num_heads=model.num_heads,
               num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
               gate_temp=model.gate_temp, gate_bias=model.gate_bias,
               budget_token=model.add_budget_token, compute_dtype=bf16)
    reason = ("the plain twin on the same int8 tree: same rounding points, sums in another "
              "order; a flipped bf16 rounding of qkv or the attention output is requantized and "
              "runs on through 12 layers: 5e-2 of max|logit|, as phase 19. The bf16 engine: "
              "reported only (random weights)")
    totals: dict = {}
    per_forward = []

    def add(counts):
        per_forward.append(sum(counts.values()))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    with torch.inference_mode():
        for images in requests:
            b = images.shape[0]
            for name, budget in RESIDUAL_INT8_RUNS:
                e = engines[name]
                got, counts = counted(torch, fa, lambda: e(images, budget=budget))
                add(counts)
                want = {k: v * layers
                        for k, v in residual_int8_layer_counts(name == "static").items()}
                if counts != want:
                    raise AssertionError(f"int8 residual {name} {budget}: launches {counts}, "
                                         f"want {want}")
                if got.shape != (b, RESIDUALVIT_B16["num_classes"]):
                    raise AssertionError(f"int8 residual: output shape {tuple(got.shape)}")
                masks = {}
                ref = residualvit_forward_quant_plain(e.params, images, budget, caps=e.caps,
                                                      masks=masks, **fwd)
                rec = compare_logits(torch, f"int8 residual {name} b{b} budget {budget}", got,
                                     [("plain_bf16", ref, 0.0, 5e-2 * ref.abs().max().item())])
                bf = bf16_engine(images, budget=budget)
                emit({"phase": "residual_int8_check", "scales": name, "batch": b,
                      "budget": budget, "launches": sum(counts.values()), "counts": counts,
                      **rec, "top1_agreement_with_bf16_engine":
                          (got.argmax(-1) == bf.argmax(-1)).float().mean().item(),
                      "max_abs_delta_vs_bf16_engine": (got - bf).abs().max().item(),
                      "kept_image_token_share_by_layer":
                          [(masks[f"layer_{i}"] > 0).float().mean().item() for i in range(layers)],
                      "tolerance_reason": reason, "card": smi})

        ee_engine = InferenceEngine(ee_model, device=DEVICE, quantized=True, ee_outputs=True)
        ee_images = requests[0][:EE_REQUEST]
        ee_out, ee_counts = counted(torch, fa, lambda: ee_engine(ee_images, budget=COMPACT_BUDGET))
        add(ee_counts)
        ee_ref = residualvit_forward_quant_plain(ee_engine.params, ee_images, COMPACT_BUDGET,
                                                 early_exits=True, **fwd)
        want = {k: v * layers for k, v in residual_int8_layer_counts(False).items()}
        if len(ee_out) != layers + 1 or ee_counts != want:
            raise AssertionError(f"int8 ee outputs {len(ee_out)}, launches {ee_counts}")
        recs = [compare_logits(torch, f"int8 ee output {i}", g,
                               [("plain_bf16", r, 0.0, 5e-2 * r.abs().max().item())])
                for i, (g, r) in enumerate(zip(ee_out, ee_ref))]
        emit({"phase": "residual_int8_ee", "batch": EE_REQUEST, "budget": COMPACT_BUDGET,
              "outputs": len(ee_out), "launches": ee_counts,
              "max_abs_delta_vs_plain_bf16": max(r["plain_bf16"]["max_abs_delta"] for r in recs),
              "tolerance_reason": reason, "card": smi})

        # sites 15-16: no engine path reaches the split int8 sublayers
        # (JAX inference.py:2075), so their compositions run once here
        def split():
            t = tq.quant_masked_attention_block(rq_ins["xs3"], rq_ins["ms3"], *qw[:8], h,
                                                BLOCK_EPS)
            return tq.quant_masked_mlp_block(t, rq_ins["ms3"], *qw[8:], BLOCK_EPS)

        out, split_counts = counted(torch, fa, split)
        if sum(split_counts.values()) != 9 or split_counts.get(
                "gemm_s8_epilogue.masked_residual") != 1 or not torch.isfinite(out).all():
            raise AssertionError(f"int8 split sublayers: launches {split_counts}")
        emit({"phase": "residual_int8_split_sublayers", "tokens": rq_ins["n_split"],
              "batch": BATCH, "launches": split_counts, "card": smi})
    emit({"phase": "residual_int8_launches", "per_forward": per_forward, "counts": totals,
          "requests": list(RESIDUAL_REQUESTS), "runs": [list(r) for r in RESIDUAL_INT8_RUNS],
          "ee_request": EE_REQUEST, "card": smi})
    if set(per_forward) != {9 * layers}:
        raise AssertionError(f"int8 residual launches per forward {per_forward}")
    missing = [k for k in RQ_ROWS_KEYS + ("gemm_s8_epilogue.masked_residual_f32",)
               if not totals.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the int8 residual path: {missing}")
    return {"model": model, "engines": engines, "bf16_engine": bf16_engine,
            "images": requests[-1], "counts": totals, "split_counts": split_counts}


def avit_phases(torch, fa, check, checks, randn, dev, smi) -> dict:
    """Phase 23: norm_rows.avit (bf16 x and fp32 y, a 0/1 and a fractional
    mask) and avit_layer_block against their plain versions at A-ViT-S/16
    bs256 shapes; then build_model("adavit", A-ViT-S/16) served at 8 and
    256 images at the config's gates and at gate_scale=5, gate_center=0
    (counts zeroed before and read after each forward: 84 launches), the
    logits against adavit_forward_plain fed the engine's halting
    decisions, each layer's active share, and how often a free-running
    plain twin picks the same depths."""
    from peekvit_torch import InferenceEngine, build_model
    from peekvit_torch.inference import adavit_forward_fused, adavit_forward_plain

    f32, bf16 = torch.float32, torch.bfloat16
    d, h, m = AVIT_S16["hidden_dim"], AVIT_S16["num_heads"], AVIT_S16["mlp_dim"]
    layers = AVIT_S16["num_layers"]
    n = (AVIT_S16["image_size"] // AVIT_S16["patch_size"]) ** 2 + 1
    rows = BATCH * n
    masks = {"binary": (randn(rows, dtype=f32) > -0.5).to(bf16),
             "fraction": torch.sigmoid(randn(rows, dtype=f32)).to(bf16)}
    ins = {"x": randn(rows, d, scale=1.5, shift=0.3),
           "y": randn(rows, d, dtype=f32, scale=1.5, shift=0.3), "masks": masks,
           "s": randn(d, scale=0.2, shift=1.0), "b": randn(d, scale=0.1), "rows": rows, "n": n,
           "w": (randn(d, scale=0.2, shift=1.0), randn(d, scale=0.1),
                 randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1),
                 randn(d, d, scale=d ** -0.5), randn(d, scale=0.1),
                 randn(d, scale=0.2, shift=1.0), randn(d, scale=0.1),
                 randn(d, m, scale=d ** -0.5), randn(m, scale=0.1),
                 randn(m, d, scale=m ** -0.5), randn(d, scale=0.1))}
    s, b = ins["s"], ins["b"]
    with torch.inference_mode():
        for src in ("x", "y"):
            key = "norm_rows.avit." + ("bf16" if src == "x" else "f32")
            for mname, a in masks.items():
                got = fa.norm_rows(ins[src], EPS, bf16, s, b, a, premask=True)
                check(f"{key}.{mname}", got,
                      fa.norm_rows_ref(ins[src], EPS, bf16, s, b, a, premask=True),
                      2.0 ** -6, "bf16 output rounding")
                if mname == "binary":  # a 0/1 mask: the masked mode's values
                    masked = fa.norm_rows(ins[src], EPS, bf16, s, b, a)
                    emit({"phase": "norm_rows_avit_vs_masked", "input": key, "mask": mname,
                          "equal_share": (got == masked).float().mean().item(), "card": smi})
                    if not torch.equal(got, masked):
                        raise AssertionError(f"{key}: a 0/1 mask differs from norm_rows.masked")
            checks[key] = max(checks[f"{key}.{mname}"] for mname in masks)
        x3 = ins["x"].reshape(BATCH, n, d)
        for mname, a in masks.items():
            a3 = a.reshape(BATCH, n, 1)
            check(f"avit_layer_block.{mname}", fa.avit_layer_block(x3 * a3, a3, *ins["w"], h, EPS),
                  fa.avit_layer_block_ref(x3 * a3, a3, *ins["w"], h, EPS), 3e-2,
                  "seven launches; bf16 roundings flipped by fp32 sums in another order, the "
                  "attention kernel's tolerance")
        ins.update(x3=x3, a3=masks["fraction"].reshape(BATCH, n, 1))
        torch.cuda.synchronize()

    cpu_gen = torch.Generator().manual_seed(1)
    engines = {}
    for gname, (gs, gc) in AVIT_GATES.items():
        model = build_model("adavit", dict(AVIT_S16, gate_scale=gs, gate_center=gc), seed=0,
                            device=DEVICE)
        with torch.no_grad():  # zero-initialised head and class token: re-drawn as in phase 4
            for p in (model.head.kernel, model.class_tokens):
                p.copy_(torch.randn(p.shape, generator=cpu_gen) * 0.02)
        engines[gname] = InferenceEngine(model, device=DEVICE)
    img_gen = torch.Generator(device=dev).manual_seed(11)
    size = AVIT_S16["image_size"]
    requests = [torch.randn(bb, size, size, 3, generator=img_gen, device=dev)
                for bb in AVIT_REQUESTS]
    totals: dict = {}
    per_forward = []
    want = {k: v * layers for k, v in AVIT_PER_LAYER.items()}
    with torch.inference_mode():
        for images in requests:
            bb = images.shape[0]
            for gname, e in engines.items():
                got, counts = counted(torch, fa, lambda: e(images))
                per_forward.append(sum(counts.values()))
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                if counts != want:
                    raise AssertionError(f"A-ViT {gname}: launches {counts}, want {want}")
                if got.shape != (bb, AVIT_S16["num_classes"]):
                    raise AssertionError(f"A-ViT: output shape {tuple(got.shape)}")
                decisions = []
                again = adavit_forward_fused(e.params, images, active_out=decisions, **e._forward)
                if not torch.equal(again, got):
                    raise AssertionError(f"A-ViT {gname}: a second forward differs")
                ref = adavit_forward_plain(e.params, images, active_in=decisions, **e._forward)
                rec = compare_logits(torch, f"A-ViT {gname} b{bb}", got,
                                     [("plain_bf16", ref, 3e-2, 3e-2)])
                free = []
                adavit_forward_plain(e.params, images, active_out=free, **e._forward)
                same = torch.ones(bb, dtype=torch.bool, device=images.device)
                for (ka, kb), (pa, pb) in zip(decisions, free):
                    same &= ((ka == pa) & (kb == pb)).all(dim=1)
                emit({"phase": "avit_check", "gates": gname,
                      "gate_scale_center": AVIT_GATES[gname], "batch": bb,
                      "launches": sum(counts.values()), "counts": counts, **rec,
                      "active_share_after_layer": [dec[1].mean().item() for dec in decisions],
                      "tokens_halted_before_last_layer": 1.0 - decisions[-2][1].mean().item(),
                      "free_running_twin_same_depths_share": same.float().mean().item(),
                      "tolerance_reason": "the plain twin fed the engine's halting decisions "
                      "(c > 1 - eps is a hard threshold; bf16 near-ties flip in a free-running "
                      "twin): same rounding points, sums in another order; the repo's bf16 "
                      "kernel tolerance (tests/test_pallas.py:42)", "card": smi})
    emit({"phase": "avit_launches", "per_forward": per_forward, "counts": totals,
          "requests": list(AVIT_REQUESTS), "gates": AVIT_GATES, "card": smi})
    missing = [k for k in AVIT_PER_LAYER if not totals.get(k)]
    if missing or set(per_forward) != {7 * layers}:
        raise AssertionError(f"A-ViT launches: missing {missing}, per forward {per_forward}")
    return {"engines": engines, "images": requests[-1], "counts": totals, "ins": ins}


def int_mm_operand(torch, a, w):
    """w in a layout torch._int_mm takes with a: as it lies if cuBLASLt
    accepts that, else a contiguous copy (for the yardsticks only)."""
    try:
        torch._int_mm(a[:32], w)
        return w
    except RuntimeError:
        return w.contiguous()


def int_mm_weights(torch, quant_ins):
    """The four int8 weights of the kernel checks' layer in a layout
    torch._int_mm takes."""
    qw, codes = quant_ins["qw"], quant_ins["codes"]
    return [int_mm_operand(torch, codes[k][0], w) for k, w in (
        ("quant_rows.ln.bf16", qw[2]), ("quant_rows.bf16", qw[5]),
        ("quant_rows.ln.f32", qw[10]), ("quant_rows.f32", qw[13]))]


def library_quant_layer(torch, F, x, mask, qw, h, eps, wlib):
    """The int8 layer (mask None: quant_layer_block; else the masked one)
    from PyTorch calls: F.layer_norm, amax/round/clamp, torch._int_mm +
    dequant, SDPA; dynamic scales. A yardstick, never called by the port."""
    ln1s, ln1b, _, sqkv, bqkv, _, so, bo, ln2s, ln2b, _, s1, b1, _, s2, b2 = qw
    wqkv, wo, w1, w2 = wlib
    bb, n, d = x.shape
    x2 = x.reshape(bb * n, d)
    m = None if mask is None else mask.reshape(-1, 1).float()

    def q(v):
        s = (v.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
        return torch.round(v / s).clamp(-127, 127).to(torch.int8), s

    def mm(a_s, w, sw, bias):
        return torch._int_mm(a_s[0], w).float() * a_s[1] * sw + bias.float()

    def ln(t, sc, bi):
        v = F.layer_norm(t.float(), (d,), sc.float(), bi.float(), eps)
        return v if m is None else v * m

    qkv = mm(q(ln(x2, ln1s, ln1b)), wqkv, sqkv, bqkv).to(torch.bfloat16)
    qh = qkv.reshape(bb, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
    attn = F.scaled_dot_product_attention(qh[0], qh[1], qh[2]).transpose(1, 2).reshape(bb * n, d)
    proj = mm(q(attn.float()), wo, so, bo)
    y = (proj if m is None else proj * m) + x2.float()
    hh = F.gelu(mm(q(ln(y, ln2s, ln2b)), w1, s1, b1), approximate="tanh")
    return (mm(q(hh), w2, s2, b2) + y).to(x.dtype).reshape(bb, n, d)


def library_avit_layer(torch, F, x, a, w, h, eps):
    """The A-ViT layer from PyTorch calls (F.layer_norm, addmm, SDPA,
    gelu): a yardstick, never called by the port."""
    ln1s, ln1b, wqkv, bqkv, wo, bo, ln2s, ln2b, w1, b1, w2, b2 = w
    bb, n, d = x.shape
    x2, am = x.reshape(bb * n, d), a.reshape(-1, 1)
    qkv = torch.addmm(bqkv, F.layer_norm(x2 * am, (d,), ln1s, ln1b, eps) * am, wqkv)
    qh = qkv.reshape(bb, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
    attn = F.scaled_dot_product_attention(qh[0], qh[1], qh[2]).transpose(1, 2).reshape(bb * n, d)
    y = torch.addmm(bo, attn, wo).float() + x2
    l2 = (F.layer_norm(y * am, (d,), ln2s.float(), ln2b.float(), eps) * am).to(x.dtype)
    hh = F.gelu(torch.addmm(b1, l2, w1), approximate="tanh")
    return (torch.addmm(b2, hh, w2) + y).to(x.dtype).reshape(bb, n, d)


def new_paths_timing(torch, F, fa, tq, smi, checks, rq_ins, rq, av, quant_ins, b_out, d, h,
                     m) -> list:
    """Phase 24 at bs256: the int8 ResidualViT at each budget beside the
    bf16 exact engine, A-ViT-S/16 at both gate settings beside a ViT-S/16
    bf16 engine of the same widths, in the same call; each new kernel
    variant's time, launches, bound, plain time and library yardstick; the
    two new compositions; one profiled forward of each path. Returns the
    new kernels' JSON entries."""
    from peekvit_torch import InferenceEngine, build_model

    bf16 = torch.bfloat16
    images = rq["images"]
    forward_ms = {}
    with torch.inference_mode():
        for name, budget in RESIDUAL_INT8_RUNS:
            ms = cuda_ms(torch, lambda: rq["engines"][name](images, budget=budget), iters=10)
            bf_ms = cuda_ms(torch, lambda: rq["bf16_engine"](images, budget=budget), iters=10)
            forward_ms[(name, budget)] = ms
            emit({"phase": "timing_residual_int8", "scales": name, "batch": BATCH,
                  "budget": budget, "ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
                  "bf16_engine_ms_per_forward": bf_ms, "bf16_images_per_s": BATCH / bf_ms * 1e3,
                  "int8_over_bf16_time": ms / bf_ms, "card": smi})
    vit_s = InferenceEngine(build_model("vit", AVIT_S16, seed=0, device=DEVICE), device=DEVICE)
    av_images = av["images"]
    with torch.inference_mode():
        vit_ms = cuda_ms(torch, lambda: vit_s(av_images), iters=10)
        for gname, e in av["engines"].items():
            ms = cuda_ms(torch, lambda: e(av_images), iters=10)
            forward_ms[gname] = ms
            emit({"phase": "timing_avit", "gates": gname, "batch": BATCH, "ms_per_forward": ms,
                  "images_per_s": BATCH / ms * 1e3, "vit_s16_bf16_ms_per_forward": vit_ms,
                  "vit_s16_images_per_s": BATCH / vit_ms * 1e3, "avit_over_vit_time": ms / vit_ms,
                  "note": "the A-ViT engine runs every layer on every token (halted tokens "
                          "masked, as the JAX engine); ViT-S/16 is the same widths unmasked",
                  "card": smi})

        rows, rows_s = rq_ins["rows"], rq_ins["rows_s"]
        m_ = rq_ins["m"]
        qw = quant_ins["qw"]
        ln_s, ln_b = qw[0], qw[1]
        w_out, s_out = quant_ins["q"]["out"]
        wlib = int_mm_weights(torch, quant_ins)
        entries = []
        src = "peekvit_torch/csrc/"

        def entry(name, source, replaces, launches, path, kfn, pfn, lfn, ops, peak, nbytes,
                  library):
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=5)
            lib_ms = cuda_ms(torch, lfn)
            t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            bnd, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
            if launches == 0:
                raise AssertionError(f"{name}: never launched on its path")
            e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": checks[name], "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                 "path": path, "shape_batch": BATCH}
            emit({"phase": "timing_kernel", **e, "share_of_bound": bnd / ms, "library": library,
                  "card": smi})
            entries.append(e)

        def lib_quant_masked(t, c):
            v = F.layer_norm(t.float(), (d,), ln_s.float(), ln_b.float(), BLOCK_EPS) * \
                m_.float()[:, None]
            s = (v.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12) if c is None \
                else tq.static_scale(c)
            return torch.round(v / s).clamp(-127, 127).to(torch.int8), s

        for key, (srcname, cap) in rq_ins["modes"].items():
            t = rq_ins[srcname]
            for c in (None, cap):
                name = key + ("" if c is None else ".static") + ".masked"
                nbytes = rows * d * (t.element_size() + 1) + (0 if c else rows * 4) + 4 * d + \
                    rows * 2
                entry(name, src + "quant_rows.cu",
                      f"{REPLACES_Q}:42 _quant_rows after :73 _ln_f32 times the row mask "
                      "(_q_layer_kernel mode masked :384-387, :411-413)",
                      rq["counts"].get(name, 0), "residual int8",
                      lambda t=t, c=c: tq.quant_rows(t, c, ln_s, ln_b, BLOCK_EPS, mask=m_),
                      lambda t=t, c=c: tq.quant_rows_ref(t, c, ln_s, ln_b, BLOCK_EPS, mask=m_),
                      lambda t=t, c=c: lib_quant_masked(t, c),
                      13.0 * rows * d, PEAK_FP32_FLOPS, nbytes,
                      "F.layer_norm * mask + amax, round, clamp")
        for epi, (a, sa), res, mk, rr, count, path in (
                ("masked_residual_f32", rq_ins["ac"], rq_ins["x"], m_, rows,
                 rq["counts"].get("gemm_s8_epilogue.masked_residual_f32", 0), "residual int8"),
                ("masked_residual", rq_ins["acs"], rq_ins["xs"], rq_ins["ms"], rows_s,
                 rq["split_counts"].get("gemm_s8_epilogue.masked_residual", 0),
                 "int8 split sublayers (sites 15-16, composition only)")):
            out_b = 4 if epi.endswith("_f32") else 2

            def lib(a=a, sa=sa, res=res, mk=mk, epi=epi):
                v = (torch._int_mm(a, wlib[1]).float() * sa * s_out + b_out.float()) * \
                    mk.float()[:, None] + res.float()
                return v if epi.endswith("_f32") else v.to(bf16)

            entry(f"gemm_s8_epilogue.{epi}", src + "gemm_s8_epilogue.cu",
                  f"{REPLACES_Q}:63 _qmatmul and the masked out-proj of "
                  + ("_q_layer_kernel :407-410" if epi.endswith("_f32")
                     else "_q_masked_attn_kernel :277-279"), count, path,
                  lambda a=a, sa=sa, res=res, mk=mk, epi=epi: tq.gemm_s8_epilogue(
                      a, sa, w_out, s_out, b_out, epi, residual=res, mask=mk),
                  lambda a=a, sa=sa, res=res, mk=mk, epi=epi: tq.gemm_s8_epilogue_ref(
                      a, sa, w_out, s_out, b_out, epi, residual=res, mask=mk),
                  lib, 2.0 * rr * d * d, PEAK_INT8_OPS,
                  rr * d + d * d + rr * 4 + d * 6 + rr * d * (out_b + 2) + rr * 2,
                  "torch._int_mm + dequant * mask + add")
        ai = av["ins"]
        a_frac = ai["masks"]["fraction"]
        for srcname, key in (("x", "norm_rows.avit.bf16"), ("y", "norm_rows.avit.f32")):
            t = ai[srcname]
            width = t.shape[-1]
            entry(key, src + "norm_rows.cu",
                  f"{REPLACES}:578 _ln_f32_rows(x * a) * a in _layer_kernel mode avit :671-672, "
                  ":704-705", av["counts"].get(key, 0), "avit",
                  lambda t=t: fa.norm_rows(t, EPS, bf16, ai["s"], ai["b"], a_frac, premask=True),
                  lambda t=t: fa.norm_rows_ref(t, EPS, bf16, ai["s"], ai["b"], a_frac,
                                               premask=True),
                  lambda t=t: (F.layer_norm(t * a_frac[:, None].to(t.dtype), (width,),
                                            ai["s"].to(t.dtype), ai["b"].to(t.dtype), EPS)
                               * a_frac[:, None]).to(bf16),
                  10.0 * ai["rows"] * width, PEAK_FP32_FLOPS,
                  ai["rows"] * width * (t.element_size() + 2) + 4 * width + ai["rows"] * 2,
                  "F.layer_norm(x * a) * a")

        # the two new compositions beside the layer from PyTorch calls
        x3, m3 = rq_ins["x3"], rq_ins["m3"]
        n_tok = x3.shape[1]
        rr = BATCH * n_tok
        t_ops = 2.0 * rr * (4 * d * d + 2 * d * m) / PEAK_INT8_OPS * 1e3
        t_attn = 4.0 * rr * n_tok * d / PEAK_BF16_FLOPS * 1e3
        emit({"phase": "timing_composition", "name": "quant_masked_layer_block",
              "ms": cuda_ms(torch, lambda: tq.quant_masked_layer_block(x3, m3, *qw, h, BLOCK_EPS)),
              "device_ms": graph_ms(
                  torch, lambda: tq.quant_masked_layer_block(x3, m3, *qw, h, BLOCK_EPS)),
              "plain_ms": cuda_ms(torch, lambda: tq.quant_masked_layer_block_ref(
                  x3, m3, *qw, h, BLOCK_EPS), iters=3),
              "library_ms": cuda_ms(torch, lambda: library_quant_layer(
                  torch, F, x3, m3, qw, h, BLOCK_EPS, wlib)),
              "library": "the layer from PyTorch calls: F.layer_norm * mask, amax/round/clamp, "
                         "torch._int_mm + dequant, SDPA (dynamic scales)",
              "launches_per_call": 9, "tokens": n_tok, "batch": BATCH,
              "int8_ops_ms_bound": t_ops, "attention_ops_ms_bound": t_attn,
              "bound_ms": t_ops + t_attn, "max_abs_err": checks["quant_masked_layer_block"],
              "replaces": f"{REPLACES_Q}:480 quant_masked_layer_block (_q_layer_kernel mode "
                          "masked :359)", "card": smi})
        h_av, d_av, m_av, n_av = (AVIT_S16["num_heads"], AVIT_S16["hidden_dim"],
                                  AVIT_S16["mlp_dim"], ai["n"])
        rr = BATCH * n_av
        flops = 2.0 * rr * (4 * d_av * d_av + 2 * d_av * m_av + 2 * n_av * d_av)
        emit({"phase": "timing_composition", "name": "avit_layer_block",
              "ms": cuda_ms(torch, lambda: fa.avit_layer_block(ai["x3"], ai["a3"], *ai["w"],
                                                               h_av, EPS)),
              "plain_ms": cuda_ms(torch, lambda: fa.avit_layer_block_ref(
                  ai["x3"], ai["a3"], *ai["w"], h_av, EPS), iters=3),
              "library_ms": cuda_ms(torch, lambda: library_avit_layer(
                  torch, F, ai["x3"], ai["a3"], ai["w"], h_av, EPS)),
              "library": "the layer from PyTorch calls: F.layer_norm(x * a) * a, addmm, SDPA, "
                         "gelu", "launches_per_call": 7, "tokens": n_av, "batch": BATCH,
              "bound_ms": flops / PEAK_BF16_FLOPS * 1e3, "bound_by": "operations",
              "max_abs_err": checks["avit_layer_block.fraction"],
              "replaces": f"{REPLACES}:904 avit_layer_block (_layer_kernel mode avit :616)",
              "card": smi})
        profile_step(torch, smi, lambda: rq["engines"][RESIDUAL_INT8_PROFILE[0]](
            images, budget=RESIDUAL_INT8_PROFILE[1]), forward_ms[RESIDUAL_INT8_PROFILE],
                     phase="profile_residual_int8_forward")
        profile_step(torch, smi, lambda: av["engines"]["mixed"](av_images), forward_ms["mixed"],
                     phase="profile_avit_forward")
    return entries


# ------------------------------------------------------------ PCT / RankPCT (25-27)

REPLACES_PCT = "peekvit_tpu/ops/pallas/pct_embed.py"
# configs/model/pct.yaml and rankpct.yaml at configs/dataset/modelnet40.yaml's
# 1024 points and 40 classes: full width and depth, seeded weights and
# BatchNorm statistics, synthetic clouds (ModelNet40 is not in the repo)
PCT_M40 = dict(num_points=1024, num_layers=4, num_heads=4, hidden_dim=128, mlp_dim=512,
               num_classes=40)
PCT_BATCH = 128
PCT_REQUESTS = (8, 128)
PCT_BUDGETS = (0.25, 0.5, 1.0, None)
PCT_PROFILE_BUDGET = 0.5
PCT_TIE_CLOUDS = 8      # clouds of each bs128 batch built with duplicated points
PCT_PER_LAYER = {"norm_rows.bf16": 1, "norm_rows.f32": 1, "gemm_bias_epilogue.bias": 1,
                 "attn_scores_pv.hd32": 1, "gemm_bias_epilogue.residual_f32": 1,
                 "gemm_bias_epilogue.gelu": 1, "gemm_bias_epilogue.residual": 1}
PCT_FORWARD_COUNTS = dict({k: v * PCT_M40["num_layers"] for k, v in PCT_PER_LAYER.items()},
                          arpe_tokens=1)
SFU_PER_S = 132 * 16 * 1.98e9  # H100 SXM: 16 MUFU results per SM and cycle, boost clock
# fp32 operations of csrc/arpe_tokens.cu (its note): per pair d2 8, the row
# max 1, the histogram pass 5, the compaction 5, the neighbour test 1; per
# neighbour the 6 maxima; per row the 30 replayed steps of 3, c_i, the
# elus and lin2 (120 + 15 d). The counting bisection it replaced did 78 a
# pair (31 counts of a compare and an add, the masked max's 7).
ARPE_OPS_PER_PAIR, ARPE_OPS_PER_NEIGHBOUR, ARPE_OPS_PER_ROW = 20, 6, 90 + 120
BISECTION_OPS_PER_PAIR, BISECTION_OPS_PER_ROW = 78, 120


def surface_clouds(torch, gen, b: int, n: int, dev, ties: int = 0):
    """(b, n, 3) clouds sampled on the surfaces of simple shapes (sphere,
    box, cylinder, torus, one per cloud in turn), each scaled per axis,
    rotated and normalised into the unit ball, as ModelNet40's clouds are.
    The last ``ties`` clouds repeat each point three times, so that about
    every row has points tied at its k-th distance."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    two_pi = 2.0 * math.pi
    g = torch.randn(b, n, 3, generator=gen, device=dev)
    sphere = g / g.norm(dim=-1, keepdim=True)
    face = torch.randint(0, 6, (b, n), generator=gen, device=dev)
    box = u(b, n, 3) * 2.0 - 1.0
    axis = (face // 2)[..., None] == torch.arange(3, device=dev)
    box = torch.where(axis, (face % 2 * 2 - 1).float()[..., None], box)
    th, z = u(b, n) * two_pi, u(b, n) * 2.0 - 1.0
    cylinder = torch.stack([th.cos(), th.sin(), z], dim=-1)
    uu, vv = u(b, n) * two_pi, u(b, n) * two_pi
    ring = 1.0 + 0.35 * vv.cos()
    torus = torch.stack([ring * uu.cos(), ring * uu.sin(), 0.35 * vv.sin()], dim=-1)
    kind = (torch.arange(b, device=dev) % 4)[:, None, None]
    pts = torch.where(kind == 0, sphere, torch.where(kind == 1, box,
                                                     torch.where(kind == 2, cylinder, torus)))
    rot = torch.linalg.qr(torch.randn(b, 3, 3, generator=gen, device=dev)).Q
    pts = (pts * (0.5 + u(b, 1, 3))) @ rot
    pts = pts - pts.mean(dim=1, keepdim=True)
    pts = pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]
    if ties:
        pts[-ties:] = pts[-ties:, :(n + 2) // 3].repeat_interleave(3, dim=1)[:, :n]
    return pts.contiguous()


def seeded_pct_model(torch, name: str):
    """build_model(name, PCT_M40, seed=0) on the card with its BatchNorm
    running statistics seeded away from (0, 1) (mean ~ N(0, 0.3), var in
    [0.5, 2]), so that the engine's folds are exercised; RankPCT with
    ranking on every layer."""
    from peekvit_torch import build_model

    model = build_model(name, PCT_M40, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for key, buf in model.named_buffers():
            new = (torch.randn(buf.shape, generator=cpu_gen) * 0.3 if key.endswith(".mean")
                   else 0.5 + 1.5 * torch.rand(buf.shape, generator=cpu_gen))
            buf.copy_(new)
    if name == "rankpct":
        model.enable_ranking(True)
    return model


def pct_kernel_checks(torch, fa, check, checks, dev, smi) -> dict:
    """Phase 25 at ModelNet40 bs128 shapes: arpe_tokens against
    arpe_tokens_ref (the engine's BN-folded pack; every row's kNN threshold
    bit-equal and its neighbour count equal, fp32 and bf16 tokens), with
    8 of the 128 clouds holding tied points; attn_scores_pv at head dim 32
    against its plain version at N = 1024 (and with logits at the clamp:
    1024 terms of 2^115 stay finite) and at N = 64; fused_layer_block_folded
    at D = 128, H = 4, N = 1024 with the engine's layer-0 weights. Returns
    the engines and the inputs phases 26-27 use."""
    from peekvit_torch import InferenceEngine
    from peekvit_torch.ops.cuda import pct_embed as tpe
    from peekvit_torch.models.adapters import module_state
    from peekvit_torch.inference import prepare_pct_engine_params

    bf16 = torch.bfloat16
    models = {name: seeded_pct_model(torch, name) for name in ("pct", "rankpct")}
    engines = {name: InferenceEngine(m, device=DEVICE) for name, m in models.items()}
    params32 = {name: prepare_pct_engine_params(*module_state(m), torch.float32)
                for name, m in models.items()}
    gen = torch.Generator(device=dev).manual_seed(25)
    n, d, h = PCT_M40["num_points"], PCT_M40["hidden_dim"], PCT_M40["num_heads"]
    k = int(32 * n / 512)
    clouds = surface_clouds(torch, gen, PCT_BATCH, n, dev, ties=PCT_TIE_CLOUDS)
    pack = engines["pct"].params["embedder"]["_arpe_kernel_pack"]
    pack_args = (pack["wc"], pack["wb"], pack["b1"], pack["w2"], pack["b2"])
    with torch.inference_mode():
        got, thr_k, cnt_k = tpe.arpe_tokens(clouds, *pack_args, k, knn_stats=True)
        want, thr_p, cnt_p = tpe.arpe_tokens_ref(clouds, *pack_args, k, knn_stats=True)
        torch.cuda.synchronize()
        tied = cnt_p > k
        rec = {"phase": "arpe_knn_check", "clouds": PCT_BATCH, "points": n, "k": k,
               "threshold_bit_equal_share": (thr_k == thr_p).float().mean().item(),
               "count_equal_share": (cnt_k == cnt_p).float().mean().item(),
               "rows_with_ties_past_k": int(tied.sum()),
               "rows_with_ties_in_tie_clouds": int(tied[-PCT_TIE_CLOUDS:].sum()),
               "count_min_max": [int(cnt_p.min()), int(cnt_p.max())], "card": smi}
        emit(rec)
        if not (torch.equal(thr_k, thr_p) and torch.equal(cnt_k, cnt_p)):
            raise AssertionError(f"arpe_tokens: neighbour sets differ from the plain version: {rec}")
        if int(tied[-PCT_TIE_CLOUDS:].sum()) == 0:
            raise AssertionError("arpe_tokens: the tie clouds produced no tied rows")
        check("arpe_tokens.f32", got, want, 1e-5,
              "same neighbour sets and masked max; expf against torch.exp in the two elus")
        check("arpe_tokens", tpe.arpe_tokens(clouds, *pack_args, k, out_dtype=bf16),
              tpe.arpe_tokens_ref(clouds, *pack_args, k, out_dtype=bf16), 2.0 ** -6,
              "the fp32 tokens within 1e-5, then one bf16 rounding")
        tokens = tpe.arpe_tokens(clouds, *pack_args, k, out_dtype=bf16)

        qkv = {1024: torch.randn(PCT_BATCH, n, 3 * d, generator=gen, device=dev).to(bf16),
               64: torch.randn(PCT_BATCH, 64, 3 * d, generator=gen, device=dev).to(bf16)}
        clamp = torch.full((PCT_BATCH, n, 3 * d), 4.0, device=dev)
        clamp[..., 2 * d:] = torch.randn(PCT_BATCH, n, d, generator=gen, device=dev)
        qkv["clamp"] = clamp.to(bf16)  # q.k 32^-0.5 log2 e ~ 130 for every pair: at the clamp
        for name, t in qkv.items():
            out = fa.attn_scores_pv(t, h)
            check(f"attn_scores_pv.hd32.n{name}", out, fa.attn_scores_pv_ref(t, h), 2e-2,
                  "bf16 rounding of logits before exp2, bf16 output rounding")
        checks["attn_scores_pv.hd32"] = checks["attn_scores_pv.hd32.n1024"]

        st = engines["pct"].params["encoder"]["_stacked_layers"]
        w = [st[key][0] for key in ("wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2")]
        check("fused_layer_block_folded.pct", fa.fused_layer_block_folded(tokens, *w, h, EPS),
              fa.fused_layer_block_folded_ref(tokens, *w, h, EPS), 3e-2,
              "seven launches; bf16 roundings flipped by fp32 sums in another order, the "
              "attention kernel's tolerance")
        torch.cuda.synchronize()
    return {"models": models, "engines": engines, "params32": params32, "clouds": clouds,
            "tokens": tokens, "qkv": qkv[1024], "pack": pack_args, "k": k, "layer": w}


def _composed_kept(torch, kept: dict) -> dict:
    """{layer: (B, n - 1) original positions (after position 0) of the
    tokens kept before that layer}: each layer's indices point into the
    previous layer's kept tokens."""
    out, ids = {}, None
    for i in sorted(kept):
        ids = kept[i] if ids is None else torch.gather(ids, 1, kept[i])
        out[i] = ids
    return out


def pct_phases(torch, fa, dev, smi, ins) -> dict:
    """Phase 26: PCT and RankPCT (ranking on) at the ModelNet40 config
    serve 8 and 128 synthetic clouds, RankPCT at budgets 0.25/0.5/1.0 and
    with no budget. Counts zeroed just before and read just after each
    forward: 29 launches (arpe_tokens and 4 x 7, attn_scores_pv.hd32
    among them: PCT_FORWARD_COUNTS). Logits against pct_forward_plain / rankpct_forward_plain
    in bf16 and fp32 (the RankPCT twins fed the engine's kept indices),
    top-1 on decided clouds, and the share of clouds whose kept sets a
    free-running bf16 twin also picks."""
    from peekvit_torch.inference import (pct_forward_plain, rankpct_forward_fused,
                                         rankpct_forward_plain)

    engines, params32 = ins["engines"], ins["params32"]
    # num_heads, num_points, ln_eps: the same for both engines
    fwd = {k: v for k, v in engines["pct"]._forward.items() if k != "compute_dtype"}
    gen = torch.Generator(device=dev).manual_seed(26)
    n = PCT_M40["num_points"]
    requests = [surface_clouds(torch, gen, bb, n, dev,
                               ties=PCT_TIE_CLOUDS if bb == PCT_BATCH else 0)
                for bb in PCT_REQUESTS]
    totals: dict = {}
    per_forward = []
    reason = ("plain_bf16: the same rounding points, sums in another order; the repo's bf16 "
              "kernel tolerance (tests/test_pallas.py:42). plain_fp32: bf16 tokens over 4 layers; "
              "the repo's bf16 engine tolerance (tests/test_inference.py:54)")

    def record(counts):
        per_forward.append(sum(counts.values()))
        for key, v in counts.items():
            totals[key] = totals.get(key, 0) + v
        if counts != PCT_FORWARD_COUNTS:
            raise AssertionError(f"PCT launches {counts}, want {PCT_FORWARD_COUNTS}")

    with torch.inference_mode():
        for pts in requests:
            bb = pts.shape[0]
            e = engines["pct"]
            got, counts = counted(torch, fa, lambda: e(pts))
            record(counts)
            if got.shape != (bb, PCT_M40["num_classes"]):
                raise AssertionError(f"PCT: output shape {tuple(got.shape)}")
            ref16 = pct_forward_plain(e.params, pts, compute_dtype=torch.bfloat16, **fwd)
            ref32 = pct_forward_plain(params32["pct"], pts, compute_dtype=torch.float32, **fwd)
            rec = compare_logits(torch, f"PCT b{bb}", got, [("plain_bf16", ref16, 3e-2, 3e-2),
                                                           ("plain_fp32", ref32, 0.1, 0.05)])
            emit({"phase": "pct_check", "model": "pct", "batch": bb, "launches": counts,
                  **rec, "tolerance_reason": reason, "card": smi})
            e = engines["rankpct"]
            for budget in PCT_BUDGETS:
                got, counts = counted(torch, fa, lambda: e(pts, budget=budget))
                record(counts)
                b = 1.0 if budget is None else budget
                kept = {}
                again = rankpct_forward_fused(e.params, pts, budget=b, ranking=e._ranking,
                                              kept_out=kept, compute_dtype=torch.bfloat16, **fwd)
                if not torch.equal(again, got):
                    raise AssertionError(f"RankPCT {budget}: a second forward differs")
                ref16 = rankpct_forward_plain(e.params, pts, budget=b, ranking=e._ranking,
                                              kept_idx=kept, compute_dtype=torch.bfloat16, **fwd)
                ref32 = rankpct_forward_plain(params32["rankpct"], pts, budget=b,
                                              ranking=e._ranking, kept_idx=kept,
                                              compute_dtype=torch.float32, **fwd)
                rec = compare_logits(torch, f"RankPCT {budget} b{bb}", got,
                                     [("plain_bf16", ref16, 3e-2, 3e-2),
                                      ("plain_fp32", ref32, 0.1, 0.05)])
                free = {}
                rankpct_forward_plain(e.params, pts, budget=b, ranking=e._ranking, kept_out=free,
                                      compute_dtype=torch.bfloat16, **fwd)
                same = torch.ones(bb, dtype=torch.bool, device=dev)
                for (_, ka), (_, kb) in zip(sorted(_composed_kept(torch, kept).items()),
                                            sorted(_composed_kept(torch, free).items())):
                    same &= (ka.sort(dim=1).values == kb.sort(dim=1).values).all(dim=1)
                emit({"phase": "pct_check", "model": "rankpct", "batch": bb, "budget": budget,
                      "tokens_per_layer": [1 + v.shape[1] for _, v in sorted(kept.items())],
                      "launches": counts, **rec,
                      "free_running_twin_same_kept_sets_share": same.float().mean().item(),
                      "tolerance_reason": "the plain twins fed the engine's kept indices (bf16 "
                      "norm ties at the keep boundary pick others in a free-running twin); "
                      + reason, "card": smi})
    emit({"phase": "pct_launches", "per_forward": per_forward, "counts": totals,
          "requests": list(PCT_REQUESTS), "budgets": list(PCT_BUDGETS), "card": smi})
    missing = [key for key in PCT_FORWARD_COUNTS if not totals.get(key)]
    if missing or set(per_forward) != {sum(PCT_FORWARD_COUNTS.values())}:
        raise AssertionError(f"PCT launches: missing {missing}, per forward {per_forward}")
    return {"counts": totals, "clouds": requests[-1]}


def library_arpe(torch, F, pts, pack, k):
    """The ARPE embedding in its linen form from PyTorch calls, with both
    BatchNorms folded: distances by bmm, torch.topk, gather, F.linear,
    elu, amax, F.linear, elu. It computes the kernel's function on clouds
    without ties at the k-th distance. A yardstick, never called by the
    port."""
    wc, wb, b1, w2, b2 = pack
    b, n, c = pts.shape
    sq = (pts * pts).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
    idx = torch.topk(-d2, k, dim=-1).indices
    knn = torch.gather(pts[:, None].expand(b, n, n, c), 2, idx[..., None].expand(b, n, k, c))
    centre = pts[:, :, None].expand_as(knn)
    h = F.elu(F.linear(torch.cat([centre, centre - knn], -1), torch.cat([wc - wb, wb]).t(), b1))
    return F.elu(F.linear(h.amax(2), w2.t(), b2)).to(torch.bfloat16)


def library_folded_layer(torch, F, x, w, h, eps):
    """The folded layer from PyTorch calls (F.layer_norm without affine,
    addmm, SDPA, tanh-gelu): a yardstick, never called by the port."""
    wqkv, bqkv, wo, bo, w1, b1, w2, b2 = w
    bb, n, d = x.shape
    x2 = x.reshape(bb * n, d)
    qkv = torch.addmm(bqkv, F.layer_norm(x2, (d,), eps=eps), wqkv)
    qh = qkv.reshape(bb, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
    attn = F.scaled_dot_product_attention(qh[0], qh[1], qh[2]).transpose(1, 2).reshape(bb * n, d)
    y = torch.addmm(bo, attn, wo).float() + x2
    hh = F.gelu(torch.addmm(b1, F.layer_norm(y, (d,), eps=eps).to(x.dtype), w1),
                approximate="tanh")
    return (torch.addmm(b2, hh, w2) + y).to(x.dtype).reshape(bb, n, d)


def pct_timing(torch, F, fa, smi, checks, ins, pct) -> list:
    """Phase 27 at bs128: PCT and RankPCT at each budget (ms, clouds/s);
    arpe_tokens and attn_scores_pv.hd32 (time, launches on phase 26's
    path, bound, plain time, library yardstick; ARPE's bound counts the
    kernel's own operations on these clouds' neighbour sets, with the
    counting bisection's bound beside it), the exp2 count beside
    the SFU's rate; the ARPE share of the PCT forward; the folded layer at
    N = 1024 beside its plain twin and the layer from PyTorch calls; one
    profiled forward of each path. Returns the two kernels' entries."""
    from peekvit_torch.ops.cuda import pct_embed as tpe

    bf16 = torch.bfloat16
    engines, pts = ins["engines"], pct["clouds"]
    n, d, h = PCT_M40["num_points"], PCT_M40["hidden_dim"], PCT_M40["num_heads"]
    hd, k, pack = d // h, ins["k"], ins["pack"]
    forward_ms = {}
    with torch.inference_mode():
        for name, budget in [("pct", None)] + [("rankpct", b) for b in PCT_BUDGETS]:
            e = engines[name]
            ms = cuda_ms(torch, lambda: e(pts, budget=budget), iters=10)
            forward_ms[(name, budget)] = ms
            emit({"phase": "timing_pct", "model": name, "budget": budget, "batch": PCT_BATCH,
                  "points": n, "ms_per_forward": ms, "clouds_per_s": PCT_BATCH / ms * 1e3,
                  "card": smi})
        entries = []
        attn_flops = 4.0 * PCT_BATCH * h * n * n * hd
        exp2_count = PCT_BATCH * h * n * n
        # the work this run's clouds need: the neighbour sets' sizes count
        neighbours = float(tpe.arpe_tokens(pts, *pack, k, out_dtype=bf16,
                                           knn_stats=True)[2].sum())
        arpe_ops = (PCT_BATCH * n * (ARPE_OPS_PER_PAIR * n + ARPE_OPS_PER_ROW + 15.0 * d)
                    + ARPE_OPS_PER_NEIGHBOUR * neighbours)
        bisection_ms = (PCT_BATCH * n * (BISECTION_OPS_PER_PAIR * n + BISECTION_OPS_PER_ROW
                                         + 15.0 * d) / PEAK_FP32_FLOPS * 1e3)
        specs = [
            ("arpe_tokens", "peekvit_torch/csrc/arpe_tokens.cu",
             f"{REPLACES_PCT}:121 arpe_tokens (_arpe_kernel :55)",
             lambda: tpe.arpe_tokens(pts, *pack, k, out_dtype=bf16),
             lambda: tpe.arpe_tokens_ref(pts, *pack, k, out_dtype=bf16),
             lambda: library_arpe(torch, F, pts, pack, k),
             arpe_ops / PEAK_FP32_FLOPS, PCT_BATCH * n * (3 * 4 + d * 2),
             "the linen form: bmm distances, torch.topk, gather, F.linear, elu, amax, "
             "F.linear, elu",
             {"ops_per_pair": ARPE_OPS_PER_PAIR, "neighbours": neighbours,
              "bound_ms_counting_bisection": bisection_ms,
              "counting_bisection_ops_per_pair": BISECTION_OPS_PER_PAIR}),
            ("attn_scores_pv.hd32", "peekvit_torch/csrc/attn_scores_pv.cu",
             f"{REPLACES}:46 _attn_scores_pv at head dim 32",
             lambda: fa.attn_scores_pv(ins["qkv"], h),
             lambda: fa.attn_scores_pv_ref(ins["qkv"], h),
             None, attn_flops / PEAK_BF16_FLOPS, PCT_BATCH * n * 4 * d * 2, "SDPA",
             {"exp2_count": exp2_count, "sfu_results_per_s": SFU_PER_S,
              "sfu_bound_ms": exp2_count / SFU_PER_S * 1e3}),
        ]
        sdpa = [ins["qkv"][..., i * d:(i + 1) * d].reshape(PCT_BATCH, n, h, hd)
                .transpose(1, 2).contiguous() for i in range(3)]
        for name, source, replaces, kfn, pfn, lfn, t_ops, nbytes, library, extra in specs:
            if lfn is None:
                lfn = lambda: F.scaled_dot_product_attention(*sdpa)  # noqa: E731
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=3)
            lib_ms = cuda_ms(torch, lfn)
            t_ops *= 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            bnd, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
            launches = pct["counts"].get(name, 0)
            if launches == 0:
                raise AssertionError(f"{name}: never launched on the PCT paths")
            entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, "max_abs_err": checks[name], "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                     "library_ms": lib_ms, "path": "pct", "shape_batch": PCT_BATCH}
            emit({"phase": "timing_kernel", **entry, "share_of_bound": bnd / ms,
                  "launches_per_forward": PCT_FORWARD_COUNTS[name], "library": library,
                  **extra, "card": smi})
            entries.append(entry)
        arpe_ms = entries[0]["ms"]
        emit({"phase": "timing_pct_breakdown", "forward_ms": forward_ms[("pct", None)],
              "arpe_ms": arpe_ms, "arpe_share_of_forward": arpe_ms / forward_ms[("pct", None)],
              "attention_ms_per_forward": entries[1]["ms"] * PCT_M40["num_layers"], "card": smi})
        x3, w = ins["tokens"], ins["layer"]
        rows = PCT_BATCH * n
        m = PCT_M40["mlp_dim"]
        flops = 2.0 * rows * (4 * d * d + 2 * d * m) + attn_flops
        emit({"phase": "timing_composition", "name": "fused_layer_block_folded.pct",
              "ms": cuda_ms(torch, lambda: fa.fused_layer_block_folded(x3, *w, h, EPS)),
              "plain_ms": cuda_ms(torch, lambda: fa.fused_layer_block_folded_ref(x3, *w, h, EPS),
                                  iters=3),
              "library_ms": cuda_ms(torch, lambda: library_folded_layer(torch, F, x3, w, h, EPS)),
              "library": "the layer from PyTorch calls: F.layer_norm, addmm, SDPA, gelu",
              "launches_per_call": 7, "tokens": n, "batch": PCT_BATCH,
              "bound_ms": flops / PEAK_BF16_FLOPS * 1e3, "bound_by": "operations",
              "max_abs_err": checks["fused_layer_block_folded.pct"],
              "replaces": f"{REPLACES}:788 fused_layer_block_folded at D = 128, H = 4",
              "card": smi})
        # warmed windows: a cold one misses the forward's first kernels (ARPE's among them)
        profile_step(torch, smi, lambda: engines["pct"](pts), forward_ms[("pct", None)],
                     phase="profile_pct_forward", batch=PCT_BATCH, warmup=True)
        profile_step(torch, smi, lambda: engines["rankpct"](pts, budget=PCT_PROFILE_BUDGET),
                     forward_ms[("rankpct", PCT_PROFILE_BUDGET)],
                     phase="profile_rankpct_forward", batch=PCT_BATCH, warmup=True)
    return entries


# ------------------------- the merged layer VJP and the attention switch (28-31)

REPLACES_LAYER = "peekvit_tpu/ops/pallas/fused_layer_vjp.py"
MERGED_GRAD_NAMES = ("dx", "dln1_scale", "dln1_bias", "dw_qkv", "db_qkv", "dw_out", "db_out",
                     "dln2_scale", "dln2_bias", "dw1", "db1", "dw2", "db2")
# Launches per layer of one merged train step: the forward's seven, then
# the backward's recompute of the first five, gelu_hpre, the gelu_grad NT
# GEMM, two NT none_f32, ln_bwd_rows.f32, NT none, attn_softmax_bwd,
# ln_bwd_rows.g_f32 and four gemm_wgrad (merged_per_layer adds them, one
# key per shape, with their summing launches). The hybrid step launches
# the forward's seven only: its backward is torch autograd.
MERGED_FWD_PER_LAYER = {"ln_rows": 1, "gemm_bias_epilogue.bias": 1, "attn_softmax_fwd": 1,
                        "gemm_bias_epilogue.residual_f32": 1, "ln_rows.f32": 1,
                        "gemm_bias_epilogue.gelu": 1, "gemm_bias_epilogue.residual": 1}
MERGED_BWD_PER_LAYER = {"ln_rows": 1, "gemm_bias_epilogue.bias": 1, "attn_softmax_fwd": 1,
                        "gemm_bias_epilogue.residual_f32": 1, "ln_rows.f32": 1,
                        "gemm_bias_epilogue.gelu_hpre": 1, "gemm_nt.gelu_grad": 1,
                        "gemm_nt.none_f32": 2, "ln_bwd_rows.f32": 1, "gemm_nt.none": 1,
                        "attn_softmax_bwd": 1, "ln_bwd_rows.g_f32": 1}
MERGED_NEW_KEYS = ("ln_rows.f32", "gemm_bias_epilogue.gelu_hpre", "gemm_nt.gelu_grad",
                   "ln_bwd_rows.f32", "ln_bwd_rows.g_f32")
MODULE_REQUESTS = (8, 256)
MERGED_PATHS = (("split", "auto"), ("merged", True), ("hybrid", "hybrid"))


def wgrad_shapes(d: int, m: int) -> dict:
    """The merged backward's weight-gradient products: name -> (K, N,
    column sums asked)."""
    return {"dwqkv": (d, 3 * d, True), "dwo": (d, d, False), "dw1": (d, m, False),
            "dw2": (m, d, True)}


def merged_per_layer(lv, rows: int, d: int, m: int) -> dict:
    """Launches per layer of one merged train step at ``rows`` token rows:
    MERGED_FWD_PER_LAYER and MERGED_BWD_PER_LAYER, one gemm_wgrad.<K>x<N>
    per product, and after each product whose plan splits rows one summing
    launch (C and its column sums together; lv.wgrad_plan)."""
    want = {k: MERGED_FWD_PER_LAYER.get(k, 0) + MERGED_BWD_PER_LAYER.get(k, 0)
            for k in {**MERGED_FWD_PER_LAYER, **MERGED_BWD_PER_LAYER}}
    for k, n, _ in wgrad_shapes(d, m).values():
        want[f"gemm_wgrad.{k}x{n}"] = 1
        if lv.wgrad_plan(rows, k, n).splits > 1:
            want[f"gemm_wgrad.{k}x{n}.reduce"] = 1
    return want


def wgrad_plan_summary(lv, rows: int, k: int, n: int) -> dict:
    """gemm_wgrad's schedule at one shape, for the record."""
    p = lv.wgrad_plan(rows, k, n)
    return {"bn": p.bn, "tiles": p.tiles_m * p.tiles_n, "stages": p.stages,
            "units": len(p.units), "grid": p.grid, "split_tiles": len(p.red_tiles),
            "splits": p.splits, "waves": len(p.units) / lv.WGRAD_SMS}


def merged_kernel_checks(torch, fa, vjp, lv, check, randn, x, y, ln_s, ln_b, g_rows, dln_in,
                         w1, b1, w2, qkv, d, h, m, rows, smi) -> dict:
    """Phase 28 at ViT-B/16 bs256 shapes: ln_rows on the fp32 y, the GEMM
    epilogues gelu_hpre (h and hpre) and NT gelu_grad (dhpre and the db1
    partials), gemm_wgrad on the merged backward's four shapes (with the
    column sums of dqkv and g, and a rerun that must give the same bits),
    ln_bwd_rows.f32 (dy, its bf16 copy, the three sets of partials) and
    ln_bwd_rows.g_f32, attn_softmax_fwd on separate q, k, v (bit-equal to
    the packed mode on the same values). Returns the inputs phase 30
    times."""
    bf16 = torch.bfloat16
    tol_bf16, tol_f32, tol_attn = 2.0 ** -6, 1e-3, 2e-2
    f32_sums = "fp32 column sums over 50,432 rows in another order"
    with torch.inference_mode():
        ln2 = fa.ln_rows(y, ln_s, ln_b, EPS, out_dtype=bf16)
        check("ln_rows.f32", ln2, fa.ln_rows_ref(y, ln_s, ln_b, EPS, out_dtype=bf16), tol_bf16,
              "bf16 output rounding")
        h_k, hpre = fa.gemm_gelu_hpre(ln2, w1, b1)
        h_p, hpre_p = fa.gemm_gelu_hpre_ref(ln2, w1, b1)
        check("gemm_bias_epilogue.gelu_hpre", h_k, h_p, tol_bf16,
              "fp32 sums in another order, bf16 output rounding")
        check("gemm_bias_epilogue.gelu_hpre.hpre", hpre, hpre_p, tol_f32,
              "tensor-core fp32 accumulation against cuBLAS fp32 over K = 768")
        dh_k, p_k = fa.gemm_nt_gelu_grad(g_rows, w2, hpre)
        dh_p, p_p = fa.gemm_nt_gelu_grad_ref(g_rows, w2, hpre)
        check("gemm_nt.gelu_grad", dh_k, dh_p, tol_bf16,
              "fp32 sums in another order, bf16 output rounding")
        check("gemm_nt.gelu_grad.db1", p_k.sum(0), p_p.sum(0), tol_f32, f32_sums)
        wgrad = {name: (randn(rows, k, scale=0.5), randn(rows, n, scale=0.05), colsum)
                 for name, (k, n, colsum) in wgrad_shapes(d, m).items()}
        rerun = {}
        for name, (a, b, colsum) in wgrad.items():
            c_k, s_k = lv.gemm_wgrad(a, b, colsum=colsum)
            c_p, s_p = lv.gemm_wgrad_ref(a, b, colsum=colsum)
            check(f"gemm_wgrad.{name}", c_k, c_p, tol_f32,
                  "fp32 sums over 50,432 rows in another order (split partials, then their sum)")
            if colsum:
                check(f"gemm_wgrad.{name}.colsum", s_k, s_p, tol_f32, f32_sums)
            c_2, s_2 = lv.gemm_wgrad(a, b, colsum=colsum)
            rerun[name] = torch.equal(c_2, c_k) and (not colsum or torch.equal(s_2, s_k))
        emit({"phase": "gemm_wgrad_rerun", "bit_identical": rerun,
              "plan": {k: wgrad_plan_summary(lv, rows, a.shape[1], b.shape[1])
                       for k, (a, b, _) in wgrad.items()}, "card": smi})
        if not all(rerun.values()):
            raise AssertionError(f"gemm_wgrad: a rerun gave other bits {rerun}")
        dy, dy_b, pw, pb, pdy = vjp.ln_bwd_rows_f32(y, dln_in, g_rows, ln_s, EPS)
        ref = vjp.ln_bwd_rows_f32_ref(y, dln_in, g_rows, ln_s, EPS)
        check("ln_bwd_rows.f32", dy, ref[0], tol_f32, "fp32 output, row sums in another order")
        check("ln_bwd_rows.f32.dy_b", dy_b, ref[1], tol_bf16, "bf16 rounding of dy")
        check("ln_bwd_rows.f32.partials", torch.cat([pw.sum(0), pb.sum(0), pdy.sum(0)]),
              torch.cat([ref[2][0], ref[3][0], ref[4][0]]), tol_f32, f32_sums)
        dx, pw, pb = vjp.ln_bwd_rows(x, dln_in, dy, ln_s, EPS)
        ref = vjp.ln_bwd_rows_ref(x, dln_in, dy, ln_s, EPS)
        check("ln_bwd_rows.g_f32", dx, ref[0], tol_bf16, "bf16 output rounding")
        check("ln_bwd_rows.g_f32.partials", torch.cat([pw.sum(0), pb.sum(0)]),
              torch.cat([ref[1][0], ref[2][0]]), tol_f32, f32_sums)
        q, k, v = (qkv[..., i * d:(i + 1) * d].contiguous() for i in range(3))
        sep = fa.fused_attention(q, k, v, h)
        check("attn_softmax_fwd.separate", sep, fa.fused_attention_ref(q, k, v, h), tol_attn,
              "bf16 rounding of the normalised P, bf16 output rounding")
        same = torch.equal(sep, vjp.attn_softmax_fwd(qkv, h))
        emit({"phase": "attn_softmax_fwd_separate_vs_packed", "bit_identical": same, "card": smi})
        if not same:
            raise AssertionError("attn_softmax_fwd: separate q, k, v differ from packed qkv")
        torch.cuda.synchronize()
    return {"ln2": ln2, "hpre": hpre, "dy": dy, "wgrad": wgrad, "q": q, "k": k, "v": v}


ATTN_EDGE_TOKENS = (1, 15, 16, 17, 64, 65, 197, 198, 208, 256, 257, 768)
KMASK_EDGES = ((99, 198), (50, 200), (1, 17), (130, 260))
WGRAD_EDGE_ROWS = (0, 31, 32, 33, 50432)
EDGE_BATCH = 4
ATTN_BWD_EDGE_TOKENS = (1, 15, 16, 17, 64, 65, 197, 198, 208, 224, 225, 256, 257, 384)
GEMM_EDGE_M = (1, 127, 129, 50432, 50688)
GEMM_EDGE_N = (8, 120, 136, 576, 3072)
GEMM_EDGE_K = (128, 3072)  # the smallest (PCT) and the largest (ViT fc2) K a path runs


def redesign_edge_checks(torch, fa, vjp, lv, check, randn, d, h, m, smi) -> None:
    """Phase 28, the redesigned kernels at their edge shapes (ViT-B/16
    width, 4 images): attn_softmax_fwd packed at every N of
    ATTN_EDGE_TOKENS (16-key padding, the 256-key switch to the key-tiled
    kernel, 768) against attn_softmax_fwd_ref, and .separate on
    the same values bit-equal to it; attn_softmax_fwd.kmask at every n_q /
    n_k of KMASK_EDGES with image 0 under a random mask, image 1 with its
    first 64 keys (or all but the last) excluded, image 2 attending its
    last key only, image 3 every key; gemm_wgrad at every R of
    WGRAD_EDGE_ROWS and (K, N) of (32, 96), (768, 776) and the four
    ViT-B/16 products, column sums off and on, against gemm_wgrad_ref, and
    a rerun bit-identical."""
    tol_attn, tol_f32 = 3e-2, 1e-3
    reason_attn = "bf16 rounding of the normalised P and of the output (3e-2 of max|plain|)"
    same = {}
    with torch.inference_mode():
        for n in ATTN_EDGE_TOKENS:
            qkv = randn(EDGE_BATCH, n, 3 * d)
            got = vjp.attn_softmax_fwd(qkv, h)
            check(f"edge.attn_softmax_fwd.N{n}", got, vjp.attn_softmax_fwd_ref(qkv, h), tol_attn,
                  reason_attn)
            q, k, v = (qkv[..., i * d:(i + 1) * d].contiguous() for i in range(3))
            same[f"separate.N{n}"] = torch.equal(fa.fused_attention(q, k, v, h), got)
        for nq, nk in KMASK_EDGES:
            q = randn(EDGE_BATCH, nq, 3 * d)[..., :d]
            kv = randn(EDGE_BATCH, nk, 2 * d)
            gen = torch.Generator(device=kv.device).manual_seed(nq * 1000 + nk)
            kmask = (torch.rand(EDGE_BATCH, nk, generator=gen, device=kv.device) > 0.5).float()
            kmask[0, 0] = 1.0
            kmask[1] = 1.0
            kmask[1, :min(64, nk - 1)] = 0.0
            kmask[2] = 0.0
            kmask[2, nk - 1] = 1.0
            kmask[3] = 1.0
            got = lv.attn_softmax_fwd_kmask(q, kv[..., :d], kv[..., d:], kmask, h)
            want = lv.attn_softmax_fwd_kmask_ref(q, kv[..., :d], kv[..., d:], kmask, h)
            check(f"edge.attn_softmax_fwd.kmask.{nq}x{nk}", got, want, tol_attn, reason_attn)
        shapes = [(32, 96), (768, 776)] + [(k, n) for k, n, _ in wgrad_shapes(d, m).values()]
        for rows in WGRAD_EDGE_ROWS:
            for k, n in shapes:
                a, b = randn(rows, k, scale=0.5), randn(rows, n, scale=0.05)
                for colsum in (False, True):
                    c, s = lv.gemm_wgrad(a, b, colsum=colsum)
                    c_p, s_p = lv.gemm_wgrad_ref(a, b, colsum=colsum)
                    name = f"edge.gemm_wgrad.R{rows}.{k}x{n}" + (".colsum" if colsum else "")
                    check(name, c, c_p, tol_f32, "fp32 sums over the rows in another order")
                    if colsum:
                        check(name + ".sums", s, s_p, tol_f32, "fp32 column sums in another order")
                    c2, s2 = lv.gemm_wgrad(a, b, colsum=colsum)
                    same[name + ".rerun"] = torch.equal(c, c2) and (
                        not colsum or torch.equal(s, s2))
        torch.cuda.synchronize()
    emit({"phase": "redesign_edges", "checked_bit_identical": len(same),
          "differ": [k for k, v in same.items() if not v], "card": smi})
    if not all(same.values()):
        raise AssertionError(f"redesign edges: bits differ {[k for k, v in same.items() if not v]}")


def gemm_modes(fa, a, w, wt, b, res32, res16, mask, g, hpre) -> dict:
    """Every epilogue of gemm_bias_epilogue.cu in its layout (NN: W as
    (K, N); NT: W as (N, K)) on one set of inputs: name -> (kernel, plain),
    each returning a tuple of outputs (the partials of masked_rowdot and
    gelu_grad in the kernel's grouping)."""
    def both(kfn, pfn):
        def wrap(fn):
            return lambda: (lambda out: out if isinstance(out, tuple) else (out,))(fn())
        return wrap(kfn), wrap(pfn)

    modes = {}
    for epi, res in (("bias", None), ("gelu", None), ("residual_f32", res32),
                     ("residual_f32.bf16_residual", res16), ("residual", res32),
                     ("residual.bf16_residual", res16)):
        e = epi.split(".")[0]
        modes[f"gemm_bias_epilogue.{epi}"] = both(
            lambda e=e, r=res: fa.gemm_bias_epilogue(a, w, b, e, residual=r),
            lambda e=e, r=res: fa.gemm_bias_epilogue_ref(a, w, b, e, residual=r))
    for epi, res in (("masked_residual_f32", res32), ("masked_residual", res16)):
        modes[f"gemm_bias_epilogue.{epi}"] = both(
            lambda e=epi, r=res: fa.gemm_bias_epilogue(a, w, b, e, residual=r, mask=mask),
            lambda e=epi, r=res: fa.gemm_bias_epilogue_ref(a, w, b, e, residual=r, mask=mask))
    for epi in ("none", "none_f32"):
        modes[f"gemm_nt.{epi}"] = both(lambda e=epi: fa.gemm_nt(a, wt, e),
                                       lambda e=epi: fa.gemm_nt_ref(a, wt, e))
    modes["gemm_bias_epilogue.masked_rowdot"] = both(
        lambda: fa.gemm_masked_rowdot(a, w, b, g, mask),
        lambda: fa.gemm_masked_rowdot_ref(a, w, b, g, mask))
    modes["gemm_bias_epilogue.gelu_hpre"] = both(lambda: fa.gemm_gelu_hpre(a, w, b),
                                                 lambda: fa.gemm_gelu_hpre_ref(a, w, b))
    modes["gemm_nt.gelu_grad"] = both(lambda: fa.gemm_nt_gelu_grad(a, wt, hpre),
                                      lambda: fa.gemm_nt_gelu_grad_ref(a, wt, hpre))
    modes["gemm_bias_epilogue.partial_f32"] = both(lambda: fa.gemm_partial_f32(a, w),
                                                   lambda: fa.gemm_partial_f32_ref(a, w))
    return modes


def gemm_attn_bwd_edge_checks(torch, fa, vjp, randn, d, h, smi) -> None:
    """Phase 28, the wgmma / TMA attention backward and GEMM at their
    edges: attn_softmax_bwd at every N of ATTN_BWD_EDGE_TOKENS (4
    images, ViT-B/16 width; 16-row padding, 64-row tiles, the switch to the
    kept kernel past 256, the 384 limit) against attn_softmax_bwd_ref at
    its phase 3 tolerance (2e-2 of max|plain|), with the kernel each N
    took; every epilogue of the GEMM in both layouts (gemm_modes) at every
    M of GEMM_EDGE_M, N of GEMM_EDGE_N and K of GEMM_EDGE_K against its
    plain version at its phase 3 tolerance (2^-6 of max|plain| for a bf16
    output, 1e-3 for an fp32 output or partial), the partials' shapes
    pinned; a rerun of each at the largest shape (and of the attention at
    every N) bit-identical."""
    bf16 = torch.bfloat16
    tol = {bf16: 2.0 ** -6, torch.float32: 1e-3}
    same, routes, worst, count = {}, {}, {}, 0
    with torch.inference_mode():
        for n in ATTN_BWD_EDGE_TOKENS:
            qkv, da = randn(EDGE_BATCH, n, 3 * d), randn(EDGE_BATCH, n, d, scale=0.05)
            got = vjp.attn_softmax_bwd(qkv, da, h)
            want = vjp.attn_softmax_bwd_ref(qkv, da, h)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            routes[n] = vjp.attn_softmax_bwd_route(n)
            emit({"phase": "kernel_check", "kernel": f"edge.attn_softmax_bwd.N{n}",
                  "kernel_path": routes[n], "shape": list(got.shape), "max_abs_err": err,
                  "max_rel_err": err / max(scale, 1e-30), "tolerance_rel": 2e-2,
                  "reason": "bf16 rounding of P and dZ * scale, bf16 output rounding",
                  "card": smi})
            if not torch.isfinite(got).all() or err > 2e-2 * scale:
                raise AssertionError(f"attn_softmax_bwd at N = {n}: {err} > 2e-2 * {scale}")
            same[f"attn_softmax_bwd.N{n}.rerun"] = torch.equal(
                got, vjp.attn_softmax_bwd(qkv, da, h))
        largest = (GEMM_EDGE_M[-1], GEMM_EDGE_N[-1], GEMM_EDGE_K[-1])
        for m in GEMM_EDGE_M:
            for n in GEMM_EDGE_N:
                for k in GEMM_EDGE_K:
                    a, w = randn(m, k), randn(k, n, scale=k ** -0.5)
                    wt, b = randn(n, k, scale=k ** -0.5), randn(n, scale=0.1)
                    res32, res16 = randn(m, n, dtype=torch.float32), randn(m, n)
                    mask = (randn(m, dtype=torch.float32) > -0.5).to(bf16)
                    g, hpre = randn(m, n, scale=0.05), randn(m, n, dtype=torch.float32)
                    for name, (kfn, pfn) in gemm_modes(fa, a, w, wt, b, res32, res16, mask, g,
                                                       hpre).items():
                        got, want = kfn(), pfn()
                        for i, (gt, wn) in enumerate(zip(got, want)):
                            if gt.shape != wn.shape or gt.dtype != wn.dtype:
                                raise AssertionError(f"{name} output {i} at {(m, n, k)}: "
                                                     f"{gt.shape} {gt.dtype}, want {wn.shape} "
                                                     f"{wn.dtype}")
                            scale = wn.float().abs().max().item()
                            rel = (gt.float() - wn.float()).abs().max().item() / max(scale, 1e-30)
                            if not torch.isfinite(gt).all() or rel > tol[wn.dtype]:
                                raise AssertionError(f"{name} output {i} at (M, N, K) = "
                                                     f"{(m, n, k)}: {rel} > {tol[wn.dtype]}")
                            key = f"{name}.{i}"
                            if rel >= worst.get(key, (-1.0,))[0]:
                                worst[key] = (rel, [m, n, k])
                            count += 1
                        if (m, n, k) == largest:
                            same[f"{name}.rerun"] = all(
                                torch.equal(x, y) for x, y in zip(got, kfn()))
                    del a, w, wt, res32, res16, g, hpre
        torch.cuda.synchronize()
    plans = {f"{epi}.{m}x{n}": fa.gemm_plan(m, n, epi) for epi in ("bias", "gelu_grad")
             for m in GEMM_EDGE_M for n in GEMM_EDGE_N}
    emit({"phase": "gemm_attn_bwd_edges", "attn_softmax_bwd_route": routes, "gemm_checks": count,
          "gemm_worst_rel_err": {k: {"rel": v[0], "mnk": v[1]} for k, v in worst.items()},
          "gemm_tolerance_rel": {"bf16": 2.0 ** -6, "fp32": 1e-3}, "gemm_plan": plans,
          "checked_bit_identical": len(same), "differ": [k for k, v in same.items() if not v],
          "card": smi})
    if not all(same.values()):
        raise AssertionError(f"redesign edges: bits differ {[k for k, v in same.items() if not v]}")


def ptxas_summary(build_info: dict, sources=("attn_softmax_bwd", "gemm_bias_epilogue")) -> list:
    """Registers and spills of every kernel that ptxas reported for
    ``sources`` (none for a library reused from an earlier build)."""
    import re

    fields = {"registers": r"Used (\d+) registers", "stack_bytes": r"(\d+) bytes stack frame",
              "spill_store_bytes": r"(\d+) bytes spill stores",
              "spill_load_bytes": r"(\d+) bytes spill loads"}
    rows = []
    for src in sources:
        for line in build_info.get(src, {}).get("ptxas", []):
            if "Compiling entry function" in line:
                rows.append({"source": src, "kernel": line.split("'")[1]})
            elif rows:
                for key, pattern in fields.items():
                    found = re.search(pattern, line)
                    if found:
                        rows[-1][key] = int(found.group(1))
    return rows


def gemm_attn_bwd_timing(torch, F, fa, vjp, smi, randn, build_info) -> None:
    """Phase 30, the wgmma / TMA attention backward and GEMM beside their
    bounds, plain versions and PyTorch calls: attn_softmax_bwd at bs256, N =
    197 and 198 (SDPA's backward the yardstick), every GEMM mode at the
    ViT-B/16 bs256 shapes, and the four layer GEMMs at PCT's (bs128, 1024
    points, d 128) and A-ViT-S/16's (bs256, D 384) shapes; each with the
    kernel or schedule it took. Then ptxas's registers and spills of both
    sources' kernels (none may spill)."""
    bf16, f32 = torch.bfloat16, torch.float32
    bf, f4 = 2, 4

    def gemm_row(name, m, k, n, kfn, pfn, lfn, out_b, extra_b=0, nt=False):
        epi = name.split(".", 1)[1].split(".")[0].replace("nt_", "")
        bnd, by = bound_ms(2.0 * m * n * k, (m * k + k * n + n) * bf + m * n * out_b + extra_b)
        with torch.inference_mode():
            ms, plain = cuda_ms(torch, kfn), cuda_ms(torch, pfn, iters=3)
            lib = cuda_ms(torch, lfn) if lfn is not None else None
        emit({"phase": "timing_redesigned", "name": name, "m": m, "k": k, "n": n,
              "layout": "NT" if nt else "NN", "kernel_path": {"wgmma": fa.gemm_plan(m, n, epi)},
              "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd, "bound_by": by,
              "share_of_bound": bnd / ms, "card": smi})

    def layer_gemms(tag, rows, d, mlp):
        x, h = randn(rows, d), randn(rows, mlp)
        y = randn(rows, d, dtype=f32)
        wq, bq = randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1)
        wo, bo = randn(d, d, scale=d ** -0.5), randn(d, scale=0.1)
        w1, b1 = randn(d, mlp, scale=d ** -0.5), randn(mlp, scale=0.1)
        w2, b2 = randn(mlp, d, scale=mlp ** -0.5), randn(d, scale=0.1)
        gemm = fa.gemm_bias_epilogue
        ref = fa.gemm_bias_epilogue_ref
        gemm_row(f"{tag}.bias", rows, d, 3 * d, lambda: gemm(x, wq, bq, "bias"),
                 lambda: ref(x, wq, bq, "bias"), lambda: torch.addmm(bq, x, wq), bf)
        gemm_row(f"{tag}.residual_f32", rows, d, d,
                 lambda: gemm(x, wo, bo, "residual_f32", residual=x),
                 lambda: ref(x, wo, bo, "residual_f32", residual=x),
                 lambda: torch.addmm(bo, x, wo).float() + x, f4, rows * d * bf)
        gemm_row(f"{tag}.gelu", rows, d, mlp, lambda: gemm(x, w1, b1, "gelu"),
                 lambda: ref(x, w1, b1, "gelu"),
                 lambda: F.gelu(torch.addmm(b1, x, w1), approximate="tanh"), bf)
        gemm_row(f"{tag}.residual", rows, mlp, d, lambda: gemm(h, w2, b2, "residual", residual=y),
                 lambda: ref(h, w2, b2, "residual", residual=y),
                 lambda: (torch.addmm(b2, h, w2) + y).to(bf16), bf, rows * d * f4)
        return x, h, y, (wq, bq, wo, bo, w1, b1, w2, b2)

    d, mlp, heads = B16["hidden_dim"], B16["mlp_dim"], B16["num_heads"]
    for n in (197, 198):
        qkv, da = randn(BATCH, n, 3 * d), randn(BATCH, n, d, scale=0.05)
        leaves = [qkv[..., i * d:(i + 1) * d].reshape(BATCH, n, heads, d // heads)
                  .transpose(1, 2).contiguous().requires_grad_() for i in range(3)]
        out = F.scaled_dot_product_attention(*leaves)
        dout = da.reshape(BATCH, n, heads, d // heads).transpose(1, 2).contiguous()
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: vjp.attn_softmax_bwd(qkv, da, heads))
            plain = cuda_ms(torch, lambda: vjp.attn_softmax_bwd_ref(qkv, da, heads), iters=3)
        lib = cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
        bnd, by = bound_ms(10.0 * BATCH * heads * n * n * (d // heads),
                           BATCH * n * (3 * d + d + 3 * d) * bf)
        emit({"phase": "timing_redesigned", "name": f"attn_softmax_bwd.n{n}", "batch": BATCH,
              "kernel_path": vjp.attn_softmax_bwd_route(n), "ms": ms, "plain_ms": plain,
              "library_ms": lib, "bound_ms": bnd, "bound_by": by, "share_of_bound": bnd / ms,
              "card": smi})
        del qkv, da, leaves, out, dout
    rows = BATCH * 197
    x, h, y, (wq, bq, wo, bo, w1, b1, w2, b2) = layer_gemms("vit_b16", rows, d, mlp)
    g, dq = randn(rows, d, scale=0.05), randn(rows, 3 * d, scale=0.05)
    hpre = randn(rows, mlp, dtype=f32)
    mask = (randn(rows, dtype=f32) > -0.5).to(bf16)
    gemm_row("vit_b16.residual.bf16_residual", rows, d, d,
             lambda: fa.gemm_bias_epilogue(x, wo, bo, "residual", residual=x),
             lambda: fa.gemm_bias_epilogue_ref(x, wo, bo, "residual", residual=x),
             lambda: (torch.addmm(bo, x, wo) + x).to(bf16), bf, rows * d * bf)
    gemm_row("vit_b16.masked_residual_f32", rows, d, d,
             lambda: fa.gemm_bias_epilogue(x, wo, bo, "masked_residual_f32", residual=y,
                                           mask=mask),
             lambda: fa.gemm_bias_epilogue_ref(x, wo, bo, "masked_residual_f32", residual=y,
                                               mask=mask),
             lambda: torch.addmm(bo, x, wo).float() * mask.float()[:, None] + y, f4,
             rows * d * f4 + rows * bf)
    gemm_row("vit_b16.masked_rowdot", rows, d, d, lambda: fa.gemm_masked_rowdot(x, wo, bo, g, mask),
             lambda: fa.gemm_masked_rowdot_ref(x, wo, bo, g, mask),
             lambda: ((g * mask[:, None]).to(bf16),
                      (g.float() * torch.addmm(bo, x, wo).float()).sum(-1)), bf,
             rows * d * bf + rows * bf + rows * 6 * f4)
    gemm_row("vit_b16.gelu_hpre", rows, d, mlp, lambda: fa.gemm_gelu_hpre(x, w1, b1),
             lambda: fa.gemm_gelu_hpre_ref(x, w1, b1),
             lambda: F.gelu(torch.addmm(b1, x, w1).float(), approximate="tanh").to(bf16),
             bf + f4)
    gemm_row("vit_b16.nt_none", rows, d, d, lambda: fa.gemm_nt(g, wo, "none"),
             lambda: fa.gemm_nt_ref(g, wo, "none"), lambda: torch.matmul(g, wo.t()), bf, nt=True)
    gemm_row("vit_b16.nt_none_f32", rows, 3 * d, d, lambda: fa.gemm_nt(dq, wq, "none_f32"),
             lambda: fa.gemm_nt_ref(dq, wq, "none_f32"),
             lambda: torch.matmul(dq, wq.t()).float(), f4, nt=True)
    gemm_row("vit_b16.nt_gelu_grad", rows, d, mlp, lambda: fa.gemm_nt_gelu_grad(g, w2, hpre),
             lambda: fa.gemm_nt_gelu_grad_ref(g, w2, hpre),
             lambda: (torch.matmul(g, w2.t()).float() * fa.gelu_tanh_grad(hpre)).to(bf16), bf,
             rows * mlp * f4 + (-(-rows // 128)) * mlp * f4, nt=True)
    hk, w2k = h[:, :mlp // 2].contiguous(), w2[:mlp // 2]  # fc2 of one of two model shards
    gemm_row("vit_b16.partial_f32.k1536", rows, mlp // 2, d, lambda: fa.gemm_partial_f32(hk, w2k),
             lambda: fa.gemm_partial_f32_ref(hk, w2k), lambda: torch.mm(hk, w2k).float(), f4)
    del x, h, y, g, dq, hpre, mask, hk
    torch.cuda.empty_cache()
    layer_gemms("pct_d128", PCT_BATCH * PCT_M40["num_points"], PCT_M40["hidden_dim"],
                PCT_M40["mlp_dim"])
    torch.cuda.empty_cache()
    layer_gemms("avit_s16", BATCH * 197, AVIT_S16["hidden_dim"], AVIT_S16["mlp_dim"])
    torch.cuda.empty_cache()
    rows = ptxas_summary(build_info)
    spilled = [r["kernel"] for r in rows if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    emit({"phase": "ptxas_redesigned", "kernels": rows if rows else "not rebuilt in this run",
          "spilled": spilled, "card": smi})
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")


SCORES_PV_EDGE_TOKENS = (1, 15, 16, 17, 63, 64, 65, 148, 197, 208, 256, 257, 786, 1024)
# head dim 48 (the EncDec decoder's d 192 over 4 heads): the 16-key slice and
# 64-key tile edges, the decoder's 400 tokens, and the wgmma kernel's route
# edges as attn_scores_pv_plan gives them: two warpgroups and two CTAs an SM
# to 512, four warpgroups to 1,024, two warpgroups and one CTA an SM to
# 1,088, the mma.sync kernel from 1,089
SCORES_PV_HD48_TOKENS = (1, 15, 16, 17, 63, 64, 65, 400, 401, 512, 513, 1024, 1025, 1088,
                         1089)
SCORES_PV_WIDTHS = (  # head dim, d, heads, token counts, batches
    (64, 768, 12, SCORES_PV_EDGE_TOKENS, (EDGE_BATCH,)),
    (32, 128, 4, SCORES_PV_EDGE_TOKENS, (EDGE_BATCH,)),
    (64, 256, 4, (786,), (EDGE_BATCH,)),
    (48, 192, 4, SCORES_PV_HD48_TOKENS, (1, 512)))
S8_EDGE_M = (1, 127, 129, 300, 50432)
S8_EDGE_N = (8, 136, 264, 768, 2304)
S8_EDGE_K = (16, 144, 784, 3072)


def plain_by_images(torch, fa, qkv, heads, kw, step=64):
    """attn_scores_pv_ref on ``step`` images at a time (each image's heads
    are independent), so that the fp32 logits of 512 images of 1,089 tokens
    never stand in memory at once."""
    parts = []
    for i in range(0, qkv.shape[0], step):
        part = dict(kw)
        if "kmask" in part:
            part["kmask"] = part["kmask"][i:i + step]
        parts.append(fa.attn_scores_pv_ref(qkv[i:i + step], heads, **part))
    return torch.cat(parts)


def scores_pv_s8_edge_checks(torch, fa, tq, randn, smi, build_info) -> None:
    """Phase 36, the wgmma / TMA attn_scores_pv and gemm_s8_epilogue at their
    edges: the attention at every N of SCORES_PV_EDGE_TOKENS (16-key slices,
    64-key chunks and tiles, the kept kernel past 832 tokens at head dim
    64) at ViT-B/16 width (head dim 64) and PCT's (32), and at the EE
    ResidualViT's (d 256, 4 heads) at its 786 tokens, 4 images; at head
    dim 48 (the EncDec decoder's d 192: the wgmma kernel to 1,088 tokens,
    the mma.sync kernel past them) at every N of SCORES_PV_HD48_TOKENS for
    1 and 512 images (the plain version taken 64 images at a time); in every
    mode (plain; the phantom key at the last token with mult 0 and 45; a
    key mask with about half the keys excluded and their rows poisoned with
    NaN and Inf, the attended rows compared and bit-equal to a clean
    input's) against attn_scores_pv_ref within 2e-2 of max|plain|, with the
    schedule each took; the exhaustive check of the packed exp2 terms over
    all 2^32 fp32 logits; the s8 GEMM's six epilogues and a static scale
    at every M of S8_EDGE_M, N of S8_EDGE_N and K of S8_EDGE_K against its
    plain version (bit for bit wherever the plain version takes the
    kernel's IEEE steps, every epilogue but the tanh-gelu: 2^-20 of max);
    a rerun of each bit-identical; ptxas's registers and spills of both
    sources' kernels (none may spill)."""
    bf16, f32 = torch.bfloat16, torch.float32
    same, plans, worst, count = {}, {}, {}, 0

    def held(name, got, want, tol, rows=None):
        if rows is not None:
            got, want = got[rows], want[rows]
        scale = want.float().abs().max().item()
        rel = (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)
        if not torch.isfinite(got).all() or rel > tol:
            raise AssertionError(f"{name}: {rel} > {tol} of max|plain|")
        worst[name.split(".N")[0]] = max(worst.get(name.split(".N")[0], 0.0), rel)

    with torch.inference_mode():
        ex2 = fa.attn_scores_pv_ex2_check()
        for hd, d, h, tokens, batches in SCORES_PV_WIDTHS:
            for n, b in ((n, b) for n in tokens for b in batches):
                qkv = randn(b, n, 3 * d)
                gen = torch.Generator(device=qkv.device).manual_seed(n)
                km = (torch.rand(b, n, generator=gen, device=qkv.device) > 0.5).to(bf16)
                km[:, 0] = 1
                poison = torch.tensor([float("nan"), float("inf"), -float("inf")],
                                      device=qkv.device, dtype=bf16)
                bad = (km == 0)[..., None].expand(-1, -1, 3 * d)
                garbage = poison[torch.randint(0, 3, qkv.shape, generator=gen,
                                               device=qkv.device)]
                qkv_km = torch.where(bad, garbage, qkv)
                tag = f"hd{hd}.d{d}.N{n}" + ("" if b == EDGE_BATCH else f".b{b}")
                plans[tag] = fa.attn_scores_pv_plan(b, n, h, hd)
                modes = {"plain": (qkv, {})}
                for mult in ((45.0,) if n == 1 else (0.0, 45.0)):
                    modes[f"kweight{mult:g}"] = (qkv, {"phantom_idx": n - 1, "phantom_mult": mult})
                modes["kmask"] = (qkv_km, {"kmask": km})
                for mode, (x, kw) in modes.items():
                    got = fa.attn_scores_pv(x, h, **kw)
                    want = plain_by_images(torch, fa, x, h, kw)
                    rows = (km > 0) if mode == "kmask" else None
                    held(f"attn_scores_pv.{mode}.hd{hd}.N{n}", got, want, 2e-2, rows)
                    same[f"attn_scores_pv.{mode}.{tag}.rerun"] = torch.equal(
                        got, fa.attn_scores_pv(x, h, **kw)) if rows is None else torch.equal(
                        got[rows], fa.attn_scores_pv(x, h, **kw)[rows])
                    count += 1
                clean = torch.where(bad, torch.zeros((), dtype=bf16, device=qkv.device), qkv_km)
                same[f"attn_scores_pv.kmask.{tag}.poison_free"] = torch.equal(
                    fa.attn_scores_pv(clean, h, kmask=km)[km > 0],
                    fa.attn_scores_pv(qkv_km, h, kmask=km)[km > 0])
        attn_checks = count
        for m in S8_EDGE_M:
            for n in S8_EDGE_N:
                for k in S8_EDGE_K:
                    wq, sw = tq.quantize_linear(randn(k, n, scale=k ** -0.5))
                    w8 = tq.kernel_layout(wq)
                    codes, scale = tq.quant_rows_ref(randn(m, k))  # inputs: any codes do
                    bias = randn(n, scale=0.1)
                    frac = (randn(m, dtype=f32) > -0.5).to(bf16) * randn(m).abs().clamp(max=1)
                    r32, r16 = randn(m, n, dtype=f32), randn(m, n)
                    runs = [(epi, scale, res, mask) for epi, res, mask in (
                        ("bias", None, None), ("gelu_f32", None, None),
                        ("residual_f32", r16, None), ("residual", r32, None),
                        ("masked_residual_f32", r32, frac), ("masked_residual", r16, frac))]
                    runs.append(("bias.static_scale", tq.static_scale(QUANT_CAPS[0][0]), None,
                                 None))
                    for name, sa, res, mask in runs:
                        epi = name.split(".")[0]
                        got = tq.gemm_s8_epilogue(codes, sa, w8, sw, bias, epi, residual=res,
                                                  mask=mask)
                        want = tq.gemm_s8_epilogue_ref(codes, sa, w8, sw, bias, epi,
                                                       residual=res, mask=mask)
                        if got.shape != want.shape or got.dtype != want.dtype:
                            raise AssertionError(f"gemm_s8_epilogue.{name} at {(m, n, k)}: "
                                                 f"{got.shape} {got.dtype}")
                        key = f"gemm_s8_epilogue.{name}"
                        if epi == "gelu_f32":
                            held(key, got, want, 2.0 ** -20)
                        else:
                            share = (got == want).float().mean().item()
                            worst[key + ".bit_identical_share"] = min(
                                worst.get(key + ".bit_identical_share", 1.0), share)
                            if share != 1.0:
                                raise AssertionError(f"{key} at {(m, n, k)}: bit_identical_share "
                                                     f"{share} != 1.0")
                        same[f"{key}.{m}x{n}x{k}.rerun"] = torch.equal(got, tq.gemm_s8_epilogue(
                            codes, sa, w8, sw, bias, epi, residual=res, mask=mask))
                        count += 1
                    del codes, r32, r16, wq, w8
        torch.cuda.synchronize()
    s8_plans = {f"{m}x{n}": tq.gemm_s8_plan(m, n) for m in S8_EDGE_M for n in S8_EDGE_N}
    rows = ptxas_summary(build_info, ("attn_scores_pv", "gemm_s8_epilogue"))
    spilled = [r["kernel"] for r in rows if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    emit({"phase": "scores_pv_s8_edges", "attn_checks": attn_checks,
          "gemm_s8_checks": count - attn_checks, "worst": worst,
          "tolerance_rel": {"attn_scores_pv": 2e-2, "gemm_s8_epilogue.gelu_f32": 2.0 ** -20,
                            "gemm_s8_epilogue, every other epilogue": "bit-identical"},
          "attn_scores_pv_plan": plans, "gemm_s8_plan": s8_plans, "ex2_check": ex2,
          "checked_bit_identical": len(same), "differ": [k for k, v in same.items() if not v],
          "ptxas": rows if rows else "not rebuilt in this run", "spilled": spilled, "card": smi})
    if ex2["mismatches"] or ex2["checked"] != 1 << 32:
        raise AssertionError(f"packed exp2 terms differ from exp2f's: {ex2}")
    if not all(same.values()):
        differ = [k for k, v in same.items() if not v]
        raise AssertionError(f"scores_pv / s8 edges: bits differ {differ}")
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")


def merged_block_checks(torch, lv, randn, layer_w, d, h, n, smi) -> None:
    """Phase 28, whole blocks: layer_block_trainable and layer_block_hybrid
    against their _ref twins at bs32, N = 197, the output and all thirteen
    gradients; a second run of each backward must give the same bits."""
    tol = 3e-2
    xb = randn(BLOCK_BATCH, n, d, scale=1.5, shift=0.3)
    gb = randn(BLOCK_BATCH, n, d, scale=0.05)
    pairs = {"trainable": (lv.layer_block_trainable, lv.layer_block_trainable_ref),
             "hybrid": (lv.layer_block_hybrid, lv.layer_block_hybrid_ref)}
    for kind, (fn, ref_fn) in pairs.items():
        runs = []
        for f in (fn, ref_fn, fn):
            leaves = [t.detach().clone().requires_grad_() for t in (xb, *layer_w)]
            out = f(*leaves, h, EPS)
            out.backward(gb)
            torch.cuda.synchronize()
            runs.append({"out": out.detach(),
                         **{name: t.grad for name, t in zip(MERGED_GRAD_NAMES, leaves)}})
        err = rel_l2(torch, runs[0], runs[1])
        same = all(torch.equal(runs[0][k], runs[2][k]) for k in runs[0])
        emit({"phase": "merged_block_check", "block": kind, "batch": BLOCK_BATCH, "tokens": n,
              "rel_l2": err, "max_rel_l2": max(err.values()), "rerun_bit_identical": same,
              "tolerance_rel_l2": tol,
              "tolerance_reason": "same rounding points; bf16 roundings flipped by fp32 sums in "
                                  "another order through one layer forward and back; the "
                                  "port's gradient bar", "card": smi})
        if max(err.values()) > tol or not same:
            raise AssertionError(f"{kind} block: rel-L2 {err}, rerun bit-identical {same}")


def merged_train_phases(torch, F, fa, dev, smi, args) -> dict:
    """Phase 29: build_model("vit", ViT-B/16) with seeded weights,
    make_fused_train_step(AdamW(1e-4), merged=True) for five steps on one
    bs-64 batch, then the same from the same weights with merged="hybrid":
    counts zeroed just before and read just after each step (merged: 24
    wrapper calls and 4 gemm_wgrad summing launches per layer, held per
    key to merged_per_layer; hybrid: 7), losses finite and falling; one bs-16
    step's gradients of each against the same step on the plain versions.
    Returns the counts, the model and its batch maker."""
    from peekvit_torch import build_model
    from peekvit_torch.models.adapters import live_params, tree_leaves
    from peekvit_torch.ops.cuda import fused_layer_vjp as lv
    from peekvit_torch.training.fused import make_fused_train_step, trainable_forward_fn
    from peekvit_torch.training.optim import AdamW

    layers = args["num_layers"]
    model = build_model("vit", args, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # zero-initialised head and class tokens: re-drawn as in phase 4
        model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
        model.class_tokens.copy_(torch.randn(model.class_tokens.shape, generator=cpu_gen) * 0.02)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = live_params(model)
    gen = torch.Generator(device=dev).manual_seed(29)
    size = args["image_size"]

    def batch(b):
        return (torch.randn(b, size, size, 3, generator=gen, device=dev),
                torch.randint(0, args["num_classes"], (b,), generator=gen, device=dev))

    x64, y64 = batch(TRAIN_BATCH)
    tokens = (size // args["patch_size"]) ** 2 + 1
    per_layer = merged_per_layer(lv, TRAIN_BATCH * tokens, args["hidden_dim"], args["mlp_dim"])
    want = {"merged": {k: v * layers for k, v in per_layer.items()},
            "hybrid": {k: v * layers for k, v in MERGED_FWD_PER_LAYER.items()}}
    counts = {}
    for kind, merged in MERGED_PATHS[1:]:
        with torch.no_grad():
            model.load_state_dict(init)
        step = make_fused_train_step(model, AdamW(lr=TRAIN_LR).build(params), merged=merged)
        losses, totals = [], {}
        for _ in range(TRAIN_STEPS):
            fa.reset_launch_counts()
            losses.append(float(step(x64, y64)))
            torch.cuda.synchronize()
            got = dict(fa.LAUNCHES)
            if got != want[kind]:
                raise AssertionError(f"{kind} step launches {got}, want {want[kind]}")
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
        counts[kind] = totals
        emit({"phase": "merged_train", "merged": merged, "batch": TRAIN_BATCH,
              "steps": TRAIN_STEPS, "optimizer": f"AdamW(lr={TRAIN_LR})", "losses": losses,
              "launches_per_step": sum(want[kind].values()), "counts": totals, "card": smi})
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{kind} losses not finite and falling: {losses}")
    missing = [k for k in (*MERGED_NEW_KEYS, *(k for k in per_layer if k.startswith("gemm_wgrad")))
               if not counts["merged"].get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the merged step: {missing}")

    # One step's gradients at GRAD_BATCH against the plain versions, as
    # phase 7 (rel-L2 per leaf 3e-2, the repo's bf16 tolerance).
    tol_grad = 3e-2
    xg, yg = batch(GRAD_BATCH)

    def grads(**kwargs):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(trainable_forward_fn(model, **kwargs)(params, xg), yg)
        loss.backward()
        return float(loss.detach()), {name: p.grad.detach().clone()
                                      for name, p in tree_leaves(params)}

    for kind, merged in MERGED_PATHS[1:]:
        loss_k, g_k = grads(merged=merged)
        loss_p, g_p = grads(merged=merged, plain=True)
        err = rel_l2(torch, g_k, g_p)
        emit({"phase": "merged_train_grads", "merged": merged, "batch": GRAD_BATCH,
              "loss_kernels": loss_k, "loss_plain": loss_p, "leaves": len(g_k),
              "rel_l2_vs_plain": err, "max_rel_l2_vs_plain": max(err.values()),
              "tolerance_rel_l2": tol_grad,
              "tolerance_reason": "same rounding points; bf16 flips from fp32 sums in another "
                                  "order through 12 layers; the repo's bf16 tolerance",
              "card": smi})
        if max(err.values()) > tol_grad:
            raise AssertionError(f"{kind} train gradients out of tolerance")
    model.zero_grad(set_to_none=True)
    return {"counts": counts, "model": model, "params": params, "batch": batch,
            "layers": layers, "per_layer": per_layer}


def merged_timing(torch, F, fa, vjp, lv, smi, checks, ins, mtrain, x, y, ln_s, ln_b, g_rows,
                  dln_in, w1, b1, w2, d, m, rows, macs_per_image) -> list:
    """Phase 30 at bs256: the split, merged and hybrid steps on one model
    and one AdamW, in turns (split, merged, hybrid, hybrid, merged, split):
    ms per step, images/s, peak memory; each new kernel's time, launches
    on phase 29's merged steps, bound, plain time and one PyTorch call's
    time; one profiled merged step (warmed window). Returns the new
    kernels' entries."""
    from peekvit_torch.training.fused import make_fused_train_step
    from peekvit_torch.training.optim import AdamW

    model, params = mtrain["model"], mtrain["params"]
    xb, yb = mtrain["batch"](BATCH)
    opt = AdamW(lr=TRAIN_LR).build(params)
    steps = {kind: make_fused_train_step(model, opt, merged=merged)
             for kind, merged in MERGED_PATHS}
    flops_img = 3 * 2.0 * macs_per_image
    runs = {}
    for kind in ("split", "merged", "hybrid", "hybrid", "merged", "split"):
        step = steps[kind]
        for _ in range(2):
            step(xb, yb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        ms = cuda_ms(torch, lambda: step(xb, yb), iters=5)
        peak = torch.cuda.max_memory_allocated()
        runs.setdefault(kind, []).append((ms, peak / 2 ** 30, (peak - start) / 2 ** 30))
        emit({"phase": "timing_merged_step", "path": kind, "batch": BATCH, "ms_per_step": ms,
              "images_per_s": BATCH / ms * 1e3,
              "share_of_bf16_peak": flops_img * BATCH / (ms / 1e3) / PEAK_BF16_FLOPS,
              "peak_memory_gib": peak / 2 ** 30, "step_memory_gib": (peak - start) / 2 ** 30,
              "card": smi})
    mean = {k: sum(r[0] for r in v) / len(v) for k, v in runs.items()}
    emit({"phase": "timing_merged_summary", "batch": BATCH, "ms_per_step": mean,
          "peak_memory_gib": {k: max(r[1] for r in v) for k, v in runs.items()},
          "step_memory_gib": {k: max(r[2] for r in v) for k, v in runs.items()},
          "ratio_to_split": {k: mean[k] / mean["split"] for k in mean},
          "launches_per_step": {"merged": sum(mtrain["per_layer"].values()) * mtrain["layers"],
                                "hybrid": sum(MERGED_FWD_PER_LAYER.values()) * mtrain["layers"],
                                "split": sum(TRAIN_PER_LAYER.values()) * mtrain["layers"]},
          "note": "one model and one AdamW (no clipping) for all three; peak memory is the "
                  "process's (the earlier phases' tensors, the weights, gradients and AdamW "
                  "state included), step memory the peak above what was allocated before the "
                  "timed steps", "card": smi})

    bf, f4 = 2, 4
    bf16 = torch.bfloat16
    counts = mtrain["counts"]["merged"]
    src = "peekvit_torch/csrc/"
    y_leaves = [y.detach().clone().requires_grad_(), ln_s.float().requires_grad_(),
                torch.zeros(d, device=y.device, requires_grad=True)]
    y_out = F.layer_norm(y_leaves[0], (d,), y_leaves[1], y_leaves[2], EPS)
    x_leaves = [x.detach().clone().requires_grad_(), ln_s.detach().clone().requires_grad_(),
                torch.zeros_like(ln_s, requires_grad=True)]
    x_out = F.layer_norm(x_leaves[0], (d,), x_leaves[1], x_leaves[2], EPS)
    ln2, hpre, dy = ins["ln2"], ins["hpre"], ins["dy"]
    g32, dy16 = g_rows.clone().float(), dy.clone().to(bf16)  # ordinary tensors for autograd
    parts_gemm, parts_ln = -(-rows // 128), -(-rows // vjp.ROWS_PER_PARTIAL)
    bwd = f"{REPLACES_LAYER}:330 _trainable_bwd (_layer_bwd_kernel :135)"
    # name, count key, launches, source, replaces, kernel, plain, library call, library,
    # flops, bytes
    timed = [
        ("ln_rows.f32", "ln_rows.f32", counts["ln_rows.f32"], src + "norm_rows.cu",
         f"{REPLACES_LAYER}:278 _fwd_call (_layer_fwd_kernel :107, LN2 on the fp32 y :122) and "
         f"{bwd} :181",
         lambda: fa.ln_rows(y, ln_s, ln_b, EPS, out_dtype=bf16),
         lambda: fa.ln_rows_ref(y, ln_s, ln_b, EPS, out_dtype=bf16),
         lambda: F.layer_norm(y, (d,), ln_s.float(), ln_b.float(), EPS).to(bf16),
         "F.layer_norm (fp32) + .to(bf16)", 8.0 * rows * d, rows * d * (f4 + bf) + 2 * d * bf),
        ("gemm_bias_epilogue.gelu_hpre", "gemm_bias_epilogue.gelu_hpre",
         counts["gemm_bias_epilogue.gelu_hpre"], src + "gemm_bias_epilogue.cu",
         f"{bwd}: fc1 recompute :184-186",
         lambda: fa.gemm_gelu_hpre(ln2, w1, b1), lambda: fa.gemm_gelu_hpre_ref(ln2, w1, b1),
         lambda: (lambda hp: (F.gelu(hp, approximate="tanh"), hp.float()))(
             torch.addmm(b1, ln2, w1)),
         "addmm (bf16 out) + gelu + .float()", 2.0 * rows * d * m,
         (rows * d + d * m + m) * bf + rows * m * (bf + f4)),
        ("gemm_nt.gelu_grad", "gemm_nt.gelu_grad", counts["gemm_nt.gelu_grad"],
         src + "gemm_bias_epilogue.cu", f"{bwd}: dh = g W2^T, dhpre, db1 :193-202",
         lambda: fa.gemm_nt_gelu_grad(g_rows, w2, hpre),
         lambda: fa.gemm_nt_gelu_grad_ref(g_rows, w2, hpre),
         lambda: (lambda dh: (dh.to(bf16), dh.sum(0)))(
             torch.matmul(g_rows, w2.t()).float() * fa.gelu_tanh_grad(hpre)),
         "matmul (bf16 out) + eager gelu' + cast + column sum", 2.0 * rows * d * m,
         (rows * d + m * d) * bf + rows * m * (f4 + bf) + parts_gemm * m * f4),
        ("ln_bwd_rows.f32", "ln_bwd_rows.f32", counts["ln_bwd_rows.f32"], src + "ln_bwd_rows.cu",
         f"{bwd}: LN2 backward, dy, dbo :206-215",
         lambda: vjp.ln_bwd_rows_f32(y, dln_in, g_rows, ln_s, EPS),
         lambda: vjp.ln_bwd_rows_f32_ref(y, dln_in, g_rows, ln_s, EPS),
         lambda: torch.autograd.grad(y_out, y_leaves, g32, retain_graph=True),
         "F.layer_norm backward (fp32)", 25.0 * rows * d,
         rows * d * (f4 + f4 + bf + f4 + bf) + d * bf + 3 * parts_ln * d * f4),
        ("ln_bwd_rows.g_f32", "ln_bwd_rows.g_f32", counts["ln_bwd_rows.g_f32"],
         src + "ln_bwd_rows.cu", f"{bwd}: LN1 backward + dy :259-265",
         lambda: vjp.ln_bwd_rows(x, dln_in, dy, ln_s, EPS),
         lambda: vjp.ln_bwd_rows_ref(x, dln_in, dy, ln_s, EPS),
         lambda: torch.autograd.grad(x_out, x_leaves, dy16, retain_graph=True),
         "F.layer_norm backward", 20.0 * rows * d,
         rows * d * (bf + f4 + f4 + bf) + d * bf + 2 * parts_ln * d * f4),
    ]
    lines = {"dwqkv": ":255-258 dWqkv = ln1^T dqkv, dbqkv", "dwo": ":212-215 dWo = attn^T dy_b",
             "dw1": ":199-201 dW1 = ln2b^T dhpre_b", "dw2": ":189-192 dW2 = h^T g, db2"}
    for name, (a, b, colsum) in ins["wgrad"].items():
        kk, nn_ = a.shape[1], b.shape[1]
        key = f"gemm_wgrad.{kk}x{nn_}"
        timed.append((f"gemm_wgrad.{name}", key, counts.get(key, 0),
                      src + "gemm_wgrad.cu", f"{bwd}: {lines[name]}",
                      lambda a=a, b=b, c=colsum: lv.gemm_wgrad(a, b, colsum=c),
                      lambda a=a, b=b, c=colsum: lv.gemm_wgrad_ref(a, b, colsum=c),
                      lambda a=a, b=b: torch.matmul(a.t(), b),
                      "a.t() @ b, bf16 out (cuBLAS)", 2.0 * rows * kk * nn_,
                      rows * (kk + nn_) * bf + kk * nn_ * f4 + (nn_ * f4 if colsum else 0)))
    entries = []
    for name, key, launches, source, replaces, kfn, pfn, lfn, library, flops, nbytes in timed:
        with torch.inference_mode():
            ms = cuda_ms(torch, kfn)
            dev_ms = graph_ms(torch, kfn)
            plain_ms = cuda_ms(torch, pfn, iters=5)
        lib_ms = cuda_ms(torch, lfn)  # outside inference mode: two calls are autograd's
        bnd, by = bound_ms(flops, nbytes)
        if launches == 0:
            raise AssertionError(f"{name}: never launched on the merged step")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": checks[name], "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                 "library_ms": lib_ms, "path": "merged train step", "shape_batch": BATCH,
                 "count_key": key}
        if name.startswith("gemm_wgrad."):  # its summing launches, timed within ms
            entry["reduce_launches"] = counts.get(f"{key}.reduce", 0)
        emit({"phase": "timing_kernel", **entry, "share_of_bound": bnd / ms,
              "library": library, "launches_per_step": launches // TRAIN_STEPS, "card": smi})
        entries.append(entry)
    wgrad_ms = sum(e["ms"] for e in entries if e["name"].startswith("gemm_wgrad."))
    emit({"phase": "timing_wgrad_per_layer", "ms": wgrad_ms,
          "bound_ms": sum(e["bound_ms"] for e in entries if e["name"].startswith("gemm_wgrad.")),
          "library_ms": sum(e["library_ms"] for e in entries
                            if e["name"].startswith("gemm_wgrad.")), "card": smi})
    profile_step(torch, smi, lambda: steps["merged"](xb, yb), mean["merged"],
                 phase="profile_merged_train_step", warmup=True)
    return entries


def module_path_phases(torch, F, fa, dev, smi, check, checks, qkv, q, k, v, d, h,
                       n) -> dict:
    """Phase 31: build_model("vit", ViT-B/16) (phase 4's seeded weights) in
    eval mode, bf16, on the card, under set_attention_impl("pallas")
    serves 8 and 256 images: counts zeroed just before and read just after
    each forward (12 attn_scores_pv launches, nothing else), logits
    against the same module under "xla" at 3e-2 of max|logit| and top-1
    on every decided image; both forwards timed at bs256. Then the grad
    guard (a forward that needs a gradient) and the fp32 guard (an fp32
    module) must raise. fused_mhsa and fused_attention at (256, 197, 768)
    against their plain versions, timed beside SDPA; one counted
    fused_attention launch. Returns the counts and the new entry."""
    from peekvit_torch import build_model
    from peekvit_torch.ops import set_attention_impl

    bf16 = torch.bfloat16
    model = build_model("vit", B16, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # phase 4's re-drawn head and class tokens
        model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
        model.class_tokens.copy_(torch.randn(model.class_tokens.shape, generator=cpu_gen) * 0.02)
    gen = torch.Generator(device=dev).manual_seed(31)
    size = B16["image_size"]
    requests = [torch.randn(b, size, size, 3, generator=gen, device=dev).to(bf16)
                for b in MODULE_REQUESTS]
    totals, guards = {}, {}
    try:
        set_attention_impl("pallas")
        try:  # an fp32 module on the card: the kernels take bf16 only (B15)
            with torch.inference_mode():
                model(requests[0].float())
            guards["fp32"] = "did not raise"
        except NotImplementedError as e:
            guards["fp32"] = str(e)
        model.to(bf16)
        try:  # the kernel has no backward: a forward that needs a gradient raises
            model(requests[0])
            guards["grad"] = "did not raise"
        except RuntimeError as e:
            guards["grad"] = str(e)
        emit({"phase": "module_guards", **guards, "card": smi})
        if "item 15" not in guards["fp32"] or "no backward" not in guards["grad"]:
            raise AssertionError(f"module-path guards: {guards}")
        with torch.inference_mode():
            for images in requests:
                set_attention_impl("pallas")
                fa.reset_launch_counts()
                got, _ = model(images)
                torch.cuda.synchronize()
                counts = dict(fa.LAUNCHES)
                if counts != {"attn_scores_pv": B16["num_layers"]}:
                    raise AssertionError(f"module forward launches {counts}")
                for key, val in counts.items():
                    totals[key] = totals.get(key, 0) + val
                set_attention_impl("xla")
                ref, _ = model(images)
                delta = (got.float() - ref.float()).abs()
                spread = ref.float().abs().max().item()
                srt = ref.float().sort(dim=-1).values
                decided = (srt[:, -1] - srt[:, -2]) > 2 * delta.max()
                agree = got.argmax(-1) == ref.argmax(-1)
                rec = {"phase": "module_check", "batch": images.shape[0], "launches": counts,
                       "max_abs_delta": delta.max().item(), "logit_spread": spread,
                       "tolerance": 3e-2, "top1_agreement": agree.float().mean().item(),
                       "decided": int(decided.sum()),
                       "tolerance_reason": "the exp2 softmax against the module's max-"
                                           "subtracted one agree up to bf16 rounding inside "
                                           "the clamp; PERF.md section 2's bf16 bar",
                       "card": smi}
                emit(rec)
                if not torch.isfinite(got).all() or delta.max().item() > 3e-2 * spread:
                    raise AssertionError(f"module logits under pallas: {rec}")
                if not agree[decided].all():
                    raise AssertionError(f"module top-1 differs on a decided image: {rec}")
            images = requests[-1]
            forward_ms = {}
            for impl in ("pallas", "xla", "xla", "pallas"):
                set_attention_impl(impl)
                forward_ms.setdefault(impl, []).append(
                    cuda_ms(torch, lambda: model(images), iters=5))
            emit({"phase": "timing_module", "batch": BATCH, "ms_per_forward": forward_ms,
                  "images_per_s": {k: BATCH / (sum(v) / len(v)) * 1e3
                                   for k, v in forward_ms.items()}, "card": smi})

            # the two attention functions alone at ViT-B/16 bs256
            sdpa = [t.reshape(BATCH, n, h, d // h).transpose(1, 2).contiguous() for t in (q, k, v)]
            check("fused_mhsa", fa.fused_mhsa(qkv, h), fa.fused_mhsa_ref(qkv, h), 2e-2,
                  "bf16 rounding of logits before exp2, bf16 output rounding (attn_scores_pv)")
            fa.reset_launch_counts()
            fa.fused_attention(q, k, v, h)
            torch.cuda.synchronize()
            sep_counts = dict(fa.LAUNCHES)
            if sep_counts != {"attn_softmax_fwd.separate": 1}:
                raise AssertionError(f"fused_attention launches {sep_counts}")
            alone = {}
            for name, kfn, pfn in (
                    ("fused_mhsa", lambda: fa.fused_mhsa(qkv, h),
                     lambda: fa.fused_mhsa_ref(qkv, h)),
                    ("fused_attention", lambda: fa.fused_attention(q, k, v, h),
                     lambda: fa.fused_attention_ref(q, k, v, h))):
                alone[name] = {"ms": cuda_ms(torch, kfn), "plain_ms": cuda_ms(torch, pfn, iters=5)}
            sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*sdpa))
            emit({"phase": "timing_attention_sites", "batch": BATCH, "tokens": n, "heads": h,
                  **alone, "sdpa_ms": sdpa_ms, "fused_mhsa_max_abs_err": checks["fused_mhsa"],
                  "fused_attention_max_abs_err": checks["attn_softmax_fwd.separate"],
                  "card": smi})
    finally:
        set_attention_impl("xla")
    bnd, by = bound_ms(4.0 * BATCH * h * n * n * (d // h), BATCH * n * 4 * d * 2)
    entry = {"name": "attn_softmax_fwd.separate", "route": "cuda",
             "source": "peekvit_torch/csrc/attn_softmax_fwd.cu",
             "replaces": f"{REPLACES}:220 fused_attention (_attn_kernel :168)",
             "launches": sep_counts["attn_softmax_fwd.separate"],
             "max_abs_err": checks["attn_softmax_fwd.separate"],
             "ms": alone["fused_attention"]["ms"], "plain_ms": alone["fused_attention"]["plain_ms"],
             "bound_ms": bnd, "bound_by": by, "library_ms": sdpa_ms,
             "path": "fused_attention alone (no engine path; JAX's tests only)",
             "shape_batch": BATCH, "count_key": "attn_softmax_fwd.separate"}
    emit({"phase": "timing_kernel", **entry, "share_of_bound": bnd / entry["ms"],
          "library": "SDPA", "card": smi})
    return {"counts": totals, "entry": entry, "alone": sep_counts, "mhsa": alone["fused_mhsa"]}


REPLACES_TP = "peekvit_tpu/ops/pallas/tp_blocks.py"
TP_MODELS = (2, 4)                  # model-axis sizes: ranks on one card
TP_SHAPE_BATCHES = (8, 256)         # the partials' checks and timings
TP_REQUEST = 8                      # the TP engines' checked request
TP_TIMING_BATCHES = (1, 8)          # the TP forward's timed batches
TP_TIMING_ITERS = 10
TP_JOIN_TIMEOUT = 400.0             # seconds for every rank of one spawn
# configs/model/eeresidualvit.yaml at image 224 and 1000 classes
EE_YAML = dict(image_size=224, patch_size=8, hidden_dim=256, mlp_dim=768, num_layers=4,
               num_heads=4, num_classes=1000, residual_layers=["attention+mlp"] * 4,
               gate_temp=1, add_input=False, gate_type="sigmoid", gate_threshold=0.5,
               gate_bias=0, add_budget_token="learnable", attention_dropout=0.0, dropout=0.0)
TP_RUNS = (("vit", (None,)), ("rankvit", (0.5, 1.0)), ("residualvit", (0.5,)),
           ("eeresidualvit", (0.5,)))
# Launches per layer of one TP forward on each rank: the attention
# partial (norm, qkv GEMM, attention, partial_f32 GEMM) and the MLP
# partial (norm, fc1 GEMM, partial_f32 GEMM); every norm reads bf16 tokens.
TP_PER_LAYER = {"norm_rows.bf16": 2, "gemm_bias_epilogue.bias": 1, "attn_scores_pv": 1,
                "gemm_bias_epilogue.gelu": 1, "gemm_bias_epilogue.partial_f32": 2}
TP_RES_PER_LAYER = dict({"norm_rows.masked.bf16": 2},
                        **{k: v for k, v in TP_PER_LAYER.items() if k != "norm_rows.bf16"})
TP_SITES = {  # composition -> (site, Pallas line, launches per call)
    "tp_attention_partial": (25, 91, 4), "tp_masked_attention_partial": (26, 173, 4),
    "tp_masked_mlp_partial": (27, 231, 3), "tp_mlp_partial": (28, 277, 3)}


def tp_model(torch, name: str):
    """The seeded model of a TP run on the card: ViT-B/16 and RankViT-B/16
    as in phases 4 and 16, ResidualViT-B/16 as in phase 10, the EE
    ResidualViT at configs/model/eeresidualvit.yaml's widths (heads, class
    token and exit heads re-drawn at std 0.02). The same bits in every
    process: the weights come from seeded CPU generators."""
    from peekvit_torch import build_model

    if name in ("residualvit", "eeresidualvit"):
        return seeded_residual_model(torch, name, EE_YAML if name == "eeresidualvit" else None)
    model = build_model(name, B16 if name == "vit" else RANKVIT_B16, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model.head.kernel.copy_(torch.randn(model.head.kernel.shape, generator=cpu_gen) * 0.02)
        model.class_tokens.copy_(torch.randn(model.class_tokens.shape, generator=cpu_gen) * 0.02)
    return model


def tp_images(torch, batch: int):
    """A TP request: seeded on the CPU, so every process draws the same."""
    gen = torch.Generator().manual_seed(33 + batch)
    size = B16["image_size"]
    return torch.randn(batch, size, size, 3, generator=gen).to(DEVICE)


def tp_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """Phase 33, one rank of a pure-TP mesh (n_data 1, n_model = world) on
    cuda:0 over gloo: every run of TP_RUNS at TP_REQUEST images (launch
    counts zeroed just before each forward and read just after), then the
    ViT-B/16 TP forward timed at TP_TIMING_BATCHES (host clock around
    TP_TIMING_ITERS forwards ending in a synchronize, after a warm-up and a
    barrier). Writes rank<r>.pt into out_dir."""
    import torch
    import torch.distributed as dist

    from peekvit_torch import InferenceEngine
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.parallel import make_mesh
    from peekvit_torch.parallel.tp_serving import make_tp_vit_forward

    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(n_data=1, n_model=world, device=DEVICE)  # cuda:0 on one card
        res = {"device": str(mesh.device), "logits": {}, "counts": {}, "ms": {}, "kept": {}}
        images = {b: tp_images(torch, b) for b in set(TP_TIMING_BATCHES) | {TP_REQUEST}}
        for name, budgets in TP_RUNS:
            model = tp_model(torch, name)
            engine = InferenceEngine(model, device=DEVICE, mesh=mesh,
                                     ee_outputs=name == "eeresidualvit")
            for budget in budgets:
                key = f"{name}/{budget}"
                fa.reset_launch_counts()
                out = engine(images[TP_REQUEST], budget=budget)
                torch.cuda.synchronize()
                res["counts"][key] = dict(fa.LAUNCHES)
                res["logits"][key] = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]
                if name == "rankvit" and budget < 1.0:
                    # the same forward again, uncounted, for its kept indices
                    kept = {}
                    again = make_tp_vit_forward(
                        mesh, num_heads=model.num_heads, patch_size=model.patch_size,
                        num_class_tokens=model.num_class_tokens, ln_eps=model.ln_eps,
                        rank_layers=model.rankvit_layers, budget=budget,
                        kept_out=kept)(engine.params, images[TP_REQUEST])
                    if not torch.equal(again, out):
                        raise AssertionError(f"TP {key}: a rerun gave other logits")
                    res["kept"][key] = {li: idx.cpu() for li, idx in kept.items()}
            if name == "vit":
                for b in TP_TIMING_BATCHES:
                    engine(images[b])
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    for _ in range(TP_TIMING_ITERS):
                        engine(images[b])
                    torch.cuda.synchronize()
                    res["ms"][b] = (time.perf_counter() - t0) / TP_TIMING_ITERS * 1e3
            del engine, model
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, fn, world: int, args: tuple, timeout: float) -> None:
    """Runs fn(rank, *args) in ``world`` spawned processes (no CUDA context
    is forked) and joins them: a rank's exception fails the phase, and ranks
    still running at the deadline are killed and fail it too."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def tp_shard_weights(torch, n_model: int, bf16) -> dict:
    """Layer 0's shard-0 slices at ViT-B/16 widths from the seeded models,
    cut by the port's prepare functions: the folded ViT slices (sites 25,
    28) and the unfolded ResidualViT slices with their LN affines (26,
    27), and the single-device layers' weights for the Megatron identity
    (every shard)."""
    from peekvit_torch.inference import prepare_engine_params
    from peekvit_torch.models.adapters import module_params
    from peekvit_torch.parallel.tp_serving import (
        prepare_tp_residual_serving_params,
        prepare_tp_serving_params,
    )

    h = B16["num_heads"]
    vit, res = module_params(tp_model(torch, "vit")), module_params(tp_model(torch, "residualvit"))
    return {"vit": prepare_tp_serving_params(vit, n_model, h, bf16),
            "res": prepare_tp_residual_serving_params(res, n_model, h, bf16),
            "vit_layer": prepare_engine_params(vit, bf16, fold_ln=True)["encoder"]["layers_0"],
            "res_layer": prepare_engine_params(res, bf16)["encoder"]["layers_0"]}


def tp_site_args(w: dict, s: int, x, mask) -> dict:
    """Each composition's arguments for shard s of layer 0; ``x`` holds the
    ViT-width ("vit", N = 197) and residual-width ("res", N = 198) tokens
    (either may be missing)."""
    tv, tr, sr = w["vit"]["tp"], w["res"]["tp"], w["res"]["shared"]
    xv, xr = x.get("vit"), x.get("res")
    return {"tp_attention_partial": (xv, tv["wqkv"][s, 0], tv["bqkv"][s, 0], tv["wo"][s, 0]),
            "tp_masked_attention_partial": (xr, mask, sr["ln1s"][0], sr["ln1b"][0],
                                            tr["wqkv"][s, 0], tr["bqkv"][s, 0], tr["wo"][s, 0]),
            "tp_masked_mlp_partial": (xr, mask, sr["ln2s"][0], sr["ln2b"][0],
                                      tr["w1"][s, 0], tr["b1"][s, 0], tr["w2"][s, 0]),
            "tp_mlp_partial": (xv, tv["w1"][s, 0], tv["b1"][s, 0], tv["w2"][s, 0])}


def tp_call(ttp, name: str, args: tuple, heads_local: int, plain: bool = False):
    fn = getattr(ttp, name + ("_ref" if plain else ""))
    return fn(*args, heads_local) if name.endswith("attention_partial") else fn(*args)


def tp_kernel_checks(torch, fa, check, randn, smi) -> dict:
    """Phase 32: the GEMM epilogue partial_f32 against its plain version at
    the four partial shapes of ViT-B/16 (out-projection K = 384 / 192, fc2
    K = 1536 / 768 for n_model 2 / 4; N = 768) at bs256 and bs8, and GEMM
    bias at the qkv width N = 576 (n_model 4, not a multiple of the 128
    tile); each of sites 25-28 against its plain version for n_model 2 and
    4 at bs8 and bs256 (layer 0's shard-0 slices of the seeded models);
    the Megatron identity at bs8: the shards' partials summed, plus bias
    and residual, against the single-device kernels' layer
    (fused_layer_block_folded / masked_layer_block). Returns the inputs
    for the timing."""
    from peekvit_torch.ops.cuda import tp_blocks as ttp

    bf16 = torch.bfloat16
    d, m, h = B16["hidden_dim"], B16["mlp_dim"], B16["num_heads"]
    n_vit = (B16["image_size"] // B16["patch_size"]) ** 2 + 1
    tol_bf16, tol_f32, tol_attn = 2.0 ** -6, 1e-3, 2e-2
    ins = {"gemm": {}, "x": {}, "mask": {}, "w": {}}
    with torch.inference_mode():
        for b in TP_SHAPE_BATCHES:
            rows = b * n_vit
            for k in sorted({d // n for n in TP_MODELS} | {m // n for n in TP_MODELS}):
                a, w = randn(rows, k), randn(k, d, scale=k ** -0.5)
                ins["gemm"][(b, k)] = (a, w)
                check(f"gemm_bias_epilogue.partial_f32.k{k}.bs{b}", fa.gemm_partial_f32(a, w),
                      fa.gemm_partial_f32_ref(a, w), tol_f32,
                      f"tensor-core fp32 accumulation against cuBLAS fp32 in another order "
                      f"over K = {k}")
            ins["x"][b] = {"vit": randn(b, n_vit, d, scale=1.5, shift=0.3),
                           "res": randn(b, n_vit + 1, d, scale=1.5, shift=0.3)}
            mask = torch.clamp(randn(b, n_vit + 1, 1, dtype=torch.float32, scale=0.5, shift=0.2),
                               0.0, 1.0)
            mask[:, 0] = mask[:, -1] = 1.0  # the class and budget tokens
            ins["mask"][b] = mask.to(bf16)
        a, w, bias = randn(BATCH * n_vit, d), randn(d, 576, scale=d ** -0.5), randn(576, scale=0.1)
        check("gemm_bias_epilogue.bias.n576", fa.gemm_bias_epilogue(a, w, bias, "bias"),
              fa.gemm_bias_epilogue_ref(a, w, bias, "bias"), tol_bf16,
              "fp32 sums in another order, bf16 output rounding; N = 576 leaves a ragged "
              "64-column tile")
        for n_model in TP_MODELS:
            w = ins["w"][n_model] = tp_shard_weights(torch, n_model, bf16)
            hl = h // n_model
            for b in TP_SHAPE_BATCHES:
                for name, args in tp_site_args(w, 0, ins["x"][b], ins["mask"][b]).items():
                    attn = "attention" in name
                    check(f"{name}.n{n_model}.bs{b}", tp_call(ttp, name, args, hl),
                          tp_call(ttp, name, args, hl, plain=True), tol_attn if attn else tol_bf16,
                          "bf16 roundings of the normalized rows, qkv and the attention output "
                          "(flipped by fp32 sums in another order) feed an fp32 product"
                          if attn else "bf16 roundings of the normalized rows and of gelu's "
                          "output feed an fp32 product")
            # the Megatron identity, bs8: every shard's partials summed, then
            # bias and residual once, as the engine's epilogues
            x, mask = ins["x"][TP_SHAPE_BATCHES[0]], ins["mask"][TP_SHAPE_BATCHES[0]]

            def psum(name, x_in, w=w, hl=hl, n_model=n_model, mask=mask):
                return sum(tp_call(ttp, name, tp_site_args(w, s, x_in, mask)[name], hl)
                           for s in range(n_model))

            reason = ("the TP path rounds the mid residual y to bf16 after the all-reduce, the "
                      "single-device layer keeps it in fp32: the bf16 engine tolerance")
            sv, lv = w["vit"]["shared"], w["vit_layer"]
            y = (x["vit"].float() + psum("tp_attention_partial", x)
                 + sv["bo"][0].float()).to(bf16)
            got = (y.float() + psum("tp_mlp_partial", {"vit": y})
                   + sv["b2"][0].float()).to(bf16)
            want = fa.fused_layer_block_folded(
                x["vit"], lv["_folded_qkv"]["kernel"], lv["_folded_qkv"]["bias"],
                lv["self_attention"]["out_proj_kernel"], lv["self_attention"]["out_proj_bias"],
                lv["_folded_fc1"]["kernel"], lv["_folded_fc1"]["bias"], lv["mlp"]["fc2_kernel"],
                lv["mlp"]["fc2_bias"], h)
            check(f"megatron_identity.plain.n{n_model}", got, want, 3e-2, reason)
            sr, lr = w["res"]["shared"], w["res_layer"]
            y = ((psum("tp_masked_attention_partial", x) + sr["bo"][0].float()) * mask.float()
                 + x["res"].float()).to(bf16)
            got = (psum("tp_masked_mlp_partial", {"res": y}) + sr["b2"][0].float()
                   + y.float()).to(bf16)
            at, mlp = lr["self_attention"], lr["mlp"]
            want = fa.masked_layer_block(
                x["res"], mask, lr["ln_1"]["scale"], lr["ln_1"]["bias"], at["in_proj_kernel"],
                at["in_proj_bias"], at["out_proj_kernel"], at["out_proj_bias"],
                lr["ln_2"]["scale"], lr["ln_2"]["bias"], mlp["fc1_kernel"], mlp["fc1_bias"],
                mlp["fc2_kernel"], mlp["fc2_bias"], h, BLOCK_EPS)
            check(f"megatron_identity.masked.n{n_model}", got, want, 3e-2, reason)
        torch.cuda.synchronize()
    emit({"phase": "tp_kernel_checks", "checked": len(TP_MODELS) * len(TP_SHAPE_BATCHES) * 4,
          "card": smi})
    return ins


def tp_phases(torch, fa, smi) -> dict:
    """Phase 33: the TP engines as n_model spawned ranks on cuda:0 over a
    gloo group (n_data 1), for n_model 2 and 4: every rank's logits equal
    every other rank's bit for bit and hold against the single-device
    engine on the card (bf16 3e-2, top-1 on every decided image, as
    compare_logits); launches per rank per forward 7 per layer (84 for a
    ViT-B/16 forward), every key of the path; the ViT-B/16 TP forward per
    rank at bs1 and bs8 beside the single-device engine's. Returns the
    launches summed over every rank and forward, by key."""
    import shutil

    from peekvit_torch import InferenceEngine
    from peekvit_torch.inference import rankvit_forward_fused, rankvit_forward_plain
    from peekvit_torch.ops.cuda import _build

    refs, single_ms, rank_kept = {}, {}, {}
    with torch.inference_mode():
        images = {b: tp_images(torch, b) for b in set(TP_TIMING_BATCHES) | {TP_REQUEST}}
    for name, budgets in TP_RUNS:
        model = tp_model(torch, name)
        engine = InferenceEngine(model, device=DEVICE, ee_outputs=name == "eeresidualvit")
        for budget in budgets:
            out = engine(images[TP_REQUEST], budget=budget)
            refs[f"{name}/{budget}"] = out if isinstance(out, tuple) else (out,)
        if name == "vit":
            single_ms = {b: cuda_ms(torch, lambda b=b: engine(images[b]), iters=TP_TIMING_ITERS)
                         for b in TP_TIMING_BATCHES}
        if name == "rankvit":
            # a bf16 norm tie at the keep boundary flips kept sets between two
            # roundings of the same layers (phase 16), so the dropping runs are
            # held against the plain twin fed the TP run's kept indices
            rank_fwd = dict(patch_size=model.patch_size, num_heads=model.num_heads,
                            rankvit_layers=model.rankvit_layers,
                            num_class_tokens=model.num_class_tokens, ln_eps=model.ln_eps)
            rank_params = engine.params
            with torch.inference_mode():
                for budget in budgets:
                    if budget < 1.0:
                        kept = rank_kept[f"{name}/{budget}"] = {}
                        rankvit_forward_fused(rank_params, images[TP_REQUEST], budget=budget,
                                              kept_out=kept, **rank_fwd)
        del engine, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _build.build_all()  # every library built before a rank starts: no rank runs nvcc
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tp_smoke")
    totals, calls = {}, {}
    for n_model in TP_MODELS:
        out_dir = os.path.join(root, f"n{n_model}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        spawn_ranks(torch, tp_rank, n_model, (n_model, os.path.join(out_dir, "rdzv"), out_dir),
                    TP_JOIN_TIMEOUT)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(n_model)]
        for key, ref in refs.items():
            name, layers = key.split("/")[0], (EE_YAML if key.startswith("ee") else B16)[
                "num_layers"]
            per_layer = TP_RES_PER_LAYER if "residual" in name else TP_PER_LAYER
            want_counts = {k: v * layers for k, v in per_layer.items()}
            for r, rank in enumerate(ranks):
                if rank["counts"][key] != want_counts:
                    raise AssertionError(f"TP {key} rank {r} launches {rank['counts'][key]}, "
                                         f"want {want_counts}")
                same = all(torch.equal(a, b) for a, b in zip(rank["logits"][key],
                                                             ranks[0]["logits"][key]))
                same = same and all(torch.equal(idx, ranks[0]["kept"][key][li])
                                    for li, idx in rank["kept"].get(key, {}).items())
                if not same:
                    raise AssertionError(f"TP {key}: rank {r}'s outputs differ from rank 0's")
                for k, v in rank["counts"][key].items():
                    totals[k] = totals.get(k, 0) + v
            attn_comp, mlp_comp = (("tp_masked_attention_partial", "tp_masked_mlp_partial")
                                   if "residual" in name
                                   else ("tp_attention_partial", "tp_mlp_partial"))
            calls[attn_comp] = calls.get(attn_comp, 0) + want_counts["attn_scores_pv"] * n_model
            calls[mlp_comp] = (calls.get(mlp_comp, 0)
                               + want_counts["gemm_bias_epilogue.gelu"] * n_model)
            got = [t.to(DEVICE) for t in ranks[0]["logits"][key]]
            if len(got) != len(ref):
                raise AssertionError(f"TP {key}: {len(got)} outputs, want {len(ref)}")
            extra = {}
            if key in rank_kept:
                kept = {li: idx.to(DEVICE) for li, idx in ranks[0]["kept"][key].items()}
                extra["kept_sets_as_single_device"] = {
                    li: (kept[li].sort(-1).values == idx.sort(-1).values).all(-1).float()
                    .mean().item() for li, idx in rank_kept[key].items()}
                delta = (got[0] - ref[0]).abs()
                extra["single_device"] = {
                    "max_abs_delta": delta.max().item(),
                    "top1_agreement": (got[0].argmax(-1) == ref[0].argmax(-1)).float()
                    .mean().item()}
                with torch.inference_mode():
                    ref = (rankvit_forward_plain(rank_params, images[TP_REQUEST],
                                                 budget=float(key.split("/")[1]), kept_idx=kept,
                                                 compute_dtype=torch.bfloat16, **rank_fwd),)
                against = "plain_twin_on_tp_kept"
            else:
                against = "single_device"
            recs = [compare_logits(torch, f"TP n_model={n_model} {key} output {i}", g.float(),
                                   [(against, r.float(), 3e-2, 3e-2)])
                    for i, (g, r) in enumerate(zip(got, ref))]
            emit({"phase": "tp_check", "n_model": n_model, "run": key, "batch": TP_REQUEST,
                  "outputs": len(got), "ranks_bit_identical": True,
                  "launches_per_rank": sum(want_counts.values()), "final": recs[-1], **extra,
                  "tolerance_reason": "bf16 engine tolerance: the TP path rounds the mid "
                                      "residual to bf16 and sums the fp32 partials in another "
                                      "order than the single-device layer",
                  "card": smi})
        emit({"phase": "timing_tp", "n_model": n_model, "ranks_device": ranks[0]["device"],
              "seconds_for_spawn": seconds,
              "ms_per_forward_by_rank": {b: [rk["ms"][b] for rk in ranks]
                                         for b in TP_TIMING_BATCHES},
              "single_device_ms": single_ms,
              "label": f"gloo through the host, {n_model} processes sharing one card: says "
                       "nothing about NCCL on separate cards",
              "card": smi})
    return {"counts": totals, "calls": calls, "single_ms": single_ms}


def tp_timing(torch, F, fa, smi, checks, ins, tp) -> list:
    """Phase 33's kernel timing: GEMM partial_f32 at the four partial shapes
    and each of sites 25-28 per shard for n_model 2 and 4, at bs256 and
    bs8: ms (CUDA events), bound, plain ms and one PyTorch yardstick
    (F.layer_norm, addmm, SDPA, mm: never called by the port). Returns the
    kernels-line entries: partial_f32 at fc2's n_model 2 shape and each
    composition at n_model 2, bs256, every other shape under ``by_shape``."""
    from peekvit_torch.ops.cuda import tp_blocks as ttp

    d, m, h = B16["hidden_dim"], B16["mlp_dim"], B16["num_heads"]
    hd = d // h
    n_vit = (B16["image_size"] // B16["patch_size"]) ** 2 + 1
    bf, f4 = 2, 4

    def lib_norm(x, s=None, bias=None, mask=None, eps=EPS):
        ln = F.layer_norm(x, (d,), None if s is None else s.reshape(-1),
                          None if bias is None else bias.reshape(-1), eps)
        return ln if mask is None else ln * mask

    def lib_attn(ln, wqkv, bqkv, wo, hl):
        b, n, _ = ln.shape
        qkv = torch.addmm(bqkv.reshape(-1), ln.reshape(b * n, d), wqkv)
        qkv = qkv.reshape(b, n, 3, hl, hd).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return torch.mm(o.transpose(1, 2).reshape(b * n, hl * hd), wo).float()

    def lib_mlp(ln, w1, b1, w2):
        b, n, _ = ln.shape
        hid = F.gelu(torch.addmm(b1.reshape(-1), ln.reshape(b * n, d), w1), approximate="tanh")
        return torch.mm(hid, w2).float()

    library = {
        "tp_attention_partial":
            lambda x, wqkv, bqkv, wo, hl: lib_attn(lib_norm(x), wqkv, bqkv, wo, hl),
        "tp_masked_attention_partial":
            lambda x, mk, s, bb, wqkv, bqkv, wo, hl: lib_attn(
                lib_norm(x, s, bb, mk, BLOCK_EPS), wqkv, bqkv, wo, hl),
        "tp_masked_mlp_partial":
            lambda x, mk, s, bb, w1, b1, w2, hl: lib_mlp(lib_norm(x, s, bb, mk, BLOCK_EPS),
                                                          w1, b1, w2),
        "tp_mlp_partial": lambda x, w1, b1, w2, hl: lib_mlp(lib_norm(x), w1, b1, w2),
    }
    gemm_rows, comp_rows = {}, {}
    with torch.inference_mode():
        for (b, k), (a, w) in sorted(ins["gemm"].items()):
            rows = b * n_vit
            bnd, by = bound_ms(2.0 * rows * k * d, (rows * k + k * d) * bf + rows * d * f4)
            rec = {"ms": cuda_ms(torch, lambda a=a, w=w: fa.gemm_partial_f32(a, w)),
                   "plain_ms": cuda_ms(torch, lambda a=a, w=w: fa.gemm_partial_f32_ref(a, w),
                                       iters=5),
                   "library_ms": cuda_ms(torch, lambda a=a, w=w: torch.mm(a, w).float()),
                   "bound_ms": bnd, "bound_by": by}
            gemm_rows[f"k{k}.bs{b}"] = rec
            emit({"phase": "timing_kernel", "name": "gemm_bias_epilogue.partial_f32",
                  "shape": [rows, k, d], "batch": b, **rec, "share_of_bound": bnd / rec["ms"],
                  "library": "torch.mm (bf16 out) + .float()", "card": smi})
        for n_model in TP_MODELS:
            hl, dl, ml = h // n_model, d // n_model, m // n_model
            for b in TP_SHAPE_BATCHES:
                args_by = tp_site_args(ins["w"][n_model], 0, ins["x"][b], ins["mask"][b])
                for name, args in args_by.items():
                    masked = "masked" in name
                    n = n_vit + 1 if masked else n_vit
                    rows = b * n
                    extra = (rows + 2 * d) * bf if masked else 0
                    if "attention" in name:
                        flops = (2.0 * rows * d * 3 * dl + 4.0 * b * hl * n * n * hd
                                 + 2.0 * rows * dl * d)
                        nbytes = rows * d * (bf + f4) + (4 * d * dl + 3 * dl) * bf + extra
                    else:
                        flops = 4.0 * rows * d * ml
                        nbytes = rows * d * (bf + f4) + (2 * d * ml + ml) * bf + extra
                    bnd, by = bound_ms(flops, nbytes)
                    rec = {"ms": cuda_ms(torch, lambda n_=name, a=args: tp_call(ttp, n_, a, hl)),
                           "device_ms": graph_ms(
                               torch, lambda n_=name, a=args: tp_call(ttp, n_, a, hl)),
                           "plain_ms": cuda_ms(torch, lambda n_=name, a=args: tp_call(
                               ttp, n_, a, hl, plain=True), iters=3),
                           "library_ms": cuda_ms(torch, lambda n_=name, a=args:
                                                 library[n_](*a, hl)),
                           "bound_ms": bnd, "bound_by": by}
                    comp_rows.setdefault(name, {})[f"n{n_model}.bs{b}"] = rec
                    emit({"phase": "timing_kernel", "name": name, "n_model": n_model,
                          "batch": b, "tokens": n, **rec, "share_of_bound": bnd / rec["ms"],
                          "library": "F.layer_norm + addmm + SDPA + mm" if "attention" in name
                          else "F.layer_norm + addmm + gelu + mm", "card": smi})
    bs = TP_SHAPE_BATCHES[-1]
    canon = f"n{TP_MODELS[0]}.bs{bs}"
    k_fc2 = m // TP_MODELS[0]
    g = gemm_rows[f"k{k_fc2}.bs{bs}"]
    entries = [{"name": "gemm_bias_epilogue.partial_f32", "route": "cuda",
                "source": "peekvit_torch/csrc/gemm_bias_epilogue.cu",
                "replaces": f"{REPLACES_TP}:68, :144, :206, :257 (the partial products)",
                "launches": tp["counts"].get("gemm_bias_epilogue.partial_f32", 0),
                "max_abs_err": checks[f"gemm_bias_epilogue.partial_f32.k{k_fc2}.bs{bs}"],
                **g, "path": "tp", "shape_batch": bs,
                "shape": f"fc2 at n_model {TP_MODELS[0]}: ({bs * n_vit}, "
                         f"{k_fc2}) x ({k_fc2}, {d})",
                "by_shape": gemm_rows, "count_key": "gemm_bias_epilogue.partial_f32"}]
    for name, (site, line, per_call) in TP_SITES.items():
        rec = comp_rows[name][canon]
        entries.append({"name": name, "route": "cuda",
                        "source": "peekvit_torch/ops/cuda/tp_blocks.py",
                        "replaces": f"{REPLACES_TP}:{line} (site {site})",
                        "launches": tp["calls"].get(name, 0) * per_call,
                        "calls": tp["calls"].get(name, 0),
                        "max_abs_err": checks[f"{name}.{canon}"], **rec, "path": "tp",
                        "note": "a composition of the port's kernels; launches = its kernel "
                                "launches on the TP path (calls x launches per call)",
                        "shape_batch": bs, "shape": canon,
                        "by_shape": comp_rows[name], "count_key": None})
    return entries


# ---------------------------------------------- 34-35. sequence-parallel training

SP_RANKS = (2, 4)                 # sequence-parallel ranks sharing cuda:0
SP_SHAPE_BATCHES = (8, 256)       # the tail's checks and timings
SP_TRAIN_BATCH = 8                # the SP Trainer's batch: the host all-reduces stay short
SP_TRAIN_STEPS = 3
SP_BUDGET = 0.5                   # the RankViT runs and the checked key masks
SP_RUNS = (("vit", None), ("rankvit", SP_BUDGET))
SP_JOIN_TIMEOUT = 500.0           # seconds for every rank of one spawn
SP_TAIL_PER_LAYER = {"attn_softmax_fwd.kmask": 1, "gemm_bias_epilogue.residual_f32": 1,
                     "ln_rows.f32": 1, "gemm_bias_epilogue.gelu": 1,
                     "gemm_bias_epilogue.residual": 1}


def sp_shape(s: int) -> tuple[int, int, int]:
    """(N, n_pad, n_local) of a ViT-B/16 sequence over s ranks."""
    n = (B16["image_size"] // B16["patch_size"]) ** 2 + 1
    n_pad = -(-n // s) * s
    return n, n_pad, n_pad // s


def sp_key_mask(torch, gen, b: int, n: int, n_pad: int, dev):
    """A RankViT key mask at SP_BUDGET over the padded sequence: the class
    key, then the top half of the image keys by a random score, padding
    excluded; image 0 also loses its first 64 keys (one all-excluded key
    tile, the class key's included)."""
    score = torch.rand(b, n - 1, generator=gen, device=dev)
    keep = math.ceil((n - 1) * SP_BUDGET)
    ranks = torch.argsort(torch.argsort(-score, dim=-1), dim=-1)
    kmask = torch.zeros(b, n_pad, device=dev)
    kmask[:, 0] = 1.0
    kmask[:, 1:n] = (ranks < keep).float()
    kmask[0, :64] = 0.0
    return kmask


def sp_kernel_checks(torch, lv, check, randn, layer_w, d, h, smi) -> dict:
    """Phase 34, checks: attn_softmax_fwd.kmask and sp_tail_block (site 12)
    against their plain versions at ViT-B/16 widths for S ranks and
    SP_SHAPE_BATCHES images: q a slice of a local qkv, k and v of a
    gathered kv buffer, the key mask of sp_key_mask; every row finite. The
    kernel-forward tail's gradients equal the plain-forward tail's bit for
    bit (both backwards recompute the plain math from the same inputs).
    Returns the inputs for the timing."""
    gen = torch.Generator(device=DEVICE).manual_seed(34)
    tol = 3e-2
    ins = {}
    with torch.inference_mode():
        for s in SP_RANKS:
            n, n_pad, nl = sp_shape(s)
            for b in SP_SHAPE_BATCHES:
                x = randn(b, nl, d, scale=1.5, shift=0.3)
                qkv_local = randn(b, nl, 3 * d)
                kv = randn(b, n_pad, 2 * d)
                kmask = sp_key_mask(torch, gen, b, n, n_pad, DEVICE)
                q, k, v = qkv_local[..., :d], kv[..., :d], kv[..., d:]
                tag = f"s{s}.bs{b}"
                check(f"attn_softmax_fwd.kmask.{tag}", lv.attn_softmax_fwd_kmask(q, k, v, kmask, h),
                      lv.attn_softmax_fwd_kmask_ref(q, k, v, kmask, h), tol,
                      "bf16 rounding of P before PV and of the output, fp32 sums in another "
                      "order; the repo's bf16 tolerance (one image's first key tile all "
                      "excluded, padding and half the image keys excluded)")
                check(f"sp_tail_block.{tag}", lv.sp_tail_block(x, q, k, v, kmask, *layer_w, h, EPS),
                      lv.sp_tail_block_ref(x, q, k, v, kmask, *layer_w, h, EPS), tol,
                      "the attention's roundings, then three GEMMs and a LayerNorm in another "
                      "sum order; the repo's bf16 tolerance")
                ins[(s, b)] = (x, q, k, v, kmask)
    s, b = SP_RANKS[0], SP_SHAPE_BATCHES[0]
    x, q, k, v, kmask = (t.clone() for t in ins[(s, b)])  # normal tensors, for autograd
    g = randn(*x.shape, scale=0.05)
    grads = []
    for fn in (lv.sp_tail_block, lv.sp_tail_block_ref):
        leaves = [t.detach().clone().requires_grad_() for t in (x, q, k, v, *layer_w)]
        out = fn(*leaves[:4], kmask, *leaves[4:], h, EPS)
        grads.append(torch.autograd.grad(out, leaves, g))
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(*grads))
    finite = all(torch.isfinite(t).all().item() for t in grads[0])
    emit({"phase": "sp_tail_grads", "ranks": s, "batch": b, "grads": len(grads[0]),
          "bit_identical_to_plain_forward": same, "finite": finite, "card": smi})
    if not (same and finite):
        raise AssertionError("sp_tail_block: the backward differs from the plain tail's")
    return ins


def sp_batch(torch, b: int):
    """The SP Trainer's batch: seeded on the CPU, the same in every rank."""
    gen = torch.Generator().manual_seed(35)
    size = B16["image_size"]
    return (torch.randn(b, size, size, 3, generator=gen).to(DEVICE),
            torch.randint(0, B16["num_classes"], (b,), generator=gen).to(DEVICE))


def sp_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """Phase 35, one rank of an SP group of ``world`` ranks on cuda:0 over
    gloo: for each run of SP_RUNS a Trainer(AdamW, clip 1.0,
    sequence_parallel_devices=world, parallel_kernels="auto") from the
    seeded weights; first one gradient of the SP step (the Trainer's own
    forward with its arguments, loss / world, backward, the gradient
    all-reduce; not applied), which rank 0 holds against the same forward
    on sp_tail_block_ref with no collective (a one-rank mesh) fed the run's
    kept tokens; then SP_TRAIN_STEPS train steps, the launch counts zeroed
    just before each and read just after, timed on the host clock between
    synchronizes. Writes rank<r>.pt into out_dir: the resolved tail form,
    losses, counts, ms, a SHA-256 of the final parameters, rank 0's check."""
    import hashlib

    import torch
    import torch.distributed as dist

    from peekvit_torch import Trainer
    from peekvit_torch.models.adapters import tree_leaves
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.parallel.sequence import sequence_parallel_vit_forward
    from peekvit_torch.training.optim import AdamW

    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)
    try:
        x, y = sp_batch(torch, SP_TRAIN_BATCH)
        res = {}
        for name, budget in SP_RUNS:
            trainer = Trainer(model=tp_model(torch, name), optimizer=AdamW(lr=TRAIN_LR),
                              clip_grad_norm=1.0, sequence_parallel_devices=world,
                              device=DEVICE)
            trainer._forward = trainer._build_forward()
            kw = trainer._sp_fwd_kwargs
            rec = {"kernels": kw["kernels"], "losses": [], "counts": [], "ms": []}
            kept = {}
            fa.reset_launch_counts()
            loss = trainer.main_criterion(sequence_parallel_vit_forward(
                trainer.params, x, budget=budget, kept_out=kept, **kw), y)
            (loss / world).backward()
            trainer._all_reduce_grads()
            torch.cuda.synchronize()
            rec["check_counts"] = dict(fa.LAUNCHES)
            grads = {p: t.grad.detach().clone() for p, t in tree_leaves(trainer.params)}
            trainer.torch_optimizer.zero_grad(set_to_none=True)
            if rank == 0:
                rec["check"] = sp_reference_check(torch, trainer, budget, x, y,
                                                  float(loss.detach()), grads, kept)
            del grads, loss
            for step in range(SP_TRAIN_STEPS):
                torch.cuda.synchronize()
                dist.barrier()
                fa.reset_launch_counts()
                t0 = time.perf_counter()
                metrics = trainer.train_step(x, y, budget=budget, step_idx=step)
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["counts"].append(dict(fa.LAUNCHES))
                rec["losses"].append(metrics["total_loss"].cpu())
            digest = hashlib.sha256()
            for _, p in tree_leaves(trainer.params):
                digest.update(p.detach().contiguous().view(-1).view(torch.uint8).cpu()
                              .numpy().tobytes())
            rec["param_sha256"] = digest.hexdigest()
            res[name] = rec
            del trainer
            torch.cuda.empty_cache()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sp_reference_check(torch, trainer, budget, x, y, loss_sp: float, grads_sp: dict,
                       kept: dict) -> dict:
    """Rank 0's reference for one SP step: the same forward (the Trainer's
    arguments) on a one-rank mesh, no collective, the tail on
    sp_tail_block_ref, the ranked layers fed the SP run's kept tokens (bf16
    norm ties flip kept sets between two roundings, phases 16 and 33); its
    loss and gradients against the SP step's: loss rel 1e-2, rel-L2 per
    leaf 3e-2 (the repo's bf16 gradient bar)."""
    from peekvit_torch.models.adapters import tree_leaves
    from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
    from peekvit_torch.parallel.sequence import sequence_parallel_vit_forward

    kw = dict(trainer._sp_fwd_kwargs, plain=True,
              mesh=Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, None, None, 0, 0, trainer.device))
    n_img = sp_shape(1)[0] - 1
    loss = trainer.main_criterion(sequence_parallel_vit_forward(
        trainer.params, x, budget=budget, kept={i: a[:, :n_img] for i, a in kept.items()},
        **kw), y)
    loss.backward()
    loss = loss.item()
    grads = {p: t.grad.detach().clone() for p, t in tree_leaves(trainer.params)}
    trainer.torch_optimizer.zero_grad(set_to_none=True)
    err = rel_l2(torch, grads_sp, grads)
    return {"loss_sp": loss_sp, "loss_ref": loss, "loss_rel": abs(loss_sp - loss) / abs(loss),
            "max_rel_l2": max(err.values()), "worst_leaf": max(err, key=err.get),
            "leaves": len(err), "kept_layers": sorted(kept)}


def sp_phases(torch, smi) -> dict:
    """Phase 35: SP training as S spawned ranks on cuda:0 over a gloo group
    (every library built before the first rank starts, the ranks joined
    with a deadline, a rank's exception failing the run), S = 2 then 4:
    parallel_kernels="auto" resolves to the tail kernel; each step's
    launches on every rank are SP_TAIL_PER_LAYER per layer (five tail
    launches, attn_softmax_fwd.kmask 12 per forward); every rank's losses
    and final parameters bit-identical; losses finite; rank 0's SP gradient
    against the plain one-process reference; ms per step per rank. Returns
    the launches summed over every rank and step, by key."""
    import shutil

    from peekvit_torch.ops.cuda import _build

    _build.build_all()  # every library built before a rank starts: no rank runs nvcc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layers = B16["num_layers"]
    want = {k: v * layers for k, v in SP_TAIL_PER_LAYER.items()}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sp_smoke")
    totals, calls, step_ms = {}, 0, {}
    for s in SP_RANKS:
        out_dir = os.path.join(root, f"s{s}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        spawn_ranks(torch, sp_rank, s, (s, os.path.join(out_dir, "rdzv"), out_dir),
                    SP_JOIN_TIMEOUT)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(s)]
        for name, budget in SP_RUNS:
            recs = [rk[name] for rk in ranks]
            for r, rec in enumerate(recs):
                if rec["kernels"] != "pallas":
                    raise AssertionError(f"SP {name} S={s} rank {r}: parallel_kernels='auto' "
                                         f"resolved to {rec['kernels']!r}")
                for i, got in enumerate([rec["check_counts"], *rec["counts"]]):
                    if got != want:
                        raise AssertionError(f"SP {name} S={s} rank {r} step {i}: launches "
                                             f"{got}, want {want}")
                    for k, v in got.items():
                        totals[k] = totals.get(k, 0) + v
                calls += layers * (1 + SP_TRAIN_STEPS)
                same = (rec["param_sha256"] == recs[0]["param_sha256"]
                        and all(torch.equal(a, b) for a, b in zip(rec["losses"],
                                                                 recs[0]["losses"])))
                if not same:
                    raise AssertionError(f"SP {name} S={s}: rank {r}'s losses or parameters "
                                         "differ from rank 0's")
            losses = [float(v) for v in recs[0]["losses"]]
            check = recs[0]["check"]
            ok = (all(math.isfinite(v) for v in losses) and check["loss_rel"] <= 1e-2
                  and check["max_rel_l2"] <= 3e-2)
            step_ms[(s, name)] = [rec["ms"] for rec in recs]
            emit({"phase": "sp_train", "ranks": s, "model": name, "budget": budget,
                  "batch": SP_TRAIN_BATCH, "optimizer": f"AdamW(lr={TRAIN_LR}), clip 1.0",
                  "parallel_kernels": "auto -> pallas", "losses": losses,
                  "launches_per_rank_per_step": sum(want.values()),
                  "ranks_bit_identical": True, "reference_check": check,
                  "tolerance": "loss rel 1e-2, gradients rel-L2 per leaf 3e-2 against the "
                               "one-process forward on sp_tail_block_ref fed the kept tokens",
                  "ms_per_step_by_rank": step_ms[(s, name)],
                  "label": f"gloo through the host, {s} processes sharing one card: says "
                           "nothing about NCCL on separate cards",
                  "card": smi})
            if not ok:
                raise AssertionError(f"SP {name} S={s}: losses {losses}, check {check}")
        emit({"phase": "sp_spawn", "ranks": s, "seconds_for_spawn": seconds, "card": smi})
    return {"counts": totals, "calls": calls, "step_ms": step_ms}


def sp_timing(torch, F, lv, smi, checks, ins, layer_w, sp, d, h, m) -> list:
    """Phase 34's timing: attn_softmax_fwd.kmask and sp_tail_block for S
    ranks and SP_SHAPE_BATCHES images (CUDA events): ms, bound (the
    attention's work counted over the attended keys only, as this data
    needs), plain ms and one PyTorch yardstick (SDPA with the boolean key
    mask; then addmm + add, F.layer_norm, addmm + tanh-gelu, addmm + add:
    never called by the port). Returns the two kernels-line entries at
    S = 2, bs256, every other shape under ``by_shape``."""
    w_out, b_out, lns2, lnb2, w1, b1, w2, b2 = layer_w
    hd = d // h
    bf = 2

    def lib_attn(q, k, v, kmask):
        b, nq, _ = q.shape
        nk = k.shape[1]
        qh = q.reshape(b, nq, h, hd).transpose(1, 2)
        kh, vh = (t.reshape(b, nk, h, hd).transpose(1, 2) for t in (k, v))
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=(kmask > 0)[:, None, None, :])
        return o.transpose(1, 2).reshape(b, nq, d)

    def lib_tail(x, q, k, v, kmask):
        b, nq, _ = x.shape
        a = lib_attn(q, k, v, kmask).reshape(b * nq, d)
        yv = torch.addmm(b_out, a, w_out).float() + x.reshape(b * nq, d).float()
        ln = F.layer_norm(yv, (d,), lns2.float(), lnb2.float(), EPS).to(x.dtype)
        hid = F.gelu(torch.addmm(b1, ln, w1), approximate="tanh")
        return (torch.addmm(b2, hid, w2).float() + yv).to(x.dtype)

    rows_by = {}
    with torch.inference_mode():
        for (s, b), (x, q, k, v, kmask) in sorted(ins.items()):
            nq, nk = q.shape[1], k.shape[1]
            attended = kmask.sum().item()  # keys this data attends, over every image
            attn_flops = 4.0 * h * nq * hd * attended
            attn_bytes = (2 * b * nq * d + 2 * b * nk * d) * bf + b * nk * 4
            rows = b * nq
            tail_flops = attn_flops + 2.0 * rows * (d * d + 2 * d * m)
            tail_bytes = (attn_bytes + rows * d * bf
                          + (d * d + 2 * d * m + 5 * d + m) * bf)
            tag = f"s{s}.bs{b}"
            for name, fn, ref, lib, flops, nbytes in (
                    ("attn_softmax_fwd.kmask",
                     lambda: lv.attn_softmax_fwd_kmask(q, k, v, kmask, h),
                     lambda: lv.attn_softmax_fwd_kmask_ref(q, k, v, kmask, h),
                     lambda: lib_attn(q, k, v, kmask), attn_flops, attn_bytes),
                    ("sp_tail_block",
                     lambda: lv.sp_tail_block(x, q, k, v, kmask, *layer_w, h, EPS),
                     lambda: lv.sp_tail_block_ref(x, q, k, v, kmask, *layer_w, h, EPS),
                     lambda: lib_tail(x, q, k, v, kmask), tail_flops, tail_bytes)):
                bnd, by = bound_ms(flops, nbytes)
                rec = {"ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, ref, iters=5),
                       "library_ms": cuda_ms(torch, lib), "bound_ms": bnd, "bound_by": by}
                rows_by.setdefault(name, {})[tag] = rec
                emit({"phase": "timing_kernel", "name": name, "ranks": s, "batch": b,
                      "queries": nq, "keys": nk, "attended_keys": attended, **rec,
                      "share_of_bound": bnd / rec["ms"],
                      "library": "SDPA, boolean key mask" if name.startswith("attn")
                      else "SDPA (boolean key mask) + addmm + add + F.layer_norm + addmm + "
                           "gelu + addmm + add",
                      "card": smi})
    canon = f"s{SP_RANKS[0]}.bs{SP_SHAPE_BATCHES[-1]}"
    return [
        {"name": "attn_softmax_fwd.kmask", "route": "cuda",
         "source": "peekvit_torch/csrc/attn_softmax_fwd.cu",
         "replaces": f"{REPLACES_LAYER}:560 (site 12, the attention of _sp_tail_math :478-514)",
         "launches": sp["counts"].get("attn_softmax_fwd.kmask", 0),
         "max_abs_err": checks[f"attn_softmax_fwd.kmask.{canon}"],
         **rows_by["attn_softmax_fwd.kmask"][canon], "path": "sp", "shape": canon,
         "by_shape": rows_by["attn_softmax_fwd.kmask"],
         "count_key": "attn_softmax_fwd.kmask"},
        {"name": "sp_tail_block", "route": "cuda",
         "source": "peekvit_torch/ops/cuda/fused_layer_vjp.py",
         "replaces": f"{REPLACES_LAYER}:560 (site 12, _sp_tail_call)",
         "launches": sp["calls"] * len(SP_TAIL_PER_LAYER), "calls": sp["calls"],
         "max_abs_err": checks[f"sp_tail_block.{canon}"],
         **rows_by["sp_tail_block"][canon], "path": "sp",
         "note": "a composition of the port's kernels (attn_softmax_fwd.kmask, GEMM "
                 "residual_f32, ln_rows.f32, GEMM gelu, GEMM residual); launches = its kernel "
                 "launches on the SP path (calls x 5)",
         "shape": canon, "by_shape": rows_by["sp_tail_block"], "count_key": None},
    ]


def arpe_norm_build_checks(smi, build_info) -> None:
    """Phase 37: ptxas's registers and spills of arpe_tokens.cu and
    norm_rows.cu (none may spill)."""
    rows = ptxas_summary(build_info, ("arpe_tokens", "norm_rows"))
    spilled = [r["kernel"] for r in rows if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    emit({"phase": "arpe_norm_build", "ptxas": rows if rows else "not rebuilt in this run",
          "spilled": spilled, "card": smi})
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")


# ------------------------ 38-40. the training attention at every shipped shape

# (head dim, d, heads): the shipped ViT-Ti / RankViT and ResidualViT widths
TILED_WIDTHS = ((32, 256, 8), (64, 256, 4))
# every route and tile edge of attn_softmax_fwd / _bwd at both head dims:
# the wgmma kernels stop at 256 and the kept backward at 384; 704 and 768
# fill whole 64-key stages, 705 and 769 one key past them; 401 / 402 and
# 785 / 786 are the shipped models at 160 and 224 px. The key-tiled
# kernels' CTA takes 128 rows in two warpgroups of 64 (127-129: a full
# CTA, then a next CTA of one row; 192 / 193: its second warpgroup full,
# then one row past it) and streams 64-row stages through a ring of four
# slots (256 / 257 and 512 / 513: the ring's first and second wrap, one
# stage past each; 448 / 449 the same stage edge past the kept backward)
TILED_EDGE_TOKENS = (1, 17, 64, 65, 127, 128, 129, 192, 193, 255, 256, 257, 384, 385, 401, 402,
                     448, 449, 512, 513, 704, 705, 768, 769, 785, 786, 1024)
# n_q, n_k: two CTAs' query rows and one stage past the ring's first wrap,
# then the shipped SP tail's shapes
TILED_KMASK_EDGES = ((64, 129), (129, 257), (201, 402), (300, 705), (512, 1024))
# configs/model/{vit_tiny,rankvit,residualvit}.yaml at
# configs/dataset/imagenette.yaml (160 px, 10 classes); full width and depth
SHIPPED_WIDTHS = dict(patch_size=8, hidden_dim=256, mlp_dim=768, num_layers=4, num_classes=10)
SHIPPED = {
    "vit_tiny": ("vit", dict(SHIPPED_WIDTHS, num_heads=8)),
    "rankvit": ("rankvit", dict(SHIPPED_WIDTHS, num_heads=8, rankvit_layers=[1, 2, 3])),
    "residualvit": ("residualvit", dict(
        SHIPPED_WIDTHS, num_heads=4, attention_dropout=0.0, dropout=0.0,
        residual_layers=["attention+mlp"] * 4, gate_temp=1, add_input=False, gate_type="sigmoid",
        gate_threshold=0.5, gate_bias=0, add_budget_token="learnable")),
}
SHIPPED_KIND = {"vit_tiny": "vit", "rankvit": "vit", "residualvit": "residual"}
SHIPPED_PIXELS = (160, 224)      # imagenette.yaml, imagenet.yaml
SHIPPED_BATCH = 128              # configs/training/base.yaml: train_batch_size
SHIPPED_LR = 1e-3                # configs/optimizer/adam.yaml
SHIPPED_GRAD_BATCH = {160: SHIPPED_BATCH, 224: 32}  # the plain versions' fp32 maps at 786 tokens
# rel-L2 limit, against the all-plain step, of a leaf whose plain bf16
# gradient bf16 rounding alone moves past 3e-2 (the ResidualViT's gate
# leaves). Readings on an H100 (PERF.md): the kernels against the
# plain versions at most 0.089 (160 px) and 0.070 (224 px) on such leaves;
# the plain bf16 step against fp32 compute up to 0.39 (160 px) and 4.2
# (224 px). 0.2 sits above the first with room and below the second: the
# kernels must stay closer to the plain bf16 step than bf16 itself keeps
# that step to fp32; a wrong mask cotangent would move a leaf by about its
# own norm.
ILL_CONDITIONED_TOL = 0.2


def expected_route(hd: int, n: int, backward: bool = False) -> str:
    """The kernel the attention sources document for a shape: at head dim
    64 the wgmma kernels up to 256 tokens and the kept backward up to 384;
    the key-tiled kernels otherwise."""
    if hd == 64 and n <= 256:
        return "wgmma"
    return "kept" if backward and hd == 64 and n <= 384 else "tiled"


def shipped_tokens(name: str, px: int) -> int:
    args = SHIPPED[name][1]
    return (px // args["patch_size"]) ** 2 + 1 + (1 if args.get("add_budget_token") else 0)


def shipped_per_layer(fa, name: str, px: int) -> dict:
    """Launches per layer of one fused train step of a shipped model: the
    split path's (TRAIN_PER_LAYER / RESIDUAL_TRAIN_PER_LAYER) with the
    attention keyed by the route its shape takes (``.tiled``)."""
    args = SHIPPED[name][1]
    hd, n = args["hidden_dim"] // args["num_heads"], shipped_tokens(name, px)
    base = TRAIN_PER_LAYER if SHIPPED_KIND[name] == "vit" else RESIDUAL_TRAIN_PER_LAYER
    keys = {"attn_softmax_fwd": fa.softmax_key("attn_softmax_fwd", hd, n),
            "attn_softmax_bwd": fa.softmax_key("attn_softmax_bwd", hd, n, backward=True)}
    return {keys.get(k, k): v for k, v in base.items()}


def tiled_kernel_checks(torch, fa, vjp, lv, check, randn, smi, build_info) -> None:
    """Phase 38: attn_softmax_fwd (packed and .separate) and
    attn_softmax_bwd at head dims 32 and 64 (d 256) and every N of
    TILED_EDGE_TOKENS, 4 images, against their plain versions; .separate
    bit-equal to packed; each backward rerun bit-identical (two launches,
    no atomics); attn_softmax_fwd.kmask at every n_q / n_k of
    TILED_KMASK_EDGES with image 0 under a random mask, image 1 with its
    whole first 64-key tile excluded, image 2 attending its last key only,
    image 3 every key. Each call's launch key, and the C entry points'
    routes (fa.softmax_route) against the reach the sources document
    (expected_route). Then ptxas's registers and spills of both sources
    (none may spill)."""
    tol = 2e-2
    reason = "bf16 rounding of the normalised P (and of dZ * scale), bf16 output rounding"
    same, routes, bad_keys = {}, {}, []

    def keyed(fn, want_key):
        out, counts = counted(torch, fa, fn)
        if counts != {want_key: 1}:
            bad_keys.append((want_key, counts))
        return out

    with torch.inference_mode():
        for hd, d, heads in TILED_WIDTHS:
            for n in TILED_EDGE_TOKENS:
                tag = f"hd{hd}.N{n}"
                routes[tag] = {"fwd": fa.softmax_route(hd, n),
                               "bwd": vjp.attn_softmax_bwd_route(n, hd),
                               "fwd_rule": expected_route(hd, n),
                               "bwd_rule": expected_route(hd, n, backward=True)}
                qkv, da = randn(EDGE_BATCH, n, 3 * d), randn(EDGE_BATCH, n, d, scale=0.05)
                got = keyed(lambda: vjp.attn_softmax_fwd(qkv, heads),
                            fa.softmax_key("attn_softmax_fwd", hd, n))
                check(f"tiled.attn_softmax_fwd.{tag}", got, vjp.attn_softmax_fwd_ref(qkv, heads),
                      tol, reason)
                q, k, v = (qkv[..., i * d:(i + 1) * d].contiguous() for i in range(3))
                sep = keyed(lambda: fa.fused_attention(q, k, v, heads),
                            fa.softmax_key("attn_softmax_fwd.separate", hd, n))
                same[f"separate.{tag}"] = torch.equal(sep, got)
                bkey = fa.softmax_key("attn_softmax_bwd", hd, n, backward=True)
                dq = keyed(lambda: vjp.attn_softmax_bwd(qkv, da, heads), bkey)
                check(f"tiled.attn_softmax_bwd.{tag}", dq,
                      vjp.attn_softmax_bwd_ref(qkv, da, heads), tol, reason)
                same[f"bwd_rerun.{tag}"] = torch.equal(dq, vjp.attn_softmax_bwd(qkv, da, heads))
            for nq, nk in TILED_KMASK_EDGES:
                tag = f"hd{hd}.{nq}x{nk}"
                routes[f"kmask.{tag}"] = {"fwd": fa.softmax_route(hd, nk),
                                          "fwd_rule": expected_route(hd, nk)}
                q = randn(EDGE_BATCH, nq, 3 * d)[..., :d]
                kv = randn(EDGE_BATCH, nk, 2 * d)
                gen = torch.Generator(device=kv.device).manual_seed(nq * 1000 + nk)
                kmask = (torch.rand(EDGE_BATCH, nk, generator=gen, device=kv.device) > 0.5).float()
                kmask[0, 0] = 1.0
                kmask[1] = 1.0
                kmask[1, :64] = 0.0
                kmask[2] = 0.0
                kmask[2, nk - 1] = 1.0
                kmask[3] = 1.0
                got = keyed(lambda: lv.attn_softmax_fwd_kmask(q, kv[..., :d], kv[..., d:], kmask,
                                                              heads),
                            fa.softmax_key("attn_softmax_fwd.kmask", hd, nk))
                check(f"tiled.attn_softmax_fwd.kmask.{tag}", got,
                      lv.attn_softmax_fwd_kmask_ref(q, kv[..., :d], kv[..., d:], kmask, heads),
                      tol, reason)
        torch.cuda.synchronize()
    mismatched = [t for t, r in routes.items()
                  if r["fwd"] != r["fwd_rule"] or r.get("bwd") != r.get("bwd_rule")]
    rows = ptxas_summary(build_info, ("attn_softmax_fwd", "attn_softmax_bwd"))
    spilled = [r["kernel"] for r in rows if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    emit({"phase": "tiled_edges", "routes": routes, "routes_differ_from_rule": mismatched,
          "checked_bit_identical": len(same), "differ": [k for k, v in same.items() if not v],
          "launch_keys_wrong": bad_keys,
          "ptxas_tiled": [r for r in rows if "tiled" in r["kernel"]] if rows
          else "not rebuilt in this run", "spilled": spilled, "card": smi})
    if mismatched or bad_keys or not all(same.values()):
        raise AssertionError(f"tiled edges: routes {mismatched}, keys {bad_keys}, bits "
                             f"{[k for k, v in same.items() if not v]}")
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")


def shipped_train_phases(torch, F, fa, vjp, dev, smi) -> dict:
    """Phase 39: vit_tiny, rankvit and residualvit (the shipped training
    configs at full width and depth, seeded weights, head and class token
    re-drawn) under Trainer(Adam(1e-3), clip_grad_norm=1.0) with
    fused="auto" at bs128. At 160 px (N 401 / 402): the path must resolve
    to the fused one; one step's gradients against the same step on the
    plain versions (rel-L2 per leaf 3e-2, or ILL_CONDITIONED_TOL on an
    ill-conditioned leaf, below; a leaf whose plain gradient is exactly 0
    must be 0 through the kernels) and against the same step with only
    the attention kernels on their plain versions (3e-2 on every leaf:
    their own share). A leaf is ill-conditioned where bf16 rounding alone
    moves the plain step's gradient past 3e-2: against the same step in
    fp32 compute, or against the same bf16 step on the images times
    (1 +- 2^-8), about one bf16 ulp. (The ResidualViT's gate leaves take
    their gradient through the mask cotangent, a sum of many cancelling
    terms.) Then five steps with the counts
    zeroed just before and read just after, each key at its per-layer
    count times layers and steps; finite losses; ms per step beside the
    module path's (Trainer(fused=False), the model's own fp32 forward) at
    the same batch. At 224 px (N 785 / 786): one counted step each and the
    gradients at bs32. Returns the 160 px run's counts (the main path) and
    each run's."""
    from peekvit_torch import Trainer
    from peekvit_torch.models.adapters import tree_leaves
    from peekvit_torch.training.fused import residual_forward_fn, sample_budgets
    from peekvit_torch.training.fused import trainable_forward_fn
    from peekvit_torch.training.optim import Adam
    from peekvit_torch.training.trainer import step_generator

    tol_grad = 3e-2
    main_counts, by_run = {}, {}
    for px in SHIPPED_PIXELS:
        for name, (family, args) in SHIPPED.items():
            model = seeded_residual_model(torch, family, dict(args, image_size=px))
            trainer = Trainer(model, Adam(lr=SHIPPED_LR), clip_grad_norm=1.0, device=DEVICE)
            kind = trainer._fused_kind()
            gen = torch.Generator(device=dev).manual_seed(px)

            def batch(b):
                return (torch.randn(b, px, px, 3, generator=gen, device=dev),
                        torch.randint(0, args["num_classes"], (b,), generator=gen, device=dev))

            gb = SHIPPED_GRAD_BATCH[px]
            xg, yg = batch(gb)
            params = trainer.params
            bvec = (sample_budgets(model, gb, step_generator(0, 0), dev)
                    if kind == "residual" else None)

            def grads(xb=xg, **kw):
                model.zero_grad(set_to_none=True)
                if kind == "residual":
                    logits = residual_forward_fn(model, **kw)(params, xb, bvec)[0]
                else:
                    logits = trainable_forward_fn(model, **kw)(params, xb)
                loss = F.cross_entropy(logits, yg)
                loss.backward()
                return float(loss.detach()), {k: (p.grad.detach().clone() if p.grad is not None
                                                  else torch.zeros_like(p))
                                              for k, p in tree_leaves(params)}

            loss_k, g_k = grads()
            loss_p, g_p = grads(plain=True)
            g_32 = grads(plain=True, compute_dtype=torch.float32)[1]
            flips = torch.randint(0, 2, xg.shape, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(px + 1))
            flips = flips * 2 - 1
            g_nudged = grads(xg * (1 + flips * 2.0 ** -8), plain=True)[1]
            kernels = (vjp._KERNELS, vjp._MASKED_KERNELS)
            try:  # the attention kernels' own share: the same step with their plain versions
                vjp._KERNELS = kernels[0][:3] + (vjp.attn_softmax_fwd_ref,
                                                 vjp.attn_softmax_bwd_ref) + kernels[0][5:]
                vjp._MASKED_KERNELS = vjp._KERNELS + kernels[1][6:]
                g_a = grads()[1]
            finally:
                vjp._KERNELS, vjp._MASKED_KERNELS = kernels
            model.zero_grad(set_to_none=True)
            err = rel_l2(torch, g_k, g_p)
            err_attn = rel_l2(torch, g_k, g_a)
            plain_32, kernels_32 = rel_l2(torch, g_p, g_32), rel_l2(torch, g_k, g_32)
            nudged = rel_l2(torch, g_nudged, g_p)
            # the leaves whose plain bf16 gradient bf16 rounding alone moves
            # past the tolerance: held at ILL_CONDITIONED_TOL
            ill = {k for k in err if max(plain_32[k], nudged[k]) > tol_grad}
            failed = sorted(k for k in err
                            if err[k] > (ILL_CONDITIONED_TOL if k in ill else tol_grad))
            failed += sorted(k for k in err_attn if err_attn[k] > tol_grad)
            zero_leaves = sorted(k for k, v in g_p.items() if not v.abs().max() > 0)
            zero_kept = all(not g_k[k].abs().max() > 0 for k in zero_leaves)
            steps = TRAIN_STEPS if px == SHIPPED_PIXELS[0] else 1
            x, y = batch(SHIPPED_BATCH)
            fa.reset_launch_counts()
            losses, per_step = [], []
            for i in range(steps):
                before = sum(fa.LAUNCHES.values())
                losses.append(trainer.train_step(x, y, step_idx=i)["total_loss"])
                per_step.append(sum(fa.LAUNCHES.values()) - before)
            torch.cuda.synchronize()
            counts = dict(fa.LAUNCHES)
            losses = [float(v) for v in losses]
            layers = args["num_layers"]
            per_layer = shipped_per_layer(fa, name, px)
            want = {k: v * layers * steps for k, v in per_layer.items()}
            rec = {"phase": "shipped_train", "model": name, "image_size": px,
                   "tokens": shipped_tokens(name, px), "fused": trainer.fused,
                   "resolved": kind, "train_kind": trainer._train_kind, "batch": SHIPPED_BATCH,
                   "steps": steps, "losses": losses, "launches_per_step": per_step,
                   "per_layer": per_layer, "counts": counts, "grad_batch": gb,
                   "loss_kernels": loss_k, "loss_plain": loss_p, "leaves": len(g_k),
                   "max_rel_l2_vs_plain": max(err.values()), "rel_l2_vs_plain": err,
                   "max_rel_l2_vs_plain_attention": max(err_attn.values()),
                   "max_rel_l2_plain_vs_fp32": max(plain_32.values()),
                   "max_rel_l2_kernels_vs_fp32": max(kernels_32.values()),
                   "max_rel_l2_plain_nudged": max(nudged.values()),
                   "ill_conditioned_vs_plain_plain_vs_fp32_nudged_kernels_vs_fp32": {
                       k: [err[k], plain_32[k], nudged[k], kernels_32[k]] for k in sorted(ill)},
                   "max_rel_l2_well_conditioned_vs_plain": max(
                       [v for k, v in err.items() if k not in ill], default=0.0),
                   "failed": failed, "zero_plain_leaves": len(zero_leaves),
                   "zero_leaves_zero_through_kernels": zero_kept, "tolerance_rel_l2": tol_grad,
                   "tolerance_ill_conditioned": ILL_CONDITIONED_TOL,
                   "tolerance_reason": "same rounding points; bf16 flips from fp32 sums in "
                                       "another order through 4 layers; the repo's bf16 "
                                       "tolerance, and ILL_CONDITIONED_TOL on the leaves that "
                                       "bf16 rounding alone moves past it",
                   "card": smi}
            if px == SHIPPED_PIXELS[0]:
                for _ in range(2):
                    trainer.train_step(x, y, step_idx=100)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                rec["ms_per_step"] = cuda_ms(torch, lambda: trainer.train_step(x, y), iters=5)
                rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
                module = Trainer(model, Adam(lr=SHIPPED_LR), clip_grad_norm=1.0, fused=False,
                                 device=DEVICE)
                module.train_step(x, y)
                rec["module_ms_per_step"] = cuda_ms(torch, lambda: module.train_step(x, y),
                                                    iters=3)
                rec["module_kind"] = module._train_kind
                rec["images_per_s"] = SHIPPED_BATCH / rec["ms_per_step"] * 1e3
                del module
                for k, v in counts.items():
                    main_counts[k] = main_counts.get(k, 0) + v
            emit(rec)
            by_run[f"{name}@{px}"] = counts
            want_kind = "fused_" + SHIPPED_KIND[name]
            if kind != SHIPPED_KIND[name] or trainer._train_kind != want_kind:
                raise AssertionError(f"{name} at {px} px resolved to {kind!r} / "
                                     f"{trainer._train_kind!r}, not {want_kind}")
            if per_step != [sum(per_layer.values()) * layers] * steps or counts != want:
                raise AssertionError(f"{name} at {px} px: launches {per_step} {counts}, "
                                     f"want {want}")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name} at {px} px: losses not finite: {losses}")
            if failed or not zero_kept:
                raise AssertionError(f"{name} at {px} px: gradients out of tolerance at "
                                     f"{failed}")
            del trainer, model, g_k, g_p, g_32, g_a, g_nudged
            torch.cuda.empty_cache()
    return {"counts": main_counts, "by_run": by_run}


def tiled_timing(torch, F, fa, vjp, lv, smi, check, checks, randn, shipped) -> list:
    """Phase 40: the key-tiled kernels at the Trainer's shapes beside their
    bounds, plain versions and one PyTorch call (SDPA forward, SDPA's
    backward, SDPA with the boolean key mask; never called by the port):
    ms (CUDA events over 20 launches from Python) and device_ms (10
    launches replayed from one CUDA graph). Bound = max(bytes: each input
    read once, each output written once, over 3.35 TB/s; the products'
    flops over the bf16 peak); beside it ``exp_ms``, the kernel's own
    exponentials at the SFU's rate (forward: two sweeps, backward: three).
    Then the tiled backward at head dim 64, bs128, N 385 beside the kept
    backward at 384 (device ms). Returns the kernels-line entries."""
    bf = 2
    entries = []

    def sdpa_heads(t, n, heads):
        b = t.shape[0]
        return t.reshape(b, n, heads, -1).transpose(1, 2)

    def row(name, shape, tag, fn, ref, lib, flops, nbytes, exps, count_key, replaces, path,
            runs):
        bnd, by = bound_ms(flops, nbytes)
        with torch.inference_mode():
            ms, dev_ms = cuda_ms(torch, fn), graph_ms(torch, fn)
            plain = cuda_ms(torch, ref, iters=3)
        lib_ms = cuda_ms(torch, lib)
        exp_ms = exps / SFU_PER_S * 1e3
        emit({"phase": "timing_tiled", "name": name, "shape": shape, "ms": ms,
              "device_ms": dev_ms, "plain_ms": plain, "library_ms": lib_ms, "bound_ms": bnd,
              "bound_by": by, "share_of_bound": bnd / dev_ms, "exp_ms": exp_ms, "card": smi})
        entries.append({"name": name, "route": "cuda",
                        "source": "peekvit_torch/csrc/" + name.split(".")[0] + ".cu",
                        "replaces": replaces,
                        "launches": sum(shipped["by_run"][r].get(count_key, 0) for r in runs),
                        "launches_counted_in": runs,
                        "max_abs_err": checks[tag], "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                        "exp_ms": exp_ms, "shape": shape, "path": path,
                        "count_key": count_key})

    check_tol = 2e-2
    fwd_replaces = (f"{REPLACES_VJP}:261 (sites 18 and 21: _attn_fwd_kernel :49-87; site 10 "
                    f"{REPLACES_LAYER}:278)")
    bwd_replaces = (f"{REPLACES_VJP}:364 (sites 19-20 and 22-23: the head core of "
                    f"_attn_bwd_kernel_saved :202-236; site 11 {REPLACES_LAYER}:330)")
    vit_runs = [f"{m}@{SHIPPED_PIXELS[0]}" for m in ("vit_tiny", "rankvit")]
    for name, (b, n, hd, heads), count_key, runs in (
            ("attn_softmax_fwd.tiled", (SHIPPED_BATCH, 401, 32, 8), "attn_softmax_fwd.tiled",
             vit_runs),
            ("attn_softmax_fwd.tiled.hd64", (SHIPPED_BATCH, 786, 64, 4),
             "attn_softmax_fwd.tiled", [f"residualvit@{SHIPPED_PIXELS[-1]}"]),
            ("attn_softmax_fwd.tiled.hd64.N402", (SHIPPED_BATCH, 402, 64, 4),
             "attn_softmax_fwd.tiled", [f"residualvit@{SHIPPED_PIXELS[0]}"]),
            ("attn_softmax_bwd.tiled", (SHIPPED_BATCH, 401, 32, 8), "attn_softmax_bwd.tiled",
             vit_runs),
            ("attn_softmax_bwd.tiled.hd64", (SHIPPED_BATCH, 402, 64, 4),
             "attn_softmax_bwd.tiled", [f"residualvit@{SHIPPED_PIXELS[0]}"])):
        d = hd * heads
        qkv, da = randn(b, n, 3 * d), randn(b, n, d, scale=0.05)
        shape = f"bs{b}.N{n}.hd{hd}.h{heads}"
        tag = f"{name}.{shape}"
        logits = b * heads * n * n
        if name.startswith("attn_softmax_fwd"):
            with torch.inference_mode():
                check(tag, vjp.attn_softmax_fwd(qkv, heads), vjp.attn_softmax_fwd_ref(qkv, heads),
                      check_tol, "bf16 rounding of the normalised P, bf16 output rounding")
            qh, kh, vh = (sdpa_heads(qkv[..., i * d:(i + 1) * d], n, heads) for i in range(3))
            row(name, shape, tag, lambda: vjp.attn_softmax_fwd(qkv, heads),
                lambda: vjp.attn_softmax_fwd_ref(qkv, heads),
                lambda: F.scaled_dot_product_attention(qh, kh, vh), 4.0 * logits * hd,
                b * n * (3 * d + d) * bf, 2.0 * logits, count_key, fwd_replaces,
                "shipped_train", runs)
        else:
            with torch.inference_mode():
                check(tag, vjp.attn_softmax_bwd(qkv, da, heads),
                      vjp.attn_softmax_bwd_ref(qkv, da, heads), check_tol,
                      "bf16 rounding of P and dZ * scale, bf16 output rounding")
            leaves = [sdpa_heads(qkv[..., i * d:(i + 1) * d], n, heads).contiguous()
                      .requires_grad_() for i in range(3)]
            out = F.scaled_dot_product_attention(*leaves)
            dout = sdpa_heads(da, n, heads).contiguous()
            row(name, shape, tag, lambda: vjp.attn_softmax_bwd(qkv, da, heads),
                lambda: vjp.attn_softmax_bwd_ref(qkv, da, heads),
                lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True),
                10.0 * logits * hd, b * n * (3 * d + d + 3 * d) * bf, 3.0 * logits, count_key,
                bwd_replaces, "shipped_train", runs)
            del leaves, out, dout
        del qkv, da
    # the separate (site 2) and masked (site 12) modes at ViT-Ti's width
    b, n, hd, heads = SHIPPED_BATCH, 401, 32, 8
    d = hd * heads
    q, k, v = (randn(b, n, d) for _ in range(3))
    shape = f"bs{b}.N{n}.hd{hd}.h{heads}"
    tag = f"attn_softmax_fwd.separate.tiled.{shape}"
    with torch.inference_mode():
        check(tag, fa.fused_attention(q, k, v, heads), fa.fused_attention_ref(q, k, v, heads),
              check_tol, "bf16 rounding of the normalised P, bf16 output rounding")
    row("attn_softmax_fwd.separate.tiled", shape, tag, lambda: fa.fused_attention(q, k, v, heads),
        lambda: fa.fused_attention_ref(q, k, v, heads),
        lambda: F.scaled_dot_product_attention(*(sdpa_heads(t, n, heads) for t in (q, k, v))),
        4.0 * b * heads * n * n * hd, b * n * 4 * d * bf, 2.0 * b * heads * n * n,
        "attn_softmax_fwd.separate.tiled",
        f"{REPLACES}:220 (site 2, fused_attention: _attn_kernel :168)", "module", vit_runs)
    nq, nk = 201, 402  # a rank's queries of RankViT-at-160 px's tokens over two ranks
    kv = randn(b, nk, 2 * d)
    gen = torch.Generator(device=kv.device).manual_seed(7)
    kmask = (torch.rand(b, nk, generator=gen, device=kv.device) > 0.5).float()
    kmask[:, 0] = 1.0
    kmask[0, :64] = 0.0
    kmask[0, nk - 1] = 1.0
    qq = q[:, :nq].contiguous()
    attended = kmask.sum().item()
    shape = f"bs{b}.{nq}x{nk}.hd{hd}.h{heads}"
    tag = f"attn_softmax_fwd.kmask.tiled.{shape}"
    with torch.inference_mode():
        check(tag, lv.attn_softmax_fwd_kmask(qq, kv[..., :d], kv[..., d:], kmask, heads),
              lv.attn_softmax_fwd_kmask_ref(qq, kv[..., :d], kv[..., d:], kmask, heads),
              check_tol, "bf16 rounding of the normalised P, bf16 output rounding")
    mask4 = (kmask > 0)[:, None, None, :]
    row("attn_softmax_fwd.kmask.tiled", shape, tag,
        lambda: lv.attn_softmax_fwd_kmask(qq, kv[..., :d], kv[..., d:], kmask, heads),
        lambda: lv.attn_softmax_fwd_kmask_ref(qq, kv[..., :d], kv[..., d:], kmask, heads),
        lambda: F.scaled_dot_product_attention(
            sdpa_heads(qq, nq, heads), sdpa_heads(kv[..., :d], nk, heads),
            sdpa_heads(kv[..., d:], nk, heads), attn_mask=mask4),
        4.0 * heads * nq * hd * attended, (2 * b * nq * d + 2 * b * nk * d) * bf + b * nk * 4,
        2.0 * heads * nq * b * nk, "attn_softmax_fwd.kmask.tiled",
        f"{REPLACES_LAYER}:560 (site 12, the attention of _sp_tail_math :478-514)", "sp",
        vit_runs)
    # the tiled backward one token past the kept backward's reach, beside it
    # (head dim 64, bs128, 4 heads): whether the tiled pair could take over
    # 256 < N <= 384
    beside = {}
    for n in (384, 385):
        qkv, da = randn(SHIPPED_BATCH, n, 768), randn(SHIPPED_BATCH, n, 256, scale=0.05)
        with torch.inference_mode():
            dev_ms = graph_ms(torch, lambda: vjp.attn_softmax_bwd(qkv, da, 4))
        beside[f"N{n}"] = {"route": vjp.attn_softmax_bwd_route(n, 64), "device_ms": dev_ms}
        del qkv, da
    emit({"phase": "timing_tiled_vs_kept", "shape": f"bs{SHIPPED_BATCH}.hd64.h4", **beside,
          "card": smi})
    return entries


# ------------------------------------------- the reconstruction decoders (41)

# configs/model/residualvitwithdecoder.yaml and configs/model/maevit.yaml at
# configs/dataset/imagenette.yaml's 160 px and 10 classes, full width and depth
RECON_MODELS = {
    "encdecresidualvit": dict(
        image_size=160, patch_size=8, hidden_dim=256, mlp_dim=768, num_layers=4, num_heads=4,
        num_classes=10, residual_layers=["attention+mlp"] * 4, gate_temp=1, add_input=False,
        gate_type="sigmoid", gate_threshold=0.5, gate_bias=0, add_budget_token="learnable",
        decoder_hidden_dim=192, decoder_num_layers=2, decoder_num_heads=4, decoder_mlp_dim=512),
    "maevit": dict(
        image_size=160, patch_size=8, hidden_dim=256, mlp_dim=768, num_layers=4, num_heads=8,
        num_classes=10, mask_ratio=0.75, decoder_hidden_dim=128, decoder_mlp_dim=512,
        num_decoder_layers=2, num_decoder_heads=4),
}
RECON_REQUESTS = (8, 512)  # 512: configs/training/base.yaml's eval_batch_size
RECON_BUDGET = 0.5
RECON_TOL = 3e-2  # of max|plain|: the repo's bf16 tolerance (tests/test_pallas.py:42)
# the plain folded layer (the decoders, MAE's encoder) without its attention
FOLDED_PER_LAYER = {k: v for k, v in PCT_PER_LAYER.items() if not k.startswith("attn_scores_pv")}


def recon_counts(fa, name: str) -> dict:
    """Launches per forward of ``name``'s recon_outputs engine: 7 per layer
    on each stack, the attention keyed by its head dim."""
    args = RECON_MODELS[name]
    counts: dict = {}

    def stack(per_layer, layers, d, heads):
        key = fa.attn_scores_pv_key(d // heads)
        for k, v in dict(per_layer, **{key: per_layer.get(key, 0) + 1}).items():
            counts[k] = counts.get(k, 0) + v * layers

    d, heads = args["hidden_dim"], args["num_heads"]
    if name == "encdecresidualvit":
        masked = {k: v for k, v in RESIDUAL_PER_LAYER.items() if k != "attn_scores_pv"}
        stack(masked, args["num_layers"], d, heads)
        stack(FOLDED_PER_LAYER, args["decoder_num_layers"], args["decoder_hidden_dim"],
              args["decoder_num_heads"])
    else:
        stack(FOLDED_PER_LAYER, args["num_layers"], d, heads)
        stack(FOLDED_PER_LAYER, args["num_decoder_layers"], args["decoder_hidden_dim"],
              args["num_decoder_heads"])
    return counts


def recon_phases(torch, F, fa, dev, smi, check, checks, build_info) -> dict:
    """Phase 41, the reconstruction decoders: build_model("encdecresidualvit")
    and build_model("maevit") at RECON_MODELS (seeded weights, heads and
    class tokens re-drawn) serve 8 and 512 images through
    InferenceEngine(recon_outputs=True), the EncDec at budget 0.5: counts
    zeroed just before each forward and read just after (recon_counts: 7
    per layer on each stack, attn_scores_pv.hd48 twice per EncDec forward);
    logits, reconstruction and mask image against the plain twins
    (residualvit_forward_plain / maevit_forward_plain in bf16, the same
    recon branch) within 3e-2 of max|plain|, top-1 on decided images, the
    logits-only engine's logits beside them. Then attn_scores_pv.hd48 at
    the EncDec decoder's bs512 shape (N 400, 4 heads, d 192) against its
    plain version and timed (ms, device_ms, plain, SDPA on the same q, k,
    v, the bound: bytes, products, exp2 terms at the SFU's rate), its
    schedule required to be the wgmma kernel; both engines logits-only and
    with recon_outputs at 8 and 512 images (ms per forward, the decoder's
    share), one profiled recon forward of each at 512; ptxas's registers
    and spills of every head-dim-48 instance of both kernels (a spill, or
    a missing wgmma instance, fails the run). Returns the counts and the
    kernels-line entry."""
    from peekvit_torch import InferenceEngine
    from peekvit_torch.inference import maevit_forward_plain, residualvit_forward_plain

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(41)
    engines = {}
    for name, args in RECON_MODELS.items():
        model = seeded_residual_model(torch, name, args)
        engines[name] = {recon: InferenceEngine(model, device=DEVICE, recon_outputs=recon)
                         for recon in (False, True)}
    kwargs = {"encdecresidualvit": {"budget": RECON_BUDGET}, "maevit": {}}
    totals: dict = {}
    requests = {}
    with torch.inference_mode():
        for bb in RECON_REQUESTS:
            size = RECON_MODELS["maevit"]["image_size"]
            x = requests[bb] = torch.randn(bb, size, size, 3, generator=gen, device=dev)
            for name, pair in engines.items():
                e, kw = pair[True], kwargs[name]
                got, counts = counted(torch, fa, lambda: e(x, **kw))
                want_counts = recon_counts(fa, name)
                if counts != want_counts:
                    raise AssertionError(f"{name} b{bb}: launches {counts}, want {want_counts}")
                for key, v in counts.items():
                    totals[key] = totals.get(key, 0) + v
                fwd = {k: v for k, v in e._forward.items() if k != "compute_dtype"}
                if name == "encdecresidualvit":
                    ref = residualvit_forward_plain(e.params, x, RECON_BUDGET, compute_dtype=bf16,
                                                    **fwd)
                else:
                    ref = maevit_forward_plain(e.params, x, compute_dtype=bf16, **fwd)
                atol = RECON_TOL * ref[0].abs().max().item()
                rec = compare_logits(torch, f"{name} b{bb}", got[0],
                                     [("plain_bf16", ref[0], 0.0, atol)])
                logits_only = pair[False](x, **kw)
                rec["logits_only_max_abs_delta"] = (logits_only - got[0]).abs().max().item()
                for label, g, r in zip(("reconstruction", "mask_image"), got[1:], ref[1:]):
                    scale = r.abs().max().item()
                    rel = (g - r).abs().max().item() / max(scale, 1e-30)
                    rec[label] = {"shape": list(g.shape), "dtype": str(g.dtype),
                                  "max_rel_err": rel, "max_abs_ref": scale}
                    if g.shape != r.shape or not torch.isfinite(g).all() or rel > RECON_TOL:
                        raise AssertionError(f"{name} b{bb} {label}: {rec[label]}")
                if name == "encdecresidualvit":
                    rec["mask_image_open_share"] = (got[2] > 0.5).float().mean().item()
                emit({"phase": "recon_check", "model": name, "batch": bb, "launches": counts,
                      **rec, "tolerance_rel": RECON_TOL,
                      "tolerance_reason": "the plain twin takes the same rounding points, fp32 "
                      "sums in another order; the repo's bf16 tolerance (tests/test_pallas.py:42)",
                      "card": smi})
    emit({"phase": "recon_launches", "counts": totals, "requests": list(RECON_REQUESTS),
          "card": smi})

    # the head-dim-48 attention at the EncDec decoder's bs512 shape, on the
    # wgmma kernel
    b, n, hd, heads = RECON_REQUESTS[-1], 400, 48, 4
    d = hd * heads
    schedule = fa.attn_scores_pv_plan(b, n, heads, hd)
    if schedule["kernel"] != "wgmma":
        raise AssertionError(f"attn_scores_pv.hd48 at b{b}, N {n}: plan {schedule}, want wgmma")
    qkv = torch.randn(b, n, 3 * d, generator=gen, device=dev).to(bf16)
    name = "attn_scores_pv.hd48"
    with torch.inference_mode():
        check(name, fa.attn_scores_pv(qkv, heads), fa.attn_scores_pv_ref(qkv, heads), 2e-2,
              "bf16 rounding of logits before exp2, bf16 output rounding")
        ms, dev_ms = (cuda_ms(torch, lambda: fa.attn_scores_pv(qkv, heads)),
                      graph_ms(torch, lambda: fa.attn_scores_pv(qkv, heads)))
        plain_ms = cuda_ms(torch, lambda: fa.attn_scores_pv_ref(qkv, heads), iters=3)
        sdpa = [qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, hd).transpose(1, 2).contiguous()
                for i in range(3)]
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*sdpa))
    exps = float(b * heads * n * n)
    bnd, by = bound_ms(4.0 * exps * hd, 4.0 * b * n * d * 2)
    entry = {"name": name, "route": "cuda", "source": "peekvit_torch/csrc/attn_scores_pv.cu",
             "replaces": f"{REPLACES}:46 _attn_scores_pv at head dim 48 (through :788 "
             "fused_layer_block_folded, site 8)",
             "launches": totals.get(name, 0), "max_abs_err": checks[name], "ms": ms,
             "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
             "library_ms": lib_ms, "exp_ms": exps / SFU_PER_S * 1e3, "path": "recon",
             "shape_batch": b, "count_key": name}
    emit({"phase": "timing_kernel", **{k: v for k, v in entry.items() if k != "count_key"},
          "plan": schedule, "share_of_bound": bnd / dev_ms,
          "library": "SDPA on the same q, k, v", "card": smi})
    if entry["launches"] == 0:
        raise AssertionError(f"{name}: never launched on the recon path")

    # both engines, logits-only and with recon_outputs
    forward_ms = {}
    with torch.inference_mode():
        for bb, x in requests.items():
            for name, pair in engines.items():
                kw = kwargs[name]
                ms = {recon: cuda_ms(torch, lambda: pair[recon](x, **kw), iters=10)
                      for recon in (False, True)}
                forward_ms[(name, bb)] = ms[True]
                emit({"phase": "timing_recon", "model": name, "batch": bb,
                      "ms_logits_only": ms[False], "ms_recon": ms[True],
                      "decoder_share": (ms[True] - ms[False]) / ms[True],
                      "images_per_s_recon": bb / ms[True] * 1e3, "card": smi})
        for name, pair in engines.items():
            x, kw = requests[RECON_REQUESTS[-1]], kwargs[name]
            profile_step(torch, smi, lambda: pair[True](x, **kw),
                         forward_ms[(name, RECON_REQUESTS[-1])], phase=f"profile_{name}_recon",
                         batch=RECON_REQUESTS[-1], warmup=True)
    # every head-dim-48 instance of both kernels: the mma.sync kernel's two
    # (key mask off and on) and the wgmma kernel's four (key mask x 2 or 4
    # warpgroups)
    rows = [r for r in ptxas_summary(build_info, ("attn_scores_pv",))
            if "attn_kernelILi48" in r["kernel"] or "attn_wgmma_kernelILi48" in r["kernel"]]
    spilled = [r["kernel"] for r in rows if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    wgmma48 = sum("attn_wgmma_kernelILi48" in r["kernel"] for r in rows)
    emit({"phase": "ptxas_hd48", "kernels": rows if rows else "not rebuilt in this run",
          "wgmma_instances": wgmma48, "spilled": spilled, "card": smi})
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")
    if rows and (wgmma48 != 4 or len(rows) != 6):
        raise AssertionError(f"ptxas reported {len(rows)} head-dim-48 instances "
                             f"({wgmma48} wgmma), want 6 (4 wgmma)")
    return {"counts": totals, "entries": [entry]}


# --------------------------------------------------------------------- 42. MoE

# configs/model/moevit.yaml at imagenette.yaml's 160 px and 10 classes
MOE_YAML = dict(image_size=160, patch_size=8, hidden_dim=256, mlp_dim=768, num_layers=4,
                num_heads=8, num_classes=10, mlp_moes=[1, 1, 2, 2], attn_moes=[1, 1, 1, 1])
MOE_REQUESTS = (8, 256)
MOE_ENGINES = {"dense": {}, "routed_2": dict(routed=2.0, routed_min_experts=2),
               "routed_1": dict(routed=1.0, routed_min_experts=2), "int8": dict(quantized=True)}
MOE_TOL = {"bf16": 3e-2, "int8": 5e-2}  # of max|plain|: tests/test_pallas.py:42, test_inference.py:728
REPLACES_MOE = f"{REPLACES_Q}:89 _quant_linear_xla (XLA, no Pallas call: the int8 MoE experts " \
               "of peekvit_tpu/inference.py:1770 moevit_forward_quant)"


def moe_counts(fa, quantized: bool) -> dict:
    """Launches per forward of the MoE_YAML engine: per layer, the folded
    layer (7; int8: 9) where both sublayers have one expert, else a
    single attention sublayer (4; int8: 5) or E attention experts (int8: 1
    + 3 E), then a single MLP sublayer (3; int8: 4) or E MLP experts
    (int8: 1 + 3 E); bf16 experts run in torch."""
    attn = fa.attn_scores_pv_key(MOE_YAML["hidden_dim"] // MOE_YAML["num_heads"])
    if quantized:
        folded = {"quant_rows.ln.bf16": 1, "quant_rows.bf16": 1, "quant_rows.ln.f32": 1,
                  "quant_rows.f32": 1, "gemm_s8_epilogue.bias": 1,
                  "gemm_s8_epilogue.residual_f32": 1, "gemm_s8_epilogue.gelu_f32": 1,
                  "gemm_s8_epilogue.residual": 1, attn: 1}
        attention = {"quant_rows.ln.bf16": 1, "gemm_s8_epilogue.bias": 1, attn: 1,
                     "quant_rows.bf16": 1, "gemm_s8_epilogue.residual": 1}
        mlp = {"quant_rows.ln.bf16": 1, "gemm_s8_epilogue.gelu_f32": 1, "quant_rows.f32": 1,
               "gemm_s8_epilogue.residual": 1}
    else:
        folded = dict(FOLDED_PER_LAYER, **{attn: 1})
        attention = {"ln_rows": 1, "gemm_bias_epilogue.bias": 1, attn: 1,
                     "gemm_bias_epilogue.residual": 1}
        mlp = {"ln_rows": 1, "gemm_bias_epilogue.gelu": 1, "gemm_bias_epilogue.residual": 1}

    def experts(e):
        return ({"quant_rows.bf16": 1 + e, "gemm_s8_epilogue.bias_f32": 2 * e}
                if quantized else {})

    counts: dict = {}
    for ea, em in zip(MOE_YAML["attn_moes"], MOE_YAML["mlp_moes"]):
        parts = [folded] if ea == em == 1 else [
            attention if ea == 1 else experts(ea), mlp if em == 1 else experts(em)]
        for part in parts:
            for k, v in part.items():
                counts[k] = counts.get(k, 0) + v
    return counts


def moe_overflow(torch, choices: dict, capacity_factor: float) -> dict:
    """Each routed MLP layer's share of tokens past their expert's capacity
    ceil(T / E * capacity_factor), from the gates' choices."""
    out = {}
    for (i, sub), eid in choices.items():
        if sub != "mlp":
            continue
        e_total = MOE_YAML["mlp_moes"][i]
        t = eid.numel()
        cap = int(math.ceil(t / e_total * capacity_factor))
        counts = torch.bincount(eid.reshape(-1), minlength=e_total)
        out[f"layer_{i}"] = (counts - cap).clamp_min(0).sum().item() / t
    return out


def moe_phases(torch, F, fa, tq, dev, smi, check, checks, build_info) -> dict:
    """Phase 42, the MoE ViT: GEMM s8 ``bias_f32`` (epilogue 6, the int8
    experts' linear) at the MoE fc1 and fc2 shapes of a bs256 forward
    (M 102,656; K / N 256 / 768) against its plain version, bit for bit,
    rerun bit-identical; build_model("moevit", MOE_YAML) (seeded weights,
    head and class token re-drawn) serves 8 and 256 images through four
    engines (dense bf16, routed at 2.0 and at 1.0 with
    routed_min_experts=2, int8), counts zeroed just before each forward
    and read just after (moe_counts, key by key); the dense and int8
    logits against their plain twins fed the engine's expert choices
    (bf16 3e-2, int8 5e-2 of max|plain|, top-1 on decided images), the
    free-running choice agreement, routed 2.0 against dense (no expert
    overflows at E = 2: cap = T), routed 1.0's overflow share; ms per
    bs256 forward of each engine and one profiled forward of each (device
    ms by group: the port's kernels against torch work); bias_f32 timed
    at both shapes beside its bound, plain version and torch._int_mm +
    dequant; ptxas of the new instances (a spill fails). Returns the
    counts and the kernels-line entry."""
    from peekvit_torch import InferenceEngine, build_model
    from peekvit_torch.inference import (moevit_forward_fused, moevit_forward_plain,
                                         moevit_forward_quant, moevit_forward_quant_plain)

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(42)
    d, m = MOE_YAML["hidden_dim"], MOE_YAML["mlp_dim"]
    n = (MOE_YAML["image_size"] // MOE_YAML["patch_size"]) ** 2 + 1
    rows = MOE_REQUESTS[-1] * n

    # the new epilogue at the experts' shapes: fc1 reads the LN output's
    # codes, fc2 the bf16 gelu output's
    shapes = {"fc1": (d, m), "fc2": (m, d)}
    gemm_ins = {}
    with torch.inference_mode():
        for name, (k, nn_) in shapes.items():
            x = (torch.randn(rows, k, generator=gen, device=dev) * (1.0 if name == "fc1" else 0.3)
                 ).to(bf16)
            a, sa = tq.quant_rows(x)
            w, sw = tq.quantize_linear(torch.randn(k, nn_, generator=gen, device=dev) * k ** -0.5)
            w = tq.kernel_layout(w)
            b = (torch.randn(nn_, generator=gen, device=dev) * 0.1).to(bf16)
            gemm_ins[name] = (a, sa, w, sw, b)
            got = tq.gemm_s8_epilogue(a, sa, w, sw, b, "bias_f32")
            again = tq.gemm_s8_epilogue(a, sa, w, sw, b, "bias_f32")
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or not torch.equal(got, again):
                raise AssertionError(f"gemm_s8_epilogue.bias_f32 {name}: dtype {got.dtype} or "
                                     "a rerun differs")
            check(f"gemm_s8_epilogue.bias_f32.{name}", got,
                  tq.gemm_s8_epilogue_ref(a, sa, w, sw, b, "bias_f32"), 0.0,
                  "exact s32 sums; the dequant steps rounded as the plain version's (__f*_rn): "
                  "bit for bit")
    checks["gemm_s8_epilogue.bias_f32"] = max(checks["gemm_s8_epilogue.bias_f32.fc1"],
                                              checks["gemm_s8_epilogue.bias_f32.fc2"])

    model = build_model("moevit", MOE_YAML, seed=0, device=DEVICE)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in (model.head.kernel, model.class_token):
            p.copy_(torch.randn(p.shape, generator=cpu_gen) * 0.02)
    engines = {name: InferenceEngine(model, device=DEVICE, **kw) for name, kw in MOE_ENGINES.items()}
    want = {q: moe_counts(fa, q) for q in (False, True)}
    totals: dict = {}
    requests = {}
    with torch.inference_mode():
        for bb in MOE_REQUESTS:
            size = MOE_YAML["image_size"]
            x = requests[bb] = torch.randn(bb, size, size, 3, generator=gen, device=dev)
            logits = {}
            for name, e in engines.items():
                got, counts = counted(torch, fa, lambda: e(x))
                if counts != want[name == "int8"]:
                    raise AssertionError(f"moe {name} b{bb}: launches {counts}, "
                                         f"want {want[name == 'int8']}")
                if got.shape != (bb, MOE_YAML["num_classes"]) or not torch.isfinite(got).all():
                    raise AssertionError(f"moe {name} b{bb}: logits {tuple(got.shape)} or "
                                         "non-finite")
                for key, v in counts.items():
                    totals[key] = totals.get(key, 0) + v
                logits[name] = got
            rec = {}
            for name, fused, plain, tol in (
                    ("dense", moevit_forward_fused, moevit_forward_plain, MOE_TOL["bf16"]),
                    ("int8", moevit_forward_quant, moevit_forward_quant_plain, MOE_TOL["int8"])):
                e = engines[name]
                fwd = {k: v for k, v in e._forward.items() if k != "compute_dtype"}
                chosen, free = {}, {}
                again = fused(e.params, x, expert_out=chosen, **e._forward)
                if not torch.equal(again, logits[name]):
                    raise AssertionError(f"moe {name} b{bb}: a rerun's logits differ")
                pinned = plain(e.params, x, compute_dtype=bf16, expert_ids=chosen, **fwd)
                plain(e.params, x, compute_dtype=bf16, expert_out=free, **fwd)
                atol = tol * pinned.abs().max().item()
                rec[name] = compare_logits(torch, f"moe {name} b{bb}", logits[name],
                                           [("plain_pinned", pinned, 0.0, atol)])
                rec[name]["free_running_choice_agreement"] = {
                    f"layer_{i}.{sub}": (chosen[(i, sub)] == free[(i, sub)]).float().mean().item()
                    for i, sub in chosen}
                rec[name]["tolerance_rel"] = tol
            # routed at capacity 2.0, E = 2: cap = T, nothing overflows
            rec["routed_2"] = compare_logits(
                torch, f"moe routed_2 b{bb}", logits["routed_2"],
                [("dense", logits["dense"], 0.0,
                  MOE_TOL["bf16"] * logits["dense"].abs().max().item())])
            routed_choices = {}
            e1 = engines["routed_1"]
            moevit_forward_fused(e1.params, x, expert_out=routed_choices, **e1._forward)
            rec["routed_1"] = {
                "overflow_share": moe_overflow(torch, routed_choices, 1.0),
                "top1_agreement_with_dense": (logits["routed_1"].argmax(-1)
                                              == logits["dense"].argmax(-1)).float().mean().item(),
                "max_abs_delta_vs_dense": (logits["routed_1"] - logits["dense"]).abs().max().item()}
            emit({"phase": "moe_check", "batch": bb, **rec,
                  "tolerance_reason": "the plain twins take the same rounding points and the "
                  "engine's expert choices (bf16 near-ties of two gate scores would swap a "
                  "token's expert); bf16: the repo's kernel tolerance (tests/test_pallas.py:42), "
                  "int8: the repo's int8 engine tolerance (tests/test_inference.py:728-730)",
                  "card": smi})
    for key in want[True]:
        if totals.get(key, 0) == 0:
            raise AssertionError(f"{key}: never launched on the MoE paths")
    emit({"phase": "moe_launches", "counts": totals,
          "per_forward": {"bf16": want[False], "int8": want[True]},
          "requests": list(MOE_REQUESTS), "engines": list(MOE_ENGINES), "card": smi})

    # each engine at bs256, then one profiled forward of each
    x = requests[MOE_REQUESTS[-1]]
    forward_ms = {}
    with torch.inference_mode():
        for name, e in engines.items():
            forward_ms[name] = cuda_ms(torch, lambda: e(x), iters=10)
            emit({"phase": "timing_moe", "engine": name, "batch": MOE_REQUESTS[-1],
                  "ms_per_forward": forward_ms[name],
                  "images_per_s": MOE_REQUESTS[-1] / forward_ms[name] * 1e3, "card": smi})
        for name, e in engines.items():
            profile_step(torch, smi, lambda: e(x), forward_ms[name],
                         phase=f"profile_moe_{name}_forward", batch=MOE_REQUESTS[-1],
                         warmup=True)

        # bias_f32 at both shapes beside its bound, plain and library
        entry = None
        for name, (a, sa, w, sw, b) in gemm_ins.items():
            k, nn_ = w.shape
            w_lib = int_mm_operand(torch, a, w)
            ms = cuda_ms(torch, lambda: tq.gemm_s8_epilogue(a, sa, w, sw, b, "bias_f32"))
            dev_ms = graph_ms(torch, lambda: tq.gemm_s8_epilogue(a, sa, w, sw, b, "bias_f32"))
            plain_ms = cuda_ms(torch, lambda: tq.gemm_s8_epilogue_ref(a, sa, w, sw, b,
                                                                      "bias_f32"), iters=3)
            lib_ms = cuda_ms(torch, lambda: torch._int_mm(a, w_lib).float() * sa * sw
                             + b.float())
            t_ops = 2.0 * rows * k * nn_ / PEAK_INT8_OPS * 1e3
            t_bytes = (rows * k + k * nn_ + rows * 4 + nn_ * 6 + rows * nn_ * 4) / PEAK_BYTES * 1e3
            bnd, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
            rec = {"name": "gemm_s8_epilogue.bias_f32", "route": "cuda",
                   "source": "peekvit_torch/csrc/gemm_s8_epilogue.cu", "replaces": REPLACES_MOE,
                   "launches": totals.get("gemm_s8_epilogue.bias_f32", 0),
                   "max_abs_err": checks["gemm_s8_epilogue.bias_f32"], "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                   "library_ms": lib_ms, "path": "moe", "shape_batch": MOE_REQUESTS[-1],
                   "shape": f"{name}: M {rows}, K {k}, N {nn_}", "plan": tq.gemm_s8_plan(rows, nn_)}
            emit({"phase": "timing_kernel", **rec, "share_of_bound": bnd / dev_ms,
                  "library": "torch._int_mm + the dequant in torch ops", "card": smi})
            if name == "fc1":
                entry = dict(rec, count_key="gemm_s8_epilogue.bias_f32")
    rows_ptx = [r for r in ptxas_summary(build_info, ("gemm_s8_epilogue",))
                if "gemm_s8_kernelILi6E" in r["kernel"]]
    spilled = [r["kernel"] for r in rows_ptx
               if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    emit({"phase": "ptxas_bias_f32", "kernels": rows_ptx if rows_ptx else "not rebuilt in this run",
          "spilled": spilled, "card": smi})
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")
    if build_info.get("gemm_s8_epilogue", {}).get("ptxas") and len(rows_ptx) != 2:
        raise AssertionError(f"ptxas reported {len(rows_ptx)} bias_f32 instances, want 2")
    emit({"phase": "moe_elapsed", "seconds": time.perf_counter() - t0, "card": smi})
    return {"counts": totals, "entries": [entry]}


# ------------------------------ 44. family training, 45. noise on the engines

# 44: configs/model/avit_s_16_224.yaml at 224 px with
# configs/loss/avit_losses.yaml, maevit.yaml and residualvitwithdecoder.yaml
# (reconstruction_weight 1.0) at 160 px, moevit.yaml at 160 px: full width
# and depth, seeded weights (heads and class tokens re-drawn at 0.02)
AVIT_LOSSES = {
    "distr_prior_loss": {"_target_": "peekvit.utils.losses.AViTDPriorLoss", "target_depth": 11,
                         "weight": 0.2},
    "ponder_loss": {"_target_": "peekvit.utils.losses.AViTPonderLoss", "weight": 0.0005}}
FAMILY_TRAIN = {  # name -> (registry name, model args, Trainer keywords)
    "avit": ("adavit", AVIT_S16, {"losses": AVIT_LOSSES}),
    "maevit": ("maevit", RECON_MODELS["maevit"], {}),
    "encdecresidualvit": ("encdecresidualvit", RECON_MODELS["encdecresidualvit"],
                          {"reconstruction_weight": 1.0}),
    "moevit": ("moevit", MOE_YAML, {}),
}
FAMILY_BATCH = 128
FAMILY_STEPS = 3
FAMILY_SERVE = 64  # images each trained model serves through its engine
# 45: configs/noise/gaussian.yaml (10 dB) and digital.yaml (token drop at
# 0.1) at their layer 6 where the model has one; RankViT-B/16 at its first
# ranked layer (3: the engine refuses a later one, as JAX's does);
# moevit.yaml has 4 layers: layer 2, its first with two MLP experts
NOISE_VALUES = {"gaussian": 10.0, "token_drop": 0.1}
NOISE_MODELS = {  # name -> (registry name, args, noise layer, budget, image size)
    "vit": ("vit", B16, 6, None),
    "residualvit": ("residualvit", RESIDUALVIT_B16, 6, 0.5),
    "rankvit": ("rankvit", RANKVIT_B16, 3, 0.5),
    "moevit": ("moevit", MOE_YAML, 2, None),
}
NOISE_CHECK_BATCH = 32
NOISE_SEED = 45
TOL_BF16, TOL_INT8 = 3e-2, 5e-2  # of max|plain|: tests/test_pallas.py:42, test_inference.py:728


def family_counts(fa, key: str) -> dict:
    """Launches per forward of a trained family's engine: A-ViT's 7 a layer,
    the recon engines' (recon_counts), the dense MoE's (moe_counts)."""
    if key == "avit":
        return {k: v * AVIT_S16["num_layers"] for k, v in AVIT_PER_LAYER.items()}
    if key == "moevit":
        return moe_counts(fa, False)
    return recon_counts(fa, key)


def family_train_phases(torch, fa, dev, smi) -> dict:
    """Phase 44, the families that train on the module path (the JAX
    Trainer's linen step): A-ViT-S/16 with the A-ViT losses, the MAE, the
    EncDec (reconstruction_weight 1.0) and the MoE ViT at FAMILY_TRAIN each
    take three Trainer(AdamW(1e-4), clip 1.0) steps on one bs128 batch
    (ms per step by CUDA events, the steps' peak memory, every metric
    finite; the module path runs the model's fp32 forward and no kernel of
    the port: its launches are counted and must be 0). Each trained model
    then serves FAMILY_SERVE images through its InferenceEngine on the
    ported kernels (the recon engines with recon_outputs=True), counts
    zeroed just before and read just after (family_counts, key by key),
    held against its plain twin within 3e-2 of max|plain| (A-ViT fed the
    engine's halting decisions, the MoE its expert choices). Returns the
    serving counts."""
    from peekvit_torch import InferenceEngine, Trainer
    from peekvit_torch.inference import (adavit_forward_fused, adavit_forward_plain,
                                         maevit_forward_plain, moevit_forward_fused,
                                         moevit_forward_plain, residualvit_forward_plain)
    from peekvit_torch.training.optim import AdamW
    from peekvit_torch.utils.losses import LossCompose

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(44)
    totals: dict = {}
    for key, (name, args, kw) in FAMILY_TRAIN.items():
        model = seeded_residual_model(torch, name, args)
        compose = LossCompose(kw["losses"]) if "losses" in kw else None
        trainer = Trainer(model, AdamW(lr=1e-4), clip_grad_norm=1.0, loss_compose=compose,
                          reconstruction_weight=kw.get("reconstruction_weight", 0.0),
                          device=DEVICE)
        size = args["image_size"]
        x = torch.randn(FAMILY_BATCH, size, size, 3, generator=gen, device=dev)
        y = torch.randint(0, args["num_classes"], (FAMILY_BATCH,), generator=gen, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        step_ms, metrics = [], []
        for i in range(FAMILY_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            m = trainer.train_step(x, y, step_idx=i)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in m.items()})
        train_counts = dict(fa.LAUNCHES)
        rec = {"phase": "family_train", "model": key, "config": args, "batch": FAMILY_BATCH,
               "train_kind": trainer._train_kind, "ms_per_step": step_ms,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "peak_over_start_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               "metrics": metrics, "launches": train_counts, "card": smi}
        emit(rec)
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"{key}: non-finite training metrics {metrics}")
        if trainer._train_kind != "module" or train_counts:
            raise AssertionError(f"{key}: train kind {trainer._train_kind}, launches "
                                 f"{train_counts}: the module path runs no port kernel")
        want_keys = {"avit": {"distr_prior_loss", "ponder_loss"},
                     "encdecresidualvit": {"reconstruction_loss"}}.get(key, set())
        if set(metrics[0]) != {"classification_loss", "total_loss"} | want_keys:
            raise AssertionError(f"{key}: metrics {sorted(metrics[0])}")

        # the trained weights served on the ported kernels
        recon = key in ("maevit", "encdecresidualvit")
        engine = InferenceEngine(model, device=DEVICE, recon_outputs=recon)
        xs = x[:FAMILY_SERVE]
        kwb = {"budget": RECON_BUDGET} if key == "encdecresidualvit" else {}
        with torch.inference_mode():
            got, counts = counted(torch, fa, lambda: engine(xs, **kwb))
            want_counts = family_counts(fa, key)
            if counts != want_counts:
                raise AssertionError(f"{key} served: launches {counts}, want {want_counts}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            fwd = {k: v for k, v in engine._forward.items() if k != "compute_dtype"}
            extra = {}
            if key == "avit":
                decisions = []
                adavit_forward_fused(engine.params, xs, active_out=decisions, **engine._forward)
                ref = adavit_forward_plain(engine.params, xs, active_in=decisions,
                                           compute_dtype=bf16, **fwd)
            elif key == "moevit":
                chosen = {}
                again = moevit_forward_fused(engine.params, xs, expert_out=chosen,
                                             **engine._forward)
                if not torch.equal(again, got):
                    raise AssertionError("moevit served: a rerun's logits differ")
                ref = moevit_forward_plain(engine.params, xs, compute_dtype=bf16,
                                           expert_ids=chosen, **fwd)
            elif key == "maevit":
                ref = maevit_forward_plain(engine.params, xs, compute_dtype=bf16, **fwd)
            else:
                ref = residualvit_forward_plain(engine.params, xs, RECON_BUDGET,
                                                compute_dtype=bf16, **fwd)
            outs, refs = ((t if isinstance(t, tuple) else (t,)) for t in (got, ref))
            rec = compare_logits(torch, f"{key} served", outs[0],
                                 [("plain_bf16", refs[0], 0.0,
                                   TOL_BF16 * refs[0].abs().max().item())])
            for label, g, r in zip(("reconstruction", "mask_image"), outs[1:], refs[1:]):
                rel = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                extra[label] = {"shape": list(g.shape), "max_rel_err": rel}
                if g.shape != r.shape or not torch.isfinite(g).all() or rel > TOL_BF16:
                    raise AssertionError(f"{key} served {label}: {extra[label]}")
            serve_ms = cuda_ms(torch, lambda: engine(xs, **kwb), iters=5)
        emit({"phase": "family_serve", "model": key, "batch": FAMILY_SERVE, "launches": counts,
              **rec, **extra, "ms_per_forward": serve_ms, "tolerance_rel": TOL_BF16,
              "tolerance_reason": "the plain twin takes the same rounding points (the A-ViT "
              "the engine's halting decisions, the MoE its expert choices), fp32 sums in "
              "another order; the repo's bf16 tolerance (tests/test_pallas.py:42)", "card": smi})
        del trainer, engine, model
        torch.cuda.empty_cache()
    emit({"phase": "family_elapsed", "seconds": time.perf_counter() - t0, "card": smi})
    return {"counts": totals}


def noise_plain_twin(torch, family: str, quantized: bool, e, x, budget, spec, bf16):
    """The engine's forward and its plain twin under one noise realization
    (two generators of one seed): RankViT's twin fed the engine's kept
    tokens, the MoE's its expert choices. Returns (engine logits, twin)."""
    from peekvit_torch import inference as ti

    def fresh():
        return spec._replace(generator=torch.Generator(device=x.device).manual_seed(NOISE_SEED))

    fwd = {k: v for k, v in e._forward.items() if k != "compute_dtype"}
    q = {"caps": e.caps} if quantized else {}
    if family == "vit":
        fused, plain = ((ti.vit_forward_quant, ti.vit_forward_quant_plain) if quantized
                        else (ti.vit_forward_fused, ti.vit_forward_plain))
        return (fused(e.params, x, noise=fresh(), **e._forward, **q),
                plain(e.params, x, compute_dtype=bf16, noise=fresh(), **fwd, **q))
    if family == "residualvit":
        fused, plain = ((ti.residualvit_forward_quant, ti.residualvit_forward_quant_plain)
                        if quantized else (ti.residualvit_forward_fused,
                                           ti.residualvit_forward_plain))
        return (fused(e.params, x, budget, noise=fresh(), **e._forward, **q),
                plain(e.params, x, budget, compute_dtype=bf16, noise=fresh(), **fwd, **q))
    if family == "rankvit":
        fused, plain = ((ti.rankvit_forward_quant, ti.rankvit_forward_quant_plain) if quantized
                        else (ti.rankvit_forward_fused, ti.rankvit_forward_plain))
        kept = {}
        got = fused(e.params, x, budget=budget, kept_out=kept, noise=fresh(), **e._forward, **q)
        return got, plain(e.params, x, budget=budget, compute_dtype=bf16, kept_idx=kept,
                          noise=fresh(), **fwd, **q)
    fused, plain = ((ti.moevit_forward_quant, ti.moevit_forward_quant_plain) if quantized
                    else (ti.moevit_forward_fused, ti.moevit_forward_plain))
    chosen = {}
    got = fused(e.params, x, expert_out=chosen, noise=fresh(), **e._forward)
    return got, plain(e.params, x, compute_dtype=bf16, expert_ids=chosen, noise=fresh(), **fwd)


def noise_phases(torch, fa, dev, smi) -> dict:
    """Phase 45, the NoiseBlock on the engines: ViT-B/16, ResidualViT-B/16
    (exact, budget 0.5), RankViT-B/16 (exact, budget 0.5, noise at its
    first ranked layer) and moevit.yaml, each built with
    noise_args={"layer", "noise_type"} (NOISE_MODELS) for gaussian noise at
    10 dB and token drop at 0.1, served in bf16 and int8 with a noise
    generator on the card: counts zeroed just before and read just after
    each noisy forward, which must launch what the same engine launches
    without noise, key by key (the ViT leaves the one-call chain for its
    per-layer calls: the same kernels); logits against the plain twin fed
    the same realization (a generator of the same seed; RankViT's twin the
    kept tokens, the MoE's the expert choices) within 3e-2 (bf16) and 5e-2
    (int8) of max|plain|, top-1 on decided images; the noise's move of the
    logits (gaussian noise must move them); ms per bs256 forward beside the
    same engine without noise.
    Returns the noisy forwards' counts."""
    from peekvit_torch import InferenceEngine
    from peekvit_torch.ops.noise import NoiseSpec

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    img_gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    totals: dict = {}
    for family, (name, args, layer, budget) in NOISE_MODELS.items():
        size = args["image_size"]
        x = torch.randn(BATCH, size, size, 3, generator=img_gen, device=dev)
        xs = x[:NOISE_CHECK_BATCH]
        bkw = {} if budget is None else {"budget": budget}
        for noise_type, value in NOISE_VALUES.items():
            model = seeded_residual_model(torch, name, args,
                                          noise_args={"layer": layer, "noise_type": noise_type})
            for quantized in (False, True):
                e = InferenceEngine(model, device=DEVICE, quantized=quantized)
                label = f"{family} {'int8' if quantized else 'bf16'} {noise_type}"

                def noisy(images, e=e):
                    return e(images, noise_value=value,
                             noise_rng=torch.Generator(device=dev).manual_seed(NOISE_SEED), **bkw)

                with torch.inference_mode():
                    got, counts = counted(torch, fa, lambda: noisy(xs))
                    clean, clean_counts = counted(torch, fa, lambda: e(xs, **bkw))
                    if counts != clean_counts or not counts:
                        raise AssertionError(f"{label}: launches {counts}, without noise "
                                             f"{clean_counts}")
                    for k, v in counts.items():
                        totals[k] = totals.get(k, 0) + v
                    spec = NoiseSpec(layer, noise_type, value, None)
                    again, ref = noise_plain_twin(torch, family, quantized, e, xs, budget, spec,
                                                  bf16)
                    if not torch.equal(again, got):
                        raise AssertionError(f"{label}: the same generator seed drew otherwise")
                    tol = TOL_INT8 if quantized else TOL_BF16
                    rec = compare_logits(torch, label, got,
                                         [("plain_noisy", ref, 0.0, tol * ref.abs().max().item())])
                    ms_noisy = cuda_ms(torch, lambda: noisy(x), iters=5)
                    ms_clean = cuda_ms(torch, lambda: e(x, **bkw), iters=5)
                emit({"phase": "noise_check", "model": family, "noise_type": noise_type,
                      "noise_value": value, "noise_layer": layer, "int8": quantized,
                      "batch": NOISE_CHECK_BATCH, "launches": sum(counts.values()),
                      "counts": counts, **rec,
                      "noise_moved_logits_max": (got - clean).abs().max().item(),
                      "top1_agreement_with_clean": (got.argmax(-1) == clean.argmax(-1))
                      .float().mean().item(),
                      "ms_per_forward_noisy": ms_noisy, "ms_per_forward_clean": ms_clean,
                      "timing_batch": BATCH, "tolerance_rel": tol,
                      "tolerance_reason": "the plain twin draws the same realization from a "
                      "generator of the same seed and takes the same rounding points; bf16: "
                      "the repo's kernel tolerance (tests/test_pallas.py:42), int8: its int8 "
                      "engine tolerance (tests/test_inference.py:728-730)", "card": smi})
                # gaussian noise reaches every token; a drop can fall on
                # tokens that are gated off, so its move is only reported
                if noise_type == "gaussian" and (got - clean).abs().max().item() == 0.0:
                    raise AssertionError(f"{label}: the noise did not move the logits")
                del e
            del model
            torch.cuda.empty_cache()
    emit({"phase": "noise_launches", "counts": totals, "values": NOISE_VALUES,
          "elapsed_s": time.perf_counter() - t0, "card": smi})
    return {"counts": totals}


# Phase 46, the entry points: the CLI runs' overrides beside the repo's
# configs (the shipped vit_tiny / residualvit at imagenette.yaml's 160 px on
# synthetic data: 512 training images, 4 steps of train_batch_size 128, one
# epoch; the base test config's batch of 128 over 256 val images)
CLI_WORKSPACE = os.path.join("workspace", "chip_smoke_cli")
CLI_NOISE_LAYER, CLI_NOISE_VALUE = 2, 10.0  # noise=gaussian, noise.layer=2, 10 dB
CLI_BUDGETS = (0.25, 0.5, 1.0)
CLI_PTH_IMAGES = 224                         # vit_b_16_pretrained at imagenet.yaml's size
CLI_PTH_CLASSES = 10                         # the synthetic dataset's classes
CLI_PTH_SEED = 46
CLI_TIMING_CALLS = 2 + 5                     # utils/timing.py: warm-up and timed calls
# launches per layer of the plain ViT engine (site 9's chain); the
# attention is keyed by head dim (engine_per_forward)
VIT_ENGINE_PER_LAYER = {"norm_rows.bf16": 1, "norm_rows.f32": 1, "gemm_bias_epilogue.bias": 1,
                        "gemm_bias_epilogue.residual_f32": 1, "gemm_bias_epilogue.gelu": 1,
                        "gemm_bias_epilogue.residual": 1}


class CallRecorder:
    """Wraps ``cls.name`` for a ``with`` block: per call its launches (the
    counts' difference over the call; the counts are host-side, so no
    synchronization), its seconds on the host clock, and, with ``keep``,
    the object, the arguments and the output."""

    def __init__(self, fa, cls, name: str, keep: bool = False):
        self.fa, self.cls, self.name, self.keep = fa, cls, name, keep
        self.calls: list = []

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)
        fa, calls, keep = self.fa, self.calls, self.keep

        def wrapped(obj, *args, **kwargs):
            before, t0 = dict(fa.LAUNCHES), time.perf_counter()
            out = orig(obj, *args, **kwargs)
            rec = {"launches": {k: v - before.get(k, 0) for k, v in fa.LAUNCHES.items()
                                if v != before.get(k, 0)},
                   "seconds": time.perf_counter() - t0}
            if keep:
                rec.update(obj=obj, args=args, kwargs=kwargs, out=out)
            calls.append(rec)
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def run_cli(main, argv: list) -> tuple:
    """main(argv) with its printed lines captured: (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines()


def engine_per_forward(fa, per_layer: dict, head_dim: int, layers: int) -> dict:
    return {k: v * layers for k, v in dict(per_layer, **{fa.attn_scores_pv_key(head_dim): 1})
            .items()}


def sweep_check(torch, label: str, calls: list, labels, acc: float, twin,
                tol: float = None) -> dict:
    """A sweep's engine calls (its val batches in order) against the plain
    twin ``twin(call)`` on the same images: within ``tol`` (3e-2) of
    max|plain|, top-1 on every decided image (compare_logits). The
    engine's accuracy over them must be the sweep's, and the twin's may
    differ from it only by the undecided images."""
    tol = TOL_BF16 if tol is None else tol
    got = torch.cat([c["out"] for c in calls])
    ref = torch.cat([twin(c) for c in calls])
    y = torch.as_tensor(labels, device=got.device)
    rec = compare_logits(torch, label, got, [("plain_bf16", ref, 0.0,
                                              tol * ref.abs().max().item())])
    acc_engine = (got.argmax(-1) == y).float().mean().item()
    acc_twin = (ref.argmax(-1) == y).float().mean().item()
    undecided = got.shape[0] - rec["plain_bf16"]["decided"]
    rec.update(accuracy_sweep=acc, accuracy_engine=acc_engine, accuracy_twin=acc_twin,
               undecided=undecided)
    if abs(acc_engine - acc) > 1e-6 or abs(acc_twin - acc) * got.shape[0] > undecided + 1e-6:
        raise AssertionError(f"{label}: accuracies {rec}")
    return rec


def seeded_vit_b16_pth(torch, path: str) -> None:
    """A torchvision-grammar ViT-B/16 state dict (configs/model/vit_b_16*.yaml
    widths, a CLI_PTH_CLASSES-class head) of seeded normal(0, 0.02) weights
    with LayerNorm scales 1, written to ``path``."""
    gen = torch.Generator().manual_seed(CLI_PTH_SEED)
    d, m, p = B16["hidden_dim"], B16["mlp_dim"], B16["patch_size"]
    n = (CLI_PTH_IMAGES // p) ** 2 + 1

    def w(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {"class_token": w(1, 1, d), "conv_proj.weight": w(d, 3, p, p), "conv_proj.bias": w(d),
          "encoder.pos_embedding": w(1, n, d), "encoder.ln.weight": torch.ones(d),
          "encoder.ln.bias": w(d), "heads.head.weight": w(CLI_PTH_CLASSES, d),
          "heads.head.bias": w(CLI_PTH_CLASSES)}
    for i in range(B16["num_layers"]):
        pre = f"encoder.layers.encoder_layer_{i}."
        sd.update({pre + "ln_1.weight": torch.ones(d), pre + "ln_1.bias": w(d),
                   pre + "self_attention.in_proj_weight": w(3 * d, d),
                   pre + "self_attention.in_proj_bias": w(3 * d),
                   pre + "self_attention.out_proj.weight": w(d, d),
                   pre + "self_attention.out_proj.bias": w(d),
                   pre + "ln_2.weight": torch.ones(d), pre + "ln_2.bias": w(d),
                   pre + "mlp.0.weight": w(m, d), pre + "mlp.0.bias": w(m),
                   pre + "mlp.3.weight": w(d, m), pre + "mlp.3.bias": w(d)})
    torch.save(sd, path)


def cli_phases(torch, fa, dev, smi) -> dict:
    """Phase 46, the entry points on the card, driven by the repo's configs
    through ``cli.train.main`` / ``cli.test.main`` as a user calls them (an
    explicit experiment_name each, under workspace/chip_smoke_cli, removed
    at the end):

    (a) ``model=vit_tiny`` on synthetic data at 160 px, one epoch (4 steps
        of bs128 at full width) on the fused path: each step's launches
        equal phase 39's for that config (shipped_per_layer) and nothing
        else launches in the run; losses finite; the checkpoint committed;
        the epoch's ms, and the loader's ms a batch alone and through
        prefetch_to_device;
    (b) ``cli.test load_from=<(a)>``: every engine forward 28 launches
        (VIT_ENGINE_PER_LAYER at head dim 32); the sweep held against the
        engine's plain twin on the same batches (sweep_check); wall and
        device images/s;
    (c) ``model=residualvit loss=crossentropy_mse`` as (a) on the fused
        residual path, then ``cli.test`` at CLI_BUDGETS with
        ``noise=gaussian noise.layer=2`` and one noise value: the run
        prints ``eval path: fused InferenceEngine``, 28 launches a forward
        (RESIDUAL_PER_LAYER), each budget's sweep against the noisy plain
        twin (one realization: a generator seeded 0, the engine's default);
    (d) ``model=vit_b_16_pretrained model.torch_pretrained_weights=<a
        seeded torchvision-grammar .pth>`` at 224 px and no checkpoint: 84
        launches a forward, logits within 3e-2 of max|plain| of the plain
        twin, top-1 on every decided image.

    Any failure raises. Returns the train steps' and the engine forwards'
    counts."""
    import shutil

    from peekvit_torch import InferenceEngine, Trainer
    from peekvit_torch import inference as ti
    from peekvit_torch.cli import test as cli_test
    from peekvit_torch.cli import train as cli_train
    from peekvit_torch.data.loader import DataLoader, prefetch_to_device
    from peekvit_torch.ops.noise import NoiseSpec
    from peekvit_torch.utils.checkpoint import get_checkpoint_path
    from peekvit_torch.utils.config import instantiate, load_config

    bf16 = torch.bfloat16
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    configs = os.path.join(root, "configs")
    work = os.path.join(root, CLI_WORKSPACE)
    shutil.rmtree(work, ignore_errors=True)
    base = [f"workspace={work}", "dataset=synthetic"]
    train_counts, test_counts = {}, {}

    def add(totals, counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    def plain_kwargs(engine):
        return {k: v for k, v in engine._forward.items() if k != "compute_dtype"}

    def train_run(name, extra):
        """One training run of a shipped config; returns its experiment dir."""
        overrides = base + [f"experiment_name={name}", f"model={name}",
                            "training.num_epochs=0"] + extra
        fa.reset_launch_counts()
        with CallRecorder(fa, Trainer, "train_step", keep=True) as steps, \
                CallRecorder(fa, Trainer, "train_epoch") as epochs:
            res, lines = run_cli(cli_train.main, overrides + ["--device", DEVICE])
        torch.cuda.synchronize()
        total, res = dict(fa.LAUNCHES), res[0]
        trainer = steps.calls[0]["obj"]
        layers = SHIPPED[name][1]["num_layers"]
        want = {k: v * layers for k, v in shipped_per_layer(fa, name, 160).items()}
        per_step = [c["launches"] for c in steps.calls]
        losses = [float(c["out"]["total_loss"]) for c in steps.calls]
        ckpt = get_checkpoint_path(res["experiment_dir"])
        # the loader alone, and through prefetch_to_device, over one epoch
        cfg = load_config(configs, "train_config", overrides)
        loader = DataLoader(instantiate(cfg.dataset).train_dataset,
                            cfg.training.train_batch_size, shuffle=True,
                            num_workers=cfg.training.num_workers, drop_last=True, seed=cfg.seed)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader)
        loader_ms = (time.perf_counter() - t0) / n_batches * 1e3
        t0 = time.perf_counter()
        for _ in prefetch_to_device(iter(loader), size=2, device=dev):
            pass
        torch.cuda.synchronize()
        prefetch_ms = (time.perf_counter() - t0) / n_batches * 1e3
        epoch_ms = epochs.calls[0]["seconds"] * 1e3
        emit({"phase": "cli_train", "model": name, "overrides": overrides,
              "steps": len(steps.calls), "train_kind": trainer._train_kind, "losses": losses,
              "launches_per_step": [sum(c.values()) for c in per_step],
              "want_per_step": sum(want.values()), "run_launches": total,
              "epoch_ms": epoch_ms, "epoch_ms_per_step": epoch_ms / len(steps.calls),
              "step_host_ms": [c["seconds"] * 1e3 for c in steps.calls],
              "loader_ms_per_batch": loader_ms, "prefetch_ms_per_batch": prefetch_ms,
              "batch_mb": cfg.training.train_batch_size * 160 * 160 * 3 * 4 / 1e6,
              "checkpoint": ckpt,
              "val_accuracy": {str(k): v for k, v in res["val_accuracy"].items()},
              "printed": lines[-6:], "card": smi})
        if trainer._train_kind != "fused_" + SHIPPED_KIND[name] or len(steps.calls) != 4:
            raise AssertionError(f"cli {name}: {trainer._train_kind}, {len(steps.calls)} steps")
        if any(c != want for c in per_step) or total != {k: 4 * v for k, v in want.items()}:
            raise AssertionError(f"cli {name}: launches {per_step} / {total}, want {want} a step")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli {name}: losses {losses}")
        if not ckpt or not os.path.isfile(os.path.join(ckpt, "params.pt")):
            raise AssertionError(f"cli {name}: no committed checkpoint ({ckpt})")
        add(train_counts, total)
        return res["experiment_dir"]

    def test_run(label, overrides, per_forward, twin):
        """One sweep: every engine forward counted, each budget's sweep
        against the plain twin."""
        fa.reset_launch_counts()
        with CallRecorder(fa, InferenceEngine, "__call__", keep=True) as calls:
            res, lines = run_cli(cli_test.main, overrides + ["--device", DEVICE])
        torch.cuda.synchronize()
        (_, summary), = res.items()
        if not any(line.startswith("eval path: fused InferenceEngine") for line in lines):
            raise AssertionError(f"{label}: not on the engine: {lines}")
        bad = [c["launches"] for c in calls.calls if c["launches"] != per_forward]
        if bad or not calls.calls:
            raise AssertionError(f"{label}: forwards launched {bad[:1]}, want {per_forward}")
        for c in calls.calls:
            add(test_counts, c["launches"])
        cfg = load_config(configs, "test_config", overrides)
        val = instantiate(cfg.dataset).val_dataset
        n_batches = -(-len(val) // cfg.test.test_batch_size)
        # per budget (one noise value): a warm-up call, the sweep, then the
        # device timing's calls
        cell = 1 + n_batches + CLI_TIMING_CALLS
        checks = {}
        for i, (b, by_noise) in enumerate(summary["results_per_budget"].items()):
            (acc,) = by_noise.values()
            sweep = calls.calls[i * cell + 1:i * cell + 1 + n_batches]
            checks[str(b)] = sweep_check(torch, f"{label} budget {b}", sweep, val.labels, acc,
                                         twin)
        emit({"phase": "cli_test", "run": label, "overrides": overrides,
              "forwards": len(calls.calls), "launches_per_forward": sum(per_forward.values()),
              "per_forward": per_forward, "wall_images_per_s": summary["timings_wall"],
              "device_images_per_s": summary["timings_device"],
              "flops_per_image": summary["flops"], "sweep": checks,
              "results_per_budget": {str(b): {str(n): a for n, a in r.items()}
                                     for b, r in summary["results_per_budget"].items()},
              "sparsities": {str(b): s for b, s in summary["sparsities_per_budget"].items()},
              "printed": [ln for ln in lines if ln.startswith(("eval path", "budget=", "recap",
                                                               "no checkpoint"))],
              "tolerance_rel": TOL_BF16, "tolerance_reason": "the plain twin takes the same "
              "rounding points, fp32 sums in another order; the repo's bf16 tolerance "
              "(tests/test_pallas.py:42)", "card": smi})
        if len(calls.calls) != cell * len(summary["results_per_budget"]):
            raise AssertionError(f"{label}: {len(calls.calls)} forwards")
        return summary

    def vit_twin(c):
        e = c["obj"]
        return ti.vit_forward_plain(e.params, c["args"][0], compute_dtype=bf16,
                                    **plain_kwargs(e))

    def residual_twin(c):
        e, x = c["obj"], c["args"][0]
        noise = NoiseSpec(CLI_NOISE_LAYER, "gaussian", c["kwargs"]["noise_value"],
                          torch.Generator(device=x.device).manual_seed(0))
        return ti.residualvit_forward_plain(e.params, x, c["kwargs"]["budget"],
                                            compute_dtype=bf16, noise=noise, **plain_kwargs(e))

    try:
        exp = train_run("vit_tiny", [])
        args = SHIPPED["vit_tiny"][1]
        test_run("vit_tiny", base + ["experiment_name=vit_tiny_eval", f"load_from={exp}"],
                 engine_per_forward(fa, VIT_ENGINE_PER_LAYER,
                                    args["hidden_dim"] // args["num_heads"], args["num_layers"]),
                 vit_twin)
        exp = train_run("residualvit", ["loss=crossentropy_mse"])
        args = SHIPPED["residualvit"][1]
        masked = {k: v for k, v in RESIDUAL_PER_LAYER.items() if k != "attn_scores_pv"}
        budgets = ",".join(str(b) for b in CLI_BUDGETS)
        test_run("residualvit noisy",
                 base + ["experiment_name=residualvit_eval", f"load_from={exp}",
                         f"test.budgets=[{budgets}]", "noise=gaussian",
                         f"noise.layer={CLI_NOISE_LAYER}", f"test.noises=[{CLI_NOISE_VALUE}]"],
                 engine_per_forward(fa, masked, args["hidden_dim"] // args["num_heads"],
                                    args["num_layers"]), residual_twin)
        pth = os.path.join(work, "vit_b_16_seeded.pth")
        seeded_vit_b16_pth(torch, pth)
        test_run("vit_b_16 .pth",
                 base + ["experiment_name=vit_b_16_pth", f"dataset.image_size={CLI_PTH_IMAGES}",
                         "dataset.train_size=8", "model=vit_b_16_pretrained",
                         f"model.torch_pretrained_weights={pth}"],
                 engine_per_forward(fa, VIT_ENGINE_PER_LAYER,
                                    B16["hidden_dim"] // B16["num_heads"], B16["num_layers"]),
                 vit_twin)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "cli_elapsed", "seconds": time.perf_counter() - t_start,
          "train_counts": train_counts, "test_counts": test_counts, "card": smi})
    return {"train_counts": train_counts, "test_counts": test_counts}


QAT_BATCH = 64          # the QAT steps' batch (phase 7's)
QAT_STEPS = 3
QAT_CALIB = 64          # calibration images: cli.train's training.qat_calib_images default
QAT_SERVE = 64          # images each trained model serves through its int8 engine
QAT_BUDGET = 0.5        # the ResidualViT's calibration and serving budget
QAT_LR = 1e-4
QAT_CLI_MODEL = "vit_tiny"
QAT_WORKSPACE = os.path.join("workspace", "chip_smoke_qat")


def qat_steps(torch, fa, trainer, x, y) -> dict:
    """QAT_STEPS train steps on one batch: ms a step (CUDA events), peak
    memory over the steps, the losses, and the port kernels they launched
    (the module path launches none)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_launch_counts()
    step_ms, losses = [], []
    for i in range(QAT_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = trainer.train_step(x, y, step_idx=i)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["total_loss"]))
    return {"ms_per_step": step_ms, "losses": losses, "launches": dict(fa.LAUNCHES),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_over_start_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            "train_kind": trainer._train_kind}


def qat_phases(torch, fa, dev, smi) -> dict:
    """Phase 47, quantization-aware training and its int8 serving:

    (a) ViT-B/16 @224 (configs/model/vit_b_16.yaml, full width and depth,
        seeded weights): three Trainer(AdamW(1e-4), clip 1.0, qat=True)
        steps at bs64 beside three steps of a twin built from the same seed
        on the module path without QAT (ms a step, peak memory), then
        collect_qat_calibration on QAT_CALIB images and three
        qat="static" steps with those caps and SmoothQuant vectors; every
        loss finite, no port kernel launched (the module path);
    (b) ResidualViT-B/16 (residualvit_b_16.yaml): collect_qat_caps through
        the residual collector at budget 0.5, three qat="static" steps;
    (c) each trained model served by InferenceEngine(quantized=True,
        calib_images=the same images, calib_static_caps=True): the counts
        zeroed before and read after one forward of QAT_SERVE images (108
        launches, the expected keys), the logits against the plain twin
        within 5e-2 of max|logit|, top-1 on every decided image; printed,
        not gated: the module's fake-quant eval forward (the grid it trained
        against) and its fp32 forward against the engine, max|delta| over
        max|logit| and the top-1 share;
    (d) cli.train model=vit_tiny dataset=synthetic training.qat=static for
        one epoch (the calibrated-caps line printed, the module path, no
        port kernel launched, finite losses), then cli.test on its
        checkpoint with test.quantized=true test.calib_images=64
        test.calib_static_caps=true: every engine forward counted and the
        sweep held against the int8 plain twin (sweep_check at 5e-2).

    Any failure raises. Returns the served engines' and the sweep's
    counts."""
    from peekvit_torch import InferenceEngine, Trainer
    from peekvit_torch import inference as ti
    from peekvit_torch.cli import test as cli_test
    from peekvit_torch.cli import train as cli_train
    from peekvit_torch.ops.fake_quant import fake_quant
    from peekvit_torch.training.optim import AdamW
    from peekvit_torch.utils.config import instantiate, load_config

    bf16 = torch.bfloat16
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(47)
    size = B16["image_size"]
    x = torch.randn(QAT_BATCH, size, size, 3, generator=gen, device=dev)
    y = torch.randint(0, B16["num_classes"], (QAT_BATCH,), generator=gen, device=dev)
    calib = torch.randn(QAT_CALIB, size, size, 3, generator=gen, device=dev)
    serve = torch.randn(QAT_SERVE, size, size, 3, generator=gen, device=dev)
    serve_counts: dict = {}

    def trainer(model, **kw):
        return Trainer(model, AdamW(lr=QAT_LR), clip_grad_norm=1.0, fused=False, device=DEVICE,
                       **kw)

    def check_steps(label, rec):
        if rec["train_kind"] != "module" or rec["launches"]:
            raise AssertionError(f"{label}: {rec['train_kind']}, launches {rec['launches']}: "
                                 "QAT trains on the module path, which runs no port kernel")
        if not all(math.isfinite(v) for v in rec["losses"]):
            raise AssertionError(f"{label}: losses {rec['losses']}")

    def serve_check(label, model, engine, want_counts, plain, module_forward):
        with torch.inference_mode():
            got, counts = counted(torch, fa, lambda: engine(serve, **kw_budget(model)))
            if counts != want_counts:
                raise AssertionError(f"{label} int8: launches {counts}, want {want_counts}")
            for k, v in counts.items():
                serve_counts[k] = serve_counts.get(k, 0) + v
            ref = plain(engine)
            rec = compare_logits(torch, f"{label} int8", got,
                                 [("plain_bf16", ref, 0.0, TOL_INT8 * ref.abs().max().item())])
            spread = got.abs().max().item()
            agree = {}
            for name, fwd in module_forward.items():
                out = fwd()
                agree[name] = {"max_abs_delta_over_max_logit": (out - got).abs().max().item()
                               / spread,
                               "top1_share": (out.argmax(-1) == got.argmax(-1)).float()
                               .mean().item()}
            ms = cuda_ms(torch, lambda: engine(serve, **kw_budget(model)), iters=5)
        emit({"phase": "qat_serve", "model": label, "batch": QAT_SERVE,
              "launches": sum(counts.values()), "counts": counts, **rec,
              "module_against_engine": agree, "ms_per_forward": ms,
              "tolerance_rel": TOL_INT8, "tolerance_reason": "the plain twin on the same int8 "
              "tree: same rounding points, sums in another order; as phase 19", "card": smi})

    def kw_budget(model):
        return {"budget": QAT_BUDGET} if hasattr(model, "add_budget_token") else {}

    def module_logits(model, caps=None, smoothing=None, quantized=True):
        def run():
            model.eval()
            with torch.no_grad(), fake_quant(quantized, caps, smoothing):
                out, _ = model(serve, **kw_budget(model))
            return out
        return run

    # (a) ViT-B/16: the module path without QAT, then dynamic and static QAT
    plain_model = seeded_residual_model(torch, "vit", B16)
    base = qat_steps(torch, fa, trainer(plain_model), x, y)
    check_steps("vit plain module step", base)
    del plain_model
    torch.cuda.empty_cache()
    model = seeded_residual_model(torch, "vit", B16)
    dyn = qat_steps(torch, fa, trainer(model, qat=True), x, y)
    check_steps("vit qat=True", dyn)
    t0 = time.perf_counter()
    caps, smoothing = ti.collect_qat_calibration(model, calib)
    calib_s = time.perf_counter() - t0
    static = qat_steps(torch, fa, trainer(model, qat="static", qat_caps=caps,
                                          qat_smoothing=smoothing), x, y)
    check_steps("vit qat=static", static)
    base_ms = sorted(base["ms_per_step"])[len(base["ms_per_step"]) // 2]
    emit({"phase": "qat_train", "model": "vit_b_16", "batch": QAT_BATCH, "module_plain": base,
          "qat_dynamic": dyn, "qat_static_smoothed": static, "calibration_s": calib_s,
          "calib_images": QAT_CALIB, "caps_layer0": caps[0],
          "median_ms_over_plain": {
              "dynamic": sorted(dyn["ms_per_step"])[1] / base_ms,
              "static_smoothed": sorted(static["ms_per_step"])[1] / base_ms},
          "card": smi})
    layers = B16["num_layers"]
    engine = InferenceEngine(model, device=DEVICE, quantized=True, calib_images=calib,
                             calib_static_caps=True)
    fwd = dict(engine._forward, compute_dtype=bf16)
    serve_check("vit_b_16", model, engine,
                {k: v * layers for k, v in quant_layer_counts("merged", True).items()},
                lambda e: ti.vit_forward_quant_plain(e.params, serve, caps=e.caps, **fwd),
                {"fake_quant_trained_grid": module_logits(model, caps, smoothing),
                 "fp32": module_logits(model, quantized=False)})
    del model, engine
    torch.cuda.empty_cache()

    # (b) ResidualViT-B/16: residual caps at budget 0.5, static QAT
    model = seeded_residual_model(torch, "residualvit")
    t0 = time.perf_counter()
    rcaps = ti.collect_qat_caps(model, calib, budget=QAT_BUDGET)
    calib_s = time.perf_counter() - t0
    rstatic = qat_steps(torch, fa, trainer(model, qat="static", qat_caps=rcaps), x, y)
    check_steps("residualvit qat=static", rstatic)
    emit({"phase": "qat_train", "model": "residualvit_b_16", "batch": QAT_BATCH,
          "qat_static": rstatic, "calibration_s": calib_s, "calib_images": QAT_CALIB,
          "calib_budget": QAT_BUDGET, "caps_layer0": rcaps[0], "card": smi})
    engine = InferenceEngine(model, device=DEVICE, quantized=True, calib_images=calib,
                             calib_static_caps=True)
    rfwd = {k: v for k, v in engine._forward.items() if k != "compute_dtype"}
    serve_check("residualvit_b_16", model, engine,
                {k: v * layers for k, v in residual_int8_layer_counts(True).items()},
                lambda e: ti.residualvit_forward_quant_plain(e.params, serve, QAT_BUDGET,
                                                             caps=e.caps, compute_dtype=bf16,
                                                             **rfwd),
                {"fake_quant_trained_grid": module_logits(model, rcaps),
                 "fp32": module_logits(model, quantized=False)})
    del model, engine
    torch.cuda.empty_cache()

    # (d) the entry points: train with static QAT, serve the int8 engine
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, QAT_WORKSPACE)
    shutil.rmtree(work, ignore_errors=True)
    base_args = [f"workspace={work}", "dataset=synthetic"]
    cli_test_counts: dict = {}
    try:
        overrides = base_args + ["experiment_name=qat_train", f"model={QAT_CLI_MODEL}",
                                 "training.num_epochs=0", "training.qat=static",
                                 f"training.qat_calib_images={QAT_CALIB}"]
        fa.reset_launch_counts()
        with CallRecorder(fa, Trainer, "train_step", keep=True) as steps:
            res, lines = run_cli(cli_train.main, overrides + ["--device", DEVICE])
        torch.cuda.synchronize()
        train_launches, res = dict(fa.LAUNCHES), res[0]
        tr = steps.calls[0]["obj"]
        losses = [float(c["out"]["total_loss"]) for c in steps.calls]
        n_layers = SHIPPED[QAT_CLI_MODEL][1]["num_layers"]
        line = (f"qat=static: calibrated {n_layers} layer caps on {QAT_CALIB} images "
                "(SmoothQuant-aware)")
        emit({"phase": "qat_cli_train", "overrides": overrides, "steps": len(steps.calls),
              "train_kind": tr._train_kind, "qat": tr.qat, "losses": losses,
              "launches": train_launches, "step_host_ms": [c["seconds"] * 1e3
                                                           for c in steps.calls],
              "val_accuracy": {str(k): v for k, v in res["val_accuracy"].items()},
              "printed": [ln for ln in lines if ln.startswith(("qat=", "epoch"))], "card": smi})
        if line not in lines or tr.qat != "static" or tr._train_kind != "module":
            raise AssertionError(f"cli qat: {tr.qat}, {tr._train_kind}, printed {lines[:8]}")
        if train_launches or not steps.calls or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli qat: launches {train_launches}, losses {losses}")
        test_overrides = base_args + ["experiment_name=qat_eval",
                                      f"load_from={res['experiment_dir']}",
                                      "test.quantized=true", f"test.calib_images={QAT_CALIB}",
                                      "test.calib_static_caps=true"]
        fa.reset_launch_counts()
        with CallRecorder(fa, InferenceEngine, "__call__", keep=True) as calls:
            out, lines = run_cli(cli_test.main, test_overrides + ["--device", DEVICE])
        torch.cuda.synchronize()
        (_, summary), = out.items()
        args = SHIPPED[QAT_CLI_MODEL][1]
        per_layer = quant_layer_counts("merged", True)
        per_layer[fa.attn_scores_pv_key(args["hidden_dim"] // args["num_heads"])] = \
            per_layer.pop("attn_scores_pv")
        per_forward = {k: v * n_layers for k, v in per_layer.items()}
        want_line = (f"eval path: fused InferenceEngine (int8 w8a8) [calibrated on {QAT_CALIB}, "
                     "static caps]")
        bad = [c["launches"] for c in calls.calls if c["launches"] != per_forward]
        if want_line not in lines or bad or not calls.calls:
            raise AssertionError(f"cli qat test: {lines[:4]}, launches {bad[:1]}, "
                                 f"want {per_forward}")
        for c in calls.calls:
            for k, v in c["launches"].items():
                cli_test_counts[k] = cli_test_counts.get(k, 0) + v
        cfg = load_config(os.path.join(root, "configs"), "test_config", test_overrides)
        val = instantiate(cfg.dataset).val_dataset
        n_batches = -(-len(val) // cfg.test.test_batch_size)
        (acc,) = summary["results_per_budget"][None].values()

        def twin(c):
            e = c["obj"]
            return ti.vit_forward_quant_plain(e.params, c["args"][0], caps=e.caps,
                                              **dict(e._forward, compute_dtype=bf16))

        check = sweep_check(torch, "cli qat int8 sweep", calls.calls[1:1 + n_batches],
                            val.labels, acc, twin, tol=TOL_INT8)
        emit({"phase": "qat_cli_test", "overrides": test_overrides,
              "forwards": len(calls.calls), "launches_per_forward": sum(per_forward.values()),
              "per_forward": per_forward, "sweep": check,
              "wall_images_per_s": summary["timings_wall"],
              "device_images_per_s": summary["timings_device"],
              "printed": [ln for ln in lines if ln.startswith(("eval path", "budget="))],
              "tolerance_rel": TOL_INT8, "card": smi})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "qat_elapsed", "seconds": time.perf_counter() - t_start,
          "serve_counts": serve_counts, "cli_test_counts": cli_test_counts, "card": smi})
    return {"serve_counts": serve_counts, "cli_test_counts": cli_test_counts}


# ----------------------------------------------------------------- 48. serving

SERVE_BUCKETS = (1, 8, 64, 256)  # the (a) bundle's batch geometries
SERVE_CLIENTS = (1, 8, 64, 256)  # closed-loop client threads of the MicroBatcher runs
HTTP_CLIENTS = (1, 8, 64)        # urllib clients of the HTTP runs
SERVE_SECONDS = 3.0              # each closed-loop run
SERVE_POOL = 512                 # distinct images the clients draw from
SERVE_DELAY_MS = 5.0             # serving_host's default max_delay_ms
SERVE_PIPELINE_CLIENTS = 64      # where pipeline_fetches 4 and 0 are compared
SERVE_FAMILY_LAYERS = 4          # (b): depth of the ViT-B/16-width families
SERVE_FAMILY_RANKED = [1, 2, 3]  # (b): RankViT-B/16's ranked layers at that depth
SERVE_FAMILY_BATCH = 8           # (b): the bucket, and the padded call's rows
SERVE_FAMILY_PADDED = 5
SERVE_CLI_BUCKETS = (1, 8)
SERVE_CLI_PIXELS = 160           # configs/dataset/synthetic.yaml
SERVE_CLI_BENCH = 20
SERVE_WORKSPACE = os.path.join("workspace", "chip_smoke_serving")


def serve_depth(args: dict, layers: int = SERVE_FAMILY_LAYERS) -> dict:
    """``args`` at ``layers`` layers (the residual and ranked schedules cut
    with it)."""
    out = dict(args, num_layers=layers)
    if "residual_layers" in out:
        out["residual_layers"] = ["attention+mlp"] * layers
    if "rankvit_layers" in out:
        out["rankvit_layers"] = SERVE_FAMILY_RANKED
    return out


def closed_loop(submit, clients: int, seconds: float, pool: int) -> tuple:
    """``clients`` threads, each sending one image at a time through
    ``submit(index)`` for ``seconds``, client c drawing pool indices c,
    c + clients, ...: ([(index, reply, latency s)], elapsed s). A client's
    failure raises."""
    import threading

    stop = time.perf_counter() + seconds
    results = [[] for _ in range(clients)]
    errors = []

    def run(c):
        i = c
        try:
            while time.perf_counter() < stop:
                idx = i % pool
                t0 = time.perf_counter()
                out = submit(idx)
                results[c].append((idx, out, time.perf_counter() - t0))
                i += clients
        except Exception as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return [r for rs in results for r in rs], elapsed


def latency_summary(replies: list, elapsed: float) -> dict:
    lat = sorted(r[2] for r in replies)
    return {"replies": len(lat), "seconds": elapsed, "images_per_s": len(lat) / elapsed,
            "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3}


def serving_phases(torch, fa, dev, smi) -> dict:
    """Phase 48, serving bundles and the micro-batching host on the card
    (peekvit_torch/serving.py, serving_host.py), under workspace/
    chip_smoke_serving (removed at the end):

    (a) ViT-B/16 @224 bf16 (seeded), saved as a bucketed bundle at
        SERVE_BUCKETS: the bytes of all leaves and of the live ones, the
        seconds to save, from load_serving_bundle to the first served
        batch (files warm in the page cache) beside building the engine
        from the model; at each bucket the bundle's launches (counted;
        the live engine's 84, key by key) and its logits bit-identical to
        the live engine's on the same input (where the engine's own rerun
        is not bit-identical, a kernel is nondeterministic: then 3e-2 of
        max|logit|); a padded call (5 rows) bit-identical to the engine on
        the zero-padded batch and within 3e-2 of max|logit| of the plain
        twin; the bundle alone timed at each bucket;
    (b) every other family's bundle at its shipped widths (the
        ViT-B/16-width ones at SERVE_FAMILY_LAYERS layers) against its
        live engine, bit-identical, exact and padded: ResidualViT-B/16
        (traced, budgets 0.5 and 1.0), the same with add_budget_token=True
        (batch-coupled: exact buckets serve, a padded batch is refused),
        compact-auto at 0.5; RankViT-B/16 exact at 0.5 (static) and padded
        at max_budget=0.75; int8 ViT-B/16; moevit.yaml @160 dense, routed
        and int8; A-ViT-S/16; PCT and RankPCT at ModelNet40 width;
        the EncDec and MAE with recon_outputs=True; the EE ResidualViT
        (eeresidualvit.yaml) with its exit tuple;
    (c) MicroBatcher over (a)'s bundle: closed-loop client threads
        (SERVE_CLIENTS) sending single images for SERVE_SECONDS each:
        images/s, p50 / p99 latency, mean items a batch, the padded share,
        the stats breakdown a batch, pipeline_fetches 4 against 0 at 64
        clients, beside the bundle alone at each bucket; every reply
        within 3e-2 of max|logit| of its own image's plain twin, top-1
        equal on decided images (distinct images: a reply routed to the
        wrong caller fails);
    (d) build_server on port 0 with HTTP_CLIENTS urllib clients posting
        .npy single images: requests/s, p50 / p99, the same reply check;
    (e) cli.test on vit_tiny (synthetic.yaml at 160 px) with
        test.export_bundle and test.export_buckets=[1,8], then
        ``python -m peekvit_torch.serving`` on the bundle with --bench 20,
        its outputs against the sweep engine's on the same images.

    Any failure raises. Returns the bundles' launch counts (the
    ``serving`` path)."""
    import io
    import threading
    import urllib.request

    import numpy as np

    from peekvit_torch import InferenceEngine
    from peekvit_torch import inference as ti
    from peekvit_torch import serving as sv
    from peekvit_torch.cli import test as cli_test
    from peekvit_torch.serving_host import MicroBatcher, build_server
    from peekvit_torch.utils.checkpoint import save_state

    bf16 = torch.bfloat16
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, SERVE_WORKSPACE)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gen = torch.Generator(device=dev).manual_seed(48)
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    def served(fn):
        """fn() on a bundle: its output and launches, added to the path's."""
        out, c = counted(torch, fa, fn)
        add(c)
        return out, c

    def images(n, size=B16["image_size"]):
        return torch.randn(n, size, size, 3, generator=gen, device=dev)

    def leaves(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def held(label, got, want, rerun) -> dict:
        """The bundle's outputs bit-identical to the live engine's; where
        the engine's own rerun is not (a nondeterministic kernel), within
        TOL_BF16 of max|output| instead."""
        g, w = leaves(got), leaves(want)
        if len(g) != len(w) or any(a.shape != b.shape for a, b in zip(g, w)):
            raise AssertionError(f"{label}: outputs {[a.shape for a in g]}, "
                                 f"want {[b.shape for b in w]}")
        delta = max((a.float() - b.float()).abs().max().item() for a, b in zip(g, w))
        if delta == 0.0 and all(torch.equal(a, b) for a, b in zip(g, w)):
            return {"bit_identical": True}
        if all(torch.equal(a, b) for a, b in zip(leaves(rerun()), w)):
            raise AssertionError(f"{label}: the bundle differs from its deterministic engine "
                                 f"by {delta}")
        spread = max(b.float().abs().max().item() for b in w)
        if not delta <= TOL_BF16 * spread:
            raise AssertionError(f"{label}: {delta} over {TOL_BF16} of {spread}")
        return {"bit_identical": False, "engine_rerun_bit_identical": False,
                "max_abs_delta": delta, "tolerance_rel": TOL_BF16}

    def vit_twin(engine, x):
        kw = {k: v for k, v in engine._forward.items() if k != "compute_dtype"}
        return ti.vit_forward_plain(engine.params, x, compute_dtype=bf16, **kw)

    try:
        # (a) the main path: ViT-B/16 @224 bf16, bucketed
        model = seeded_residual_model(torch, "vit", B16)
        sample = images(8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = InferenceEngine(model, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with torch.inference_mode():
            engine(sample[:1])
        torch.cuda.synchronize()
        build_first_s = time.perf_counter() - t0
        path = os.path.join(work, "vit_b16")
        t0 = time.perf_counter()
        sv.save_bucketed_bundle(engine, path, sample, SERVE_BUCKETS)
        save_s = time.perf_counter() - t0
        flat = sv._flatten(engine.params)
        live = set(np.load(os.path.join(path, "params.npz")).files)
        x1 = images(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = sv.load_serving_bundle(path, device=DEVICE)
        served(lambda: srv(x1))
        load_first_s = time.perf_counter() - t0
        want_counts = engine_per_forward(fa, VIT_ENGINE_PER_LAYER,
                                         B16["hidden_dim"] // B16["num_heads"], B16["num_layers"])
        buckets, alone = {}, {}
        with torch.inference_mode():
            for n in SERVE_BUCKETS:
                x = images(n)
                got, c = served(lambda: srv(x))
                want, wc = counted(torch, fa, lambda: engine(x))
                if c != want_counts or wc != want_counts:
                    raise AssertionError(f"vit_b16 bundle b{n}: launches {c}, engine {wc}, "
                                         f"want {want_counts}")
                rec = held(f"vit_b16 bundle b{n}", got, want, lambda: engine(x))
                ms = cuda_ms(torch, lambda: srv(x), iters=10)
                engine_ms = cuda_ms(torch, lambda: engine(x), iters=10)
                alone[n] = n / ms * 1e3
                buckets[n] = dict(rec, launches=sum(c.values()), ms=ms, images_per_s=alone[n],
                                  engine_ms=engine_ms)
            x5 = images(SERVE_FAMILY_PADDED)
            got, _ = served(lambda: srv(x5))
            padded = torch.cat([x5, x5.new_zeros((3,) + tuple(x5.shape[1:]))])
            rec_pad = held("vit_b16 bundle padded 5 -> 8", got, engine(padded)[:5],
                           lambda: engine(padded)[:5])
            ref = vit_twin(engine, x5)
            rec_pad.update(compare_logits(torch, "vit_b16 bundle padded", got, [
                ("plain_bf16", ref, 0.0, TOL_BF16 * ref.abs().max().item())]))
        emit({"phase": "serving_bundle", "model": "vit_b_16", "buckets": list(SERVE_BUCKETS),
              "all_leaves_bytes": sum(t.numel() * t.element_size() for t in flat.values()),
              "live_leaves_bytes": sum(flat[k].numel() * flat[k].element_size() for k in live),
              "params_npz_bytes": os.path.getsize(os.path.join(path, "params.npz")),
              "leaves": len(flat), "live_leaves": len(live), "save_s": save_s,
              "load_to_first_batch_s": load_first_s, "engine_build_s": build_s,
              "engine_build_to_first_batch_s": build_first_s, "page_cache": "warm",
              "launches_per_forward": sum(want_counts.values()), "per_bucket": buckets,
              "padded_5": rec_pad, "card": smi})

        # (c) the MicroBatcher over (a)'s bundle, closed-loop clients
        pool = images(SERVE_POOL)
        with torch.inference_mode():
            twin = torch.cat([vit_twin(engine, pool[i:i + 64]) for i in range(0, SERVE_POOL, 64)])
        pool_host = pool.cpu().numpy()
        distinct = len(set(twin.argmax(-1).tolist()))

        def reply_check(label, replies):
            idx = torch.tensor([r[0] for r in replies], device=dev)
            got = torch.from_numpy(np.concatenate([r[1] for r in replies])).to(dev)
            ref = twin[idx]
            return compare_logits(torch, label, got, [
                ("plain_bf16", ref, 0.0, TOL_BF16 * ref.abs().max().item())])

        def batcher_run(clients, fetches):
            mb = MicroBatcher(srv, max_delay_ms=SERVE_DELAY_MS, pipeline_fetches=fetches)
            try:
                fa.reset_launch_counts()
                mb.predict(pool_host[0], timeout=120)  # warm-up
                replies, elapsed = closed_loop(
                    lambda i: mb.submit(pool_host[i]).result(120), clients, SERVE_SECONDS,
                    SERVE_POOL)
            finally:
                mb.close()
            torch.cuda.synchronize()
            add(fa.LAUNCHES)
            st = dict(mb.stats)
            nb = max(st["batches"], 1)
            rec = dict(latency_summary(replies, elapsed), clients=clients,
                       pipeline_fetches=fetches, max_delay_ms=SERVE_DELAY_MS,
                       mean_items_per_batch=st["items"] / nb,
                       padded_share=st["padded_rows"] / max(st["items"] + st["padded_rows"], 1),
                       per_batch_ms={k: st[k] / nb for k in ("t_concat_ms", "t_dispatch_ms",
                                                             "t_fetch_ms", "t_deliver_ms")},
                       stats=st, bundle_alone_images_per_s=alone,
                       check=reply_check(f"microbatcher C={clients} fetches={fetches}",
                                         replies))
            if st["errors"] or st["shed"] or st["rejected"]:
                raise AssertionError(f"microbatcher C={clients}: {st}")
            return rec

        runs = [batcher_run(c, 4) for c in SERVE_CLIENTS]
        runs.append(batcher_run(SERVE_PIPELINE_CLIENTS, 0))
        for rec in runs:
            emit({"phase": "serving_microbatcher", "model": "vit_b_16",
                  "distinct_top1_in_pool": distinct, **rec, "card": smi})

        # (d) HTTP: build_server on port 0, urllib clients
        bodies = []
        for i in range(SERVE_POOL):
            buf = io.BytesIO()
            np.save(buf, pool_host[i])
            bodies.append(buf.getvalue())
        for clients in HTTP_CLIENTS:
            mb = MicroBatcher(srv, max_delay_ms=SERVE_DELAY_MS)
            httpd = build_server(mb, port=0)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{httpd.server_port}/predict"

            def post(i):
                req = urllib.request.Request(url, data=bodies[i], method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    return np.load(io.BytesIO(resp.read()))

            try:
                fa.reset_launch_counts()
                post(0)  # warm-up
                replies, elapsed = closed_loop(post, clients, SERVE_SECONDS, SERVE_POOL)
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join()
                mb.close()
            torch.cuda.synchronize()
            add(fa.LAUNCHES)
            st = dict(mb.stats)
            emit({"phase": "serving_http", "model": "vit_b_16", "clients": clients,
                  **latency_summary(replies, elapsed),
                  "mean_items_per_batch": st["items"] / max(st["batches"], 1), "stats": st,
                  "bundle_alone_images_per_s": alone,
                  "check": reply_check(f"http C={clients}", replies), "card": smi})
        del engine, srv, model, pool, twin
        torch.cuda.empty_cache()

        # (b) every other family's bundle against its live engine
        def family(label, engine, x, save_budget=None, budgets=(None,), coupled=False,
                   compact=False):
            path = os.path.join(work, label)
            t0 = time.perf_counter()
            sv.save_bucketed_bundle(engine, path, x, (SERVE_FAMILY_BATCH,), budget=save_budget)
            save_s = time.perf_counter() - t0
            bundle = sv.load_serving_bundle(path, device=DEVICE)
            recs = {}
            xp = x[:SERVE_FAMILY_PADDED]
            zeros = xp.new_zeros((SERVE_FAMILY_BATCH - SERVE_FAMILY_PADDED,) + tuple(x.shape[1:]))
            with torch.inference_mode():
                for b in budgets:
                    kw = {} if b is None else {"budget": b}
                    got, c = served(lambda: bundle(x, **kw))
                    want, wc = counted(torch, fa, lambda: engine(x, **kw))
                    if c != wc:
                        raise AssertionError(f"{label} bundle: launches {c}, engine {wc}")
                    recs[f"{b}/exact"] = dict(held(f"{label} {b}", got, want,
                                                   lambda: engine(x, **kw)),
                                              launches=sum(c.values()))
                    if coupled:
                        try:
                            bundle(xp, **kw)
                        except ValueError as e:
                            recs[f"{b}/padded"] = {"refused": str(e)[:80]}
                            continue
                        raise AssertionError(f"{label}: a padded coupled batch was served")
                    got, _ = served(lambda: bundle(xp, **kw))
                    xz = torch.cat([xp, zeros])
                    recs[f"{b}/padded"] = held(
                        f"{label} {b} padded", got,
                        tuple(v[:SERVE_FAMILY_PADDED] for v in leaves(engine(xz, **kw))),
                        lambda: tuple(v[:SERVE_FAMILY_PADDED] for v in leaves(engine(xz, **kw))))
                if compact:  # a lower budget runs with the export budget's capacities
                    fwd, fkw, _ = engine._resolve(save_budget)
                    got, _ = served(lambda: bundle(x, budget=save_budget / 2))
                    recs["compact_lower_budget"] = held(
                        f"{label} budget {save_budget / 2}", got,
                        fwd(engine.params, x, save_budget / 2, **fkw),
                        lambda: fwd(engine.params, x, save_budget / 2, **fkw))
            meta = bundle.meta
            with open(os.path.join(path, f"b{SERVE_FAMILY_BATCH}", "meta.json")) as f:
                sub_meta = json.load(f)
            emit({"phase": "serving_family", "family": label, "budget_mode": meta["budget_mode"],
                  "batch_coupled": bool(meta.get("batch_coupled")),
                  "forward": sub_meta["forward"], "save_s": save_s,
                  "params_npz_bytes": os.path.getsize(os.path.join(path, "params.npz")),
                  "checks": recs, "card": smi})
            shutil.rmtree(path)
            torch.cuda.empty_cache()

        b16 = serve_depth(B16)
        res16 = serve_depth(RESIDUALVIT_B16)
        rank16 = serve_depth(RANKVIT_B16)
        x8 = images(SERVE_FAMILY_BATCH)
        res = seeded_residual_model(torch, "residualvit", res16)
        family("residualvit_b16", InferenceEngine(res, device=DEVICE), x8,
               budgets=(0.5, 1.0))
        family("residualvit_b16_compact_auto", InferenceEngine(res, device=DEVICE, compact=True),
               x8, save_budget=0.5, budgets=(0.5,), compact=True)
        del res
        coupled = seeded_residual_model(torch, "residualvit",
                                        dict(res16, add_budget_token=True))
        family("residualvit_b16_coupled", InferenceEngine(coupled, device=DEVICE), x8,
               budgets=(0.5, 1.0), coupled=True)
        del coupled
        rank = seeded_residual_model(torch, "rankvit", rank16)
        family("rankvit_b16_exact", InferenceEngine(rank, device=DEVICE), x8, save_budget=0.5,
               budgets=(0.5,))
        family("rankvit_b16_padded", InferenceEngine(rank, device=DEVICE, max_budget=0.75), x8,
               budgets=(0.75, 0.5, 0.25))
        del rank
        vit = seeded_residual_model(torch, "vit", b16)
        family("vit_b16_int8", InferenceEngine(vit, device=DEVICE, quantized=True), x8)
        del vit
        moe = seeded_residual_model(torch, "moevit", MOE_YAML)
        xm = images(SERVE_FAMILY_BATCH, MOE_YAML["image_size"])
        for name in ("dense", "routed_2", "int8"):
            family(f"moevit_{name}", InferenceEngine(moe, device=DEVICE, **MOE_ENGINES[name]),
                   xm)
        del moe
        avit = seeded_residual_model(torch, "adavit", dict(AVIT_S16, gate_scale=5.0,
                                                            gate_center=0.0))
        family("adavit_s16", InferenceEngine(avit, device=DEVICE), x8)
        del avit
        clouds = surface_clouds(torch, gen, SERVE_FAMILY_BATCH, PCT_M40["num_points"], dev)
        for name in ("pct", "rankpct"):
            pct = seeded_pct_model(torch, name)
            family(name, InferenceEngine(pct, device=DEVICE), clouds,
                   save_budget=0.5 if name == "rankpct" else None,
                   budgets=(0.5,) if name == "rankpct" else (None,))
            del pct
        xr = images(SERVE_FAMILY_BATCH, RECON_MODELS["maevit"]["image_size"])
        for name, budgets in (("encdecresidualvit", (0.5, 1.0)), ("maevit", (None,))):
            recon = seeded_residual_model(torch, name, RECON_MODELS[name])
            family(f"{name}_recon", InferenceEngine(recon, device=DEVICE, recon_outputs=True),
                   xr, budgets=budgets)
            del recon
        ee = seeded_residual_model(torch, "eeresidualvit", EE_YAML)
        family("eeresidualvit", InferenceEngine(ee, device=DEVICE, ee_outputs=True),
               images(SERVE_FAMILY_BATCH, EE_YAML["image_size"]), budgets=(0.5, 1.0))
        del ee
        torch.cuda.empty_cache()

        # (e) the CLIs: cli.test's bundle export, then the serving CLI
        tiny = seeded_residual_model(torch, "vit", dict(SHIPPED["vit_tiny"][1],
                                                           image_size=SERVE_CLI_PIXELS))
        ckpt = save_state(os.path.join(work, "vit_tiny_ckpt"), tiny)
        del tiny
        bdir = os.path.join(work, "vit_tiny_bundle")
        overrides = [f"workspace={work}", "dataset=synthetic", "experiment_name=serve_eval",
                     f"load_from={ckpt}", f"test.export_bundle={bdir}",
                     "test.export_buckets=[" + ",".join(map(str, SERVE_CLI_BUCKETS)) + "]"]
        with CallRecorder(fa, InferenceEngine, "__call__", keep=True) as calls:
            _, lines = run_cli(cli_test.main, overrides + ["--device", DEVICE])
        if f"exported serving bundle: {bdir}" not in lines:
            raise AssertionError(f"cli.test export: {lines[-4:]}")
        sweep_engine = calls.calls[0]["obj"]
        x = calls.calls[1]["args"][0][:SERVE_CLI_BUCKETS[-1]]
        inp, out = os.path.join(work, "input.npy"), os.path.join(work, "out.npy")
        np.save(inp, x.float().cpu().numpy())
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "peekvit_torch.serving", bdir, inp,
                               "--bench", str(SERVE_CLI_BENCH), "--out", out,
                               "--device", DEVICE], cwd=root,
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"serving CLI: rc {proc.returncode}: {proc.stderr[-2000:]}")
        info = json.loads(proc.stdout.strip().splitlines()[-1])
        with torch.inference_mode():
            want = sweep_engine(x)
        got = torch.from_numpy(np.load(out)).to(dev)
        rec = compare_logits(torch, "serving CLI", got, [
            ("sweep_engine", want, 0.0, TOL_BF16 * want.abs().max().item())])
        emit({"phase": "serving_cli", "overrides": overrides,
              "printed": [ln for ln in lines if ln.startswith(("eval path", "exported"))],
              "bundle_buckets": sorted(os.listdir(bdir)), "serving_cli": info,
              "serving_cli_process_s": cli_s, "bit_identical": bool(torch.equal(got, want)),
              "check": rec, "card": smi})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    missing = [k for k in want_counts if not counts.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    emit({"phase": "serving_elapsed", "seconds": time.perf_counter() - t_start,
          "counts": counts, "card": smi})
    return {"counts": counts}



# --------------------------- 49. training with dropout, data parallelism

DROPOUT_RATE = 0.1
DROPOUT_BATCH = 64
DROPOUT_STEPS = 5
DROPOUT_FAMILY_BATCH = 32
DROPOUT_FAMILIES = {  # phase 44's configs, one step each at both rates
    "avit": ("adavit", AVIT_S16), "moevit": ("moevit", MOE_YAML),
    "maevit": ("maevit", RECON_MODELS["maevit"])}
DP_RANKS = 2                        # data-parallel ranks sharing cuda:0
DP_SERVE_BATCH = 256                # the global batch every rank receives
DP_SERVE_ITERS = 3
DP_TRAIN_BATCH = 64
DP_TRAIN_STEPS = 3
DP_TRAIN_LR = 1e-2                  # SGD(momentum 0.9): the update is linear in the gradients
DP_JOIN_TIMEOUT = 600.0             # seconds for every rank of the spawn
DP_LABEL = "gloo through the host, 2 processes sharing one card: not NCCL"
# key -> (registry name, args, engine keywords, budgets); the ResidualViT
# with a constant budget token, whose whole-batch mean spans the data column
DP_SERVE_RUNS = {
    "vit": ("vit", B16, {}, (None,)),
    "residualvit": ("residualvit", dict(RESIDUALVIT_B16, add_budget_token=0.5), {}, (0.4, 0.9)),
    "vit_int8": ("vit", B16, dict(quantized=True), (None,)),
}
# key -> (registry name, args, Trainer keywords): the fused paths ("auto"
# on the card), ZeRO-1 on the fused ViT step
DP_TRAIN_RUNS = {
    "fused_vit": ("vit", B16, {}),
    "fused_residual": ("residualvit", RESIDUALVIT_B16, dict(loss_compose=CROSSENTROPY_MSE)),
    "zero": ("vit", B16, dict(zero_sharded_optimizer=True)),
}


def dropout_phases(torch, fa, dev, smi) -> dict:
    """Phase 49a, training with dropout on the module path (JAX's linen
    step at a nonzero rate): a ViT-B/16 Trainer(AdamW, clip 1.0) at
    dropout = attention_dropout = DROPOUT_RATE takes DROPOUT_STEPS steps on
    one bs64 batch (ms per step by CUDA events, peak memory; losses finite
    and falling; no port kernel launched), then one more step with every
    mask recorded: each site's keep share within 5 sigma of 1 - rate, and
    the time to draw all of one step's masks alone (the RNG work a
    data-parallel rank repeats for the global batch); then the same model
    at rate 0 takes the same steps on the module path too (ms, peak
    memory: the fused path has no dropout). A-ViT-S/16, MoE and
    MAE (phase 44's configs) take one step each at both rates."""
    from peekvit_torch import Trainer
    from peekvit_torch.ops import dropout as drop
    from peekvit_torch.training.optim import AdamW

    gen = torch.Generator(device=dev).manual_seed(49)
    size = B16["image_size"]
    x = torch.randn(DROPOUT_BATCH, size, size, 3, generator=gen, device=dev)
    y = torch.randint(0, B16["num_classes"], (DROPOUT_BATCH,), generator=gen, device=dev)
    runs = {}
    for rate in (DROPOUT_RATE, 0.0):
        model = seeded_residual_model(torch, "vit", dict(B16, dropout=rate,
                                                         attention_dropout=rate))
        trainer = Trainer(model, AdamW(lr=TRAIN_LR), clip_grad_norm=1.0, fused=False,
                          device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        step_ms, losses = [], []
        for i in range(DROPOUT_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            m = trainer.train_step(x, y, step_idx=i)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(m["total_loss"]))
        rec = {"phase": "dropout_train", "model": "vit_b_16", "rate": rate,
               "batch": DROPOUT_BATCH, "train_kind": trainer._train_kind, "losses": losses,
               "ms_per_step": step_ms, "launches": dict(fa.LAUNCHES),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if rate:
            sites, orig = [], drop.keep_mask

            def recording(shape, keep_prob, generator, device, orig=orig, sites=sites):
                mask = orig(shape, keep_prob, generator, device)
                sites.append((tuple(shape), keep_prob, mask.float().mean()))
                return mask

            drop.keep_mask = recording
            try:
                trainer.train_step(x, y, step_idx=DROPOUT_STEPS)
            finally:
                drop.keep_mask = orig
            shares = []
            for shape, p, share in sites:
                n = math.prod(shape)
                share = float(share)
                shares.append({"shape": list(shape), "keep_share": share,
                               "sigmas": abs(share - p) / math.sqrt(p * (1 - p) / n)})
            draw_gen = torch.Generator(device=dev).manual_seed(0)
            draw_ms = cuda_ms(torch, lambda: [drop.keep_mask(s, p, draw_gen, dev)
                                              for s, p, _ in sites], iters=5)
            rec.update(sites=len(shares), keep_shares=shares, mask_draw_ms=draw_ms,
                       mask_draw_share_of_step=draw_ms / min(step_ms))
            if any(s["sigmas"] > 5 for s in shares) or len(shares) != 1 + 2 * B16["num_layers"]:
                raise AssertionError(f"dropout keep shares {shares}")
        runs[rate] = rec
        emit(dict(rec, card=smi))
        if (trainer._train_kind != "module" or rec["launches"]
                or not all(math.isfinite(v) for v in losses)
                or (rate and not losses[-1] < losses[0])):
            raise AssertionError(f"dropout {rate}: {trainer._train_kind}, losses {losses}, "
                                 f"launches {rec['launches']}")
        del trainer, model
        torch.cuda.empty_cache()
    emit({"phase": "dropout_cost", "model": "vit_b_16", "batch": DROPOUT_BATCH,
          "ms_per_step_ratio": min(runs[DROPOUT_RATE]["ms_per_step"])
          / min(runs[0.0]["ms_per_step"]),
          "peak_memory_ratio": runs[DROPOUT_RATE]["peak_memory_gib"]
          / runs[0.0]["peak_memory_gib"], "card": smi})
    for key, (name, args) in DROPOUT_FAMILIES.items():
        model = seeded_residual_model(torch, name, dict(args, dropout=DROPOUT_RATE,
                                                        attention_dropout=DROPOUT_RATE))
        trainer = Trainer(model, AdamW(lr=1e-4), clip_grad_norm=1.0, device=DEVICE)
        s = args["image_size"]
        xf = torch.randn(DROPOUT_FAMILY_BATCH, s, s, 3, generator=gen, device=dev)
        yf = torch.randint(0, args["num_classes"], (DROPOUT_FAMILY_BATCH,), generator=gen,
                           device=dev)
        sites, orig = [], drop.keep_mask
        drop.keep_mask = lambda *a, orig=orig, sites=sites: sites.append(a[0]) or orig(*a)
        try:
            t0 = time.perf_counter()
            m = trainer.train_step(xf, yf, step_idx=0)
            loss = float(m["total_loss"])
            seconds = time.perf_counter() - t0
        finally:
            drop.keep_mask = orig
        emit({"phase": "dropout_family_step", "model": key, "batch": DROPOUT_FAMILY_BATCH,
              "rate": DROPOUT_RATE, "train_kind": trainer._train_kind, "loss": loss,
              "masks_drawn": len(sites), "seconds_with_first_call": seconds, "card": smi})
        if trainer._train_kind != "module" or not math.isfinite(loss) or not sites:
            raise AssertionError(f"dropout {key}: {trainer._train_kind}, loss {loss}, "
                                 f"{len(sites)} masks")
        del trainer, model
        torch.cuda.empty_cache()
    return runs


def dp_images(torch, b: int, size: int, classes: int, seed: int):
    """A global batch seeded on the CPU, so every rank draws the same."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(b, size, size, 3, generator=gen).to(DEVICE),
            torch.randint(0, classes, (b,), generator=gen).to(DEVICE))


def param_digest(torch, params) -> str:
    import hashlib

    from peekvit_torch.models.adapters import tree_leaves

    digest = hashlib.sha256()
    for _, p in tree_leaves(params):
        digest.update(p.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def tensor_digest(torch, t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def dp_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """Phase 49b, one rank of a (world, 1) data mesh on cuda:0 over gloo.
    Serving: each run of DP_SERVE_RUNS through InferenceEngine(mesh=) on the
    global bs256 batch (a warm-up, then DP_SERVE_ITERS forwards timed on
    the host clock after a barrier; the launch counts zeroed just before
    the last and read just after); rank 0 also serves it on one device and
    holds the dp logits against it. Training: each run of DP_TRAIN_RUNS,
    a Trainer(SGD(momentum 0.9), clip 1.0, mesh=) from the seeded weights
    (an update linear in the gradients, so that their sums are compared;
    ZeRO-1 shards the momentum) takes
    DP_TRAIN_STEPS steps on the global bs64 batch (counts zeroed just
    before each step, read just after; ms on the host clock between a
    barrier and a synchronize); rank 0 then takes the same steps on one
    device (the single-device step of the same seed, while rank 1 waits)
    and holds losses and parameter updates against the dp run's. Writes
    rank<r>.pt into out_dir."""
    import torch
    import torch.distributed as dist

    from peekvit_torch import InferenceEngine, Trainer
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.parallel import make_mesh
    from peekvit_torch.training.optim import SGD
    from peekvit_torch.utils.losses import LossCompose

    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(world, 1, device=DEVICE)  # cuda:0 for every rank on one card
        res = {"device": str(mesh.device), "serve": {}, "train": {}}
        x, _ = dp_images(torch, DP_SERVE_BATCH, B16["image_size"], B16["num_classes"], 49)
        for key, (name, args, kw, budgets) in DP_SERVE_RUNS.items():
            model = seeded_residual_model(torch, name, args)
            engine = InferenceEngine(model, device=DEVICE, mesh=mesh, **kw)
            single = InferenceEngine(model, device=DEVICE, **kw) if rank == 0 else None
            for budget in budgets:
                bkw = {} if budget is None else {"budget": budget}
                with torch.inference_mode():
                    engine(x, **bkw)
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    for _ in range(DP_SERVE_ITERS - 1):
                        engine(x, **bkw)
                    fa.reset_launch_counts()
                    out = engine(x, **bkw)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) / DP_SERVE_ITERS * 1e3
                    rec = {"counts": dict(fa.LAUNCHES), "ms": ms, "shape": list(out.shape),
                           "digest": tensor_digest(torch, out)}
                    if rank == 0:
                        single(x, **bkw)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(DP_SERVE_ITERS - 1):
                            single(x, **bkw)
                        fa.reset_launch_counts()
                        want = single(x, **bkw)
                        torch.cuda.synchronize()
                        rec.update(
                            single_ms=(time.perf_counter() - t0) / DP_SERVE_ITERS * 1e3,
                            single_counts=dict(fa.LAUNCHES),
                            bit_identical=bool(torch.equal(out, want)),
                            max_abs_diff=float((out - want).abs().max()),
                            max_abs_logit=float(want.abs().max()),
                            rows_differing=int((out != want).any(-1).sum()),
                            top1_agree=float((out.argmax(-1) == want.argmax(-1)).float().mean()))
                    res["serve"][f"{key}/{budget}"] = rec
                    dist.barrier()
            del engine, single, model
            torch.cuda.empty_cache()
        xt, yt = dp_images(torch, DP_TRAIN_BATCH, B16["image_size"], B16["num_classes"], 50)
        for key, (name, args, kw) in DP_TRAIN_RUNS.items():
            kw = dict(kw)
            if "loss_compose" in kw:
                kw["loss_compose"] = LossCompose(kw["loss_compose"])
            runs = {"dp": mesh} if rank else {"dp": mesh, "single": None}
            rec = {}
            for run, run_mesh in runs.items():
                model = seeded_residual_model(torch, name, args)
                start = ({k: p.detach().clone() for k, p in model.named_parameters()}
                         if rank == 0 else None)
                run_kw = kw if run == "dp" else {k: v for k, v in kw.items()
                                                 if k != "zero_sharded_optimizer"}
                trainer = Trainer(model, SGD(lr=DP_TRAIN_LR, momentum=0.9),
                                  clip_grad_norm=1.0, mesh=run_mesh, device=DEVICE, **run_kw)
                out = {"losses": [], "counts": [], "ms": []}
                for step in range(DP_TRAIN_STEPS):
                    torch.cuda.synchronize()
                    if run == "dp":
                        dist.barrier()
                    fa.reset_launch_counts()
                    t0 = time.perf_counter()
                    m = trainer.train_step(xt, yt, step_idx=step)
                    torch.cuda.synchronize()
                    out["ms"].append((time.perf_counter() - t0) * 1e3)
                    out["counts"].append(dict(fa.LAUNCHES))
                    out["losses"].append(float(m["total_loss"]))
                out["kind"] = trainer._train_kind
                out["digest"] = param_digest(torch, trainer.params)
                opt = trainer.torch_optimizer
                out["opt_bytes"] = (opt.state_bytes() if hasattr(opt, "state_bytes") else sum(
                    t.numel() * t.element_size() for st in opt.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor)))
                if start is not None:
                    out["update"] = {k: (p.detach() - start[k]).float()
                                     for k, p in model.named_parameters()}
                rec[run] = out
                del trainer, model
                torch.cuda.empty_cache()
            if rank == 0:
                got, want = rec["dp"].pop("update"), rec["single"].pop("update")
                rec["update_rel_l2"] = rel_l2(torch, got, want)
                # the whole update's (SGD: the gradients' sums); a leaf whose
                # gradient is 0 in exact arithmetic (the key bias's) is all noise
                num = sum(float((got[k] - want[k]).square().sum()) for k in want)
                rec["update_rel_l2_all"] = math.sqrt(
                    num / sum(float(want[k].square().sum()) for k in want))
            res["train"][key] = rec
            dist.barrier()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_phases(torch, smi) -> dict:
    """Phase 49b: data parallelism as DP_RANKS spawned ranks on cuda:0 over
    a gloo group (every library built before a rank starts, the ranks
    joined with a deadline, a rank's exception failing the run; dp_rank):
    every rank's logits, losses and final parameters bit-identical; each
    rank's launches a forward and a step those of the single-device
    forward and step (each rank runs the whole chain on its rows); the dp
    logits against the single-device engine's (bit-identical, or the
    largest difference within 3e-2 of max|logit| and top-1 on 99% of
    images), the dp steps' losses within 1e-2 and their whole parameter
    update within rel-L2 3e-2 of the single-device step's (the repo's bf16
    bars; the worst leaf reported); ZeRO-1's parameters bit-identical to the replicated dp step's
    and its optimizer bytes a rank. Returns the launches summed over every
    rank, forward and step, by path ("dp_serve", "dp_train")."""
    import shutil

    from peekvit_torch.ops.cuda import _build

    _build.build_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dp_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    spawn_ranks(torch, dp_rank, DP_RANKS, (DP_RANKS, os.path.join(out_dir, "rdzv"), out_dir),
                DP_JOIN_TIMEOUT)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(DP_RANKS)]
    totals = {"dp_serve": {}, "dp_train": {}}

    def add(path, counts):
        for k, v in counts.items():
            totals[path][k] = totals[path].get(k, 0) + v

    for key, rec0 in ranks[0]["serve"].items():
        recs = [rk["serve"][key] for rk in ranks]
        if any(r["digest"] != rec0["digest"] for r in recs):
            raise AssertionError(f"dp serve {key}: the ranks' logits differ")
        for r in recs:
            if r["counts"] != rec0["single_counts"]:
                raise AssertionError(f"dp serve {key}: a rank launched {r['counts']}, the "
                                     f"single-device forward {rec0['single_counts']}")
            add("dp_serve", r["counts"])
        ok = rec0["bit_identical"] or (
            rec0["max_abs_diff"] <= 3e-2 * rec0["max_abs_logit"] and rec0["top1_agree"] >= 0.99)
        emit({"phase": "dp_serve", "run": key, "ranks": DP_RANKS, "global_batch": DP_SERVE_BATCH,
              "launches_per_rank_per_forward": sum(rec0["counts"].values()),
              "ranks_bit_identical": True,
              **{k: rec0[k] for k in ("bit_identical", "max_abs_diff", "max_abs_logit",
                                      "rows_differing", "top1_agree", "single_ms")},
              "ms_per_forward_by_rank": [r["ms"] for r in recs], "label": DP_LABEL,
              "card": smi})
        if not ok:
            raise AssertionError(f"dp serve {key}: against the single device {rec0}")
    for key, rec0 in ranks[0]["train"].items():
        recs = [rk["train"][key] for rk in ranks]
        dp = [r["dp"] for r in recs]
        if any(d["digest"] != dp[0]["digest"] or d["losses"] != dp[0]["losses"] for d in dp):
            raise AssertionError(f"dp train {key}: the ranks' losses or parameters differ")
        single = rec0["single"]
        for d in dp:
            for i, counts in enumerate(d["counts"]):
                if counts != single["counts"][i]:
                    raise AssertionError(f"dp train {key} step {i}: a rank launched {counts}, "
                                         f"the single-device step {single['counts'][i]}")
                add("dp_train", counts)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(dp[0]["losses"], single["losses"]))
        err = rec0["update_rel_l2"]
        ok = (dp[0]["kind"] == single["kind"] and dp[0]["kind"].startswith("fused")
              and loss_rel <= 1e-2 and rec0["update_rel_l2_all"] <= 3e-2
              and all(math.isfinite(v) for v in dp[0]["losses"]))
        rec = {"phase": "dp_train", "run": key, "ranks": DP_RANKS,
               "global_batch": DP_TRAIN_BATCH, "train_kind": dp[0]["kind"],
               "losses": dp[0]["losses"], "single_losses": single["losses"],
               "loss_rel_max": loss_rel, "update_rel_l2": rec0["update_rel_l2_all"],
               "update_rel_l2_worst_leaf": [max(err, key=err.get), max(err.values())],
               "launches_per_rank_per_step": sum(dp[0]["counts"][0].values()),
               "ranks_bit_identical": True,
               "ms_per_step_by_rank": [d["ms"] for d in dp], "single_ms": single["ms"],
               "optimizer_bytes_per_rank": [d["opt_bytes"] for d in dp],
               "single_optimizer_bytes": single["opt_bytes"], "label": DP_LABEL, "card": smi}
        if key == "zero":
            rec["params_equal_replicated_dp"] = (
                dp[0]["digest"] == ranks[0]["train"]["fused_vit"]["dp"]["digest"])
            ok = ok and rec["params_equal_replicated_dp"]
        emit(rec)
        if not ok:
            raise AssertionError(f"dp train {key}: {rec}")
    emit({"phase": "dp_spawn", "ranks": DP_RANKS, "seconds_for_spawn": seconds, "card": smi})
    return totals


# --------------------------------------------------- 50. sharded training

SHARD_RANKS = 2                     # (a) FSDP and (b) tensor parallelism share one spawn
SHARD_SP_RANKS = 4                  # (c) ZeRO-1 under SP on a (2, 2) mesh
SHARD_STEPS = 3
SHARD_SP_STEPS = 2
SHARD_LR = 1e-2                     # SGD(momentum 0.9): the update is linear in the gradients
SHARD_JOIN_TIMEOUT = 600.0
SHARD_LABEL = ("gloo through the host, processes sharing one card: not NCCL; FSDP and TP take "
               "the fp32 module step (no port kernel), ZeRO-1 under SP the SP step")
# ViT-B/16 at full width and a third of its depth: phase 51 brought the
# whole script past 650 s of its 1200 s limit (746.5 s on one H100), and these
# worlds run paths that phase 51 and phase 49 drive at full depth
SHARD_B16 = dict(B16, num_layers=4)
# key -> (registry name, args, mesh (n_data, n_model), Trainer keywords, global batch, steps)
SHARD_RUNS = {
    "fsdp_vit": ("vit", SHARD_B16, (2, 1), dict(fused=False, fsdp_sharded_params=True), 64,
                 SHARD_STEPS),
    "tp_vit": ("vit", SHARD_B16, (1, 2), dict(fused=False, tensor_parallel=True), 64,
               SHARD_STEPS),
    "tp_moe": ("moevit", MOE_YAML, (1, 2), dict(fused=False, tensor_parallel=True), 64,
               SHARD_STEPS),
}
SHARD_SP_RUNS = {
    "zero_sp_vit": ("vit", SHARD_B16, (2, 2), dict(sequence_parallel_devices=2,
                                                   zero_sharded_optimizer=True), 16,
                    SHARD_SP_STEPS),
}
# (loss rel, whole update rel-L2, worst leaf's update rel-L2) against rank
# 0's single-device step: FSDP and TP against the same fp32 module step, at
# fp32 limits (every leaf checked, so a fault confined to small leaves, an
# LN gradient left partial or a misplaced bias slice, shows); ZeRO-1 under
# SP against the bf16 fused step, at phase 49's bars on the whole update
SHARD_TOLERANCES = {"fsdp_vit": (1e-4, 1e-3, 1e-3), "tp_vit": (1e-4, 1e-3, 1e-3),
                    "tp_moe": (1e-4, 1e-3, 1e-3), "zero_sp_vit": (1e-2, 3e-2, None)}
# the path name of each run's launches in the kernels line
SHARD_PATHS = {"fsdp_vit": "fsdp_train", "tp_vit": "tp_train", "tp_moe": "tp_train",
               "zero_sp_vit": "zero_sp_train"}
NATIVE_IMAGES = 64
NATIVE_PIXELS = (375, 500)          # an Imagenette-like JPEG, eval recipe 256 -> 224
NATIVE_WORKSPACE = os.path.join("workspace", "chip_smoke_native")


def shard_variants(rank: int, kw: dict) -> dict:
    """A run's Trainers: the sharded one on every rank; for ZeRO-1 under SP
    the same SP step without ZeRO on every rank; rank 0's single-device
    step (the module step of FSDP / TP, the fused step beside SP)."""
    out = {"sharded": (True, kw)}
    if kw.get("zero_sharded_optimizer"):
        out["unsharded"] = (True, {k: v for k, v in kw.items() if k != "zero_sharded_optimizer"})
    if rank == 0:
        single = {k: v for k, v in kw.items()
                  if k not in ("fsdp_sharded_params", "tensor_parallel", "zero_sharded_optimizer",
                               "sequence_parallel_devices")}
        out["single"] = (False, single)
    return out


def shard_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """Phase 50, one rank on cuda:0 over gloo: every run of SHARD_RUNS (a
    world of SHARD_RANKS) or SHARD_SP_RUNS (SHARD_SP_RANKS) on its mesh.
    Each Trainer (SGD(momentum 0.9), clip 1.0) from the seeded weights takes
    the run's steps on its global batch: counts zeroed just before each
    step, read just after; ms on the host clock between a barrier and a
    synchronize; peak memory since the Trainer was built; the parameter
    and optimizer bytes held between steps beside the whole model's; the
    whole parameters' digest (gathered). Rank 0 then takes the same steps
    on one device while the others wait, and holds the update against the
    sharded run's. Writes rank<r>.pt into out_dir."""
    import torch
    import torch.distributed as dist

    from peekvit_torch import Trainer
    from peekvit_torch.models.adapters import module_params
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.parallel import make_mesh
    from peekvit_torch.training.optim import SGD

    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)
    try:
        runs = SHARD_RUNS if world == SHARD_RANKS else SHARD_SP_RUNS
        meshes, res = {}, {}
        for key, (name, args, shape, kw, batch, steps) in runs.items():
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device=DEVICE)
            x, y = dp_images(torch, batch, args["image_size"], args["num_classes"], 50)
            rec = {}
            for variant, (sharded, vkw) in shard_variants(rank, kw).items():
                model = seeded_residual_model(torch, name, args)
                start = ({k: v.clone() for k, v in _flat(module_params(model)).items()}
                         if rank == 0 else None)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                trainer = Trainer(model, SGD(lr=SHARD_LR, momentum=0.9), clip_grad_norm=1.0,
                                  mesh=meshes[shape] if sharded else None, device=DEVICE, **vkw)
                out = {"losses": [], "counts": [], "ms": []}
                for step in range(steps):
                    torch.cuda.synchronize()
                    if sharded:
                        dist.barrier()
                    fa.reset_launch_counts()
                    t0 = time.perf_counter()
                    m = trainer.train_step(x, y, step_idx=step)
                    torch.cuda.synchronize()
                    out["ms"].append((time.perf_counter() - t0) * 1e3)
                    out["counts"].append(dict(fa.LAUNCHES))
                    out["losses"].append(float(m["total_loss"]))
                out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
                out["kind"] = trainer._train_kind
                shards = trainer._shards
                out["param_bytes"] = (shards.held_bytes() if shards is not None else sum(
                    p.numel() * p.element_size() for p in model.parameters()))
                out["whole_param_bytes"] = (shards.whole_bytes() if shards is not None
                                            else out["param_bytes"])
                opt = trainer.torch_optimizer
                out["opt_bytes"] = (opt.state_bytes() if hasattr(opt, "state_bytes") else sum(
                    t.numel() * t.element_size() for st in opt.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor)))
                whole = _flat(trainer.gathered_params())  # a collective when sharded
                out["digest"] = param_digest(torch, {k: whole[k] for k in sorted(whole)})
                if start is not None:
                    out["update"] = {k: (whole[k] - start[k]).float() for k in start}
                rec[variant] = out
                del trainer, model, whole
                torch.cuda.empty_cache()
                if not sharded:
                    continue
                dist.barrier()
            if rank == 0:
                got, want = rec["sharded"].pop("update"), rec["single"].pop("update")
                num = sum(float((got[k] - want[k]).square().sum()) for k in want)
                rec["update_rel_l2_all"] = math.sqrt(
                    num / sum(float(want[k].square().sum()) for k in want))
                err = rel_l2(torch, got, want)
                rec["update_rel_l2_worst_leaf"] = [max(err, key=err.get), max(err.values())]
                rec.get("unsharded", {}).pop("update", None)
            res[key] = rec
            dist.barrier()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def shard_phases(torch, smi) -> dict:
    """Phase 50 (a)-(c): sharded training as spawned ranks on cuda:0 over a
    gloo group (shard_rank): FSDP on a (2, 1) mesh and tensor parallelism
    on (1, 2) (ViT-B/16, and moevit.yaml at 160 px with its experts split)
    in one spawn of 2 ranks; ZeRO-1 under SP on (2, 2) in a spawn of 4.
    Every rank's losses and whole parameters bit-identical within a run;
    each rank's launches a step those of the unsharded step (the module
    step launches no port kernel; SP's tail launches site 12's); losses
    and updates against rank 0's single-device step within
    SHARD_TOLERANCES (fp32 limits on every leaf for FSDP and TP, phase
    49's bf16 bars for ZeRO-1 under SP); ZeRO's parameters bit-identical
    to the SP step's without it; FSDP holding about half of the parameters
    and of the momentum, TP the split share. Returns the launches summed
    over every rank and step by path ("fsdp_train", "tp_train",
    "zero_sp_train")."""
    import shutil

    from peekvit_torch.ops.cuda import _build

    _build.build_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    totals = {path: {} for path in set(SHARD_PATHS.values())}
    for world in (SHARD_RANKS, SHARD_SP_RANKS):
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                               f"shard_smoke_{world}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        spawn_ranks(torch, shard_rank, world, (world, os.path.join(out_dir, "rdzv"), out_dir),
                    SHARD_JOIN_TIMEOUT)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]
        for key, rec0 in ranks[0].items():
            recs = [rk[key]["sharded"] for rk in ranks]
            if any(r["digest"] != recs[0]["digest"] or r["losses"] != recs[0]["losses"]
                   for r in recs):
                raise AssertionError(f"{key}: the ranks' losses or whole parameters differ")
            base = rec0.get("unsharded", rec0["single"])
            path = SHARD_PATHS[key]
            for r in recs:
                for i, counts in enumerate(r["counts"]):
                    if counts != base["counts"][i]:
                        raise AssertionError(f"{key} step {i}: a rank launched {counts}, the "
                                             f"unsharded step {base['counts'][i]}")
                    for k, v in counts.items():
                        totals[path][k] = totals[path].get(k, 0) + v
            single = rec0["single"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"],
                                                               single["losses"]))
            loss_tol, update_tol, leaf_tol = SHARD_TOLERANCES[key]
            ok = (loss_rel <= loss_tol and rec0["update_rel_l2_all"] <= update_tol
                  and (leaf_tol is None or rec0["update_rel_l2_worst_leaf"][1] <= leaf_tol)
                  and all(math.isfinite(v) for v in recs[0]["losses"]))
            out = {"phase": "shard_train", "run": key, "ranks": world,
                   "mesh": list(SHARD_RUNS.get(key, SHARD_SP_RUNS.get(key))[2]),
                   "global_batch": SHARD_RUNS.get(key, SHARD_SP_RUNS.get(key))[4],
                   "train_kind": recs[0]["kind"], "losses": recs[0]["losses"],
                   "single_losses": single["losses"], "single_kind": single["kind"],
                   "loss_rel_max": loss_rel, "update_rel_l2": rec0["update_rel_l2_all"],
                   "update_rel_l2_worst_leaf": rec0["update_rel_l2_worst_leaf"],
                   "tolerance": dict(zip(("loss_rel", "update_rel_l2", "worst_leaf"),
                                         SHARD_TOLERANCES[key])),
                   "launches_per_rank_per_step": sum(recs[0]["counts"][0].values()),
                   "ranks_bit_identical": True,
                   "ms_per_step_by_rank": [r["ms"] for r in recs], "single_ms": single["ms"],
                   "param_bytes_per_rank": [r["param_bytes"] for r in recs],
                   "single_param_bytes": single["param_bytes"],
                   "optimizer_bytes_per_rank": [r["opt_bytes"] for r in recs],
                   "single_optimizer_bytes": single["opt_bytes"],
                   "peak_memory_gib_by_rank": [r["peak_memory_gib"] for r in recs],
                   "single_peak_memory_gib": single["peak_memory_gib"],
                   "label": SHARD_LABEL, "card": smi}
            held = max(r["param_bytes"] for r in recs) / single["param_bytes"]
            opt = max(r["opt_bytes"] for r in recs) / max(single["opt_bytes"], 1)
            if key.startswith("fsdp"):
                ok = ok and held < 0.55 and opt < 0.55
            elif key.startswith("tp"):
                ok = ok and held < 0.9 and opt < 0.9
            else:
                unsharded = rec0["unsharded"]
                out["params_equal_sp_without_zero"] = (recs[0]["digest"]
                                                       == unsharded["digest"])
                out["unsharded_optimizer_bytes"] = unsharded["opt_bytes"]
                out["unsharded_ms"] = unsharded["ms"]
                ok = (ok and out["params_equal_sp_without_zero"]
                      and max(r["opt_bytes"] for r in recs) < 0.55 * unsharded["opt_bytes"])
            out["held_param_share"], out["held_optimizer_share"] = held, opt
            emit(out)
            if not ok:
                raise AssertionError(f"{key}: {out}")
        emit({"phase": "shard_spawn", "ranks": world, "seconds_for_spawn": seconds, "card": smi})
    return totals


def native_phase(smi) -> None:
    """Phase 50 (d): the native image decoder (peekvit_torch.native): its
    available() and build_error() printed as they are. Where it built,
    NATIVE_IMAGES JPEGs that PIL wrote under NATIVE_WORKSPACE go through
    the DataLoader's native batch path and its PIL path (the ImageFolder's
    native spec turned off) at the eval recipe (256 -> 224): the batches
    within tests/test_native.py's bounds (mean |diff| < 0.1, 95th
    percentile < 0.35 in normalized units), images/s of each. Where it did
    not, the loader's batches (which then decode with PIL) equal the PIL
    transform's image by image, and the line says so."""
    import numpy as np
    from PIL import Image

    from peekvit_torch import native
    from peekvit_torch.data import transforms as T
    from peekvit_torch.data.datasets import ImageFolder
    from peekvit_torch.data.loader import DataLoader

    ok, err = native.available(), native.build_error()
    shutil.rmtree(NATIVE_WORKSPACE, ignore_errors=True)
    folder = os.path.join(NATIVE_WORKSPACE, "c")
    os.makedirs(folder)
    rng = np.random.default_rng(50)
    h, w = NATIVE_PIXELS
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(NATIVE_IMAGES):  # smooth content with some texture
        a, b, ph = rng.uniform(0.5, 4.0, 3)
        img = np.stack([127 + 60 * np.sin(a * (c + 1) * 2 * np.pi * yy / h + ph)
                        + 50 * np.cos(b * 2 * np.pi * xx / w) for c in range(3)], -1)
        img += rng.normal(0, 6, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB").save(
            os.path.join(folder, f"{i}.jpg"), quality=90)
    transform = T.test_transform(224)
    transform.transforms[0] = T.Resize(256)

    def load(ds):
        t0 = time.perf_counter()
        batches = list(DataLoader(ds, 16, num_workers=4))
        seconds = time.perf_counter() - t0
        return (np.concatenate([b[0] for b in batches]),
                np.concatenate([b[1] for b in batches]), NATIVE_IMAGES / seconds)

    rec = {"phase": "native_decoder", "available": ok, "build_error": err,
           "images": NATIVE_IMAGES, "pixels": list(NATIVE_PIXELS), "recipe": [256, 224],
           "card": smi}
    pil_ds = ImageFolder(NATIVE_WORKSPACE, transform)
    pil_ds._native_spec = False
    pil_x, pil_y, rec["pil_images_per_s"] = load(pil_ds)
    if ok:
        nat_x, nat_y, rec["native_images_per_s"] = load(ImageFolder(NATIVE_WORKSPACE, transform))
        diff = np.abs(nat_x - pil_x)
        rec.update(mean_abs_diff=float(diff.mean()), q95_abs_diff=float(np.quantile(diff, 0.95)),
                   labels_equal=bool((nat_y == pil_y).all()))
        good = rec["mean_abs_diff"] < 0.1 and rec["q95_abs_diff"] < 0.35 and rec["labels_equal"]
    else:
        got_x, got_y, rec["fallback_images_per_s"] = load(ImageFolder(NATIVE_WORKSPACE,
                                                                      transform))
        want = np.stack([transform(Image.open(os.path.join(folder, f"{i}.jpg")).convert("RGB"))
                         for i in sorted(range(NATIVE_IMAGES), key=lambda i: f"{i}.jpg")])
        rec["fallback"] = "the library did not build: the loader decoded with PIL"
        rec["fallback_equals_pil"] = bool(np.array_equal(got_x, want)
                                          and np.array_equal(got_x, pil_x)
                                          and (got_y == pil_y).all())
        good = rec["fallback_equals_pil"]
    shutil.rmtree(NATIVE_WORKSPACE, ignore_errors=True)
    emit(rec)
    if not good:
        raise AssertionError(f"native decoder: {rec}")


# ------------------------------------------- 51. pipeline-parallel training

PIPE_RANKS = 4
PIPE_STEPS = 3
PIPE_BATCH = 32                     # (a) and (b): the global batch
PIPE_GATED_BATCH = 16               # (c)
PIPE_LR = 1e-4                      # AdamW, the fused train phases' rate
PIPE_JOIN_TIMEOUT = 600.0
PIPE_BUDGET = 0.6
PIPE_SPARSITY = {"sparsity": {"_target_": "peekvit.utils.losses.SparsityLoss", "weight": 0.2,
                              "sparsity_type": "l1"}}
PIPE_LABEL = ("gloo through the host, 4 processes sharing one card: not NCCL; each stage hand-off "
              "is one all-reduce of the stage group's zero-filled slots")
# key -> (registry name, args, mesh (n_data, n_second, axis), Trainer keywords, optimizer,
# global batch, rank 0's single-device reference). "pallas" steps against
# the fused bf16 step (AdamW, clip 1.0), the fp32 ones against the module
# step (phase 50's SGD with momentum 0.9, clip 1.0: an update linear in the
# gradients, so that fp32 limits hold it)
PIPE_RUNS = {
    "pp_vit": ("vit", B16, (1, 4, "stage"), dict(pipeline_stages=4, pipeline_microbatches=8),
               "adamw", PIPE_BATCH, "fused"),
    "pp_vit_xla": ("vit", B16, (1, 4, "stage"),
                   dict(pipeline_stages=4, pipeline_microbatches=8, parallel_kernels="xla"),
                   "momentum", PIPE_BATCH, "module"),
    "dppp_vit": ("vit", B16, (2, 2, "stage"), dict(pipeline_stages=2, pipeline_microbatches=4),
                 "adamw", PIPE_BATCH, "fused"),
    "pp_res": ("residualvit", RESIDUALVIT_B16, (1, 4, "stage"),
               dict(pipeline_stages=4, pipeline_microbatches=8), "momentum", PIPE_GATED_BATCH,
               "module_res"),
    "sp_res": ("residualvit", RESIDUALVIT_B16, (1, 4, "model"),
               dict(sequence_parallel_devices=4), "momentum", PIPE_GATED_BATCH, "module_res"),
}
# Launches a layer a microbatch of the "pallas" pipeline step: the trainable
# attention block's forward (ln_rows, qkv GEMM, attention, out-proj GEMM)
# and its recompute backward (save_qkv=False: ln_rows and the qkv GEMM
# again, g Wo^T, the attention backward, dqkv Wqkv^T, the LN backward)
PIPE_PER_LAYER = {"ln_rows": 2, "gemm_bias_epilogue.bias": 2, "attn_softmax_fwd": 1,
                  "gemm_bias_epilogue.residual": 1, "gemm_nt.none": 1, "attn_softmax_bwd": 1,
                  "gemm_nt.none_f32": 1, "ln_bwd_rows": 1}
# (loss rel, whole update rel-L2, worst leaf's update rel-L2) against rank
# 0's reference: the fp32 runs at phase 50's fp32 limits; the bf16 runs
# from their first reading (PERF.md: loss rel 1.10e-3, update 7.20e-2,
# worst leaf 0.735, AdamW turning bf16 roundings into sign-sized steps on
# near-zero gradients) at 2-5 times it
PIPE_TOLERANCES = {"pp_vit": (5e-3, 0.2, 1.5), "dppp_vit": (5e-3, 0.2, 1.5),
                   "pp_vit_xla": SHARD_TOLERANCES["fsdp_vit"],
                   "pp_res": SHARD_TOLERANCES["fsdp_vit"], "sp_res": SHARD_TOLERANCES["fsdp_vit"]}


def pipe_expected(fa, key: str) -> dict:
    """The launches a rank a step of PIPE_RUNS[key]: PIPE_PER_LAYER times
    the layers a stage and the microbatches, the attention keyed by the
    route its shape takes; none for the fp32 runs."""
    name, args, mesh, kw, _, _, ref = PIPE_RUNS[key]
    if ref != "fused" or kw.get("parallel_kernels") == "xla":
        return {}
    hd = args["hidden_dim"] // args["num_heads"]
    n = (args["image_size"] // args["patch_size"]) ** 2 + 1
    times = args["num_layers"] // kw["pipeline_stages"] * kw["pipeline_microbatches"]
    keys = {"attn_softmax_fwd": fa.softmax_key("attn_softmax_fwd", hd, n),
            "attn_softmax_bwd": fa.softmax_key("attn_softmax_bwd", hd, n, backward=True)}
    return {keys.get(k, k): v * times for k, v in PIPE_PER_LAYER.items()}


def pipe_trainer(torch, key: str, parallel: bool, mesh=None):
    """A run's Trainer from the seeded weights: the parallel one on every
    rank, or rank 0's single-device reference."""
    from peekvit_torch import Trainer
    from peekvit_torch.training.optim import SGD, AdamW
    from peekvit_torch.utils.losses import LossCompose

    name, args, _, kw, opt, _, ref = PIPE_RUNS[key]
    model = seeded_residual_model(torch, name, args)
    optimizer = AdamW(lr=PIPE_LR) if opt == "adamw" else SGD(lr=SHARD_LR, momentum=0.9)
    extra = dict(loss_compose=LossCompose(PIPE_SPARSITY)) if name == "residualvit" else {}
    if parallel:
        extra.update(kw, mesh=mesh)
    else:
        extra["fused"] = ref == "fused"
    return model, Trainer(model, optimizer, clip_grad_norm=1.0, device=DEVICE, **extra)


def pipe_steps(torch, dist, fa, trainer, x, y, budget, parallel: bool) -> dict:
    """PIPE_STEPS steps: counts zeroed just before each step and read just
    after, ms on the host clock between a barrier and a synchronize, the
    metric names, peak memory since the Trainer was built."""
    out = {"losses": [], "counts": [], "ms": [], "metrics": []}
    for step in range(PIPE_STEPS):
        torch.cuda.synchronize()
        if parallel:
            dist.barrier()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        m = trainer.train_step(x, y, budget=budget, step_idx=step)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"].append(dict(fa.LAUNCHES))
        out["losses"].append(float(m["total_loss"]))
        out["metrics"] = sorted(m)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["kind"] = trainer._train_kind
    return out


def pipe_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """Phase 51, one rank on cuda:0 over gloo: every run of PIPE_RUNS on its
    mesh, each Trainer from the seeded weights taking PIPE_STEPS steps on
    its global batch (pipe_steps); the whole parameters' digest. Rank 0
    then takes each distinct reference's steps on one device while the
    others wait, and holds losses and updates against each run's. cuDNN's
    TF32 is off in the phase: the module step embeds with a convolution,
    the parallel forwards with a matmul, and TF32 would round one but not
    the other. Writes rank<r>.pt into out_dir."""
    import torch
    import torch.distributed as dist

    from peekvit_torch.models.adapters import module_params
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)
    try:
        meshes, res, starts = {}, {}, {}
        for key, (name, args, shape, kw, _, batch, ref) in PIPE_RUNS.items():
            if shape not in meshes:
                meshes[shape] = make_mesh(shape[0], shape[1], device=DEVICE, axis=shape[2])
            x, y = dp_images(torch, batch, args["image_size"], args["num_classes"], 51)
            budget = PIPE_BUDGET if name == "residualvit" else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model, trainer = pipe_trainer(torch, key, True, meshes[shape])
            if rank == 0 and ref not in starts:
                starts[ref] = {k: v.clone() for k, v in _flat(module_params(model)).items()}
            rec = pipe_steps(torch, dist, fa, trainer, x, y, budget, True)
            kwargs = trainer._pipeline_fwd_kwargs or trainer._sp_fwd_kwargs
            rec["kernels"] = kwargs.get("kernels", "fp32 (the gated forward)")
            whole = _flat(module_params(model))
            rec["digest"] = param_digest(torch, {k: whole[k] for k in sorted(whole)})
            if rank == 0:
                rec["update"] = {k: (whole[k] - starts[ref][k]).float() for k in whole}
            res[key] = rec
            del trainer, model, whole
            torch.cuda.empty_cache()
            dist.barrier()
        if rank == 0:
            singles = {}
            for key, (name, args, _, _, _, batch, ref) in PIPE_RUNS.items():
                if ref in singles:
                    continue
                x, y = dp_images(torch, batch, args["image_size"], args["num_classes"], 51)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                model, trainer = pipe_trainer(torch, key, False)
                rec = pipe_steps(torch, dist, fa, trainer, x, y,
                                 PIPE_BUDGET if name == "residualvit" else None, False)
                whole = _flat(module_params(model))
                rec["update"] = {k: (whole[k] - starts[ref][k]).float() for k in whole}
                singles[ref] = rec
                del trainer, model, whole
                torch.cuda.empty_cache()
            for key, rec in res.items():
                single = singles[PIPE_RUNS[key][6]]
                got, want = rec.pop("update"), single["update"]
                num = sum(float((got[k] - want[k]).square().sum()) for k in want)
                rec["update_rel_l2_all"] = math.sqrt(
                    num / sum(float(want[k].square().sum()) for k in want))
                err = rel_l2(torch, got, want)
                rec["update_rel_l2_worst_leaf"] = [max(err, key=err.get), max(err.values())]
                rec["single"] = {k: v for k, v in single.items() if k != "update"}
        dist.barrier()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def pipe_phases(torch, smi) -> dict:
    """Phase 51 (a)-(c): pipeline-parallel training as 4 spawned ranks on
    cuda:0 over a gloo group (pipe_rank). (a) ViT-B/16 on a (1, 4) stage
    mesh at a global bs32, M = 8, parallel_kernels "auto" (which must
    resolve to "pallas": the trainable attention kernels, sites 18-19)
    against rank 0's fused single-device step (AdamW), and the "xla"
    form (fp32) against the module step; (b) dp x pp on (2, 2), M = 4,
    "pallas", against the same fused step; (c) the gated
    residualvit_b_16.yaml at budget 0.6 with the l1 sparsity regularizer,
    pipelined on (1, 4) with M = 8 and sequence-parallel on 4 ranks, fp32,
    against the module step. Every rank's losses and whole parameters
    bit-identical within a run; each "pallas" rank's launches a step
    pipe_expected's (and > 0), the fp32 runs' none; losses and updates
    within PIPE_TOLERANCES; the regularizer's loss among (c)'s metrics; ms a
    step a rank (steps 2-3) beside the single device's, the bubble, peak
    memory a rank. Returns the launches summed over every rank and step
    ("pipeline_train")."""
    from peekvit_torch.ops.cuda import _build
    from peekvit_torch.ops.cuda import fused_attention as fa
    from peekvit_torch.parallel.pipeline import bubble_fraction

    _build.build_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pipe_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    spawn_ranks(torch, pipe_rank, PIPE_RANKS, (PIPE_RANKS, os.path.join(out_dir, "rdzv"),
                                               out_dir), PIPE_JOIN_TIMEOUT)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(PIPE_RANKS)]
    totals = {}
    failed = []
    for key, rec0 in ranks[0].items():
        name, args, shape, kw, opt, batch, ref = PIPE_RUNS[key]
        recs = [rk[key] for rk in ranks]
        same = all(r["digest"] == recs[0]["digest"] and r["losses"] == recs[0]["losses"]
                   for r in recs)
        want = pipe_expected(fa, key)
        counts_ok = all(c == want for r in recs for c in r["counts"])
        for r in recs:
            for counts in r["counts"]:
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
        single = rec0["single"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], single["losses"]))
        loss_tol, update_tol, leaf_tol = PIPE_TOLERANCES[key]
        kernels_ok = recs[0]["kernels"] == (kw.get("parallel_kernels", "pallas")
                                            if name == "vit" else "fp32 (the gated forward)")
        stages = kw.get("pipeline_stages", 1)
        m = kw.get("pipeline_microbatches", 1)
        out = {"phase": "pipeline_train", "run": key, "ranks": PIPE_RANKS, "mesh": list(shape),
               "global_batch": batch, "train_kind": recs[0]["kind"],
               "kernels": recs[0]["kernels"], "reference": single["kind"],
               "optimizer": "AdamW(lr=1e-4)" if opt == "adamw" else
               f"SGD(lr={SHARD_LR}, momentum=0.9)", "clip_grad_norm": 1.0,
               "microbatches": m if "pipeline_stages" in kw else None,
               "bubble_fraction": bubble_fraction(stages, m) if "pipeline_stages" in kw
               else None,
               "losses": recs[0]["losses"], "single_losses": single["losses"],
               "metrics": recs[0]["metrics"], "loss_rel_max": loss_rel,
               "update_rel_l2": rec0["update_rel_l2_all"],
               "update_rel_l2_worst_leaf": rec0["update_rel_l2_worst_leaf"],
               "tolerance": dict(zip(("loss_rel", "update_rel_l2", "worst_leaf"),
                                     PIPE_TOLERANCES[key])),
               "launches_per_rank_per_step": recs[0]["counts"][0],
               "expected_launches_per_rank_per_step": want,
               "ranks_bit_identical": same,
               "ms_per_step_by_rank": [r["ms"][1:] for r in recs], "single_ms": single["ms"][1:],
               "peak_memory_gib_by_rank": [r["peak_memory_gib"] for r in recs],
               "single_peak_memory_gib": single["peak_memory_gib"],
               "label": PIPE_LABEL, "tf32": "cuDNN TF32 off in the phase", "card": smi}
        ok = (same and counts_ok and kernels_ok and loss_rel <= loss_tol
              and rec0["update_rel_l2_all"] <= update_tol
              and rec0["update_rel_l2_worst_leaf"][1] <= leaf_tol
              and all(math.isfinite(v) for v in recs[0]["losses"])
              and (not want or sum(want.values()) > 0)
              and (name != "residualvit" or "sparsity" in recs[0]["metrics"]))
        emit(out)
        if not ok:
            failed.append(key)
    emit({"phase": "pipeline_spawn", "ranks": PIPE_RANKS, "seconds_for_spawn": seconds,
          "card": smi})
    if failed:
        raise AssertionError(f"phase 51: {failed} failed their checks (lines above)")
    return {"pipeline_train": totals}


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
    from peekvit_torch.ops.cuda import quant_blocks as tq
    from peekvit_torch.utils.flops_count import analytic_macs

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---------------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    host = {}
    for lib in ("yaml", "PIL", "matplotlib"):  # the entry points' host packages
        try:
            host[lib] = __import__(lib).__version__
        except ImportError:
            host[lib] = None
    # what the JAX package's native image decoder (-ljpeg -lpng) would need
    host["g++"] = shutil.which("g++")
    for header in ("/usr/include/jpeglib.h", "/usr/include/png.h"):
        host[header] = os.path.isfile(header)
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "host_packages": host})

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
            dev_ms = graph_ms(torch, kfn)
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
                     "max_abs_err": checks[key], "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms,
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
    # ------------------------------------------------- 9-11. ResidualViT serving
    res_ins = residual_kernel_checks(torch, fa, check, randn, w_out, b_out, d, h)
    res = residual_phases(torch, fa, dev, smi)
    res_entries = residual_timing(torch, F, fa, smi, checks, res_ins, res, kernel_ms, d, h)
    merged, split = (res["compact_counts"][c] for c in COMPACT)
    # ------------------------------------------------ 12-14. ResidualViT training
    rt_ins = masked_block_checks(torch, fa, vjp, check, randn, ln_s, ln_b, w_qkv, b_qkv, w_out,
                                 b_out, d, h)
    rtrain = residual_train_phases(torch, F, fa, dev, smi, analytic_macs(res["model"]))
    rt_entries = residual_train_entries(torch, F, fa, vjp, smi, checks, rtrain, kernel_ms, rt_ins,
                                        res_ins, ln_s, ln_b, w_out, b_out, d)

    def residual_paths(key, residual=True, compact=(merged, split)):
        # fc2's GEMM takes the fp32 residual in the merged layer and the
        # bf16 one in the split sublayers; the phantom attention entries
        # are one per compact mode
        return {"residual": res["counts"].get(key, 0) if residual else 0,
                "compact": sum(c.get(key, 0) for c in compact)}

    for entry in kernels:
        name = entry["name"]
        entry["launches_by_path"].update(residual_paths(
            name, compact=(merged,) if name == "gemm_bias_epilogue.residual" else (merged, split)))
    for entry in entries:  # none of them runs on the engine's path
        key = entry.pop("count_key")
        bf16_res = entry["name"].endswith("bf16_residual")
        entry["launches_by_path"] = {
            "engine": 0, "split": split_counts.get(key, 0), "train": train["counts"].get(key, 0),
            **residual_paths(key, residual=not bf16_res,
                             compact=(split,) if bf16_res else (merged, split))}
    for entry in res_entries:
        key = entry.pop("count_key")
        by_n = {f"{key}.n{compact_geometry(c)[0]}": (res["compact_counts"][c],) for c in COMPACT}
        entry["launches_by_path"] = {"engine": 0, "split": 0, "train": 0, **residual_paths(
            key, compact=by_n.get(entry["name"], (merged, split)))}
    for entry in rt_entries:
        entry["launches_by_path"] = {"engine": 0, "split": 0, "train": 0, "residual": 0,
                                     "compact": 0}
    kernels += entries + res_entries + rt_entries
    for entry in kernels:
        # the masked-residual GEMM row is the bf16-residual one the
        # residual train step runs; fc2's residual GEMM does not run there
        key = entry["name"].removesuffix(".bf16_residual").split(".n1")[0]
        entry["launches_by_path"]["residual_train"] = (
            rtrain["counts"].get(key, 0) if key in RESIDUAL_TRAIN_PER_LAYER else 0)
    new_keys = ("norm_rows.masked.bf16", "norm_rows.masked.f32", "ln_rows.masked",
                "gemm_bias_epilogue.masked_residual_f32", "gemm_bias_epilogue.masked_residual",
                "attn_scores_pv.kweight")
    missing = [k for k in new_keys
               if not res["counts"].get(k, 0) + merged.get(k, 0) + split.get(k, 0)]
    if missing:
        raise AssertionError(f"kernels never launched on the residual paths: {missing}")
    # ----------------------------------------------------- 15-17. RankViT serving
    fc1_w, fc1_b = gemms["fc1"][1], gemms["fc1"][2]
    fc2_w, fc2_b = gemms["fc2"][1], gemms["fc2"][2]
    rank_w = (ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, fc1_w, fc1_b, fc2_w, fc2_b)
    rank_ins = rank_kernel_checks(torch, fa, check, randn, *rank_w, d, h, smi)
    rank = rank_phases(torch, fa, dev, smi)
    rank_entries = rank_timing(torch, F, fa, smi, checks, rank_ins, rank, kernel_ms, *rank_w,
                               d, h, m)
    rank_paths = [rank["paths"][run] for _ in RANK_REQUESTS for run in RANK_RUNS]
    split_layers = sum(p.count("split") for p in rank_paths)
    folded_layers = len(rank_paths) * RANKVIT_B16["num_layers"] - split_layers
    for entry in kernels:
        # fc2's GEMM takes the fp32 residual in the folded layers; both
        # split sublayers' GEMMs take the bf16 one
        name = entry["name"]
        entry["launches_by_path"]["rank"] = (
            folded_layers if name == "gemm_bias_epilogue.residual"
            else 2 * split_layers if name == "gemm_bias_epilogue.residual.bf16_residual"
            else rank["counts"].get(name, 0))
    for entry in rank_entries:
        entry["launches_by_path"] = {"engine": 0, "split": 0, "train": 0, "residual": 0,
                                     "compact": 0, "residual_train": 0,
                                     "rank": entry["launches"]}
    kernels += rank_entries
    # ----------------------------------------------------- 18-20. int8 (w8a8)
    quant_ins = quant_kernel_checks(torch, F, tq, check, checks, randn, ln_s, ln_b, w_qkv, b_qkv,
                                    w_out, b_out, fc1_w, fc1_b, fc2_w, fc2_b, d, h, m, smi)
    quant = quant_phases(torch, fa, dev, smi)
    quant_entries = quant_timing(torch, F, tq, smi, checks, quant_ins, quant, d, h, m)
    for entry in kernels:  # the int8 paths run the attention, plain and key-masked
        entry["launches_by_path"]["int8"] = quant["counts"].get(entry["name"], 0)
    for entry in quant_entries:
        entry["launches_by_path"] = {"engine": 0, "split": 0, "train": 0, "residual": 0,
                                     "compact": 0, "residual_train": 0, "rank": 0,
                                     "int8": entry["launches"]}
    kernels += quant_entries
    # ------------------------------------ 21-24. ResidualViT int8 and A-ViT
    rq_ins = residual_int8_kernel_checks(torch, tq, check, checks, randn, quant_ins, ln_s, ln_b,
                                         b_out, d, h, smi)
    rq = residual_int8_phases(torch, fa, tq, dev, smi, rq_ins, quant_ins["qw"], h)
    av = avit_phases(torch, fa, check, checks, randn, dev, smi)
    new_entries = new_paths_timing(torch, F, fa, tq, smi, checks, rq_ins, rq, av, quant_ins,
                                   b_out, d, h, m)
    for entry in kernels:  # the new paths run the earlier slices' kernels too
        entry["launches_by_path"]["residual_int8"] = rq["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["avit"] = av["counts"].get(entry["name"], 0)
    for entry in new_entries:
        name = entry["name"]
        entry["launches_by_path"] = {
            **dict.fromkeys(("engine", "split", "train", "residual", "compact", "residual_train",
                             "rank", "int8"), 0),
            "residual_int8": rq["counts"].get(name, 0),
            "int8_split_sublayers": rq["split_counts"].get(name, 0),
            "avit": av["counts"].get(name, 0)}
    kernels += new_entries
    # ----------------------------------------------------- 25-27. PCT / RankPCT
    pct_ins = pct_kernel_checks(torch, fa, check, checks, dev, smi)
    pct = pct_phases(torch, fa, dev, smi, pct_ins)
    pct_entries = pct_timing(torch, F, fa, smi, checks, pct_ins, pct)
    for entry in kernels:  # the PCT paths run the earlier slices' layer kernels
        entry["launches_by_path"]["pct"] = pct["counts"].get(entry["name"], 0)
    for entry in pct_entries:
        entry["launches_by_path"] = {
            **dict.fromkeys(("engine", "split", "train", "residual", "compact", "residual_train",
                             "rank", "int8", "residual_int8", "int8_split_sublayers", "avit"), 0),
            "pct": entry["launches"]}
    kernels += pct_entries
    # ------------------------- 28-31. the merged layer VJP and the attention switch
    from peekvit_torch.ops.cuda import fused_layer_vjp as lv

    m_ins = merged_kernel_checks(torch, fa, vjp, lv, check, randn, x, y, ln_s, ln_b, g_rows,
                                 dln_in, fc1_w, fc1_b, fc2_w, qkv, d, h, m, rows, smi)
    redesign_edge_checks(torch, fa, vjp, lv, check, randn, d, h, m, smi)
    gemm_attn_bwd_edge_checks(torch, fa, vjp, randn, d, h, smi)
    merged_block_checks(torch, lv, randn, (ln_s, ln_b, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b,
                                           fc1_w, fc1_b, fc2_w, fc2_b), d, h, n, smi)
    mtrain = merged_train_phases(torch, F, fa, dev, smi, B16)
    merged_entries = merged_timing(torch, F, fa, vjp, lv, smi, checks, m_ins, mtrain, x, y, ln_s,
                                   ln_b, g_rows, dln_in, fc1_w, fc1_b, fc2_w, d, m, rows,
                                   analytic_macs(model))
    gemm_attn_bwd_timing(torch, F, fa, vjp, smi, randn, info)
    mod = module_path_phases(torch, F, fa, dev, smi, check, checks, qkv, m_ins["q"], m_ins["k"],
                             m_ins["v"], d, h, n)
    # ------------------------------------------- 32-33. tensor-parallel serving
    tp_ins = tp_kernel_checks(torch, fa, check, randn, smi)
    tp = tp_phases(torch, fa, smi)
    tp_entries = tp_timing(torch, F, fa, smi, checks, tp_ins, tp)
    # ------------------------------------------ 34-35. sequence-parallel training
    sp_w = (w_out, b_out, ln_s, ln_b, fc1_w, fc1_b, fc2_w, fc2_b)
    sp_ins = sp_kernel_checks(torch, lv, check, randn, sp_w, d, h, smi)
    sp = sp_phases(torch, smi)
    sp_entries = sp_timing(torch, F, lv, smi, checks, sp_ins, sp_w, sp, d, h, m)
    # ------------------------- 36. the redesigned attention and s8 GEMM at their edges
    scores_pv_s8_edge_checks(torch, fa, tq, randn, smi, info)
    arpe_norm_build_checks(smi, info)
    # ------------------------- 38-40. the training attention at every shipped shape
    tiled_kernel_checks(torch, fa, vjp, lv, check, randn, smi, info)
    shipped = shipped_train_phases(torch, F, fa, vjp, dev, smi)
    tiled_entries = tiled_timing(torch, F, fa, vjp, lv, smi, check, checks, randn, shipped)
    # ------------------------------------------- 41. the reconstruction decoders
    recon = recon_phases(torch, F, fa, dev, smi, check, checks, info)
    # ---------------------------------------------------------------- 42. MoE
    moe = moe_phases(torch, F, fa, tq, dev, smi, check, checks, info)
    # ------------------------------------ 44. family training, 45. noise
    family = family_train_phases(torch, fa, dev, smi)
    noise = noise_phases(torch, fa, dev, smi)
    # ----------------------------------------------------- 46. the entry points
    cli = cli_phases(torch, fa, dev, smi)
    # ------------------------------------------- 47. quantization-aware training
    qat = qat_phases(torch, fa, dev, smi)
    # ------------------------------------- 48. serving bundles and the host
    serving = serving_phases(torch, fa, dev, smi)
    # --------------------- 49. training with dropout, data parallelism
    dropout_phases(torch, fa, dev, smi)
    dp = dp_phases(torch, smi)
    # ----------------- 50. sharded training, the native image decoder
    shard = shard_phases(torch, smi)
    native_phase(smi)
    # ---------------------------------------- 51. pipeline-parallel training
    shard.update(pipe_phases(torch, smi))
    for entry in kernels:  # the later paths run earlier kernels too
        entry["launches_by_path"]["merged"] = mtrain["counts"]["merged"].get(entry["name"], 0)
        entry["launches_by_path"]["hybrid"] = mtrain["counts"]["hybrid"].get(entry["name"], 0)
        entry["launches_by_path"]["module"] = mod["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["tp"] = tp["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["sp"] = sp["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["shipped_train"] = shipped["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["recon"] = recon["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["moe"] = moe["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["family_serve"] = family["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["noise"] = noise["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["cli_train"] = cli["train_counts"].get(entry["name"], 0)
        entry["launches_by_path"]["cli_test"] = cli["test_counts"].get(entry["name"], 0)
        entry["launches_by_path"]["qat_serve"] = qat["serve_counts"].get(entry["name"], 0)
        entry["launches_by_path"]["qat_cli_test"] = qat["cli_test_counts"].get(entry["name"], 0)
        entry["launches_by_path"]["serving"] = serving["counts"].get(entry["name"], 0)
        entry["launches_by_path"]["dp_serve"] = dp["dp_serve"].get(entry["name"], 0)
        entry["launches_by_path"]["dp_train"] = dp["dp_train"].get(entry["name"], 0)
        for path, counts in shard.items():
            entry["launches_by_path"][path] = counts.get(entry["name"], 0)
    # every path's counts as this run measured them, read by each new
    # entry's count key
    measured = {"engine": main_counts, "split": split_counts, "train": train["counts"],
                "residual": res["counts"],
                "compact": {k: merged.get(k, 0) + split.get(k, 0) for k in {**merged, **split}},
                "residual_train": rtrain["counts"], "rank": rank["counts"],
                "int8": quant["counts"], "residual_int8": rq["counts"],
                "int8_split_sublayers": rq["split_counts"], "avit": av["counts"],
                "pct": pct["counts"], "merged": mtrain["counts"]["merged"],
                "hybrid": mtrain["counts"]["hybrid"], "module": mod["counts"],
                "attention_alone": mod["alone"], "tp": tp["counts"], "sp": sp["counts"],
                "shipped_train": shipped["counts"], "recon": recon["counts"], "moe": moe["counts"],
                "family_serve": family["counts"], "noise": noise["counts"],
                "cli_train": cli["train_counts"], "cli_test": cli["test_counts"],
                "qat_serve": qat["serve_counts"], "qat_cli_test": qat["cli_test_counts"],
                "serving": serving["counts"], "dp_serve": dp["dp_serve"],
                "dp_train": dp["dp_train"], **shard}
    later = (merged_entries + [mod["entry"]] + tp_entries + sp_entries + tiled_entries
             + recon["entries"] + moe["entries"])
    for entry in later:
        key = entry.pop("count_key")
        entry["launches_by_path"] = {path: c.get(key, 0) for path, c in measured.items()}
        if key is None:  # a composition: its calls' launches on its path
            entry["launches_by_path"][entry["path"]] = entry["launches"]
    kernels += later
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start, "card": smi})

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
