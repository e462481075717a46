#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught but [17]'s
expected FloatingPointError:

1. Require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. Build the kernels from ``hybrid_vit_cascade_tpu_torch/csrc`` with nvcc
   (sm_90a) and print the build time.
3. Hold each kernel against its plain PyTorch version on the card, at every
   shape the main path gives it and at ragged small shapes, in bf16 and fp32
   (flash attention's output with the absolute part of its tolerance scaled
   by the call's largest |want|: FLASH_OUT_TOL; the bf16 calls with Cin ≥ 8
   and Cout ≥ 8 at either stride on the tensor-core conv). Then the chain forms H
   (stride-1 chain conv, and as its data gradient), I (stride-2 chain
   conv), J (stride-2 chain data gradient) and K (chain weight gradients)
   at every shape the streamed stage-3 chains give them
   (8-slab training, 1-slab eval, batch 1 and 2, both volume ends) and at
   ragged small shapes, with every option (window, Σ/Σ² sums, gelu/silu
   prologue, act′ epilogue).
4. The slice: the full-width progressive cascade of
   ``configs/progressive_cascade.json`` (bf16 compute over fp32 weights made
   from a seeded torch.Generator, written with torch.save and loaded back
   through InferenceEngine) reconstructs one 512² X-ray pair at
   max_stage=3 with return_intermediate=True, its stage-3 chains streamed
   (the eval schedule: one slab, every endpoint stored). Checks the output
   shapes, finiteness, and that each kernel launched as often as the path
   needs it (EXPECTED_LAUNCHES), its tensor-core instances included: every
   stride-2 conv on the tensor cores (the 1→64 stem on the one-input-channel
   instance), every 1-channel stride-1 conv on the one-input-channel
   instance.
5. A small-input reference: a scaled cascade in fp32 on the card (kernels)
   against the same weights on the CPU (plain versions), its stage-3 chains
   streamed at every level.
6. Timings from CUDA events and the host clock after a warm-up: the median
   end-to-end reconstruct time and volumes/s under the streamed (default) and
   the dense stage-3 schedule, in turns, then one streamed reconstruct under
   torch.profiler (device time by kernel name, idle share); each kernel
   beside its plain version at the main-path shapes.
7. The gradient kernels — D (flash backward), L and M (the split flash
   backward: dq, then dk and dv), E (stride-1 weight gradient), F (stride-2
   data gradient), G (stride-2 weight gradient) and kernel B run as the
   stride-1 data gradient — against their plain versions at every shape the
   three training stages give them (and ragged small shapes), in bf16 and
   fp32, with kernel and plain times at the training shapes (the three
   flash backward kernels with FLASH_OUT_TOL: their gradients are well under
   1 at the long shapes); two runs of D agree bitwise at every training
   shape in bf16 and fp32 (its dq adds go in a fixed order), two runs of M at
   every training shape in bf16 (and its dk, dv are D's bits), and two runs
   of L and of M at the stage-3 shape in fp32 (no atomics); the bf16 64→32
   and 32→64 weight gradients of the stage-3 step (dense and one training
   slab) take the tensor-core instance
   of E/G/K (its own launch counter), the bf16 1→64 and 1→32 ones (dense and
   one training slab) and the 1→64 stride-2 stem's the one-input-channel
   instances (stride 1 and stride 2), fp32 calls the CUDA-core one; the bf16
   64→32 conv and its data
   gradient (dense and one training slab) take the tensor-core B/H, the bf16
   1→64 and 1→32 convs (dense and one training slab of each chain) the
   one-input-channel B/H, and every bf16 flash forward and backward
   of the training shapes the tensor-core A, D, M and L, the bf16 32→64
   stride-2 conv and its data gradient (dense and one training slab) the
   tensor-core C/I and F/J, the bf16 one-output-channel data gradient of the
   1-channel convs (dense 64→1 and 32→1, one training slab) its own
   tensor-core instance, the bf16 1→64 stride-2 stem and its data gradient
   their one-input-channel and one-dx-channel tensor-core instances; their
   fp32 calls the CUDA-core ones. The one-output-channel chain data
   gradient has its own row in the kernels line
   (conv3d_k3s1_chain_c1_dgrad: 64→1 over the whole volume, 32→1 likewise
   and the two training slabs, each with its conv3d_input time), and so do
   the one-input-channel instances (conv3d_k3s1_c1in, conv3d_k3s1_chain_c1in,
   conv3d_k3s1_c1in_wgrad: 1→64 and 1→32 over 256³ and the training slabs,
   beside cuDNN's conv3d and conv3d_weight) and the stride-2 1→64 stem
   (conv3d_k3s2_c1in, conv3d_k3s2_c1in_dgrad and conv3d_k3s2_c1in_wgrad on
   their tensor-core instances: stage 1's batch of 8 at 64³). The stem's
   data gradient runs once more in fp32 ([7d]), on its one-dx-channel CUDA-
   core instance (dgrad_s2_c1_f32_kernel), held to its plain version at the
   hot and the ragged stem shapes and bitwise across two runs, and timed
   beside it and conv3d_input in fp32, by CUDA events around the wrapper and
   a launch at a time (the mean of 20 back-to-back launches): the ``fp32``
   entry of its row, whose launches are that instance's on the main path
   (0: the main path is bf16). [7h] holds A, D, L and M at head dims other
   than 32 and 64 (HEAD_DIM_AT: d = 128 at 2 heads and d = 16, padded to
   the d = 32 instance, at 16 heads, over 32,768 voxel tokens and 32,768 ×
   4,096 cross-attention; HEAD_DIM_RAGGED at padded d 16, 48, 96 and at
   128) to their plain versions in bf16 and fp32, checks each bf16 call's
   tensor-core launch and two runs of D (bf16, fp32), L and M (bf16)
   bitwise, and times them beside their plain versions.
8. A small training reference: one scaled stage-3 train step (deterministic
   forward, fp32, stage-3 chains streamed in 4 slabs at every level) on the
   card (kernels) against the same step on the CPU (plain versions): loss and
   every trainable gradient within 2e-4.
9. The training slice: the full-width cascade trains stage 1 (64³, batch 8),
   stage 2 (128³, batch 2) and stage 3 (256³, batch 1) the way the JAX
   trainer's fit_cascade builds each stage (trainable stage + shared encoder,
   AdamW with the stage's learning rate, MultiScaleLoss at the stage's
   resolution, stop_grad_stage1, remat 'mlp' at stage 3), on seeded X-rays
   and a seeded 256³ CT volume: one warm-up step and 3 timed ones per stage,
   finite losses, peak memory, and each kernel's launches per step (every
   counted wrapper, B as the stride-1 data gradient included, launches in
   the stage-3 step, its bf16 64→32 and 32→64 weight gradients, its 64→32
   chain conv and data gradient in every slab, every 32→64 chain conv (I),
   and every flash forward and fused backward of each stage on the tensor
   cores; every bf16 F/J call with Cin, Cout ≥ 8 on the tensor cores, as
   many launches as the rule names; every bf16 stride-1 conv and weight
   gradient with one input channel on the one-input-channel instances, and
   every bf16 stride-2 conv, data gradient and weight gradient with one
   input channel (the 1→64 stem: all three in every stage-1 step) on their
   tensor-core instances).
   Stage 3 trains on the config's streamed schedule (8 slabs). Each stage's
   steps run a second time from the state they began from, and stage 3's
   twice more with the split flash backward (L + M): the losses, the state
   after the last step and its gradients must agree in every bit.
10. The chain phase: the full 256³ detail-enhancer and trunk chains (full
   widths, seeded weights, fp32) streamed — 8 slabs, then 1 slab with every
   endpoint stored, each with the activation prologue off and on — against
   the port's dense chain on the card: values and the gradients of the input
   and every chain array within 2e-4, the absolute part scaled by the
   largest |want|.
11. The training entry point: ``cli.main(["train", "--config", <copy>])``
   in this process, on the card, on a copy of ``configs/quality_r5.json``
   (frozen shared encoder, split stage-3 step; widths, batches, schedule and
   losses the config's) with one epoch per stage, 11 synthetic 256³ patients
   (8 train, 1 val), no visualization and ``save_dir`` under ``build/``,
   with the split flash backward selected (``ops.attention.FUSED_BWD =
   False``, what ``HVC_FLASH_FUSED_BWD=0`` selects). Checks: D never
   launched, L and M launched in every stage, every bf16 L, M, F/J (Cin,
   Cout ≥ 8), one-output-channel data gradient and one-input-channel
   stride-1 conv and weight gradient on the tensor cores, as many launches
   as the rules name, every stage's ``latest`` and
   ``best_*`` written, finite losses, the shared encoder's parameters and
   BatchNorm buffers at ``stage3/latest`` bitwise those at ``stage2/latest``
   while stage 3 moved; the same command again skips every stage (resume);
   ``InferenceEngine(<save_dir>/stage3/best_psnr)`` reconstructs a volume.
   Prints each stage's wall time and median step time.
12. The probe path, kernel family N (``csrc/conv_probe.cu``): each of the
   eight probe kernels (V1 and the V0 control through one wrapper) against
   its plain version at the probes' full size (N = 131,072 columns, R = 64
   passes) and at ragged small N, within 1e-4·max|want| + 1e-4·|want|;
   then the entry point's ``run`` (``hybrid_vit_cascade_tpu_torch.scripts.
   bench_conv_probe``) over every case at full size, launches counted from
   0: each kernel beside its plain version and its cuBLAS yardstick, and
   the cuDNN dense convs VX (64→32) and VX2 (32→64) at 256³. Each probe
   call, at full size and at ragged N, must have taken the instance its
   rule names (``conv_probe.probe_v1_instance``, ``probe_v2_instance``,
   ``probe_v3_instance``, ``probe_v3p_instance``, ``probe_v4_instance``,
   ``probe_v6_instance``, ``probe_v5_instance``, ``probe_v8_instance``): at
   N = 131,072 V0 on its wgmma instance (conv_probe_v1_wgmma), V1 on its own
   (conv_probe_v1_wgmma_m32), V2 on its own (conv_probe_v2_wgmma), V3, V3',
   V4, V6, V5 and V8 on theirs (conv_probe_v3_wgmma, conv_probe_v3p_wgmma,
   conv_probe_v4_wgmma, conv_probe_v6_wgmma, conv_probe_v5_wgmma,
   conv_probe_v8_wgmma); V1, V3, V3', V4, V6, V5 and V8 at N = 77 on
   mma.sync.
13. The serving commands: ``cli.main(["infer" | "eval" | "inspect" |
   "diagnose", ...])`` in this process, on the card, on [11]'s full-width
   ``stage3/best_psnr`` entry (whose config is [11]'s copy), with synthetic
   256³ patients and ``HVC_PHANTOM_CACHE`` under ``build/``. Checks: infer
   writes a finite 256³ ``.npy`` (bf16, as the export writes it) and
   ``.nii.gz``, its PNGs only where matplotlib is installed (else their keys
   are absent and the skips printed), and finite per-stage metrics, and
   caches its phantom; eval's summary is finite over the test split; inspect
   lists every tensor of the entry; diagnose reports finite losses with
   ``captured_attention == ["cross_attention"]``. Launches, counted from 0
   per command: EXPECTED_LAUNCHES for every reconstruct of infer (two) and
   eval (one an item), none for inspect, and for diagnose stage 1's share
   (STAGE1_LAUNCHES) less its cross-attentions, which the capture takes on
   the plain path. Prints each command's wall time.
14. The direct-regression families at their configs' full widths (bf16 over
   fp32 weights from a seeded torch.Generator, written with
   ``save_checkpoint`` and loaded through InferenceEngine):
   ``DirectCTRegression`` of ``configs/direct_64.json`` reconstructs one
   512² pair at batch 1 (finite (1, 1, 64³), launches
   EXPECTED_LAUNCHES_DIRECT: its 4 × 4,096 × 4,096 × 64 self- and
   cross-attentions on A's tensor-core instance, which [3] and [7] hold to
   the plain version at that shape and [7] holds bitwise for D), then 5
   timed reconstructs (volumes/s), then 1 + 3 train steps at the config's
   batch 8 (finite losses, peak memory, launches per step: every flash
   forward and backward and every bf16 B, C, E, F, G call on the instance
   its rule names); ``cli train`` on a one-epoch copy of the config with 10
   synthetic patients (latest, latest_opt, best_* written; the same
   command again trains nothing and launches nothing), then ``cli infer``,
   ``eval`` and ``diagnose`` on its ``best_psnr`` (the other-family metrics
   psnr, psnr_dynamic, ssim, l1; diagnose captures ``["cross_attention"]``;
   launches 2 ×, one × a test item and EXPECTED_LAUNCHES_DIRECT less the 4
   captured cross-attentions). The CNN decoders (cuDNN, no hand-written
   kernel launches): ``Direct128ModelH200`` of
   ``configs/direct128_h200.json`` reconstructs (finite (1, 1, 128³), time,
   peak) and takes 1 + 3 train steps at batch 2 with ``Direct256Loss`` at
   128³ (finite losses, peak); ``cli transfer --init-only`` moves its
   seeded checkpoint into a ``direct256_h200`` copy of that config
   (transferred and skipped counts > 0), whose written entry reconstructs a
   finite (1, 1, 256³); ``Direct256ModelB200`` of
   ``configs/direct256_b200.json`` reconstructs a finite (1, 1, 256³),
   then ([14f]) takes 1 + 1 train steps at its batch 1 at 256³ with
   ``Direct256Loss`` (the loss nets' layers and the decoder's top scale
   recomputed: finite losses, step time, peak), run twice from one state
   with every bit of the losses, the state and the gradients equal; ``cli
   train`` on a one-epoch copy of that config (B200_PATIENTS synthetic 256³
   patients: latest, latest_opt, best_* written, finite metrics, no
   hand-written kernel launched); ``Direct256ModelH200``'s 256³ step at batch
   1 on [14e]'s copy, or the allocator's numbers where it runs out of memory.
   Small-input references (fp32, card against CPU, 2e-4): a scaled
   DirectCTRegression's forward and one deterministic step's loss and
   gradients; ResidualDenseBlock, CBAM, UpConvStage and Direct256Loss at 16³.
15. The diffusion family at its configs' full widths (bf16 over fp32
   weights from a seeded torch.Generator, T = 1000): ``configs/
   diffusion_64.json``'s stage1_low (64³, voxel_dim 256, depth 4, 4 heads,
   X-ray features 512, remat) takes 1 + 3 train steps at batch 4 (every
   loss component finite, peak, launches per step DIFFUSION_STEP[1], the
   17→64 stem's forward, dx and dW on the tensor-core C, F, G), one denoise
   forward (EXPECTED_LAUNCHES_DIFFUSION) and ``ddim_sample`` at batch 1 with
   the config's 20 steps, twice (cold, warm; 20 × those launches); the
   stage2_mid step (128³, depth 6, 8 heads) of ``diffusion_quality_r5.json``
   (batch 2, lifter streamed in 8 slabs) and of ``diffusion_progressive.json``
   (batch 1, dense lifter), conditioned on the ground truth at 64³
   (DIFFUSION_STEP[2]); ``cascaded_ddim_sample`` of the r5 ladder at batch 1
   with its 25 steps (wall time and launches per stage); the stage-2 lifter
   streamed against dense at full width in fp32 (value and gradients within
   1e-4·max|want|); ``cli train`` on a one-epoch-a-stage copy of the r5
   config (6 synthetic 128³ patients, ``diffusion_sample_steps`` cut to 2 for
   wall time): both stages' ``latest``, a finite ``diffusion_chain_eval``
   row, and the same command again trains nothing; a scaled two-stage
   ladder in fp32 on the card against the CPU (loss components, every
   gradient, a 4-step ddim_sample, 2e-4); C, F and G timed at the 17→64
   stem's shapes beside the same calls with 16, 32 and 64 input channels
   (CIN_COST). Then the ladder's third stage, stage3_high (256³,
   voxel_dim 256, depth 8, 8 heads of 32, a 256-deep lifter), on a copy of
   ``diffusion_progressive.json`` with ``volume_size`` 256³ and a
   ``stage3`` entry (batch 1, stage 2's learning rate, one epoch): [15g]
   one warm-up and one timed step at batch 1 (launches DIFFUSION_STEP[3],
   every call on its tensor-core instance; peak memory), run twice from one
   state bitwise, then profiled; out of memory fails the phase after the
   allocator's numbers are logged; [15h] ``cascaded_ddim_sample`` 64³ → 128³ →
   256³ at the config's 10 steps, batch 1 (seconds and launches a stage,
   every volume finite); [15i] ``cli train`` on a one-epoch-a-stage copy
   (DIFFUSION_PATIENTS synthetic 256³ patients, 2 sampling steps), then
   again: every stage skipped. [3] and [7] hold A, C, D, F and G
   at the slice's new shapes (DIFFUSION_AT: the 17→64 stem from 64³ at
   batch 4, from 128³ at batch 2 and from 256³ at batch 1; A and D at 16 ×
   4,096² at d = 64 and 32 and at the stage-3 shapes 8 × 32,768² and 8 ×
   32,768 × 4,096), D bitwise at 16 × 4,096² × 32 among the training shapes.
16. The serving artifact: ``InferenceEngine.export_serving`` of [4]'s
   full-width cascade (bf16, max_stage=3, batch 1) and of [14]'s
   ``direct_vit`` on the card (export seconds, artifact bytes, the sidecar),
   ``load_serving`` in this process: one served call launches exactly
   EXPECTED_LAUNCHES (EXPECTED_LAUNCHES_DIRECT) and no gradient kernel, and
   its volume matches ``reconstruct``'s within 2⁻⁷·max|want| (SERVE_TOL); 5
   served calls and 5 reconstructs in turns (median ms); then a fresh
   ``python3`` process that imports only the serving loader loads the
   cascade's artifact, runs it (its volume within the same bound) and has
   imported no ``hybrid_vit_cascade_tpu_torch.models`` module. ``cli export`` on [11]'s
   entry (sidecar checked). Each number beside the card's name and power
   limit.
17. Training observability: ``cli train`` on a copy of
   ``configs/quality_r5.json`` at [5]'s widths (one epoch a stage,
   OBS_PATIENTS patients) with ``profile_dir``, ``debug_nans``, ``viz_every``
   1 and ``use_wandb`` (wandb replaced by a recording stand-in, so the real
   package is never called: an init, then each epoch's row under JAX's keys,
   OBS_WANDB_KEYS): every epoch in the JSONL, one
   Chrome trace a phase whose kernel events name A, D and the convs
   (OBS_KERNELS, the port's anonymous-namespace kernels), the figures
   written where matplotlib is installed and else the ``[viz] ... failed``
   line for every epoch while the run completes; then one stage-1 step on
   NaN X-rays with ``debug_nans`` raises FloatingPointError (the one
   exception the script expects).
18. Data-parallel training (``parallel_phase``): ``cli train`` under
   ``torchrun --standalone --nproc_per_node 1`` (an NCCL process group of
   one), in a process of its own, against the same command run plain, on a
   copy of ``configs/quality_r5.json`` at full width, stage 1 only (stages
   2-3 at 0 epochs), PARALLEL_EPOCHS epochs of one step at the config's
   batch 8 on PARALLEL_PATIENTS synthetic 256³ patients (the train and
   val ones made once, a process each, into a phantom cache under
   ``build/``). Checks: (a) the loss
   of every step and stage1/latest bitwise the plain run's; (b) every
   checkpoint entry and log row written once, by rank 0; (c) the same
   kernel launches; (d) each run's step times, printed beside the card's
   name and power limit. With two cards or more, 2 ranks against one
   process on the global batch, dropout off in both, within bf16's TOL;
   with one card the log says it did not run.
19. The flagship cascade of ``configs/progressive_h200.json`` at full width
   and depth (voxel_dim 512, 16 heads of 32, depths 4/8/12, stage 3 dense;
   bf16 over fp32 weights from a seeded torch.Generator): C, F and G at its
   token stems' new widths (in → 128 → 256 → 512 from 256³, 128³ and 64³ at
   the stages' batches), I, J and K on a training slab of the stage-3 stem,
   A and D at 2 × 16 heads over 32,768² and 32,768 × 4,096 (d = 32), each
   against its plain version in bf16, the hot ones timed (the ``h200`` entry
   of their rows); a reconstruct at batch 1 (finite (1, 1, 256³), 2 × 24
   flash forwards on the tensor cores, no gradient kernel) and REPS timed
   ones; one warm-up and one timed step of each stage at the config's batch
   8 / 4 / 2, or at the largest batch that fits, halved while a step runs
   out of memory and each failure logged with the allocator's numbers:
   finite losses, peak memory, launches per step by letter, every flash
   forward and backward and every call the rules send to a tensor-core
   instance taken there.
20. A JAX run converted by the Orbax reader's port-side half and resumed
   (``orbax_resume_phase``): on the CPU, the full-width
   ``progressive_cascade.json`` at stage 2 written as ``convert_orbax.py``
   writes it (the seeded weights in the JAX layout, converting back bitwise;
   seeded moments over stage2 + xray_encoder through ``convert.adamw_state``;
   ``latest`` and ``latest_opt`` by ``write_entry``); on the card the
   Trainer's resume into ``stage_step``'s state and one stage-2 step at
   batch 2. Checks: the epoch, step, schedule step and learning rate
   resumed; every group still fused; the step finite, launching what [9]'s
   stage-2 step launches, and bitwise the step from the same state loaded
   into a card optimizer by hand; the step's ms printed.
21. Head dims other than 32 and 64 (``head_dim_phase``): copies of
   ``configs/progressive_cascade.json`` with 16 heads of 16 and 2 heads of
   128 at every stage (HEAD_DIM_CASCADES), each a seeded checkpoint served
   by InferenceEngine (a 256³ reconstruct at batch 1: finite, A 36 times on
   the tensor cores, no gradient kernel) and one stage-3 train step at
   batch 1 with the fused backward (D) and one with the split backward (L
   and M), finite, every flash kernel on its tensor-core instance.

Every kernel in the {"kernels": ...} line carries its time, the plain
version's, the least time the card could take for the same work (bound_ms:
the larger of the bytes it must move over 3.35 TB/s and its operations over
989 TFLOP/s, the H100 SXM's HBM rate and dense bf16 peak; bound_terms_ms
holds each term, and for the flash kernels A, D, L and M also exp2_ms, one
exp2 per score over 16 a clock per SM at the card's maximum SM clock, the
special-function units' fp32 rate: informative only and not in bound_ms,
since exps computed as polynomials on the FMA units or two at a time by
ex2.approx.bf16x2 go under it) and the time of one
PyTorch call that computes the same function (library_ms: cuDNN convolution
or its weight/data gradient, scaled_dot_product_attention forward or
backward), all in bf16 at the kernel's hot shape; each row names the card
and its power limit; launches are those of the main path: the reconstruct
[4], the first step of each stage in [9], the training run of [11] (the only
one that takes L and M), the probe run of [12] (the only one that takes N),
the serving commands of [13], [14]'s direct_vit reconstruct, first train
step and entry points, [15]'s first train steps, samplers and cli train,
[16]'s two served calls, [17]'s cli train, [18]'s cli train under
torchrun, [19]'s reconstruct and first stage steps, [20]'s resumed
step and [21]'s reconstructs and steps; the rows of A, D, L and M also
carry, under ``head_dims``, for d = 16 and 128 the instance's d, their
time, plain time, bound and library time at each HEAD_DIM_AT shape, the
max_abs_err of [7h] and their launches and tensor-core launches in [21];
the rows of A and D also carry, under ``direct_vit``, their time,
plain time, bound and library time at the direct model's attention shape
and their launches in [14], and the rows of A, C, D, F and G under
``diffusion`` the same at each DIFFUSION_AT shape and their launches in
[15], and the rows of A, C, D, F and G under ``h200`` the same at the
H200_AT shape, its max_abs_err there and their launches in [19]. The probe rows are at
N = 131,072, R = 64, and their library call is cuBLAS (``torch.mm`` over
the same operands, R calls).

cuDNN and cuBLAS run with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 are set False), so the fp32 plain
versions are full fp32. The second-to-last line of the output is a
{"kernels": [...]} JSON object, the last line {"ok": true, "device": ...};
a line before them gives the script's wall; the full record goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "progressive_cascade.json"
TRAIN_CONFIG = ROOT / "configs" / "quality_r5.json"  # what the JAX package trained round 5 with
BUILD_DIR = ROOT / "build"
CKPT_DIR = BUILD_DIR / "smoke"

# |got - want| <= atol + rtol·|want|. fp32: both sides accumulate in fp32, in
# another order. bf16: both sides compute in fp32 from the same bf16 inputs
# and round once to bf16 (one ulp is 2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# Flash attention's output: its values are averages over up to 32,768 keys of
# unit-variance v, |out| ~ (e / Nk)^0.5 (0.009 at Nk = 32,768), so an
# absolute part of 2e-2 would let an output 30% off pass. The absolute part
# is scaled by the call's largest |want| instead; one bf16 ulp is at most
# 2^-7·|want|, well inside the relative part.
FLASH_OUT_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
# The flash backward kernels (D, L, M) take FLASH_OUT_TOL too: at the long
# shapes their dq, dk and dv are 0.1-0.15 at most (PERF.md §6), where TOL's
# absolute 2e-2 would be over 10% of the largest gradient. On the
# tensor cores D and M round p and ds to bf16 before their products, as the
# TPU kernels do (2^-9 relative each).
# Gradient kernels take the same bounds with the absolute part scaled by the
# largest |want| of the call: their sums run over up to 16.7 M voxels or
# 32,768 keys, so an element that cancels to near zero carries the rounding
# of terms at the full scale.
# The small-input references: fp32 end to end, tolerance of
# tests/test_parity_cascade.py:345.
SMALL_TOL = (2e-4, 2e-4)

# Per max_stage=3 forward at the default widths: flash attention in the self-
# and cross-attention of 4 + 6 + 8 blocks; dense stride-1 conv (B) = stage-1
# projection (128→256 at 16³) and stage-2 upsample conv; dense stride-2 conv
# (C) = 2 + 3 token-stem convs of stages 1-2 and the stage-3 stem's dense
# 128³ tail (2); the streamed eval schedule (one slab, every endpoint stored)
# runs the stage-3 upsample conv and the two detail convs as H and the first
# stage-3 stem conv as I, once each. On the tensor-core instances (bf16): all
# 36 flash forwards, the 128→256 projection (B), the stage-2 1→32 upsample
# conv (B, one-input-channel instance), the detail chain's 64→32 conv (H),
# the stage-3 1→32 upsample conv and the detail chain's 1→64 conv (H,
# one-input-channel instance), every dense stride-2 conv but stage 1's 1→64
# stem (C, counted in conv3d_k3s2_c1in), which takes the one-input-channel
# instance (conv3d_k3s2_c1in_tc), and the 32→64 stage-3 stem conv (I).
EXPECTED_LAUNCHES = {"flash_attention": 36, "conv3d_k3s1": 2, "conv3d_k3s2": 7,
                     "conv3d_k3s1_chain": 3, "conv3d_k3s2_chain": 1,
                     "flash_attention_tc": 36, "conv3d_k3s1_tc": 1, "conv3d_k3s1_chain_tc": 1,
                     "conv3d_k3s1_c1in_tc": 1, "conv3d_k3s1_chain_c1in_tc": 2,
                     "conv3d_k3s2_tc": 6, "conv3d_k3s2_chain_tc": 1, "conv3d_k3s2_c1in": 1,
                     "conv3d_k3s2_c1in_tc": 1}
REPS = 5  # timed reconstruct calls
TRAIN_STEPS = 3  # timed train steps per stage, after one warm-up step
TRAIN_BATCH = {1: 8, 2: 2, 3: 1}
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_FLOPS_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# fp32 exp2 per clock per SM on the special-function units (compute
# capability 9.0, CUDA C Programming Guide, arithmetic instruction
# throughput); times the SMs and the card's maximum SM clock (nvidia-smi
# clocks.max.sm) it gives the flash rows' informative exp2_ms term, one exp2
# per score. It is no lower bound: a kernel may compute exps as polynomials
# on the FMA units, or two a time by ex2.approx.bf16x2.
EXP2_PER_CLOCK_PER_SM = 16

# The 1-channel convs of the stage-3 chains at 256³ (1→32, 1→64): the
# one-input-channel forward stems and weight gradients, and the dense form of
# the one-output-channel data gradient, each timed beside its library call.
_STEMS = [(1, 1, 32, (256, 256, 256)), (1, 1, 64, (256, 256, 256))]
# The stride-2 1→64 stem of stage 1 (64³, the training batch of 8): its
# forward, data gradient and weight gradient on their tensor-core instances.
# Ragged: Cout 8 / 40 / 96 (masked, and two Cout tiles of the forward: the
# data gradient's CUDA cores), odd D, H and W, W not a multiple of 16.
_S2_STEM = (8, 1, 64, (64, 64, 64))
# The diffusion denoisers' 17→64 stride-2 stem (the noisy volume and the
# 16-channel prior) at its training batches: stage 1 at 64³ (batch 4),
# stage 2 at 128³ (batch 2); a last 16-channel chunk with one real channel
_S2_C17 = [(4, 17, 64, (64, 64, 64)), (2, 17, 64, (128, 128, 128))]
# and the ladder's stage3_high from 256³ at its batch 1 ([15g])
_S2_C17_256 = [(1, 17, 64, (256, 256, 256))]
_S2_STEM_RAGGED = [(2, 1, 8, (5, 6, 10)), (1, 1, 40, (7, 9, 35)), (2, 1, 64, (9, 7, 13))]
KERNELS = {
    "flash_attention": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/flash_attention.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py:156",
        # (BH, Nq, Nk, d): stage 1 self/cross, stage 2 self/cross, stage 3 self/cross;
        # the diffusion ladder's training forwards (stage 1 at batch 4, stage 2 at 2)
        "shapes": [(4, 4096, 4096, 64), (4, 4096, 256, 64), (8, 4096, 4096, 32),
                   (8, 4096, 1024, 32), (8, 32768, 32768, 32), (8, 32768, 4096, 32),
                   (16, 4096, 4096, 64), (16, 4096, 4096, 32)],
        "ragged": [(3, 200, 77, 32), (3, 200, 77, 64)],
        "hot": (8, 32768, 32768, 32),
    },
    "conv3d_k3s1": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
        # (B, Cin, Cout, (D, H, W))
        "shapes": [(1, 128, 256, (16, 16, 16)), (1, 64, 32, (256, 256, 256))],
        "ragged": [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10))],
        "hot": (1, 64, 32, (256, 256, 256)),
    },
    # B with one input channel: the 1→32 / 1→64 convs, dense (stage 2's
    # upsample conv at 128³ and the dense stage-3 schedule at 256³)
    "conv3d_k3s1_c1in": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:493",
        "shapes": [(1, 1, 32, (128, 128, 128)), (1, 1, 32, (256, 256, 256)),
                   (1, 1, 64, (256, 256, 256))],
        "ragged": [(2, 1, 8, (5, 6, 70)), (1, 1, 40, (5, 6, 10)), (1, 1, 96, (6, 9, 64))],
        "hot": (1, 1, 64, (256, 256, 256)),
        "counter": "conv3d_k3s1_c1in_tc",
        "library_at": _STEMS,
    },
    "conv3d_k3s2": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:225",
        "shapes": [(1, 64, 128, (32, 32, 32)),
                   (1, 32, 64, (128, 128, 128)), (1, 64, 128, (64, 64, 64)),
                   (1, 128, 256, (32, 32, 32)), (1, 32, 64, (256, 256, 256)),
                   (1, 64, 128, (128, 128, 128)), (1, 128, 256, (64, 64, 64))] + _S2_C17
                  + _S2_C17_256,
        "ragged": [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10))],
        "hot": (1, 32, 64, (256, 256, 256)),
    },
    # C with one input channel: stage 1's 1→64 stem (its tensor-core instance)
    "conv3d_k3s2_c1in": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:225",
        "shapes": [(1, 1, 64, (64, 64, 64)), _S2_STEM],
        "ragged": _S2_STEM_RAGGED + [(1, 1, 96, (6, 9, 64))],
        "hot": _S2_STEM,
        "counter": "conv3d_k3s2_c1in_tc",
    },
}

# Gradient kernels at the shapes of the training slice ([9]): stage 1 at
# batch 8, stage 2 at batch 2, stage 3 at batch 1.
_S2_GRAD_SHAPES = [(8, 64, 128, (32, 32, 32)),
                   (2, 32, 64, (128, 128, 128)), (2, 64, 128, (64, 64, 64)),
                   (2, 128, 256, (32, 32, 32)), (1, 32, 64, (256, 256, 256)),
                   (1, 64, 128, (128, 128, 128)), (1, 128, 256, (64, 64, 64))] + _S2_C17 \
    + _S2_C17_256
_RAGGED_CONV = [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10))]
# (BH, Nq, Nk, d): stage 1 self/cross, stage 2 self/cross, stage 3 self/cross
_FLASH_TRAIN_SHAPES = [(32, 4096, 4096, 64), (32, 4096, 256, 64), (16, 4096, 4096, 32),
                       (16, 4096, 1024, 32), (8, 32768, 32768, 32), (8, 32768, 4096, 32)]
_FLASH_RAGGED = [(3, 200, 77, 32), (3, 200, 77, 64)]
_SDPA_BWD = "scaled_dot_product_attention backward: dq, dk and dv together"
TRAIN_KERNELS = {
    "flash_attention_bwd": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py:399",
        # and the diffusion ladder's stage 1 at batch 4 (its stage 2 at batch 2
        # is the cascade's stage 2, (16, 4096, 4096, 32))
        "shapes": _FLASH_TRAIN_SHAPES + [(16, 4096, 4096, 64)],
        "ragged": _FLASH_RAGGED,
        "hot": (8, 32768, 32768, 32),
    },
    "flash_attention_bwd_dq": {  # L: dq of the split backward
        "source": "hybrid_vit_cascade_tpu_torch/csrc/flash_attention_bwd_split.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py:280",
        "shapes": _FLASH_TRAIN_SHAPES,
        "ragged": _FLASH_RAGGED,
        "hot": (8, 32768, 32768, 32),
    },
    "flash_attention_bwd_dkv": {  # M: dk and dv of the split backward
        "source": "hybrid_vit_cascade_tpu_torch/csrc/flash_attention_bwd_split.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/flash_attention.py:301",
        "shapes": _FLASH_TRAIN_SHAPES,
        "ragged": _FLASH_RAGGED,
        "hot": (8, 32768, 32768, 32),
    },
    "conv3d_k3s1_wgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:592",
        # (B, Cin, Cout, (D, H, W)) of the forward conv
        "shapes": [(8, 128, 256, (16, 16, 16)), (1, 64, 32, (256, 256, 256))],
        "ragged": _RAGGED_CONV,
        "hot": (1, 64, 32, (256, 256, 256)),
    },
    # E with one input channel: the 1→32 / 1→64 convs' weight gradient (its
    # counter also counts K's one-input-channel launches)
    "conv3d_k3s1_c1in_wgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:592",
        "shapes": [(2, 1, 32, (128, 128, 128)), (1, 1, 32, (256, 256, 256)),
                   (1, 1, 64, (256, 256, 256))],
        "ragged": [(2, 1, 8, (5, 6, 70)), (1, 1, 40, (5, 6, 10)), (1, 1, 96, (6, 9, 64))],
        "hot": (1, 1, 64, (256, 256, 256)),
        "counter": "conv3d_k3s1_wgrad_c1in_tc",
        "library_at": _STEMS,
    },
    "conv3d_k3s1_dgrad": {  # kernel B with flipped weights, counted on its own
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
        "shapes": [(8, 128, 256, (16, 16, 16)), (1, 1, 32, (256, 256, 256)),
                   (1, 1, 64, (256, 256, 256)), (1, 64, 32, (256, 256, 256))],
        "ragged": _RAGGED_CONV,
        "hot": (1, 64, 32, (256, 256, 256)),
        "library_at": _STEMS,
    },
    "conv3d_k3s2_dgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:396",
        "shapes": _S2_GRAD_SHAPES,
        "ragged": _RAGGED_CONV,
        "hot": (1, 32, 64, (256, 256, 256)),
    },
    "conv3d_k3s2_wgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:535",
        "shapes": _S2_GRAD_SHAPES,
        "ragged": _RAGGED_CONV,
        "hot": (1, 32, 64, (256, 256, 256)),
    },
    # F and G with one input channel: stage 1's 1→64 stem (F on its
    # one-dx-channel tensor-core instance, G on its one-input-channel one)
    "conv3d_k3s2_c1in_dgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:396",
        "shapes": [_S2_STEM], "ragged": _S2_STEM_RAGGED, "hot": _S2_STEM,
        "counter": "conv3d_k3s2_dgrad_c1in_tc",
    },
    "conv3d_k3s2_c1in_wgrad": {
        "source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
        "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:535",
        "shapes": [_S2_STEM], "ragged": _S2_STEM_RAGGED, "hot": _S2_STEM,
        "counter": "conv3d_k3s2_wgrad_c1in_tc",
    },
}


# Chain kernels H-K at the shapes of the streamed stage-3 chains at 256³:
# (B, Cin, Cout, planes of x, H, W, slab plane of x's first plane, output
# planes, Σ/Σ² epilogue, prologue act). Training, 8 slabs (sd 32 at 256³,
# 16 at 128³): the detail chain's stats pass (1→64 over 34 planes, the first
# slab's x starting at slab plane 1, the last one's ending a plane early), its
# store pass (the GN-folded 1→64 over 36 planes, then 64→32 over 34), the
# trunk's stats pass (1→32 over 34) and store pass (1→32 over 35, then I
# 32→64 from 33 planes to 16 at 128²); at batch 2 (no fold) the 64→32 and the
# stride-2 ones. Eval, 1 slab: each over the whole volume, x at slab plane 1.
# With the prologue fused (act_fuse) the 64→32 and 32→64 convs take gelu.
_CH = 256
CHAIN_SHAPES_S1 = [
    (1, 1, 64, 34, _CH, _CH, 0, 32, True, None), (1, 1, 64, 33, _CH, _CH, 1, 32, True, None),
    (1, 1, 64, 33, _CH, _CH, 0, 32, True, None), (1, 1, 64, 36, _CH, _CH, 0, 34, False, None),
    (1, 64, 32, 34, _CH, _CH, 0, 32, True, None), (1, 64, 32, 34, _CH, _CH, 0, 32, True, "gelu"),
    (1, 1, 32, 34, _CH, _CH, 0, 32, True, None), (1, 1, 32, 35, _CH, _CH, 0, 33, False, None),
    (2, 64, 32, 34, _CH, _CH, 0, 32, True, None),
    (1, 1, 64, 256, _CH, _CH, 1, 256, True, None), (1, 64, 32, 256, _CH, _CH, 1, 256, True, None),
    (1, 1, 32, 256, _CH, _CH, 1, 256, True, None)]
CHAIN_SHAPES_S2 = [
    (1, 32, 64, 33, _CH, _CH, 0, 16, True, None), (1, 32, 64, 32, _CH, _CH, 1, 16, True, None),
    (1, 32, 64, 33, _CH, _CH, 0, 16, True, "gelu"), (2, 32, 64, 33, _CH, _CH, 0, 16, True, None),
    (1, 32, 64, 256, _CH, _CH, 1, 128, True, None)]
# ragged: both volume ends, x starting before the slab, every option
CHAIN_RAGGED = [(2, 3, 5, 4, 6, 10, 2, 5, True, "gelu"), (1, 8, 40, 6, 5, 12, 0, 4, True, "silu"),
                (1, 4, 8, 5, 6, 6, -1, 3, False, "silu"), (1, 1, 64, 9, 16, 16, 0, 8, True, None)]
CHAIN_RAGGED_S2 = [(2, 3, 5, 4, 6, 10, 2, 3, True, "silu"), (1, 8, 40, 6, 5, 12, 0, 2, True, "gelu"),
                   (1, 4, 8, 5, 6, 6, -1, 2, False, None)]
_HOT_S1 = (1, 64, 32, 256, _CH, _CH, 1, 256, True, None)  # the eval 64→32, whole volume
_HOT_S2 = (1, 32, 64, 256, _CH, _CH, 1, 128, True, None)
_TRAIN_S1 = (1, 64, 32, 34, _CH, _CH, 0, 32, True, None)  # one training slab
_TRAIN_S1_GELU = (1, 64, 32, 34, _CH, _CH, 0, 32, True, "gelu")  # the same, prologue fused
_TRAIN_S2 = (1, 32, 64, 33, _CH, _CH, 0, 16, True, None)
_TRAIN_S2_GELU = (1, 32, 64, 33, _CH, _CH, 0, 16, True, "gelu")  # the same, prologue fused
# The one-output-channel data gradient: 64→1 over the whole volume (hot), 32→1
# likewise, and the training slabs of the two store passes (1→64 over 36
# planes, 1→32 over 35); ragged: g's channels 8 and 40 (not multiples of 16),
# H, W off the 4 × 64 tile, x before the slab, more planes than a block's 32,
# act′ gelu and silu.
_HOT_C1 = (1, 1, 64, 256, _CH, _CH, 1, 256, True, None)
_TRAIN_C1 = (1, 1, 64, 36, _CH, _CH, 0, 34, False, None)
_TIMED_C1 = [(1, 1, 32, 256, _CH, _CH, 1, 256, True, None), _TRAIN_C1,
             (1, 1, 32, 35, _CH, _CH, 0, 33, False, None)]
CHAIN_RAGGED_C1 = [(1, 1, 8, 35, 9, 66, 1, 35, False, None), (2, 1, 40, 5, 6, 20, -1, 7, False, "gelu"),
                   (1, 1, 24, 4, 5, 70, 2, 3, False, "silu")]
# The one-input-channel chain conv: the stats slabs (1→64 over 34 planes,
# 1→32 over 34) and store slabs (1→64 over 36, 1→32 over 35) of training;
# ragged: Cout 8 / 40 / 96 (masked and two Cout tiles), W off the 64-column
# tile and not a multiple of 8, x before the slab, every option.
_TIMED_C1IN = [(1, 1, 64, 34, _CH, _CH, 0, 32, True, None), _TRAIN_C1,
               (1, 1, 32, 34, _CH, _CH, 0, 32, True, None), (1, 1, 32, 35, _CH, _CH, 0, 33, False, None)]
CHAIN_RAGGED_C1IN = [(2, 1, 8, 5, 6, 70, -1, 7, True, "gelu"), (1, 1, 40, 6, 5, 33, 2, 6, True, "silu"),
                     (1, 1, 96, 9, 4, 64, 0, 9, True, None)]
CHAIN_KERNELS = {
    "conv3d_k3s1_chain": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
                          "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
                          "shapes": [s for s in CHAIN_SHAPES_S1 if s[1] > 1],
                          "ragged": CHAIN_RAGGED[:3], "hot": _HOT_S1, "timed": [_TRAIN_S1]},
    # H with one input channel: the 1→64 and 1→32 chain convs
    "conv3d_k3s1_chain_c1in": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
                               "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:493",
                               "shapes": [s for s in CHAIN_SHAPES_S1 if s[1] == 1],
                               "ragged": CHAIN_RAGGED[3:] + CHAIN_RAGGED_C1IN, "hot": _HOT_C1,
                               "timed": _TIMED_C1IN, "counter": "conv3d_k3s1_chain_c1in_tc",
                               "library_at": _TIMED_C1IN},
    "conv3d_k3s1_chain_dgrad": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
                                "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
                                "shapes": [s for s in CHAIN_SHAPES_S1 if s[1] > 1],
                                "ragged": CHAIN_RAGGED[:3], "hot": _HOT_S1, "timed": [_TRAIN_S1]},
    # H with one output channel: the data gradient of the 1→64 and 1→32 convs
    "conv3d_k3s1_chain_c1_dgrad": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
                                   "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:439",
                                   "shapes": [s for s in CHAIN_SHAPES_S1 if s[1] == 1],
                                   "ragged": CHAIN_RAGGED[3:] + CHAIN_RAGGED_C1, "hot": _HOT_C1,
                                   "timed": _TIMED_C1, "counter": "conv3d_k3s1_chain_dgrad_c1_tc",
                                   "library_at": _TIMED_C1},
    "conv3d_k3s1_chain_wgrad": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
                                "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3.py:592",
                                "shapes": CHAIN_SHAPES_S1, "ragged": CHAIN_RAGGED,
                                "hot": _HOT_S1, "timed": [_TRAIN_S1, _TRAIN_S1_GELU]},
    "conv3d_k3s2_chain": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3.cu",
                          "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:225",
                          "shapes": CHAIN_SHAPES_S2, "ragged": CHAIN_RAGGED_S2, "hot": _HOT_S2,
                          "timed": [_TRAIN_S2]},
    "conv3d_k3s2_chain_dgrad": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
                                "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:396",
                                "shapes": CHAIN_SHAPES_S2, "ragged": CHAIN_RAGGED_S2,
                                "hot": _HOT_S2, "timed": [_TRAIN_S2]},
    "conv3d_k3s2_chain_wgrad": {"source": "hybrid_vit_cascade_tpu_torch/csrc/conv3d_k3_bwd.cu",
                                "replaces": "hybrid_vit_cascade_tpu/ops/pallas/conv3d_k3s2.py:535",
                                "shapes": CHAIN_SHAPES_S2, "ragged": CHAIN_RAGGED_S2,
                                "hot": _HOT_S2, "timed": [_TRAIN_S2]},
}
# The chain kernels' letter counters (H-K): the one-output-channel data
# gradient counts under H's (conv3d_k3s1_chain_dgrad) and, on its tensor-core
# instance, under its own counter.
_CHAIN_LETTERS = tuple(k for k, spec in CHAIN_KERNELS.items() if "counter" not in spec)
# The chain phase [10]: values and gradients of the streamed chains against
# the dense chain, fp32, absolute part scaled by the largest |want|.
CHAIN_TOL = (2e-4, 2e-4)

# The probe phase [12]: kernel family N, one row per TPU probe function (V0
# is make_v1 at m = 256, counted and listed under conv_probe_v1). Both sides
# sum the same bf16 products in fp32, in another order: |got - want| <=
# atol·max|want| + rtol·|want|. Ragged N: rows of P / X not 16-byte aligned
# (77) and aligned with a ragged last tile (2,120).
PROBE_SOURCE = "hybrid_vit_cascade_tpu_torch/csrc/conv_probe.cu"
PROBE_TOL = (1e-4, 1e-4)
PROBE_RAGGED_N = (77, 2120)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernels ---

def _inputs(name: str, shape, dtype, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    if name == "flash_attention":
        bh, nq, nk, d = shape
        q = torch.randn((bh, nq, d), generator=g, device=dev).to(dtype)
        k = torch.randn((bh, nk, d), generator=g, device=dev).to(dtype)
        v = torch.randn((bh, nk, d), generator=g, device=dev).to(dtype)
        return (q, k, v, d ** -0.5)
    b, cin, cout, dhw = shape
    x = torch.randn((b, cin, *dhw), generator=g, device=dev).to(dtype)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5).to(dtype)
    bias = 0.1 * torch.randn((cout,), generator=g, device=dev)
    return (x, w, bias)


def _fns(name: str):
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    if name == "flash_attention":
        return fa.flash_attention_fwd, fa.flash_attention_plain
    s = 2 if name.startswith("conv3d_k3s2") else 1
    return (lambda x, w, b: ck.conv3d_k3(x, w, b, s, 1, (x.shape[2] - 1) // s + 1, dense=True),
            lambda x, w, b: ck.conv3d_k3_plain(x, w, b, s, 1, (x.shape[2] - 1) // s + 1))


def check_kernels(dev, seed: int, specs: dict, inputs, fns, scaled: bool = False,
                  dtypes: tuple = (torch.bfloat16, torch.float32)) -> dict:
    """Phases 3 and 7: every kernel of ``specs`` against its plain version at
    every shape, in each of ``dtypes``; returns the max error per kernel. Each
    output is held to the tolerance of its own dtype (flash attention's lse
    and the weight gradients are fp32); ``scaled`` multiplies the absolute
    part by the largest |want| of the call, as FLASH_OUT_TOL always does for
    flash attention's output."""
    worst = {}
    for name, spec in specs.items():
        kern, plain = fns(name)
        worst[name] = 0.0
        for shape in spec["shapes"] + spec["ragged"]:
            for dtype in dtypes:
                args = inputs(name, shape, dtype, dev, seed)
                got, want = kern(*args), plain(*args)
                if not isinstance(got, tuple):
                    got, want = (got,), (want,)
                torch.cuda.synchronize()
                for i, (g, w) in enumerate(zip(got, want)):
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(f"{name} {shape}: {g.shape}/{g.dtype} vs "
                                             f"{w.shape}/{w.dtype}")
                    flash_out = (name == "flash_attention" and i == 0) or \
                        name.startswith("flash_attention_bwd")
                    atol, rtol = (FLASH_OUT_TOL if flash_out else TOL)[w.dtype]
                    diff = (g.float() - w.float()).abs()
                    err = float(diff.max())
                    scale = (float(w.float().abs().max()) if flash_out else
                             max(1.0, float(w.float().abs().max())) if scaled else 1.0)
                    ok = bool(torch.isfinite(g.float()).all()) and bool(
                        (diff <= atol * scale + rtol * w.float().abs()).all())
                    log(f"  {name:19s} {str(shape):32s} {str(dtype):15s} out{i} "
                        f"max_abs_err={err:.3e} tol={atol:g}·{scale:.3g}+{rtol:g}|ref| "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its plain version at "
                                             f"{shape} {dtype}: max_abs_err {err}")
                    worst[name] = max(worst[name], err)
                del args, got, want
    return worst


def _once(fn, args) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _time_pair(kern, plain, args) -> tuple[float, float]:
    """Medians of the CUDA-event times of kernel and plain version, in turns
    plain, kernel, kernel, plain, after a warm-up of each."""
    kern(*args), plain(*args)
    t_k, t_p = [], []
    for _ in range(3):
        t_p.append(_once(plain, args))
        t_k.append(_once(kern, args))
        t_k.append(_once(kern, args))
        t_p.append(_once(plain, args))
    return statistics.median(t_k), statistics.median(t_p)


def time_kernels(dev, seed: int, specs: dict, inputs, fns) -> dict:
    """Phases 6b and 7b: each kernel beside its plain version at every shape
    of its spec, bf16 (the main path's dtype)."""
    rows = {}
    for name, spec in specs.items():
        kern, plain = fns(name)
        for shape in spec["shapes"]:
            args = inputs(name, shape, torch.bfloat16, dev, seed)
            ms, plain_ms = _time_pair(kern, plain, args)
            rows[(name, shape)] = (ms, plain_ms)
            log(f"  {name:19s} {str(shape):32s} bf16 kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms")
            del args
    return rows


# -------------------------------------------------------- gradient kernels ---

def _train_inputs(name: str, shape, dtype, dev, seed: int):
    """Arguments of a gradient kernel and of its plain version."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    if name.startswith("flash_attention_bwd"):
        bh, nq, nk, d = shape
        q, dout = (torch.randn((bh, nq, d), generator=g, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((bh, nk, d), generator=g, device=dev).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention_plain(q, k, v, d ** -0.5)
        return (q, k, v, out, lse, dout, d ** -0.5)
    b, cin, cout, dhw = shape
    stride = 2 if "s2" in name else 1
    odhw = tuple((n - 1) // stride + 1 for n in dhw)
    gy = torch.randn((b, cout, *odhw), generator=g, device=dev).to(dtype)
    if name.endswith("wgrad"):
        return (torch.randn((b, cin, *dhw), generator=g, device=dev).to(dtype), gy)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5).to(dtype)
    # the data gradient reads only x's shape (x's values only for act′)
    return (gy, w, torch.empty((b, cin, *dhw), dtype=dtype, device=dev))


def _train_fns(name: str):
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    if name == "flash_attention_bwd":
        return fa.flash_attention_bwd, fa.flash_attention_bwd_plain
    if name == "flash_attention_bwd_dq":
        return (lambda *a: (fa.flash_attention_bwd_dq(*a),),
                lambda *a: (fa.flash_attention_bwd_plain(*a)[0],))
    if name == "flash_attention_bwd_dkv":
        return fa.flash_attention_bwd_dkv, lambda *a: fa.flash_attention_bwd_plain(*a)[1:]
    s = 2 if "s2" in name else 1
    if name.endswith("dgrad"):
        return (lambda g, w, x: ck.conv3d_k3_dgrad(g, w, x, s, 1, dense=True),
                lambda g, w, x: ck.conv3d_k3_dgrad_plain(g, w, x, s, 1))
    return (lambda x, g: ck.conv3d_k3_wgrad(x, g, s, 1, dense=True),
            lambda x, g: ck.conv3d_k3_wgrad_plain(x, g, s, 1))


# ----------------------------------------------------------- chain kernels ---

def _chain_stride(name: str) -> int:
    return 2 if name.startswith("conv3d_k3s2") else 1


def _chain_inputs(name: str, shape, dtype, dev, seed: int):
    """Arguments of a chain kernel and of its plain version; x is a
    D-narrowed view of a larger tensor, as the slab bodies pass it."""
    b, cin, cout, nv, h, w, qlo, d_out, sums, act = shape
    stride = _chain_stride(name)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, cin, nv + 2, h, w), generator=g, device=dev).to(dtype).narrow(2, 1, nv)
    wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) / (27 * cin) ** 0.5).to(dtype)
    if not name.endswith(("dgrad", "wgrad")):
        return (x, wt, 0.1 * torch.randn((cout,), generator=g, device=dev), qlo, d_out, sums, act)
    ho, wo = ((n - 1) // stride + 1 for n in (h, w))
    gy = torch.randn((b, cout, d_out, ho, wo), generator=g, device=dev).to(dtype)
    return (gy, wt, x, qlo, act) if name.endswith("dgrad") else (x, gy, qlo, act)


def _chain_fns(name: str):
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck

    s = _chain_stride(name)
    if name.endswith("dgrad"):
        return (lambda g, w, x, qlo, act: ck.conv3d_k3_dgrad(g, w, x, s, qlo, act),
                lambda g, w, x, qlo, act: ck.conv3d_k3_dgrad_plain(g, w, x, s, qlo, act))
    if name.endswith("wgrad"):
        return (lambda x, g, qlo, act: ck.conv3d_k3_wgrad(x, g, s, qlo, act),
                lambda x, g, qlo, act: ck.conv3d_k3_wgrad_plain(x, g, s, qlo, act))
    return (lambda x, w, b, qlo, d, sums, act: ck.conv3d_k3(x, w, b, s, qlo, d, sums, act),
            lambda x, w, b, qlo, d, sums, act: ck.conv3d_k3_plain(x, w, b, s, qlo, d, sums, act))


def check_chain_kernels(dev, seed: int) -> dict:
    """Phase 3b: H-K against their plain versions at every chain shape, bf16
    and fp32. Outputs take TOL of their dtype; the gradients TOL with the
    absolute part scaled by the largest |want| (as [7]); the Σ/Σ² sums
    |Δ| ≤ rtol·Σ|out| (resp. Σ out²), rtol that of the output's dtype — the
    two outputs may differ by rounding in every voxel at most."""
    worst = {}
    for name, spec in CHAIN_KERNELS.items():
        kern, plain = _chain_fns(name)
        scaled = name.endswith(("dgrad", "wgrad"))
        worst[name] = 0.0
        for shape in spec["shapes"] + spec["ragged"]:
            for dtype in (torch.bfloat16, torch.float32):
                args = _chain_inputs(name, shape, dtype, dev, seed)
                got, want = kern(*args), plain(*args)
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                torch.cuda.synchronize()
                out_ref = want[0].float()
                errs = []
                for i, (g, w) in enumerate(zip(got, want)):
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(f"{name} {shape}: {g.shape}/{g.dtype} vs "
                                             f"{w.shape}/{w.dtype}")
                    diff = (g.float() - w.float()).abs()
                    if i == 0:
                        atol, rtol = TOL[w.dtype]
                        scale = max(1.0, float(w.float().abs().max())) if scaled else 1.0
                        bound = atol * scale + rtol * w.float().abs()
                    else:  # Σ (i = 1) and Σ² (i = 2) per (B, Cout)
                        mag = out_ref.abs() if i == 1 else out_ref * out_ref
                        bound = TOL[want[0].dtype][1] * mag.sum(dim=(2, 3, 4)) + 1e-5
                    ok = bool(torch.isfinite(g.float()).all()) and bool((diff <= bound).all())
                    errs.append(float(diff.max()))
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its plain version at "
                                             f"{shape} {dtype} out{i}: max_abs_err {errs[-1]}")
                log(f"  {name:24s} {str(shape):58s} {str(dtype):15s} max_abs_err "
                    f"{', '.join(f'{e:.2e}' for e in errs)} ok")
                worst[name] = max(worst[name], errs[0])
                del args, got, want
    return worst


# --------------------------------------------- bounds and library yardsticks ---

def _conv_geom(name: str, shape):
    """(B, Cin, Cout, input planes read, output planes, H, W, stride, act) of
    a conv kernel's shape, dense or chain."""
    stride = 2 if "s2" in name else 1
    if "chain" in name:
        b, cin, cout, nv, h, w, _, d_out, _, act = shape
        return b, cin, cout, nv, d_out, h, w, stride, act
    b, cin, cout, (d, h, w) = shape
    return b, cin, cout, d, (d - 1) // stride + 1, h, w, stride, None


def bound(name: str, shape, itemsize: int = 2, exp2_rate: float = 0.0,
          peak_flops: float = PEAK_FLOPS):
    """(bound_ms, bound_by, terms) at bf16 (``itemsize`` 2; 4 for fp32, with
    ``peak_flops`` the fp32 rate): the larger of the bytes the function must
    move (each input read once, each output written once) over PEAK_BYTES and
    its multiply-adds (2 operations each) over ``peak_flops``; for
    the flash kernels (A, D, L, M each compute every score's exp2 once)
    ``terms`` also holds the exp2s over ``exp2_rate`` (per second, the
    special-function units' fp32 rate) as exp2_ms, which is informative and
    not part of the bound: exps computed as polynomials on the FMA units or
    by ex2.approx.bf16x2 go under it. ``terms`` holds each term in ms. A
    probe kernel's shape is its case name (V1 ...), at N = 131,072 and R = 64
    passes."""
    if name.startswith("conv_probe"):
        from hybrid_vit_cascade_tpu_torch.scripts import bench_conv_probe as bench

        b_ms, b_by = bench.bound(bench.BY_KEY[shape], bench.N_TOTAL, bench.R)
        return b_ms, b_by, {}
    n_exp = 0.0
    if name.startswith("flash"):
        bh, nq, nk, d = shape
        if name == "flash_attention":  # q, k, v in; out, lse out
            flops = 4.0 * bh * nq * nk * d
            nbytes = itemsize * (2 * bh * nq * d + 2 * bh * nk * d) + 4 * bh * nq
        elif name == "flash_attention_bwd_dq":  # q, k, v, out, dout, lse in; dq out
            flops = 6.0 * bh * nq * nk * d
            nbytes = itemsize * (4 * bh * nq * d + 2 * bh * nk * d) + 4 * bh * nq
        elif name == "flash_attention_bwd_dkv":  # q, k, v, out, dout, lse in; dk, dv out
            flops = 8.0 * bh * nq * nk * d
            nbytes = itemsize * (3 * bh * nq * d + 4 * bh * nk * d) + 4 * bh * nq
        else:  # q, k, v, out, dout, lse in; dq, dk, dv out
            flops = 10.0 * bh * nq * nk * d
            nbytes = itemsize * (4 * bh * nq * d + 4 * bh * nk * d) + 4 * bh * nq
        n_exp = float(bh) * nq * nk
    else:
        b, cin, cout, d_in, d_out, h, w, stride, act = _conv_geom(name, shape)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        n_in, n_out = b * cin * d_in * h * w, b * cout * d_out * ho * wo
        flops = 2.0 * 27 * cin * n_out
        wbytes = itemsize * 27 * cin * cout
        if name.endswith("wgrad"):  # x, g in; dW fp32 out
            nbytes = itemsize * (n_in + n_out) + 2 * wbytes
        elif name.endswith("dgrad"):  # g, w in (x too with act′); dx out
            nbytes = itemsize * (n_out + n_in * (2 if act else 1)) + wbytes
        else:  # x, w, bias in; out (+ sums) out
            nbytes = itemsize * (n_in + n_out) + wbytes + 4 * cout * 3 * b
    terms = {"products_ms": flops / peak_flops * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    if n_exp:
        terms["exp2_ms"] = n_exp / exp2_rate * 1e3
    return ((terms["products_ms"], "operations", terms)
            if terms["products_ms"] >= terms["bytes_ms"] else (terms["bytes_ms"], "bytes", terms))


def _median_ms(fn, reps: int = 5) -> float:
    fn()
    ts = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def library_ms(name: str, shape, dev, seed: int, dt: torch.dtype = torch.bfloat16):
    """The time of one PyTorch call computing the kernel's function at its
    hot shape, in bf16 unless ``dt`` says otherwise (cuDNN convolution or its
    data / weight gradient, scaled_dot_product_attention forward or
    backward). For the chain convs the call runs over the slab with its zero
    planes in place and computes no Σ/Σ² (kernels H, I take them in the same
    pass)."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    if name.startswith("flash"):
        bh, nq, nk, d = shape
        q = torch.randn((1, bh, nq, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((1, bh, nk, d), generator=g, device=dev).to(dt) for _ in range(2))
        if name == "flash_attention":
            return _median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        dout = torch.randn_like(out)
        return _median_ms(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True))
    b, cin, cout, d_in, d_out, h, w, stride, _ = _conv_geom(name, shape)
    if "chain" in name:
        d_in = stride * (d_out - 1) + 3  # the slab with its halo planes
        pad = (0, 1, 1)
    else:
        pad = 1
    x = torch.randn((b, cin, d_in, h, w), generator=g, device=dev).to(dt)
    wt = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev).to(dt)
    gy = F.conv3d(x, wt, stride=stride, padding=pad)
    if name.endswith("wgrad"):
        return _median_ms(lambda: torch.nn.grad.conv3d_weight(x, wt.shape, gy, stride=stride,
                                                              padding=pad))
    if name.endswith("dgrad"):
        return _median_ms(lambda: torch.nn.grad.conv3d_input(x.shape, wt, gy, stride=stride,
                                                             padding=pad))
    bias = torch.randn((cout,), generator=g, device=dev).to(dt)
    return _median_ms(lambda: F.conv3d(x, wt, bias, stride=stride, padding=pad))


def _dgrad_launch_ms(g, w, x_shape, reps: int = 20) -> float:
    """The mean time of ``reps`` back-to-back launches of F's C entry point
    (``hvc_conv3d_k3s2_dgrad``, dense: qlo 1, no act′) into one preallocated
    dx between one pair of CUDA events: the kernel's time a launch without
    the wrapper's host work. The wrapper's counters do not see them."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck

    b, cin, nv, h, w_ = x_shape
    dx = torch.empty(x_shape, dtype=g.dtype, device=g.device)
    fn = _build.function("hvc_conv3d_k3s2_dgrad", ck._DGRAD_ARGTYPES)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    args = (g.data_ptr(), w.data_ptr(), None, dx.data_ptr(), b, cin, w.shape[0], nv, h, w_,
            g.shape[2], 1, 0, None, 0, 0, ck._DTYPE_CODES[g.dtype], stream)
    _build.check(fn(*args), "hvc_conv3d_k3s2_dgrad")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        _build.check(fn(*args), "hvc_conv3d_k3s2_dgrad")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fp32_stem_dgrad(dev, seed: int) -> dict:
    """Phase 7d: the stride-2 1→64 stem's data gradient in fp32 (8 × 1→64, g
    32³ → dx 64³, and the stem's ragged shapes), which takes the one-dx-channel
    kernel's fp32 form dgrad_s2_c1_f32_kernel (instance 3 of
    ``dgrad_s2_instance``: CUDA-core FMAs, TF32 would leave the fp32
    tolerance): one launch each on its counter and none on
    dgrad_s2_kernel<float>, held to its plain version at TOL[fp32] with the
    absolute part scaled by the largest |want| (as [7]), two runs bitwise
    equal; then timed beside it by CUDA events around the wrapper and a
    launch at a time (``ms_per_launch``), with its bound (bytes; products at
    the fp32 rate) and conv3d_input in fp32 (TF32 off)."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck

    name, shape = "conv3d_k3s2_c1in_dgrad", _S2_STEM
    kern, plain = _train_fns(name)
    counters = ("conv3d_k3s2_dgrad_c1in", "conv3d_k3s2_dgrad_c1in_tc",
                "conv3d_k3s2_dgrad_c1in_fp32")
    atol, rtol = TOL[torch.float32]
    worst = 0.0
    for at in [shape] + _S2_STEM_RAGGED:
        args = _train_inputs(name, at, torch.float32, dev, seed)
        before = {k: ck.LAUNCHES[k] for k in counters}
        got = kern(*args)
        took = {k: ck.LAUNCHES[k] - before[k] for k in counters}
        if ck.dgrad_s2_instance(torch.float32, at[1], at[2]) != ck.DGRAD_S2_C1_FP32 or \
                took != {"conv3d_k3s2_dgrad_c1in": 1, "conv3d_k3s2_dgrad_c1in_tc": 0,
                         "conv3d_k3s2_dgrad_c1in_fp32": 1}:
            raise AssertionError(f"[7] the fp32 stem dgrad at {at} did not take "
                                 f"dgrad_s2_c1_f32_kernel alone: {took}")
        want, again = plain(*args), kern(*args)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err, scale = float(diff.max()), max(1.0, float(want.abs().max()))
        ok = bool(torch.isfinite(got).all()) and bool(
            (diff <= atol * scale + rtol * want.abs()).all()) and torch.equal(got, again)
        log(f"[7] {name} {at} fp32 (dgrad_s2_c1_f32_kernel) max_abs_err={err:.3e} "
            f"tol={atol:g}·{scale:.3g}+{rtol:g}|ref| bitwise {torch.equal(got, again)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[7] the fp32 stem dgrad at {at} disagrees with its plain "
                                 f"version or is not repeatable: {err}")
        worst = max(worst, err)
        del args, got, want, again
    args = _train_inputs(name, shape, torch.float32, dev, seed)
    ms, plain_ms = _time_pair(kern, plain, args)
    per_launch = _dgrad_launch_ms(args[0], args[1], tuple(args[2].shape))
    b_ms, b_by, terms = bound(name, shape, itemsize=4, peak_flops=PEAK_FLOPS_FP32)
    lib = library_ms(name, shape, dev, seed, torch.float32)
    log(f"[7] {name} {shape} fp32 kernel {ms:.4f} ms by events, {per_launch:.4f} a launch  "
        f"plain {plain_ms:.4f}  bound {b_ms:.4f} ({b_by})  conv3d_input fp32 {lib:.4f}")
    return {"at": f"{shape} fp32", "instance": "dgrad_s2_c1_f32_kernel, the one-dx-channel "
            "kernel's fp32 form on the CUDA cores (instance 3 of dgrad_s2_instance)",
            "counter": "conv3d_k3s2_dgrad_c1in_fp32", "ms": ms, "ms_per_launch": per_launch,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_terms_ms": terms,
            "library_ms": lib, "library_call": "torch.nn.grad.conv3d_input fp32, TF32 off",
            "max_abs_err": worst}


def time_chain_kernels(dev, seed: int) -> dict:
    """Phase 7c: H-K beside their plain versions, bf16, at the hot (eval,
    whole volume) and training-slab shapes."""
    rows = {}
    for name, spec in CHAIN_KERNELS.items():
        kern, plain = _chain_fns(name)
        for shape in [spec["hot"]] + spec["timed"]:
            args = _chain_inputs(name, shape, torch.bfloat16, dev, seed)
            ms, plain_ms = _time_pair(kern, plain, args)
            rows[(name, shape)] = (ms, plain_ms)
            log(f"  {name:24s} {str(shape):58s} bf16 kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms")
            del args
    return rows


# -------------------------------------------------------------- the chains ---

class force_streaming:
    """Within the block, the cascade's streamed chain schedule streams every
    level (dense_max_voxels=0): at the scaled sizes of [5] and [8] every level
    fits the dense tail, so the slab bodies would otherwise not run."""

    def __enter__(self):
        import functools

        from hybrid_vit_cascade_tpu_torch.models import cascade

        self.real = cascade.chain_apply_streamed
        cascade.chain_apply_streamed = functools.partial(self.real, dense_max_voxels=0)

    def __exit__(self, *exc):
        from hybrid_vit_cascade_tpu_torch.models import cascade

        cascade.chain_apply_streamed = self.real


# The tensor-core counters of the kernels whose rule depends on the call's
# channels (F/J, the one-output-channel B/H, the one-input-channel B/H, C/I,
# E/K and G/K, the one-dx-channel F/J) or dtype (L, M), which [9] and [11]
# hold to the calls the rules name.
_RULE_COUNTERS = ("conv3d_k3s2_dgrad_tc", "conv3d_k3s2_chain_dgrad_tc",
                  "flash_attention_bwd_dkv_tc", "flash_attention_bwd_dq_tc",
                  "conv3d_k3s1_dgrad_c1_tc", "conv3d_k3s1_chain_dgrad_c1_tc",
                  "conv3d_k3s1_c1in_tc", "conv3d_k3s1_chain_c1in_tc", "conv3d_k3s1_wgrad_c1in_tc",
                  "conv3d_k3s2_c1in_tc", "conv3d_k3s2_dgrad_c1in_tc", "conv3d_k3s2_wgrad_c1in_tc")


class rule_calls:
    """Within the block, count per tensor-core counter the calls of F/J
    (``conv3d_k3._dgrad_s2``), M (``flash_attention._bwd_dkv``), L
    (``flash_attention._bwd_dq``), the conv with one output or one input
    channel (``conv3d_k3._fwd``) and the weight gradient with one input
    channel (``conv3d_k3._wgrad``) that the Python rules
    (``dgrad_s2_instance``, ``bwd_dkv_uses_tensor_cores``,
    ``bwd_dq_uses_tensor_cores``, ``dgrad_c1_uses_tensor_cores``,
    ``fwd_c1in_uses_tensor_cores``, ``wgrad_instance``) send to the tensor
    cores, and in ``c1in_bf16`` every bf16 forward (``fwd`` at stride 1,
    ``fwd_s2`` at stride 2), weight gradient (``wgrad``, ``wgrad_s2``) and
    stride-2 data gradient (``dgrad_s2``) with one input channel, whatever
    the rules say: the wrappers' launch functions are wrapped, so every call
    on the path is seen."""

    def __enter__(self):
        from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
        from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

        self.n = dict.fromkeys(_RULE_COUNTERS, 0)
        self.c1in_bf16 = {"fwd": 0, "wgrad": 0, "fwd_s2": 0, "dgrad_s2": 0, "wgrad_s2": 0}
        self.real = real_d, real_m, real_l, real_f, real_w = (ck._dgrad_s2, fa._bwd_dkv, fa._bwd_dq,
                                                               ck._fwd, ck._wgrad)

        def dgrad(g, w, x_shape, qlo, dact=None, dense=False):
            inst = ck.dgrad_s2_instance(g.dtype, x_shape[1], w.shape[0], dact is not None)
            if inst == ck.DGRAD_S2_TC:
                self.n[_RULE_COUNTERS[0] if dense else _RULE_COUNTERS[1]] += 1
            elif inst == ck.DGRAD_S2_C1_TC:
                self.n["conv3d_k3s2_dgrad_c1in_tc"] += 1
            if x_shape[1] == 1 and g.dtype == torch.bfloat16:
                self.c1in_bf16["dgrad_s2"] += 1
            return real_d(g, w, x_shape, qlo, dact=dact, dense=dense)

        def dkv(q, *args):
            self.n[_RULE_COUNTERS[2]] += fa.bwd_dkv_uses_tensor_cores(q.dtype)
            return real_m(q, *args)

        def dq(q, *args):
            self.n[_RULE_COUNTERS[3]] += fa.bwd_dq_uses_tensor_cores(q.dtype)
            return real_l(q, *args)

        def fwd(entry, stride, x, w, bias, qlo, d_out, want_sums=False, act=None, dact=None,
                dense=False):
            cin, cout = x.shape[1], w.shape[0]
            if stride == 1 and ck.dgrad_c1_uses_tensor_cores(x.dtype, cin, cout, act, want_sums):
                self.n[_RULE_COUNTERS[4] if dense else _RULE_COUNTERS[5]] += 1
            if ck.fwd_c1in_uses_tensor_cores(x.dtype, stride, cin, cout, dact is not None):
                s1 = _RULE_COUNTERS[6] if dense else _RULE_COUNTERS[7]
                self.n[s1 if stride == 1 else "conv3d_k3s2_c1in_tc"] += 1
            if cin == 1 and x.dtype == torch.bfloat16:
                self.c1in_bf16["fwd" if stride == 1 else "fwd_s2"] += 1
            return real_f(entry, stride, x, w, bias, qlo, d_out, want_sums, act, dact, dense)

        def wgrad(entry, stride, x, g, qlo, act=None):
            if ck.wgrad_instance(x.dtype, stride, x.shape[1]) in (ck.WGRAD_C1IN_TC,
                                                                  ck.WGRAD_C1IN_S2_TC):
                self.n[f"conv3d_k3s{stride}_wgrad_c1in_tc"] += 1
            if x.shape[1] == 1 and x.dtype == torch.bfloat16:
                self.c1in_bf16["wgrad" if stride == 1 else "wgrad_s2"] += 1
            return real_w(entry, stride, x, g, qlo, act)

        ck._dgrad_s2, fa._bwd_dkv, fa._bwd_dq, ck._fwd, ck._wgrad = dgrad, dkv, dq, fwd, wgrad
        return self

    def __exit__(self, *exc):
        from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
        from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

        ck._dgrad_s2, fa._bwd_dkv, fa._bwd_dq, ck._fwd, ck._wgrad = self.real


def check_c1in(launched: dict, calls: dict, where: str) -> None:
    """Every bf16 conv and weight gradient at either stride and every bf16
    stride-2 data gradient with one input channel (``calls``:
    ``rule_calls.c1in_bf16``) launched its one-input-channel (one-dx-channel)
    tensor-core instance."""
    got = {"fwd": launched["conv3d_k3s1_c1in_tc"] + launched["conv3d_k3s1_chain_c1in_tc"],
           "wgrad": launched["conv3d_k3s1_wgrad_c1in_tc"],
           "fwd_s2": launched["conv3d_k3s2_c1in_tc"],
           "dgrad_s2": launched["conv3d_k3s2_dgrad_c1in_tc"],
           "wgrad_s2": launched["conv3d_k3s2_wgrad_c1in_tc"]}
    if got != calls:
        raise AssertionError(f"{where}: launches on the one-input-channel instances {got}, for "
                             f"{calls} bf16 calls with one input channel")


def chain_phase(dev, seed: int, size: int = 256) -> dict:
    """Phase 10: the full-width size³ detail and trunk chains, streamed,
    against the dense chain on the card, fp32: values and every gradient."""
    from hybrid_vit_cascade_tpu_torch.models.cascade import DetailEnhancer, Stage3ViTTrunk
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.slab import chain_apply_dense, chain_apply_streamed

    torch.manual_seed(seed)
    chains = {"detail": seeded_init_(DetailEnhancer(), seed).to(dev).chain(),
              "trunk": seeded_init_(Stage3ViTTrunk((size,) * 3, 256, 1, 8, 512), seed)
              .to(dev).chain()}
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    x = torch.randn((1, 1, size, size, size), generator=g, device=dev)
    runs = {"8 slabs": dict(num_slabs=8), "8 slabs, act fused": dict(num_slabs=8, act_fuse=True),
            "1 slab store-all": dict(num_slabs=1, store_min_flops=0.0),
            "1 slab store-all, act fused": dict(num_slabs=1, store_min_flops=0.0,
                                                act_fuse=True)}
    atol, rtol = CHAIN_TOL
    out, failed = {}, []
    for cname, chain in chains.items():
        arrs = [t for op in chain for t in op[1:] if isinstance(t, torch.Tensor)]
        xr = x.clone().requires_grad_()
        want = chain_apply_dense(xr, chain)
        cot = torch.randn(want.shape, generator=g, device=dev)
        want_g = torch.autograd.grad((want * cot).sum(), [xr] + arrs)
        want = want.detach()
        for rname, kw in runs.items():
            t0 = time.perf_counter()
            got = chain_apply_streamed(xr, chain, **kw)
            got_g = torch.autograd.grad((got * cot).sum(), [xr] + arrs)
            if x.is_cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            errs = []
            for gv, wv in [(got.detach(), want)] + list(zip(got_g, want_g)):
                diff = (gv - wv).abs()
                scale = max(1.0, float(wv.abs().max()))
                errs.append(float(diff.max()) / scale)
                if not bool((diff <= atol * scale + rtol * wv.abs()).all()):
                    failed.append(f"{cname} {rname}: tensor {len(errs) - 1} "
                                  f"max_abs_err {float(diff.max()):.3e} (scale {scale:.3g})")
            out[f"{cname} {rname}"] = {"max_err_over_scale": max(errs), "fwd_bwd_s": secs}
            log(f"[10] {cname:6s} {rname:28s} vs dense: max |err|/max|want| over value and "
                f"{len(errs) - 1} gradients {max(errs):.3e} (values {errs[0]:.3e}); "
                f"fwd+bwd {secs:.2f} s")
            del got, got_g
        del want, want_g, xr
        if x.is_cuda:
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError("[10] streamed chains disagree with the dense chain: "
                             + "; ".join(failed))
    return out


# -------------------------------------------------------------- training ---

def scaled_config(cfg):
    """The small-input configuration of [5] and [8]: widths cut so every
    kernel still runs (d = 32 heads, one stride-2 stem conv at stage 3)."""
    from hybrid_vit_cascade_tpu_torch.config import Config

    small = Config.from_dict(cfg.to_dict())
    sm = small.model
    sm.voxel_dim, sm.xray_feature_dim, sm.dtype = 128, 128, "float32"
    sm.stage_depths, sm.stage_heads, sm.stage_sizes = (1, 1, 1), (4, 4, 4), (8, 16, 32)
    for n, size in zip((1, 2, 3), (8, 16, 32)):
        small.training.stages[f"stage{n}"].target_resolution = (size, size, size)
    small.data.xray_size = 64
    return small


def train_reference(cfg, dev, seed: int) -> dict:
    """Phase 8: one scaled stage-3 train step, card against CPU."""
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.trainer import stage_step

    small = scaled_config(cfg)
    small.model.slab_count = 4
    g = torch.Generator().manual_seed(seed + 3)
    batch = {"drr_stacked": torch.rand((1, 2, 1, 64, 64), generator=g) * 2 - 1,
             "ct_volume": torch.rand((1, 1, 32, 32, 32), generator=g) * 2 - 1}
    runs = {}
    for where in ("cpu", dev):
        model = seeded_init_(build_model(small), seed).to(where)
        model.stage3.eval_schedule = "train"  # the deterministic step streams as training does
        state, step = stage_step(model, small, 3, MultiScaleLoss(), train=False)
        b = {k: v.to(where) for k, v in batch.items()}
        reset_launch_counts()
        with force_streaming():
            _, metrics = step(state, b, None)
        runs[str(where)] = (metrics, {n: p.grad.cpu() for n, p in model.named_parameters()
                                      if p.grad is not None}, launch_counts())
    (m_cpu, g_cpu, _), (m_gpu, g_gpu, launched) = runs["cpu"], runs[str(dev)]
    atol, rtol = SMALL_TOL
    worst = {"loss": 0.0, "grad": 0.0}
    for k in m_cpu:
        err = abs(float(m_gpu[k]) - float(m_cpu[k]))
        worst["loss"] = max(worst["loss"], err)
        if err > atol + rtol * abs(float(m_cpu[k])):
            raise AssertionError(f"[8] {k}: card {float(m_gpu[k])} vs cpu {float(m_cpu[k])}")
    if sorted(g_cpu) != sorted(g_gpu) or not g_cpu:
        raise AssertionError("[8] the card and the CPU step trained different parameters")
    for n, w in g_cpu.items():
        diff = (g_gpu[n] - w).abs()
        worst["grad"] = max(worst["grad"], float(diff.max()))
        if not bool((diff <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"[8] gradient of {n} disagrees: max_abs_err {float(diff.max())}")
    log(f"[8] small train reference (stage 3, fp32, 4 slabs, {len(g_cpu)} trainable tensors): "
        f"total_loss card {float(m_gpu['total_loss']):.6f} cpu {float(m_cpu['total_loss']):.6f}; "
        f"max_abs_err loss {worst['loss']:.3e} grads {worst['grad']:.3e} "
        f"tol={atol:g}+{rtol:g}|ref| ok; launches {launched}")
    need = ("flash_attention", "flash_attention_bwd", *_CHAIN_LETTERS, "conv3d_k3s2_chain")
    if any(launched[k] == 0 for k in need):
        raise AssertionError(f"[8] the card's step did not run every kernel of {need}: {launched}")
    return {"max_abs_err": worst, "launches": launched}


def _trained_state(model) -> tuple[dict, dict]:
    """Copies of the model's state and of the gradients its last step left."""
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})


def _tensors_differing(a: dict, b: dict) -> tuple[int, float]:
    """How many tensors of ``a`` and ``b`` differ in any bit, and by how much at most."""
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    return len(bad), max((float((a[k].float() - b[k].float()).abs().max()) for k in bad),
                         default=0.0)


def train_twice(model, run, start: dict, first: tuple) -> dict:
    """The stage's steps once more, from the state ``start`` they began from
    (``run()`` draws its batch and dropout from a generator seeded as the
    first run's): the losses, the state after the last step (weights and
    BatchNorm statistics) and its gradients, against the first run's
    ``first`` = (losses, state, gradients)."""
    model.load_state_dict(start)
    losses = run()["total_loss"]
    state, grads = _trained_state(model)
    n_state, d_state = _tensors_differing(first[1], state)
    n_grads, d_grads = _tensors_differing(first[2], grads)
    return {"losses": [first[0], losses], "losses_equal": first[0] == losses,
            "state_differing": n_state, "state_tensors": len(state),
            "grads_differing": n_grads, "grads": len(grads),
            "max_abs_diff": max(d_state, d_grads)}


def train_full_width(cfg, dev, seed: int) -> dict:
    """Phase 9: full-width training of stages 1, 2 and 3. Each stage's steps
    run twice from the state they began from, and the third stage's twice
    more with the split flash backward (L + M): each pair must agree in
    every bit."""
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops import attention
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    model = seeded_init_(build_model(cfg), seed).to(dev)
    loss_obj = MultiScaleLoss({f"stage{n}": getattr(cfg.loss, f"stage{n}") for n in (1, 2, 3)})
    out = {}
    for stage in (1, 2, 3):
        b = TRAIN_BATCH[stage]

        def run(stage=stage, b=b):
            g = torch.Generator(device=dev).manual_seed(seed + 10 + stage)
            return train_steps(model, cfg, stage, b, TRAIN_STEPS, g, loss_obj=loss_obj)

        start = {k: v.clone() for k, v in model.state_dict().items()}
        with rule_calls() as rc:
            r = run()
        trained = _trained_state(model)
        r["repeat"] = train_twice(model, run, start, (r["total_loss"], *trained))
        if stage == 3:
            attention.FUSED_BWD = False
            try:
                model.load_state_dict(start)
                split = run()
                r["repeat_split_bwd"] = train_twice(model, run, start,
                                                    (split["total_loss"], *_trained_state(model)))
            finally:
                attention.FUSED_BWD = True
            model.load_state_dict(trained[0])
        del start, trained
        # every step runs the same calls: the warm-up step's share of them
        r["tc_rule_calls_per_step"] = {k: n / (1 + TRAIN_STEPS) for k, n in rc.n.items()}
        r["c1in_bf16_calls_per_step"] = {k: n / (1 + TRAIN_STEPS) for k, n in rc.c1in_bf16.items()}
        res = (64, 128, 256)[stage - 1]
        key = f"train_stage{stage}_{res}_b{b}_steps_per_sec"
        r[key] = r.pop("steps_per_sec")
        log(f"[9] stage {stage} ({res}³, batch {b}, {r['trainable_params'] / 1e6:.1f} M "
            f"trainable): {key} = {r[key]:.4f} (steps "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} ms; warm-up {r['warmup_s']:.2f} s); "
            f"peak memory {r['peak_allocated_gb']:.2f} GB; total_loss per step "
            f"{', '.join(f'{v:.5f}' for v in r['total_loss'])}; launches per step "
            f"{r['launches_per_step']}")
        if not all(math.isfinite(v) for v in r["total_loss"]):
            raise AssertionError(f"[9] stage {stage}: non-finite loss {r['total_loss']}")
        for key, bwd in (("repeat", "D"), ("repeat_split_bwd", "L + M")):
            if key in r:
                x = r[key]
                log(f"[9] stage {stage} ({bwd}) run twice from one state: losses equal "
                    f"{x['losses_equal']}, {x['state_differing']} of {x['state_tensors']} "
                    f"state tensors and {x['grads_differing']} of {x['grads']} gradients differ "
                    f"(max |diff| {x['max_abs_diff']:.3e})")
        out[f"stage{stage}"] = r
        torch.cuda.empty_cache()
    unrepeated = {f"{stage} {key}": r[key] for stage, r in out.items()
                  for key in ("repeat", "repeat_split_bwd")
                  if key in r and (not r[key]["losses_equal"] or r[key]["state_differing"]
                                   or r[key]["grads_differing"])}
    if unrepeated:
        raise AssertionError(f"[9] a step did not repeat bitwise: {unrepeated}")
    step3 = out["stage3"]["launches_per_step"]
    need = ("flash_attention", "flash_attention_bwd", "conv3d_k3s2", "conv3d_k3s2_dgrad",
            "conv3d_k3s2_wgrad", *_CHAIN_LETTERS, "conv3d_k3s1_wgrad_tc", "conv3d_k3s2_wgrad_tc",
            "conv3d_k3s1_chain_tc", "flash_attention_tc", "flash_attention_bwd_tc",
            "conv3d_k3s2_chain_tc")
    if any(step3[k] == 0 for k in need):
        raise AssertionError(f"[9] the stage-3 step did not run every kernel of its path: {step3}")
    # every flash forward and fused backward of a bf16 step takes the tensor
    # cores, and so do the 64→32 chain conv and its data gradient (at least
    # one of each per slab) and the stage-3 step's 32→64 chain conv (I)
    for stage, r in out.items():
        lc = r["launches_per_step"]
        for k in ("flash_attention", "flash_attention_bwd"):
            if lc[f"{k}_tc"] != lc[k]:
                raise AssertionError(f"[9] {stage}: {lc[f'{k}_tc']} of {lc[k]} launches of {k} "
                                     f"on the tensor cores")
    if step3["conv3d_k3s1_chain_tc"] < 2 * cfg.model.slab_count:
        raise AssertionError(f"[9] the stage-3 step's 64→32 chain conv and its data gradient "
                             f"did not take the tensor cores in every slab: {step3}")
    if step3["conv3d_k3s2_chain_tc"] != step3["conv3d_k3s2_chain"]:
        raise AssertionError(f"[9] the stage-3 step's 32→64 chain conv (I) did not take the "
                             f"tensor cores every time: {step3}")
    # every bf16 stride-2 data gradient with Cin, Cout ≥ 8 took the tensor
    # cores (F/J), and every bf16 one-output-channel data gradient with 8-64
    # g channels its tensor-core instance, as many as the rules name; stage 3
    # ran both forms of F/J and the chain form of the latter
    for stage, r in out.items():
        lc, want = r["launches_per_step"], r["tc_rule_calls_per_step"]
        if any(lc[k] != want[k] for k in _RULE_COUNTERS):
            raise AssertionError(f"[9] {stage}: tensor-core launches "
                                 f"{ {k: lc[k] for k in _RULE_COUNTERS} } differ from the calls "
                                 f"the rules name {want}")
    if not (step3["conv3d_k3s2_dgrad_tc"] and step3["conv3d_k3s2_chain_dgrad_tc"]):
        raise AssertionError(f"[9] the stage-3 step ran no tensor-core F or J: {step3}")
    if not step3["conv3d_k3s1_chain_dgrad_c1_tc"]:
        raise AssertionError(f"[9] the stage-3 step ran no one-output-channel data gradient on "
                             f"the tensor cores: {step3}")
    # every bf16 stride-1 conv and weight gradient with one input channel of
    # each step took the one-input-channel instances; stage 3 ran both
    for stage, r in out.items():
        check_c1in(r["launches_per_step"], r["c1in_bf16_calls_per_step"], f"[9] {stage}")
    if not (step3["conv3d_k3s1_chain_c1in_tc"] and step3["conv3d_k3s1_wgrad_c1in_tc"]):
        raise AssertionError(f"[9] the stage-3 step ran no one-input-channel conv or weight "
                             f"gradient on the tensor cores: {step3}")
    step1 = out["stage1"]["launches_per_step"]
    if not (step1["conv3d_k3s2_c1in_tc"] and step1["conv3d_k3s2_dgrad_c1in_tc"]
            and step1["conv3d_k3s2_wgrad_c1in_tc"]):
        raise AssertionError(f"[9] the stage-1 step ran the 1→64 stem's forward, data gradient "
                             f"or weight gradient off its tensor-core instance: {step1}")
    return out


def flash_bwd_bitwise(dev, seed: int) -> dict:
    """Phase 7d: two runs give the same bits — kernel D at every training
    shape in bf16 (tensor cores: dq added in key-tile order) and fp32 (CUDA
    cores: dq partials added in group order), M and L at every training shape
    in bf16 (tensor cores: one writer a row), M's dk and dv also bitwise D's
    (the same body without the dq phase), and L and M at the stage-3
    self-attention shape in fp32 (no atomics)."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    runs = [(name, shape, dtype) for shape in _FLASH_TRAIN_SHAPES
            for dtype in (torch.bfloat16, torch.float32) for name in ("flash_attention_bwd",)]
    runs += [(name, shape, torch.bfloat16) for shape in _FLASH_TRAIN_SHAPES
             for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")]
    runs += [(name, (8, 32768, 32768, 32), torch.float32)
             for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")]
    fns = {"flash_attention_bwd_dq": lambda *a: (fa.flash_attention_bwd_dq(*a),),
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
           "flash_attention_bwd": fa.flash_attention_bwd}
    out, failed = {}, []
    for name, shape, dtype in runs:
        args = _train_inputs("flash_attention_bwd", shape, dtype, dev, seed)
        a, b = fns[name](*args), fns[name](*args)
        torch.cuda.synchronize()
        key = f"{name} {shape} {str(dtype).replace('torch.', '')}"
        out[key] = {"bitwise_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
                    "max_abs_diff": max(float((x.float() - y.float()).abs().max())
                                        for x, y in zip(a, b))}
        if name == "flash_attention_bwd_dkv" and dtype == torch.bfloat16:
            fused = fa.flash_attention_bwd(*args)[1:]
            out[key]["equals_d"] = all(torch.equal(x, y) for x, y in zip(a, fused))
            del fused
        log(f"[7] {key:64s} two runs: bitwise equal {out[key]['bitwise_equal']}, "
            f"max |diff| {out[key]['max_abs_diff']:.3e}"
            + (f"; dk, dv bitwise D's {out[key]['equals_d']}" if "equals_d" in out[key] else ""))
        if not out[key]["bitwise_equal"] or not out[key].get("equals_d", True):
            failed.append(key)
        del args, a, b
    if failed:
        raise AssertionError(f"[7] not bitwise repeatable (or M not D's dk, dv): {failed}")
    return out


# Head dims other than 32 and 64 ([7h], [21]): the d = 128 instances of A, D,
# L and M, and d = 16 zero-padded to the d = 32 instance, at the stage-3
# self- and cross-attention shapes of a cascade with 2 heads of 128 or 16
# heads of 16 (32,768 voxel tokens over themselves and over 4,096 X-ray
# tokens, batch 1), and ragged shapes at padded d (16 → 32, 48 → 64, 96 →
# 128) and at d = 128.
HEAD_DIM_AT = {128: [(2, 32768, 32768, 128), (2, 32768, 4096, 128)],
               16: [(16, 32768, 32768, 16), (16, 32768, 4096, 16)]}
HEAD_DIM_RAGGED = [(3, 200, 77, 128), (3, 200, 77, 16), (3, 200, 77, 48), (2, 65, 63, 96)]
FLASH_NAMES = ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")


def _flash_wrapper(name: str):
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    return getattr(fa, name if name != "flash_attention" else "flash_attention_fwd")


def head_dim_kernels(dev, seed: int) -> dict:
    """Phase 7h: A, D, L and M at HEAD_DIM_AT and HEAD_DIM_RAGGED against their
    plain versions in bf16 and fp32 (FLASH_OUT_TOL, as [3] and [7]); each bf16
    call at HEAD_DIM_AT on its tensor-core instance (one launch and one
    tensor-core launch on its wrapper's counters); two runs of D, L and M at
    each HEAD_DIM_AT shape bitwise equal in bf16 (and D in fp32); each timed
    beside its plain version in bf16. Returns max_abs_err by kernel and d,
    the timed rows and the bitwise record."""
    rec = {"max_abs_err": {}, "rows": {}, "bitwise": {}}
    for name in FLASH_NAMES:
        inputs, fns = (_inputs, _fns) if name == "flash_attention" else (_train_inputs, _train_fns)
        for d, shapes in HEAD_DIM_AT.items():
            log(f"[7h] {name} at d = {d} vs plain (bf16 and fp32)")
            rec["max_abs_err"][f"{name} d{d}"] = check_kernels(
                dev, seed, {name: {"shapes": shapes, "ragged": []}}, inputs, fns,
                scaled=name != "flash_attention")[name]
            wrapper, kern = _flash_wrapper(name), fns(name)[0]
            for shape in shapes:
                args = inputs(name, shape, torch.bfloat16, dev, seed)
                before = (wrapper.launches, wrapper.tc_launches)
                first = kern(*args)
                took = (wrapper.launches - before[0], wrapper.tc_launches - before[1])
                if took != (1, 1):
                    raise AssertionError(f"[7h] {name} {shape} bf16: launches, tensor-core "
                                         f"launches {took}, expected (1, 1)")
                runs = [(torch.bfloat16, args, first)] if name != "flash_attention" else []
                if name == "flash_attention_bwd":
                    a32 = inputs(name, shape, torch.float32, dev, seed)
                    runs.append((torch.float32, a32, kern(*a32)))
                for dtype, a, got in runs:
                    again = kern(*a)
                    torch.cuda.synchronize()
                    key = f"{name} {shape} {str(dtype).replace('torch.', '')}"
                    ok = rec["bitwise"][key] = all(torch.equal(x, y) for x, y in zip(got, again))
                    log(f"[7h] {key:64s} two runs: bitwise equal {ok}")
                    if not ok:
                        raise AssertionError(f"[7h] {key}: two runs differ")
                del args, first, runs
            rec["rows"].update(time_kernels(dev, seed, {name: {"shapes": shapes}}, inputs, fns))
        log(f"[7h] {name} at ragged head dims vs plain (bf16 and fp32)")
        rec["max_abs_err"][f"{name} ragged"] = check_kernels(
            dev, seed, {name: {"shapes": [], "ragged": HEAD_DIM_RAGGED}}, inputs, fns,
            scaled=name != "flash_attention")[name]
        torch.cuda.empty_cache()
    return rec


# bf16 weight gradients of the stage-3 step: the dense 64→32 and 32→64 and
# one training slab of each chain, with the counter their launch must add to.
_TC_WGRAD_CALLS = [("conv3d_k3s1_wgrad", (1, 64, 32, (256, 256, 256))),
                   ("conv3d_k3s2_wgrad", (1, 32, 64, (256, 256, 256))),
                   ("conv3d_k3s1_chain_wgrad", _TRAIN_S1), ("conv3d_k3s2_chain_wgrad", _TRAIN_S2)]


def tc_wgrad_dispatch(dev, seed: int) -> dict:
    """Phase 7e: the bf16 64→32 and 32→64 weight gradients of the stage-3
    step launch the tensor-core instance (conv3d_k3s{1,2}_wgrad_tc counts
    them), the bf16 1→64 and 1→32 ones (dense and one training slab of each
    chain) the one-input-channel instance (conv3d_k3s1_wgrad_c1in_tc), the
    bf16 1→64 stride-2 stem's its stride-2 form (conv3d_k3s2_wgrad_c1in_tc);
    the same calls in fp32 none of them, and no call another's."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck

    out = {}
    calls = [(n, sh, torch.bfloat16, True, None) for n, sh in _TC_WGRAD_CALLS]
    calls += [(n, sh, torch.float32, False, None) for n, sh in _TC_WGRAD_CALLS[2:]]
    calls += [("conv3d_k3s1_wgrad", (1, 1, 64, (256, 256, 256)), torch.bfloat16, False, None)]
    c1in = "conv3d_k3s1_wgrad_c1in_tc"
    calls += [(n, sh, dt, dt == torch.bfloat16, c1in)
              for n, sh in (("conv3d_k3s1_wgrad", (1, 1, 64, (256, 256, 256))),
                            ("conv3d_k3s1_wgrad", (1, 1, 32, (256, 256, 256))),
                            ("conv3d_k3s1_chain_wgrad", _TRAIN_C1),
                            ("conv3d_k3s1_chain_wgrad", _TIMED_C1IN[3]))
              for dt in (torch.bfloat16, torch.float32)]
    calls += [("conv3d_k3s2_wgrad", _S2_STEM, torch.bfloat16, False, c) for c in
              ("conv3d_k3s2_wgrad_tc", c1in)]
    calls += [("conv3d_k3s2_wgrad", _S2_STEM, dt, dt == torch.bfloat16, "conv3d_k3s2_wgrad_c1in_tc")
              for dt in (torch.bfloat16, torch.float32)]
    calls += [("conv3d_k3s1_wgrad", (1, 1, 64, (256, 256, 256)), torch.bfloat16, False,
               "conv3d_k3s2_wgrad_c1in_tc")]
    for name, shape, dtype, want_tc, counter in calls:
        counter = counter or f"conv3d_k3s{_chain_stride(name)}_wgrad_tc"
        if "chain" in name:
            args, fn = _chain_inputs(name, shape, dtype, dev, seed), _chain_fns(name)[0]
        else:
            args, fn = _train_inputs(name, shape, dtype, dev, seed), _train_fns(name)[0]
        before = ck.LAUNCHES[counter]
        fn(*args)
        torch.cuda.synchronize()
        took = ck.LAUNCHES[counter] - before
        key = f"{name} {shape} {str(dtype).replace('torch.', '')} {counter}"
        out[key] = took
        log(f"[7] {key:100s} launches {took} (expected {int(want_tc)})")
        if took != int(want_tc):
            raise AssertionError(f"[7] {key}: {took} launches on {counter}, expected "
                                 f"{int(want_tc)}")
        del args
    return out


# bf16 calls of the stage-3 step on the tensor-core convs: the dense and
# one-slab 64→32 conv and its data gradient (the forward on g, 32→64
# channels), the dense and one-slab 32→64 stride-2 conv and its data
# gradient, with the counter their launch must add to.
_TC_FWD_CALLS = [("conv3d_k3s1", (1, 64, 32, (256, 256, 256)), "conv3d_k3s1_tc"),
                 ("conv3d_k3s1_dgrad", (1, 64, 32, (256, 256, 256)), "conv3d_k3s1_tc"),
                 ("conv3d_k3s1_chain", _TRAIN_S1_GELU, "conv3d_k3s1_chain_tc"),
                 ("conv3d_k3s1_chain_dgrad", _TRAIN_S1_GELU, "conv3d_k3s1_chain_tc"),
                 ("conv3d_k3s2", (1, 32, 64, (256, 256, 256)), "conv3d_k3s2_tc"),
                 ("conv3d_k3s2_chain", _TRAIN_S2, "conv3d_k3s2_chain_tc"),
                 ("conv3d_k3s2_dgrad", (1, 32, 64, (256, 256, 256)), "conv3d_k3s2_dgrad_tc"),
                 ("conv3d_k3s2_chain_dgrad", _TRAIN_S2, "conv3d_k3s2_chain_dgrad_tc"),
                 ("conv3d_k3s2_chain_dgrad", _TRAIN_S2_GELU, "conv3d_k3s2_chain_dgrad_tc")]


def tc_fwd_dispatch(dev, seed: int) -> dict:
    """Phase 7f: the bf16 64→32 conv of the stage-3 step and its data
    gradient (dense and one training slab) launch the tensor-core conv
    (conv3d_k3s1_tc / conv3d_k3s1_chain_tc count them), the bf16 32→64
    stride-2 conv and its data gradient (dense and one training slab, the
    slab's with and without act′) the tensor-core C/I and F/J
    (conv3d_k3s2_tc / conv3d_k3s2_chain_tc, conv3d_k3s2_dgrad_tc /
    conv3d_k3s2_chain_dgrad_tc), and every bf16 flash forward, fused backward
    and dk/dv and dq of the training shapes the tensor-core A, D, M and L
    (flash_attention_tc, flash_attention_bwd_tc, flash_attention_bwd_dkv_tc,
    flash_attention_bwd_dq_tc), the 1-channel conv's one-output-channel data
    gradient (dense 64→1 and 32→1, one training slab) the one-output-channel
    tensor-core instance (conv3d_k3s1_dgrad_c1_tc /
    conv3d_k3s1_chain_dgrad_c1_tc), the bf16 1→64 stride-2 stem and its data
    gradient the one-input-channel and one-dx-channel instances
    (conv3d_k3s2_c1in_tc, conv3d_k3s2_dgrad_c1in_tc); the same calls in fp32,
    and the 1-channel conv and the stem on the other instances, do not; the
    stem's data gradient in fp32 takes its fp32 form
    (conv3d_k3s2_dgrad_c1in_fp32), in bf16 not."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts

    calls = [(n, sh, c, dt, dt == torch.bfloat16) for n, sh, c in _TC_FWD_CALLS
             for dt in (torch.bfloat16, torch.float32)]
    calls += [(n, (1, 1, 64, (256, 256, 256)), "conv3d_k3s1_tc", torch.bfloat16, False)
              for n in ("conv3d_k3s1", "conv3d_k3s1_dgrad")]
    # the 1-channel conv's one-output-channel data gradient: dense and one
    # training slab, bf16 on its tensor-core instance, fp32 not
    calls += [(n, sh, c, dt, dt == torch.bfloat16)
              for n, sh, c in (("conv3d_k3s1_dgrad", (1, 1, 64, (256, 256, 256)),
                                "conv3d_k3s1_dgrad_c1_tc"),
                               ("conv3d_k3s1_dgrad", (1, 1, 32, (256, 256, 256)),
                                "conv3d_k3s1_dgrad_c1_tc"),
                               ("conv3d_k3s1_chain_c1_dgrad", _TRAIN_C1,
                                "conv3d_k3s1_chain_dgrad_c1_tc"))
              for dt in (torch.bfloat16, torch.float32)]
    # the 1-channel convs themselves: dense 1→64 and 1→32, and one training
    # slab of each chain, bf16 on the one-input-channel instance, fp32 not
    calls += [(n, sh, c, dt, dt == torch.bfloat16)
              for n, sh, c in (("conv3d_k3s1", (1, 1, 64, (256, 256, 256)), "conv3d_k3s1_c1in_tc"),
                               ("conv3d_k3s1", (1, 1, 32, (256, 256, 256)), "conv3d_k3s1_c1in_tc"),
                               ("conv3d_k3s1_chain", _TIMED_C1IN[0], "conv3d_k3s1_chain_c1in_tc"),
                               ("conv3d_k3s1_chain", _TIMED_C1IN[3], "conv3d_k3s1_chain_c1in_tc"))
              for dt in (torch.bfloat16, torch.float32)]
    calls += [("conv3d_k3s2", (1, 1, 64, (64, 64, 64)), c, torch.bfloat16, False)
              for c in ("conv3d_k3s2_tc", "conv3d_k3s1_c1in_tc")]
    calls += [("conv3d_k3s2_dgrad", _S2_STEM, "conv3d_k3s2_dgrad_tc", torch.bfloat16, False)]
    # the stem and its data gradient on their own instances, bf16 only
    calls += [(n, sh, c, dt, dt == torch.bfloat16)
              for n, sh, c in (("conv3d_k3s2", _S2_STEM, "conv3d_k3s2_c1in_tc"),
                               ("conv3d_k3s2", (1, 1, 64, (64, 64, 64)), "conv3d_k3s2_c1in_tc"),
                               ("conv3d_k3s2_dgrad", _S2_STEM, "conv3d_k3s2_dgrad_c1in_tc"))
              for dt in (torch.bfloat16, torch.float32)]
    calls += [("conv3d_k3s2_dgrad", _S2_STEM, "conv3d_k3s2_dgrad_c1in_fp32", dt,
               dt == torch.float32) for dt in (torch.bfloat16, torch.float32)]
    calls += [(n, sh, f"{n}_tc", dt, dt == torch.bfloat16)
              for n in ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_dkv",
                        "flash_attention_bwd_dq")
              for sh in _FLASH_TRAIN_SHAPES for dt in (torch.bfloat16, torch.float32)]
    out = {}
    for name, shape, counter, dtype, want_tc in calls:
        if "chain" in name:
            args, fn = _chain_inputs(name, shape, dtype, dev, seed), _chain_fns(name)[0]
        elif name.endswith("dgrad") or name.startswith("flash_attention_bwd"):
            args, fn = _train_inputs(name, shape, dtype, dev, seed), _train_fns(name)[0]
        else:
            args, fn = _inputs(name, shape, dtype, dev, seed), _fns(name)[0]
        before = launch_counts()[counter]
        fn(*args)
        torch.cuda.synchronize()
        took = launch_counts()[counter] - before
        key = f"{name} {shape} {str(dtype).replace('torch.', '')} {counter}"
        out[key] = took
        log(f"[7] {key:74s} tensor-core launches {took} (expected {int(want_tc)})")
        if took != int(want_tc):
            raise AssertionError(f"[7] {key}: {took} tensor-core launches, expected "
                                 f"{int(want_tc)}")
        del args
    return out


# ----------------------------------------------------- training entry point ---

def _config_copy(src: Path, name: str, **overrides) -> Path:
    """A copy of config ``src`` under build/ with dotted-key overrides."""
    cfg = json.loads(src.read_text())
    for key, value in overrides.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value
    out = BUILD_DIR / name
    out.write_text(json.dumps(cfg, indent=1))
    return out


def train_entry_point(dev, seed: int, fused_stage3_ms: float) -> dict:
    """Phase 11: ``cli train`` on a copy of configs/quality_r5.json with the
    split flash backward, then resume, then serve from its checkpoint."""
    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.inference.infer import InferenceEngine
    from hybrid_vit_cascade_tpu_torch.ops import attention
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training import trainer as trainer_mod
    from hybrid_vit_cascade_tpu_torch.training.checkpoint import load_entry

    t_phase = time.perf_counter()
    save_dir = BUILD_DIR / "cli_train"
    shutil.rmtree(save_dir, ignore_errors=True)
    overrides = {**{f"training.stages.stage{n}.num_epochs": 1 for n in (1, 2, 3)},
                 "data.synthetic_patients": 11, "training.viz_every": 0,
                 "checkpoints.save_dir": str(save_dir)}
    copy = _config_copy(TRAIN_CONFIG, "quality_r5_smoke.json", **overrides)
    cfg = json.loads(copy.read_text())
    log(f"[11] cli train on {copy.relative_to(ROOT)}, a copy of {TRAIN_CONFIG.relative_to(ROOT)} "
        f"with {overrides}; widths, batches, schedule and losses are the config's "
        f"(freeze_shared_encoder_stage3 {cfg['training']['freeze_shared_encoder_stage3']}, "
        f"stage3_split_step {cfg['training']['stage3_split_step']})")

    # per stage: launches and wall time of its epoch loop, time of each step
    current, per_stage, step_ms = {}, {}, {}
    real_stage_step, real_run = trainer_mod.stage_step, trainer_mod.Trainer._run_epochs

    def timed_stage_step(model, cfg_, stage, *a, **kw):
        state, step = real_stage_step(model, cfg_, stage, *a, **kw)
        current["stage"] = stage
        times = step_ms.setdefault(stage, [])

        def timed(state, batch, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return res
        return state, timed

    def counted_run(self, *a, **kw):
        before, t0 = launch_counts(), time.perf_counter()
        res = real_run(self, *a, **kw)
        torch.cuda.synchronize()
        after = launch_counts()
        per_stage[current["stage"]] = {"wall_s": time.perf_counter() - t0,
                                       "launches": {k: after[k] - before[k] for k in after}}
        return res

    attention.FUSED_BWD = False
    trainer_mod.stage_step, trainer_mod.Trainer._run_epochs = timed_stage_step, counted_run
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        with rule_calls() as rc:
            cli.main(["train", "--config", str(copy)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launched = launch_counts()
    finally:
        attention.FUSED_BWD = True
        trainer_mod.stage_step, trainer_mod.Trainer._run_epochs = real_stage_step, real_run
    torch.cuda.empty_cache()
    for n in (1, 2, 3):
        r, ms = per_stage[n], step_ms[n]
        lc = {k: v for k, v in r["launches"].items() if v}
        log(f"[11] stage {n}: wall {r['wall_s']:.1f} s (epoch loop, data and checkpoints "
            f"included); {len(ms)} steps, median {statistics.median(ms):.1f} ms "
            f"({', '.join(f'{t:.1f}' for t in ms)}); launches {lc}")
        if r["launches"]["flash_attention_bwd"] or not (r["launches"]["flash_attention_bwd_dq"]
                                                        and r["launches"]["flash_attention_bwd_dkv"]):
            raise AssertionError(f"[11] stage {n} did not take the split backward: {lc}")
    split3 = statistics.median(step_ms[3])
    log(f"[11] split stage-3 step (frozen encoder, L + M) median {split3:.1f} ms beside [9]'s "
        f"stage-3 step (trained encoder, D) {fused_stage3_ms:.1f} ms (information only)")
    if launched["flash_attention_bwd"]:
        raise AssertionError(f"[11] kernel D launched under FUSED_BWD=False: {launched}")
    log(f"[11] tensor-core F, J, M, L, one-output-channel dgrad and one-input-channel conv "
        f"and wgrad launches {({k: launched[k] for k in _RULE_COUNTERS})}, calls the rules name "
        f"{rc.n}; bf16 stride-1 calls with one input channel {rc.c1in_bf16}")
    # the one-output-channel data gradient runs only where the 1-channel
    # convs' input needs a gradient, which the frozen-encoder split step's
    # does not ([9]'s stage-3 step runs it)
    if any(launched[k] != rc.n[k] for k in _RULE_COUNTERS) or not all(
            rc.n[k] for k in _RULE_COUNTERS if "dgrad_c1" not in k):
        raise AssertionError(f"[11] tensor-core F/J/M/L/one-output-channel/one-input-channel "
                             f"launches differ from the calls the rules name, or one never ran: "
                             f"{launched} vs {rc.n}")
    check_c1in(launched, rc.c1in_bf16, "[11]")

    rows = [json.loads(line) for line in (save_dir / "training_log.jsonl").read_text().splitlines()]
    for n in (1, 2, 3):
        d = save_dir / f"stage{n}"
        missing = [e for e in ("latest", "latest_opt", "best_loss", "best_psnr", "best_ssim")
                   if not (d / e / "checkpoint.pt").is_file()]
        if missing:
            raise AssertionError(f"[11] stage {n}: no {missing} under {d}")
    losses = {r["phase"]: [r["train_loss"], r["loss"], r["psnr"], r["ssim"]] for r in rows}
    log(f"[11] per stage [train loss, val loss, val psnr, val ssim]: {losses}")
    if sorted(losses) != ["stage1", "stage2", "stage3"] or not all(
            math.isfinite(v) for vals in losses.values() for v in vals):
        raise AssertionError(f"[11] expected finite losses of three stages: {losses}")
    s2 = load_entry(save_dir / "stage2" / "latest")[0]["state_dict"]
    s3 = load_entry(save_dir / "stage3" / "latest")[0]["state_dict"]
    enc = [k for k in s2 if k.startswith("xray_encoder.")]
    changed = [k for k in enc if not torch.equal(s2[k], s3[k])]
    moved = [k for k in s2 if k.startswith("stage3.") and not torch.equal(s2[k], s3[k])]
    log(f"[11] shared encoder at stage3/latest vs stage2/latest: {len(enc)} tensors "
        f"({sum('running' in k for k in enc)} BatchNorm running statistics), {len(changed)} "
        f"differ; stage-3 tensors that moved: {len(moved)}")
    if changed or not enc or not moved:
        raise AssertionError(f"[11] encoder changed {changed[:5]} or stage 3 did not move")
    del s2, s3

    n_rows = len(rows)
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["train", "--config", str(copy)])
    resume_s = time.perf_counter() - t0
    again = launch_counts()
    n_after = len((save_dir / "training_log.jsonl").read_text().splitlines())
    log(f"[11] the same command again: {resume_s:.1f} s, {n_after - n_rows} epochs run, "
        f"launches {({k: v for k, v in again.items() if v})}")
    if n_after != n_rows or any(again.values()):
        raise AssertionError("[11] resume did not skip every completed stage")

    engine = InferenceEngine(save_dir / "stage3" / "best_psnr", device=dev)
    xs = cfg["data"]["xray_size"]
    xr = torch.rand((1, 2, 1, xs, xs), generator=torch.Generator().manual_seed(seed + 4)) * 2 - 1
    vol = engine.reconstruct(xr)
    torch.cuda.synchronize()
    ok = tuple(vol.shape) == (1, 1, 256, 256, 256) and bool(torch.isfinite(vol.float()).all())
    log(f"[11] InferenceEngine(stage3/best_psnr) reconstruct: {tuple(vol.shape)} {vol.dtype} "
        f"finite {ok}")
    if not ok:
        raise AssertionError("[11] the trained checkpoint does not serve a finite 256³ volume")
    del engine, vol
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[11] phase time {phase_s:.1f} s (train {train_s:.1f} s, resume {resume_s:.1f} s)")
    return {"launches": launched, "tc_rule_calls": rc.n, "per_stage": per_stage, "step_ms": step_ms,
            "split_stage3_median_ms": split3, "fused_stage3_median_ms": fused_stage3_ms,
            "losses": losses, "train_s": train_s, "resume_s": resume_s, "phase_s": phase_s}


# ---------------------------------------------------------- the probe path ---

def _probe_instance_counter(key: str, n: int):
    """The wgmma counter a probe call (V1, V0, V2, V3, V3', V4, V6, V5, V8)
    at N columns must add to, by the wrapper's rule (None: an mma.sync
    instance, or another case)."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv_probe as cp

    if key == "V2":
        return {cp.V2_WGMMA: "conv_probe_v2_wgmma"}.get(cp.probe_v2_instance(cp.K, n))
    if key in ("V3", "V3'", "V4", "V6", "V5", "V8"):
        v = key.lower().replace("'", "p")
        wgmma = getattr(cp, f"probe_{v}_instance")(n) == getattr(cp, f"{v.upper()}_WGMMA")
        return f"conv_probe_{v}_wgmma" if wgmma else None
    if key in ("V1", "V0"):
        m = 32 if key == "V1" else 256
        return {cp.V1_WGMMA_V0: "conv_probe_v1_wgmma",
                cp.V1_WGMMA_M32: "conv_probe_v1_wgmma_m32"}.get(cp.probe_v1_instance(m, cp.K, n))
    return None


_PROBE_INSTANCE_COUNTERS = ("conv_probe_v1_wgmma", "conv_probe_v1_wgmma_m32",
                            "conv_probe_v2_wgmma", "conv_probe_v3_wgmma",
                            "conv_probe_v3p_wgmma", "conv_probe_v4_wgmma",
                            "conv_probe_v6_wgmma", "conv_probe_v5_wgmma",
                            "conv_probe_v8_wgmma")


def probe_phase(dev, seed: int) -> dict:
    """Phase [12]: every probe kernel against its plain version at full size
    and at ragged N, each call on the instance its rule names, then the
    entry point's run over every case, launches counted from 0."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv_probe as cp
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.scripts import bench_conv_probe as bench

    t0 = time.perf_counter()
    atol, rtol = PROBE_TOL
    worst = {}
    for case in (c for c in bench.CASES if c.kernel):
        for n, reps in ((bench.N_TOTAL, bench.R),) + tuple((n, 2) for n in PROBE_RAGGED_N):
            args = bench.make_inputs(case, n, dev, seed)
            before = {k: cp.LAUNCHES[k] for k in _PROBE_INSTANCE_COUNTERS}
            # one pass of the plain version gives the same values as R
            got, want = case.wrapper(*args, reps), case.plain(*args, 1)
            counter = _probe_instance_counter(case.key, n)
            took = {k: cp.LAUNCHES[k] - before[k] for k in _PROBE_INSTANCE_COUNTERS}
            if took != {k: int(k == counter) for k in _PROBE_INSTANCE_COUNTERS}:
                raise AssertionError(f"[12] {case.key} N={n} took {took}, its rule names {counter}")
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.float32:
                raise AssertionError(f"[12] {case.key} N={n}: {got.shape}/{got.dtype} vs "
                                     f"{want.shape}")
            diff = (got - want).abs()
            err, scale = float(diff.max()), float(want.abs().max())
            ok = bool(torch.isfinite(got).all()) and bool(
                (diff <= atol * scale + rtol * want.abs()).all())
            log(f"[12] {case.key:3s} N={n:6d} R={reps:2d} max_abs_err={err:.3e} "
                f"tol={atol:g}·{scale:.4g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'} "
                f"instance {counter or 'mma.sync'}")
            if not ok:
                raise AssertionError(f"[12] {case.key} disagrees with its plain version at "
                                     f"N={n}: max_abs_err {err}")
            worst[case.kernel] = max(worst.get(case.kernel, 0.0), err)
            del args, got, want
    torch.cuda.empty_cache()
    reset_launch_counts()
    rows = bench.run(bench.CASES, dev, bench.N_TOTAL, bench.R, seed,
                     log=lambda line: log(f"[12] {line}"))
    launched = launch_counts()
    probe_launches = {k: v for k, v in launched.items() if k.startswith("conv_probe")}
    log(f"[12] launches {probe_launches}; phase time {time.perf_counter() - t0:.1f} s")
    if any(launched[k] for k in launched if k not in probe_launches):
        raise AssertionError(f"[12] the probe run launched another kernel: {launched}")
    # at N = 131,072 every probe runs on its wgmma instance, every launch
    by_case = {r["case"]: r.get("launches", {}) for r in rows}
    for key, kernel, counter in (("V0", "conv_probe_v1", "conv_probe_v1_wgmma"),
                                 ("V1", "conv_probe_v1", "conv_probe_v1_wgmma_m32"),
                                 ("V2", "conv_probe_v2", "conv_probe_v2_wgmma"),
                                 ("V3", "conv_probe_v3", "conv_probe_v3_wgmma"),
                                 ("V3'", "conv_probe_v3p", "conv_probe_v3p_wgmma"),
                                 ("V4", "conv_probe_v4", "conv_probe_v4_wgmma"),
                                 ("V6", "conv_probe_v6", "conv_probe_v6_wgmma"),
                                 ("V5", "conv_probe_v5", "conv_probe_v5_wgmma"),
                                 ("V8", "conv_probe_v8", "conv_probe_v8_wgmma")):
        got = by_case[key]
        if not (got.get(kernel, 0) > 0 and got == {kernel: got[kernel], counter: got[kernel]}):
            raise AssertionError(f"[12] {key} did not run on its wgmma instance ({counter}) "
                                 f"alone: {got}")
    return {"max_abs_err": worst, "launches": launched, "rows": rows,
            "phase_s": time.perf_counter() - t0}


_EXP2_NOTE = ("bound_ms is max(products_ms, bytes_ms); exp2_ms, every score's exp2 on the "
              "special-function units at 16 fp32 a clock per SM, is informative and not in "
              "the bound: exps computed as polynomials on the FMA units or by "
              "ex2.approx.bf16x2 go under it")

# The tensor-core instances: each kernel row's counter (the conv forward's
# counts its data gradient too).
_TC_COUNTERS = {"flash_attention": "flash_attention_tc",
                "flash_attention_bwd_dq": "flash_attention_bwd_dq_tc",
                "conv3d_k3s1_chain_c1_dgrad": "conv3d_k3s1_chain_dgrad_c1_tc",
                "flash_attention_bwd": "flash_attention_bwd_tc", "conv3d_k3s1": "conv3d_k3s1_tc",
                "conv3d_k3s1_dgrad": "conv3d_k3s1_tc", "conv3d_k3s1_chain": "conv3d_k3s1_chain_tc",
                "conv3d_k3s1_chain_dgrad": "conv3d_k3s1_chain_tc",
                "conv3d_k3s2": "conv3d_k3s2_tc", "conv3d_k3s2_chain": "conv3d_k3s2_chain_tc",
                "conv3d_k3s2_dgrad": "conv3d_k3s2_dgrad_tc",
                "conv3d_k3s2_chain_dgrad": "conv3d_k3s2_chain_dgrad_tc",
                "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_tc"}


def _tc_rule(counter: str) -> str:
    """The rule that sends a call to ``counter``'s instance: the docstring of
    the wrapper's predicate that states it."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
    from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

    rule = (fa.bwd_dkv_uses_tensor_cores if counter.startswith("flash_attention_bwd_dkv") else
            fa.bwd_dq_uses_tensor_cores if counter.startswith("flash_attention_bwd_dq") else
            fa.bwd_uses_tensor_cores if counter.startswith("flash_attention_bwd") else
            fa.fwd_uses_tensor_cores if counter.startswith("flash") else
            ck.wgrad_instance if "wgrad" in counter else
            ck.dgrad_s2_instance if "s2" in counter and "dgrad" in counter else
            ck.fwd_c1in_uses_tensor_cores if "c1in" in counter else
            ck.dgrad_c1_uses_tensor_cores if "c1" in counter else
            ck.fwd_uses_tensor_cores)
    return " ".join(inspect.getdoc(rule).split())


# ------------------------------------------------------------------ slice ---

# ------------------------------------------------------- the serving commands ---

# One stage-1 forward (max_stage=1) at the full widths: A in the 4 self- and
# 4 cross-attentions of its blocks, the 1→64 stem (C, one-input-channel
# instance) and the 64→128 token-stem conv (C, tensor cores), the 128→256
# projection (B, tensor cores). Under diagnose's capture the cross-attentions
# (one a block) take the plain path, so A launches only in the 4 self-attentions.
STAGE1_LAUNCHES = {"flash_attention": 8, "flash_attention_tc": 8, "conv3d_k3s1": 1,
                   "conv3d_k3s1_tc": 1, "conv3d_k3s2": 2, "conv3d_k3s2_tc": 1,
                   "conv3d_k3s2_c1in": 1, "conv3d_k3s2_c1in_tc": 1}
SERVING_INDEX = 0  # the synthetic patient that infer and diagnose take


def _cli_text(cli, argv: list) -> tuple[str, float, dict]:
    """cli.main(argv) in this process with its output captured → (the
    output, wall seconds, launches counted from 0)."""
    import contextlib
    import io

    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0, launch_counts()


def _cli_json(cli, argv: list) -> tuple[dict, str, float, dict]:
    """_cli_text → (the JSON the command printed last, the lines before it,
    wall seconds, launches)."""
    text, wall, launched = _cli_text(cli, argv)
    start = text.index("\n{") + 1 if not text.startswith("{") else 0
    return json.loads(text[start:]), text[:start], wall, launched


def _saved_volume(path: Path) -> torch.Tensor:
    """An exported .npy as a tensor: fp32, or the raw bf16 values that the
    export writes under the descr '<V2'."""
    import numpy as np

    a = np.load(path)
    if a.dtype.kind == "V":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def serving_phase(dev, cfg) -> dict:
    """Phase 13: the serving commands on [11]'s checkpoint."""
    import importlib.util
    import os

    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.data.nifti import read_nifti
    from hybrid_vit_cascade_tpu_torch.inference.infer import load_checkpoint

    t_phase = time.perf_counter()
    entry = BUILD_DIR / "cli_train" / "stage3" / "best_psnr"
    entry_cfg, state = load_checkpoint(entry)
    ecfg = Config.from_dict(entry_cfg).to_dict()
    copy = Config.from_json(str(BUILD_DIR / "quality_r5_smoke.json")).to_dict()
    if any(ecfg[k] != copy[k] for k in ("model", "data")):
        raise AssertionError("[13] the entry's config is not [11]'s config copy")
    m = cfg.model
    widths = (m.voxel_dim, m.xray_feature_dim, m.dtype, tuple(m.stage_depths),
              tuple(m.stage_heads), tuple(m.stage_sizes))
    em = Config.from_dict(entry_cfg).model
    got_widths = (em.voxel_dim, em.xray_feature_dim, em.dtype, tuple(em.stage_depths),
                  tuple(em.stage_heads), tuple(em.stage_sizes))
    if got_widths != widths:
        raise AssertionError(f"[13] the entry's widths {got_widths} are not [4]'s {widths}, "
                             f"whose launch counts the phase checks")
    out = BUILD_DIR / "serving"
    cache = BUILD_DIR / "phantom_cache"
    for d in (out, cache):
        shutil.rmtree(d, ignore_errors=True)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    common = ["--checkpoint", str(entry), "--synthetic", "--device", dev.type]
    saved_env = os.environ.get("HVC_PHANTOM_CACHE")
    os.environ["HVC_PHANTOM_CACHE"] = str(cache)
    try:
        infer, infer_text, infer_s, infer_lc = _cli_json(
            cli, ["infer", *common, "--index", str(SERVING_INDEX), "--output", str(out / "infer")])
        cached = sorted(p.name for p in cache.iterdir())
        ev, _, eval_s, eval_lc = _cli_json(
            cli, ["eval", *common, "--output", str(out / "evaluation_metrics.json")])
        insp, _, inspect_s, inspect_lc = _cli_json(cli, ["inspect", "--checkpoint", str(entry)])
        diag, _, diag_s, diag_lc = _cli_json(
            cli, ["diagnose", *common, "--index", str(SERVING_INDEX),
                  "--output", str(out / "diagnose.json")])
    finally:
        if saved_env is None:
            os.environ.pop("HVC_PHANTOM_CACHE")
        else:
            os.environ["HVC_PHANTOM_CACHE"] = saved_env

    # infer: one reconstruct for the export, one for the item's metrics
    exports, metrics = infer["exports"], infer["metrics"]
    vol = _saved_volume(Path(exports["npy"]))
    nii = read_nifti(exports["nifti"])
    size = m.stage_sizes[-1]
    pngs = ("summary", "views")
    log(f"[13] infer: {infer_s:.1f} s; exports {sorted(exports)}; .npy {tuple(vol.shape)} "
        f"{vol.dtype}, .nii.gz {nii.shape}; metrics {metrics}; matplotlib "
        f"{'present' if has_mpl else 'absent'}; phantom cache after infer {cached}")
    ok = (tuple(vol.shape) == (size,) * 3 and bool(torch.isfinite(vol.float()).all())
          and nii.shape == (size,) * 3 and bool(torch.isfinite(torch.from_numpy(nii)).all())
          and sorted(metrics) == sorted(f"stage{s}_{k}" for s in (1, 2, 3)
                                        for k in ("psnr", "ssim", "l1"))
          and all(math.isfinite(v) for v in metrics.values()) and len(cached) == 1)
    if has_mpl:
        ok = ok and all(Path(exports[k]).is_file() for k in pngs)
    else:
        ok = ok and not any(k in exports for k in pngs) and all(
            msg in infer_text for msg in ("summary figure skipped", "orthogonal views skipped"))
    if not ok:
        raise AssertionError(f"[13] infer: unexpected outputs {infer} / {infer_text!r}")

    # eval: one reconstruct per item of the test split
    rows = json.loads((out / "evaluation_metrics.json").read_text())["per_sample"]
    log(f"[13] eval: {eval_s:.1f} s; {len(rows)} test items; summary "
        f"{({k: round(v['mean'], 4) for k, v in ev.items()})}")
    if not rows or sorted(ev) != sorted(metrics) or not all(
            math.isfinite(v[s]) for v in ev.values() for s in ("mean", "std")):
        raise AssertionError(f"[13] eval: unexpected summary {ev}")

    # inspect: every tensor of the entry, no error
    log(f"[13] inspect: {inspect_s:.1f} s; {len(insp['arrays'])} tensors, meta epoch "
        f"{insp['meta'].get('epoch')}")
    if "error" in insp or insp["arrays"] != {k: str(tuple(v.shape)) for k, v in state.items()}:
        raise AssertionError(f"[13] inspect: {insp.get('error')} or the names and shapes differ")
    del state

    # diagnose: stage 1 with its cross-attention captured on the plain path
    losses = diag["losses"]
    log(f"[13] diagnose: {diag_s:.1f} s; captured {diag['captured_attention']}; "
        f"{len(losses)} losses, total {losses['total']:.4f}, cross_attention_align "
        f"{losses['cross_attention_align']:.4f}; health {diag['health']}")
    if diag["captured_attention"] != ["cross_attention"] or not all(
            math.isfinite(v) for v in losses.values()) or not losses["cross_attention_align"]:
        raise AssertionError(f"[13] diagnose: unexpected report {diag}")

    want = {"infer": {k: 2 * v for k, v in EXPECTED_LAUNCHES.items()},
            "eval": {k: len(rows) * v for k, v in EXPECTED_LAUNCHES.items()},
            "inspect": {},
            "diagnose": {**STAGE1_LAUNCHES, **{k: STAGE1_LAUNCHES[k] - m.stage_depths[0]
                                               for k in ("flash_attention", "flash_attention_tc")}}}
    launched = {"infer": infer_lc, "eval": eval_lc, "inspect": inspect_lc, "diagnose": diag_lc}
    for cmd, lc in launched.items():
        counted = {k: v for k, v in lc.items() if v}
        log(f"[13] {cmd} launches {counted} (expected {want[cmd]})")
        if counted != {k: v for k, v in want[cmd].items() if v}:
            raise AssertionError(f"[13] {cmd} launched {counted}, expected {want[cmd]}")
    phase_s = time.perf_counter() - t_phase
    log(f"[13] wall: infer {infer_s:.1f} s, eval {eval_s:.1f} s, inspect {inspect_s:.1f} s, "
        f"diagnose {diag_s:.1f} s; phase {phase_s:.1f} s")
    total = {k: sum(lc[k] for lc in launched.values()) for k in infer_lc}
    return {"wall_s": {"infer": infer_s, "eval": eval_s, "inspect": inspect_s,
                       "diagnose": diag_s, "phase": phase_s},
            "launches": total, "launches_by_command": launched, "infer_metrics": metrics,
            "eval_summary": ev, "test_items": len(rows), "diagnose": diag,
            "matplotlib": has_mpl}


# ------------------------------------------------------ the direct families ---

DIRECT_CONFIG = ROOT / "configs" / "direct_64.json"
DIRECT128_CONFIG = ROOT / "configs" / "direct128_h200.json"
DIRECT_B200_CONFIG = ROOT / "configs" / "direct256_b200.json"
# One DirectCTRegression forward at configs/direct_64.json's widths (64³,
# voxel_dim 256, depth 4, 4 heads, X-ray features 512 at 64² = 4,096 keys):
# A in the 4 self- and 4 cross-attentions (4 × 4,096 × 4,096 × 64 both, on
# the tensor cores), the 1→64 stride-2 stem (C, one-input-channel instance),
# the 64→128 token-stem conv (C, tensor cores) and the 128→256 projection at
# 16³ (B, tensor cores): stage 1's counts, the same backbone at the same widths.
EXPECTED_LAUNCHES_DIRECT = STAGE1_LAUNCHES
# A and D at the direct model's attention shape (BH, Nq, Nk, d): serving
# batch 1 and the config's training batch 8; [3] and [7] check both (and D
# bitwise) among the stage-1 shapes
DIRECT_FLASH = {"flash_attention": (4, 4096, 4096, 64), "flash_attention_bwd": (32, 4096, 4096, 64)}
DIRECT_PATIENTS = 10  # [14]'s cli train: 8 train, 1 val, 1 test at the config's splits
B200_PATIENTS = 2  # [14f]'s cli train: 1 train, 1 val (splits 0.5 / 0.5)


def _timed_reconstruct(engine, xr, dev) -> dict:
    """One warm-up reconstruct, then REPS timed ones (host clock ending in a
    sync) and the peak memory of the last one."""
    engine.reconstruct(xr)
    times = []
    for _ in range(REPS):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        engine.reconstruct(xr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"ms": [t * 1e3 for t in times], "median_ms": med * 1e3, "volumes_per_s": 1.0 / med,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _check_direct_step(lc: dict, calls: dict, where: str) -> None:
    """Every flash forward and backward of a bf16 direct_vit step on the
    tensor cores, every bf16 B, C, E, F and G call on the instance its rule
    names (tensor cores at Cin ≥ 8; the 1→64 stem and its dx, dW on the
    one-input- and one-dx-channel instances), nothing on the CUDA cores."""
    pairs = {"flash_attention": lc["flash_attention_tc"],
             "flash_attention_bwd": lc["flash_attention_bwd_tc"],
             "conv3d_k3s1": lc["conv3d_k3s1_tc"] - lc["conv3d_k3s1_dgrad"],
             "conv3d_k3s1_wgrad": lc["conv3d_k3s1_wgrad_tc"],
             "conv3d_k3s2": lc["conv3d_k3s2_tc"] + lc["conv3d_k3s2_c1in_tc"],
             "conv3d_k3s2_dgrad": lc["conv3d_k3s2_dgrad_tc"] + lc["conv3d_k3s2_dgrad_c1in_tc"],
             "conv3d_k3s2_wgrad": lc["conv3d_k3s2_wgrad_tc"] + lc["conv3d_k3s2_wgrad_c1in_tc"]}
    off = {k: (lc[k], v) for k, v in pairs.items() if lc[k] != v or not v}
    if off:
        raise AssertionError(f"{where}: launches off their rule's instance or missing "
                             f"(launched, on the instance): {off}")
    if any(lc[k] != calls["n"][k] for k in _RULE_COUNTERS):
        raise AssertionError(f"{where}: tensor-core launches differ from the calls the rules "
                             f"name {calls['n']}: {lc}")
    check_c1in(lc, calls["c1in"], where)


def direct_reference(dev, seed: int) -> dict:
    """Phase 14's small-input references, fp32, card (kernels, cuDNN with
    TF32 off) against CPU (plain versions): a scaled DirectCTRegression's
    eval forward and one deterministic train step's loss and gradients; a
    ResidualDenseBlock, CBAM, UpConvStage and Direct256Loss at 16³."""
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.losses.direct256 import Direct256Loss
    from hybrid_vit_cascade_tpu_torch.models import cnn_models as cm
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.trainer import single_model_step

    small = Config.from_json(str(DIRECT_CONFIG))
    sm = small.model
    sm.volume_size, sm.voxel_dim, sm.xray_feature_dim = (32, 32, 32), 128, 128
    sm.vit_depth, sm.num_heads, sm.dtype, small.data.xray_size = 1, 4, "float32", 64
    g = torch.Generator().manual_seed(seed + 50)
    batch = {"drr_stacked": torch.rand((2, 2, 1, 64, 64), generator=g) * 2 - 1,
             "ct_volume": torch.rand((2, 1, 32, 32, 32), generator=g) * 2 - 1}
    x16 = {"rdb": torch.randn((1, 16, 16, 16, 16), generator=g),
           "cbam": torch.randn((1, 32, 16, 16, 16), generator=g),
           "upconv": torch.randn((1, 8, 8, 8, 8), generator=g)}
    pred = torch.rand((1, 1, 16, 16, 16), generator=g) * 2 - 1
    target = (0.6 * pred + 0.4 * torch.rand(pred.shape, generator=g)).clamp(-1, 1)
    runs = {}
    for where in ("cpu", dev):
        model = seeded_init_(build_model(small), seed).to(where)
        b = {k: v.to(where) for k, v in batch.items()}
        with torch.no_grad():
            fwd = model.eval()(b["drr_stacked"]).cpu()
        state, step = single_model_step(model, small, 1, 1e-4, train=False)
        reset_launch_counts()
        _, metrics = step(state, b, None)
        launched = launch_counts()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        torch.manual_seed(seed)
        blocks = {"rdb": cm.ResidualDenseBlock(16, 24, 4), "cbam": cm.CBAM(32, 16),
                  "upconv": cm.UpConvStage(8, 16, 8, ((8, 2),))}
        with torch.no_grad():
            outs = {k: blk.to(where)(x16[k].to(where)).cpu() for k, blk in blocks.items()}
            loss = Direct256Loss()(pred.to(where), target.to(where))
            loss = {k: v.cpu() for k, v in loss.items()}
        runs[str(where)] = (fwd, metrics, grads, outs, loss, launched)
    (f_c, m_c, g_c, o_c, l_c, _), (f_g, m_g, g_g, o_g, l_g, launched) = runs["cpu"], runs[str(dev)]
    if sorted(g_c) != sorted(g_g) or not g_c:
        raise AssertionError("[14] the card and the CPU step trained different parameters")
    atol, rtol = SMALL_TOL
    pairs = ([("forward", f_g, f_c)] + [(f"loss {k}", m_g[k].cpu(), m_c[k]) for k in m_c]
             + [(f"grad {n}", g_g[n], w) for n, w in g_c.items()]
             + [(f"{k} 16³", o_g[k], w) for k, w in o_c.items()]
             + [(f"Direct256Loss {k}", l_g[k], w) for k, w in l_c.items()])
    worst = {}
    for name, got, want in pairs:
        diff = (got.float() - want.float()).abs()
        group = name.split()[0]
        worst[group] = max(worst.get(group, 0.0), float(diff.max()))
        if not bool((diff <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"[14] small reference {name}: card vs cpu max_abs_err "
                                 f"{float(diff.max())}")
    need = ("flash_attention", "flash_attention_bwd", "conv3d_k3s1", "conv3d_k3s2",
            "conv3d_k3s2_dgrad", "conv3d_k3s2_wgrad", "conv3d_k3s1_wgrad")
    if any(launched[k] == 0 for k in need):
        raise AssertionError(f"[14] the small step did not run every kernel of {need}: {launched}")
    log(f"[14] small references (fp32, card vs cpu, tol {atol:g}+{rtol:g}|ref|): max_abs_err "
        f"{ {k: f'{v:.3e}' for k, v in worst.items()} }; total_loss card "
        f"{float(m_g['total_loss']):.6f} cpu {float(m_c['total_loss']):.6f}; {len(g_c)} gradients; "
        f"launches of the step {({k: v for k, v in launched.items() if v})}")
    return {"max_abs_err": worst, "launches": launched}


def decoder256_train(dev, seed: int, cfgb, cfg_h200: Path) -> dict:
    """[14f]: Direct256ModelB200's 256³ step at configs/direct256_b200.json's
    batch 1 (1 + 1 steps, run twice from one state), ``cli train`` on a
    one-epoch copy of that config (B200_PATIENTS synthetic 256³ patients),
    and Direct256ModelH200's step at batch 1 on [14e]'s copy, or the
    allocator's numbers where it runs out of memory."""
    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    out = {}
    model = seeded_init_(build_model(cfgb), seed).to(dev)

    def run():
        return train_steps(model, cfgb, None, 1, 1,
                           torch.Generator(device=dev).manual_seed(seed + 44))

    start = {k: v.clone() for k, v in model.state_dict().items()}
    r = run()
    r["repeat"] = train_twice(model, run, start, (r["total_loss"], *_trained_state(model)))
    x = r["repeat"]
    log(f"[14f] direct256_b200 train step (256³, batch 1, Direct256Loss, remat): "
        f"{r['step_ms'][0]:.1f} ms (warm-up {r['warmup_s']:.2f} s); peak "
        f"{r['peak_allocated_gb']:.2f} GB, reserved {r['peak_reserved_gb']:.2f} GB; total_loss "
        f"{', '.join(f'{v:.5f}' for v in r['total_loss'])}; run twice from one state: losses "
        f"equal {x['losses_equal']}, {x['state_differing']} of {x['state_tensors']} state "
        f"tensors and {x['grads_differing']} of {x['grads']} gradients differ (max |diff| "
        f"{x['max_abs_diff']:.3e})")
    if not all(math.isfinite(v) for v in r["total_loss"]):
        raise AssertionError(f"[14f] direct256_b200: non-finite loss {r['total_loss']}")
    if not x["losses_equal"] or x["state_differing"] or x["grads_differing"]:
        raise AssertionError(f"[14f] the direct256_b200 step did not repeat bitwise: {x}")
    out["b200_train"] = r
    del model, start
    torch.cuda.empty_cache()

    save_dir = BUILD_DIR / "b200_train"
    shutil.rmtree(save_dir, ignore_errors=True)
    copy = _config_copy(DIRECT_B200_CONFIG, "direct256_b200_smoke.json", **{
        "training.num_epochs": 1, "data.synthetic": True,
        "data.synthetic_patients": B200_PATIENTS, "data.train_split": 0.5,
        "data.val_split": 0.5, "checkpoints.save_dir": str(save_dir)})
    final, _, train_s, train_lc = _cli_json(cli, ["train", "--config", str(copy),
                                                  "--device", dev.type])
    entries = sorted(p.name for p in save_dir.iterdir() if p.is_dir())
    log(f"[14f] cli train build/{copy.name} ({B200_PATIENTS} patients at 256³): {train_s:.1f} s, "
        f"final {final['final']}, entries {entries}")
    if (not {"latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"} <= set(entries)
            or not all(math.isfinite(v) for v in final["final"].values()) or any(train_lc.values())):
        raise AssertionError(f"[14f] cli train: {final}, {entries}, launches {train_lc}")
    out["b200_cli"] = {"wall_s": train_s, "final": final["final"], "entries": entries}
    torch.cuda.empty_cache()

    cfgh = Config.from_json(str(cfg_h200))
    model = seeded_init_(build_model(cfgh), seed).to(dev)
    r = train_steps(model, cfgh, None, 1, 1, torch.Generator(device=dev).manual_seed(seed + 45),
                    allow_oom=True)
    oom = r.get("out_of_memory")
    log(f"[14f] direct256_h200 train step (256³, batch 1): " + (
        f"out of memory: {oom['error']}; allocated {oom['allocated_gb']:.2f} GB, peak "
        f"{oom['max_allocated_gb']:.2f} GB, reserved {oom['reserved_gb']:.2f} GB of "
        f"{oom['card_gb']:.2f}; in {' < '.join(reversed(oom['where']))}" if oom else
        f"steps {', '.join(f'{v:.1f}' for v in r['step_ms'])} ms; peak "
        f"{r['peak_allocated_gb']:.2f} GB; total_loss {r['total_loss']}"))
    if not oom and not all(math.isfinite(v) for v in r["total_loss"]):
        raise AssertionError(f"[14f] direct256_h200: non-finite loss {r['total_loss']}")
    out["h200_decoder_train"] = r
    del model
    torch.cuda.empty_cache()
    return out


def direct_phase(dev, seed: int) -> dict:
    """Phase 14: the direct-regression families on their configs' widths."""
    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import (
        InferenceEngine,
        build_model,
        save_checkpoint,
    )
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    t_phase = time.perf_counter()
    rec = {}
    for name, shape in DIRECT_FLASH.items():  # checked in [3] / [7] among stage 1's shapes
        if shape not in {**KERNELS, **TRAIN_KERNELS}[name]["shapes"]:
            raise AssertionError(f"[14] {name} is not checked at the direct shape {shape}")
    xr = torch.rand((1, 2, 1, 512, 512), generator=torch.Generator().manual_seed(seed + 1))

    # 14a DirectCTRegression at full width: one reconstruct with its launches
    cfg = Config.from_json(str(DIRECT_CONFIG))
    m = cfg.model
    widths = (m.family, tuple(m.volume_size), m.voxel_dim, m.vit_depth, m.num_heads,
              m.xray_feature_dim, m.dtype, cfg.data.xray_size, cfg.training.batch_size)
    if widths != ("direct_vit", (64, 64, 64), 256, 4, 4, 512, "bfloat16", 512, 8):
        raise AssertionError(f"{DIRECT_CONFIG.name} no longer holds the direct_vit widths: "
                             f"{widths}")
    ckpt = CKPT_DIR / "direct_vit_seeded.pt"
    save_checkpoint(ckpt, cfg, seeded_init_(build_model(cfg), seed))
    engine = InferenceEngine(ckpt, device=dev)
    reset_launch_counts()
    vol = engine.reconstruct(xr)
    torch.cuda.synchronize()
    launched = launch_counts()
    counted = {k: v for k, v in launched.items() if v}
    finite = bool(torch.isfinite(vol.float()).all())
    if tuple(vol.shape) != (1, 1, 64, 64, 64) or not finite or counted != EXPECTED_LAUNCHES_DIRECT:
        raise AssertionError(f"[14] direct_vit reconstruct: {tuple(vol.shape)} finite={finite}, "
                             f"launches {counted} (expected {EXPECTED_LAUNCHES_DIRECT})")
    t = _timed_reconstruct(engine, xr, dev)
    log(f"[14] direct_vit reconstruct 64³ (batch 1, bf16): launches {counted} as expected; median "
        f"{t['median_ms']:.2f} ms over {REPS} ({', '.join(f'{v:.2f}' for v in t['ms'])}); "
        f"{t['volumes_per_s']:.2f} volumes/s; peak {t['peak_gb']:.2f} GB")
    rec["direct_vit"] = {**t, "launches": launched}
    del engine, vol

    # 14b its training step at the config's batch
    model = seeded_init_(build_model(cfg), seed).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    b = cfg.training.batch_size
    with rule_calls() as rc:
        r = train_steps(model, cfg, None, b, TRAIN_STEPS, g)
    calls = {"n": {k: n / (1 + TRAIN_STEPS) for k, n in rc.n.items()},
             "c1in": {k: n / (1 + TRAIN_STEPS) for k, n in rc.c1in_bf16.items()}}
    lc = r["launches_per_step"]
    r["train_direct_vit_64_b8_steps_per_sec"] = r.pop("steps_per_sec")
    log(f"[14] direct_vit train step (64³, batch {b}, {r['trainable_params'] / 1e6:.1f} M "
        f"parameters): {r['train_direct_vit_64_b8_steps_per_sec']:.3f} steps/s (steps "
        f"{', '.join(f'{v:.1f}' for v in r['step_ms'])} ms; warm-up {r['warmup_s']:.2f} s); "
        f"peak {r['peak_allocated_gb']:.2f} GB; total_loss "
        f"{', '.join(f'{v:.5f}' for v in r['total_loss'])}; launches per step "
        f"{({k: v for k, v in lc.items() if v})}")
    if not all(math.isfinite(v) for v in r["total_loss"]):
        raise AssertionError(f"[14] direct_vit: non-finite loss {r['total_loss']}")
    _check_direct_step(lc, calls, "[14] direct_vit step")
    rec["direct_vit_train"] = r
    del model
    torch.cuda.empty_cache()

    # 14c the entry points on a one-epoch copy of the config
    save_dir = BUILD_DIR / "direct_train"
    shutil.rmtree(save_dir, ignore_errors=True)
    copy = _config_copy(DIRECT_CONFIG, "direct_64_smoke.json", **{
        "training.num_epochs": 1, "data.synthetic": True,
        "data.synthetic_patients": DIRECT_PATIENTS, "checkpoints.save_dir": str(save_dir)})
    argv = ["train", "--config", str(copy), "--device", dev.type]
    final, _, train_s, train_lc = _cli_json(cli, argv)
    again, _, again_s, again_lc = _cli_json(cli, argv)
    entries = sorted(p.name for p in save_dir.iterdir() if p.is_dir())
    log(f"[14] cli train build/{copy.name}: {train_s:.1f} s, final {final['final']}, "
        f"entries {entries}; again {again_s:.1f} s: {again}")
    if (not {"latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"} <= set(entries)
            or not all(math.isfinite(v) for v in final["final"].values())
            or again != {"final": {}} or any(again_lc.values())):
        raise AssertionError(f"[14] cli train: {final}, {entries}; resumed run {again} "
                             f"launched {again_lc}")
    common = ["--checkpoint", str(save_dir / "best_psnr"), "--synthetic", "--device", dev.type]
    infer, _, infer_s, infer_lc = _cli_json(cli, ["infer", *common,
                                                  "--output", str(BUILD_DIR / "direct_infer")])
    ev, _, eval_s, eval_lc = _cli_json(cli, ["eval", *common,
                                             "--output", str(BUILD_DIR / "direct_eval.json")])
    diag, _, diag_s, diag_lc = _cli_json(cli, ["diagnose", *common])
    rows = json.loads((BUILD_DIR / "direct_eval.json").read_text())["per_sample"]
    metrics = infer["metrics"]
    saved = _saved_volume(Path(infer["exports"]["npy"]))
    log(f"[14] cli infer {infer_s:.1f} s: {metrics}, .npy {tuple(saved.shape)}; "
        f"eval {eval_s:.1f} s "
        f"({len(rows)} items): { {k: round(v['mean'], 4) for k, v in ev.items()} }; diagnose "
        f"{diag_s:.1f} s: captured {diag['captured_attention']}, {len(diag['losses'])} losses")
    keys = ["psnr", "psnr_dynamic", "ssim", "l1"]
    if (list(metrics) != keys or not all(math.isfinite(v) for v in metrics.values())
            or tuple(saved.shape) != (64, 64, 64) or not bool(torch.isfinite(saved.float()).all())
            or list(ev) != keys or not rows
            or diag["captured_attention"] != ["cross_attention"]
            or not all(math.isfinite(v) for v in diag["losses"].values())):
        raise AssertionError(f"[14] serving: infer {infer}, eval {ev}, diagnose {diag}")
    want = {"infer": {k: 2 * v for k, v in EXPECTED_LAUNCHES_DIRECT.items()},
            "eval": {k: len(rows) * v for k, v in EXPECTED_LAUNCHES_DIRECT.items()},
            "diagnose": {**EXPECTED_LAUNCHES_DIRECT, **{
                k: EXPECTED_LAUNCHES_DIRECT[k] - m.vit_depth
                for k in ("flash_attention", "flash_attention_tc")}}}
    for cmd, got in (("infer", infer_lc), ("eval", eval_lc), ("diagnose", diag_lc)):
        if {k: v for k, v in got.items() if v} != want[cmd]:
            raise AssertionError(f"[14] {cmd} launched {got}, expected {want[cmd]}")
    cli_lc = {k: sum(x[k] for x in (train_lc, infer_lc, eval_lc, diag_lc)) for k in train_lc}
    rec["direct_cli"] = {"wall_s": {"train": train_s, "train_again": again_s, "infer": infer_s,
                                    "eval": eval_s, "diagnose": diag_s},
                         "final": final["final"], "infer_metrics": metrics, "eval_summary": ev,
                         "captured_attention": diag["captured_attention"], "launches": cli_lc,
                         "train_launches": train_lc}
    torch.cuda.empty_cache()

    # 14d Direct128ModelH200: reconstruct, train at the config's batch 2
    cfg128 = Config.from_json(str(DIRECT128_CONFIG))
    if (cfg128.model.family, cfg128.model.dtype, cfg128.training.batch_size) != (
            "direct128_h200", "bfloat16", 2):
        raise AssertionError(f"{DIRECT128_CONFIG.name} changed: {cfg128.model}")
    ckpt128 = CKPT_DIR / "direct128_seeded.pt"
    save_checkpoint(ckpt128, cfg128, seeded_init_(build_model(cfg128), seed))
    decoders = {}

    def serve(name, path, size):
        engine = InferenceEngine(path, device=dev)
        reset_launch_counts()
        v = engine.reconstruct(xr)
        torch.cuda.synchronize()
        lc = {k: n for k, n in launch_counts().items() if n}
        ok = tuple(v.shape) == (1, 1, size, size, size) and bool(torch.isfinite(v.float()).all())
        t = _timed_reconstruct(engine, xr, dev)
        log(f"[14] {name} reconstruct {size}³ (batch 1, bf16, "
            f"{sum(p.numel() for p in engine.model.parameters()) / 1e6:.1f} M parameters"
            f"): finite {ok}; median {t['median_ms']:.1f} ms over "
            f"{REPS} ({', '.join(f'{x:.1f}' for x in t['ms'])}); peak {t['peak_gb']:.2f} GB; "
            f"hand-written kernels launched {lc}")
        if not ok or lc:  # the decoders are cuDNN's, as the JAX package's are XLA's
            raise AssertionError(f"[14] {name}: {tuple(v.shape)} finite {ok}, launches {lc}")
        decoders[name] = t

    serve("direct128_h200", ckpt128, 128)
    torch.cuda.empty_cache()
    model = seeded_init_(build_model(cfg128), seed).to(dev)
    r128 = train_steps(model, cfg128, None, 2, TRAIN_STEPS,
                       torch.Generator(device=dev).manual_seed(seed + 41))
    r128["train_direct128_h200_128_b2_steps_per_sec"] = r128.pop("steps_per_sec")
    log(f"[14] direct128_h200 train step (128³, batch 2, Direct256Loss, remat): "
        f"{r128['train_direct128_h200_128_b2_steps_per_sec']:.3f} steps/s (steps "
        f"{', '.join(f'{v:.1f}' for v in r128['step_ms'])} ms; warm-up {r128['warmup_s']:.2f} s); "
        f"peak {r128['peak_allocated_gb']:.2f} GB; total_loss "
        f"{', '.join(f'{v:.5f}' for v in r128['total_loss'])}")
    if not all(math.isfinite(v) for v in r128["total_loss"]):
        raise AssertionError(f"[14] direct128_h200: non-finite loss {r128['total_loss']}")
    rec["direct128_train"] = r128
    del model
    torch.cuda.empty_cache()

    # 14e cli transfer of it into direct256_h200, then serve the written entry
    tdir = BUILD_DIR / "direct_transfer"
    shutil.rmtree(tdir, ignore_errors=True)
    copy256 = _config_copy(DIRECT128_CONFIG, "direct256_h200_smoke.json", **{
        "model.family": "direct256_h200", "data.synthetic": True, "data.synthetic_patients": 4,
        "checkpoints.save_dir": str(tdir)})
    text, transfer_s, transfer_lc = _cli_text(cli, ["transfer", "--from-checkpoint",
                                                    str(ckpt128), "--init-only", "--config",
                                                    str(copy256), "--device", dev.type])
    line = text.strip().splitlines()[-1]
    counts = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
    log(f"[14] cli transfer {ckpt128.name} → {copy256.name} --init-only: "
        f"{transfer_s:.1f} s; {line}")
    if not line.startswith("transfer: ") or len(counts) < 2 or min(counts[:2]) <= 0 \
            or any(transfer_lc.values()):
        raise AssertionError(f"[14] transfer: {text!r}, launches {transfer_lc}")
    serve("direct256_h200", tdir / "latest", 256)
    torch.cuda.empty_cache()

    # 14f Direct256ModelB200: reconstruct, its 256³ step and cli train; the
    # H200 decoder's 256³ step
    cfgb = Config.from_json(str(DIRECT_B200_CONFIG))
    ckptb = CKPT_DIR / "direct256_b200_seeded.pt"
    save_checkpoint(ckptb, cfgb, seeded_init_(build_model(cfgb), seed))
    serve("direct256_b200", ckptb, 256)
    torch.cuda.empty_cache()
    rec.update(decoder256_train(dev, seed, cfgb, copy256))
    rec["decoders"] = decoders
    rec["transfer"] = {"line": line, "transferred": counts[0], "skipped": counts[1],
                       "wall_s": transfer_s}

    # 14g small-input references
    rec["reference"] = direct_reference(dev, seed)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[14] phase {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------- the diffusion family ---

DIFFUSION_64 = ROOT / "configs" / "diffusion_64.json"
DIFFUSION_R5 = ROOT / "configs" / "diffusion_quality_r5.json"
DIFFUSION_PROG = ROOT / "configs" / "diffusion_progressive.json"
# One denoise forward of stage1_low (64³, voxel_dim 256, depth 4, 4 heads):
# A in the 4 self- and 4 cross-attentions (4,096 queries over 4,096 voxel
# tokens and over the 64² X-ray features, d = 64), the 17→64 and 64→128
# token-stem convs (C, tensor cores: the noisy volume and the 16-channel
# prior) and the 128→256 projection at 16³ (B, tensor cores).
EXPECTED_LAUNCHES_DIFFUSION = {"flash_attention": 8, "flash_attention_tc": 8, "conv3d_k3s1": 1,
                               "conv3d_k3s1_tc": 1, "conv3d_k3s2": 2, "conv3d_k3s2_tc": 2}
# One of stage2_mid (128³, depth 6, 8 heads, d = 32): A 12, C 3 (17→64,
# 64→128, 128→256); the stem ends at voxel_dim, so no projection.
EXPECTED_LAUNCHES_DIFFUSION_S2 = {"flash_attention": 12, "flash_attention_tc": 12,
                                  "conv3d_k3s2": 3, "conv3d_k3s2_tc": 3}
# One of stage3_high (256³, depth 8, 8 heads, d = 32): A 16, C 3 (17→64,
# 64→128, 128→256 to 32³ tokens at voxel_dim: no projection).
EXPECTED_LAUNCHES_DIFFUSION_S3 = {"flash_attention": 16, "flash_attention_tc": 16,
                                  "conv3d_k3s2": 3, "conv3d_k3s2_tc": 3}
# One train step (remat: every block's forward runs again in the backward;
# the token stem does not): stage 1 A 16, D 8, C 2, F 2 (the 17-channel dx
# feeds the lifter), G 2, B 1, B as the dgrad 1, E 1; stage 2 A 24, D 12,
# C 3, F 3, G 3; stage 3 A 32, D 16, C 3, F 3, G 3.
DIFFUSION_STEP = {
    1: {"flash_attention": 16, "flash_attention_bwd": 8, "conv3d_k3s2": 2,
        "conv3d_k3s2_dgrad": 2, "conv3d_k3s2_wgrad": 2, "conv3d_k3s1": 1,
        "conv3d_k3s1_dgrad": 1, "conv3d_k3s1_wgrad": 1},
    2: {"flash_attention": 24, "flash_attention_bwd": 12, "conv3d_k3s2": 3,
        "conv3d_k3s2_dgrad": 3, "conv3d_k3s2_wgrad": 3, "conv3d_k3s1": 0,
        "conv3d_k3s1_dgrad": 0, "conv3d_k3s1_wgrad": 0},
    3: {"flash_attention": 32, "flash_attention_bwd": 16, "conv3d_k3s2": 3,
        "conv3d_k3s2_dgrad": 3, "conv3d_k3s2_wgrad": 3, "conv3d_k3s1": 0,
        "conv3d_k3s1_dgrad": 0, "conv3d_k3s1_wgrad": 0}}
# The shapes the slice first gives A, C, D, F and G ([3] and [7] check them):
# the training forwards and backwards of both stages and the 17→64 stem.
# stage3_high (256³, 8 heads of 32, batch 1) adds the 17→64 stem from 256³
# and A and D at 8 × 32,768² and 8 × 32,768 × 4,096 (the cascade's stage-3
# shapes, in both lists already).
_DIFF_FLASH = [(16, 4096, 4096, 64), (16, 4096, 4096, 32), (8, 32768, 32768, 32),
               (8, 32768, 4096, 32)]
DIFFUSION_AT = {"flash_attention": _DIFF_FLASH, "flash_attention_bwd": _DIFF_FLASH,
                "conv3d_k3s2": _S2_C17 + _S2_C17_256,
                "conv3d_k3s2_dgrad": _S2_C17 + _S2_C17_256,
                "conv3d_k3s2_wgrad": _S2_C17 + _S2_C17_256}
DIFFUSION_PATIENTS = 6  # [15]'s cli train: 4 train (and validation) patients at 128³
LIFT_TOL = 1e-4  # the streamed lifter against the dense one: × max|want|


def _check_diffusion_step(lc: dict, calls: dict, stage: int, where: str) -> None:
    """A bf16 diffusion step launched each kernel as often as DIFFUSION_STEP
    says, every flash forward and backward and every bf16 B, C, E, F and G
    call (the 17→64 stem's forward, dx and dW included) on its tensor-core
    instance, as many launches as the rules name, none with one channel."""
    pairs = {"flash_attention": lc["flash_attention_tc"],
             "flash_attention_bwd": lc["flash_attention_bwd_tc"],
             "conv3d_k3s1": lc["conv3d_k3s1_tc"] - lc["conv3d_k3s1_dgrad"],
             "conv3d_k3s1_wgrad": lc["conv3d_k3s1_wgrad_tc"],
             "conv3d_k3s2": lc["conv3d_k3s2_tc"],
             "conv3d_k3s2_dgrad": lc["conv3d_k3s2_dgrad_tc"],
             "conv3d_k3s2_wgrad": lc["conv3d_k3s2_wgrad_tc"]}
    off = {k: (lc[k], v) for k, v in pairs.items() if lc[k] != v}
    counts = {k: lc[k] for k in DIFFUSION_STEP[stage]}
    if off or counts != DIFFUSION_STEP[stage]:
        raise AssertionError(f"{where}: launches {counts} (expected {DIFFUSION_STEP[stage]}); "
                             f"off the tensor-core instance (launched, on it): {off}")
    if any(lc[k] != calls["n"][k] for k in _RULE_COUNTERS) or any(calls["c1in"].values()):
        raise AssertionError(f"{where}: tensor-core launches differ from the calls the rules "
                             f"name {calls}: {lc}")


def _diffusion_train(model, cfg, stage: int, batch: int, dev, seed: int, where: str) -> dict:
    """1 + TRAIN_STEPS train steps of a ladder stage (training.measure's
    train_steps over diffusion_steps' step), every loss component finite,
    launches checked by _check_diffusion_step."""
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    with rule_calls() as rc:
        r = train_steps(model, cfg, stage, batch, TRAIN_STEPS,
                        torch.Generator(device=dev).manual_seed(seed))
    calls = {"n": {k: n / (1 + TRAIN_STEPS) for k, n in rc.n.items()},
             "c1in": {k: n / (1 + TRAIN_STEPS) for k, n in rc.c1in_bf16.items()}}
    lc = r["launches_per_step"]
    log(f"{where} train step (stage {stage}, batch {batch}, {r['trainable_params'] / 1e6:.1f} M "
        f"trainable): median {statistics.median(r['step_ms']):.1f} ms (steps "
        f"{', '.join(f'{v:.1f}' for v in r['step_ms'])} ms; warm-up {r['warmup_s']:.2f} s); peak "
        f"{r.get('peak_allocated_gb', float('nan')):.2f} GB; losses per step "
        + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in m.items() if k != "total_loss")
                    for m in r["metrics"])
        + f"; launches per step {({k: v for k, v in lc.items() if v})}")
    bad = [m for m in r["metrics"] if not all(math.isfinite(v) for v in m.values())]
    if bad or set(r["metrics"][0]) != {"total_loss", "loss", "diffusion_loss", "physics_loss"}:
        raise AssertionError(f"{where}: loss components {r['metrics']}")
    _check_diffusion_step(lc, calls, stage, where)
    return r


def _sample(fn, dev, where: str, want: dict) -> tuple:
    """fn() under launch counting and a synced host clock: (its output, wall
    s, launches); the launches must be ``want``."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lc = {k: v for k, v in launch_counts().items() if v}
    if lc != want:
        raise AssertionError(f"{where}: launches {lc}, expected {want}")
    return out, wall, lc


# one denoise forward of each ladder stage ([15b], [15h])
EXPECTED_BY_STAGE = {"stage1_low": EXPECTED_LAUNCHES_DIFFUSION,
                     "stage2_mid": EXPECTED_LAUNCHES_DIFFUSION_S2,
                     "stage3_high": EXPECTED_LAUNCHES_DIFFUSION_S3}


def _cascade_sample(model, xr, n: int, dev, seed: int, where: str) -> dict:
    """``cascaded_ddim_sample`` of the whole ladder at batch 1 with ``n``
    steps, each stage under ``_sample`` (wall seconds; n × one denoise
    forward's launches, EXPECTED_BY_STAGE); every volume finite at its
    stage's size. Returns the steps, each stage's wall and launches, and the
    peak GB."""
    from hybrid_vit_cascade_tpu_torch.models import diffusion as dm

    per_stage, real = {}, dm.ddim_sample

    def timed(model, xrays, stage_name, *a, **kw):
        want = {k: n * v for k, v in EXPECTED_BY_STAGE[stage_name].items()}
        vol, wall, lc = _sample(lambda: real(model, xrays, stage_name, *a, **kw), dev,
                                f"{where} cascaded_ddim_sample {stage_name}", want)
        per_stage[stage_name] = {"wall_s": wall, "launches": lc}
        return vol
    dm.ddim_sample = timed
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        vols = dm.cascaded_ddim_sample(model, xr, torch.Generator(device=dev).manual_seed(seed),
                                       num_steps=n)
    finally:
        dm.ddim_sample = real
    want = {c["name"]: (1, 1, *c["volume_size"]) for c in model.stage_configs}
    if set(per_stage) != set(want):
        raise AssertionError(f"{where} cascaded_ddim_sample timed the stages {sorted(per_stage)}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    shapes = {k: tuple(v.shape) for k, v in vols.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in vols.values())
    log(f"{where} cascaded_ddim_sample (batch 1, {n} steps, bf16): {shapes} finite {finite}; "
        + "; ".join(f"{k} {v['wall_s']:.3f} s ({v['wall_s'] / n * 1e3:.1f} ms a step), "
                    f"launches {v['launches']}" for k, v in per_stage.items())
        + f"; peak {peak:.2f} GB")
    if shapes != want or not finite:
        raise AssertionError(f"{where} cascaded_ddim_sample: {shapes} finite {finite}")
    return {"steps": n, "per_stage": per_stage, "peak_gb": peak}


def lifter_streamed_vs_dense(dev, seed: int) -> dict:
    """Phase 15c: the depth lifter of stage2_mid at full width (D = 128, 64²
    X-ray features, C = 512, batch 1, a 64³ previous volume), fp32 with TF32
    off: the streamed fusion in 8 slabs against the dense one, value and the
    gradients of Σ out² (every parameter, the features, the previous volume)
    within LIFT_TOL·max|want|."""
    from hybrid_vit_cascade_tpu_torch.models.depth_lifting import CascadedDepthLifting
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_

    g = torch.Generator().manual_seed(seed + 70)
    feats = torch.randn((1, 512, 64, 64), generator=g)
    prev = torch.rand((1, 1, 64, 64, 64), generator=g) * 2 - 1
    dense = seeded_init_(CascadedDepthLifting(512, 128, lift_slabs=0), seed).to(dev)
    runs = {}
    for slabs in (0, 8):
        m = CascadedDepthLifting(512, 128, lift_slabs=slabs).to(dev)
        m.load_state_dict(dense.state_dict())
        f, p = feats.to(dev).requires_grad_(), prev.to(dev).requires_grad_()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m(f, p)
        (out.double() ** 2).sum().backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grads = {"features": f.grad, "prev": p.grad,
                 **{n: q.grad for n, q in m.named_parameters()}}
        runs[slabs] = (out.detach(), grads, wall, torch.cuda.max_memory_allocated(dev) / 1e9)
        del m, out
    (want, wg, w_s, w_gb), (got, gg, g_s, g_gb) = runs[0], runs[8]
    errs = {}
    for name, a, b in [("value", got, want)] + [(n, gg[n], wg[n]) for n in wg]:
        errs[name] = float((a - b).abs().max()) / float(b.abs().max())
    worst = max(errs, key=errs.get)
    log(f"[15c] lifter 128 × 64² × 512 (fp32, TF32 off), 8 slabs vs dense: max |err| / max|want| "
        f"{errs[worst]:.3e} at {worst} (value {errs['value']:.3e}); fwd+bwd {g_s:.2f} s, "
        f"{g_gb:.2f} GB streamed; {w_s:.2f} s, {w_gb:.2f} GB dense")
    if errs[worst] > LIFT_TOL or not all(math.isfinite(v) for v in errs.values()):
        raise AssertionError(f"[15c] the streamed lifter disagrees with the dense one: {errs}")
    return {"rel_err": errs, "streamed_s": g_s, "streamed_gb": g_gb, "dense_s": w_s,
            "dense_gb": w_gb}


def diffusion_reference(dev, seed: int) -> dict:
    """Phase 15e: a scaled two-stage ladder (16³ → 32³, voxel_dim 128 so
    that the heads are d = 32, depth 1, 4 heads, X-ray features 32, 64²
    X-rays, T = 1000) in fp32 from one seed, on the card (kernels, cuDNN with
    TF32 off) and on the CPU (plain versions): the refiner's loss components
    and every gradient from the same t and noise, and a 4-step ddim_sample of
    it from the same x_T, within SMALL_TOL."""
    from hybrid_vit_cascade_tpu_torch.models.diffusion import UnifiedHybridViTCascade, ddim_sample
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    ladder = tuple(dict(name=n, volume_size=(s, s, s), voxel_dim=128, vit_depth=1, num_heads=4,
                        use_depth_lifting=True, use_physics_loss=True)
                   for n, s in (("s1", 16), ("s2", 32)))
    g = torch.Generator().manual_seed(seed + 80)
    xr = torch.rand((2, 2, 1, 64, 64), generator=g) * 2 - 1
    x0 = torch.rand((2, 1, 32, 32, 32), generator=g) * 2 - 1
    prev = torch.rand((2, 1, 16, 16, 16), generator=g) * 2 - 1
    t = torch.randint(0, 1000, (2,), generator=g)
    noise = torch.randn(x0.shape, generator=g)
    x_T = torch.randn(x0.shape, generator=g)
    runs = {}
    for where in ("cpu", dev):
        model = seeded_init_(UnifiedHybridViTCascade(ladder, xray_embed_dim=32), seed).to(where)
        mv = lambda a: a.to(where)  # noqa: E731
        reset_launch_counts()
        ld = model(mv(x0), mv(xr), "s2", prev_stage_volume=mv(prev), t=mv(t), noise=mv(noise))
        ld["loss"].backward()
        launched = launch_counts()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        vol = ddim_sample(model, mv(xr), "s2", num_steps=4, prev_stage_volume=mv(prev),
                          x_T=mv(x_T)).cpu()
        runs[str(where)] = ({k: v.detach().cpu() for k, v in ld.items()}, grads, vol, launched)
        del model
    (l_c, g_c, v_c, _), (l_g, g_g, v_g, launched) = runs["cpu"], runs[str(dev)]
    if sorted(g_c) != sorted(g_g) or len(g_c) < 40:
        raise AssertionError("[15e] the card and the CPU step reached different parameters")
    atol, rtol = SMALL_TOL
    pairs = ([(f"loss {k}", l_g[k], w) for k, w in l_c.items()] + [("ddim_sample", v_g, v_c)]
             + [(f"grad {n}", g_g[n], w) for n, w in g_c.items()])
    worst = {}
    for name, got, want in pairs:
        diff = (got.float() - want.float()).abs()
        group = name.split()[0]
        worst[group] = max(worst.get(group, 0.0), float(diff.max()))
        if not bool((diff <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"[15e] small reference {name}: card vs cpu max_abs_err "
                                 f"{float(diff.max())}")
    need = ("flash_attention", "flash_attention_bwd", "conv3d_k3s1", "conv3d_k3s1_wgrad",
            "conv3d_k3s1_dgrad", "conv3d_k3s2", "conv3d_k3s2_dgrad", "conv3d_k3s2_wgrad")
    if any(launched[k] == 0 for k in need):
        raise AssertionError(f"[15e] the small step did not run every kernel of {need}: "
                             f"{launched}")
    log(f"[15e] small references (fp32, card vs cpu, tol {atol:g}+{rtol:g}|ref|): max_abs_err "
        f"{ {k: f'{v:.3e}' for k, v in worst.items()} }; loss card {float(l_g['loss']):.6f} cpu "
        f"{float(l_c['loss']):.6f}; {len(g_c)} gradients; launches of the step "
        f"{({k: v for k, v in launched.items() if v})}")
    return {"max_abs_err": worst, "launches": launched}


# The ragged chunk's cost: C, F and G at the 17→64 stem's shapes beside the
# same calls with 16, 32 and 64 input channels (16-channel chunks in C, 32
# dx channels a block in F, 32-channel Cin blocks in G), bf16, kernel alone.
CIN_COST = (16, 17, 32, 64)


def cin_cost(dev, seed: int) -> dict:
    """Phase 15f: CUDA-event medians of C, F and G (bf16, 5 launches each
    after a warm-up) at each _S2_C17 shape with Cin ∈ CIN_COST."""
    from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck

    out = {}
    for b, _, cout, dhw in _S2_C17:
        for cin in CIN_COST:
            sh = (b, cin, cout, dhw)
            x, w, bias = _inputs("conv3d_k3s2", sh, torch.bfloat16, dev, seed)
            gy, _, xe = _train_inputs("conv3d_k3s2_dgrad", sh, torch.bfloat16, dev, seed)
            calls = {"C": (lambda: ck.conv3d_k3(x, w, bias, 2, 1, (dhw[0] - 1) // 2 + 1,
                                                dense=True)),
                     "F": lambda: ck.conv3d_k3_dgrad(gy, w, xe, 2, 1, dense=True),
                     "G": lambda: ck.conv3d_k3_wgrad(x, gy, 2, 1, dense=True)}
            for k, fn in calls.items():
                fn()
                out[f"{k} {sh}"] = statistics.median(_once(lambda: fn(), ()) for _ in range(5))
            del x, w, bias, gy, xe
        log(f"[15f] C / F / G at {b} × Cin→{cout} from {dhw[0]}³, Cin {CIN_COST}: "
            + "; ".join(f"{k} " + ", ".join(f"{out[f'{k} {(b, c, cout, dhw)}']:.3f}"
                                             for c in CIN_COST) for k in "CFG") + " ms")
    return out


def _diffusion_256_config() -> Path:
    """A copy of diffusion_progressive.json under build/ whose ladder reaches
    256³: ``volume_size`` 256³ and a ``stage3`` entry (batch 1, stage 2's
    learning rate, one epoch)."""
    stage2 = json.loads(DIFFUSION_PROG.read_text())["training"]["stages"]["stage2"]
    return _config_copy(DIFFUSION_PROG, "diffusion_progressive_256.json", **{
        "model.volume_size": [256, 256, 256],
        "training.stages.stage3": {"num_epochs": 1, "batch_size": 1,
                                   "learning_rate": stage2["learning_rate"],
                                   "target_resolution": [256, 256, 256]}})


def diffusion_256(dev, seed: int, xr) -> dict:
    """[15g]-[15i]: the ladder's third stage, stage3_high (256³, voxel_dim
    256, depth 8, 8 heads of 32, 32,768 voxel tokens, a 256-deep lifter), on
    a copy of diffusion_progressive.json whose ladder reaches 256³. [15g] one
    warm-up and one timed step at batch 1 (training.measure's train_steps over
    diffusion_steps' step; launches DIFFUSION_STEP[3] on the tensor-core
    instances), run twice from one state with every bit of the losses, state
    and gradients equal, then one more step under torch.profiler; out of
    memory fails the phase, after the allocator's numbers are logged. [15h]
    cascaded_ddim_sample 64³ → 128³ → 256³ at the config's steps, batch 1,
    bf16 (seconds and launches a stage). [15i] cli train on the copy, one
    epoch a stage, DIFFUSION_PATIENTS synthetic 256³ patients,
    diffusion_sample_steps cut to 2, then again: every stage skipped."""
    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    rec, t0 = {}, time.perf_counter()
    copy = _diffusion_256_config()
    cfg = Config.from_json(str(copy))
    model = seeded_init_(build_model(cfg), seed).to(dev)
    ladder = [(c["name"], c["volume_size"], c["vit_depth"], c["num_heads"])
              for c in model.stage_configs]
    if ladder != [("stage1_low", (64, 64, 64), 4, 4), ("stage2_mid", (128, 128, 128), 6, 8),
                  ("stage3_high", (256, 256, 256), 8, 8)] or cfg.model.voxel_dim != 256:
        raise AssertionError(f"[15g] {copy.name}'s ladder {ladder}")

    def run(profile: bool = False, steps: int = 1):
        with rule_calls() as rc:
            r = train_steps(model, cfg, 3, 1, steps,
                            torch.Generator(device=dev).manual_seed(seed + 66),
                            allow_oom=True, profile=profile)
        if "out_of_memory" in r:
            o = r["out_of_memory"]
            log(f"[15g] stage3_high step (256³, batch 1): out of memory: {o['error']}; "
                f"allocated {o['allocated_gb']:.2f} GB, peak {o['max_allocated_gb']:.2f} GB, "
                f"reserved {o['reserved_gb']:.2f} GB of {o['card_gb']:.2f}; in "
                f"{' < '.join(reversed(o['where']))}")
            raise AssertionError("[15g] stage3_high ran out of memory at batch 1")
        r["calls"] = {"n": {k: n / (1 + steps) for k, n in rc.n.items()},
                      "c1in": {k: n / (1 + steps) for k, n in rc.c1in_bf16.items()}}
        return r

    start = {k: v.clone() for k, v in model.state_dict().items()}
    r = run()
    lc = r["launches_per_step"]
    r["repeat"] = train_twice(model, run, start, (r["total_loss"], *_trained_state(model)))
    x = r["repeat"]
    log(f"[15g] stage3_high train step (256³, batch 1, "
        f"{r['trainable_params'] / 1e6:.1f} M trainable): {r['step_ms'][0]:.1f} ms (warm-up "
        f"{r['warmup_s']:.2f} s); peak {r['peak_allocated_gb']:.2f} GB, reserved "
        f"{r['peak_reserved_gb']:.2f} GB; losses per step "
        + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in m.items() if k != "total_loss")
                    for m in r["metrics"])
        + f"; launches per step {({k: v for k, v in lc.items() if v})}; run twice from one "
        f"state: losses equal {x['losses_equal']}, {x['state_differing']} of "
        f"{x['state_tensors']} state tensors and {x['grads_differing']} of {x['grads']} "
        f"gradients differ (max |diff| {x['max_abs_diff']:.3e})")
    if not all(math.isfinite(v) for m in r["metrics"] for v in m.values()):
        raise AssertionError(f"[15g] stage3_high: loss components {r['metrics']}")
    _check_diffusion_step(lc, r["calls"], 3, "[15g]")
    if not x["losses_equal"] or x["state_differing"] or x["grads_differing"]:
        raise AssertionError(f"[15g] the stage3_high step did not repeat bitwise: {x}")
    prof = run(profile=True, steps=0)["profile"]
    log(f"[15g] profiled stage3_high step: wall {prof['wall_ms']:.1f} ms, kernels "
        f"{prof['kernel_ms']:.1f} ms, idle {prof['idle_share']:.1%}; top: "
        + "; ".join(f"{t['name'][:60]} {t['ms']:.1f} ms ×{t['launches']}" for t in prof["top"][:12]))
    r["profile"] = prof
    rec.update(train_s3_b1=r, config=copy.name)
    del start
    torch.cuda.empty_cache()

    # 15h the whole cascaded sampler, 64³ → 128³ → 256³
    model.eval()
    rec["cascade_sample_256"] = _cascade_sample(model, xr, cfg.training.diffusion_sample_steps,
                                                dev, seed + 67, "[15h]")
    del model
    torch.cuda.empty_cache()

    # 15i cli train on a one-epoch-a-stage copy, then again
    save_dir = BUILD_DIR / "diffusion_train256"
    shutil.rmtree(save_dir, ignore_errors=True)
    train_copy = _config_copy(copy, "diffusion_progressive_256_smoke.json", **{
        "training.stages.stage1.num_epochs": 1, "training.stages.stage2.num_epochs": 1,
        "training.diffusion_sample_steps": 2, "data.synthetic_patients": DIFFUSION_PATIENTS,
        "checkpoints.save_dir": str(save_dir)})
    argv = ["train", "--config", str(train_copy), "--device", dev.type]
    final, _, train_s, train_lc = _cli_json(cli, argv)
    log_file = save_dir / "training_log.jsonl"
    rows = [json.loads(r) for r in log_file.read_text().splitlines()]
    again, out_again, again_s, _ = _cli_json(cli, argv)
    rows_again = [json.loads(r) for r in log_file.read_text().splitlines()][len(rows):]
    stages = ("stage1_low", "stage2_mid", "stage3_high")
    latest = [(save_dir / f"diffusion_{n}" / "latest").is_dir() for n in stages]
    skipped = [f"[diffusion_{n}] complete" in out_again for n in stages]
    chain = [r for r in rows if r.get("phase") == "diffusion_chain_eval"]
    log(f"[15i] cli train build/{train_copy.name} (one epoch a stage, {DIFFUSION_PATIENTS} "
        f"patients at 256³, diffusion_sample_steps cut to 2): {train_s:.1f} s; phases "
        f"{[r['phase'] for r in rows]}; final {final['final']}; latest written {latest}; again "
        f"{again_s:.1f} s: stages skipped {skipped}, phases {[r['phase'] for r in rows_again]}")
    if (not all(latest) or not all(skipped) or len(chain) != 1
            or [r["phase"] for r in rows] != [f"diffusion_{n}" for n in stages]
            + ["diffusion_chain_eval"]
            or not all(math.isfinite(v) for k, v in chain[0].items() if k != "phase")
            or [r["phase"] for r in rows_again] != ["diffusion_chain_eval"]
            or not all(math.isfinite(v) for v in final["final"].values())):
        raise AssertionError(f"[15i] cli train: rows {rows}, again {rows_again}, final {final}")
    rec["cli_train"] = {"wall_s": train_s, "again_s": again_s, "final": final["final"],
                        "again": again["final"], "launches": train_lc,
                        "phases": [r["phase"] for r in rows]}
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def diffusion_phase(dev, seed: int) -> dict:
    """Phase 15: the diffusion family at its configs' full widths."""
    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.models import diffusion as dm
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    rec = {}
    for name, shapes in DIFFUSION_AT.items():  # checked and timed in [3] / [7]
        spec = {**KERNELS, **TRAIN_KERNELS}[name]
        if not set(shapes) <= set(spec["shapes"]):
            raise AssertionError(f"[15] {name} is not checked at the diffusion shapes {shapes}")
    xr = torch.rand((1, 2, 1, 512, 512), generator=torch.Generator().manual_seed(seed + 1)).to(dev)

    # 15a diffusion_64: stage1_low's train step, one denoise forward, ddim_sample
    cfg = Config.from_json(str(DIFFUSION_64))
    m, t = cfg.model, cfg.training
    widths = (m.family, tuple(m.volume_size), m.voxel_dim, m.xray_feature_dim, m.dtype,
              m.use_gradient_checkpointing, t.batch_size, t.diffusion_sample_steps)
    if widths != ("diffusion", (64, 64, 64), 256, 512, "bfloat16", True, 4, 20):
        raise AssertionError(f"{DIFFUSION_64.name} changed: {widths}")
    model = seeded_init_(build_model(cfg), seed).to(dev)
    ladder = [(c["name"], c["volume_size"], c["vit_depth"], c["num_heads"])
              for c in model.stage_configs]
    if ladder != [("stage1_low", (64, 64, 64), 4, 4)]:
        raise AssertionError(f"[15] diffusion_64's ladder {ladder}")
    rec["train_64_b4"] = _diffusion_train(model, cfg, 1, 4, dev, seed + 60, "[15a]")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 61)
    x = torch.randn((1, 1, 64, 64, 64), generator=gen, device=dev)
    t999 = torch.full((1,), 999, dtype=torch.long, device=dev)
    with torch.no_grad():
        v, _, _ = _sample(lambda: model(x, xr, "stage1_low", mode="denoise", t=t999), dev,
                          "[15a] one denoise forward", EXPECTED_LAUNCHES_DIFFUSION)
    n = t.diffusion_sample_steps
    want = {k: n * c for k, c in EXPECTED_LAUNCHES_DIFFUSION.items()}
    walls = []
    for _ in range(2):  # the first call cold (cuDNN plans), the second warm
        torch.cuda.reset_peak_memory_stats(dev)
        vol, wall, lc = _sample(lambda: dm.ddim_sample(
            model, xr, "stage1_low", torch.Generator(device=dev).manual_seed(seed + 62),
            num_steps=n), dev, "[15a] ddim_sample", want)
        walls.append(wall)
    finite = bool(torch.isfinite(vol).all())
    log(f"[15a] ddim_sample 64³ (batch 1, {n} steps, bf16): {tuple(vol.shape)} finite {finite}, "
        f"std {float(vol.std()):.4f}; wall {walls[0]:.3f} s cold, {walls[1]:.3f} s warm "
        f"({walls[1] / n * 1e3:.1f} ms a step); peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
        f" GB; launches {lc} (one denoise forward {EXPECTED_LAUNCHES_DIFFUSION})")
    if tuple(vol.shape) != (1, 1, 64, 64, 64) or not finite or not bool(torch.isfinite(v).all()):
        raise AssertionError(f"[15a] ddim_sample: {tuple(vol.shape)} finite {finite}")
    rec["sample_64"] = {"wall_s": walls, "steps": n, "launches": lc,
                        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del model, vol, v
    torch.cuda.empty_cache()

    # 15b diffusion_quality_r5 (streamed lifter) and diffusion_progressive
    # (dense): stage2_mid's step; then the r5 ladder's cascaded DDIM
    steps = {}
    for path, slabs, batch, key in ((DIFFUSION_R5, 8, 2, "r5"), (DIFFUSION_PROG, 0, 1, "prog")):
        c = Config.from_json(str(path))
        w = (c.model.family, tuple(c.model.volume_size), c.model.voxel_dim, c.model.dtype,
             c.model.diffusion_lift_slabs, c.training.stages["stage2"].batch_size,
             c.training.diffusion_progressive)
        if w != ("diffusion", (128, 128, 128), 256, "bfloat16", slabs, batch, True):
            raise AssertionError(f"{path.name} changed: {w}")
        model = seeded_init_(build_model(c), seed).to(dev)
        ladder = [(s["name"], s["volume_size"], s["vit_depth"], s["num_heads"])
                  for s in model.stage_configs]
        if ladder != [("stage1_low", (64, 64, 64), 4, 4), ("stage2_mid", (128, 128, 128), 6, 8)]:
            raise AssertionError(f"[15] {path.name}'s ladder {ladder}")
        steps[key] = _diffusion_train(model, c, 2, batch, dev, seed + 63,
                                      f"[15b] {path.stem} stage2_mid")
        torch.cuda.empty_cache()
        if key != "r5":
            del model
            continue
        rec["cascade_sample_r5"] = _cascade_sample(model, xr, c.training.diffusion_sample_steps,
                                                   dev, seed + 64, "[15b]")
        del model
        torch.cuda.empty_cache()
    rec["train_r5_s2_b2"], rec["train_prog_s2_b1"] = steps["r5"], steps["prog"]

    # 15c the streamed lifter against the dense one, full width, fp32
    rec["lifter"] = lifter_streamed_vs_dense(dev, seed)
    torch.cuda.empty_cache()

    # 15d cli train on a one-epoch-a-stage copy of diffusion_quality_r5.json
    save_dir = BUILD_DIR / "diffusion_train"
    shutil.rmtree(save_dir, ignore_errors=True)
    copy = _config_copy(DIFFUSION_R5, "diffusion_quality_r5_smoke.json", **{
        "training.stages.stage1.num_epochs": 1, "training.stages.stage2.num_epochs": 1,
        "training.diffusion_sample_steps": 2, "data.synthetic_patients": DIFFUSION_PATIENTS,
        "checkpoints.save_dir": str(save_dir)})
    argv = ["train", "--config", str(copy), "--device", dev.type]
    final, _, train_s, train_lc = _cli_json(cli, argv)
    log_file = save_dir / "training_log.jsonl"
    rows = [json.loads(r) for r in log_file.read_text().splitlines()]
    again, _, again_s, _ = _cli_json(cli, argv)
    rows_again = [json.loads(r) for r in log_file.read_text().splitlines()][len(rows):]
    chain = [r for r in rows if r.get("phase") == "diffusion_chain_eval"]
    latest = [(save_dir / f"diffusion_{s}" / "latest").is_dir() for s in ("stage1_low", "stage2_mid")]
    log(f"[15d] cli train build/{copy.name} (one epoch a stage, {DIFFUSION_PATIENTS} patients, "
        f"diffusion_sample_steps cut to 2 for wall time): {train_s:.1f} s; phases "
        f"{[r['phase'] for r in rows]}; final {final['final']}; latest written {latest}; again "
        f"{again_s:.1f} s: phases {[r['phase'] for r in rows_again]}")
    if (not all(latest) or len(chain) != 1
            or not all(math.isfinite(v) for k, v in chain[0].items() if k != "phase")
            or [r["phase"] for r in rows_again] != ["diffusion_chain_eval"]
            or not all(math.isfinite(v) for v in final["final"].values())):
        raise AssertionError(f"[15d] cli train: rows {rows}, again {rows_again}, final {final}")
    rec["cli_train"] = {"wall_s": train_s, "again_s": again_s, "final": final["final"],
                        "again": again["final"], "launches": train_lc,
                        "phases": [r["phase"] for r in rows]}
    torch.cuda.empty_cache()

    # 15e small-input reference; 15f the 17-channel calls beside 16, 32, 64
    rec["reference"] = diffusion_reference(dev, seed)
    rec["cin_cost_ms"] = cin_cost(dev, seed)
    torch.cuda.empty_cache()

    # 15g-15i stage3_high at 256³: its step, the whole sampler, cli train
    rec["s256"] = diffusion_256(dev, seed, xr)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[15] phase {rec['phase_s']:.1f} s")
    return rec


SERVE_TOL = 2 ** -7  # [16]: the served volume against reconstruct, × max|want|
SERVE_DIR = BUILD_DIR / "serving"
# [16]'s fresh process: it imports the serving loader (and through it the
# operator module) and nothing else of the port, loads the artifact, runs it
# on the saved X-rays and prints the model modules it imported and the
# largest difference from the saved reconstruct.
_FRESH_SERVE = """
import json, sys, time
import torch
t0 = time.perf_counter()
from hybrid_vit_cascade_tpu_torch.inference.serving import load_serving
path, xr, want, device = sys.argv[1:5]
serve = load_serving(path, device=device)
got = serve(torch.load(xr)).cpu()
want = torch.load(want)
models = sorted(m for m in sys.modules if m.startswith("hybrid_vit_cascade_tpu_torch.models"))
print(json.dumps({"models": models, "max_diff": float((got.float() - want.float()).abs().max()),
                  "load_and_run_s": time.perf_counter() - t0}))
"""


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seeded_checkpoint(cfg_path: Path, name: str, seed: int) -> Path:
    """A checkpoint of the config's model with weights seeded as [4] and [14]
    seed theirs (the file those phases wrote, when it is there)."""
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model, save_checkpoint
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_

    ckpt = CKPT_DIR / name
    if not ckpt.exists():
        CKPT_DIR.mkdir(parents=True, exist_ok=True)
        cfg = Config.from_json(str(cfg_path))
        save_checkpoint(ckpt, cfg, seeded_init_(build_model(cfg), seed))
    return ckpt


def export_phase(dev, seed: int, card: str) -> dict:
    """Phase 16: the serving artifact (``export_serving`` / ``load_serving``,
    ``cli export``) of the full-width cascade and direct_vit."""
    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.inference.infer import InferenceEngine, load_checkpoint
    from hybrid_vit_cascade_tpu_torch.inference.serving import load_serving
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    rec = {}
    for name, cfg_path, ckpt_name, want_launches, kw in (
            ("cascade", CONFIG, "cascade_seeded.pt", EXPECTED_LAUNCHES, {"max_stage": 3}),
            ("direct_vit", DIRECT_CONFIG, "direct_vit_seeded.pt", EXPECTED_LAUNCHES_DIRECT, {})):
        engine = InferenceEngine(_seeded_checkpoint(cfg_path, ckpt_name, seed), device=dev)
        size = engine.cfg.data.xray_size  # [4]'s and [14]'s X-ray pair
        xr = torch.rand((1, 2, 1, size, size), generator=torch.Generator().manual_seed(seed + 1))
        torch.save(xr, SERVE_DIR / "xrays.pt")
        path = SERVE_DIR / f"{name}.pt2"
        t0 = time.perf_counter()
        info = engine.export_serving(path, **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = load_serving(path, device=dev.type)
        load_s = time.perf_counter() - t0
        reset_launch_counts()
        got = serve(xr)
        _sync(dev)
        launched = launch_counts()
        counted = {k: v for k, v in launched.items() if v}
        want = engine.reconstruct(xr, **kw)
        diff = float((got.float() - want.float()).abs().max())
        tol = SERVE_TOL * float(want.float().abs().max())
        log(f"[16] {name}: export {export_s:.1f} s, artifact {info['bytes'] / 1e9:.3f} GB, load "
            f"{load_s:.1f} s; sidecar {json.dumps(info)}; one served call launches {counted}; "
            f"max |served - reconstruct| {diff:.3e} (tol {tol:.3e}) on {card}")
        if counted != {k: v for k, v in want_launches.items() if v}:
            raise AssertionError(f"[16] {name}: a served call launched {counted}, expected "
                                 f"{want_launches} and no gradient kernel")
        if not (diff <= tol and torch.isfinite(got.float()).all()) or got.shape != want.shape:
            raise AssertionError(f"[16] {name}: served {tuple(got.shape)} differs from "
                                 f"reconstruct {tuple(want.shape)} by {diff}")
        if info["platforms"] != [dev.type] or info["output_shape"] != [list(want.shape)]:
            raise AssertionError(f"[16] {name}: sidecar {info}")
        times = {"served": [], "reconstruct": []}
        for i in range(REPS):  # in turns
            for which in (("served", "reconstruct") if i % 2 == 0 else ("reconstruct", "served")):
                t0 = time.perf_counter()
                serve(xr) if which == "served" else engine.reconstruct(xr, **kw)
                _sync(dev)
                times[which].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"[16] {name}: median of {REPS} in turns: served {med['served']:.2f} ms "
            f"({', '.join(f'{t:.2f}' for t in times['served'])}), reconstruct "
            f"{med['reconstruct']:.2f} ms ({', '.join(f'{t:.2f}' for t in times['reconstruct'])})"
            f" on {card}")
        rec[name] = {"export_s": export_s, "bytes": info["bytes"], "load_s": load_s,
                     "sidecar": info, "launches": launched, "max_abs_diff": diff, "tol": tol,
                     "served_ms": times["served"], "reconstruct_ms": times["reconstruct"],
                     "served_median_ms": med["served"],
                     "reconstruct_median_ms": med["reconstruct"], "card": card}
        torch.save(want.cpu(), SERVE_DIR / f"{name}_want.pt")
        del serve, engine, got, want
        torch.cuda.empty_cache()
        if name != "cascade":
            path.unlink()
            continue
        res = subprocess.run([sys.executable, "-c", _FRESH_SERVE, str(path),
                              str(SERVE_DIR / "xrays.pt"), str(SERVE_DIR / f"{name}_want.pt"),
                              dev.type],
                             capture_output=True, text=True, cwd=ROOT, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"[16] {name}: the fresh process failed:\n{res.stderr[-4000:]}")
        fresh = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"[16] {name}: fresh process: model modules imported {fresh['models']}, max diff "
            f"{fresh['max_diff']:.3e}, import + load + run {fresh['load_and_run_s']:.1f} s")
        if fresh["models"] or not fresh["max_diff"] <= tol:
            raise AssertionError(f"[16] {name}: fresh process {fresh}")
        rec[name]["fresh"] = fresh
        path.unlink()

    # 16c cli export on [11]'s entry
    entry = BUILD_DIR / "cli_train" / "stage3" / "best_psnr"
    size = load_checkpoint(entry)[0]["model"]["stage_sizes"][2]
    out = SERVE_DIR / "quality_r5.pt2"
    info, _, wall, _ = _cli_json(cli, ["export", "--checkpoint", str(entry), "--output", str(out),
                                       "--device", dev.type])
    log(f"[16c] cli export {entry.relative_to(ROOT)}: {wall:.1f} s; {json.dumps(info)}")
    if (info["output_shape"] != [[1, 1, size, size, size]] or info["platforms"] != [dev.type]
            or info["bytes"] != out.stat().st_size):
        raise AssertionError(f"[16c] cli export: {info}")
    rec["cli_export"] = {"wall_s": wall, "sidecar": info}
    shutil.rmtree(SERVE_DIR)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[16] phase {rec['phase_s']:.1f} s")
    return rec


class _NaNXrays:
    """[17]'s debug_nans check: a dataset whose X-rays are NaN."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = dict(self.ds[i])
        item["drr_stacked"] = item["drr_stacked"] * float("nan")
        return item


class _RecordingWandb:
    """[17]'s stand-in for the wandb module: it records init, log and Image
    calls, so the run's wandb logging is checked and the real package (which
    the card's machine may have) is never imported or called."""

    def __init__(self):
        self.calls = []

    def init(self, **kwargs):
        self.calls.append(("init", sorted(kwargs)))

    def log(self, metrics, step=None):
        self.calls.append(("log", sorted(metrics), step))

    def Image(self, path):  # noqa: N802 (wandb's name)
        return path


OBS_PATIENTS = 6  # [17]: 4 train, 1 val, 1 test at quality_r5.json's splits
# [17]: the keys of each epoch's wandb row, JAX's (training/trainer.py:844-847)
OBS_WANDB_KEYS = ["loss", "phase", "psnr", "ssim", "train_loss"]
# [17]'s trace check: kernel names (the port's kernels sit in anonymous
# namespaces, as training/measure.py:kernel_profile's ``own`` filter reads
# them) that each phase's trace must hold: A, D and the convs
OBS_KERNELS = {"A": ("flash_fwd",), "D": ("flash_bwd_kernel", "flash_bwd_tc_kernel"),
               "conv": ("conv",)}


def observability_phase(dev, seed: int, card: str) -> dict:
    """Phase 17: ``cli train`` with ``profile_dir``, ``debug_nans``,
    ``viz_every`` and ``use_wandb``, then debug_nans on a NaN batch."""
    import importlib.util

    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    save_dir = BUILD_DIR / "observability"
    shutil.rmtree(save_dir, ignore_errors=True)
    prof_dir = save_dir / "profile"
    overrides = {"model.voxel_dim": 128, "model.xray_feature_dim": 128,
                 "model.stage_depths": [1, 1, 1], "model.stage_heads": [4, 4, 4],
                 "model.stage_sizes": [8, 16, 32], "data.xray_size": 64,
                 "data.synthetic_patients": OBS_PATIENTS,
                 **{f"training.stages.stage{n}.{k}": v for n, size in zip((1, 2, 3), (8, 16, 32))
                    for k, v in (("num_epochs", 1), ("batch_size", 2),
                                 ("target_resolution", [size] * 3))},
                 "training.profile_dir": str(prof_dir), "training.debug_nans": True,
                 "training.viz_every": 1, "training.use_wandb": True,
                 "checkpoints.save_dir": str(save_dir)}
    copy = _config_copy(TRAIN_CONFIG, "quality_r5_observability.json", **overrides)
    recorder = _RecordingWandb()
    real = sys.modules.get("wandb")
    sys.modules["wandb"] = recorder  # what utils/wandb_compat.py imports
    from hybrid_vit_cascade_tpu_torch.utils import wandb_compat

    saved = wandb_compat.wandb, wandb_compat.WANDB_AVAILABLE, wandb_compat._active
    wandb_compat.wandb, wandb_compat.WANDB_AVAILABLE = recorder, True
    try:
        text, train_s, launched = _cli_text(cli, ["train", "--config", str(copy), "--device",
                                                  dev.type])
    finally:
        wandb_compat.wandb, wandb_compat.WANDB_AVAILABLE, wandb_compat._active = saved
        if real is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = real
    final = json.loads(text.strip().splitlines()[-1])["final"]
    rows = [json.loads(r) for r in (save_dir / "training_log.jsonl").read_text().splitlines()]
    epochs = [(r["phase"], r["epoch"]) for r in rows if "train_loss" in r]
    phases = ("stage1", "stage2", "stage3")
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    viz_failed = text.count("visualization failed")
    log(f"[17] cli train build/{copy.name} (quality_r5.json at [5]'s widths, one epoch a stage, "
        f"{OBS_PATIENTS} patients, all four flags): {train_s:.1f} s on {card}; epochs {epochs}; "
        f"'[viz] ... visualization failed' printed {viz_failed} times (matplotlib "
        f"{'installed' if matplotlib else 'absent'}); final {final}")
    if epochs != [(s, 0) for s in phases] or not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"[17] cli train: epochs {epochs}, final {final}")
    viz_rows = [r for r in rows if "viz_files" in r]
    if (viz_failed, len(viz_rows)) != ((0, 3) if matplotlib else (3, 0)):
        raise AssertionError(f"[17] figures: {viz_failed} failures, {len(viz_rows)} rows")
    logged = [c for c in recorder.calls if c[0] == "log" and "phase" in c[1]]
    log(f"[17] wandb (a recording stand-in): {len(recorder.calls)} calls, "
        f"{[c[0] for c in recorder.calls]}; epoch rows' keys {[c[1] for c in logged]}")
    if recorder.calls[0][0] != "init" or [c[1] for c in logged] != [OBS_WANDB_KEYS] * 3:
        raise AssertionError(f"[17] wandb calls: {recorder.calls}")
    traces = {}
    for s in phases:
        path = prof_dir / f"{s}_epoch000.json"
        events = json.loads(path.read_text())["traceEvents"]
        names = {e["name"].removeprefix("void ") for e in events if e.get("cat") == "kernel"}
        own = sorted(n for n in names if n.startswith("(anonymous namespace)::"))
        found = {k: any(p in n for n in own for p in pats) for k, pats in OBS_KERNELS.items()}
        traces[s] = {"bytes": path.stat().st_size, "kernel_names": len(names), "own": own,
                     "found": found}
        log(f"[17] {path.relative_to(ROOT)}: {path.stat().st_size / 1e6:.2f} MB, {len(names)} "
            f"kernel names, {len(own)} of the port's; A, D, convs found {found}")
        if not all(found.values()):
            raise AssertionError(f"[17] {s}'s trace lacks kernels: {found}; own {own}")

    # 17b debug_nans: one step on a batch of NaN X-rays raises
    cfg = Config.from_json(str(copy))
    cfg.training.profile_dir, cfg.training.viz_every, cfg.training.use_wandb = "", 0, False
    cfg.checkpoints.save_dir = str(save_dir / "nan")
    trainer = Trainer(cfg, device=dev)
    trainer.train_ds = _NaNXrays(trainer.train_ds)
    try:
        trainer.fit_cascade(stages=("stage1",), progress=False)
    except FloatingPointError as exc:
        raised = str(exc)
    else:
        raise AssertionError("[17b] debug_nans: a step on NaN X-rays raised no FloatingPointError")
    log(f"[17b] debug_nans on NaN X-rays: FloatingPointError({raised!r})")
    shutil.rmtree(save_dir)
    rec = {"train_s": train_s, "launches": launched, "epochs": epochs, "viz_failed": viz_failed,
           "wandb_calls": recorder.calls, "traces": traces, "debug_nans": raised, "phase_s": time.perf_counter() - t_phase}
    log(f"[17] phase {rec['phase_s']:.1f} s")
    return rec


# ------------------------------------------------------- data parallelism ---

PARALLEL_PATIENTS = 11  # [18]: 8 train (one global batch of 8), 1 val, 2 test
PARALLEL_EPOCHS = 3  # [18]: stage 1's steps, one an epoch
PARALLEL_TIMEOUT_S = 300  # one [18] training process (or torchrun and its ranks)
PARALLEL_CACHE = BUILD_DIR / "phantom_cache18"


def _phantom(item: tuple) -> None:
    """[18]'s pool worker: synthetic patient ``i`` written to the phantom
    cache ``cache`` (numpy on one host core)."""
    import os

    from hybrid_vit_cascade_tpu_torch.data.synthetic import SyntheticCTDataset

    i, n, size, xray, cache = item
    os.environ["HVC_PHANTOM_CACHE"] = cache
    SyntheticCTDataset(num_patients=n, volume_size=(size,) * 3, xray_size=xray)[i]


def parallel_run(out: Path, config: Path, no_dropout: bool) -> None:
    """[18]'s training process: ``cli.main(["train", ...])`` on ``config``,
    under torchrun when launched so (a process group of the ranks), plain
    otherwise. Writes to ``out`` (``<out>.rank<r>.json``): every step's loss
    (the global batch's) and wall ms, the kernel launches of the run (counted from 0), the
    checkpoint entries and log rows this process wrote, and the collective
    backend it trained under."""
    import os

    import torch.distributed as dist

    from hybrid_vit_cascade_tpu_torch import cli
    from hybrid_vit_cascade_tpu_torch.models import layers
    from hybrid_vit_cascade_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.parallel.mesh import all_reduce_mean, ambient_group
    from hybrid_vit_cascade_tpu_torch.training import trainer as trainer_mod
    from hybrid_vit_cascade_tpu_torch.training.checkpoint import CheckpointManager
    from hybrid_vit_cascade_tpu_torch.utils.logging import CSVLogger, JSONLLogger

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if no_dropout:  # one process and n ranks draw other masks
        real_init = layers.Dropout.__init__
        layers.Dropout.__init__ = lambda self, rate: real_init(self, 0.0)
    rank = int(os.environ.get("RANK", 0))
    rec = {"rank": rank, "losses": [], "step_ms": [], "writes": [], "rows": 0, "backend": None}
    real_stage_step = trainer_mod.stage_step

    def timed_stage_step(*a, **kw):
        state, step = real_stage_step(*a, **kw)

        def timed(state, batch, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(all_reduce_mean(m["total_loss"].float(), ambient_group())))
            rec["backend"] = dist.get_backend() if dist.is_initialized() else None
            return state, m
        return state, timed

    real_write, real_csv, real_jsonl = CheckpointManager._write, CSVLogger.log, JSONLLogger.log

    def write(self, name, tree, meta):
        rec["writes"].append(f"{self.save_dir.name}/{name}@{meta['epoch']}")
        real_write(self, name, tree, meta)

    def row(real):
        def logged(self, *a, **kw):
            rec["rows"] += 1
            real(self, *a, **kw)
        return logged

    trainer_mod.stage_step = timed_stage_step
    CheckpointManager._write, CSVLogger.log, JSONLLogger.log = (write, row(real_csv),
                                                                row(real_jsonl))
    _build.library()  # built by the parent in [2]
    reset_launch_counts()
    cli.main(["train", "--config", str(config)])
    torch.cuda.synchronize()
    rec["launches"] = launch_counts()
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(rec))


def _parallel_child(name: str, config: Path, nproc: int, no_dropout: bool = False) -> dict:
    """Run [18]'s training process (``nproc`` 0: plain; else torchrun with
    that many ranks) and return its ranks' records and its wall seconds."""
    import os
    import signal

    out = BUILD_DIR / "parallel" / name
    for f in out.parent.glob(f"{name}.rank*.json"):
        f.unlink()
    me = [str(ROOT / "chip_smoke.py"), "--parallel-run", str(out), "--config", str(config)]
    me += ["--no-dropout"] if no_dropout else []
    argv = ([sys.executable, *me] if not nproc else
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(nproc), *me])
    env = {**os.environ, "HVC_PHANTOM_CACHE": str(PARALLEL_CACHE)}
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=PARALLEL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[18] {name}: rc {proc.returncode} after {wall:.1f} s\n{text[-6000:]}")
    recs = [json.loads(out.parent.joinpath(f"{name}.rank{r}.json").read_text())
            for r in range(max(nproc, 1))]
    return {"ranks": recs, "wall_s": wall, "final": text.strip().splitlines()[-1]}


def parallel_phase(dev, seed: int, card: str) -> dict:
    """Phase 18: ``cli train`` under ``torchrun --standalone --nproc_per_node
    1`` (an NCCL process group of one) against the same command run plain,
    each in a process of its own, on a copy of configs/quality_r5.json at
    full width, stage 1 only (stages 2-3 at 0 epochs), PARALLEL_EPOCHS
    epochs of one step at the config's batch 8 on synthetic 256³ patients
    (the train and val ones made once, in parallel, into a phantom cache). Checks: the loss of
    every step and the final parameters bitwise equal, every checkpoint
    entry and log row written once and by rank 0 alone, the same kernel
    launches; prints each run's step times. With two cards or more, also 2
    ranks against one process, dropout off in both, within bf16's
    tolerance."""
    import multiprocessing

    from hybrid_vit_cascade_tpu_torch.data.dataset import create_train_val_datasets
    from hybrid_vit_cascade_tpu_torch.training.checkpoint import load_entry

    t_phase = time.perf_counter()
    save = BUILD_DIR / "parallel"
    shutil.rmtree(save, ignore_errors=True)
    save.mkdir(parents=True)
    raw = json.loads(TRAIN_CONFIG.read_text())
    size, xray = max(raw["model"].get("stage_sizes", [64, 128, 256])), raw["data"]["xray_size"]
    # the train and val patients (the test split is never read), one process each
    train, val, _ = create_train_val_datasets(range(PARALLEL_PATIENTS), raw["data"]["train_split"],
                                              raw["data"]["val_split"], seed=42)
    used = [int(i) for i in (*train.indices, *val.indices)]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(used)) as pool:
        pool.map(_phantom, [(i, PARALLEL_PATIENTS, size, xray, str(PARALLEL_CACHE)) for i in used])
    phantom_s = time.perf_counter() - t0

    def config(run: str) -> Path:
        return _config_copy(TRAIN_CONFIG, f"quality_r5_parallel_{run}.json", **{
            "training.stages.stage1.num_epochs": PARALLEL_EPOCHS,
            "training.stages.stage2.num_epochs": 0, "training.stages.stage3.num_epochs": 0,
            "data.synthetic_patients": PARALLEL_PATIENTS, "training.viz_every": 0,
            "checkpoints.save_dir": str(save / run)})

    plain = _parallel_child("plain", config("plain"), 0)
    group = _parallel_child("nccl1", config("nccl1"), 1)
    p, g = plain["ranks"][0], group["ranks"][0]
    log(f"[18] the {len(used)} train and val patients of {PARALLEL_PATIENTS} (synthetic, "
        f"{size}³) into the phantom cache in {phantom_s:.1f} s ({len(used)} processes); plain run {plain['wall_s']:.1f} s, torchrun "
        f"--nproc_per_node 1 {group['wall_s']:.1f} s (process start, model, data, "
        f"{PARALLEL_EPOCHS} epochs and checkpoints)")
    if p["backend"] is not None or g["backend"] != "nccl":
        raise AssertionError(f"[18] backends: plain {p['backend']}, torchrun {g['backend']}")
    sd_p = load_entry(save / "plain" / "stage1" / "latest")[0]["state_dict"]
    sd_g = load_entry(save / "nccl1" / "stage1" / "latest")[0]["state_dict"]
    differ = [k for k in sd_p if not torch.equal(sd_p[k], sd_g[k])]
    log(f"[18a] stage-1 losses plain {p['losses']}, NCCL group of one {g['losses']}; "
        f"{len(differ)} of {len(sd_p)} tensors of stage1/latest differ")
    if p["losses"] != g["losses"] or differ or len(p["losses"]) != PARALLEL_EPOCHS:
        raise AssertionError(f"[18a] the group of one is not bitwise the plain run: losses "
                             f"{p['losses']} vs {g['losses']}, tensors {differ[:5]}")
    writes = [w for w in g["writes"]]
    log(f"[18b] rank 0 wrote {len(writes)} entries ({writes}) and {g['rows']} log rows; the "
        f"plain run {len(p['writes'])} and {p['rows']}")
    if writes != p["writes"] or len(set(writes)) != len(writes) or g["rows"] != p["rows"] or \
            g["rows"] != 2 * PARALLEL_EPOCHS:
        raise AssertionError(f"[18b] writes {writes} / rows {g['rows']} against the plain "
                             f"run's {p['writes']} / {p['rows']}")
    letters = {k: v for k, v in g["launches"].items() if v}
    log(f"[18c] launches under the group {letters}; plain "
        f"{({k: v for k, v in p['launches'].items() if v})}")
    if g["launches"] != p["launches"] or not letters:
        raise AssertionError(f"[18c] the group launched {g['launches']}, plain {p['launches']}")
    med = {k: statistics.median(r["step_ms"][1:]) for k, r in (("plain", p), ("nccl1", g))}
    log(f"[18d] stage-1 step (full width, batch 8, bf16) ms: plain {p['step_ms']}, NCCL group "
        f"of one {g['step_ms']}; median after the first {med['plain']:.1f} / {med['nccl1']:.1f} "
        f"ms on {card}")
    rec = {"phantom_s": phantom_s, "plain": plain, "nccl1": group, "median_step_ms": med,
           "launches": g["launches"], "card": card}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        one = _parallel_child("plain_nodrop", config("plain_nodrop"), 0, no_dropout=True)
        two = _parallel_child("nccl2", config("nccl2"), 2, no_dropout=True)
        lo, lt = one["ranks"][0]["losses"], two["ranks"][0]["losses"]
        sd_o = load_entry(save / "plain_nodrop" / "stage1" / "latest")[0]["state_dict"]
        sd_t = load_entry(save / "nccl2" / "stage1" / "latest")[0]["state_dict"]
        atol, rtol = TOL[torch.bfloat16]
        bad = [k for k in sd_o if not torch.allclose(sd_t[k], sd_o[k], rtol=rtol, atol=atol)]
        rank1 = two["ranks"][1]
        log(f"[18e] 2 ranks (NCCL) vs one process on the global batch of 8, dropout off: "
            f"losses {lt} vs {lo}; {len(bad)} tensors outside {atol:g}+{rtol:g}|ref|; rank 1 "
            f"wrote {len(rank1['writes'])} entries, {rank1['rows']} rows; step ms "
            f"{two['ranks'][0]['step_ms']} vs {one['ranks'][0]['step_ms']}")
        if (not torch.allclose(torch.tensor(lt), torch.tensor(lo), rtol=rtol, atol=atol) or bad
                or rank1["writes"] or rank1["rows"]):
            raise AssertionError(f"[18e] 2 ranks disagree with one process: {lt} vs {lo}, "
                                 f"{bad[:5]}, rank 1 wrote {rank1['writes']}")
        rec.update(plain_nodrop=one, nccl2=two)
    else:
        log(f"[18e] 2 ranks against one process: not run, this machine has {n_cards} card")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[18] phase {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------- the h200 cascade [19] ---

H200_CONFIG = ROOT / "configs" / "progressive_h200.json"
H200_BATCH = {1: 8, 2: 4, 3: 2}  # the config's stage batches
# The shapes the h200 cascade (voxel_dim 512, 16 heads of 32) first gives the
# kernels: its token stems in → 128 → 256 → 512 (stage 3 from 256³ at batch
# 2, stage 2 from 128³ at batch 4; stage 1's 128→256 from 32³ and 1→128 from
# 64³ at batch 8) for C, F and G; stage 3's self- and cross-attention at
# batch 2 (2 × 16 heads over 32,768 voxel tokens and 4,096 X-ray tokens) for
# A and D; I, J and K on a training slab of the stage-3 stem's first conv (8
# slabs at 256³: 33 planes to 16), with Σ/Σ² and without and with the gelu
# prologue.
_H200_S2 = [(2, 32, 128, (256, 256, 256)), (2, 128, 256, (128, 128, 128)),
            (2, 256, 512, (64, 64, 64)), (4, 32, 128, (128, 128, 128)),
            (4, 128, 256, (64, 64, 64)), (4, 256, 512, (32, 32, 32)),
            (8, 128, 256, (32, 32, 32)), (8, 1, 128, (64, 64, 64))]
_H200_FLASH = [(32, 32768, 32768, 32), (32, 32768, 4096, 32)]
_H200_CHAIN = [(2, 32, 128, 33, 256, 256, 0, 16, True, None),
               (2, 32, 128, 33, 256, 256, 0, 16, True, "gelu")]
H200_CHECKS = (({"flash_attention": _H200_FLASH, "conv3d_k3s2": _H200_S2}, "_inputs", "_fns"),
               ({"flash_attention_bwd": _H200_FLASH, "conv3d_k3s2_dgrad": _H200_S2,
                 "conv3d_k3s2_wgrad": _H200_S2}, "_train_inputs", "_train_fns"),
               ({"conv3d_k3s2_chain": _H200_CHAIN, "conv3d_k3s2_chain_dgrad": _H200_CHAIN,
                 "conv3d_k3s2_chain_wgrad": _H200_CHAIN}, "_chain_inputs", "_chain_fns"))
# the hot one of each, timed beside its plain version and library call (the
# ``h200`` entry of its row in the kernels line)
H200_AT = {"flash_attention": _H200_FLASH[0], "flash_attention_bwd": _H200_FLASH[0],
           "conv3d_k3s2": _H200_S2[0], "conv3d_k3s2_dgrad": _H200_S2[0],
           "conv3d_k3s2_wgrad": _H200_S2[0]}


def h200_phase(dev, seed: int) -> dict:
    """Phase 19: ``configs/progressive_h200.json`` at full width and depth.
    Its kernels at the new shapes in bf16 against their plain versions, and
    the hot ones timed; one reconstruct at batch 1 (max_stage=3) with its
    launches and REPS timed ones; one warm-up and one timed step of each
    stage at the config's batch, halved while it runs out of memory (each
    failure logged with the allocator's numbers), with its launches per
    step, every flash forward and backward on the tensor cores and every
    call the rules send there taken there (stage 1's 1→128 stem gives F a
    dx of one channel from 128: past the one-dx-channel instance's 64, so
    its CUDA cores)."""
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import (
        InferenceEngine,
        build_model,
        save_checkpoint,
    )
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    t_phase = time.perf_counter()
    cfg = Config.from_json(str(H200_CONFIG))
    m = cfg.model
    widths = (m.family, m.voxel_dim, m.xray_feature_dim, m.dtype, tuple(m.stage_depths),
              tuple(m.stage_heads), tuple(m.stage_sizes), cfg.data.xray_size, m.stage3_slab_scan,
              tuple(cfg.training.stages[f"stage{n}"].batch_size for n in (1, 2, 3)))
    if widths != ("cascade", 512, 512, "bfloat16", (4, 8, 12), (16, 16, 16), (64, 128, 256),
                  512, False, tuple(H200_BATCH.values())):
        raise AssertionError(f"{H200_CONFIG.name} no longer holds the h200 cascade: {widths}")
    rec = {"max_abs_err": {}, "rows": {}}
    CKPT_DIR.mkdir(parents=True, exist_ok=True)

    # 19a the kernels at the new shapes, bf16
    log("[19] kernels at the h200 cascade's shapes vs plain versions (bf16)")
    for specs, inputs, fns in H200_CHECKS:
        inputs, fns = globals()[inputs], globals()[fns]
        rec["max_abs_err"].update(check_kernels(
            dev, seed, {k: {"shapes": v, "ragged": []} for k, v in specs.items()}, inputs, fns,
            scaled=inputs is not _inputs, dtypes=(torch.bfloat16,)))
        timed = {k: {"shapes": [H200_AT[k]]} for k in specs if k in H200_AT}
        rec["rows"].update(time_kernels(dev, seed, timed, inputs, fns))
    torch.cuda.empty_cache()

    # 19b reconstruct at batch 1
    ckpt = CKPT_DIR / "h200_seeded.pt"
    model = seeded_init_(build_model(cfg), seed)
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(ckpt, cfg, model)
    del model
    engine = InferenceEngine(ckpt, device=dev, max_stage=3)
    xs = cfg.data.xray_size
    xr = torch.rand((1, 2, 1, xs, xs), generator=torch.Generator().manual_seed(seed + 1))
    reset_launch_counts()
    vol = engine.reconstruct(xr, max_stage=3)
    torch.cuda.synchronize()
    launched = launch_counts()
    finite = bool(torch.isfinite(vol.float()).all())
    n_attn = 2 * sum(m.stage_depths)  # a self- and a cross-attention a block
    if (tuple(vol.shape) != (1, 1, 256, 256, 256) or not finite
            or launched["flash_attention"] != n_attn or launched["flash_attention_tc"] != n_attn
            or not launched["conv3d_k3s2"] or any(launched[k] for k in launched if "grad" in k)):
        raise AssertionError(f"[19] reconstruct: {tuple(vol.shape)} finite={finite}, launches "
                             f"{launched} (A {n_attn} on the tensor cores, C, no gradient kernel)")
    t = _timed_reconstruct(engine, xr, dev)
    log(f"[19] progressive_h200 reconstruct 256³ (batch 1, bf16, {n_params / 1e6:.1f} M "
        f"parameters): median {t['median_ms']:.1f} ms over {REPS} "
        f"({', '.join(f'{v:.1f}' for v in t['ms'])}); {t['volumes_per_s']:.3f} volumes/s; peak "
        f"{t['peak_gb']:.2f} GB; launches {({k: v for k, v in launched.items() if v})}")
    rec["reconstruct"] = {**t, "launches": launched, "n_params": n_params}
    del engine, vol
    torch.cuda.empty_cache()

    # 19c one step of each stage, at the config's batch or the largest that fits
    model = seeded_init_(build_model(cfg), seed).to(dev)
    for stage in (1, 2, 3):
        b, ooms = H200_BATCH[stage], {}
        while True:
            g = torch.Generator(device=dev).manual_seed(seed + 60 + stage)
            with rule_calls() as rc:
                r = train_steps(model, cfg, stage, b, 1, g, allow_oom=True)
            if "out_of_memory" not in r:
                break
            o = ooms[b] = r["out_of_memory"]
            log(f"[19] stage {stage} at batch {b}: out of memory: {o['error']}; allocated "
                f"{o['allocated_gb']:.2f} GB, peak {o['max_allocated_gb']:.2f} GB, reserved "
                f"{o['reserved_gb']:.2f} GB of {o['card_gb']:.2f}")
            if b == 1:
                raise AssertionError(f"[19] stage {stage} does not fit at batch 1")
            b //= 2
        lc = r["launches_per_step"]
        r.update(batch=b, out_of_memory_at=ooms)
        log(f"[19] stage {stage} step ({m.stage_sizes[stage - 1]}³, batch {b}"
            f"{'' if b == H200_BATCH[stage] else f', the config says {H200_BATCH[stage]}'}, "
            f"{r['trainable_params'] / 1e6:.1f} M trainable): {r['step_ms'][0]:.1f} ms (warm-up "
            f"{r['warmup_s']:.2f} s); peak {r['peak_allocated_gb']:.2f} GB; total_loss "
            f"{', '.join(f'{v:.5f}' for v in r['total_loss'])}; launches per step "
            f"{({k: v for k, v in lc.items() if v})}")
        if not all(math.isfinite(v) for v in r["total_loss"]):
            raise AssertionError(f"[19] stage {stage}: non-finite loss {r['total_loss']}")
        want = {k: n / 2 for k, n in rc.n.items()}  # the warm-up step's half of two
        if (not lc["flash_attention"] or not lc["flash_attention_bwd"]
                or any(lc[f"{k}_tc"] != lc[k] for k in ("flash_attention", "flash_attention_bwd"))
                or any(lc[k] != want[k] for k in _RULE_COUNTERS)):
            raise AssertionError(f"[19] stage {stage}: launches {lc} off the tensor cores or "
                                 f"the rules' instances {want}")
        rec[f"stage{stage}"] = r
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    rec["launches"] = {k: launched[k] + sum(rec[f"stage{n}"]["launches_per_step"][k]
                                            for n in (1, 2, 3)) for k in launched}
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[19] launches by letter (reconstruct and each stage's first step): "
        f"{({k: v for k, v in rec['launches'].items() if v})}; phase {rec['phase_s']:.1f} s")
    return rec


# ------------------------------------------ a converted JAX run resumed [20] ---

# [21]: copies of progressive_cascade.json (voxel_dim 256) whose heads are
# d = 16 (16 heads at every stage) and d = 128 (2 heads)
HEAD_DIM_CASCADES = {16: (16, 16, 16), 128: (2, 2, 2)}


def head_dim_phase(dev, seed: int) -> dict:
    """Phase 21: the full-width cascade at head dims other than 32 and 64,
    for d in HEAD_DIM_CASCADES: a seeded checkpoint of the copy served by
    InferenceEngine (a 256³ reconstruct at batch 1, max_stage=3: finite, A 36
    times on the tensor cores, no gradient kernel), then one stage-3 train
    step at batch 1 with the fused backward (D on the tensor cores) and one
    with the split one (L and M on the tensor cores, no D), finite."""
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import (
        InferenceEngine,
        build_model,
        save_checkpoint,
    )
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops import attention
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.measure import train_steps

    rec, t_phase = {}, time.perf_counter()
    xr = torch.rand((1, 2, 1, 512, 512), generator=torch.Generator().manual_seed(seed + 1))
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    for d, heads in HEAD_DIM_CASCADES.items():
        copy = _config_copy(CONFIG, f"progressive_cascade_d{d}.json",
                            **{"model.stage_heads": list(heads)})
        cfg = Config.from_json(str(copy))
        model = seeded_init_(build_model(cfg), seed)
        dims = {m.head_dim for m in model.modules() if hasattr(m, "head_dim")}
        if dims != {d}:
            raise AssertionError(f"[21] {copy.name}: head dims {dims}, expected {d}")
        ckpt = CKPT_DIR / f"cascade_d{d}.pt"
        save_checkpoint(ckpt, cfg, model)
        del model
        engine = InferenceEngine(ckpt, device=dev, max_stage=3)
        reset_launch_counts()
        t0 = time.perf_counter()
        vol = engine.reconstruct(xr, max_stage=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launch_counts()
        finite = bool(torch.isfinite(vol.float()).all())
        log(f"[21] d = {d} ({heads} heads): reconstruct 256³ (batch 1, bf16, first call) "
            f"{wall:.2f} s, {tuple(vol.shape)} finite {finite}, std {float(vol.float().std()):.4f}; "
            f"launches {({k: v for k, v in launched.items() if v})}")
        if (tuple(vol.shape) != (1, 1, 256, 256, 256) or not finite
                or launched["flash_attention"] != 36 or launched["flash_attention_tc"] != 36
                or any(launched[k] for k in launched if "grad" in k or "bwd" in k)):
            raise AssertionError(f"[21] d = {d}: reconstruct {tuple(vol.shape)} finite {finite}, "
                                 f"launches {launched}")
        rec[f"d{d}_reconstruct"] = {"wall_s": wall, "launches": launched}
        del engine, vol
        torch.cuda.empty_cache()
        model = seeded_init_(build_model(cfg), seed).to(dev)
        fused_before = attention.FUSED_BWD
        for fused in (True, False):
            attention.FUSED_BWD = fused
            try:
                r = train_steps(model, cfg, 3, 1, 0,
                                torch.Generator(device=dev).manual_seed(seed + 90 + d))
            finally:
                attention.FUSED_BWD = fused_before
            lc = r["launches_per_step"]
            bwd = "fused" if fused else "split"
            log(f"[21] d = {d}: stage-3 step ({bwd} backward, batch 1) warm-up "
                f"{r['warmup_s']:.2f} s, peak {r['peak_allocated_gb']:.2f} GB, total_loss "
                f"{r['total_loss'][0]:.5f}; launches {({k: v for k, v in lc.items() if v})}")
            names = (("flash_attention_bwd",) if fused
                     else ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
            if (not all(math.isfinite(v) for v in r["total_loss"])
                    or any(not lc[k] or lc[f"{k}_tc"] != lc[k] for k in names)
                    or lc["flash_attention_tc"] != lc["flash_attention"]
                    or (not fused and lc["flash_attention_bwd"])):
                raise AssertionError(f"[21] d = {d} {bwd} step: loss {r['total_loss']}, "
                                     f"launches {lc}")
            rec[f"d{d}_train_{bwd}"] = r
        del model
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[21] phase {rec['phase_s']:.1f} s")
    return rec


ORBAX_EPOCH = 3  # the converted entry's epoch: the resume starts at epoch 4
ORBAX_COUNT = 7  # optax's Adam and schedule counts, and the trainer's step
ORBAX_STEPS_PER_EPOCH = 10  # the schedule's length: 10 × stage 2's epochs


def _flax_dense(sd: dict, prefix: str) -> dict:
    out = {"kernel": sd[prefix + "weight"].T.numpy()}
    if prefix + "bias" in sd:
        out["bias"] = sd[prefix + "bias"].numpy()
    return out


def _flax_norm(sd: dict, prefix: str) -> dict:
    return {"scale": sd[prefix + "weight"].numpy(), "bias": sd[prefix + "bias"].numpy()}


def _flax_conv(sd: dict, prefix: str) -> dict:
    w = sd[prefix + "weight"]  # (O, I, k…) → flax's (k…, I, O)
    return {"kernel": w.permute(*range(2, w.dim()), 1, 0).numpy(), "bias": sd[prefix + "bias"].numpy()}


def _ncdhw_conv(sd: dict, prefix: str) -> dict:
    return {"kernel": sd[prefix + "weight"].numpy(), "bias": sd[prefix + "bias"].numpy()}


def _jax_encoder(sd: dict, prefix: str) -> tuple[dict, dict]:
    """MultiScaleXrayEncoder's (params, batch_stats) in the JAX layout."""
    enc = prefix + "xray_encoder."
    params = {f"Conv_{i}": _flax_conv(sd, f"{enc}conv{i + 1}.") for i in range(3)}
    params.update({f"BatchNorm_{i}": _flax_norm(sd, f"{enc}bn{i + 1}.") for i in range(3)})
    params.update(to_cond=_flax_dense(sd, enc + "to_cond."), Dense_0=_flax_dense(sd, enc + "time1."),
                  Dense_1=_flax_dense(sd, enc + "time2."))
    stats = {f"BatchNorm_{i}": {"mean": sd[f"{enc}bn{i + 1}.running_mean"].numpy(),
                                "var": sd[f"{enc}bn{i + 1}.running_var"].numpy()} for i in range(3)}
    out = {"xray_encoder": params}
    branches = sorted({k[len(prefix + "down."):].split(".")[0] for k in sd
                       if k.startswith(prefix + "down.")})
    for i, name in enumerate(branches):
        out[f"{name}_conv"] = _flax_conv(sd, f"{prefix}down.{name}.conv.")
        out[f"GroupNorm_{i}"] = _flax_norm(sd, f"{prefix}down.{name}.norm.")
    return out, {"xray_encoder": stats}


def _jax_vit(sd: dict, prefix: str, ncdhw: bool) -> dict:
    """HybridViT3D's params in the JAX layout: its stem feature-first
    (ConvNCDHW_i / GroupNormNCDHW_i) or channels-last (Conv_i / GroupNorm_i)."""
    conv, gn, to_jax = (("ConvNCDHW", "GroupNormNCDHW", _ncdhw_conv) if ncdhw
                        else ("Conv", "GroupNorm", _flax_conv))
    n_conv = len({k.split(".")[0] for k in (k[len(prefix + "stem_convs."):] for k in sd
                                             if k.startswith(prefix + "stem_convs."))})
    out = {}
    for i in range(n_conv):
        out[f"{conv}_{i}"] = to_jax(sd, f"{prefix}stem_convs.{i}.")
        out[f"{gn}_{i}"] = _flax_norm(sd, f"{prefix}stem_norms.{i}.")
    if prefix + "proj.weight" in sd:
        out[f"{conv}_{n_conv}"] = to_jax(sd, prefix + "proj.")
    out["pos_embed"] = sd[prefix + "pos_embed"].numpy()
    blocks = sorted({int(k[len(prefix + "blocks."):].split(".")[0]) for k in sd
                     if k.startswith(prefix + "blocks.")})
    for i in blocks:
        b = f"{prefix}blocks.{i}."
        out[f"HybridViTBlock3D_{i}"] = {
            "AdaLNModulation_0": {"Dense_0": _flax_dense(sd, b + "adaln.linear.")},
            **{f"LayerNorm_{j}": _flax_norm(sd, f"{b}norm{j + 1}.") for j in range(3)},
            "MultiHeadSelfAttention_0": {"Dense_0": _flax_dense(sd, b + "self_attn.qkv."),
                                         "Dense_1": _flax_dense(sd, b + "self_attn.proj.")},
            "MultiHeadCrossAttention_0": {"q": _flax_dense(sd, b + "cross_attn.q."),
                                          "kv": _flax_dense(sd, b + "cross_attn.kv."),
                                          "Dense_0": _flax_dense(sd, b + "cross_attn.proj.")},
            "Mlp_0": {"Dense_0": _flax_dense(sd, b + "mlp.fc1."),
                      "Dense_1": _flax_dense(sd, b + "mlp.fc2.")}}
    out["LayerNorm_0"] = _flax_norm(sd, prefix + "norm.")
    out["Dense_0"] = _flax_dense(sd, prefix + "head.")
    return out


def cascade_jax_layout(sd: dict) -> dict:
    """A cascade's port state dict as the JAX package's ``{"params",
    "batch_stats"}`` numpy tree: what ``convert.cascade`` reads, so that it
    gives ``sd`` back (phase [20] holds it to that, bitwise). The card's
    machine has no JAX: this stands in for a JAX run's restored entry."""
    s1_enc, s1_stats = _jax_encoder(sd, "stage1.xray_encoder.")
    params = {"stage1": {"initial_volume": sd["stage1.initial_volume"].permute(0, 2, 3, 4, 1).numpy(),
                         "xray_encoder": s1_enc,
                         "vit_backbone": _jax_vit(sd, "stage1.vit_backbone.", ncdhw=False)}}
    stats = {"stage1": {"xray_encoder": s1_stats}}
    if any(k.startswith("xray_encoder.") for k in sd):
        params["xray_encoder"], stats["xray_encoder"] = _jax_encoder(sd, "xray_encoder.")
    if "stage2.residual_weight" in sd:
        params["stage2"] = {
            "residual_weight": sd["stage2.residual_weight"].numpy(),
            "upsample_from_64": {
                "ConvNCDHW_0": _ncdhw_conv(sd, "stage2.upsample_from_64.conv."),
                "GroupNormNCDHW_0": _flax_norm(sd, "stage2.upsample_from_64.norm.")},
            "vit_refiner": _jax_vit(sd, "stage2.vit_refiner.", ncdhw=True)}
    if "stage3.residual_weight" in sd:
        trunk = {k[len("stage3.vit_trunk."):]: v.numpy() for k, v in sd.items()
                 if k.startswith("stage3.vit_trunk.")
                 and not k.startswith("stage3.vit_trunk.vit_refiner.")}
        params["stage3"] = {
            "residual_weight": sd["stage3.residual_weight"].numpy(),
            "detail_weight": sd["stage3.detail_weight"].numpy(),
            "vit_trunk": {**trunk, "vit_refiner": _jax_vit(sd, "stage3.vit_trunk.vit_refiner.",
                                                           ncdhw=True)},
            "detail_enhancer": {k[len("stage3.detail_enhancer."):]: v.numpy()
                                for k, v in sd.items() if k.startswith("stage3.detail_enhancer.")}}
    return {"params": params, "batch_stats": stats}


def _seeded_moments(tree: dict, trainable, g: torch.Generator, square: bool) -> dict:
    """optax-shaped moments over ``tree``: seeded values at the leaves of the
    top-level subtrees named by ``trainable``, None (optax's MaskedNode) at
    every other."""
    def fill(sub, train):
        if isinstance(sub, dict):
            return {k: fill(v, train) for k, v in sub.items()}
        if not train:
            return None
        x = 1e-3 * torch.randn(tuple(sub.shape), generator=g)
        return (x * x if square else x).numpy()

    return {k: fill(v, any(k.startswith(p) for p in trainable)) for k, v in tree.items()}


def orbax_resume_phase(dev, seed: int, stage2_launches: dict) -> dict:
    """Phase 20: a converted JAX run resumed on the card. On the CPU, the
    full-width ``progressive_cascade.json`` at stage 2 (stage2 + xray_encoder
    trained) as the Orbax reader writes it: the seeded weights in the JAX
    layout (``cascade_jax_layout``, checked to convert back bitwise),
    seeded moments over the trainable leaves with optax's counts at
    ORBAX_COUNT through ``convert.adamw_state``, ``latest`` and
    ``latest_opt`` written by ``write_entry``. On the card, the Trainer's
    resume (``_restore_state``, as ``fit_cascade`` calls it) into
    ``stage_step``'s state, which must start at ORBAX_EPOCH + 1 with every
    group still fused, and one stage-2 step at batch 2: finite, launching
    what [9]'s stage-2 step launches, and bitwise the same step from the same
    state loaded into a card optimizer by hand."""
    from hybrid_vit_cascade_tpu_torch import convert
    from hybrid_vit_cascade_tpu_torch.config import Config, data_volume_size
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.training.checkpoint import CheckpointManager, write_entry
    from hybrid_vit_cascade_tpu_torch.training.schedules import (
        apply_stage_freeze,
        cosine_schedule,
        make_optimizer,
    )
    from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer, cascade_trainable, stage_step

    t_phase = time.perf_counter()
    cfg = Config.from_json(str(CONFIG))
    run = BUILD_DIR / "orbax_resume"
    shutil.rmtree(run, ignore_errors=True)
    cfg.checkpoints.save_dir = str(run)
    cfg.data.synthetic, cfg.data.synthetic_patients = True, 2
    t, sc = cfg.training, cfg.training.stages["stage2"]
    total = ORBAX_STEPS_PER_EPOCH * sc.num_epochs

    # 20a the converted entry, on the CPU
    model = seeded_init_(build_model(cfg), seed)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tree = cascade_jax_layout(sd)
    back = convert.cascade(tree)
    differ = [k for k in sd if k not in back or not torch.equal(back[k], sd[k])]
    if sorted(back) != sorted(sd) or differ:
        raise AssertionError(f"[20] the JAX layout does not convert back: {differ[:5]} "
                             f"{sorted(set(back) ^ set(sd))[:5]}")
    trainable = cascade_trainable(2, t.freeze_shared_encoder_stage3)
    g = torch.Generator().manual_seed(seed + 20)
    mu = _seeded_moments(tree["params"], trainable, g, square=False)
    nu = _seeded_moments(tree["params"], trainable, g, square=True)
    opt = make_optimizer(apply_stage_freeze(model, trainable), sc.learning_rate, total,
                         t.weight_decay, t.gradient_clip)
    state = convert.adamw_state("cascade", tree, mu, nu, ORBAX_COUNT, ORBAX_COUNT, ORBAX_COUNT,
                                model, opt)
    meta = {"epoch": ORBAX_EPOCH, "metrics": {"loss": 1.0, "psnr": 10.0, "ssim": 0.1},
            "config": cfg.to_dict()}
    write_entry(run / "stage2" / "latest", {"state_dict": sd}, meta)
    write_entry(run / "stage2" / "latest_opt", state, meta)
    n_trained = sum(p.numel() for p in opt.param_groups[0]["params"])
    convert_s = time.perf_counter() - t_phase
    del model, opt, tree, back, mu, nu
    log(f"[20] converted entry on the CPU: {len(sd)} tensors, {n_trained / 1e6:.1f} M trained "
        f"parameters with their moments, counts {ORBAX_COUNT}, in {convert_s:.1f} s")

    # 20b the Trainer's resume on the card, and the same state loaded by hand
    loss_obj = MultiScaleLoss({f"stage{n}": getattr(cfg.loss, f"stage{n}") for n in (1, 2, 3)})
    trainer = Trainer(cfg, device=dev)
    tstate, tstep = stage_step(trainer.model, cfg, 2, loss_obj, ORBAX_STEPS_PER_EPOCH)
    start = trainer._restore_state(CheckpointManager(str(run / "stage2")), tstate)
    groups = tstate.optimizer.param_groups
    flags = [(gr["fused"], gr["foreach"]) for gr in groups]
    lr = cosine_schedule(sc.learning_rate, total)(ORBAX_COUNT)
    if (start != ORBAX_EPOCH + 1 or tstate.step != ORBAX_COUNT
            or any(gr["schedule_step"] != ORBAX_COUNT or gr["lr"] != lr for gr in groups)):
        raise AssertionError(f"[20] resumed at epoch {start}, step {tstate.step}, groups "
                             f"{[(gr['schedule_step'], gr['lr']) for gr in groups]}; expected "
                             f"{ORBAX_EPOCH + 1}, {ORBAX_COUNT}, ({ORBAX_COUNT}, {lr})")
    if not all(f is True for f, _ in flags):
        raise AssertionError(f"[20] the resumed optimizer is not fused: (fused, foreach) {flags}")
    ref = build_model(cfg).to(dev)
    ref.load_state_dict(sd)
    rstate, rstep = stage_step(ref, cfg, 2, loss_obj, ORBAX_STEPS_PER_EPOCH)
    saved = state["optimizer"]["state"]
    ropt = rstate.optimizer
    for i, p in enumerate(p for gr in ropt.param_groups for p in gr["params"]):
        ropt.state[p] = {"step": torch.tensor(float(ORBAX_COUNT), device=dev),
                         "exp_avg": saved[i]["exp_avg"].to(dev),
                         "exp_avg_sq": saved[i]["exp_avg_sq"].to(dev)}
    for gr in ropt.param_groups:
        gr["schedule_step"], gr["lr"] = ORBAX_COUNT, lr
    rstate.step = ORBAX_COUNT
    if not all(gr["fused"] for gr in ropt.param_groups):
        raise AssertionError("[20] the card optimizer built by hand is not fused")

    xs, b = cfg.data.xray_size, TRAIN_BATCH[2]
    gb = torch.Generator(device=dev).manual_seed(seed + 21)
    batch = {"drr_stacked": torch.rand((b, 2, 1, xs, xs), generator=gb, device=dev) * 2 - 1,
             "ct_volume": torch.rand((b, 1, *data_volume_size(cfg)), generator=gb,
                                     device=dev) * 2 - 1}
    torch.cuda.synchronize()
    reset_launch_counts()
    with rule_calls() as rc:
        t0 = time.perf_counter()
        tstate, tm = tstep(tstate, batch, torch.Generator(device=dev).manual_seed(seed + 22))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    launched = launch_counts()
    rstate, rm = rstep(rstate, batch, torch.Generator(device=dev).manual_seed(seed + 22))
    torch.cuda.synchronize()
    loss = float(tm["total_loss"])
    n_state, worst = _tensors_differing(trainer.model.state_dict(), ref.state_dict())
    topt = tstate.optimizer.state_dict()["state"]
    ropt_sd = ropt.state_dict()["state"]
    n_opt = sum(not torch.equal(topt[i][k], ropt_sd[i][k]) for i in topt for k in topt[i])
    log(f"[20] resumed at epoch {start}, step {ORBAX_COUNT}, lr {lr:.6g}, (fused, foreach) "
        f"{sorted(set(flags))}; one stage-2 step ({cfg.model.stage_sizes[1]}³, batch {b}): "
        f"{step_ms:.1f} ms, total_loss "
        f"{loss:.5f} against {float(rm['total_loss']):.5f} by hand; {n_state} of "
        f"{len(ref.state_dict())} state tensors and {n_opt} optimizer tensors differ "
        f"(max |diff| {worst:.3e}); launches {({k: v for k, v in launched.items() if v})}")
    if not math.isfinite(loss) or loss != float(rm["total_loss"]) or n_state or n_opt:
        raise AssertionError("[20] the resumed step is not the step from the state loaded by hand")
    if launched != stage2_launches:
        raise AssertionError(f"[20] the resumed step launched {launched}, [9]'s stage-2 step "
                             f"{stage2_launches}")
    want = {k: rc.n[k] for k in _RULE_COUNTERS}
    if (not launched["flash_attention"] or not launched["flash_attention_bwd"]
            or any(launched[k] != want[k] for k in _RULE_COUNTERS)):
        raise AssertionError(f"[20] launches {launched} miss A, D or the rules' instances {want}")
    del trainer, ref, tstate, rstate
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[20] phase {phase_s:.1f} s")
    return {"step_ms": step_ms, "total_loss": loss, "launches": launched, "flags": flags,
            "start_epoch": start, "convert_s": convert_s, "phase_s": phase_s,
            "trained_params": n_trained, "lr": lr}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    ap.add_argument("--parallel-run", type=Path, help=argparse.SUPPRESS)  # [18]'s processes
    ap.add_argument("--config", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--no-dropout", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if args.parallel_run:
        parallel_run(args.parallel_run, args.config, args.no_dropout)
        return 0

    # 1. the card
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
                 "the port's kernels run only on the card")
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import (
        InferenceEngine,
        build_model,
        save_checkpoint,
    )
    from hybrid_vit_cascade_tpu_torch.models.layers import seeded_init_
    from hybrid_vit_cascade_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from hybrid_vit_cascade_tpu_torch.ops.cuda.flash_attention import (
        kernel_head_dim as fa_kernel_head_dim,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 off for cuDNN and cuBLAS")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp2_rate = EXP2_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    log(f"[1] {sms} SMs at up to {clock_mhz:g} MHz: exp2 rate {exp2_rate:.4g}/s "
        f"({EXP2_PER_CLOCK_PER_SM} a clock per SM)")
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "sm_clock_max_mhz": clock_mhz, "sms": sms, "exp2_rate_per_s": exp2_rate}

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"[2] built {lib_path.relative_to(ROOT)} in {build_s:.1f} s")
    ptxas = [line.strip() for line in (lib_path.parent / "nvcc.log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    record.update(build_s=build_s, ptxas=ptxas)

    # 3. kernels against their plain versions
    log("[3] kernels vs plain versions (bf16 and fp32)")
    worst = check_kernels(dev, args.seed, KERNELS, _inputs, _fns)
    log("[3] chain kernels H-K vs plain versions (bf16 and fp32)")
    worst.update(check_chain_kernels(dev, args.seed))
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()

    # 4. the slice
    cfg = Config.from_json(str(CONFIG))
    m = cfg.model
    widths = (m.family, m.voxel_dim, m.xray_feature_dim, m.dtype, tuple(m.stage_depths),
              tuple(m.stage_heads), tuple(m.stage_sizes), cfg.data.xray_size)
    if widths != ("cascade", 256, 512, "bfloat16", (4, 6, 8), (4, 8, 8), (64, 128, 256), 512):
        raise AssertionError(f"{CONFIG.name} no longer holds the default cascade: {widths}")
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = CKPT_DIR / "cascade_seeded.pt"
    t0 = time.perf_counter()
    model = seeded_init_(build_model(cfg), args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(ckpt, cfg, model)
    del model
    engine = InferenceEngine(ckpt, device=dev, max_stage=3)
    load_s = time.perf_counter() - t0
    xr = torch.rand((1, 2, 1, cfg.data.xray_size, cfg.data.xray_size),
                    generator=torch.Generator().manual_seed(args.seed + 1))
    log(f"[4] slice: {n_params / 1e6:.1f} M parameters, seeded, saved and loaded in "
        f"{load_s:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.reconstruct(xr, max_stage=3, return_intermediate=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = launch_counts()
    launches = {k: launched[k] for k in EXPECTED_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for stage, size in (("stage1", 64), ("stage2", 128), ("stage3", 256)):
        v = out[stage]
        finite = bool(torch.isfinite(v.float()).all())
        log(f"    {stage}: shape {tuple(v.shape)} {v.dtype} finite={finite} "
            f"mean={float(v.float().mean()):.4f} std={float(v.float().std()):.4f}")
        if tuple(v.shape) != (1, 1, size, size, size) or not finite:
            raise AssertionError(f"{stage}: expected finite (1, 1, {size}³), got {tuple(v.shape)}")
    log(f"    launches {launches} (expected {EXPECTED_LAUNCHES}); first call {first_s:.2f} s; "
        f"peak memory {peak_gb:.2f} GB")
    if launches != EXPECTED_LAUNCHES or any(launched[k] for k in launched if k not in launches):
        raise AssertionError(f"launch counts {launched}: expected {EXPECTED_LAUNCHES} and "
                             f"no gradient kernel")
    record.update(n_params=n_params, launches=launches, first_call_s=first_s,
                  peak_memory_gb=peak_gb)
    del out

    # 5. small-input reference: card (kernels) vs CPU (plain versions), fp32
    small = scaled_config(cfg)
    cpu_model = seeded_init_(build_model(small), args.seed).eval()
    gpu_model = seeded_init_(build_model(small), args.seed).to(dev).eval()
    xs = torch.rand((1, 2, 1, 64, 64), generator=torch.Generator().manual_seed(args.seed + 2))
    before = launch_counts()
    with torch.inference_mode(), force_streaming():
        want = cpu_model(xs, return_intermediate=True)
        got = gpu_model(xs.to(dev), return_intermediate=True)
    after = launch_counts()
    small_err = {}
    atol, rtol = SMALL_TOL
    for stage in ("stage1", "stage2", "stage3"):
        g, w = got[stage].cpu(), want[stage]
        diff = (g - w).abs()
        small_err[stage] = float(diff.max())
        ok = bool((diff <= atol + rtol * w.abs()).all())
        log(f"[5] small reference {stage} {tuple(g.shape)}: max_abs_err={small_err[stage]:.3e} "
            f"tol={atol:g}+{rtol:g}|ref| {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"small-input reference disagrees at {stage}")
    # at the scaled sizes stages 1-2 have no token-stem conv and stage 3's one
    # stride-2 conv streams (I): no dense stride-2 conv runs
    need = ("flash_attention", "conv3d_k3s1", "conv3d_k3s1_chain", "conv3d_k3s2_chain")
    if any(after[k] <= before[k] for k in need):
        raise AssertionError(f"small reference did not run every kernel of {need}: "
                             f"{before} → {after}")
    record["small_reference_max_abs_err"] = small_err
    del cpu_model, gpu_model, got, want

    # 6. timings: the streamed (default) and the dense stage-3 schedule in turns
    from hybrid_vit_cascade_tpu_torch.training.measure import kernel_profile, use_dense_stage3

    s3 = engine.model.stage3
    streamed = (s3.slab_scan, s3.eval_schedule)

    def reconstruct_s(dense: bool) -> tuple[float, float]:
        if dense:
            use_dense_stage3(engine.model)
        else:
            s3.slab_scan, s3.eval_schedule = streamed
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        engine.reconstruct(xr, max_stage=3)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 1e9

    reconstruct_s(False), reconstruct_s(True)  # warm-up of each
    times = {"streamed": [], "dense": []}
    peaks = {}
    for i in range(REPS):
        for dense in ((False, True) if i % 2 == 0 else (True, False)):
            t, peaks["dense" if dense else "streamed"] = reconstruct_s(dense)
            times["dense" if dense else "streamed"].append(t)
    s3.slab_scan, s3.eval_schedule = streamed
    med = statistics.median(times["streamed"])
    med_dense = statistics.median(times["dense"])
    for k in ("streamed", "dense"):
        log(f"[6] reconstruct 256³ (batch 1, bf16, max_stage=3), stage-3 schedule {k}: median "
            f"{statistics.median(times[k]) * 1e3:.1f} ms over {REPS} calls "
            f"({', '.join(f'{t * 1e3:.1f}' for t in times[k])}); "
            f"{1.0 / statistics.median(times[k]):.3f} volumes/s; peak {peaks[k]:.2f} GB")
    record.update(reconstruct_ms=[t * 1e3 for t in times["streamed"]],
                  reconstruct_median_ms=med * 1e3, volumes_per_s=1.0 / med,
                  reconstruct_dense_ms=[t * 1e3 for t in times["dense"]],
                  reconstruct_dense_median_ms=med_dense * 1e3, reconstruct_peak_gb=peaks)
    # one more streamed reconstruct under torch.profiler: device time by kernel
    # name and the share of the wall in which no kernel ran
    prof = kernel_profile(lambda: engine.reconstruct(xr, max_stage=3), dev)
    log(f"[6] profiled reconstruct (streamed): wall {prof['wall_ms']:.1f} ms, kernels "
        f"{prof['kernel_ms']:.1f} ms, idle {prof['idle_share']:.1%}; top: "
        + "; ".join(f"{t['name'][:60]} {t['ms']:.1f} ms ×{t['launches']}" for t in prof["top"][:10]))
    record["reconstruct_profile"] = prof
    del engine
    torch.cuda.empty_cache()
    rows = time_kernels(dev, args.seed, KERNELS, _inputs, _fns)

    # 7. gradient kernels against their plain versions, then their times
    log("[7] gradient kernels vs plain versions (bf16 and fp32)")
    worst.update(check_kernels(dev, args.seed, TRAIN_KERNELS, _train_inputs, _train_fns,
                               scaled=True))
    rows.update(time_kernels(dev, args.seed, TRAIN_KERNELS, _train_inputs, _train_fns))
    record["flash_bwd_bitwise"] = flash_bwd_bitwise(dev, args.seed)
    torch.cuda.empty_cache()
    record["head_dims"] = head_dim_kernels(dev, args.seed)
    rows.update(record["head_dims"].pop("rows"))
    torch.cuda.empty_cache()
    record["tc_wgrad_launches"] = tc_wgrad_dispatch(dev, args.seed)
    torch.cuda.empty_cache()
    record["tc_fwd_launches"] = tc_fwd_dispatch(dev, args.seed)
    torch.cuda.empty_cache()
    record["fp32_stem_dgrad"] = fp32_stem_dgrad(dev, args.seed)
    log("[7] chain kernels H-K, bf16 times")
    rows.update(time_chain_kernels(dev, args.seed))
    record["max_abs_err"] = worst
    record["kernel_ms"] = {f"{n} {s}": {"ms": a, "plain_ms": b} for (n, s), (a, b) in rows.items()}
    record["after_timing"] = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    torch.cuda.empty_cache()

    # 8. small training reference; 9. the training slice; 10. the chains
    record["train_reference"] = train_reference(cfg, dev, args.seed)
    record["train"] = train_full_width(cfg, dev, args.seed)
    torch.cuda.empty_cache()
    record["chains"] = chain_phase(dev, args.seed)
    torch.cuda.empty_cache()

    # 11. the training entry point
    record["train_entry_point"] = train_entry_point(
        dev, args.seed, statistics.median(record["train"]["stage3"]["step_ms"]))

    # 12. the probe path
    torch.cuda.empty_cache()
    record["probe"] = probe_phase(dev, args.seed)
    worst.update(record["probe"]["max_abs_err"])

    # 13. the serving commands
    torch.cuda.empty_cache()
    record["serving"] = serving_phase(dev, cfg)

    # 14. the direct-regression families
    torch.cuda.empty_cache()
    record["direct"] = direct_phase(dev, args.seed)

    # 15. the diffusion family
    torch.cuda.empty_cache()
    record["diffusion"] = diffusion_phase(dev, args.seed)

    # 16. the serving artifact; 17. training observability
    torch.cuda.empty_cache()
    record["export"] = export_phase(dev, args.seed, card)
    torch.cuda.empty_cache()
    record["observability"] = observability_phase(dev, args.seed, card)

    # 18. data-parallel training under torchrun
    torch.cuda.empty_cache()
    record["parallel"] = parallel_phase(dev, args.seed, card)

    # 19. the h200 cascade
    torch.cuda.empty_cache()
    record["h200"] = h200_phase(dev, args.seed)
    rows.update(record["h200"].pop("rows"))

    # 20. a converted JAX run resumed on the card
    torch.cuda.empty_cache()
    record["orbax_resume"] = orbax_resume_phase(dev, args.seed,
                                                record["train"]["stage2"]["launches_per_step"])

    # 21. the cascade at head dims 16 and 128
    torch.cuda.empty_cache()
    record["head_dim_cascades"] = head_dim_phase(dev, args.seed)

    # launches on the main path: the reconstruct [4], the first step of each
    # stage in [9], the cli train run of [11], the probe run of [12], the
    # serving commands of [13], [14]'s direct_vit reconstruct, first train
    # step and entry points, [15]'s first train steps, samplers and cli
    # train, [16]'s served calls, [17]'s cli train, [18]'s cli train under
    # torchrun, [19]'s reconstruct and first step of each stage, [20]'s
    # resumed step and [21]'s reconstructs and steps, each counted from 0
    direct, diffusion = record["direct"], record["diffusion"]
    s256 = diffusion["s256"]
    by_run = {"reconstruct": launched, **{f"train_{k}": v["launches_per_step"]
                                          for k, v in record["train"].items()},
              "cli_train": record["train_entry_point"]["launches"],
              "conv_probe": record["probe"]["launches"],
              "cli_serving": record["serving"]["launches"],
              "direct_vit_reconstruct": direct["direct_vit"]["launches"],
              "direct_vit_train": direct["direct_vit_train"]["launches_per_step"],
              "direct_vit_cli": direct["direct_cli"]["launches"],
              **{f"diffusion_{k}": diffusion[k]["launches_per_step"]
                 for k in ("train_64_b4", "train_r5_s2_b2", "train_prog_s2_b1")},
              "diffusion_sample_64": diffusion["sample_64"]["launches"],
              **{f"diffusion_cascade_sample_{k}": v["launches"]
                 for k, v in diffusion["cascade_sample_r5"]["per_stage"].items()},
              "diffusion_cli": diffusion["cli_train"]["launches"],
              "diffusion_train_s3_b1": s256["train_s3_b1"]["launches_per_step"],
              **{f"diffusion_cascade_sample256_{k}": v["launches"]
                 for k, v in s256["cascade_sample_256"]["per_stage"].items()},
              "diffusion_cli256": s256["cli_train"]["launches"],
              **{f"served_{k}": record["export"][k]["launches"] for k in ("cascade", "direct_vit")},
              "observability_cli": record["observability"]["launches"],
              "parallel_cli": record["parallel"]["launches"],
              "h200_reconstruct": record["h200"]["reconstruct"]["launches"],
              **{f"h200_train_s{n}": record["h200"][f"stage{n}"]["launches_per_step"]
                 for n in (1, 2, 3)},
              "orbax_resume": record["orbax_resume"]["launches"],
              **{f"headdim{d}_reconstruct": record["head_dim_cascades"][f"d{d}_reconstruct"][
                  "launches"] for d in HEAD_DIM_CASCADES},
              **{f"headdim{d}_train_{bwd}": record["head_dim_cascades"][f"d{d}_train_{bwd}"][
                  "launches_per_step"] for d in HEAD_DIM_CASCADES for bwd in ("fused", "split")}}
    by_run = {run: {**dict.fromkeys(launched, 0), **counts} for run, counts in by_run.items()}
    kernels = []
    for name, spec in {**KERNELS, **TRAIN_KERNELS, **CHAIN_KERNELS}.items():
        ms, plain_ms = rows[(name, spec["hot"])]
        b_ms, b_by, terms = bound(name, spec["hot"], exp2_rate=exp2_rate)
        runs = {run: counts[spec.get("counter", name)] for run, counts in by_run.items()}
        kernels.append({"name": name, "route": "cuda", "source": spec["source"],
                        "replaces": spec["replaces"], "launches": sum(runs.values()),
                        "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms(name, spec["hot"], dev, args.seed),
                        "at": f"{spec['hot']} bf16", "card": card, "launches_by_run": runs,
                        "bound_terms_ms": terms})
        if name.startswith("flash_attention_bwd"):
            kernels[-1]["library_call"] = _SDPA_BWD
        if spec.get("library_at"):  # more timed shapes, each with its bound and library call
            kernels[-1]["library_at"] = [
                {"at": f"{sh} bf16", "ms": rows[(name, sh)][0], "plain_ms": rows[(name, sh)][1],
                 "bound_ms": bound(name, sh)[0], "library_ms": library_ms(name, sh, dev, args.seed)}
                for sh in spec["library_at"]]
        if "exp2_ms" in terms:
            kernels[-1]["bound_note"] = _EXP2_NOTE
        if name in DIRECT_FLASH:  # the direct model's attention shape, and its launches there
            sh = DIRECT_FLASH[name]
            d_runs = {k: by_run[k][name] for k in by_run if k.startswith("direct_vit")}
            kernels[-1]["direct_vit"] = {
                "at": f"{sh} bf16", "ms": rows[(name, sh)][0], "plain_ms": rows[(name, sh)][1],
                "bound_ms": bound(name, sh, exp2_rate=exp2_rate)[0],
                "library_ms": library_ms(name, sh, dev, args.seed), "launches": sum(d_runs.values()),
                "launches_by_run": d_runs}
        if name in DIFFUSION_AT:  # the diffusion slice's shapes, and its launches
            f_runs = {k: by_run[k][name] for k in by_run if k.startswith("diffusion")}
            kernels[-1]["diffusion"] = {
                "at": [{"at": f"{sh} bf16", "ms": rows[(name, sh)][0],
                        "plain_ms": rows[(name, sh)][1],
                        "bound_ms": bound(name, sh, exp2_rate=exp2_rate)[0],
                        "library_ms": library_ms(name, sh, dev, args.seed)}
                       for sh in DIFFUSION_AT[name]],
                "launches": sum(f_runs.values()), "launches_by_run": f_runs}
        if name in H200_AT:  # the h200 cascade's hot shape, and its launches in [19]
            sh = H200_AT[name]
            h_runs = {k: by_run[k][name] for k in by_run if k.startswith("h200")}
            kernels[-1]["h200"] = {
                "at": f"{sh} bf16", "ms": rows[(name, sh)][0], "plain_ms": rows[(name, sh)][1],
                "bound_ms": bound(name, sh, exp2_rate=exp2_rate)[0],
                "library_ms": library_ms(name, sh, dev, args.seed),
                "max_abs_err": record["h200"]["max_abs_err"][name],
                "launches": sum(h_runs.values()), "launches_by_run": h_runs}
        if name in FLASH_NAMES:  # head dims 16 (padded) and 128: [7h]'s rows, [21]'s launches
            tc_name = _TC_COUNTERS[name]
            kernels[-1]["head_dims"] = {}
            for d, shapes in HEAD_DIM_AT.items():
                h_runs = {k: by_run[k][name] for k in by_run if k.startswith(f"headdim{d}_")}
                kernels[-1]["head_dims"][str(d)] = {
                    "instance_d": fa_kernel_head_dim(d),
                    "at": [{"at": f"{sh} bf16", "ms": rows[(name, sh)][0],
                            "plain_ms": rows[(name, sh)][1],
                            "bound_ms": bound(name, sh, exp2_rate=exp2_rate)[0],
                            "bound_by": bound(name, sh, exp2_rate=exp2_rate)[1],
                            "library_ms": library_ms(name, sh, dev, args.seed)} for sh in shapes],
                    "max_abs_err": record["head_dims"]["max_abs_err"][f"{name} d{d}"],
                    "launches": sum(h_runs.values()), "launches_by_run": h_runs,
                    "tc_launches": sum(by_run[k][tc_name] for k in h_runs)}
                hd = kernels[-1]["head_dims"][str(d)]
                log(f"  {name:24s} d = {d}: " + "; ".join(
                    f"{a['at']} {a['ms']:.3f} ms, plain {a['plain_ms']:.3f}, bound "
                    f"{a['bound_ms']:.3f} ({a['bound_by']}), library {a['library_ms']:.3f}"
                    for a in hd["at"]) + f"; launches {hd['launches']} (tc {hd['tc_launches']})")
        if name == "conv3d_k3s2_c1in_dgrad":  # its fp32 instance, off the bf16 main path
            fp32_runs = {run: counts["conv3d_k3s2_dgrad_c1in_fp32"] for run, counts in by_run.items()}
            kernels[-1]["fp32"] = {**record["fp32_stem_dgrad"], "launches": sum(fp32_runs.values()),
                                   "launches_by_run": fp32_runs}
        # an instance's own row counts on its tensor-core counter
        tc = spec.get("counter") or _TC_COUNTERS.get(name) or (
            name.endswith("wgrad") and f"conv3d_k3s{_chain_stride(name)}_wgrad_tc")
        if tc:  # launches that took the tensor-core instance
            kernels[-1]["instance"] = _tc_rule(tc)
            kernels[-1]["tc_counter"] = tc
            kernels[-1]["tc_launches_by_run"] = {run: counts[tc]
                                                 for run, counts in by_run.items()}
        log(f"  {name:24s} {ms:9.3f} ms  plain {plain_ms:9.3f}  bound {b_ms:8.3f} ({b_by})  "
            f"library {kernels[-1]['library_ms']:9.3f}  launches {runs}")
    probe_rows = {r["case"]: r for r in record["probe"]["rows"]}
    for r in (r for r in record["probe"]["rows"] if r["kernel"] and r["case"] != "V0"):
        name = r["kernel"]
        b_ms, b_by, _ = bound(name, r["case"])
        runs = {run: counts[name] for run, counts in by_run.items()}
        kernels.append({"name": name, "route": "cuda", "source": PROBE_SOURCE,
                        "replaces": r["replaces"], "launches": sum(runs.values()),
                        "max_abs_err": worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["library_ms"],
                        "at": f"{r['case']}: N {r['n']}, R {r['repeats']}, bf16 in, fp32 out",
                        "card": card,
                        "library_call": r["library_call"], "launches_by_run": runs})
        kernels[-1]["pass_floor_ms"] = r["pass_floor_ms"]
        counter = _probe_instance_counter(r["case"], r["n"])
        if counter:  # the row's launches in the timed run, on its wgmma instance
            kernels[-1]["wgmma_counter"] = counter
            kernels[-1]["wgmma_launches"] = r["launches"].get(counter, 0)
        if name == "conv_probe_v1":
            kernels[-1]["v0"] = {k: probe_rows["V0"][k] for k in
                                 ("ms", "plain_ms", "bound_ms", "library_ms", "pass_floor_ms")}
            kernels[-1]["v0"]["wgmma_launches"] = probe_rows["V0"]["launches"]["conv_probe_v1_wgmma"]
        log(f"  {name:24s} {r['ms']:9.3f} ms  plain {r['plain_ms']:9.3f}  bound {b_ms:8.3f} "
            f"({b_by})  library {r['library_ms']:9.3f}  launches {runs}")
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    if unlaunched:
        raise AssertionError(f"kernels the main path never launched: {unlaunched}")
    record["wall_s"] = time.perf_counter() - t_start
    (BUILD_DIR / "chip_smoke.json").write_text(json.dumps({**record, "kernels": kernels}, indent=1))
    log(f"wall {record['wall_s']:.1f} s (build {build_s:.1f} s)")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
