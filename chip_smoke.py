#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (attngan_torch) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. Phases:

1. import every subpackage of the port through its ``__init__`` and
   resolve each name of its ``__all__`` (neither JAX nor the JAX package
   may load); build the Hopper kernels from attngan_torch/csrc/ (one nvcc
   each, at once), with each kernel's registers and spills from ptxas; the
   streaming K1 kernel, the resident and cluster K2 kernels and the
   tensor-core DAMSM forward and backward must not spill;
2. hold each kernel against its plain PyTorch version on the same CUDA
   tensors, at the serving path's gen2 (64^2) and gen3 (128^2) shapes: fp32
   and bf16 at batch 8, bf16 at the GAN step's batch 16 (K1's shapes in the
   train-mode generator), then fp32 and bf16 at the serving batch, which
   are also timed (device time of one call, median of 20, see ``time_ms``)
   beside the card's bound; each K1 and K2 line names the kernel's form
   (K1: ``stream`` and its plan; K2: ``resident`` in bf16, ``cuda_cores``
   in fp32, as its launch counters must show); K2 beside the plain
   serving chain too (``chain_ms``:
   upsample, bf16 conv, eval BN, GLU as the generator runs them without
   the kernel); then the DAMSM similarity (K4) and its backward
   (K5 / K6) in fp32 at full width (R=289, D=256, L=8, lengths 1..8):
   square at batch 64, 192 x 192, the sharded shape 16 x 64, the GAN
   step's coupling 16 x 16 at L=5, and scores of ~1e3 at batch 64, timed
   beside their bound and plain versions (each line names the kernel's
   form, ``tc_3xtf32`` on the tensor cores or
   ``cuda_cores``, and gives ``tc_bound_ms`` beside ``bound_ms``; K4's
   also time its tensor-core form on other grids, ``grid_ms`` by S, the
   blocks per image: the backward's S, a block per text tile (S = K), and
   the S it takes, ``splits``);
3. serve full-width 256^2 images (GanConfig defaults, random weights from a
   seed, round-tripped through save_infer_state / load_infer_state) at
   batch 64 in bf16 through K2, with the launch counters reset just before
   the shape's second call (the CUDA graph's capture and first replay) and
   read just after: exactly 2 K1 launches and 2 of K2, both in the
   resident form, and every other counter at 0;
   the sampler's counts 1 eager call, 1 capture, 1 replay; a third call,
   a replay, launching K1 twice and the UpBlock kernel twice by
   torch.profiler's count; then fp32 at batch 2, three calls (eager,
   captured, replayed), the first and the third against the port's own
   CPU run with the same weights and noise;
4. throughput: img/s over 5 windows, through K2 and with the kernels off,
   the two paths taking their windows in turns; then
   ``utils.timing.device_timeit`` of the K2 path's call beside CUDA events
   around the same timed loop (it may not read more than 2% under them:
   its clock must stop after the work) and ``time_ms`` of the call;
   4c. DF-GAN (``dfgan_phase``; nf 32, sentence 256, 18-word captions,
   bf16, batch 64): K7 against its plain version at each of the 12 DF
   layers of a serving call, timed beside its bound (bytes at 3.35 TB/s),
   its plain version and GAN.py's eager chain in bf16 (``chain_ms``), and
   in fp32 at two odd shapes; the DF-GAN sampler's eager call, capture and
   replay (K7 launched 12, 12 and 0 times by the host, the replay's 12 by
   torch.profiler's count, the images within one bf16 step), img/s over 4
   windows of 10 calls and the memory reserved; fp32 at batch 2, eager,
   captured and replayed, against the port's CPU run;
   4d. the eval BatchNorm epilogue (``bn_epilogue_phase``, K8) against its
   plain version at each site shape of an AttnGAN serving call at batch
   64 in bf16 (InitialStage's GLU over (64, 16384), the four stage-1
   UpBlocks', each ResBlock's GLU and residual add), timed beside its
   bound (bytes at 3.35 TB/s), its plain version and PyTorch's chain as
   the generator ran it before K8 (``chain_ms``), each weighted by its
   sites a call, and in fp32 at odd shapes; the serving sampler's eager
   call, capture and replay (K8 launched 13, 13 and 0 times by the host,
   the replay's 13 by torch.profiler's count);
   4e. the text encoder's masked BiLSTM (``bilstm_phase``, K9) against its
   plain version in fp32 at the serving cells' (rows, seq), (64, 5),
   (1, 18) and (64, 18), each batch with lengths 0 and L, timed beside its
   bound (bytes at 3.35 TB/s or its fp32 operations at 67 TFLOP/s), its
   plain version, the whole eval encoder on K9's route (embedding, the two
   input GEMMs, K9: ``encoder_ms``) and on cuDNN's packed path with its
   host syncs (``cudnn_ms``, events around each call), with the rows a
   cluster takes; the serving sampler's eager call, capture and replay at
   batch 64 (K9 launched 1, 1 and 0 times by the host, the replay's 1 by
   torch.profiler's count);
   4f. DM-GAN (``memread_phase``; gf 64, emb 256, 18-word captions, bf16,
   batch 64): K1's memory form (``memory_read_cuda``) against its plain
   version at the two memory stages' shapes (64^2 and 128^2, C 64, L 18),
   timed (L2 cold) beside its bound (bytes at 3.35 TB/s or operations at
   989 TFLOP/s, the larger) and its plain version, and in fp32 and bf16
   at odd shapes over L in {1, 8, 18}; K2 at DM-GAN's (Ci, Co) = (128,
   64) in its cluster form (one ``cluster_launches`` a call) against the
   plain version, timed beside its bound (operations at 989 TFLOP/s),
   PyTorch's plain serving chain (``chain_ms``) and the same chain with
   K8's BN -> GLU (``chain_k8_ms``); K1's AttnGAN
   form at the serving shapes (64 rows, C 32, L 5 and 18), timed as
   phase 2 times it, to show that the memory form left it as it was; the
   DM-GAN sampler's eager call, capture and replay (the memory form and
   K2's cluster form each launched 2, 2 and 0 times by the host, the
   replay's 2 each by torch.profiler's count), img/s over 4 windows of 10
   calls and the memory reserved;
5. the DAMSM pretrain step (DamsmConfig defaults: Inception-v3 trunk in
   bf16 with seeded random weights, emb 256, vocab 1000, 8 words): one step
   at batch 64 and one at batch 192, each with the launch counters reset
   just before and read just after (the forward and the backward's pass
   on the tensor cores once each in each); 20 steps on one repeated batch,
   whose loss must fall; the fp32 step at batch 4 against the port's CPU run;
   steps/s with the kernels and with the plain words loss, in turns;
   (with ``--profile``: device time by kernel and operator, the device's
   idle share and the host's time in the CUDA runtime over 3 serving calls
   per path and 3 training steps, from torch.profiler;)
6. the GAN step (GanConfig defaults: gf 32, df 64, emb 256, 3 stages, 5
   words, bf16; the Inception-v3 trunk with seeded random weights) at
   batch 16: one step with the launch counters reset just before and read
   just after (K1 twice, K4 once, K5 twice, the forward and the backward's
   pass on the tensor cores once each, nothing else); 20 steps with finite
   metrics that move every parameter and BN statistic of the generator and
   the discriminators; the fp32 step at batch 2 against the port's CPU
   run, and two faulty steps (gradient faults only) that this check must
   catch; GAN steps/s with the kernels and with the plain paths, in turns;
   (with ``--profile``: 3 GAN steps under torch.profiler;)
7. whether Pillow, matplotlib and scikit-learn can be imported (a fact
   to record: the path below needs none of them); the loop's batches
   (pinned by the prefetch thread, copied and preprocessed on the main
   stream while matmuls hold it) against the same batches built
   synchronously, bit for bit; then the training surface at full width
   through the CLIs' ``main(argv)``, chained through their own
   checkpoints under one temporary directory: ``cli.pretrain`` (128
   synthetic images, batch 64, 2 epochs: 4 steps), ``cli.train`` from its
   checkpoint (64 images, batch 16, 2 epochs: 8 steps, a sample grid each
   epoch; the encoders equal to the DAMSM checkpoint's bit for bit), its
   ``--resume`` to 3 epochs (4 steps more; the restored state equal to
   its files bit for bit, then every tensor of the generator and the
   discriminators, the Adams, the generator state and the step moved,
   the frozen encoders not), ``cli.infer`` from the GAN checkpoint (a
   ``--df-dim`` that contradicts its config.json refused with no launch;
   2 captions with JAX's ``--df-dim`` / ``--image-encoder`` at the
   recorded values, ``--fused-attention``, ``--swap 1 --all-stages
   --save-attention``: 10 PNGs, each read back to its shape; ``--benchmark`` at batch 64, whose
   host launches on 2 of its 21 calls, the rest replaying), and a GAN run of
   512 images (2 epochs of 32 steps, one save and grid at its end) beside
   4 windows of 16 bare steps on the state it returns. Every loss moves
   and stays finite. Each call's launch counts must be exact: K4 once
   and K5 twice a pretrain or GAN step, K1 twice a GAN step, sample grid
   or serving call, K2 twice a grid or serving call, K6 never. One
   line per call: steps, seconds, steps/s through the loop with and
   without its checkpoint saves and grids (beside phase 6's bare-step
   steps/s, and for the 512-image run beside its own bare windows), each
   save's seconds and MB on disk;
8. the captioner: the port's scene corpus (512 images, seed 0) written as
   JPEGs (Pillow, quality 95); the bundled sample photos (none there: the
   photo-patch corpus must raise); whether the native JPEG decoder built,
   and the corpus decoded by it and by Pillow (images/s each, their max and
   mean absolute difference, the mean under 6 levels an image); the 1024
   records (files and flips) embedded by the seeded ResNet-18 on the card
   in fp32 (TF32 off; img/s) and on the CPU, the first 64 within 1e-4;
   both embeddings clustered at the defaults (agglomerative_complete,
   ``auto`` = pca to 128 dims, vocabulary 1000: k = 7 ... 500): the two
   trees hold the same merges, at heights within 1e-4, in the same order
   but where merges lie closer than that (such a swap renumbers the labels
   of every cut above it: the k where labels differ are printed), and the
   same partitions at every k, with the ARI of each k against the
   corpus's wall, bed and layout factors; then ``cli.pretrain
   --data-root --cluster --stream`` at full width over the 1024 records (batch 64, 1 epoch: 16
   steps; K4 16 and K5 32 launches, every other kernel 0; a finite loss
   that moves; a captions JSON of every record with one token per k),
   and ``cli.pretrain`` again from that JSON, streamed and then eagerly
   decoded, with the same launch counts and the same losses, each call's
   steps/s through its loop beside the other's;
9. the pretrain options at full width (DamsmConfig defaults, a seeded
   Inception-v3 trunk written as a torchvision .pth with num_batches_tracked,
   AuxLogits and fc entries) over 512 synthetic images at batch 64: first
   K4 and K5 at the shapes the phase gives them, one fp32 step with the
   kernels against one with the plain words loss (metrics and every
   gradient at phase 2's tolerances), on a batch of the CLI's synthetic
   data (2 words, 4 classes) and of the comparison runs' (captions of 3-8
   words over a vocabulary of 1000, 128 classes); then
   ``run_damsm_training`` over the latter, each run on its own records,
   from the .pth's trunk as ``--pretrained-cnn`` loads it: 2 epochs plain
   (the trained state's trunk equal to the file's bit for bit), with the
   feature cache (the precompute's seconds, the cache's MB, all finite;
   losses within 1e-2 relative of the plain run's), plain in fp32, with a
   superbatch of 4 (all 16 losses within 1e-3 of the plain run's, and no
   further off them than the plain run is off the fp32 one) and in fp32
   with a superbatch of 4 (all 16 within 1e-3); then
   ``cli.pretrain``'s ``main(argv)`` on its own data, 1 epoch with
   ``--trunk-train-mode-bn --pretrained-cnn`` (every trunk running
   statistic moved, every other trunk tensor equal to the file's, the
   saved ``cnn.pt`` equal to the state, and ``load_damsm_encoders``, which
   ``cli.train --damsm-checkpoint`` calls, reading them bit for bit); each
   run with K4 once and K5 twice a step and every other kernel 0; then
   ``iter_attention_maps`` over the 512 images (maps/s; each real word's
   map sums to 1 within 1e-5; the first 4 in fp32 within 1e-4 of the
   CPU's) and ``populate_attention_maps`` (8 PNGs read back); and the
   steps/s of the plain, cached, superbatch (K = 4) and train-mode-BN
   steps at batch 64, in turns (with ``--profile``: a 12-step window of
   each under torch.profiler);
10. data parallelism: the sharded DAMSM loss on 2 gloo ranks sharing the
   card (``torchrun`` of this script with ``--rank``: K4 once and K6 twice
   a rank) against one process, K4 / K6 against their plain versions and
   timed at each rank's shapes; the CLIs under ``torchrun --mesh-shape 2``
   in fp32, chained through their checkpoints, against the same chain in
   one process (the ranks' states bit-identical, exact launches a rank);
   NCCL at world 1 (``data_parallel_phase``);
11. the side tiers at full width (``side_tiers_phase``): int8 serving
   (GanConfig defaults, bf16, batch 64): the s32 product of every
   quantized site of one call against the CPU's, bit for bit; K1 and K2
   twice a call and nothing else; int8 against float images and img/s in
   turns; each pass's device time at the two largest sites beside the bf16
   conv; ``cli.infer --int8 --benchmark`` (its launches exact); fp32 int8
   images at batch 2 against the CPU's; ``cli.infer --export`` (cuda and
   cpu, symbolic batch) and ``--export --int8``, both served in a fresh
   process that imports only torch and the loader's file (batches of 3
   and 64 on the card, 2 on the CPU) against the live samplers;
   ``cli.pretrain --trunk-int8`` and plain (128 images, batch 64: 2
   steps each, K4 once and K5 twice a step), their losses within 5%, and
   both steps' steps/s in turns; ``int8_vs_bf16_fid`` at batch 64 on the
   calibrated random featurizer, a set's FID against itself, and the
   featurizer's fp32 features on the card against the CPU's;
12. the last modules (``last_modules_phase``): VGG19-BN from a seeded
   torchvision ``.pth`` (``load_torchvision_vgg19_bn``) at 256^2, the
   default taps, fp32, batch 16 (ms a forward, its FLOPs), two images
   against the CPU's; the default DFCVAE's deep-feature loss step (a
   train-mode forward, VGG features of the reconstructions and inputs,
   ``dfc_vae_loss``, the backward) at batch 16 (ms a step, peak MB,
   FLOPs), fp32 at batch 2 against the CPU (the loss, each gradient in
   norm, the CPU on the card's side of every leaky ReLU input, which may
   differ from its own only within 1e-4 of 0); ``HierarchicalClusterer`` with ``VAEEmbedder(DFCVAE(), "dfc")``
   and then ``VAEEmbedder(AutoEncoder(), "ae")`` (seeded He weights, fixed
   noise) over phase 8's 512 scene JPEGs on the card and on the CPU (the
   embeddings, one tree, the same partitions at every k; img/s);
   ``attngan_torch.tools.mfu_report``'s three paths (the sampler at 64,
   the pretrain step at 64, the GAN step at 16: 0 < mfu <= 1.05, the
   host's launches exactly the calls', the sampler's replays launching
   none); then every other tool once at a small
   size, its exit code and JSON keys: ``collision_check``, ``fid_curve``
   and ``int8_fid_run`` on a full-width CLI chain of its own (32 JPEGs,
   vocabulary capped at 32, so that classes collide), ``attnmaps_bench``,
   ``cluster_quality_run``, ``make_photo_corpus`` (non-zero without
   bundled photos, as it must) and ``convert_torch_weights`` for the
   three trunks;
13. one ``{"kernels": [...]}`` line (launches summed over every path's
   counted call), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no ok line.
Without a GPU, or without the repository around it, it exits non-zero too.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile

BATCH = 64            # serving batch of the full-width run
CHECK_BATCH = 8       # batch of the fp32 / bf16 per-kernel checks
SEQ_LEN, VOCAB = 5, 1000
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core flop/s. bound_ms = max(bytes / BW, flops / PEAK).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12   # fp32 outside the tensor cores (TF32 is off)
TF32_FLOPS_PER_S = 495e12  # TF32 tensor cores; 3xTF32 does 3 per fp32 product
# kernels that must not spill (ptxas)
NO_SPILL = ("word_attention_stream_kernel", "memread_stream_kernel",
            "upblock_resident_kernel", "upblock_cluster_kernel",
            "damsm_bwd_tc_kernel", "damsm_fwd_tc_kernel",
            "bn_epilogue_kernel", "bilstm_kernel")
L2_BYTES = 50 * 2 ** 20
# device_timeit's seconds a call may read at most this share under the
# CUDA events around the same timed loop
FENCE_SLACK = 0.02
SUBPACKAGES = ("core", "data", "eval", "infer", "losses", "models", "ops",
               "parallel", "train", "utils")
SLEEP_CYCLES = 10 ** 8   # ~50 ms at the H100's 1.98 GHz peak SM clock
# kernel vs plain version on the same inputs. fp32: same arithmetic in
# another summation order (TF32 off). bf16: the outputs may differ by one
# rounding step, 2^-7 relative, plus an absolute floor for values near 0.
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=1e-2, rtol=2.0 ** -7)}
ATTN_TOL = dict(atol=1e-5, rtol=0.0)   # attention maps are fp32 either way
IMAGE_ATOL = 1e-3   # fp32 GPU vs CPU images in [0, 1]: 3 stages of convs,
#                     cuDNN vs CPU algorithms, errors ~1e-5 observed scale
# DAMSM similarity at full width (DamsmConfig, DataConfig.max_seqlen, the
# 17x17 regions of Inception's Mixed_6e)
DAMSM_BATCH, DAMSM_BIG = 64, 192
DAMSM_SEQ, DAMSM_REGIONS, DAMSM_DIM = 8, 289, 256
# kernel vs plain version, both fp32 (TF32 off): sims to 1e-4 relative and
# 1e-5 absolute; gradients to 1e-3 relative plus 1e-5 of the largest entry
# (the kernel forms the region-softmax row term as d_v.v, the plain version
# as sum_r d_a2 a2; both sum over up to 192 texts and 289 regions in other
# orders). Scores of ~1e3: 5e-3 / 5e-4, as tests/test_pallas.py allows.
SIMS_TOL = dict(rtol=1e-4, atol=1e-5)
EXTREME_TOL = dict(rtol=5e-3, atol=5e-4)
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-5
# fp32 pretrain step on the card vs the CPU: loss parts and BiLSTM gradient
# norm to 1e-3 relative, gradients to 1e-3 relative plus 1e-3 of the
# largest entry: a 94-conv trunk (cuDNN vs CPU algorithms) feeds the loss
STEP_RTOL, STEP_GRAD_ATOL_SHARE = 1e-3, 1e-3
GAN_STEPS = 20        # full-width GAN steps whose metrics must stay finite
GAN_CHECK_BATCH = 2   # the fp32 GAN step against the CPU
# ... and its gradients, in norm: the fakes differ by rounding (~1e-5) and
# the discriminators' leaky ReLUs and the trunk's ReLUs flip where an input
# lies within it of 0; the G-step runs through discriminators that Adam
# moved by +-lr, differently where their gradients straddle 0. Before
# models/cnn_encoder.py::_avg_pool3x3 the generator's was off by half. On
# an H100 80GB HBM3 at 700 W the generator's read 1.8e-2, and each of
# gan_faults 0.96-0.98 (the gan_fp32_vs_cpu line's faulty_steps).
GAN_GRAD_RTOL = 0.1
# phase 8: the scene corpus written as JPEGs, the card's embeddings of its
# records (files and flips) against the CPU's, fp32 with TF32 off (the
# same function in other conv algorithms; features of magnitude ~1-5)
CAPTIONER_IMAGES = 512
EMBED_ATOL, EMBED_CHECK = 1e-4, 64
NATIVE_MAD = 6.0      # native vs Pillow decode, mean levels an image
# ... and their complete-linkage trees: merge heights (cosine distances of
# the 128-dim PCA) within 1e-4, 100x the embeddings' relative difference
# (~1e-6: 2.4e-6 on features up to 2.4, H100 80GB HBM3 at 700 W); merges
# closer than that may come in either order
HEIGHT_ATOL = 1e-4
# phase 9: the pretrain options over 512 synthetic images at batch 64; the
# comparison runs' captions (3-8 words, a vocabulary of 1000) and classes
OPTIONS_IMAGES = 512
OPTIONS_SEED, OPTIONS_CLASSES = 0, 128
# losses against the plain run's over the same batches: the cached run
# trains on fp16 features (JAX states an O(1e-3) relative shift for an fp32
# trunk; a bf16 value is exact in fp16 above 2^-14); the superbatch's
# trunk runs at 256 rows, where cuDNN rounds the bf16 features otherwise
# than at 64 (its superbatch_features line says how far), and training
# carries that on: its 16 bf16 losses are held to SUPER_RTOL and to the
# plain run's own bf16 drift (plain bf16 against plain fp32), fp32 to
# SUPER_RTOL
CACHED_RTOL, SUPER_RTOL = 1e-2, 1e-3
# attention maps: each real word's map sums to 1 (an fp32 softmax over 289
# regions); the card's fp32 maps against the CPU's at batch 4
MAP_SUM_ATOL, MAP_CPU_ATOL = 1e-5, 1e-4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def fail_unless(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def refused(fn) -> str:
    """The message of the SystemExit that ``fn()`` must raise."""
    try:
        fn()
    except SystemExit as e:
        return str(e)
    raise RuntimeError("check failed: the call was not refused")


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of one call, from CUDA events around each of
    ``iters`` calls.

    A sleep kernel holds the stream while the host enqueues every call, so
    the events time the device's work and not the host's launch overhead
    (the sleep is lengthened until it outlasts the enqueue). A function of
    many small kernels (the plain versions) can fill the device's launch
    queue before the sleep ends; the host then waits on the queue, the
    device never waits on the host, and the events are device time all
    the same: after the sleep has been lengthened twice, they are taken as
    they are. A write of twice the L2 cache between calls leaves it cold,
    as the serving path, whose activations exceed it, finds its inputs."""
    import torch

    for _ in range(3):
        fn()
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    cycles = SLEEP_CYCLES
    for attempt in range(3):
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  for _ in range(iters)]
        held = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        held[0].record()
        torch.cuda._sleep(cycles)
        held[1].record()
        t0 = time.perf_counter()
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < held[0].elapsed_time(held[1]) or attempt == 2:
            return statistics.median(s.elapsed_time(e) for s, e in events)
        cycles *= 4


def ptxas_usage(log: str) -> list:
    """[[kernel, registers, spill stores, spill loads]] from nvcc's
    ``-Xptxas -v`` report (a kernel's lines follow its "Compiling entry
    function" line)."""
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    rows = []
    for line in log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            name = re.search(r"([a-z_]+kernel)(?:I(f|13__nv_bfloat16)?"
                             r"((?:Li\d+E)+)E)?", entry.group(1))
            if name and name.group(3):      # template arguments: <T,ints>
                args = ([types[name.group(2)]] if name.group(2) else []) + \
                    re.findall(r"Li(\d+)E", name.group(3))
                label = f"{name.group(1)}<{','.join(args)}>"
            else:
                label = name.group(1) if name else entry.group(1)
            rows.append([label, None, None, None])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and rows:
            rows[-1][2:] = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs and rows:
            rows[-1][1] = int(regs.group(1))
    return rows


def upblock_chain(torch, weight, bn_k, bn_b, dtype):
    """The plain serving chain the generator runs without the fused kernel
    (ops/layers.py::UpBlock.forward with fused_inference off, eval mode),
    holding this conv weight and BN constants: upsample_nearest_2x -> conv
    in ``dtype`` -> eval BatchNorm -> glu. Takes NCHW (channels_last)."""
    from attngan_torch.ops.layers import BN_EPS, UpBlock

    block = UpBlock(weight.shape[1], weight.shape[0] // 2,
                    dtype=dtype).cuda().eval()
    with torch.no_grad():
        block.conv.weight.copy_(weight)
        block.bn.weight.copy_(bn_k)
        block.bn.bias.copy_(bn_b)
        block.bn.running_var.fill_(1.0 - BN_EPS)   # fold() = (bn_k, bn_b)
    return block


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cases(torch, dtype, batch, seed):
    """(name, wrapper, plain, args, bound flops, gen) for every kernel at the
    gen2 and gen3 shapes of the serving path (gf=32: attention C=32 over 5
    words; UpBlock Ci=64 -> Co=32)."""
    from attngan_torch.ops.attention import word_attention
    from attngan_torch.ops.cuda_attention import word_attention_cuda
    from attngan_torch.ops.cuda_upblock import (
        upblock_fused_eval,
        upblock_fused_eval_cuda,
    )

    g = torch.Generator("cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale)

    cases = []
    for gen, hw in (("gen2", 64), ("gen3", 128)):
        images = randn(batch, hw, hw, 32).to(dtype)
        words = randn(batch, SEQ_LEN, 32).to(dtype)
        lengths = torch.randint(1, SEQ_LEN + 1, (batch,), generator=g,
                                device=dev)
        mask = (torch.arange(SEQ_LEN, device=dev)[None] < lengths[:, None]
                ).to(torch.int32)
        flops = 4 * batch * hw * hw * SEQ_LEN * 32
        cases.append(("word_attention", word_attention_cuda, word_attention,
                      (images, words, mask), flops, gen))
        x = randn(batch, hw, hw, 64).to(dtype)
        weight = randn(64, 64, 3, 3, scale=(9 * 64) ** -0.5)
        bn_k = torch.rand(64, generator=g, device=dev) + 0.5
        bn_b = randn(64, scale=0.1)
        flops = 2 * batch * (2 * hw) ** 2 * 64 * (4 * 64)
        cases.append(("upblock_fused_eval", upblock_fused_eval_cuda,
                      upblock_fused_eval, (x, weight, bn_k, bn_b), flops,
                      gen))
    return cases


def check_kernels(torch, card_name: str) -> dict:
    """Phase 2. Returns per-kernel totals over gen2 + gen3 at the serving
    batch in bf16, the serving type: ms, plain_ms, bound_ms, bound_by,
    max_abs_err. fp32 at the serving batch is timed too (printed, not in
    the totals): it is the CUDA-core form of the UpBlock kernels."""
    from attngan_torch.core.config import GanConfig
    from attngan_torch.ops.cuda_attention import plan
    from attngan_torch.ops.cuda_upblock import (
        form as upblock_form,
        upblock_fused_eval_cuda as k2,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    totals = {}
    for dtype, batch, timed in ((torch.float32, CHECK_BATCH, False),
                                (torch.bfloat16, CHECK_BATCH, False),
                                (torch.bfloat16, GanConfig().batch_size,
                                 False),
                                (torch.float32, BATCH, True),
                                (torch.bfloat16, BATCH, True)):
        tname = str(dtype).split(".")[-1]
        for name, fn, plain, args, flops, gen in kernel_cases(
                torch, dtype, batch, seed=batch):
            before = fn.launches
            resident_before = k2.resident_launches
            got = fn(*args)
            torch.cuda.synchronize()
            fail_unless(fn.launches == before + 1,
                        f"{name} counted {fn.launches - before} launches")
            if name == "word_attention":
                b, h, w, c = args[0].shape
                form = {"form": "stream", "plan": plan(
                    b, h * w, c, SEQ_LEN, args[0].element_size(),
                    sms)._asdict()}
            else:
                # bf16 at Ci=64 -> Co=32 takes the resident form, fp32 the
                # CUDA cores
                form = {"form": upblock_form(dtype, args[0].shape[3],
                                             args[1].shape[0] // 2)}
                resident = k2.resident_launches - resident_before
                expected = ("resident" if dtype == torch.bfloat16
                            else "cuda_cores")
                fail_unless(form["form"] == expected
                            and resident == (expected == "resident"),
                            f"{name} {tname}: the {form['form']} form, "
                            f"{resident} resident launches; expected "
                            f"{expected}")
            want = plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                fail_unless(a.shape == b.shape and a.dtype == b.dtype,
                            f"{name} output {i}: {a.shape} {a.dtype} vs "
                            f"{b.shape} {b.dtype}")
                tol = ATTN_TOL if i == 1 else TOL[tname]
                torch.testing.assert_close(a.float(), b.float(), **tol,
                                           msg=lambda m: f"{name} {gen} "
                                           f"{tname} B={batch}: {m}")
                err = max(err, float((a.float() - b.float()).abs().max()))
            line = {"phase": "kernel_check", "kernel": name, "shape": gen,
                    "dtype": tname, "batch": batch, "max_abs_err": err,
                    **form}
            if timed:
                moved = nbytes(*args, *got)
                peak = (BF16_FLOPS_PER_S if dtype == torch.bfloat16
                        else FP32_FLOPS_PER_S)
                bound = max(moved / HBM_BYTES_PER_S, flops / peak) * 1e3
                ms = time_ms(lambda: fn(*args))
                plain_ms = time_ms(lambda: plain(*args))
                line.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bytes=moved, flops=flops, card=card_name)
                if name == "upblock_fused_eval":
                    chain = upblock_chain(torch, *args[1:], dtype)
                    nchw = args[0].permute(0, 3, 1, 2)
                    with torch.inference_mode():
                        line["chain_ms"] = time_ms(lambda: chain(nchw))
            if timed and dtype == torch.bfloat16:
                t = totals.setdefault(name, dict(ms=0.0, plain_ms=0.0,
                                                 bound_ms=0.0, max_abs_err=0.0,
                                                 bytes_ms=0.0, flops_ms=0.0,
                                                 form=form["form"]))
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                if "chain_ms" in line:
                    t["chain_ms"] = t.get("chain_ms", 0.0) + line["chain_ms"]
                t["bound_ms"] += bound
                t["bytes_ms"] += moved / HBM_BYTES_PER_S * 1e3
                t["flops_ms"] += flops / BF16_FLOPS_PER_S * 1e3
                t["max_abs_err"] = max(t["max_abs_err"], err)
            print(json.dumps(line), flush=True)
    return totals


def damsm_inputs(torch, gen, bi, bt, extreme=False, seq=DAMSM_SEQ):
    dev = torch.device("cuda")
    img = torch.randn(bi, DAMSM_REGIONS, DAMSM_DIM, generator=gen, device=dev)
    words = torch.randn(bt, seq, DAMSM_DIM, generator=gen, device=dev)
    if extreme:               # text 0's scores ~ +-1e3, the others' O(1)
        words[0] *= 250.0
    lengths = torch.randint(1, seq + 1, (bt,), generator=gen, device=dev)
    mask = (torch.arange(seq, device=dev)[None] < lengths[:, None]
            ).to(torch.int32)
    g = torch.randn(bi, bt, generator=gen, device=dev)
    return img, words, mask, g


def tc_form(counter, before: int) -> str:
    """The form of the DAMSM kernel (the backward's: of its pass) in the
    calls since ``before`` (the counter's ``tc_launches`` then)."""
    return "tc_3xtf32" if counter.tc_launches > before else "cuda_cores"


def check_damsm_kernels(torch, card_name: str) -> dict:
    """Phase 2, DAMSM: K4 and the backward against their plain versions in
    fp32 at full width; timed at 64 x 64 (K4, K5), 192 x 192 (K4 and K6 on
    the B=192 step), 16 x 64 (K6 on a data-parallel shard's rows) and 16 x
    16 at 5 words (K4 and K5 in the GAN step's DAMSM coupling: tiles of 12
    texts, 60 word rows, the second tile of 4).
    Returns per kernel name: ms, plain_ms, bound_ms, bytes_ms, flops_ms,
    max_abs_err, form and tc_bound_ms (its products, two in K4 and six in
    the backward, at 3 TF32 products each on the tensor cores, or bytes if
    more) at the shapes of the pretrain step."""
    from attngan_torch.core.config import GanConfig
    from attngan_torch.ops.cuda_damsm import (
        _launch_fwd,
        damsm_similarity,
        damsm_similarity_bwd_square,
        damsm_similarity_bwd_tiled,
        plan,
    )
    from attngan_torch.ops.damsm_similarity import (
        similarity_bwd_plain,
        similarity_plain,
    )

    gen = torch.Generator("cuda").manual_seed(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gan_b = GanConfig().batch_size
    totals = {}
    # the shape each kernel meets on the pretrain step, for the totals
    report_at = {"damsm_similarity": "square64",
                 "damsm_similarity_bwd_square": "square64",
                 "damsm_similarity_bwd_tiled": "big192"}
    for label, bi, bt, extreme, seq in (
            ("square64", DAMSM_BATCH, DAMSM_BATCH, False, DAMSM_SEQ),
            ("big192", DAMSM_BIG, DAMSM_BIG, False, DAMSM_SEQ),
            ("rect16x64", 16, DAMSM_BATCH, False, DAMSM_SEQ),
            (f"gan{gan_b}", gan_b, gan_b, False, SEQ_LEN),
            ("extreme64", DAMSM_BATCH, DAMSM_BATCH, True, DAMSM_SEQ)):
        pair_flops = 2 * seq * DAMSM_DIM * DAMSM_REGIONS     # one product
        img, words, mask, g = damsm_inputs(torch, gen, bi, bt, extreme, seq)
        square = bi == bt <= 128
        bwd = damsm_similarity_bwd_square if square else \
            damsm_similarity_bwd_tiled
        bwd_name = ("damsm_similarity_bwd_square" if square
                    else "damsm_similarity_bwd_tiled")
        counts = lambda: (damsm_similarity.launches,
                          damsm_similarity.tc_launches, bwd.launches,
                          bwd.tc_launches)
        before = counts()
        sims = damsm_similarity(img, words, mask)
        grads = bwd(img, words, mask, g)
        torch.cuda.synchronize()
        after = counts()
        fail_unless(after == (before[0] + 1, before[1] + 1, before[2] + 2,
                              before[3] + 1),
                    f"{label}: launches (forward, its tensor-core form, "
                    f"backward, its tensor-core pass) {before} -> {after}")
        forms = {"damsm_similarity": tc_form(damsm_similarity, before[1]),
                 bwd_name: tc_form(bwd, before[3])}
        want = similarity_plain(img, words, mask)
        want_grads = similarity_bwd_plain(img, words, mask, g)
        torch.testing.assert_close(
            sims, want, **(EXTREME_TOL if extreme else SIMS_TOL),
            msg=lambda m: f"damsm_similarity {label}: {m}")
        for got, ref in zip(grads, want_grads):
            tol = EXTREME_TOL if extreme else dict(
                rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * float(ref.abs().max()))
            torch.testing.assert_close(
                got, ref, **tol, msg=lambda m: f"{bwd_name} {label}: {m}")
        errs = {"damsm_similarity": float((sims - want).abs().max()),
                bwd_name: max(float((a - b).abs().max())
                              for a, b in zip(grads, want_grads))}
        for name, err in errs.items():
            line = {"phase": "kernel_check", "kernel": name, "shape": label,
                    "dtype": "float32", "bi": bi, "bt": bt, "words": seq,
                    "max_abs_err": err, "form": forms[name]}
            if not extreme:
                if name == "damsm_similarity":
                    fn = lambda: damsm_similarity(img, words, mask)
                    plain = lambda: similarity_plain(img, words, mask)
                    moved = nbytes(img, words, mask, sims)
                    flops = 2 * pair_flops * bi * bt     # two products
                else:
                    fn = lambda: bwd(img, words, mask, g)
                    plain = lambda: similarity_bwd_plain(img, words, mask, g)
                    moved = nbytes(img, words, mask, g, *grads)
                    flops = 6 * pair_flops * bi * bt     # recompute + four
                bytes_ms = moved / HBM_BYTES_PER_S * 1e3
                flops_ms = flops / FP32_FLOPS_PER_S * 1e3
                line.update(ms=time_ms(fn), plain_ms=time_ms(plain),
                            bound_ms=max(bytes_ms, flops_ms),
                            tc_bound_ms=max(
                                bytes_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3),
                            bytes=moved, flops=flops, card=card_name)
                if name == "damsm_similarity":
                    # the tensor-core form on its grid and on the others
                    _, k, s_bwd = plan(bi, bt, seq, DAMSM_DIM, sms)
                    s = plan(bi, bt, seq, DAMSM_DIM, sms, slack=1.0)[2]
                    line["splits"] = s
                    line["grid_ms"] = {
                        str(n): time_ms(lambda: _launch_fwd(
                            img, words, mask, 4.0, 5.0, splits=n))
                        for n in sorted({s_bwd, k, s})}
                if report_at[name] == label:
                    totals[name] = dict(line, bytes_ms=bytes_ms,
                                        flops_ms=flops_ms)
            t = totals.setdefault(name, {})
            t["max_abs_err"] = max(t.get("max_abs_err", 0.0), err)
            print(json.dumps(line), flush=True)
    return totals


def damsm_batch(torch, rng, batch: int) -> dict:
    """A pretraining batch made from ``rng``: random captions, 256^2
    images in [-1, 1] on the card; the lengths stay on the host, where
    the BiLSTM's packing reads them."""
    return {
        "tokens": torch.as_tensor(rng.integers(0, VOCAB, (batch, DAMSM_SEQ)),
                                  device="cuda"),
        "lengths": torch.as_tensor(rng.integers(1, DAMSM_SEQ + 1, batch)),
        "class_ids": torch.as_tensor(rng.integers(0, 50, batch),
                                     device="cuda"),
        "img256": torch.as_tensor(rng.uniform(-1, 1, (batch, 256, 256, 3)),
                                  dtype=torch.float32, device="cuda")}


def kernel_counters() -> dict:
    """{kernel name: its wrapper}, whose ``launches`` the paths read."""
    from attngan_torch.ops.cuda_attention import word_attention_cuda
    from attngan_torch.ops.cuda_damsm import (
        damsm_similarity,
        damsm_similarity_bwd_square,
        damsm_similarity_bwd_tiled,
    )
    from attngan_torch.ops.cuda_upblock import upblock_fused_eval_cuda

    return {"word_attention": word_attention_cuda,
            "upblock_fused_eval": upblock_fused_eval_cuda,
            "damsm_similarity": damsm_similarity,
            "damsm_similarity_bwd_square": damsm_similarity_bwd_square,
            "damsm_similarity_bwd_tiled": damsm_similarity_bwd_tiled}


def pretrain(torch, card_name: str):
    """Phase 5: the full-width pretrain step at batch 64 and 192 with exact
    launch counts, a falling loss over 20 steps, fp32 against the CPU.
    Returns ({kernel name: launches in its step}, trainer, state, batch)."""
    import numpy as np

    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    counters = kernel_counters()
    rng = np.random.default_rng(5)
    trainer = DamsmTrainer(DamsmConfig(), VOCAB, DAMSM_SEQ)
    state = trainer.init_state(seed=0)
    batches = {b: damsm_batch(torch, rng, b) for b in (DAMSM_BATCH,
                                                       DAMSM_BIG)}
    launches = {}
    expect = {DAMSM_BATCH: {"damsm_similarity": 1,
                            "damsm_similarity_bwd_square": 2},
              DAMSM_BIG: {"damsm_similarity": 1,
                          "damsm_similarity_bwd_tiled": 2}}
    with_tc = ("damsm_similarity", "damsm_similarity_bwd_square",
               "damsm_similarity_bwd_tiled")
    for b, want in expect.items():
        trainer.train_step(state, batches[b])                      # warm
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        for name in with_tc:
            counters[name].tc_launches = 0
        state, m = trainer.train_step(state, batches[b])
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        tc = {name: counters[name].tc_launches for name in with_tc}
        full = {name: want.get(name, 0) for name in counters}
        fail_unless(counts == full, f"pretrain step at batch {b}: launches "
                    f"{counts}, expected {full}")
        # the forward, and the backward's pass (one of its two launches),
        # on the tensor cores
        tc_want = {name: min(want.get(name, 0), 1) for name in with_tc}
        fail_unless(tc == tc_want, f"pretrain step at batch {b}: tensor-core "
                    f"launches {tc}, expected {tc_want}")
        metrics = {k: float(v) for k, v in m.items()}
        fail_unless(all(np.isfinite(v) for v in metrics.values()),
                    f"non-finite metrics {metrics}")
        for name, n in want.items():
            launches[name] = launches.get(name, 0) + n
        print(json.dumps({"phase": "pretrain_step", "batch": b,
                          "launches": counts, "tc_launches": tc,
                          **metrics}), flush=True)

    losses = []
    for _ in range(20):
        state, m = trainer.train_step(state, batches[DAMSM_BATCH])
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    print(json.dumps({"phase": "pretrain_loss", "batch": DAMSM_BATCH,
                      "steps": len(losses), "losses": losses}), flush=True)
    fail_unless(all(np.isfinite(losses)), "non-finite loss")
    fail_unless(np.mean(losses[-3:]) < np.mean(losses[:3]),
                f"loss does not fall: {losses[:3]} -> {losses[-3:]}")
    step_fp32_vs_cpu(torch, rng)
    return launches, trainer, state, batches[DAMSM_BATCH]


def step_fp32_vs_cpu(torch, rng) -> None:
    """Two fp32 steps at batch 4 (dropout 0) on the card and on the CPU from
    the same seeded weights: loss parts, BiLSTM gradient norm, and the
    first step's clipped gradients of every trainable parameter."""
    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    cfg = DamsmConfig(compute_dtype="", dropout=0.0)
    batch = {k: v.cpu() for k, v in damsm_batch(torch, rng, 4).items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = DamsmTrainer(cfg, VOCAB, DAMSM_SEQ, device=dev)
        state = trainer.init_state(seed=7)
        metrics = []
        for step in range(2):
            state, m = trainer.train_step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if step == 0:
                grads = [p.grad.cpu().clone() for _, p in state.trainable()]
        runs[dev] = metrics, grads
    metric_err = max(abs(a[k] - b[k]) / abs(b[k])
                     for a, b in zip(runs["cuda"][0], runs["cpu"][0])
                     for k in b)
    grad_err = 0.0
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        grad_err = max(grad_err, float((a - b).abs().max())
                       / float(b.abs().max()))
        torch.testing.assert_close(
            a, b, rtol=STEP_RTOL,
            atol=STEP_GRAD_ATOL_SHARE * float(b.abs().max()))
    print(json.dumps({"phase": "pretrain_fp32_vs_cpu", "batch": 4,
                      "metrics_gpu": runs["cuda"][0],
                      "metrics_cpu": runs["cpu"][0],
                      "max_rel_metric_err": metric_err,
                      "max_grad_err_over_max": grad_err}), flush=True)
    fail_unless(metric_err <= STEP_RTOL,
                f"fp32 step: metrics differ by {metric_err} relative")


def pretrain_throughput(torch, trainer, state, batch, card_name: str) -> None:
    """steps/s and images/s at batch 64 over 10 windows of 10 steps, with
    the kernels and with the plain words loss (autograd through the
    vectorised form), the two taking their windows in turns, on one state."""
    from attngan_torch.core.config import replace
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    plain = DamsmTrainer(replace(trainer.cfg, fused_similarity=False), VOCAB,
                         DAMSM_SEQ)
    paths = (("kernels", trainer), ("plain", plain))
    for _, t in paths:
        t.train_step(state, batch)
    torch.cuda.synchronize()
    rates = {label: [] for label, _ in paths}
    for round_ in range(10):
        for label, t in paths[round_ % 2:] + paths[:round_ % 2]:
            start = time.perf_counter()
            for _ in range(10):
                t.train_step(state, batch)
            torch.cuda.synchronize()
            rates[label].append(10 / (time.perf_counter() - start))
    for label, windows in rates.items():
        median = statistics.median(windows)
        print(json.dumps({
            "phase": "pretrain_throughput", "path": label,
            "batch": DAMSM_BATCH, "steps_per_s": median,
            "images_per_s": median * DAMSM_BATCH, "windows": windows,
            "spread_pct": 100 * (max(windows) - min(windows)) / median,
            "card": card_name}), flush=True)


def gan_batch(torch, rng, batch: int, resolutions) -> dict:
    """A GAN batch made from ``rng``: random captions of SEQ_LEN tokens, real
    images in [-1, 1] at each resolution on the card; the lengths stay on
    the host, where the BiLSTM's packing reads them."""
    return {
        "tokens": torch.as_tensor(rng.integers(0, VOCAB, (batch, SEQ_LEN)),
                                  device="cuda"),
        "lengths": torch.as_tensor(rng.integers(1, SEQ_LEN + 1, batch)),
        "class_ids": torch.as_tensor(rng.integers(0, 50, batch),
                                     device="cuda"),
        **{f"img{r}": torch.as_tensor(rng.uniform(-1, 1, (batch, r, r, 3)),
                                      dtype=torch.float32, device="cuda")
           for r in resolutions}}


def gan_tensors(state) -> dict:
    """{name: tensor} of the generator's and discriminators' parameters and
    BN statistics."""
    return {**{f"gen.{k}": v for k, v in state.gen.state_dict().items()},
            **{f"disc{k}": v for k, v in state.discs.state_dict().items()}}


def gan(torch, card_name: str):
    """Phase 6: the full-width GAN step (GanConfig defaults: gf 32, df 64,
    emb 256, 3 stages, 5 words, bf16; the Inception-v3 trunk with seeded
    random weights; vocab 1000) at its batch_size, 16. One step with the launch
    counters reset just before and read just after: K1 twice (the gen2 and
    gen3 forwards; the backward recomputes through the plain version), K4
    once and K5 twice, each on the tensor cores once, nothing else; 20
    steps, all metrics finite, every parameter and BN statistic of the
    generator and the discriminators moved; the fp32 step at batch 2
    against the port's CPU run, with its faulty steps. Returns ({kernel
    name: launches in its step}, trainer, state, batch)."""
    import numpy as np

    from attngan_torch.core.config import GanConfig
    from attngan_torch.train.gan_trainer import GanTrainer

    counters = kernel_counters()
    rng = np.random.default_rng(6)
    cfg = GanConfig()
    trainer = GanTrainer(cfg, VOCAB)
    state = trainer.init_state(seed=0)
    batch = gan_batch(torch, rng, cfg.batch_size, cfg.resolutions)
    before = {k: v.clone() for k, v in gan_tensors(state).items()}
    want = {"word_attention": 2, "damsm_similarity": 1,
            "damsm_similarity_bwd_square": 2}
    with_tc = ("damsm_similarity", "damsm_similarity_bwd_square",
               "damsm_similarity_bwd_tiled")
    metrics = [trainer.train_step(state, batch)[1]]              # warm
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for name in with_tc:
        counters[name].tc_launches = 0
    state, m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counters.items()}
    tc = {name: counters[name].tc_launches for name in with_tc}
    full = {name: want.get(name, 0) for name in counters}
    fail_unless(counts == full, f"GAN step: launches {counts}, expected {full}")
    tc_want = {name: min(want.get(name, 0), 1) for name in with_tc}
    fail_unless(tc == tc_want, f"GAN step: tensor-core launches {tc}, "
                f"expected {tc_want}")
    metrics.append(m)
    print(json.dumps({"phase": "gan_step", "batch": cfg.batch_size,
                      "launches": counts, "tc_launches": tc,
                      **{k: float(v) for k, v in m.items()}}), flush=True)
    for _ in range(GAN_STEPS - len(metrics)):
        metrics.append(trainer.train_step(state, batch)[1])
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    fail_unless(all(np.isfinite(v) for m in metrics for v in m.values()),
                f"non-finite GAN metrics {metrics}")
    still = sorted(k for k, v in gan_tensors(state).items()
                   if torch.equal(v, before[k]))
    fail_unless(not still, f"did not move in {GAN_STEPS} steps: {still}")
    print(json.dumps({"phase": "gan_steps", "batch": cfg.batch_size,
                      "steps": len(metrics), "tensors_moved": len(before),
                      "metrics": {k: [m[k] for m in metrics]
                                  for k in metrics[0]}}), flush=True)
    gan_fp32_vs_cpu(torch, rng)
    return want, trainer, state, batch


def gan_fp32_step(torch, cfg, batch, noise, eps, dev: str, fault=None):
    """One fp32 GAN step from seed 7 on ``dev``, under the context manager
    ``fault()`` where given: (metrics, gradients, BN statistics), the last
    two {name: CPU tensor} of the generator and the discriminators."""
    import contextlib

    from attngan_torch.train.gan_trainer import GanTrainer

    trainer = GanTrainer(cfg, VOCAB, device=dev)
    state = trainer.init_state(seed=7)
    with (fault or contextlib.nullcontext)():
        state, m = trainer.train_step(state, batch, noise=noise, eps=eps)
    modules = {"gen": state.gen,
               **{f"disc{r}": d for r, d in state.discs.items()}}
    return ({k: float(v) for k, v in m.items()},
            {f"{w}.{k}": p.grad.cpu() for w, mod in modules.items()
             for k, p in mod.named_parameters()},
            {f"{w}.{k}": v.cpu() for w, mod in modules.items()
             for k, v in mod.named_buffers()})


def gan_step_errors(cfg, got, ref) -> dict:
    """How far step ``got`` lies from step ``ref`` (each gan_fp32_step's),
    in the measures gan_fp32_vs_cpu holds."""
    (m_a, g_a, s_a), (m_b, g_b, s_b) = got, ref

    def rel_norm(keys, a, b):
        return float(sum((a[k] - b[k]).square().sum() for k in keys).sqrt()
                     / sum(b[k].square().sum() for k in keys).sqrt())

    grad = {"gen": rel_norm([k for k in g_b if k.startswith("gen.")],
                            g_a, g_b)}
    for res in cfg.resolutions:
        grad[f"disc{res}"] = max(rel_norm([k], g_a, g_b) for k in g_b
                                 if k.startswith(f"disc{res}."))
    gen_stat = max(float(((s_a[k] - v).abs() - STEP_RTOL * v.abs()).max())
                   / (float(v.abs().max()) or 1.0)
                   for k, v in s_b.items() if k.startswith("gen."))
    disc_stat = max(rel_norm([k], s_a, s_b) for k in s_b
                    if k.startswith("disc"))
    return {"metric": max(abs(m_a[k] - v) / abs(v) for k, v in m_b.items()),
            "grad": grad, "gen_stat": gen_stat, "disc_stat": disc_stat}


def gan_step_agrees(err: dict) -> bool:
    return (err["metric"] <= STEP_RTOL
            and max(err["grad"].values()) <= GAN_GRAD_RTOL
            and err["gen_stat"] <= STEP_GRAD_ATOL_SHARE
            and err["disc_stat"] <= GAN_GRAD_RTOL)


def gan_faults(torch) -> dict:
    """Faults that leave the step's metrics as they are and change only
    its gradients, each a context manager: the control runs of
    gan_fp32_vs_cpu, which its check must catch."""
    from unittest import mock

    from attngan_torch.ops import cuda_damsm
    from attngan_torch.train.gan_trainer import GanTrainer

    coupling = GanTrainer._damsm_coupling
    bwd = cuda_damsm.damsm_similarity_bwd

    def detached(self, state, fake256, *args):
        return coupling(self, state, fake256.detach(), *args)

    def doubled(*args):
        return tuple(2 * g for g in bwd(*args))

    return {
        # the DAMSM coupling's gradient does not reach the generator
        "coupling_gradient_dropped": lambda: mock.patch.object(
            GanTrainer, "_damsm_coupling", detached),
        # K5 returns twice the words loss's gradient
        "k5_gradient_doubled": lambda: mock.patch.object(
            cuda_damsm, "damsm_similarity_bwd", doubled),
    }


def gan_fp32_vs_cpu(torch, rng) -> None:
    """One fp32 GAN step at batch GAN_CHECK_BATCH (full width, the kernels
    on: K1, K4 and K5 in fp32) on the card and on the CPU from the same
    seeded weights, noise and eps. Held: the metrics within STEP_RTOL
    relative; the generator's BN statistics (moved once, by the forward,
    before any update) with phase 5's rule, STEP_RTOL relative plus
    STEP_GRAD_ATOL_SHARE of the largest entry; in norm within GAN_GRAD_RTOL,
    the gradients (each discriminator tensor's, the generator's as a whole)
    and each discriminator's BN statistics (last moved by the G-side pass,
    through the updated parameters).

    The gradients are held in norm only: elementwise they do not reproduce
    across devices in this step (leaky ReLU and ReLU kinks flip where an
    input lies within rounding of 0). The updated parameters are not held
    apart: from the same weights, Adam's first step moves each by
    lr g / (|g| + eps), a function of its gradient alone, so they would
    hold the same gradients again, elementwise, through the sign of g.

    Then each of ``gan_faults`` runs the card's step once more; the check
    must fail on it (each reading is printed beside the limits)."""
    import numpy as np

    from attngan_torch.core.config import GanConfig

    cfg = GanConfig(compute_dtype="")
    batch = {k: v.cpu() for k, v in
             gan_batch(torch, rng, GAN_CHECK_BATCH, cfg.resolutions).items()}
    noise = torch.from_numpy(rng.standard_normal(
        (GAN_CHECK_BATCH, cfg.z_dim), dtype=np.float32))
    eps = torch.from_numpy(rng.standard_normal(
        (GAN_CHECK_BATCH, cfg.cond_dim), dtype=np.float32))
    cpu = gan_fp32_step(torch, cfg, batch, noise, eps, "cpu")
    gpu = gan_fp32_step(torch, cfg, batch, noise, eps, "cuda")
    err = gan_step_errors(cfg, gpu, cpu)
    faults = {name: gan_step_errors(cfg, gan_fp32_step(
        torch, cfg, batch, noise, eps, "cuda", fault), cpu)
        for name, fault in gan_faults(torch).items()}
    print(json.dumps({"phase": "gan_fp32_vs_cpu", "batch": GAN_CHECK_BATCH,
                      "metrics_gpu": gpu[0], "metrics_cpu": cpu[0],
                      "errors": err, "faulty_steps": faults,
                      "limits": {"metric": STEP_RTOL,
                                 "grad": GAN_GRAD_RTOL,
                                 "gen_stat": STEP_GRAD_ATOL_SHARE,
                                 "disc_stat": GAN_GRAD_RTOL}}), flush=True)
    fail_unless(gan_step_agrees(err),
                f"fp32 GAN step: the card's differs from the CPU's: {err}")
    for name, fault_err in faults.items():
        fail_unless(not gan_step_agrees(fault_err),
                    f"fp32 GAN step: the check does not catch {name}: "
                    f"{fault_err}")


def bare_windows(torch, trainer, state, batch, windows: int = 4,
                 steps: int = 16) -> list:
    """steps/s of ``windows`` windows of ``steps`` bare train steps on one
    batch (no loop, no data path), each window ended by a synchronize."""
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - start))
    return rates


def gan_throughput(torch, trainer, state, batch, card_name: str) -> float:
    """GAN steps/s and images/s at the configuration's batch over 6 windows
    of 4 steps, with the kernels and with the plain paths (fused_attention
    and fused_similarity off: K1 and the words loss in PyTorch ops), the two
    taking their windows in turns, each on its own state from one seed.
    Returns the kernel path's median steps/s."""
    from attngan_torch.core.config import replace
    from attngan_torch.train.gan_trainer import GanTrainer

    b = trainer.cfg.batch_size
    plain = GanTrainer(replace(trainer.cfg, fused_attention=False,
                               fused_similarity=False), VOCAB)
    paths = (("kernels", trainer, state),
             ("plain", plain, plain.init_state(seed=0)))
    for _, t, st in paths:
        t.train_step(st, batch)
    torch.cuda.synchronize()
    rates = {label: [] for label, _, _ in paths}
    for round_ in range(6):
        for label, t, st in paths[round_ % 2:] + paths[:round_ % 2]:
            rates[label] += bare_windows(torch, t, st, batch, windows=1,
                                         steps=4)
    for label, windows in rates.items():
        median = statistics.median(windows)
        print(json.dumps({
            "phase": "gan_throughput", "path": label, "batch": b,
            "steps_per_s": median, "images_per_s": median * b,
            "windows": windows,
            "spread_pct": 100 * (max(windows) - min(windows)) / median,
            "card": card_name}), flush=True)
    return statistics.median(rates["kernels"])


class LoopProbe:
    """Phase 7's instruments around the loops, installed while it runs:
    the time and bytes of every checkpoint save and the time of every
    sample grid (each after a synchronize, so that the steps' queued work
    is not theirs), the loop's StepTimer, and a bit-for-bit comparison of
    every restored state with the files it came from (``restored`` keeps
    each path with the state's saved form just after its restore)."""

    def __init__(self, torch):
        from attngan_torch.train import checkpoint, loops

        self.torch, self.checkpoint, self.loops = torch, checkpoint, loops
        self.saves, self.grids, self.restored, self.timers = [], [], [], []
        self.originals = {}

    def __enter__(self):
        loops, checkpoint, probe = self.loops, self.checkpoint, self

        def save(directory, state, step, *args, **kw):
            probe.torch.cuda.synchronize()
            t = time.perf_counter()
            path = probe.originals["save_checkpoint"](directory, state, step,
                                                      *args, **kw)
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            probe.saves.append((time.perf_counter() - t, size))
            return path

        def grid(*args, **kw):
            probe.torch.cuda.synchronize()
            t = time.perf_counter()
            probe.originals["_sample_grid"](*args, **kw)
            probe.grids.append(time.perf_counter() - t)

        def restore(path, state):
            state = probe.originals["restore_checkpoint"](path, state)
            parts = checkpoint.state_parts(state)
            diff = checkpoint.diff_parts(parts, {
                name: checkpoint.load_part(path, name) for name in parts})
            fail_unless(not diff, f"restored state differs from {path} at "
                        f"{diff[:5]}")
            probe.restored.append((path, parts))
            return state

        class Timer(loops.StepTimer):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                probe.timers.append(self)

        self.originals = {"save_checkpoint": loops.save_checkpoint,
                          "_sample_grid": loops._sample_grid,
                          "restore_checkpoint": loops.restore_checkpoint,
                          "StepTimer": loops.StepTimer}
        loops.save_checkpoint, loops._sample_grid = save, grid
        loops.restore_checkpoint = checkpoint.restore_checkpoint = restore
        loops.StepTimer = Timer
        return self

    def __exit__(self, *exc):
        for name, fn in self.originals.items():
            setattr(self.loops, name, fn)
        self.checkpoint.restore_checkpoint = \
            self.originals["restore_checkpoint"]

    def run(self, counters, fn):
        """(fn's result, {kernel: launches}, seconds, the loop's line)."""
        torch = self.torch
        for c in counters.values():
            c.launches = 0
        n_saves, n_grids, n_timers = (len(self.saves), len(self.grids),
                                      len(self.timers))
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = {name: c.launches for name, c in counters.items()}
        saves = self.saves[n_saves:]
        line = {"seconds": seconds, "launches": counts,
                "checkpoint_s": [s for s, _ in saves],
                "checkpoint_mb": [b / 2 ** 20 for _, b in saves],
                "grid_s": self.grids[n_grids:]}
        timers = self.timers[n_timers:]
        if timers:
            # steps after the first (the StepTimer's warm-up) over the time
            # from its end to the loop's end: with the per-epoch saves and
            # grids, and without them
            timer = timers[-1]
            loop_s = time.perf_counter() - timer.start
            line.update(counted_steps=timer.count, loop_s=loop_s,
                        steps_per_s=timer.count / loop_s,
                        steps_per_s_without_saves=timer.count / (
                            loop_s - sum(line["checkpoint_s"])
                            - sum(line["grid_s"])))
        return out, counts, line


def prefetched_vs_sync(torch, card_name: str) -> dict:
    """The loop's batches (host batches pinned by the prefetch thread, then
    the copies and the pyramid on the main stream) against the same
    batches built synchronously from the numpy arrays, bit for bit. Each
    loop batch is followed by 4 matmuls of 4096^2 that hold the stream, so
    that the host runs ahead of the queued copies and frees their pinned
    sources while they are pending. Returns the first synchronous batch."""
    from attngan_torch.data.synthetic import make_synthetic_dataset
    from attngan_torch.train import loops

    dataset = make_synthetic_dataset(128)
    dataset.build_vocab()
    seed, b = 1, 16
    busy = torch.randn(4096, 4096, device="cuda")
    got = []
    for batch in loops._epoch_batches(dataset, b, SEQ_LEN, seed,
                                      torch.device("cuda")):
        for _ in range(4):
            torch.mm(busy, busy)
        got.append(batch)
    torch.cuda.synchronize()
    want = [dataset.device_batch(host, "cuda") for host in
            dataset.iter_batches(b, SEQ_LEN, seed=seed)
            if not loops._skip_batch(host, b)]
    fail_unless(len(got) == len(want) == 128 // b,
                f"prefetch: {len(got)} batches, sync {len(want)}")
    differ = sorted({key for g, w in zip(got, want) for key in w
                     if g[key].device != w[key].device
                     or not torch.equal(g[key], w[key])})
    fail_unless(not differ, f"prefetched batches differ at {differ}")
    print(json.dumps({"phase": "loops", "step": "prefetch_vs_sync",
                      "batches": len(got), "keys": sorted(want[0]),
                      "identical": True, "card": card_name}), flush=True)
    return want[0]


def loops_phase(torch, card_name: str, bare_gan_rate: float) -> dict:
    """Phase 7: the CLIs' main(argv) in-process, chained through their own
    checkpoints under one temporary directory, at full width (DamsmConfig
    and GanConfig defaults; Inception-v3 trunk in bf16, seeded random
    weights): pretrain on 128 synthetic images at batch 64 for 2 epochs
    (4 steps), GAN training on 64 at batch 16 for 2 epochs (8 steps, a
    sample grid each epoch) from the pretrain's checkpoint, its resume to
    3 epochs (4 more steps; the restored state must equal the saved one
    bit for bit, and the steps must then move every tensor of the
    generator and the discriminators, the Adams, the generator state and
    the step, and nothing of the frozen encoders), then serving from the
    GAN checkpoint: 2 captions through --swap 1 --all-stages
    --save-attention (10 PNGs, each read back to its shape) and
    --benchmark at batch 64. Every loss history must be finite and move;
    the GAN state's encoders must equal the DAMSM checkpoint's files bit
    for bit. Before the chain, the loop's prefetched batches against
    synchronous ones (``prefetched_vs_sync``); after it, the loop's cost:
    a GAN run of 2 epochs of 32 steps (512 images) with one save and one
    grid, at its end, beside 4 windows of 16 bare steps on the state it
    returns. Each launch count must be exact. Returns {kernel name:
    launches over the phase}."""
    from attngan_torch.cli import infer, pretrain, train
    from attngan_torch.train.checkpoint import (
        diff_parts,
        latest_checkpoint,
        load_part,
        state_parts,
    )
    from attngan_torch.utils.imaging import read_png

    counters = kernel_counters()
    total = {}

    def expect(step: str, counts: dict, want: dict) -> None:
        full = {name: want.get(name, 0) for name in counters}
        fail_unless(counts == full, f"loops {step}: launches {counts}, "
                    f"expected {full}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    bare_batch = prefetched_vs_sync(torch, card_name)
    with tempfile.TemporaryDirectory() as d, LoopProbe(torch) as probe:
        common = ["--captions-path", f"{d}/caps.json",
                  "--checkpoint-dir", f"{d}/ckpt", "--image-dir", f"{d}/img"]
        tc_names = ("damsm_similarity", "damsm_similarity_bwd_square")
        tc_before = [counters[n].tc_launches for n in tc_names]
        (_, state, history), counts, line = probe.run(
            counters, lambda: pretrain.main([
                "--synthetic", "128", "--batch-size", "64", "--epochs", "2",
                *common]))
        steps = state.step
        fail_unless(steps == 4, f"pretrain ran {steps} steps, not 4")
        fail_unless(all(map(math.isfinite, history))
                    and len(set(history)) > 1, f"pretrain: loss {history}")
        # the forward, and the backward's pass, on the tensor cores
        fail_unless([counters[n].tc_launches - b for n, b in
                     zip(tc_names, tc_before)] == [steps, steps],
                    "pretrain: K4 or K5 off the tensor cores")
        expect("pretrain", counts, {"damsm_similarity": steps,
                                    "damsm_similarity_bwd_square": 2 * steps})
        print(json.dumps({"phase": "loops", "step": "pretrain", "batch": 64,
                          "steps": steps, "losses": history, **line,
                          "card": card_name}), flush=True)

        damsm_ckpt = latest_checkpoint(f"{d}/ckpt/damsm")

        def gan_run(label, argv, want_steps, grids):
            (trainer, state, losses), counts, line = probe.run(
                counters, lambda: train.main(argv))
            steps = len(losses["g_total"])
            fail_unless(steps == want_steps, f"{label}: {steps} steps")
            fail_unless(all(math.isfinite(v) for h in losses.values()
                            for v in h), f"{label}: non-finite losses")
            still = [k for k, h in losses.items() if len(set(h)) == 1]
            fail_unless(not still, f"{label}: {still} did not move")
            for name in ("rnn", "cnn"):       # loaded, then frozen
                diff = diff_parts(getattr(state, name).state_dict(),
                                  load_part(damsm_ckpt, name))
                fail_unless(not diff, f"{label}: {name} differs from "
                            f"{damsm_ckpt} at {diff[:5]}")
            expect(label, counts, {
                "word_attention": 2 * steps + 2 * grids,
                "upblock_fused_eval": 2 * grids,
                "damsm_similarity": steps,
                "damsm_similarity_bwd_square": 2 * steps})
            line.update(batch=16, steps=steps, state_step=state.step,
                        grids=grids, bare_step_steps_per_s=bare_gan_rate,
                        final_losses={k: v[-1] for k, v in losses.items()})
            return trainer, state, line

        gan = ["--synthetic", "64", "--batch-size", "16",
               "--damsm-checkpoint", f"{d}/ckpt/damsm", *common]
        _, state, line = gan_run("gan", [*gan, "--epochs", "2"], 8, 2)
        fail_unless(not probe.restored, "gan: restored a checkpoint")
        print(json.dumps({"phase": "loops", "step": "gan", **line,
                          "card": card_name}), flush=True)
        del state
        _, state, line = gan_run("gan_resume",
                                 [*gan, "--epochs", "3", "--resume"], 4, 1)
        fail_unless(len(probe.restored) == 1, "gan_resume: restores")
        restored = probe.restored[-1][1]
        moved = {where.split(".")[1]
                 for where in diff_parts(state_parts(state), restored)}
        want_moved = {"gen", "discs", "gen_optimizer", "disc_optimizers",
                      "generator", "step"}
        fail_unless(moved == want_moved, f"gan_resume: moved {sorted(moved)}"
                    f" since the restore, expected {sorted(want_moved)}")
        still = [f"{field}.{k}" for field in ("gen", "discs")
                 for k, v in getattr(state, field).state_dict().items()
                 if torch.equal(v.cpu(), restored[field][k])]
        fail_unless(not still, f"gan_resume: unmoved since the restore: "
                    f"{still[:5]}")
        print(json.dumps({"phase": "loops", "step": "gan_resume", **line,
                          "moved_since_restore": sorted(moved),
                          "card": card_name}), flush=True)
        fail_unless(state.step == 12, f"the resumed run ends at step "
                    f"{state.step}, not 12")
        with open(f"{d}/ckpt/gan/progress.json") as f:
            fail_unless(json.load(f)["epoch"] == 3, "progress.json epoch")
        fail_unless(os.path.exists(f"{d}/img/epoch_3-256x256.png"),
                    "the resumed run's grid is not epoch 3's")
        del state, restored

        serve = ["--checkpoint", f"{d}/ckpt/gan",
                 "--captions-path", f"{d}/caps.json"]
        # JAX's model flags: the recorded values serve, a contradicting
        # --df-dim is refused before anything runs
        with open(f"{d}/ckpt/gan/config.json") as f:
            recorded = json.load(f)
        jax_flags = ["--df-dim", str(recorded["df_dim"]), "--image-encoder",
                     recorded["image_encoder"], "--fused-attention"]
        refusal, counts, _ = probe.run(counters, lambda: refused(
            lambda: infer.main([*serve, "--image-names", "00000",
                                "--df-dim", str(2 * recorded["df_dim"]),
                                "--out", f"{d}/refused"])))
        expect("serve_contradicting_df_dim", counts, {})
        fail_unless("contradicts the checkpoint's recorded df_dim" in refusal
                    and not os.path.exists(f"{d}/refused"),
                    f"a contradicting --df-dim: {refusal!r}")
        print(json.dumps({"phase": "loops", "step": "serve_shape_flags",
                          "served_with": jax_flags, "refused": refusal}),
              flush=True)
        paths, counts, line = probe.run(counters, lambda: infer.main([
            *serve, *jax_flags, "--image-names", "00000", "00001", "--swap",
            "1", "--all-stages", "--save-attention", "--out", f"{d}/out"]))
        expect("serve_images", counts, {"word_attention": 2,
                                        "upblock_fused_eval": 2})
        want = {"64px": (64, 64, 3), "128px": (128, 128, 3),
                "256px": (256, 256, 3), "attn64": (64, SEQ_LEN * 64, 3),
                "attn128": (128, SEQ_LEN * 128, 3)}
        fail_unless(sorted(os.path.basename(p) for p in paths) == sorted(
            f"{n}_{k}.png" for n in ("00000", "00001") for k in want),
            f"serving wrote {paths}")
        shapes = {}
        for path in paths:
            png = read_png(path)
            kind = os.path.basename(path)[6:-4]
            fail_unless(png.shape == want[kind], f"{path}: {png.shape}")
            shapes[os.path.basename(path)] = [list(png.shape),
                                              float(png.std())]
        print(json.dumps({"phase": "loops", "step": "serve_images",
                          "pngs": shapes, **line, "card": card_name}),
              flush=True)

        bench, counts, line = probe.run(counters, lambda: infer.main([
            *serve, "--benchmark", "--batch-size", "64"]))
        calls = 1 + infer.BENCH_WINDOWS * infer.BENCH_ITERS
        # the host launches on the first call (eager) and the second (the
        # graph's capture); the others replay it
        host = 2 * min(calls, 2)
        expect("serve_benchmark", counts, {"word_attention": host,
                                           "upblock_fused_eval": host})
        print(json.dumps({"phase": "loops", "step": "serve_benchmark",
                          "calls": calls, "img_per_s": bench["value"],
                          "spread_pct": bench["spread_pct"], **line,
                          "card": card_name}), flush=True)

        # the loop's cost over the bare step: 63 timed steps, the epoch
        # boundary once, the save and the grid only at the end
        trainer, state, line = gan_run("gan_long", [
            *gan, "--synthetic", "512", "--epochs", "2",
            "--checkpoint-every-epochs", "3",
            "--checkpoint-dir", f"{d}/long", "--image-dir", f"{d}/long_img"],
            64, 1)
        rates = bare_windows(torch, trainer, state, bare_batch)
        median = statistics.median(rates)
        print(json.dumps({
            "phase": "loops", "step": "gan_long", **line,
            "bare_windows_steps_per_s": rates,
            "bare_median_steps_per_s": median,
            "bare_spread_pct": 100 * (max(rates) - min(rates)) / median,
            "loop_vs_bare_pct": 100 * (
                line["steps_per_s_without_saves"] / median - 1),
            "card": card_name}), flush=True)
    return total


def write_scene_corpus(directory: str) -> tuple:
    """The port's scene corpus (CAPTIONER_IMAGES, seed 0) as JPEGs in
    ``directory``; returns (paths, {factor: per-image ints})."""
    from PIL import Image

    from attngan_torch.data.synthetic import make_scene_dataset

    dataset, factors = make_scene_dataset(CAPTIONER_IMAGES, seed=0)
    paths = []
    for rec in dataset.records:
        path = os.path.join(directory, os.path.basename(rec.fpath))
        Image.fromarray(rec.pixels).save(path, quality=95)
        paths.append(path)
    return paths, factors


def decoders(paths, card_name: str) -> None:
    """Whether the native JPEG decoder built, and the corpus decoded by it
    and by Pillow: images/s each, their differences; which sample photos
    the host's packages bundle (none: the photo-patch corpus must raise)."""
    import numpy as np

    from attngan_torch.data import native_loader
    from attngan_torch.data.dataset import decode_image
    from attngan_torch.data.synthetic import (
        find_bundled_photos,
        make_photo_patch_dataset,
    )

    t = time.perf_counter()
    available = native_loader.available()
    line = {"phase": "captioner", "step": "decoders", "files": len(paths),
            "native_available": available,
            "native_build_error": native_loader.build_error(),
            "native_build_s": time.perf_counter() - t}
    photos = find_bundled_photos()
    line["bundled_photos"] = sorted(photos)
    if not photos:              # no scikit-learn or matplotlib sample data
        try:
            make_photo_patch_dataset(4)
        except RuntimeError as e:
            line["photo_patch_corpus"] = str(e)
        else:
            fail_unless(False, "photo patches made without bundled photos")
    t = time.perf_counter()
    pil = np.stack([decode_image(p) for p in paths])
    line["pil_img_per_s"] = len(paths) / (time.perf_counter() - t)
    if available:
        t = time.perf_counter()
        native, ok = native_loader.decode_batch(paths)
        line["native_img_per_s"] = len(paths) / (time.perf_counter() - t)
        fail_unless(bool(ok.all()), "native decode failed on the corpus")
        diff = np.abs(native.astype(np.int16) - pil.astype(np.int16))
        per_image = diff.reshape(len(paths), -1).mean(axis=1)
        line.update(max_abs_diff=int(diff.max()),
                    mean_abs_diff=float(diff.mean()),
                    worst_image_mean_abs_diff=float(per_image.max()))
        fail_unless(per_image.max() < NATIVE_MAD, f"native decode off Pillow "
                    f"by {per_image.max()} levels on average in an image")
    print(json.dumps({**line, "card": card_name}), flush=True)


def same_tree(xa, xb) -> dict:
    """Hold the complete-linkage cosine trees of two embeddings of one
    corpus to the same merges (as sets of leaves), their heights within
    HEIGHT_ATOL, merging in another order only where their heights lie
    within HEIGHT_ATOL of each other. Such a swap renumbers the labels of
    every cut above it (the numbering follows the merge order) and changes
    no partition. Returns the measured sizes."""
    import numpy as np
    from scipy.cluster import hierarchy

    def merges(z):
        n = z.shape[0] + 1
        members, out = {}, []
        for i, (a, b) in enumerate(z[:, :2].astype(int)):
            leaves = (members.get(a, frozenset([a]))
                      | members.get(b, frozenset([b])))
            members[n + i] = leaves
            out.append(leaves)
        return out

    za, zb = (hierarchy.linkage(x, "complete", "cosine") for x in (xa, xb))
    index_b = {leaves: i for i, leaves in enumerate(merges(zb))}
    missing = [leaves for leaves in merges(za) if leaves not in index_b]
    fail_unless(not missing, f"the card's tree has {len(missing)} merges "
                f"the CPU's has not")
    pos = np.array([index_b[leaves] for leaves in merges(za)])
    height_err = float(np.abs(za[:, 2] - zb[pos, 2]).max())
    h = za[:, 2]
    later_in_b = np.triu(pos[:, None] > pos[None, :], k=1)   # i < j in A
    gaps = (h[None, :] - h[:, None])[later_in_b]
    line = {"merge_height_max_abs_err": height_err,
            "merges_reordered": int(later_in_b.any(axis=1).sum()),
            "max_height_gap_reordered": float(gaps.max()) if gaps.size
            else 0.0,
            "min_height_gap": float(np.diff(h).min())}
    fail_unless(height_err <= HEIGHT_ATOL
                and line["max_height_gap_reordered"] <= HEIGHT_ATOL,
                f"card and CPU trees: {line}")
    return line


def captioner_phase(torch, card_name: str) -> dict:
    """Phase 8: the clustering captioner and the streaming loader on the
    scene corpus (see the module docstring). Returns {kernel name:
    launches over the phase's two CLI calls}."""
    import numpy as np

    from attngan_torch.cli import pretrain
    from attngan_torch.data.clusterer import (
        HierarchicalClusterer,
        adjusted_rand_index,
        cluster_ladder,
        determine_k_values,
        reduce_dimensionality,
    )
    from attngan_torch.data.dataset import preprocess_pyramid
    from attngan_torch.data.streaming import StreamingDataset

    counters = kernel_counters()
    total = {}
    with tempfile.TemporaryDirectory() as d:
        corpus = os.path.join(d, "scenes")
        os.makedirs(corpus)
        t = time.perf_counter()
        paths, factors = write_scene_corpus(corpus)
        write_s = time.perf_counter() - t
        decoders(paths, card_name)

        # the embedder: card against CPU, and its rate on the card
        dataset = StreamingDataset(corpus)
        n = len(dataset)
        fail_unless(n == 2 * CAPTIONER_IMAGES, f"{n} records")
        card = HierarchicalClusterer(device="cuda")
        t = time.perf_counter()
        emb = {"cuda": card.embed_dataset(dataset)}
        embed_dataset_s = time.perf_counter() - t
        t = time.perf_counter()
        emb["cpu"] = HierarchicalClusterer(device="cpu").embed_dataset(dataset)
        cpu_s = time.perf_counter() - t
        err = np.abs(emb["cuda"] - emb["cpu"])
        fail_unless(err[:EMBED_CHECK].max() <= EMBED_ATOL,
                    f"embeddings: card vs CPU {err[:EMBED_CHECK].max()}")
        pixels = torch.as_tensor(dataset._batch_pixels(dataset.records),
                                 device="cuda")
        flip = torch.as_tensor([r.flip for r in dataset.records],
                               device="cuda")
        images = preprocess_pyramid(pixels, flip)[256]
        card.embedder.embed(images[:64], 32)           # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        card.embedder.embed(images, 32)
        embed_s = time.perf_counter() - t
        del pixels, images
        print(json.dumps({
            "phase": "captioner", "step": "embedder", "records": n,
            "max_abs_err_first_64": float(err[:EMBED_CHECK].max()),
            "max_abs_err_all": float(err.max()),
            "feature_abs_max": float(np.abs(emb["cpu"]).max()),
            "img_per_s": n / embed_s, "embed_dataset_s": embed_dataset_s,
            "cpu_embed_dataset_s": cpu_s, "write_jpegs_s": write_s,
            "card": card_name}), flush=True)

        # the clusterer on both embeddings: one tree, the same partitions
        ks = determine_k_values(1000, 5)
        t = time.perf_counter()
        reduced = {dev: reduce_dimensionality(e, 128, "auto")
                   for dev, e in emb.items()}
        labels = {dev: cluster_ladder(x, ks, "agglomerative_complete")
                  for dev, x in reduced.items()}
        cluster_s = (time.perf_counter() - t) / 2
        tree = same_tree(reduced["cuda"], reduced["cpu"])
        split = [k for k, a, b in zip(ks, labels["cuda"], labels["cpu"])
                 if adjusted_rand_index(a, b) != 1.0]
        fail_unless(not split, f"card and CPU partitions differ at k {split}")
        renumbered = [k for k, a, b in zip(ks, labels["cuda"], labels["cpu"])
                      if not np.array_equal(a, b)]
        ari = {k: {name: adjusted_rand_index(lab, np.repeat(f, 2))
                   for name, f in factors.items()}
               for k, lab in zip(ks, labels["cuda"])}
        print(json.dumps({"phase": "captioner", "step": "clusterer",
                          "ks": ks, "partitions_equal_cpu": True,
                          "labels_equal_cpu": not renumbered,
                          "renumbered_at_k": renumbered, **tree,
                          "clusters": [int(lab.max()) + 1
                                       for lab in labels["cuda"]],
                          "ari": ari, "seconds": cluster_s,
                          "card": card_name}), flush=True)

        def run(step: str, argv: list):
            (_, state, history), counts, line = probe.run(
                counters, lambda: pretrain.main(argv))
            want = {name: 0 for name in counters}
            want.update(damsm_similarity=16, damsm_similarity_bwd_square=32)
            fail_unless(state.step == 16, f"{step}: {state.step} steps")
            fail_unless(counts == want, f"{step}: launches {counts}, "
                        f"expected {want}")
            fail_unless(all(map(math.isfinite, history))
                        and len(set(history)) > 1, f"{step}: loss {history}")
            for name, k in counts.items():
                total[name] = total.get(name, 0) + k
            print(json.dumps({"phase": "captioner", "step": step,
                              "steps": state.step, **line,
                              "losses": history, "card": card_name}),
                  flush=True)
            return history

        caps = os.path.join(d, "caps.json")
        common = ["--data-root", corpus, "--epochs", "1", "--batch-size",
                  "64", "--captions-path", caps,
                  "--image-dir", os.path.join(d, "img")]
        with LoopProbe(torch) as probe:
            run("cli_cluster_stream", [*common, "--stream", "--cluster",
                                       "--checkpoint-dir",
                                       os.path.join(d, "ckpt_cluster")])
            with open(caps) as f:
                mapping = json.load(f)
            fail_unless(sorted(mapping) == sorted(r.fpath
                                                  for r in dataset.records),
                        f"captions JSON: {len(mapping)} records")
            finest = sorted({c[-1] for c, _ in mapping.values()})
            for fpath, (caption, class_id) in mapping.items():
                fail_unless([tok.split("c")[0] for tok in caption]
                            == [f"k{k}" for k in ks]
                            and class_id == finest.index(caption[-1]),
                            f"captions JSON: {fpath} {caption} {class_id}")
            same = all(mapping[r.fpath][0] == [f"k{k}c{lab[i]}" for k, lab
                                               in zip(ks, labels["cuda"])]
                       for i, r in enumerate(dataset.records))
            print(json.dumps({"phase": "captioner", "step": "captions_json",
                              "records": len(mapping), "tokens": len(ks),
                              "classes": len(finest),
                              "equal_to_the_embedder_check": same,
                              "card": card_name}), flush=True)
            # the same epoch streamed, then eagerly decoded up front: the
            # loop's cost of decoding in its prefetch thread (the same
            # pixels either way: the 256^2 JPEGs take no resize)
            streamed = run("cli_stream_from_json", [
                *common, "--stream", "--checkpoint-dir",
                os.path.join(d, "ckpt_stream")])
            eager = run("cli_eager_from_json", [
                *common, "--checkpoint-dir", os.path.join(d, "ckpt_eager")])
            fail_unless(streamed == eager, "streamed and eager epochs differ: "
                        f"{streamed} vs {eager}")
    return total


def write_pretrained_trunk(torch, path: str) -> dict:
    """A seeded Inception-v3 trunk (He-initialised convs, BN weights,
    biases and running statistics drawn away from 1 and 0, so that a
    misplaced entry shows) saved at ``path`` as a torchvision state_dict:
    with every BN's ``num_batches_tracked``, ``AuxLogits.*`` and ``fc.*``.
    Returns the trunk's own state_dict (the port's keys)."""
    from attngan_torch.models.cnn_encoder import InceptionV3Trunk

    gen = torch.Generator().manual_seed(11)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        trunk = InceptionV3Trunk().state_dict()
    draws = {"running_mean": lambda v: v.normal_(0, 0.1, generator=gen),
             "running_var": lambda v: v.uniform_(0.5, 1.5, generator=gen),
             "bn.weight": lambda v: v.uniform_(0.5, 1.5, generator=gen),
             "bn.bias": lambda v: v.normal_(0, 0.1, generator=gen)}
    torchvision = {}
    for key, value in trunk.items():
        for suffix, draw in draws.items():
            if key.endswith(suffix):
                draw(value)
        torchvision[key] = value
        if key.endswith("bn.running_var"):
            torchvision[key.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(0)
    torchvision.update({"AuxLogits.conv0.conv.weight": torch.zeros(128, 768,
                                                                   1, 1),
                        "fc.weight": torch.zeros(1000, 2048),
                        "fc.bias": torch.zeros(1000)})
    torch.save(torchvision, path)
    return {k: v.clone() for k, v in trunk.items()}


def options_throughput(torch, trunk: dict, card_name: str) -> None:
    """The bf16 trunk's features of the 4 batches at 256 rows (the
    superbatch's forward) against those at 64 (max difference, share of
    elements that differ); then steps/s at batch 64 (vocabulary 1000, 8
    words) of the four step forms in turns, 6 rounds of a 12-step window
    each, their inputs on the card: plain, cached (the features of the
    same batches in fp16),
    superbatch (K = 4: 3 calls a window) on one state, and train-mode
    trunk BN on its own state from the same seed (its steps move the
    statistics, after which the others would refold their trunk)."""
    import numpy as np

    from attngan_torch.core.config import DamsmConfig, replace
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    k = 4
    rng = np.random.default_rng(9)
    batches = [damsm_batch(torch, rng, DAMSM_BATCH) for _ in range(k)]
    cfg = DamsmConfig(batch_size=DAMSM_BATCH)
    plain = DamsmTrainer(cfg, VOCAB, DAMSM_SEQ)
    sup = DamsmTrainer(replace(cfg, superbatch=k), VOCAB, DAMSM_SEQ)
    bn = DamsmTrainer(replace(cfg, trunk_train_mode_bn=True), VOCAB,
                      DAMSM_SEQ)
    state = plain.init_state(seed=0, pretrained_cnn=trunk)
    bn_state = bn.init_state(seed=0, pretrained_cnn=trunk)
    cached = []
    for batch in batches:
        regions, pooled = plain._eval_trunk_forward(state, batch["img256"])
        cached.append({**batch, "trunk_regions": regions.half(),
                       "trunk_pooled": pooled.half()})
    superbatch = {key: torch.cat([b[key] for b in batches])
                  for key in batches[0]}
    # what the superbatch's trunk reads: its features of 256 rows against
    # the same images' at 64
    big = plain._eval_trunk_forward(state, superbatch["img256"])
    small = [torch.cat(f) for f in zip(*[
        plain._eval_trunk_forward(state, b["img256"]) for b in batches])]
    line = {}
    for key, big, small in zip(("regions", "pooled"), big, small):
        line[key] = {"max_abs_diff": float((big - small).abs().max()),
                     "share_differing": float((big != small).float().mean()),
                     "abs_max": float(small.abs().max())}
    print(json.dumps({"phase": "pretrain_options", "step":
                      "superbatch_features_256_vs_64_rows", **line,
                      "card": card_name}), flush=True)
    window = 12
    paths = (
        ("plain", lambda: [plain.train_step(state, batches[i % k])
                           for i in range(window)]),
        ("cached", lambda: [plain.train_step_cached(state, cached[i % k])
                            for i in range(window)]),
        ("superbatch_4", lambda: [sup.train_step_super(state, superbatch)
                                  for _ in range(window // k)]),
        ("train_mode_bn", lambda: [bn.train_step(bn_state, batches[i % k])
                                   for i in range(window)]))
    for _, fn in paths:
        fn()
    torch.cuda.synchronize()
    rates = {label: [] for label, _ in paths}
    for round_ in range(6):
        for label, fn in paths[round_ % 4:] + paths[:round_ % 4]:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates[label].append(window / (time.perf_counter() - start))
    for label, windows in rates.items():
        median = statistics.median(windows)
        print(json.dumps({
            "phase": "pretrain_options", "step": "throughput",
            "path": label, "batch": DAMSM_BATCH, "steps_per_s": median,
            "windows": windows,
            "spread_pct": 100 * (max(windows) - min(windows)) / median,
            "card": card_name}), flush=True)
    if "--profile" in sys.argv[1:]:
        for label, fn in paths:
            stats = profile_calls(torch, fn, calls=1)
            print(json.dumps({"phase": "profile", "path": label,
                              "batch": DAMSM_BATCH, "steps_per_call": window,
                              **stats, "card": card_name}), flush=True)


def attention_maps(torch, trunk: dict, dataset, folder: str,
                   card_name: str) -> None:
    """iter_attention_maps over the dataset at full width (bf16 trunk,
    batch 64): maps/s, each real word's map summing to 1; the first batch
    in fp32 at batch 4 against the CPU's; populate_attention_maps' PNGs
    read back."""
    import numpy as np

    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.train.damsm_trainer import DamsmTrainer
    from attngan_torch.utils.imaging import read_png

    dataset.build_vocab()
    vocab, seq = dataset.vocab.n_words, dataset.max_seqlen
    trainer = DamsmTrainer(DamsmConfig(), vocab, seq)
    state = trainer.init_state(seed=0, pretrained_cnn=trunk)
    list(trainer.iter_attention_maps(state, dataset, DAMSM_BATCH,
                                     limit=DAMSM_BATCH))
    torch.cuda.synchronize()
    t = time.perf_counter()
    maps = list(trainer.iter_attention_maps(state, dataset, DAMSM_BATCH))
    seconds = time.perf_counter() - t
    n = len(dataset.records) // DAMSM_BATCH * DAMSM_BATCH
    fail_unless(len(maps) == n, f"attention maps: {len(maps)} of {n}")
    fail_unless(all(m.shape == (seq, 17, 17) and m.dtype == np.float32
                    for m in maps), f"attention maps: {maps[0].shape}")
    sums = np.stack([m.sum(axis=(1, 2)) for m in maps])
    real = np.array([[i < len(r.caption) for i in range(seq)]
                     for r in dataset.records[:n]])
    sum_err = float(np.abs(sums[real] - 1.0).max())
    fail_unless(sum_err <= MAP_SUM_ATOL, f"attention maps sum to 1 +- "
                f"{sum_err}")
    fp32 = {}
    for dev in ("cuda", "cpu"):
        t32 = DamsmTrainer(DamsmConfig(compute_dtype=""), vocab, seq,
                           device=dev)
        s32 = t32.init_state(seed=0, pretrained_cnn=trunk)
        fp32[dev] = np.stack(list(t32.iter_attention_maps(
            s32, dataset, batch_size=4, limit=4)))
    cpu_err = float(np.abs(fp32["cuda"] - fp32["cpu"]).max())
    fail_unless(cpu_err <= MAP_CPU_ATOL, f"attention maps: card vs CPU "
                f"{cpu_err}")
    written = trainer.populate_attention_maps(state, dataset, folder,
                                              DAMSM_BATCH, limit=8)
    pngs = sorted(os.listdir(folder))
    fail_unless(written == 8 and pngs == [f"attn_{i:06d}.png"
                                          for i in range(8)],
                f"populate_attention_maps wrote {pngs}")
    for name in pngs:
        shape = read_png(os.path.join(folder, name)).shape
        fail_unless(shape == (17, 17 * seq, 3), f"{name}: {shape}")
    print(json.dumps({
        "phase": "pretrain_options", "step": "attention_maps", "maps": n,
        "words": seq, "seconds": seconds, "maps_per_s": n / seconds,
        "max_sum_err": sum_err, "fp32_vs_cpu_max_abs_err": cpu_err,
        "pngs": written, "card": card_name}), flush=True)


def options_data(base):
    """A dataset over ``base``'s images (its pixel arrays, new records) with
    captions of 3 to 8 words drawn from 999 words, each of them used (a
    vocabulary of VOCAB with UNK), and OPTIONS_CLASSES classes: the data of
    phase 9's comparison runs, made anew for each run."""
    import numpy as np

    from attngan_torch.data.dataset import Dataset, Record

    rng = np.random.default_rng(OPTIONS_SEED)
    n = len(base.records)
    lengths = rng.integers(3, DAMSM_SEQ + 1, n)
    lengths[0] = DAMSM_SEQ
    words = np.concatenate([np.arange(VOCAB - 1), rng.integers(
        0, VOCAB - 1, int(lengths.sum()) - (VOCAB - 1))])
    rng.shuffle(words)
    captions = np.split(words, np.cumsum(lengths)[:-1])
    return Dataset(records=[
        Record(r.fpath, r.pixels, flip=r.flip,
               caption=[f"w{w}" for w in caption],
               class_id=i % OPTIONS_CLASSES)
        for i, (r, caption) in enumerate(zip(base.records, captions))])


def step_kernels_vs_plain(torch, dataset, label: str, trunk: dict,
                          counters: dict, card_name: str) -> None:
    """K4 and K5 at the shapes ``dataset`` gives them on the pretrain path:
    one fp32 step (TF32 off) at batch 64 on its first batch as the loop
    draws it, with the kernels and with the plain words loss
    (``fused_similarity=False``), each on a state from the same seed and
    trunk; the metrics held to SIMS_TOL and every trainable gradient to
    GRAD_RTOL plus GRAD_ATOL_SHARE of its largest entry (phase 2's
    tolerances). Comparison launches: they count in no path's total."""
    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.data.dataset import Dataset
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    dataset.build_vocab()
    seq = dataset.max_seqlen
    host = next(dataset.iter_batches(DAMSM_BATCH, seq, seed=1))
    batch = Dataset.device_batch(host, "cuda")
    runs = {}
    for fused in (True, False):
        trainer = DamsmTrainer(DamsmConfig(compute_dtype="",
                                           fused_similarity=fused),
                               dataset.vocab.n_words, seq)
        state = trainer.init_state(seed=0, pretrained_cnn=trunk)
        before = {name: c.launches for name, c in counters.items()}
        _, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        runs[fused] = ({k: float(v) for k, v in m.items()},
                       [(name, p.grad.clone()) for name, p in
                        state.trainable()],
                       {name: c.launches - before[name]
                        for name, c in counters.items()})
    want = {name: 0 for name in counters}
    fail_unless(runs[False][2] == want, f"{label}: the plain step launched "
                f"{runs[False][2]}")
    want.update(damsm_similarity=1, damsm_similarity_bwd_square=2)
    fail_unless(runs[True][2] == want, f"{label}: the kernels' step launched "
                f"{runs[True][2]}, expected {want}")
    got, ref = runs[True][0], runs[False][0]
    metric_err = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ref)
    for k in ref:
        torch.testing.assert_close(
            torch.tensor(got[k]), torch.tensor(ref[k]), **SIMS_TOL,
            msg=lambda msg: f"{label}: {k} with the kernels: {msg}")
    grad_err = 0.0
    for (name, a), (_, b) in zip(runs[True][1], runs[False][1]):
        scale = float(b.abs().max())
        grad_err = max(grad_err, float((a - b).abs().max()) / scale)
        torch.testing.assert_close(
            a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale,
            msg=lambda msg: f"{label}: {name}'s gradient with the kernels: "
            f"{msg}")
    lengths = host["lengths"]
    print(json.dumps({
        "phase": "pretrain_options", "step": "kernels_vs_plain_step",
        "data": label, "batch": DAMSM_BATCH, "words": seq,
        "real_word_share": float(lengths.sum() / (len(lengths) * seq)),
        "classes_in_batch": len(set(host["class_ids"].tolist())),
        "metrics": got, "max_rel_metric_err": metric_err,
        "max_grad_err_over_max": grad_err, "card": card_name}), flush=True)


def pretrain_options_phase(torch, card_name: str) -> dict:
    """Phase 9: the pretrain options at full width over 512 synthetic
    images (see the module docstring). Returns {kernel name: launches over
    the phase's training runs}."""
    import numpy as np

    from attngan_torch.cli import pretrain
    from attngan_torch.cli.train import load_damsm_encoders
    from attngan_torch.convert import load_pretrained_trunk
    from attngan_torch.core.config import DamsmConfig, GanConfig, RunConfig
    from attngan_torch.data import synthetic
    from attngan_torch.train import loops
    from attngan_torch.train.checkpoint import (
        diff_parts,
        latest_checkpoint,
        load_part,
    )
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    counters = kernel_counters()
    total = {}
    # the CLI's own synthetic data, whose images the comparison runs share
    base = synthetic.make_synthetic_dataset(OPTIONS_IMAGES)
    precompute = DamsmTrainer.precompute_trunk_features
    caches = []

    def timed_precompute(self, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache = precompute(self, *args, **kw)
        caches.append((time.perf_counter() - t, cache))
        return cache

    DamsmTrainer.precompute_trunk_features = timed_precompute
    try:
        with tempfile.TemporaryDirectory() as d, LoopProbe(torch) as probe:
            pth = os.path.join(d, "inception_v3.pth")
            trunk = write_pretrained_trunk(torch, pth)
            step_kernels_vs_plain(torch, base, "cli_synthetic", trunk,
                                  counters, card_name)
            step_kernels_vs_plain(torch, options_data(base), "options",
                                  trunk, counters, card_name)

            def count(step: str, fn, steps: int, extra=None):
                (_, state, history), counts, line = probe.run(counters, fn)
                want = {name: 0 for name in counters}
                want.update(damsm_similarity=steps,
                            damsm_similarity_bwd_square=2 * steps)
                fail_unless(state.step == len(history) == steps,
                            f"{step}: {state.step} steps")
                fail_unless(counts == want, f"{step}: launches {counts}, "
                            f"expected {want}")
                fail_unless(all(map(math.isfinite, history))
                            and len(set(history)) > 1,
                            f"{step}: loss {history}")
                for name, n in counts.items():
                    total[name] = total.get(name, 0) + n
                print(json.dumps({"phase": "pretrain_options", "step": step,
                                  "steps": state.step, **line,
                                  **(extra(state, history) if extra else {}),
                                  "losses": history, "card": card_name}),
                      flush=True)
                return state, history

            def train(step: str, extra=None, **flags):
                """2 epochs of run_damsm_training over options_data from
                the .pth's trunk (what cli.pretrain --pretrained-cnn
                calls), at DamsmConfig's defaults and ``flags``."""
                cfg = DamsmConfig(batch_size=DAMSM_BATCH, epochs=2, **flags)
                run_cfg = RunConfig(checkpoint_dir=os.path.join(d, step),
                                    image_dir=os.path.join(d, "img"))
                return count(step, lambda: loops.run_damsm_training(
                    cfg, run_cfg, options_data(base),
                    pretrained_cnn=load_pretrained_trunk(pth)), steps, extra)

            steps = 2 * OPTIONS_IMAGES // DAMSM_BATCH

            def pretrained(state, _):
                got = state.cnn.trunk.state_dict()
                differ = [k for k in trunk if not torch.equal(got[k].cpu(),
                                                              trunk[k])]
                fail_unless(set(got) == set(trunk) and not differ,
                            f"--pretrained-cnn: the trunk differs at "
                            f"{differ[:5]}")
                return {"trunk_equals_file": True, "trunk_tensors": len(got)}

            _, plain = train("plain", pretrained)

            def rel(a, b):
                return max(abs(x - y) / abs(y) for x, y in zip(a, b))

            def cache_line(_, history):
                seconds, cache = caches[-1]
                fail_unless(cache["regions"].shape == (
                    OPTIONS_IMAGES, DAMSM_REGIONS, 768)
                    and cache["pooled"].shape == (OPTIONS_IMAGES, 2048)
                    and cache["regions"].dtype == np.float16,
                    f"cache {cache['regions'].shape}")
                fail_unless(all(np.isfinite(v).all()
                                for v in cache.values()), "cache not finite")
                err = rel(history, plain)
                fail_unless(err <= CACHED_RTOL, f"cached losses: {err} "
                            "relative off the plain run's")
                return {"precompute_s": seconds, "cache_mb": sum(
                            v.nbytes for v in cache.values()) / 2 ** 20,
                        "cache_abs_max": float(np.abs(
                            cache["regions"]).max()),
                        "max_rel_loss_vs_plain": err}

            train("cached", cache_line, cache_region_features=True)
            fail_unless(len(caches) == 1, f"{len(caches)} precomputes")
            _, plain32 = train("plain_fp32", compute_dtype="")

            # all 16 steps against the plain run's, and no further off it
            # than the plain run is off the fp32 one (bf16's own drift)
            def super_line(_, history):
                first = rel(history[:4], plain[:4])
                drift, own = rel(history, plain), rel(plain, plain32)
                fail_unless(drift <= min(SUPER_RTOL, own), f"superbatch "
                            f"losses: {drift} relative off the plain run's "
                            f"over 16 steps; the limit is {SUPER_RTOL} and "
                            f"bf16's own drift {own} (plain bf16 against "
                            "plain fp32)")
                return {"max_rel_loss_vs_plain_first_call": first,
                        "max_rel_loss_vs_plain": drift,
                        "plain_bf16_vs_fp32_max_rel": own}

            train("superbatch_4", super_line, superbatch=4)

            def super32_line(_, history):
                err = rel(history, plain32)
                fail_unless(err <= SUPER_RTOL, f"fp32 superbatch losses: "
                            f"{err} relative off the plain run's")
                return {"max_rel_loss_vs_plain": err}

            train("superbatch_4_fp32", super32_line, compute_dtype="",
                  superbatch=4)

            # the entry point itself, on its own synthetic data
            def bn_line(state, _):
                got = {k: v.cpu() for k, v in
                       state.cnn.trunk.state_dict().items()}
                stats = [k for k in got if "running" in k]
                still = [k for k in stats if torch.equal(got[k], trunk[k])]
                fail_unless(stats and not still, f"train-mode BN: {still[:5]}"
                            " did not move")
                differ = [k for k in got if k not in stats
                          and not torch.equal(got[k], trunk[k])]
                fail_unless(set(got) == set(trunk) and not differ,
                            f"--pretrained-cnn: the trunk differs at "
                            f"{differ[:5]}")
                ckpt = latest_checkpoint(os.path.join(d, "bn", "damsm"))
                saved = diff_parts(state.cnn.state_dict(),
                                   load_part(ckpt, "cnn"))
                fail_unless(not saved, f"cnn.pt differs at {saved[:5]}")
                _, cnn = load_damsm_encoders(
                    os.path.join(d, "bn", "damsm"), GanConfig(),
                    state.rnn.embedding.weight.shape[0], SEQ_LEN)
                read = diff_parts(cnn.state_dict(), state.cnn.state_dict())
                fail_unless(not read, "load_damsm_encoders differs at "
                            f"{read[:5]}")
                moved = max(float((got[k] - trunk[k]).abs().max())
                            for k in stats)
                return {"statistics": len(stats), "all_moved": True,
                        "max_stat_move": moved,
                        "other_trunk_tensors_equal_file": len(got)
                        - len(stats), "cnn_pt_equal": True,
                        "damsm_checkpoint_reads_them": True}

            count("bn_cli", lambda: pretrain.main([
                "--synthetic", str(OPTIONS_IMAGES), "--batch-size",
                str(DAMSM_BATCH), "--epochs", "1", "--trunk-train-mode-bn",
                "--pretrained-cnn", pth, "--captions-path",
                os.path.join(d, "caps.json"), "--image-dir",
                os.path.join(d, "img"), "--checkpoint-dir",
                os.path.join(d, "bn")]), steps // 2, bn_line)
            attention_maps(torch, trunk, options_data(base),
                           os.path.join(d, "maps"), card_name)
            options_throughput(torch, trunk, card_name)
    finally:
        DamsmTrainer.precompute_trunk_features = precompute
    return total


# ------------------------------------------------- phase 10: data parallel

DP_RANKS = 2
DP_LOSS_BATCH = DAMSM_BATCH   # K4 / K6 at 32 x 64 on each rank
DP_PRETRAIN = ["--synthetic", "128", "--batch-size", "64", "--epochs", "1"]
# one step an epoch, so that the first step's state is saved on its own
DP_GAN = ["--synthetic", "16", "--batch-size", "16", "--epochs", "2"]
DP_STEPS = 2                  # each of the two training calls


def dp_loss_inputs(torch, batch: int, seq: int) -> tuple:
    """The sharded loss's global inputs at full width, the same on every
    rank (a CPU generator), on the card: img (B, 289, 256), cnn_code,
    words (B, seq, 256), sent, mask (lengths 1..seq), class ids."""
    gen = torch.Generator().manual_seed(13 + seq)
    lengths = torch.randint(1, seq + 1, (batch,), generator=gen)
    mask = (torch.arange(seq)[None] < lengths[:, None]).to(torch.int32)
    shapes = ((batch, DAMSM_REGIONS, DAMSM_DIM), (batch, DAMSM_DIM),
              (batch, seq, DAMSM_DIM), (batch, DAMSM_DIM))
    img, code, words, sent = (torch.randn(s, generator=gen) for s in shapes)
    class_ids = torch.randint(0, batch // 2, (batch,), generator=gen)
    return tuple(t.cuda() for t in (img, code, words, sent, mask, class_ids))


DP_LOSS_CASES = (("pretrain", DP_LOSS_BATCH, DAMSM_SEQ),
                 ("gan_coupling", 16, SEQ_LEN))


def dp_loss(torch, mesh, inputs) -> dict:
    """The DAMSM loss of ``inputs`` and its gradients in img, code, words
    and sent: sharded over ``mesh`` (this rank's rows, K4 on its images x
    all texts, K6 in the backward), or in one process with ``mesh`` None
    (K4 and K5 square)."""
    from attngan_torch.losses.damsm import damsm_loss
    from attngan_torch.losses.damsm_sharded import make_sharded_damsm_loss
    from attngan_torch.parallel.mesh import shard_rows

    img, code, words, sent, mask, class_ids = (shard_rows(t, mesh)
                                               for t in inputs)
    diff = [t.clone().requires_grad_() for t in (img, code, words, sent)]
    b = img.shape[0]
    first = 0 if mesh is None else mesh.rank * b
    labels = torch.arange(first, first + b, device="cuda")
    args = (diff[0], diff[1], diff[2], diff[3], labels, mask, class_ids)
    if mesh is None:
        total = damsm_loss(*args, fused=True, attention_maps=False)[0]
    else:
        total = make_sharded_damsm_loss(mesh)(*args)[0]
    total.backward()
    torch.cuda.synchronize()
    return {"total": total.detach().cpu(),
            **{k: t.grad.cpu() for k, t in zip(("img", "code", "words",
                                                 "sent"), diff)}}


def rank_main(job: str, out: str, argv: list) -> int:
    """One rank of a ``torchrun`` launch (``chip_smoke.py --rank JOB OUT
    ARGS``): the sharded loss (``loss``) or a CLI's ``main(ARGS)`` in fp32
    with TF32 off, its launch counts read around it; writes OUT/rank{r}.pt
    ({launches, seconds, and the loss's values or the CLI's result: the
    trained state's parts and history, or the benchmark line})."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from attngan_torch.train.checkpoint import state_parts

    counters = kernel_counters()
    record = {}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, {n: c.launches for n, c in counters.items()}, \
            time.perf_counter() - t0

    if job == "loss":
        from attngan_torch.parallel.mesh import launched, make_mesh

        with launched() as device:
            for label, batch, seq in DP_LOSS_CASES:
                mesh = make_mesh(batch, (DP_RANKS,), device)
                inputs = dp_loss_inputs(torch, batch, seq)
                record[label] = counted(lambda: dp_loss(torch, mesh, inputs))
    else:
        cli = importlib.import_module(f"attngan_torch.cli.{job}")
        result, launches, seconds = counted(lambda: cli.main(argv))
        if job == "infer":
            record["result"] = result
        else:
            _, state, history = result
            record["result"] = {"parts": state_parts(state),
                                "history": history}
        record["launches"], record["seconds"] = launches, seconds
    torch.save(record, os.path.join(out, f"rank{os.environ['RANK']}.pt"))
    return 0


def torchrun(job: str, out: str, argv: list, ranks: int = DP_RANKS) -> tuple:
    """Run ``job`` under ``torchrun --standalone --nproc-per-node ranks``;
    returns (each rank's record, rank 0's standard output)."""
    import torch

    os.makedirs(out, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), os.path.abspath(__file__),
         "--rank", job, out, *argv],
        capture_output=True, text=True, timeout=600)
    fail_unless(proc.returncode == 0,
                f"torchrun {job}: exit {proc.returncode}\n"
                f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(ranks)], proc.stdout


def norm_rel(a, b) -> float:
    """||a - b|| / ||b||, fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def worst_rel(a, b, where: str = "") -> tuple:
    """(largest ``norm_rel`` over the float tensors of two saved states,
    where); second moments at their gradient's scale (square roots)."""
    import torch

    if isinstance(a, torch.Tensor):
        if not a.is_floating_point() or a.numel() == 0:
            return 0.0, where
        if where.endswith("exp_avg_sq"):
            a, b = a.sqrt(), b.sqrt()
        return norm_rel(a, b), where
    pairs = (a.items() if isinstance(a, dict) else
             enumerate(a) if isinstance(a, (list, tuple)) else [])
    worst = (0.0, where)
    for k, v in pairs:
        worst = max(worst, worst_rel(v, b[k], f"{where}.{k}"))
    return worst


def gan_held(parts: dict) -> dict:
    """What a GAN state check holds across devices (gan_fp32_vs_cpu's
    rule): the gradients, as the four Adams' moments, the BN statistics and
    the frozen encoders; not the updated weights, which Adam moves by about
    +-lr whatever their gradient's size, the sign deciding where the
    gradient lies within rounding of 0."""
    out = {k: v for k, v in parts.items() if k not in ("gen", "discs")}
    for k in ("gen", "discs"):
        out[k] = {n: t for n, t in parts[k].items() if "running_" in n}
    return out


# K4 / K6 checked and timed at each rank's shapes: the sharded loss's two
# cases and cli.pretrain's synthetic captions (two words)
DP_KERNEL_CASES = DP_LOSS_CASES + (("cli_pretrain", DP_LOSS_BATCH, 2),)


def time_sharded_kernels(torch, card_name: str) -> dict:
    """K4 and K6 at the shapes each rank gives them (32 x 64 at 8 words,
    8 x 16 at 5, 32 x 64 at 2), against their plain versions at SIMS_TOL
    and GRAD_RTOL plus GRAD_ATOL_SHARE of the largest entry, and timed
    beside them with their bounds (phase 2's rules, ``tc_bound_ms`` too).
    Returns {label: {kernel: line}}."""
    from attngan_torch.ops.cuda_damsm import (
        damsm_similarity,
        damsm_similarity_bwd_tiled,
    )
    from attngan_torch.ops.damsm_similarity import (
        similarity_bwd_plain,
        similarity_plain,
    )

    gen = torch.Generator("cuda").manual_seed(17)
    out = {}
    for label, batch, seq in DP_KERNEL_CASES:
        bi, bt = batch // DP_RANKS, batch
        img, words, mask, g = damsm_inputs(torch, gen, bi, bt, seq=seq)
        pair_flops = 2 * seq * DAMSM_DIM * DAMSM_REGIONS
        grads = damsm_similarity_bwd_tiled(img, words, mask, g)
        sims = damsm_similarity(img, words, mask)
        want = similarity_plain(img, words, mask)
        want_grads = similarity_bwd_plain(img, words, mask, g)
        torch.testing.assert_close(
            sims, want, **SIMS_TOL,
            msg=lambda m: f"damsm_similarity {label}: {m}")
        for got, ref in zip(grads, want_grads):
            torch.testing.assert_close(
                got, ref, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_SHARE * float(ref.abs().max()),
                msg=lambda m: f"damsm_similarity_bwd_tiled {label}: {m}")
        cases = {
            "damsm_similarity": (
                lambda: damsm_similarity(img, words, mask),
                lambda: similarity_plain(img, words, mask),
                nbytes(img, words, mask, sims), 2 * pair_flops * bi * bt,
                float((sims - want).abs().max())),
            "damsm_similarity_bwd_tiled": (
                lambda: damsm_similarity_bwd_tiled(img, words, mask, g),
                lambda: similarity_bwd_plain(img, words, mask, g),
                nbytes(img, words, mask, g, *grads),
                6 * pair_flops * bi * bt,
                max(float((a - b).abs().max())
                    for a, b in zip(grads, want_grads)))}
        out[label] = {}
        for name, (fn, plain, moved, flops, err) in cases.items():
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / FP32_FLOPS_PER_S * 1e3
            line = {"phase": "data_parallel", "step": "kernel_check",
                    "kernel": name, "shape": label, "bi": bi, "bt": bt,
                    "words": seq, "max_abs_err": err, "ms": time_ms(fn),
                    "plain_ms": time_ms(plain),
                    "bound_ms": max(bytes_ms, flops_ms),
                    "bound_by": "bytes" if bytes_ms >= flops_ms
                    else "operations",
                    "tc_bound_ms": max(
                        bytes_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3),
                    "card": card_name}
            out[label][name] = line
            print(json.dumps(line), flush=True)
    return out


def second_step(torch, root: str, args: list, ranks_parts: dict,
                one_state, expect) -> dict:
    """The GAN's second step under the mesh, held from one state: one
    process resumes the ranks' first save (``root``/ranks) and takes the
    second step (``args``: the one-process cli.train call), whose state
    (``gan_held``) must lie within GAN_GRAD_RTOL of the ranks' second
    (``ranks_parts``), as their first steps do; ``expect(what, counts)``
    checks its launches (one step and an epoch's grid). Beside it, read
    only: the ranks' second step against the one-process chain's
    (``one_state``), each from its own first step, and a witness of one
    process against itself: the same chain with cuDNN's deterministic
    algorithms and with its autotuned ones, their first and second
    steps."""
    from attngan_torch.cli import train
    from attngan_torch.train.checkpoint import load_part, state_parts

    counters = kernel_counters()
    again = f"{root}/again/gan"
    shutil.copytree(f"{root}/ranks/ckpt/gan/step_00000001",
                    f"{again}/step_00000001")
    shutil.copy(f"{root}/ranks/ckpt/gan/config.json", again)
    with open(f"{again}/progress.json", "w") as f:
        json.dump({"epoch": 1, "step": 1}, f)
    for c in counters.values():
        c.launches = 0
    _, resumed, _ = train.main(args + [
        "--checkpoint-dir", f"{root}/again", "--image-dir",
        f"{root}/again_img", "--resume"])
    torch.cuda.synchronize()
    expect("train: the second step resumed in one process",
           {n: c.launches for n, c in counters.items()})
    worst, where = worst_rel(gan_held(ranks_parts),
                             gan_held(state_parts(resumed)))
    fail_unless(worst <= GAN_GRAD_RTOL, f"train: the ranks' second step "
                f"{where} {worst} from one process's from the same state")
    out = {"step2_from_one_state_worst_rel": [worst, where],
           "step2_worst_rel": worst_rel(gan_held(ranks_parts),
                                        gan_held(state_parts(one_state)))}
    one_first = {name: load_part(f"{root}/one/ckpt/gan/step_00000001", name)
                 for name in state_parts(one_state)}
    for flag in ("deterministic", "benchmark"):
        setattr(torch.backends.cudnn, flag, True)
        try:
            _, state, _ = train.main(args + [
                "--checkpoint-dir", f"{root}/{flag}", "--image-dir",
                f"{root}/{flag}_img"])
        finally:
            setattr(torch.backends.cudnn, flag, False)
        first = {name: load_part(f"{root}/{flag}/gan/step_00000001", name)
                 for name in one_first}
        out[f"witness_cudnn_{flag}"] = {
            "step1_worst_rel": worst_rel(gan_held(first),
                                         gan_held(one_first)),
            "step2_worst_rel": worst_rel(gan_held(state_parts(state)),
                                         gan_held(state_parts(one_state)))}
    return out


def data_parallel_phase(torch, card_name: str) -> dict:
    """Phase 10: data parallelism on the card, two gloo ranks sharing it
    (NCCL refuses two ranks on one GPU). (1) The sharded DAMSM loss at
    full width, global batch 64 at 8 words and the GAN coupling's 16 at 5
    (K4 at 32 x 64 and 8 x 16 on each rank, K6 in the backward, K5 never:
    exactly 1, 2 and 0 launches a rank and case), against the loss and
    gradients of one process (K4 and K5 square) at SIMS_TOL and GRAD_RTOL
    plus GRAD_ATOL_SHARE of the largest entry (a rank's gradient is 2x its
    rows' share: the gathers' backward sums both ranks' replicated loss);
    K4 and K6 alone against their plain versions and timed at those shapes
    and at cli.pretrain's 32 x 64 at 2 words. (2) The CLIs through their own
    ``--mesh-shape 2`` under ``torchrun --standalone --nproc-per-node 2``,
    in fp32, chained through their checkpoints: cli.pretrain (128
    synthetic images, batch 64: 2 steps), cli.train from it (16 at batch
    16 for 2 epochs: 2 steps, the sharded coupling, rank 0's sample grids)
    and
    cli.infer --benchmark at batch 64 from that; and the same chain in
    this process. Each rank's launches exact (one process's sampler
    launches from the host on its eager and its captured call only); the
    ranks' trained states equal bit for bit; losses finite and moving, the first step's within
    STEP_RTOL of the one-process chain's; the states against that chain's
    in norm per tensor (second moments at their gradient's scale): the
    pretrain state within STEP_RTOL, the GAN's moments, BN statistics and
    frozen encoders after its first step (each epoch's save) within
    GAN_GRAD_RTOL (``gan_held``), and so after its second when one process
    takes it from the ranks' first save (``second_step``); seconds and steps/s of each call and img/s
    of the benchmarks, two ranks on one card beside one process. (3) NCCL
    at world 1: ``cli.train --mesh-shape 1`` under torchrun, its
    launches those of one process. Returns {kernel: launches over the
    phase}."""
    from attngan_torch.cli import infer, pretrain, train
    from attngan_torch.train.checkpoint import (
        diff_parts,
        load_part,
        state_parts,
    )

    counters = kernel_counters()
    total = {}
    zero = {name: 0 for name in counters}

    def add(counts: dict) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    def expect(what: str, counts: dict, want: dict) -> None:
        full = dict(zero, **want)
        fail_unless(counts == full, f"{what}: launches {counts}, expected "
                    f"{full}")
        add(counts)

    kernel_times = time_sharded_kernels(torch, card_name)
    with tempfile.TemporaryDirectory() as d:
        # (1) the sharded loss against one process
        ranks, _ = torchrun("loss", f"{d}/loss", [])
        for label, batch, seq in DP_LOSS_CASES:
            for c in counters.values():
                c.launches = 0
            ref = dp_loss(torch, None, dp_loss_inputs(torch, batch, seq))
            expect(f"sharded loss {label}, one process",
                   {n: c.launches for n, c in counters.items()},
                   {"damsm_similarity": 1, "damsm_similarity_bwd_square": 2})
            errs = {}
            for r, record in enumerate(ranks):
                got, counts, _ = record[label]
                expect(f"sharded loss {label}, rank {r}", counts,
                       {"damsm_similarity": 1,
                        "damsm_similarity_bwd_tiled": 2})
                torch.testing.assert_close(got["total"], ref["total"],
                                           **SIMS_TOL)
                rows = slice(r * batch // DP_RANKS,
                             (r + 1) * batch // DP_RANKS)
                for k in ("img", "code", "words", "sent"):
                    want = ref[k][rows]
                    torch.testing.assert_close(
                        got[k] / DP_RANKS, want, rtol=GRAD_RTOL,
                        atol=GRAD_ATOL_SHARE * float(ref[k].abs().max()),
                        msg=lambda m: f"sharded loss {label} d_{k}: {m}")
                    errs[k] = max(errs.get(k, 0.0), float(
                        (got[k] / DP_RANKS - want).abs().max()))
            print(json.dumps({
                "phase": "data_parallel", "step": "sharded_loss",
                "case": label, "batch": batch, "words": seq,
                "per_rank": f"{batch // DP_RANKS} x {batch}",
                "loss": float(ref["total"]),
                "loss_err": max(abs(float(rec[label][0]["total"]
                                          - ref["total"])) for rec in ranks),
                "grad_max_abs_err": errs,
                "launches_per_rank": ranks[0][label][1],
                "kernels": kernel_times[label], "card": card_name}),
                flush=True)

        # (2) the CLI chain: two ranks, then one process
        def chain_args(root):
            common = ["--captions-path", f"{root}/caps.json",
                      "--checkpoint-dir", f"{root}/ckpt", "--image-dir",
                      f"{root}/img", "--compute-dtype", "float32"]
            return {"pretrain": DP_PRETRAIN + common,
                    "train": DP_GAN + common + [
                        "--damsm-checkpoint", f"{root}/ckpt/damsm"],
                    "infer": ["--checkpoint", f"{root}/ckpt/gan",
                              "--benchmark", "--batch-size", "64"]}

        grids = 2 * DP_STEPS          # rank 0's: K1 and K2 twice, 2 epochs
        want_ranks = {
            "pretrain": [{"damsm_similarity": DP_STEPS,
                          "damsm_similarity_bwd_tiled": 2 * DP_STEPS}] * 2,
            "train": [{"word_attention": 2 * DP_STEPS + grids,
                       "upblock_fused_eval": grids,
                       "damsm_similarity": DP_STEPS,
                       "damsm_similarity_bwd_tiled": 2 * DP_STEPS},
                      {"word_attention": 2 * DP_STEPS,
                       "damsm_similarity": DP_STEPS,
                       "damsm_similarity_bwd_tiled": 2 * DP_STEPS}],
            "infer": [{"word_attention": 2 * 21,
                       "upblock_fused_eval": 2 * 21}] * 2}
        want_one = {
            "pretrain": {"damsm_similarity": DP_STEPS,
                         "damsm_similarity_bwd_square": 2 * DP_STEPS},
            "train": {"word_attention": 2 * DP_STEPS + grids,
                      "upblock_fused_eval": grids,
                      "damsm_similarity": DP_STEPS,
                      "damsm_similarity_bwd_square": 2 * DP_STEPS},
            # one device: the first call eager, the second captured, the
            # other 19 replayed, launching nothing from the host
            "infer": {"word_attention": 2 * 2,
                      "upblock_fused_eval": 2 * 2}}
        two, one = chain_args(f"{d}/ranks"), chain_args(f"{d}/one")
        clis = {"pretrain": pretrain, "train": train, "infer": infer}
        for job in ("pretrain", "train", "infer"):
            ranks, stdout = torchrun(job, f"{d}/out_{job}", two[job] +
                                     ["--mesh-shape", str(DP_RANKS)])
            fail_unless("backend gloo" in stdout,
                        f"{job}: no gloo process group in\n{stdout[-2000:]}")
            for r, record in enumerate(ranks):
                expect(f"{job} rank {r}", record["launches"],
                       want_ranks[job][r])
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            result = clis[job].main(one[job])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            expect(f"{job} one process",
                   {n: c.launches for n, c in counters.items()},
                   want_one[job])
            line = {"phase": "data_parallel", "step": "cli_chain",
                    "cli": job, "ranks_on_one_card": DP_RANKS,
                    "rank_seconds": [rec["seconds"] for rec in ranks],
                    "one_process_seconds": seconds,
                    "launches_per_rank": [rec["launches"] for rec in ranks],
                    "card": card_name,
                    "note": "two ranks sharing one card, set-up included: "
                            "not a scaling figure"}
            if job == "infer":
                got = ranks[0]["result"]
                fail_unless(got["devices"] == DP_RANKS
                            and result["devices"] == 1,
                            f"infer devices {got['devices']}, "
                            f"{result['devices']}")
                line.update(ranks_img_per_s=got["value"],
                            ranks_windows=got["windows"],
                            one_process_img_per_s=result["value"],
                            one_process_windows=result["windows"])
            else:
                parts = [rec["result"]["parts"] for rec in ranks]
                diff = diff_parts(parts[0], parts[1])
                fail_unless(not diff, f"{job}: ranks' states differ at "
                            f"{diff[:5]}")
                _, state, history = result
                got_hist = ranks[0]["result"]["history"]
                series = ({"loss": got_hist} if job == "pretrain"
                          else got_hist)
                want_series = ({"loss": history} if job == "pretrain"
                               else history)
                metric_rel = {}
                for key, values in series.items():
                    fail_unless(len(values) == DP_STEPS
                                and all(map(math.isfinite, values))
                                and values[0] != values[-1],
                                f"{job} {key}: {values}")
                    rel = [abs(a - b) / abs(b)
                           for a, b in zip(values, want_series[key])]
                    # the first step's, from the same state (later steps
                    # follow Adam's sign flips, which the state check holds)
                    fail_unless(rel[0] <= STEP_RTOL, f"{job} {key}: first "
                                f"step {values[0]} vs one process's "
                                f"{want_series[key][0]}")
                    metric_rel[key] = rel
                if job == "pretrain":
                    worst, where = worst_rel(parts[0], state_parts(state))
                    fail_unless(worst <= STEP_RTOL, f"pretrain: state "
                                f"{where} {worst} from one process's")
                else:
                    # the first step's state, from the same state on both
                    # sides (its saved epoch); the second step starts
                    # from weights that Adam's sign flips moved apart
                    first = [{name: load_part(ckpt, name)
                              for name in state_parts(state)}
                             for ckpt in (f"{root}/ckpt/gan/step_00000001"
                                          for root in (f"{d}/ranks",
                                                       f"{d}/one"))]
                    worst, where = worst_rel(gan_held(first[0]),
                                             gan_held(first[1]))
                    fail_unless(worst <= GAN_GRAD_RTOL, f"train: step 1 "
                                f"state {where} {worst} from one process's")
                    line.update(second_step(
                        torch, d, one["train"], parts[0], state,
                        lambda what, counts: expect(what, counts, {
                            "word_attention": 2 + 2,
                            "upblock_fused_eval": 2,
                            "damsm_similarity": 1,
                            "damsm_similarity_bwd_square": 2})))
                line.update(state_worst_rel=worst, state_worst_at=where,
                            ranks_steps_per_s=[DP_STEPS / rec["seconds"]
                                               for rec in ranks],
                            one_process_steps_per_s=DP_STEPS / seconds,
                            losses=got_hist, metric_rel_by_step=metric_rel)
            print(json.dumps(line), flush=True)

        # (3) NCCL at world 1
        ranks, stdout = torchrun("train", f"{d}/out_nccl",
                                 chain_args(f"{d}/ranks")["train"][:-2]
                                 + ["--damsm-checkpoint",
                                    f"{d}/ranks/ckpt/damsm",
                                    "--checkpoint-dir", f"{d}/nccl",
                                    "--mesh-shape", "1"], ranks=1)
        fail_unless("backend nccl" in stdout,
                    f"--mesh-shape 1: no NCCL process group in\n"
                    f"{stdout[-2000:]}")
        expect("NCCL world 1", ranks[0]["launches"], want_one["train"])
        print(json.dumps({"phase": "data_parallel", "step": "nccl_world_1",
                          "seconds": ranks[0]["seconds"],
                          "launches": ranks[0]["launches"],
                          "card": card_name}), flush=True)
    return total


# ------------------------------------------------ phase 11: the side tiers

# int8 images, fp32 at batch 2, card against the CPU (same weights, noise
# and scales): a site's input differs by float rounding between the two
# (~1e-6 relative), which flips round(x / sx) for the element within that
# of a half step (~1e-4 of a site's elements at full width); a flip moves
# that element's product by one quantization step and the later convs
# spread it over a patch. Read on the card (H100 80GB HBM3, 700 W): mean
# 3.0e-4, max 4.8e-3 (a first bound of 1e-4 on the mean came from the
# tiny CPU test against JAX, 1.1e-5, whose sites hold ~1000x fewer
# elements). The tier's own effect, int8 against float, is a mean of
# 7.4e-3, which a wrong scale or weight would reach.
INT8_VS_CPU = dict(atol=2e-2, mean=1e-3)
# an artifact's images against the live sampler's, same weights and seed's
# draws: the same ops in bf16, but the BiLSTM in its masked form (fp32,
# ~1e-7 from nn.LSTM) moves a bf16 rounding here and there; a wrong
# weight, seed or path moves the mean by ~1e-1
EXPORT_MEAN = 1e-3
# the int8 trunk's losses against the plain trunk's from the same state:
# JAX's own bound (tests/test_quantize.py)
TRUNK_INT8_RTOL = 0.05
# the FID featurizer's fp32 features, card against the CPU, as a share of
# their largest magnitude (the CPU against JAX: 3.6e-5)
FEATURE_RTOL = 1e-3
# a set's FID against itself, as a share of its covariance's trace (sqrtm
# of a rank-deficient product: 64 images in 2048 dimensions; 2.4e-7 of it
# on random features on the CPU)
SELF_FID_SHARE = 1e-5
EXPORT_SEED = 7

SERVE_EXPORTED = r"""
import importlib.util, sys
import torch
spec = importlib.util.spec_from_file_location("export_loader", sys.argv[1])
loader = importlib.util.module_from_spec(spec)
spec.loader.exec_module(loader)
tokens, lengths = torch.load(sys.argv[2])
out = {}
for name, path in (("float", sys.argv[3]), ("int8", sys.argv[4])):
    for device, sizes in (("cuda", (3, 64)), ("cpu", (2,))):
        served = loader.ExportedSampler(path, device=device)
        for n in sizes:
            out[(name, device, n)] = served(tokens[:n], lengths[:n],
                                            seed=int(sys.argv[6])).cpu()
imported = sorted(m for m in sys.modules if m.startswith("attngan"))
assert not imported, imported
torch.save(out, sys.argv[5])
"""


def int8_products(torch, sampler, tokens, lengths, noise, eps) -> dict:
    """Every quantized site of one int8 serving call: its int8 input's
    exact s32 product on the card (``Int8Site.int_product``, cuBLASLt's
    IMMA) against the CPU's, in float64 (exact: every partial sum is an
    integer below 2^53), whole batch, bit for bit. Returns {path: the
    site's input} for the timing of the largest sites."""
    import torch.nn.functional as F

    from attngan_torch.ops.int8 import quantize

    quantizer = sampler.quantizer
    captured = []

    def capture(layer, x):
        entry = quantizer._by_layer.get(layer)
        if entry is not None and entry[0] in quantizer.act_scales:
            captured.append((*entry, x))
        return quantizer(layer, x)

    sampler.quantizer = capture
    try:
        sampler.generate_from_tokens(tokens, lengths, noise, eps)
    finally:
        sampler.quantizer = quantizer
    torch.cuda.synchronize()
    rows, inputs = [], {}
    for path, site, x in captured:
        sx = max(quantizer.act_scales[path], 1e-8) / 127.0
        w = site.int8_weight().cpu().double()
        if site.conv:
            q = quantize(x.permute(0, 2, 3, 1), sx).contiguous()
            ref = F.conv2d(q.permute(0, 3, 1, 2).cpu().double(), w,
                           stride=site.stride, padding=site.padding
                           ).permute(0, 2, 3, 1)
        else:
            q = quantize(x, sx).reshape(-1, x.shape[-1])
            ref = q.cpu().double() @ w.t()
        got = site.int_product(q).cpu()
        exact = bool(torch.equal(got.long(), ref.long()))
        rows.append([path, list(q.shape), int(got.abs().max()), exact])
        fail_unless(exact, f"int8 product of {path} differs from the CPU's")
        inputs[path] = x
    print(json.dumps({"phase": "side_tiers", "step": "int8_products",
                      "sites": len(rows), "exact": all(r[3] for r in rows),
                      "rows": ["path, int8 input shape, max |s32|, exact",
                               *rows]}), flush=True)
    fail_unless(len(rows) == 15, f"{len(rows)} int8 sites, expected 15")
    return inputs


def int8_site_times(torch, sampler, inputs: dict, card_name: str) -> None:
    """Device ms at the two largest sites (gen3's first ResBlock conv at
    128^2 and img_out3's at 256^2, batch 64, bf16): the bf16 cuDNN conv
    beside the int8 site and its passes (quantize, im2col, the s32 GEMM,
    dequantize)."""
    import torch.nn.functional as F

    from attngan_torch.ops.int8 import quantize

    gen = sampler.state.generator
    for path, layer in (("gen3/ResBlock_0/Conv_0", gen.gen3.res[0].conv1),
                        ("img_out3/Conv_0", gen.img_out3.conv)):
        x = inputs[path]
        site = sampler.quantizer._by_layer[layer][1]
        sx = max(sampler.quantizer.act_scales[path], 1e-8) / 127.0
        w = layer.weight.to(x.dtype)
        q = quantize(x.permute(0, 2, 3, 1), sx).contiguous()
        (kh, kw), (ph, pw) = site.kernel_size, site.padding
        qp = F.pad(q, (0, 0, pw, pw, ph, ph))
        b, hp, wp, c = qp.shape
        ho, wo = hp - kh + 1, wp - kw + 1
        a = torch.cat([qp[:, i:i + ho, j:j + wo] for i in range(kh)
                       for j in range(kw)], dim=-1).reshape(b * ho * wo, -1)
        a = F.pad(a, (0, site.wmat.shape[0] - a.shape[1]))
        y = torch._int_mm(a, site.wmat)
        ms = {
            "bf16_conv": time_ms(lambda: F.conv2d(x, w, padding=layer.padding),
                                 iters=10),
            "int8_site": time_ms(lambda: site(x, sx), iters=10),
            "quantize": time_ms(lambda: quantize(x.permute(0, 2, 3, 1), sx)
                                .contiguous(), iters=10),
            "im2col": time_ms(lambda: torch.cat(
                [qp[:, i:i + ho, j:j + wo] for i in range(kh)
                 for j in range(kw)], dim=-1), iters=10),
            "int8_gemm": time_ms(lambda: torch._int_mm(a, site.wmat),
                                 iters=10),
            "dequantize": time_ms(lambda: (y[:, :site.out_features].float()
                                           * (sx * site.sw)).to(x.dtype),
                                  iters=10)}
        print(json.dumps({"phase": "side_tiers", "step": "int8_site_ms",
                          "site": path, "input": list(x.shape),
                          "gemm_mkn": [a.shape[0], a.shape[1],
                                       site.wmat.shape[1]],
                          "im2col_mb": a.numel() / 2 ** 20, **ms,
                          "card": card_name}), flush=True)


def int8_serving(torch, card_name: str, d: str) -> tuple:
    """Int8 serving at full width (bf16, batch 64): the products of one
    call bit for bit, exact launches, int8 against float images and img/s
    in turns, the sites' device times, cli.infer --int8 --benchmark, fp32
    at batch 2 against the CPU. Returns ({kernel: launches}, the state's
    .pt path, tokens, lengths)."""
    import numpy as np

    from attngan_torch.cli import infer
    from attngan_torch.core.config import GanConfig, replace
    from attngan_torch.infer.quantize import Int8Sampler
    from attngan_torch.infer.sampler import (
        InferState,
        Sampler,
        load_infer_state,
        save_infer_state,
    )

    counters = kernel_counters()
    cfg = GanConfig()
    torch.manual_seed(0)
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, VOCAB, (BATCH, SEQ_LEN)))
    lengths = torch.as_tensor(rng.integers(1, SEQ_LEN + 1, BATCH))
    path = os.path.join(d, "infer_state.pt")
    state = InferState(cfg, VOCAB)
    calibrate_bn(torch, state, tokens[:16], lengths[:16])
    save_infer_state(path, state)
    float_s = Sampler(load_infer_state(path, cfg, device="cuda"))
    int8_s = Int8Sampler(load_infer_state(path, cfg, device="cuda"))
    gen = torch.Generator("cuda").manual_seed(12)
    noise = torch.randn((BATCH, cfg.z_dim), generator=gen, device="cuda")
    eps = torch.randn((BATCH, cfg.cond_dim), generator=gen, device="cuda")
    int8_s.generate_from_tokens(tokens, lengths, noise, eps)   # calibrates
    inputs = int8_products(torch, int8_s, tokens, lengths, noise, eps)
    launches = {}
    for fn in counters.values():
        fn.launches = 0
    int8_imgs = int8_s.generate_from_tokens(tokens, lengths, noise, eps)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counters.items()}
    want = {name: 2 if name in ("word_attention", "upblock_fused_eval")
            else 0 for name in counters}
    fail_unless(counts == want, f"int8 serving call: launches {counts}, "
                f"expected {want}")
    for name in ("word_attention", "upblock_fused_eval"):
        launches[name] = 2
    float_imgs = float_s.generate_from_tokens(tokens, lengths, noise, eps)
    delta = (int8_imgs - float_imgs).abs()
    fail_unless(bool(torch.isfinite(int8_imgs).all()), "non-finite int8 "
                "images")
    print(json.dumps({"phase": "side_tiers", "step": "int8_serve",
                      "batch": BATCH, "launches": counts,
                      "scales": len(int8_s.act_scales),
                      "int8_vs_float_mean_abs": float(delta.mean()),
                      "int8_vs_float_max_abs": float(delta.max()),
                      "float_std": float(float_imgs.std())}), flush=True)
    int8_site_times(torch, int8_s, inputs, card_name)
    del inputs

    paths = (("int8", int8_s), ("float_k2", float_s))
    rates = {label: [] for label, _ in paths}
    for round_ in range(4):
        for label, sampler in paths[round_ % 2:] + paths[:round_ % 2]:
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(5):
                sampler.generate_from_tokens(tokens, lengths, noise, eps)
            torch.cuda.synchronize()
            rates[label].append(5 * BATCH / (time.perf_counter() - start))
    print(json.dumps({"phase": "side_tiers", "step": "int8_throughput",
                      "batch": BATCH, **{f"{k}_img_per_s":
                                         statistics.median(v)
                                         for k, v in rates.items()},
                      "windows": rates, "card": card_name}), flush=True)
    del float_s, int8_s

    for fn in counters.values():
        fn.launches = 0
    line = infer.main(["--checkpoint", path, "--int8", "--benchmark",
                       "--batch-size", str(BATCH)])
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counters.items()}
    # cli/infer.py's warm-up and 5 windows of 4 calls, and the first
    # call's calibration forward (float: K1 and K2 too)
    calls = 1 + 5 * 4 + 1
    want = {name: 2 * calls if name in ("word_attention",
                                        "upblock_fused_eval") else 0
            for name in counters}
    fail_unless(counts == want and line["int8"] is True,
                f"cli.infer --int8 --benchmark: launches {counts}, "
                f"expected {want}")
    for name in ("word_attention", "upblock_fused_eval"):
        launches[name] += want[name]

    cfg32 = replace(cfg, compute_dtype="float32")
    card32 = Int8Sampler(load_infer_state(path, cfg32, device="cuda"))
    cpu32 = Int8Sampler(load_infer_state(path, cfg32, device="cpu"),
                        device="cpu")
    scales = card32.calibrate_on(tokens[:2], lengths[:2], noise[:2], eps[:2])
    cpu32.act_scales = cpu32.quantizer.act_scales = scales
    got = card32.generate_from_tokens(tokens[:2], lengths[:2], noise[:2],
                                      eps[:2]).cpu()
    ref = cpu32.generate_from_tokens(tokens[:2], lengths[:2],
                                     noise[:2].cpu(), eps[:2].cpu())
    diff = (got - ref).abs()
    print(json.dumps({"phase": "side_tiers", "step": "int8_fp32_vs_cpu",
                      "batch": 2, "max_abs_err": float(diff.max()),
                      "mean_abs_err": float(diff.mean()),
                      "share_within_1e-3": float((diff <= 1e-3).float()
                                                 .mean()),
                      "tol": INT8_VS_CPU}), flush=True)
    fail_unless(float(diff.max()) <= INT8_VS_CPU["atol"]
                and float(diff.mean()) <= INT8_VS_CPU["mean"],
                f"int8 fp32 images, card vs CPU: max {float(diff.max())}, "
                f"mean {float(diff.mean())}")
    return launches, path, tokens, lengths


def exported(torch, d: str, path: str, tokens, lengths) -> None:
    """cli.infer --export (cuda,cpu, symbolic batch) and --export --int8 on
    the card; both served in a fresh process that imports torch and the
    loader's file only (batches of 3 and 64 on the card, 2 on the CPU),
    against the live plain-path Sampler and the live Int8Sampler (the
    artifact's scales) on the seed's draws."""
    from attngan_torch.cli import infer
    from attngan_torch.data.synthetic import make_synthetic_dataset
    from attngan_torch.infer import export
    from attngan_torch.infer.quantize import Int8Sampler
    from attngan_torch.infer.sampler import Sampler, load_infer_state

    caps = os.path.join(d, "caps.json")
    make_synthetic_dataset(16).save_captions_and_class_ids(caps)
    artifacts = {"float": os.path.join(d, "float.zip"),
                 "int8": os.path.join(d, "int8.zip")}
    seconds = {}
    for name, flags in (("float", []), ("int8", ["--int8"])):
        start = time.perf_counter()
        infer.main(["--checkpoint", path, "--captions-path", caps,
                    "--export", artifacts[name], "--batch-size", str(BATCH),
                    *flags])
        seconds[name] = time.perf_counter() - start
    batch_path, out = os.path.join(d, "batch.pt"), os.path.join(d, "out.pt")
    torch.save((tokens.int(), lengths.int()), batch_path)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_EXPORTED, export.__file__, batch_path,
         artifacts["float"], artifacts["int8"], out, str(EXPORT_SEED)],
        capture_output=True, text=True, timeout=600, cwd=d)
    fail_unless(proc.returncode == 0, f"serving the artifacts: exit "
                f"{proc.returncode}\n{proc.stderr[-3000:]}")
    serve_s = time.perf_counter() - start
    served = torch.load(out)
    state = load_infer_state(path, device="cpu")
    with zipfile.ZipFile(artifacts["int8"]) as z:
        scales = json.loads(z.read(export.ABI))["act_scales"]
    errors = {}
    for device in ("cuda", "cpu"):
        plain = export.plain_state(state, device)
        live = {"float": Sampler(plain, device=device),
                "int8": Int8Sampler(plain, device=device)}
        live["int8"].act_scales = live["int8"].quantizer.act_scales = scales
        for (name, dev, n), imgs in served.items():
            if dev != device:
                continue
            want = live[name].generate_from_tokens(
                tokens[:n], lengths[:n],
                generator=torch.Generator(device).manual_seed(EXPORT_SEED))
            diff = (imgs - want.cpu()).abs()
            errors[f"{name}_{dev}_{n}"] = [float(diff.mean()),
                                           float(diff.max())]
            fail_unless(tuple(imgs.shape) == (n, 256, 256, 3)
                        and float(diff.mean()) <= EXPORT_MEAN,
                        f"{name} artifact on {dev} at {n}: mean |diff| "
                        f"{float(diff.mean())}")
    print(json.dumps({"phase": "side_tiers", "step": "export",
                      "mb": {k: os.path.getsize(p) / 2 ** 20
                             for k, p in artifacts.items()},
                      "export_s": seconds, "serve_process_s": serve_s,
                      "mean_max_abs_err": errors,
                      "mean_tol": EXPORT_MEAN}), flush=True)


def int8_trunk(torch, card_name: str, d: str) -> dict:
    """cli.pretrain at full width (128 synthetic images, batch 64, 1
    epoch: 2 steps), with --trunk-int8 and plain from the same seed: K4 1
    and K5 2 a step, every other kernel 0; losses finite and the int8
    run's within 5% of the plain run's; then steps/s of the two trainers
    in turns on one batch. Returns {kernel: launches}."""
    import numpy as np

    from attngan_torch.cli import pretrain

    counters = kernel_counters()
    runs, launches = {}, {}
    for name, flags in (("plain", []), ("int8", ["--trunk-int8"])):
        for fn in counters.values():
            fn.launches = 0
        runs[name] = pretrain.main([
            "--synthetic", "128", "--batch-size", "64", "--epochs", "1",
            "--captions-path", f"{d}/{name}/caps.json",
            "--checkpoint-dir", f"{d}/{name}/ckpt",
            "--image-dir", f"{d}/{name}/img", *flags])
        torch.cuda.synchronize()
        counts = {n: fn.launches for n, fn in counters.items()}
        want = {n: {"damsm_similarity": 2,
                    "damsm_similarity_bwd_square": 4}.get(n, 0)
                for n in counters}
        fail_unless(counts == want, f"cli.pretrain {flags}: launches "
                    f"{counts}, expected {want}")
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
    plain, int8 = (runs[k][2] for k in ("plain", "int8"))
    rel = [abs(q - p) / abs(p) for p, q in zip(plain, int8)]
    trainer = runs["int8"][0]
    print(json.dumps({"phase": "side_tiers", "step": "trunk_int8",
                      "steps": len(int8), "plain_losses": plain,
                      "int8_losses": int8, "rel": rel,
                      "scales": len(trainer._trunk_scales),
                      "rtol": TRUNK_INT8_RTOL}), flush=True)
    fail_unless(len(int8) == 2 and all(np.isfinite(int8))
                and max(rel) < TRUNK_INT8_RTOL
                and len(trainer._trunk_scales) == 65,
                f"int8 trunk losses {int8} vs plain {plain}")

    rng = np.random.default_rng(13)
    batch = {      # the CLI's vocabulary and caption length
        "tokens": torch.as_tensor(rng.integers(
            0, trainer.vocab_size, (DAMSM_BATCH, trainer.seq_len)),
            device="cuda"),
        "lengths": torch.as_tensor(rng.integers(1, trainer.seq_len + 1,
                                                DAMSM_BATCH)),
        "class_ids": None,
        "img256": torch.rand((DAMSM_BATCH, 256, 256, 3), device="cuda")
        * 2.0 - 1.0}
    steps = {k: (runs[k][0], runs[k][1]) for k in runs}
    rates = {k: [] for k in steps}
    order = list(steps)
    for round_ in range(4):
        for label in order[round_ % 2:] + order[:round_ % 2]:
            tr, st = steps[label]
            tr.train_step(st, batch)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(5):
                tr.train_step(st, batch)
            torch.cuda.synchronize()
            rates[label].append(5 / (time.perf_counter() - start))
    print(json.dumps({"phase": "side_tiers", "step": "trunk_int8_throughput",
                      "batch": DAMSM_BATCH,
                      **{f"{k}_steps_per_s": statistics.median(v)
                         for k, v in rates.items()},
                      "windows": rates, "card": card_name}), flush=True)
    return launches


def fid(torch, path: str, tokens, lengths, card_name: str) -> None:
    """int8_vs_bf16_fid at batch 64 on the calibrated random featurizer
    (bf16), a set's FID against itself, and the featurizer's fp32 features
    on the card against the CPU's (the same weights and calibration
    batch)."""
    import numpy as np

    from attngan_torch.eval.fid import (
        FIDEvaluator,
        activation_statistics,
        frechet_distance,
        int8_vs_bf16_fid,
    )
    from attngan_torch.infer.sampler import Sampler, load_infer_state

    start = time.perf_counter()
    ev = FIDEvaluator(batch_size=BATCH)
    state = load_infer_state(path, device="cuda")
    out = int8_vs_bf16_fid(state, tokens, lengths, seed=14, evaluator=ev)
    imgs = Sampler(state).generate_from_tokens(
        tokens, lengths, generator=torch.Generator("cuda").manual_seed(14))
    mu, sigma = activation_statistics(ev.features(imgs * 2.0 - 1.0))
    self_fid = frechet_distance(mu, sigma, mu, sigma)
    fid_s = time.perf_counter() - start
    calib = torch.rand((16, 128, 128, 3), generator=torch.Generator()
                       .manual_seed(15)) * 2.0 - 1.0
    probe = torch.rand((4, 64, 64, 3), generator=torch.Generator()
                       .manual_seed(16)) * 2.0 - 1.0
    feats = {dev: FIDEvaluator(batch_size=4, device=dev, calibration=calib,
                               dtype=torch.float32).features(probe)
             for dev in ("cuda", "cpu")}
    scale = float(np.abs(feats["cpu"]).max())
    err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
    print(json.dumps({"phase": "side_tiers", "step": "fid", "batch": BATCH,
                      **out, "self_fid": self_fid,
                      "self_fid_share_of_trace": abs(self_fid)
                      / float(np.trace(sigma)),
                      "fp32_features_max_abs_err": err,
                      "features_scale": scale, "feature_rtol": FEATURE_RTOL,
                      "fid_s": fid_s, "card": card_name}), flush=True)
    fail_unless(all(np.isfinite(v) for v in out.values()), f"FID {out}")
    fail_unless(abs(self_fid) <= SELF_FID_SHARE * float(np.trace(sigma)),
                f"FID of a set against itself: {self_fid}")
    fail_unless(err <= FEATURE_RTOL * scale, f"fp32 features, card vs CPU: "
                f"{err} of {scale}")


def side_tiers_phase(torch, card_name: str) -> dict:
    """Phase 11: int8 serving, export, the int8 trunk and FID at full
    width. Returns {kernel: launches over the phase's counted calls}."""
    with tempfile.TemporaryDirectory() as d:
        launches, path, tokens, lengths = int8_serving(torch, card_name, d)
        exported(torch, d, path, tokens, lengths)
        for name, n in int8_trunk(torch, card_name, d).items():
            launches[name] = launches.get(name, 0) + n
        fid(torch, path, tokens, lengths, card_name)
    return launches


# ---------------------------------------------------- phase 12: last modules

LAST_BATCH = 16           # VGG19-BN features and the DFCVAE loss step
LAST_CHECK_BATCH = 2      # the fp32 DFCVAE step and VGG taps vs the CPU
LAST_STEPS = 10           # timed DFCVAE loss steps
# the card's fp32 (TF32 off) against the CPU's: VGG taps and VAE embeddings
# within 1e-4 of their largest magnitude (44 conv layers; other conv
# algorithms); the DFCVAE loss within 1e-4 relative and each parameter's
# gradient within 1e-3 in norm (its 1x1 bottleneck's train-mode BN over 2
# rows amplifies rounding, as on the CPU against JAX) of its own norm; a
# conv bias ahead of a train-mode BN, whose true gradient is 0, of
# VAE_GRAD_FLOOR of the whole gradient's norm
VGG_RTOL, VAE_EMBED_RTOL = 1e-4, 1e-4
VAE_LOSS_RTOL, VAE_GRAD_RTOL, VAE_GRAD_FLOOR = 1e-4, 1e-3, 1e-3
# a leaky ReLU input within rounding of 0 takes either side on two devices,
# and the gradients upstream then differ by a whole slope there; so the
# CPU's DFCVAE step takes the card's side of every leaky ReLU input, and an
# input whose own side differs must lie within SIDE_ATOL of 0 (the fp32
# activations after BN are O(1); their rounding ~1e-5)
SIDE_ATOL = 1e-4
VAE_EMBED_SEED = 5
CHAIN_IMAGES = 32         # JPEGs (64 records) of the tools' CLI chain
MFU_ARGV = ["sampler", "damsm", "gan", "--sampler-batch", "64",
            "--damsm-batch", "64", "--gan-batch", "16"]
MFU_CALLS = {"sampler": 1 + 3 * 20, "damsm": 1 + 3 * 30, "gan": 1 + 3 * 20}
MFU_MAX = 1.05
TOOL_KEYS = {
    "attnmaps_bench": [
        {"metric", "value", "unit", "images", "batch_size", "image_encoder",
         "seconds", "reference_img_per_sec", "vs_reference"},
        {"metric", "value", "unit", "images", "seconds", "vs_reference"}],
    "cluster_quality_run": [
        {"n_images", "k_ladder", "method", "reducer", "levels",
         "grid_member_counts", "caption_swap_demo"}],
    "collision_check": [
        {"batch", "excluded_offdiag_pairs", "distinct_classes", "loss_masked",
         "loss_ablated", "delta", "words_delta", "sent_delta"},
        {"summary", "total_excluded_pairs", "batches"}],
    "fid_curve": [{"step", "fid", "fid_std", "fid_seeds"},
                  {"first", "last", "decreasing"}],
    "int8_fid_run": [{"fid_int8_vs_float"}],     # without --real-dir
    "make_photo_corpus": [],
    "convert_torch_weights": [],
    "mfu_report": [{"path", "sec_per_call", "unit_per_call", "windows_ms",
                    "model_gflops_per_call", "device_kind", "achieved_tflops",
                    "peak_tflops", "mfu"}],
}


def he_init_(torch, module, seed: int):
    """Seeded He-normal weights on every conv, transposed conv and Linear
    (a transposed conv's fan-in: its input channels x k^2 / stride^2), zero
    biases: the signal keeps its scale through eval-mode BN at its initial
    statistics. Returns ``module``."""
    gen = torch.Generator().manual_seed(seed)
    nn = torch.nn
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel() / 4
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
            else:
                continue
            m.weight.normal_(0, math.sqrt(2.0 / fan_in), generator=gen)
            if m.bias is not None:
                m.bias.zero_()
    return module


def write_vgg_pth(torch, path: str) -> dict:
    """A seeded VGG19-BN ``features`` trunk saved at ``path`` as a
    torchvision vgg19_bn state_dict (every BN's ``num_batches_tracked`` and
    a classifier entry included), drawn as tests/torch_oracles.py's
    ``randomize_`` draws: fan-in scaled convs, BN weights, biases and
    statistics away from 1 and 0. Returns the port's state_dict."""
    from attngan_torch.models.vgg import VGG19BNFeatures

    gen = torch.Generator().manual_seed(12)
    sd = VGG19BNFeatures().state_dict()
    bns = {k.rsplit(".", 1)[0] for k in sd if k.endswith("running_mean")}
    torchvision = {}
    for key, value in sd.items():
        module, leaf = key.rsplit(".", 1)
        if value.dim() == 4:
            value.normal_(0, value[0].numel() ** -0.5, generator=gen)
        elif module not in bns:                         # a conv's bias
            value.normal_(0, 0.05, generator=gen)
        elif leaf in ("weight", "running_var"):
            value.uniform_(0.5, 1.5, generator=gen)
        else:                                           # bias, running_mean
            value.normal_(0, 0.1, generator=gen)
        torchvision[key] = value
        if leaf == "running_var":
            torchvision[f"{module}.num_batches_tracked"] = torch.tensor(0)
    torchvision["classifier.6.bias"] = torch.zeros(1000)
    torch.save(torchvision, path)
    return sd


def last_vgg(torch, path: str, card_name: str):
    """VGG19-BN from a torchvision .pth through load_torchvision_vgg19_bn,
    fp32, default taps, 256^2 at LAST_BATCH: ms a forward, its FLOPs; two
    images against the CPU. Returns (card module, CPU module)."""
    from attngan_torch.convert import load_torchvision_vgg19_bn
    from attngan_torch.models.vgg import VGG19BNFeatures
    from attngan_torch.utils.mfu import model_flops

    sd = load_torchvision_vgg19_bn(path)
    cpu = VGG19BNFeatures()
    cpu.load_state_dict(sd, strict=True)
    vgg = VGG19BNFeatures()
    vgg.load_state_dict(sd, strict=True)
    vgg = vgg.to("cuda", memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(13)
    x = torch.rand((LAST_BATCH, 256, 256, 3), generator=gen) * 2 - 1
    xc = x.cuda()
    with torch.no_grad():
        flops, taps = model_flops(vgg, xc)
        ms = time_ms(lambda: vgg(xc), iters=10)
        want = cpu(x[:LAST_CHECK_BATCH])
    errs = []
    for t, got, ref in zip(vgg.taps, taps, want):
        err = float((got[:LAST_CHECK_BATCH].cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        errs.append(err / scale)
        fail_unless(torch.isfinite(got).all() and err <= VGG_RTOL * scale,
                    f"VGG tap {t}: card vs CPU {err} (largest {scale})")
    print(json.dumps({
        "phase": "last_modules", "step": "vgg19_bn", "batch": LAST_BATCH,
        "taps": list(vgg.taps), "shapes": [list(t.shape) for t in taps],
        "ms": ms, "gflop": flops / 1e9,
        "tflops": flops / ms / 1e9, "fp32_peak_tflops": 67.0,
        "rel_err_vs_cpu": errs, "card": card_name}), flush=True)
    return vgg, cpu


def dfc_step(torch, model, vgg, x, eps):
    """The function JAX differentiates: a train-mode forward, the VGG
    features of the reconstructions and of the inputs, dfc_vae_loss, the
    backward into the DFCVAE. Returns the loss."""
    from attngan_torch.models.vae import dfc_vae_loss

    model.zero_grad(set_to_none=True)
    recons, mu, logvar = model(x, eps=eps)
    with torch.no_grad():
        want = vgg(x)
    loss = dfc_vae_loss(recons, x, mu, logvar, vgg(recons), want)
    loss.backward()
    return loss


class LeakyReluSides:
    """Within the block, every F.leaky_relu call records the side of 0 of
    its input (``replay`` None), or takes the sides that ``replay``
    recorded, in call order, and counts the inputs whose own side
    differs (``flips``: their number, and the largest |input| among them)."""

    def __init__(self, torch, replay=None):
        self.torch, self.replay = torch, replay
        self.sides, self.flips, self.max_flip = [], 0, 0.0

    def __enter__(self):
        functional = self.torch.nn.functional
        self.real = functional.leaky_relu

        def leaky_relu(x, negative_slope=0.01, inplace=False):
            if self.replay is None:
                self.sides.append((x > 0).detach())
                return self.real(x, negative_slope)
            side = self.replay.sides[len(self.sides)].to(x.device)
            self.sides.append(side)
            differ = (x > 0) != side
            if bool(differ.any()):
                self.flips += int(differ.sum())
                self.max_flip = max(self.max_flip,
                                    float(x.detach()[differ].abs().max()))
            return self.torch.where(side, x, x * negative_slope)

        functional.leaky_relu = leaky_relu
        return self

    def __exit__(self, *exc):
        self.torch.nn.functional.leaky_relu = self.real


def last_dfcvae(torch, vgg, vgg_cpu, card_name: str) -> None:
    """The default DFCVAE's deep-feature loss step at LAST_BATCH: finite
    loss and gradients, ms a step, peak MB, FLOPs; at LAST_CHECK_BATCH in
    fp32 against the CPU (loss, each gradient in norm)."""
    from attngan_torch.models.vae import DFCVAE
    from attngan_torch.utils.mfu import model_flops

    init = he_init_(torch, DFCVAE(), 20).state_dict()
    gen = torch.Generator().manual_seed(14)
    x = torch.rand((LAST_BATCH, 256, 256, 3), generator=gen) * 2 - 1
    eps = torch.randn((LAST_BATCH, 128), generator=gen)

    def model_on(device):
        m = DFCVAE()
        m.load_state_dict(init)
        return m.to(device, memory_format=torch.channels_last).train()

    model = model_on("cuda")
    xc, ec = x.cuda(), eps.cuda()
    flops, loss = model_flops(dfc_step, torch, model, vgg, xc, ec)
    fail_unless(math.isfinite(loss.item()) and all(
        torch.isfinite(p.grad).all() for p in model.parameters()),
        f"DFCVAE step: loss {float(loss)} or a gradient not finite")
    for _ in range(2):
        dfc_step(torch, model, vgg, xc, ec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(LAST_STEPS):
        loss = dfc_step(torch, model, vgg, xc, ec)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / LAST_STEPS * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    n = LAST_CHECK_BATCH
    card = model_on("cuda")
    cpu = model_on("cpu")
    with LeakyReluSides(torch) as card_sides:
        got = float(dfc_step(torch, card, vgg, xc[:n], ec[:n]))
    with LeakyReluSides(torch, replay=card_sides) as sides:
        want = float(dfc_step(torch, cpu, vgg_cpu, x[:n], eps[:n]))
    fail_unless(len(sides.sides) == len(card_sides.sides)
                and sides.max_flip <= SIDE_ATOL,
                f"DFCVAE leaky ReLU sides: {sides.flips} inputs off the "
                f"card's side, up to {sides.max_flip} from 0")
    # the bias of a conv that feeds a train-mode BN (every encoder conv and
    # decoder transposed conv) has a true gradient of 0, as the BN takes
    # the mean out: its computed one is rounding, held against
    # VAE_GRAD_FLOOR of the whole gradient's norm; every other leaf against
    # its own norm
    fail_unless(card.training and cpu.training, "DFCVAE not in train mode")
    pre_bn = {f"{seq}.{i}.bias" for seq in ("encoder", "decoder")
              for i in range(len(getattr(card, seq)))}
    total = torch.cat([q.grad.flatten() for q in cpu.parameters()]).norm()
    worst = {"own_norm": ("", 0.0), "pre_bn_bias": ("", 0.0)}
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        group = "pre_bn_bias" if name in pre_bn else "own_norm"
        scale = VAE_GRAD_FLOOR * total if name in pre_bn else q.grad.norm()
        rel = float((p.grad.cpu() - q.grad).norm() / scale)
        worst[group] = max(worst[group], (name, rel), key=lambda w: w[1])
    fail_unless(abs(got - want) <= VAE_LOSS_RTOL * abs(want),
                f"DFCVAE loss card {got} vs CPU {want}")
    fail_unless(all(w[1] <= VAE_GRAD_RTOL for w in worst.values()),
                f"DFCVAE gradient card vs CPU: {worst}")
    print(json.dumps({
        "phase": "last_modules", "step": "dfcvae_loss_step",
        "batch": LAST_BATCH, "latent": 128,
        "hidden": list(model.hidden_dims),
        "loss": float(loss), "ms_per_step": ms, "peak_mb": peak_mb,
        "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
        "fp32_vs_cpu": {"batch": n, "loss_card": got, "loss_cpu": want,
                        "worst_grad_rel": worst,
                        "sides_flipped": sides.flips,
                        "flipped_max_abs": sides.max_flip},
        "card": card_name}), flush=True)


def last_embedders(torch, corpus: str, card_name: str) -> None:
    """HierarchicalClusterer with VAEEmbedder(DFCVAE(), "dfc") and then
    VAEEmbedder(AutoEncoder(), "ae") (seeded He weights, the noise from
    VAE_EMBED_SEED) over the scene JPEGs on the card and on the CPU: the
    embeddings within VAE_EMBED_RTOL, one tree (same_tree), the same
    partitions at every k; img/s on the card."""
    import copy

    import numpy as np

    from attngan_torch.data.clusterer import (
        HierarchicalClusterer,
        adjusted_rand_index,
        cluster_ladder,
        determine_k_values,
    )
    from attngan_torch.data.dataset import preprocess_pyramid
    from attngan_torch.data.streaming import StreamingDataset
    from attngan_torch.models.vae import DFCVAE, AutoEncoder, VAEEmbedder

    dataset = StreamingDataset(corpus)
    pixels = torch.as_tensor(dataset._batch_pixels(dataset.records),
                             device="cuda")
    flip = torch.as_tensor([r.flip for r in dataset.records], device="cuda")
    images = preprocess_pyramid(pixels, flip)[256]
    del pixels
    ks = determine_k_values(1000, 5)
    for kind, model in (("dfc", he_init_(torch, DFCVAE(), 21)),
                        ("ae", he_init_(torch, AutoEncoder(), 22))):
        emb, seconds = {}, {}
        for dev in ("cuda", "cpu"):
            embedder = VAEEmbedder(copy.deepcopy(model), kind,
                                   seed=VAE_EMBED_SEED, device=dev)
            t = time.perf_counter()
            emb[dev] = HierarchicalClusterer(
                embedder=embedder, device=dev).embed_dataset(dataset)
            seconds[dev] = time.perf_counter() - t
        err = float(np.abs(emb["cuda"] - emb["cpu"]).max())
        scale = float(np.abs(emb["cpu"]).max())
        fail_unless(np.isfinite(emb["cuda"]).all()
                    and err <= VAE_EMBED_RTOL * scale,
                    f"{kind} embeddings: card vs CPU {err} (largest {scale})")
        embedder = VAEEmbedder(copy.deepcopy(model), kind,
                               seed=VAE_EMBED_SEED, device="cuda")
        embedder.embed(images[:64], 32)                 # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        embedder.embed(images, 32)
        embed_s = time.perf_counter() - t
        tree = same_tree(emb["cuda"], emb["cpu"])
        labels = {dev: cluster_ladder(e, ks, "agglomerative_complete")
                  for dev, e in emb.items()}
        split = [k for k, a, b in zip(ks, labels["cuda"], labels["cpu"])
                 if adjusted_rand_index(a, b) != 1.0]
        fail_unless(not split, f"{kind}: card and CPU partitions differ at "
                    f"k {split}")
        renumbered = [k for k, a, b in zip(ks, labels["cuda"], labels["cpu"])
                      if not np.array_equal(a, b)]
        print(json.dumps({
            "phase": "last_modules", "step": f"vae_embedder_{kind}",
            "records": len(dataset.records), "dims": emb["cuda"].shape[1],
            "img_per_s": len(dataset.records) / embed_s,
            "embed_dataset_s": seconds["cuda"],
            "cpu_embed_dataset_s": seconds["cpu"],
            "max_abs_err": err, "embedding_abs_max": scale,
            "partitions_equal_cpu": True, "renumbered_at_k": renumbered,
            **tree, "card": card_name}), flush=True)
    del images


def run_tool(torch, counters, name: str, argv: list) -> dict:
    """``attngan_torch.tools.<name>.main(argv)`` in this process, the
    launch counters set to 0 just before and read just after: its exit
    code (a SystemExit's), its printed JSON lines, seconds, launches."""
    import contextlib
    import importlib
    import io

    module = importlib.import_module(f"attngan_torch.tools.{name}")
    for c in counters.values():
        c.launches = 0
    out, code, message = io.StringIO(), 0, ""
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            module.main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (
                0 if e.code is None else 1)
            message = "" if isinstance(e.code, int) else str(e.code)
    torch.cuda.synchronize()
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith("{")]
    kinds = TOOL_KEYS[name]
    for line in lines:
        fail_unless(set(line) in kinds, f"{name}: keys {sorted(line)}")
    fail_unless(all(any(set(line) == k for line in lines) for k in kinds),
                f"{name}: a kind of line missing from {lines}")
    return {"code": code, "message": message, "lines": lines,
            "seconds": time.perf_counter() - t,
            "launches": {n: c.launches for n, c in counters.items()}}


def last_mfu(torch, counters, card_name: str) -> dict:
    """attngan_torch.tools.mfu_report on its three paths (the sampler at
    batch 64, the pretrain step at 64, the GAN step at 16): 0 < mfu <=
    MFU_MAX each; the host's launches exactly the calls' (K1 2, K2 2 a
    sampling call that the host launches: its first, eager, and its
    second, captured, the rest replaying the graph; K4 1, K5 2 a pretrain
    step; K1 2, K4 1, K5 2 a GAN step). Returns the launches."""
    run = run_tool(torch, counters, "mfu_report", MFU_ARGV)
    fail_unless(run["code"] == 0, f"mfu_report exited {run['code']}")
    calls = MFU_CALLS
    sampled = min(calls["sampler"], 2)          # eager, captured
    want = {name: 0 for name in counters}
    want.update(word_attention=2 * sampled + 2 * calls["gan"],
                upblock_fused_eval=2 * sampled,
                damsm_similarity=calls["damsm"] + calls["gan"],
                damsm_similarity_bwd_square=2 * calls["damsm"]
                + 2 * calls["gan"])
    fail_unless(run["launches"] == want,
                f"mfu_report launches {run['launches']}, expected {want}")
    for line in run["lines"]:
        fail_unless(line["mfu"] is not None and 0 < line["mfu"] <= MFU_MAX,
                    f"{line['path']}: mfu {line['mfu']}")
        print(json.dumps({
            "phase": "last_modules", "step": "mfu", **{
                k: line[k] for k in ("path", "sec_per_call", "windows_ms",
                                     "model_gflops_per_call",
                                     "achieved_tflops", "peak_tflops",
                                     "mfu", "device_kind")},
            "card": card_name}), flush=True)
    print(json.dumps({"phase": "last_modules", "step": "mfu_launches",
                      "launches": run["launches"],
                      "seconds": run["seconds"]}), flush=True)
    return run["launches"]


def last_tools(torch, counters, d: str, corpus: str, vgg_pth: str,
               card_name: str) -> dict:
    """Every other tool once at a small size, each one's exit code, JSON
    keys and seconds; the checkpoint tools on a chain of the port's CLIs
    over CHAIN_IMAGES of the scene JPEGs at full width with a capped
    vocabulary (32), so that classes collide; the FID tools at one seed
    and without real images (each FID is a ~10 s ``sqrtm`` of 2048^2 on
    the host). Returns the launches."""
    from attngan_torch.cli import pretrain, train
    from attngan_torch.data.synthetic import find_bundled_photos
    from attngan_torch.models.cnn_encoder import InceptionV3Trunk
    from attngan_torch.models.resnet import init_resnet18

    small = os.path.join(d, "chain_images")
    os.makedirs(small)
    for name in sorted(os.listdir(corpus))[:CHAIN_IMAGES]:
        shutil.copy(os.path.join(corpus, name), small)
    caps = os.path.join(d, "chain_caps.json")
    ckpt = os.path.join(d, "chain_ckpt")
    common = ["--data-root", small, "--batch-size", "16", "--captions-path",
              caps, "--checkpoint-dir", ckpt,
              "--image-dir", os.path.join(d, "chain_img")]
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    pretrain.main([*common, "--cluster", "--max-vocab-size", "32",
                   "--epochs", "1"])
    train.main([*common, "--epochs", "2", "--damsm-checkpoint",
                os.path.join(ckpt, "damsm")])
    torch.cuda.synchronize()
    chain = {n: c.launches for n, c in counters.items()}
    add(chain)
    print(json.dumps({"phase": "last_modules", "step": "tools_cli_chain",
                      "seconds": time.perf_counter() - t,
                      "launches": {k: v for k, v in chain.items() if v},
                      "gan_saves": sorted(s for s in os.listdir(
                          os.path.join(ckpt, "gan")) if s.startswith("step_")),
                      "card": card_name}), flush=True)

    photos = bool(find_bundled_photos())
    trunk_pth = os.path.join(d, "inception.pth")
    write_pretrained_trunk(torch, trunk_pth)
    resnet_pth = os.path.join(d, "resnet18.pth")
    torch.save({**init_resnet18(3).state_dict(),
                "fc.weight": torch.zeros(1000, 512),
                "fc.bias": torch.zeros(1000)}, resnet_pth)
    runs = [
        ("collision_check", ["--checkpoint", os.path.join(ckpt, "damsm"),
                             "--captions-path", caps, "--data-root", small,
                             "--batches", "4", "--batch-size", "16"]),
        ("fid_curve", ["--checkpoint", os.path.join(ckpt, "gan"),
                       "--captions-path", caps, "--data-root", small,
                       "--n", "64", "--max-real", "64", "--seeds", "1",
                       "--out", os.path.join(d, "fid_curve")]),
        ("int8_fid_run", ["--checkpoint", os.path.join(ckpt, "gan"),
                          "--captions-path", caps, "--n", "64"]),
        ("attnmaps_bench", ["--n", "256", "--png"]),
        ("cluster_quality_run", ["--num-images", "128", "--out",
                                 os.path.join(d, "cluster_quality")]),
        ("make_photo_corpus", ["--num-images", "8", "--out",
                               os.path.join(d, "photos")]),
        *(("convert_torch_weights", [kind, src, os.path.join(d, f"{kind}.pt")])
          for kind, src in (("inception", trunk_pth),
                            ("resnet18", resnet_pth),
                            ("vgg19_bn", vgg_pth))),
    ]
    for name, argv in runs:
        run = run_tool(torch, counters, name, argv)
        add(run["launches"])
        if name == "make_photo_corpus" and not photos:
            fail_unless(run["code"] != 0
                        and "no bundled photographs" in run["message"],
                        f"make_photo_corpus without photos: {run}")
        else:
            fail_unless(run["code"] == 0, f"{name} exited {run['code']}: "
                        f"{run['message']}")
        if name == "collision_check":
            fail_unless(run["lines"][-1]["total_excluded_pairs"] > 0,
                        f"collision_check: {run['lines'][-1]}")
        print(json.dumps({
            "phase": "last_modules", "step": f"tool_{name}",
            "argv": argv[:1] if name == "convert_torch_weights" else None,
            "exit_code": run["code"], "message": run["message"] or None,
            "seconds": run["seconds"], "json_lines": len(run["lines"]),
            "last_line": run["lines"][-1] if run["lines"] else None,
            "launches": {k: v for k, v in run["launches"].items() if v},
            "card": card_name}, default=str), flush=True)
    return total


def last_modules_phase(torch, card_name: str) -> dict:
    """Phase 12: VGG19-BN, the DFCVAE loss step, the VAE embedders in the
    captioner, MFU of the three paths and every other tool. Returns
    {kernel: launches over the phase's counted calls}."""
    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as d:
        vgg_pth = os.path.join(d, "vgg19_bn.pth")
        write_vgg_pth(torch, vgg_pth)
        vgg, vgg_cpu = last_vgg(torch, vgg_pth, card_name)
        last_dfcvae(torch, vgg, vgg_cpu, card_name)
        del vgg, vgg_cpu
        corpus = os.path.join(d, "scenes")
        os.makedirs(corpus)
        write_scene_corpus(corpus)
        last_embedders(torch, corpus, card_name)
        launches = last_mfu(torch, counters, card_name)
        for name, n in last_tools(torch, counters, d, corpus, vgg_pth,
                                  card_name).items():
            launches[name] = launches.get(name, 0) + n
    print(json.dumps({"phase": "last_modules", "step": "launches",
                      "launches": launches}), flush=True)
    return launches


def calibrate_bn(torch, state, tokens, lengths, passes: int = 40) -> None:
    """Random weights leave every BatchNorm at mean 0, var 1, which shrinks
    the signal at each GLU until the images are a flat gray. Train-mode
    forwards on random noise set the running statistics to the activations'
    own (momentum 0.1, 40 passes: 0.9^40 = 1.5% of the init left), so that
    eval-mode images have contrast and the comparisons see real values."""
    gen = torch.Generator("cuda").manual_seed(4)
    tokens = torch.as_tensor(tokens, device="cuda")
    lengths = torch.as_tensor(lengths, device="cuda")
    from attngan_torch.data.dataset import word_mask

    state.cuda().eval()
    state.generator.train()
    with torch.no_grad():
        words, sent = state.rnn(tokens, lengths)
        mask = word_mask(lengths, tokens.shape[1])
        for _ in range(passes):
            noise = torch.randn((tokens.shape[0], state.cfg.z_dim),
                                generator=gen, device="cuda")
            state.generator(noise, sent, words, mask, generator=gen)
    state.eval().cpu()


def device_kernel_counts(torch, fn) -> dict:
    """{kernel name: launches} of one call of ``fn`` on the card, by
    torch.profiler (CUPTI): a CUDA graph's kernels too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def serve(torch, card_name: str) -> dict:
    """Phase 3: the serving path through K2, fp32 against the CPU. Returns
    {kernel name: launches in its serving call} and the samplers for the
    throughput phase."""
    import numpy as np

    from attngan_torch.core.config import GanConfig, replace
    from attngan_torch.infer.sampler import (
        InferState,
        Sampler,
        load_infer_state,
        save_infer_state,
    )
    counters = kernel_counters()
    cfg = GanConfig()                       # full width, bf16, kernels on
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (BATCH, SEQ_LEN))
    lengths = rng.integers(1, SEQ_LEN + 1, BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "infer_state.pt")
        state = InferState(cfg, VOCAB)
        calibrate_bn(torch, state, tokens[:16], lengths[:16])
        save_infer_state(path, state)
        samplers = {
            True: Sampler(load_infer_state(path, cfg, device="cuda")),
            "plain": Sampler(load_infer_state(path, replace(
                cfg, fused_attention=False, fused_upsample=False),
                device="cuda"))}
        cfg32 = replace(cfg, compute_dtype="float32")
        gpu32 = Sampler(load_infer_state(path, cfg32, device="cuda"))
        cpu32 = Sampler(load_infer_state(path, cfg32, device="cpu"),
                        device="cpu")

    want = ("word_attention", "upblock_fused_eval")
    sampler = samplers[True]
    k2 = counters["upblock_fused_eval"]
    gen = torch.Generator("cuda").manual_seed(1)
    sampler.generate_from_tokens(tokens, lengths, generator=gen)  # warm
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    k2.resident_launches = 0
    # the shape's second call: the capture, then its first replay
    imgs = sampler.generate_from_tokens(tokens, lengths, generator=gen)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counters.items()}
    expect = {name: 2 if name in want else 0 for name in counters}
    fail_unless(counts == expect,
                f"serving: launches {counts}, expected {expect}")
    paths = (sampler.eager_calls, sampler.captures, sampler.replays)
    fail_unless(paths == (1, 1, 1), f"serving: eager calls, captures, "
                f"replays {paths}, expected (1, 1, 1)")
    # a replay launches nothing from the host: its kernels, by CUPTI
    replayed = device_kernel_counts(
        torch, lambda: sampler.generate_from_tokens(tokens, lengths,
                                                    generator=gen))
    mine = {k: sum(n for name, n in replayed.items() if k in name)
            for k in ("word_attention", "upblock")}
    fail_unless(mine == {"word_attention": 2, "upblock": 2}
                and sampler.replays == 2,
                f"serving: a replay ran {mine} ({sampler.replays} replays)")
    # the two UpBlocks at >= 64^2 (Ci=64 -> Co=32, bf16) take the
    # resident-weight kernel
    fail_unless(k2.resident_launches == 2,
                f"serving: resident launches {k2.resident_launches}, "
                f"expected 2")
    launches = {name: counts[name] for name in want}
    std = float(imgs.float().std())
    fail_unless(tuple(imgs.shape) == (BATCH, 256, 256, 3),
                f"image shape {tuple(imgs.shape)}")
    fail_unless(bool(torch.isfinite(imgs).all()), "non-finite images")
    fail_unless(float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0,
                "images outside [0, 1]")
    fail_unless(std > 0.02, f"flat images (std {std})")
    print(json.dumps({"phase": "serve", "fused_upsample": True,
                      "batch": BATCH, "shape": list(imgs.shape),
                      "launches": counts,
                      "resident_launches": k2.resident_launches,
                      "replay_kernels": mine,
                      "replay_kernels_all": sum(replayed.values()),
                      "mean": float(imgs.float().mean()), "std": std}),
          flush=True)

    # fp32 on the card (kernels, TF32 off) against the port's CPU run, on
    # every stage and attention map
    noise = torch.from_numpy(rng.standard_normal((2, cfg.z_dim),
                                                 dtype=np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, cfg.cond_dim),
                                               dtype=np.float32))
    # three calls on the card: eager, captured, replayed; the first and the
    # third against the CPU
    calls = [gpu32.generate_stages(tokens[:2], lengths[:2], noise, eps)
             for _ in range(3)]
    paths = (gpu32.eager_calls, gpu32.captures, gpu32.replays)
    fail_unless(paths == (1, 1, 2), f"fp32 on the card: eager calls, "
                f"captures, replays {paths}, expected (1, 1, 2)")
    ref = cpu32.generate_stages(tokens[:2], lengths[:2], noise, eps)
    errs = {}
    for label, got in (("eager", calls[0]), ("replayed", calls[2])):
        pairs = list(zip(got[0] + got[1], ref[0] + ref[1]))
        errs[label] = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
    print(json.dumps({"phase": "serve_fp32_vs_cpu", "batch": 2,
                      "max_abs_err": errs["eager"],
                      "max_abs_err_replayed": errs["replayed"],
                      "atol": IMAGE_ATOL,
                      "final_std": float(ref[0][-1].std())}), flush=True)
    for label, err in errs.items():
        fail_unless(err <= IMAGE_ATOL,
                    f"fp32 GPU ({label}) vs CPU images differ by {err}")
    return launches, samplers, tokens, lengths


def throughput(torch, samplers, tokens, lengths, card_name: str) -> None:
    """Phase 4: img/s over 5 windows of 10 calls, per path. The paths take
    their windows in turns, in an order that rotates each round, so that a
    drift of the card's clock or of the host's load falls on both."""
    paths = (("kernels_k2", True), ("plain", "plain"))
    gen = torch.Generator("cuda").manual_seed(2)
    for _, mode in paths:
        samplers[mode].generate_from_tokens(tokens, lengths, generator=gen)
    torch.cuda.synchronize()
    rates = {label: [] for label, _ in paths}
    for round_ in range(5):
        for label, mode in paths[round_ % 2:] + paths[:round_ % 2]:
            start = time.perf_counter()
            for _ in range(10):
                samplers[mode].generate_from_tokens(tokens, lengths,
                                                    generator=gen)
            torch.cuda.synchronize()
            rates[label].append(10 * BATCH / (time.perf_counter() - start))
    for label, windows in rates.items():
        median = statistics.median(windows)
        print(json.dumps({
            "phase": "throughput", "path": label, "batch": BATCH,
            "img_per_s": median, "windows": windows,
            "spread_pct": 100 * (max(windows) - min(windows)) / median,
            "card": card_name}), flush=True)


def timing_fence(torch, samplers, tokens, lengths, card_name: str) -> None:
    """Phase 4b: ``utils.timing.device_timeit`` of one serving call at the
    serving batch through K1 and K2, with CUDA events recorded before its
    first timed call and after its last: its seconds a call may not read
    below the events' by more than FENCE_SLACK (a clock stopped before the
    work ended would). ``time_ms`` of the same call (cold L2, median)
    beside it, for reference."""
    from attngan_torch.utils.timing import device_timeit

    sampler = samplers[True]
    gen = torch.Generator("cuda").manual_seed(3)

    def call():
        return sampler.generate_from_tokens(tokens, lengths, generator=gen)

    warmup, iters, calls, marks = 3, 20, [0], []

    def marked():
        calls[0] += 1
        if calls[0] == warmup + 1:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        out = call()
        if calls[0] == warmup + iters:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        return out

    seconds = device_timeit(marked, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    fail_unless(calls[0] == warmup + iters and len(marks) == 2,
                f"device_timeit made {calls[0]} calls")
    events_s = marks[0].elapsed_time(marks[1]) / 1e3 / iters
    print(json.dumps({"phase": "timing_fence", "path": "kernels_k2",
                      "batch": BATCH, "device_timeit_ms": seconds * 1e3,
                      "events_ms": events_s * 1e3,
                      "ratio": seconds / events_s, "time_ms": time_ms(call),
                      "card": card_name}), flush=True)
    fail_unless(seconds >= (1 - FENCE_SLACK) * events_s,
                f"device_timeit read {seconds * 1e3} ms a call, under the "
                f"events' {events_s * 1e3} ms")


def api_phase() -> None:
    """Every subpackage through its __init__, each name of its __all__
    resolved, and neither JAX nor the JAX package imported on the way."""
    names = {}
    for sub in SUBPACKAGES:
        module = importlib.import_module(f"attngan_torch.{sub}")
        for name in module.__all__:
            getattr(module, name)
        names[sub] = len(module.__all__)
    import attngan_torch

    loaded = sorted({"jax", "flax", "attngan_tpu"} & set(sys.modules))
    fail_unless(not loaded, f"the port's imports loaded {loaded}")
    print(json.dumps({"phase": "api", "version": attngan_torch.__version__,
                      "names": names}), flush=True)


def profile_calls(torch, fn, calls: int = 3) -> dict:
    """Runs ``fn`` once, then ``calls`` times under torch.profiler (CUPTI).
    Per call: wall and device-busy ms, the device's idle share, kernels
    launched, device time by kernel and by the PyTorch operator that
    launched it (which names the elementwise kernels, whose own names are
    generic), the optimizer's device time, and the host's time inside the
    CUDA runtime by call (a copy from pageable memory waits there for the
    stream to drain; a launch costs its own time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / calls
    events = prof.key_averages()
    per = 1e3 * calls                      # the profiler counts microseconds
    # a user range (the optimizer's) also shows as a device-side span over
    # its kernels: not a kernel, and counted once through them
    kernels = [(e.key, e.self_device_time_total / per, e.count / calls)
               for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    ops = [(e.key, e.self_device_time_total / per, e.count / calls)
           for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    runtime = [(e.key, e.self_cpu_time_total / per, e.count / calls)
               for e in events if e.key.startswith("cuda")]
    # the optimizer's host range holds its kernels: inclusive device time
    optimizer = [e.device_time_total / per for e in events
                 if e.key.startswith("Optimizer.step")
                 and e.device_type == DeviceType.CPU]
    busy = sum(ms for _, ms, _ in kernels)
    for rows in (kernels, ops, runtime):
        rows.sort(key=lambda k: -k[1])
    return {
        "wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy,
        "idle_share": 1 - busy / wall_ms if wall_ms else None,
        "kernels_per_call": sum(n for _, _, n in kernels),
        "optimizer_ms": optimizer[0] if optimizer else None,
        "top": [[name[:60], ms, n] for name, ms, n in kernels[:16]],
        "top_ops": [[name[:40], ms, n] for name, ms, n in ops[:16]],
        "host_runtime_ms": [[name, ms, n] for name, ms, n in runtime[:8]]}


def profile(torch, samplers, tokens, lengths, card_name: str) -> None:
    """--profile: 3 serving calls per path (``profile_calls``)."""
    for label, mode in (("kernels_k2", True), ("plain", "plain")):
        sampler = samplers[mode]
        gen = torch.Generator("cuda").manual_seed(3)
        stats = profile_calls(torch, lambda: sampler.generate_from_tokens(
            tokens, lengths, generator=gen))
        print(json.dumps({"phase": "profile", "path": label, "batch": BATCH,
                          **stats, "card": card_name}), flush=True)


def profile_pretrain(torch, trainer, state, batch, card_name: str) -> None:
    """--profile: 3 pretrain steps at batch 64 (``profile_calls``)."""
    stats = profile_calls(torch, lambda: trainer.train_step(state, batch))
    print(json.dumps({"phase": "profile", "path": "pretrain_step",
                      "batch": DAMSM_BATCH, **stats, "card": card_name}),
          flush=True)


# phase 4c: DF-GAN at the dfgan-serve-b64 cell's widths (nf 32, sentence
# 256, 18-word captions of a vocabulary of 5450, batch 64)
DFGAN_SEQ, DFGAN_VOCAB = 18, 5450


def dfgan_layers(rows: int):
    """(B, H, W, C, upsample) of each of a call's 12 DF layers (K7): each
    block's first on its input before the upsample, its second on c1's
    output."""
    from attngan_torch.models.dfgan import channel_pairs

    h = 4
    for cin, cout in channel_pairs(32):
        yield rows, h, h, cin, True
        yield rows, 2 * h, 2 * h, cout, False
        h *= 2


def df_chain(torch, x, consts, upsample):
    """One DF layer as GAN.py runs it eagerly in x's type (NCHW
    channels_last): the upsample, then two affines, each followed by a
    LeakyReLU, each a pass over the map."""
    import torch.nn.functional as F

    g0, b0, g1, b1 = (t.to(x.dtype)[:, :, None, None] for t in consts)
    nchw = x.permute(0, 3, 1, 2)

    def run():
        y = F.interpolate(nchw, scale_factor=2) if upsample else nchw
        y = F.leaky_relu(g0 * y + b0, 0.2)
        return F.leaky_relu(g1 * y + b1, 0.2)
    return run


def dfgan_phase(torch, card_name: str) -> tuple:
    """Phase 4c. Returns ({"dfblock": totals over the 12 layers of a call
    in bf16}, {"dfblock": launches in the sampler's capture call}), as
    ``serve`` returns its capture call's launches."""
    from attngan_torch.core.config import GanConfig, replace
    from attngan_torch.infer.sampler import InferState, Sampler
    from attngan_torch.ops.cuda_dfblock import dfblock, dfblock_cuda

    g = torch.Generator("cuda").manual_seed(21)
    total = dict(ms=0.0, plain_ms=0.0, chain_ms=0.0, bound_ms=0.0,
                 bytes_ms=0.0, flops_ms=0.0, max_abs_err=0.0, form="stream")
    cases = [(torch.bfloat16, s) for s in dfgan_layers(BATCH)]
    cases += [(torch.float32, s) for s in ((3, 7, 5, 32, True),
                                          (2, 9, 13, 64, False))]
    for dtype, (b, h, w, c, up) in cases:
        tname = str(dtype).split(".")[-1]
        x = (2 * torch.randn((b, h, w, c), generator=g, device="cuda")
             ).to(dtype)
        consts = [torch.randn((b, c), generator=g, device="cuda")
                  for _ in range(4)]
        before = dfblock_cuda.launches
        got = dfblock_cuda(x, *consts, upsample=up)
        torch.cuda.synchronize()
        fail_unless(dfblock_cuda.launches == before + 1,
                    f"dfblock counted {dfblock_cuda.launches - before}")
        want = dfblock(x, *consts, upsample=up)
        torch.testing.assert_close(got.float(), want.float(),
                                   **(TOL[tname] if dtype == torch.bfloat16
                                      else dict(atol=1e-5, rtol=0.0)))
        err = float((got.float() - want.float()).abs().max())
        line = {"phase": "dfgan", "step": "k7", "shape": [b, h, w, c],
                "upsample": up, "dtype": tname, "max_abs_err": err}
        if dtype == torch.bfloat16:
            moved = nbytes(x, got, *consts)
            flops = 8 * x.numel()
            bound = moved / HBM_BYTES_PER_S * 1e3
            ms = time_ms(lambda: dfblock_cuda(x, *consts, upsample=up))
            plain_ms = time_ms(lambda: dfblock(x, *consts, upsample=up))
            chain_ms = time_ms(df_chain(torch, x, consts, up))
            line.update(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms,
                        bound_ms=bound, roofline_pct=100 * bound / ms,
                        bytes=moved, card=card_name)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("chain_ms", chain_ms), ("bound_ms", bound),
                           ("bytes_ms", bound),
                           ("flops_ms", flops / FP32_FLOPS_PER_S * 1e3)):
                total[key] += v
            total["max_abs_err"] = max(total["max_abs_err"], err)
        print(json.dumps(line), flush=True)

    # the serving path: eager call, capture, replays; fp32 against the CPU
    cfg = GanConfig(generator="dfgan", seq_len=DFGAN_SEQ)
    torch.manual_seed(0)
    state = InferState(cfg, DFGAN_VOCAB)
    lengths = torch.randint(8, DFGAN_SEQ + 1, (BATCH,), generator=g,
                            device="cuda").cpu()
    tokens = torch.randint(1, DFGAN_VOCAB, (BATCH, DFGAN_SEQ), generator=g,
                           device="cuda")
    tokens = torch.where(torch.arange(DFGAN_SEQ, device="cuda")
                         < lengths.cuda()[:, None], tokens, 0)
    noise = torch.randn((BATCH, cfg.z_dim), generator=g, device="cuda")
    sampler = Sampler(state, device="cuda")
    rises, images = [], []
    for _ in range(3):                              # eager, capture, replay
        dfblock_cuda.launches = 0
        images.append(sampler.generate_from_tokens(tokens, lengths,
                                                   noise).clone())
        torch.cuda.synchronize()
        rises.append(dfblock_cuda.launches)
    fail_unless(rises == [12, 12, 0], f"DF-GAN K7 launches {rises}, "
                f"expected [12, 12, 0]")
    paths = (sampler.eager_calls, sampler.captures, sampler.replays)
    fail_unless(paths == (1, 1, 2), f"DF-GAN eager calls, captures, "
                f"replays {paths}, expected (1, 1, 2)")
    for got in images[1:]:
        torch.testing.assert_close(got, images[0], **TOL["bfloat16"])
    windows = []          # timed before the profiler count below
    for _ in range(4):
        start = time.perf_counter()
        for _ in range(10):
            sampler.generate_from_tokens(tokens, lengths, noise)
        torch.cuda.synchronize()
        windows.append(10 * BATCH / (time.perf_counter() - start))
    replayed = device_kernel_counts(torch, lambda: sampler.generate_from_tokens(
        tokens, lengths, noise))
    k7 = sum(n for k, n in replayed.items() if "dfblock" in k)
    fail_unless(k7 == 12, f"a DF-GAN replay ran K7 {k7} times")
    print(json.dumps({
        "phase": "dfgan", "step": "serve", "batch": BATCH,
        "k7_launches": rises, "paths": paths, "replay_k7": k7,
        "replay_kernels": sum(replayed.values()),
        "img_per_s": statistics.median(windows), "windows": windows,
        "reserved_bytes": torch.cuda.memory_reserved(),
        "card": card_name}), flush=True)
    del sampler, images
    cfg32 = replace(cfg, compute_dtype="float32")
    state32 = InferState(cfg32, DFGAN_VOCAB)
    state32.load_state_dict(state.state_dict())
    want = Sampler(state32, device="cpu").generate_from_tokens(
        tokens[:2].cpu(), lengths[:2], noise[:2].cpu())
    sampler = Sampler(state32, device="cuda")
    errs = []
    for _ in range(3):
        got = sampler.generate_from_tokens(tokens[:2], lengths[:2], noise[:2])
        errs.append(float((got.cpu() - want).abs().max()))
    fail_unless(max(errs) < IMAGE_ATOL, f"DF-GAN fp32 on the card against "
                f"the CPU: {errs}")
    print(json.dumps({"phase": "dfgan", "step": "fp32_vs_cpu", "batch": 2,
                      "max_abs_err": errs, "card": card_name}), flush=True)
    return {"dfblock": total}, {"dfblock": rises[1]}


# phase 4d: K8 at the lsun-serve-b64 cell's sites (GF 32, batch 64, bf16):
# (H, W, C, residual, sites a call); H = 0 is InitialStage's (B, C)
BN_SITES = ((0, 0, 16384, False, 1), (8, 8, 512, False, 1),
            (16, 16, 256, False, 1), (32, 32, 128, False, 1),
            (64, 64, 64, False, 1), (64, 64, 128, False, 2),
            (64, 64, 64, True, 2), (128, 128, 128, False, 2),
            (128, 128, 64, True, 2))


def bn_epilogue_phase(torch, card_name: str) -> tuple:
    """Phase 4d. Returns ({"bn_epilogue": totals over the 13 sites of a
    call in bf16}, {"bn_epilogue": launches in the sampler's capture
    call})."""
    from attngan_torch.core.config import GanConfig
    from attngan_torch.infer.sampler import InferState, Sampler
    from attngan_torch.ops.cuda_bn_epilogue import (
        bn_epilogue,
        bn_epilogue_cuda,
    )
    from attngan_torch.ops.layers import BatchNorm, glu

    g = torch.Generator("cuda").manual_seed(22)
    total = dict(ms=0.0, plain_ms=0.0, chain_ms=0.0, bound_ms=0.0,
                 bytes_ms=0.0, flops_ms=0.0, max_abs_err=0.0, form="stream")
    cases = [(torch.bfloat16, (BATCH, *site)) for site in BN_SITES]
    cases += [(torch.float32, site) for site in ((3, 7, 5, 32, False, 0),
                                                 (2, 9, 13, 64, True, 0))]
    for dtype, (b, h, w, c, residual, sites) in cases:
        tname = str(dtype).split(".")[-1]
        shape = (b, c) if h == 0 else (b, h, w, c)
        x = (2 * torch.randn(shape, generator=g, device="cuda")).to(dtype)
        skip = ((2 * torch.randn(shape, generator=g, device="cuda")).to(dtype)
                if residual else None)
        bn = BatchNorm(c).cuda().eval()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.1, generator=g)
            bn.running_mean.normal_(0.0, 0.5, generator=g)
            bn.running_var.uniform_(0.5, 1.5, generator=g)
        vectors = (bn.weight.detach(), bn.bias.detach(), bn.running_mean,
                   bn.running_var)
        before = bn_epilogue_cuda.launches
        got = bn_epilogue_cuda(x, *vectors, bn.eps, skip)
        torch.cuda.synchronize()
        counted = bn_epilogue_cuda.launches - before
        fail_unless(counted == 1, f"bn_epilogue counted {counted}")
        want = bn_epilogue(x, *vectors, bn.eps, skip)
        torch.testing.assert_close(got.float(), want.float(),
                                   **(TOL[tname] if dtype == torch.bfloat16
                                      else dict(atol=1e-5, rtol=0.0)))
        err = float((got.float() - want.float()).abs().max())
        line = {"phase": "bn_epilogue", "step": "k8", "shape": list(shape),
                "residual": residual, "dtype": tname, "max_abs_err": err}
        if dtype == torch.bfloat16:
            moved = nbytes(x, got, *vectors) + (nbytes(skip) if residual
                                                else 0)
            bound = moved / HBM_BYTES_PER_S * 1e3
            ms = time_ms(lambda: bn_epilogue_cuda(x, *vectors, bn.eps, skip))
            plain_ms = time_ms(lambda: bn_epilogue(x, *vectors, bn.eps,
                                                   skip))
            # the chain as the generator ran it before K8, on its NCHW
            # (channels_last) view
            nchw = x if h == 0 else x.permute(0, 3, 1, 2)
            if residual:
                skip_nchw = skip.permute(0, 3, 1, 2)
                chain_ms = time_ms(lambda: bn(nchw) + skip_nchw)
            else:
                chain_ms = time_ms(lambda: glu(bn(nchw)))
            line.update(sites=sites, ms=ms, plain_ms=plain_ms,
                        chain_ms=chain_ms, bound_ms=bound,
                        roofline_pct=100 * bound / ms, bytes=moved,
                        card=card_name)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("chain_ms", chain_ms), ("bound_ms", bound),
                           ("bytes_ms", bound)):
                total[key] += sites * v
            total["flops_ms"] += sites * 6 * x.numel() / FP32_FLOPS_PER_S * 1e3
            total["max_abs_err"] = max(total["max_abs_err"], err)
        print(json.dumps(line), flush=True)

    # the serving path at batch 64: eager call, capture, replay
    torch.manual_seed(0)
    state = InferState(GanConfig(), VOCAB)
    with torch.no_grad():
        for name, t in state.generator.named_buffers():
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5)
    lengths = torch.randint(1, SEQ_LEN + 1, (BATCH,), generator=g,
                            device="cuda").cpu()
    tokens = torch.randint(1, VOCAB, (BATCH, SEQ_LEN), generator=g,
                           device="cuda")
    sampler = Sampler(state, device="cuda")
    rises = []
    for _ in range(3):                              # eager, capture, replay
        bn_epilogue_cuda.launches = 0
        sampler.generate_from_tokens(tokens, lengths)
        torch.cuda.synchronize()
        rises.append(bn_epilogue_cuda.launches)
    fail_unless(rises == [13, 13, 0], f"K8 launches {rises}, expected "
                f"[13, 13, 0]")
    replayed = device_kernel_counts(
        torch, lambda: sampler.generate_from_tokens(tokens, lengths))
    k8 = sum(n for k, n in replayed.items() if "bn_epilogue" in k)
    fail_unless(k8 == 13, f"a replay ran K8 {k8} times")
    print(json.dumps({"phase": "bn_epilogue", "step": "serve",
                      "batch": BATCH, "k8_launches": rises, "replay_k8": k8,
                      "replay_kernels": sum(replayed.values()),
                      "totals": total, "card": card_name}), flush=True)
    return {"bn_epilogue": total}, {"bn_epilogue": rises[1]}


# the serving cells' (rows, seq) at K9: lsun-serve-b64, cub-serve-b1,
# dfgan-serve-b64; the vocabulary of the CUB cells
BILSTM_SHAPES = ((64, 5), (1, 18), (64, 18))
CUB_VOCAB = 5450


def bilstm_phase(torch, card_name: str) -> tuple:
    """Phase 4e. Returns ({"bilstm": K9's line at (64, 18), the largest
    error over the three shapes}, {"bilstm": launches in the sampler's
    capture call})."""
    from attngan_torch.core.config import GanConfig
    from attngan_torch.infer.sampler import InferState, Sampler
    from attngan_torch.models.rnn_encoder import BiLSTMEncoder
    from attngan_torch.ops import cuda_bilstm
    from attngan_torch.ops.cuda_bilstm import bilstm, bilstm_cuda

    g = torch.Generator("cuda").manual_seed(24)
    torch.manual_seed(0)
    rnn = BiLSTMEncoder(CUB_VOCAB, hidden_dim=256).cuda().eval()
    total = {"max_abs_err": 0.0, "form": "cluster"}
    for rows, seq in BILSTM_SHAPES:
        lengths = torch.randint(1, seq + 1, (rows,), generator=g,
                                device="cuda").cpu()
        lengths[0] = seq
        lengths[-1] = 0 if rows > 1 else seq
        tokens = torch.randint(1, CUB_VOCAB, (rows, seq), generator=g,
                               device="cuda")
        on_card = lengths.cuda()
        with torch.no_grad():
            args = rnn._projected(tokens)
            gates, rest = args[0], args[1:]
            before = bilstm_cuda.launches
            got = bilstm_cuda(gates, on_card, *rest)
            torch.cuda.synchronize()
            counted = bilstm_cuda.launches - before
            fail_unless(counted == 1, f"bilstm counted {counted}")
            want = bilstm(gates, on_card, *rest)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0.0)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ms = time_ms(lambda: bilstm_cuda(gates, on_card, *rest))
            plain_ms = time_ms(lambda: bilstm(gates, on_card, *rest))
            encoder_ms = time_ms(lambda: rnn(tokens, on_card))
            cudnn_ms = time_ms(lambda: rnn._forward_packed(
                tokens, lengths, None, (0, 1)))
        # each input byte read once, each output written once; the steps
        # these lengths need
        moved = nbytes(*gates, *got, *(t for pair in rest for t in pair),
                       on_card)
        flops = 2 * 2 * int(lengths.sum()) * 4 * 128 * 128
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOPS_PER_S * 1e3
        line = {"phase": "bilstm", "step": "k9", "rows": rows, "seq": seq,
                "rows_per_cluster": cuda_bilstm.rows_per_cluster(rows),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "encoder_ms": encoder_ms, "cudnn_ms": cudnn_ms,
                "bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
                "flops_ms": flops_ms, "bytes": moved, "card": card_name}
        print(json.dumps(line), flush=True)
        total["max_abs_err"] = max(total["max_abs_err"], err)
        if (rows, seq) == BILSTM_SHAPES[-1]:
            total.update({k: line[k] for k in (
                "ms", "plain_ms", "bound_ms", "bytes_ms", "flops_ms",
                "encoder_ms", "cudnn_ms")})

    # the serving path at batch 64: eager call, capture, replay
    torch.manual_seed(0)
    sampler = Sampler(InferState(GanConfig(), VOCAB), device="cuda")
    lengths = torch.randint(1, SEQ_LEN + 1, (BATCH,), generator=g,
                            device="cuda").cpu()
    tokens = torch.randint(1, VOCAB, (BATCH, SEQ_LEN), generator=g,
                           device="cuda")
    rises = []
    for _ in range(3):                              # eager, capture, replay
        before = bilstm_cuda.launches
        sampler.generate_from_tokens(tokens, lengths)
        torch.cuda.synchronize()
        rises.append(bilstm_cuda.launches - before)
    fail_unless(rises == [1, 1, 0], f"K9 launches {rises}, expected "
                f"[1, 1, 0]")
    replayed = device_kernel_counts(
        torch, lambda: sampler.generate_from_tokens(tokens, lengths))
    k9 = sum(n for k, n in replayed.items() if "bilstm" in k)
    fail_unless(k9 == 1, f"a replay ran K9 {k9} times")
    print(json.dumps({"phase": "bilstm", "step": "serve", "batch": BATCH,
                      "k9_launches": rises, "replay_k9": k9,
                      "replay_kernels": sum(replayed.values()),
                      "totals": total, "card": card_name}), flush=True)
    return {"bilstm": total}, {"bilstm": rises[1]}


# phase 4f: the dmgan-serve-b64 cell's widths
DMGAN_GF, DMGAN_SEQ = 64, 18


def memread_inputs(torch, g, b, hw, c, l, dtype):
    """Pixel rows, ReLU'd keys and values, a mask of lengths 1..L (one row
    at L) and the gate, as a memory stage gives them to the kernel."""
    h, w = hw
    images = torch.randn((b, h, w, c), generator=g, device="cuda").to(dtype)
    key, value = (torch.relu(torch.randn((b, l, c), generator=g,
                                         device="cuda")).to(dtype)
                  for _ in range(2))
    lengths = torch.randint(1, l + 1, (b,), generator=g, device="cuda")
    lengths[0] = l
    mask = (torch.arange(l, device="cuda") < lengths[:, None]).to(torch.int32)
    gate_w = torch.randn((2 * c,), generator=g, device="cuda") / (2 * c) ** 0.5
    gate_b = 0.05 * torch.randn((1,), generator=g, device="cuda")
    return images, key, value, mask, gate_w, gate_b


def memread_phase(torch, card_name: str) -> tuple:
    """Phase 4f. Returns ({"memory_read": totals over the two memory
    stages of a call in bf16}, {"memory_read": launches in the sampler's
    capture call})."""
    from attngan_torch.core.config import GanConfig
    from attngan_torch.infer.sampler import InferState, Sampler
    from attngan_torch.ops.attention import memory_read, word_attention
    from attngan_torch.ops.cuda_attention import (
        memory_read_cuda,
        word_attention_cuda,
    )
    from attngan_torch.ops.cuda_upblock import (
        form as upblock_form,
        upblock_fused_eval,
        upblock_fused_eval_cuda as k2,
    )
    from attngan_torch.ops.layers import conv, upsample_nearest_2x

    g = torch.Generator("cuda").manual_seed(25)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                 flops_ms=0.0, max_abs_err=0.0, form="stream")
    cases = [(torch.bfloat16, BATCH, (hw, hw), DMGAN_GF, DMGAN_SEQ)
             for hw in (64, 128)]
    cases += [(dtype, b, hw, c, l) for dtype in (torch.float32, torch.bfloat16)
              for b, hw, c in ((3, (7, 5), 64), (2, (9, 13), 32))
              for l in (1, 8, 18)]
    for dtype, b, hw, c, l in cases:
        tname = str(dtype).split(".")[-1]
        args = memread_inputs(torch, g, b, hw, c, l, dtype)
        before = memory_read_cuda.launches
        got = memory_read_cuda(*args)
        torch.cuda.synchronize()
        counted = memory_read_cuda.launches - before
        fail_unless(counted == 1, f"memory_read counted {counted}")
        want = memory_read(*args)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   **TOL[tname])
        torch.testing.assert_close(got[1], want[1], **ATTN_TOL)
        err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
        line = {"phase": "memread", "step": "k10", "shape": [b, *hw, c],
                "words": l, "dtype": tname, "max_abs_err": err}
        if b == BATCH:
            moved = nbytes(*args, *got)
            # scores and the read, 2 L C each; the gate's dot and blend
            flops = b * hw[0] * hw[1] * (4 * l * c + 7 * c)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / BF16_FLOPS_PER_S * 1e3
            ms = time_ms(lambda: memory_read_cuda(*args))
            plain_ms = time_ms(lambda: memory_read(*args))
            bound = max(bytes_ms, flops_ms)
            line.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        roofline_pct=100 * bound / ms, bytes=moved,
                        attn_max=float(got[1].max()),
                        attn_top_mean=float(got[1].amax(1).mean()),
                        card=card_name)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound), ("bytes_ms", bytes_ms),
                           ("flops_ms", flops_ms)):
                total[key] += v
            total["max_abs_err"] = max(total["max_abs_err"], err)
        print(json.dumps(line), flush=True)

    # K2 at DM-GAN's memory stages' UpBlocks: (Ci, Co) = (128, 64)
    ci, co = 2 * DMGAN_GF, DMGAN_GF
    for hw in (64, 128):
        x = torch.randn((BATCH, hw, hw, ci), generator=g,
                        device="cuda").to(torch.bfloat16)
        weight = torch.randn((2 * co, ci, 3, 3), generator=g,
                             device="cuda") * (9 * ci) ** -0.5
        bn_k = torch.rand(2 * co, generator=g, device="cuda") + 0.5
        bn_b = 0.1 * torch.randn(2 * co, generator=g, device="cuda")
        before = (k2.launches, k2.resident_launches, k2.cluster_launches)
        got = k2(x, weight, bn_k, bn_b)
        torch.cuda.synchronize()
        form = upblock_form(x.dtype, ci, co)
        fail_unless(form == "cluster" and (
            k2.launches, k2.resident_launches, k2.cluster_launches) == (
                before[0] + 1, before[1], before[2] + 1),
            f"K2 at ({ci}, {co}): the {form} form")
        want = upblock_fused_eval(x, weight, bn_k, bn_b)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL["bfloat16"])
        fail_unless(torch.equal(k2(x, weight, bn_k, bn_b), got),
                    f"K2's cluster form at {hw}^2: other bits on a relaunch")
        moved = nbytes(x, weight.to(torch.bfloat16), bn_k, bn_b, got)
        flops = 2 * BATCH * (2 * hw) ** 2 * (2 * co) * (4 * ci)
        bound = max(moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        ms = time_ms(lambda: k2(x, weight, bn_k, bn_b))
        plain_ms = time_ms(lambda: upblock_fused_eval(x, weight, bn_k, bn_b))
        chain = upblock_chain(torch, weight, bn_k, bn_b, torch.bfloat16)
        nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            chain_ms = time_ms(lambda: chain(nchw))
            # the same chain with K8's BN -> GLU, as ops/layers.py::UpBlock
            # runs it below 64^2
            chain_k8_ms = time_ms(lambda: chain.bn.forward_glu(
                conv(upsample_nearest_2x(nchw), chain.conv, torch.bfloat16),
                True))
        fail_unless(ms < chain_ms, f"K2's cluster form at {hw}^2: {ms} ms, "
                    f"cuDNN's chain {chain_ms} ms")
        print(json.dumps({
            "phase": "memread", "step": "k2", "shape": [BATCH, hw, hw, ci],
            "co": co, "form": form,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": ms, "bound_ms": bound, "roofline_pct": 100 * bound / ms,
            "plain_ms": plain_ms, "chain_ms": chain_ms,
            "chain_k8_ms": chain_k8_ms, "card": card_name}), flush=True)

    # K1's AttnGAN form at the serving shapes, timed as phase 2 times it
    for l in (SEQ_LEN, DMGAN_SEQ):
        ms = []
        for hw in (64, 128):
            images = torch.randn((BATCH, hw, hw, 32), generator=g,
                                 device="cuda").to(torch.bfloat16)
            words = torch.randn((BATCH, l, 32), generator=g,
                                device="cuda").to(torch.bfloat16)
            lengths = torch.randint(1, l + 1, (BATCH,), generator=g,
                                    device="cuda")
            mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]
                    ).to(torch.int32)
            got = word_attention_cuda(images, words, mask)
            want = word_attention(images, words, mask)
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       **TOL["bfloat16"])
            torch.testing.assert_close(got[1], want[1], **ATTN_TOL)
            ms.append(time_ms(lambda: word_attention_cuda(images, words,
                                                          mask)))
        print(json.dumps({"phase": "memread", "step": "k1_attngan",
                          "batch": BATCH, "words": l, "gen2_ms": ms[0],
                          "gen3_ms": ms[1], "ms": sum(ms),
                          "card": card_name}), flush=True)

    # the serving path at batch 64: eager call, capture, replays
    cfg = GanConfig(generator="dmgan", gf_dim=DMGAN_GF, seq_len=DMGAN_SEQ)
    torch.manual_seed(0)
    sampler = Sampler(InferState(cfg, CUB_VOCAB), device="cuda")
    lengths = torch.randint(8, DMGAN_SEQ + 1, (BATCH,), generator=g,
                            device="cuda").cpu()
    tokens = torch.randint(1, CUB_VOCAB, (BATCH, DMGAN_SEQ), generator=g,
                           device="cuda")
    tokens = torch.where(torch.arange(DMGAN_SEQ, device="cuda")
                         < lengths.cuda()[:, None], tokens, 0)
    rises, images, k2_rises = [], [], []
    for _ in range(3):                              # eager, capture, replay
        before = memory_read_cuda.launches, k2.cluster_launches
        images.append(sampler.generate_from_tokens(tokens, lengths).clone())
        torch.cuda.synchronize()
        rises.append(memory_read_cuda.launches - before[0])
        k2_rises.append(k2.cluster_launches - before[1])
    fail_unless(rises == [2, 2, 0], f"DM-GAN memory reads {rises}, "
                f"expected [2, 2, 0]")
    fail_unless(k2_rises == [2, 2, 0], f"DM-GAN K2 cluster launches "
                f"{k2_rises}, expected [2, 2, 0]")
    paths = (sampler.eager_calls, sampler.captures, sampler.replays)
    fail_unless(paths == (1, 1, 2), f"DM-GAN eager calls, captures, "
                f"replays {paths}, expected (1, 1, 2)")
    for got in images[1:]:
        torch.testing.assert_close(got, images[0], **TOL["bfloat16"])
    windows = []          # timed before the profiler count below
    for _ in range(4):
        start = time.perf_counter()
        for _ in range(10):
            sampler.generate_from_tokens(tokens, lengths)
        torch.cuda.synchronize()
        windows.append(10 * BATCH / (time.perf_counter() - start))
    replayed = device_kernel_counts(
        torch, lambda: sampler.generate_from_tokens(tokens, lengths))
    k10 = sum(n for k, n in replayed.items() if "memread" in k)
    fail_unless(k10 == 2, f"a DM-GAN replay ran the memory form {k10} times")
    k2_cluster = sum(n for k, n in replayed.items()
                     if "upblock_cluster" in k)
    fail_unless(k2_cluster == 2, f"a DM-GAN replay ran K2's cluster form "
                f"{k2_cluster} times")
    print(json.dumps({
        "phase": "memread", "step": "serve", "batch": BATCH,
        "memread_launches": rises, "paths": paths, "replay_memread": k10,
        "k2_cluster_launches": k2_rises, "replay_k2_cluster": k2_cluster,
        "replay_kernels": sum(replayed.values()),
        "img_per_s": statistics.median(windows), "windows": windows,
        "reserved_bytes": torch.cuda.memory_reserved(),
        "totals": total, "card": card_name}), flush=True)
    return {"memory_read": total}, {"memory_read": rises[1]}


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2], sys.argv[3], sys.argv[4:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # the port lives beside this script; without it the import fails
    from attngan_torch.ops import _build

    card_name = card()
    print(card_name, flush=True)
    api_phase()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (path, seconds, log) in built.items():
        usage = ptxas_usage(log)
        print(json.dumps({"phase": "build", "library": os.path.basename(path),
                          "nvcc_s": seconds,
                          "ptxas": ["kernel, registers, spill stores, "
                                    "spill loads", *usage]}), flush=True)
        for kernel, _, stores, loads in usage:
            fail_unless(not kernel.startswith(NO_SPILL)
                        or stores == loads == 0,
                        f"{kernel} spills ({stores} / {loads} bytes)")
    print(json.dumps({"phase": "build", "total_s": time.perf_counter() - t0}),
          flush=True)

    seconds = {"build": time.perf_counter() - t0}

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    totals = check_kernels(torch, card_name)
    totals.update(check_damsm_kernels(torch, card_name))
    lap("kernel_checks")
    launches, samplers, tokens, lengths = serve(torch, card_name)
    throughput(torch, samplers, tokens, lengths, card_name)
    timing_fence(torch, samplers, tokens, lengths, card_name)
    if "--profile" in sys.argv[1:]:
        profile(torch, samplers, tokens, lengths, card_name)
    del samplers
    lap("serving")
    dfgan_totals, dfgan_launches = dfgan_phase(torch, card_name)
    totals.update(dfgan_totals)
    lap("dfgan")
    bn_totals, bn_launches = bn_epilogue_phase(torch, card_name)
    totals.update(bn_totals)
    lap("bn_epilogue")
    bilstm_totals, bilstm_launches = bilstm_phase(torch, card_name)
    totals.update(bilstm_totals)
    lap("bilstm")
    memread_totals, memread_launches = memread_phase(torch, card_name)
    totals.update(memread_totals)
    lap("memread")
    damsm_launches, trainer, state, batch = pretrain(torch, card_name)
    pretrain_throughput(torch, trainer, state, batch, card_name)
    if "--profile" in sys.argv[1:]:
        profile_pretrain(torch, trainer, state, batch, card_name)
    del trainer, state, batch
    lap("pretrain")
    gan_launches, trainer, state, batch = gan(torch, card_name)
    bare_gan_rate = gan_throughput(torch, trainer, state, batch, card_name)
    if "--profile" in sys.argv[1:]:
        stats = profile_calls(torch, lambda: trainer.train_step(state, batch))
        print(json.dumps({"phase": "profile", "path": "gan_step",
                          "batch": trainer.cfg.batch_size, **stats,
                          "card": card_name}),
              flush=True)
    del trainer, state, batch
    lap("gan")
    print(json.dumps({"phase": "host_packages", **{
        name: importlib.util.find_spec(name) is not None
        for name in ("PIL", "matplotlib", "sklearn")}}), flush=True)
    loop_launches = loops_phase(torch, card_name, bare_gan_rate)
    lap("loops")
    captioner_launches = captioner_phase(torch, card_name)
    lap("captioner")
    options_launches = pretrain_options_phase(torch, card_name)
    lap("pretrain_options")
    dp_launches = data_parallel_phase(torch, card_name)
    lap("data_parallel")
    side_launches = side_tiers_phase(torch, card_name)
    lap("side_tiers")
    last_launches = last_modules_phase(torch, card_name)
    lap("last_modules")
    print(json.dumps({"phase": "seconds", **seconds}), flush=True)
    # launches summed over every path: serving, DF-GAN, the BN epilogue's,
    # the BiLSTM's and DM-GAN's serving calls, pretrain, GAN step, loops,
    # captioner, pretrain options, data parallel (every rank's), side
    # tiers, the last modules (MFU and the tools)
    for counted in (dfgan_launches, bn_launches, bilstm_launches,
                    memread_launches, damsm_launches, gan_launches, loop_launches,
                    captioner_launches, options_launches, dp_launches,
                    side_launches, last_launches):
        for name, n in counted.items():
            launches[name] = launches.get(name, 0) + n

    replaces = {
        "word_attention": ("attngan_torch/csrc/word_attention.cu",
                           "attngan_tpu/ops/pallas_attention.py:51"),
        "upblock_fused_eval": ("attngan_torch/csrc/upblock.cu",
                               "attngan_tpu/ops/pallas_upblock.py:128"),
        "damsm_similarity": ("attngan_torch/csrc/damsm_similarity.cu",
                             "attngan_tpu/ops/pallas_damsm.py:265"),
        "damsm_similarity_bwd_square": (
            "attngan_torch/csrc/damsm_similarity.cu",
            "attngan_tpu/ops/pallas_damsm.py:297"),
        "damsm_similarity_bwd_tiled": (
            "attngan_torch/csrc/damsm_similarity.cu",
            "attngan_tpu/ops/pallas_damsm.py:340"),
        "dfblock": ("attngan_torch/csrc/dfblock.cu", None),   # DF-GAN's
        # XLA fuses the eval BatchNorm epilogue on the TPU
        "bn_epilogue": ("attngan_torch/csrc/bn_epilogue.cu", None),
        # the JAX package scans the BiLSTM in XLA
        "bilstm": ("attngan_torch/csrc/bilstm.cu", None),
        # K1's memory form: DM-GAN's (the JAX package has no DM-GAN)
        "memory_read": ("attngan_torch/csrc/word_attention.cu", None),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        t = totals[name]
        fail_unless(launches.get(name, 0) > 0, f"{name} never launched")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["flops_ms"]
            else "operations",
            "library_ms": None,
            **{k: t[k] for k in ("chain_ms", "form", "tc_bound_ms",
                                 "encoder_ms", "cudnn_ms") if k in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_name, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
