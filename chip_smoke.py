"""Chip smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `latent_diffusion_speech_tpu_torch/csrc`
with nvcc (sm_90a), then:

1. holds each kernel against its plain PyTorch version on the card at the
   shapes the serve path gives it (K4 attention_fwd at the four UNet
   resolutions at B=1 and B=4 and T=1024; K5 flash_attention at the four UNet resolutions
   at B=1 and B=4 and T=1024, and at the JAX kernel's contract shapes,
   causal with Tq != Tkv included; both also at head dim 8, the general
   denoiser's block zoo's, with H = 32-64 at the four resolutions at B=1
   and B=4; K1 ar_decode at the flagship decoder
   width, B in {1, 4}, N=430 (f32 greedy also with the end gate; bf16
   logits also at N=1024), and at the HTTP server's batch sizes B in
   {2, 8}, N=1024, over 64 encoder rows (bf16 logits and sampled tokens),
   timed at N=430 and N=1024 with its cluster plan,
   cudaOccupancyMaxActiveClusters and the wrapper's host time, and with the
   encoder K/V in shared memory against device memory where the plan puts
   it in shared memory; the fused UNet forward unet_fwd (K2/K3) at
   the flagship width, T in {64, 448, 1024}, f32 and bf16, with its
   per-group phase breakdown at T=448 beside the earlier design's), and
   times each beside its plain version, its bound and, where one exists, the one
   PyTorch call that computes the same function.  The bf16 K4 forward and
   K5, on the tensor cores, are also held to their CUDA-core (SIMT)
   kernels in the same call: back-to-back and device times (50 calls
   captured in a CUDA graph and replayed) of the new kernel, the SIMT
   kernel and F.scaled_dot_product_attention at every shape, new and SIMT
   in turns; the share of bf16 outputs that differ from the plain version;
   the host time a call of each wrapper; the HMMA instructions of each
   tensor-core kernel (cuobjdump -sass);
2. drives the port's serve path once at flagship width with seeded random
   weights (bf16): one `TTSPipeline.tts` and one `tts_batch` of 4 English
   requests, with per-stage wall times (the tts's lm_decode split into the
   encoder with the cross K/V, the K1 wrapper's host time and the kernel),
   and shows through the kernels' launch counters that the path ran
   through K1 and K4;
3. drives the same path in the fused configuration
   (`Unit2MelSystem(unet_impl="pallas")`, the same weights): one `tts`
   (20 unet_fwd launches, no K4) and one `tts_batch` of 4 (B>1 stays on the
   eager module: K4, no unet_fwd), with its stage times beside the eager
   ones, and one more `tts` with UniPC (the shipped config's sampler):
   20 unet_fwd launches, a finite waveform;
4. drives the path through K5: the general (reference-layout) denoiser,
   `Unit2MelConfig(denoiser="general", attn_impl="pallas")`, at full width,
   one `tts` and one `tts_batch` of 4, and the flagship with
   attn_impl="pallas", one `tts`: 640 K5 launches per 20-step diffusion
   call, no K4, no unet_fwd, no call routed to the plain attention, with
   per-stage wall times;
5. checks the 20-step diffusion + vocoder against the same run with the
   plain attention, in f32, on a short input, for the flagship with K4 and
   for the general denoiser with K5; `zoo`: the general denoiser's block
   zoo, four configurations at the shipped widths that between them reach
   every block type (attention heads of dim 8), each one bf16 `tts` and
   one `tts_batch` of 4 through K5 and one `tts` through K4, the launches
   equal to the attention modules x 20 evaluations, no plain route, and in
   f32 against the plain attention; then the fused configuration's
   diffusion trajectory against the eager one from the same x_init
   (DPM-Solver++ in bf16 and f32, UniPC in bf16);
6. holds the training kernels against their plain versions at the shapes
   the diffusion trainer gives them (K4 attention_bwd at B=48, H=8 and the
   four UNet resolutions of a 1 s crop, f32 and bf16, two calls
   bit-identical, its 16-key tiles against 32-key tiles at T=11; K6 kmeans_argmin at the contract shapes and at N=4128,
   K=4096, D=1280), timed beside their plain versions, bounds, PyTorch
   yardsticks and the earlier kernels' times on the same card;
7. serve_entry: the port's serve entry points as a user starts them, on
   `configs/config.yaml` at flagship width with seeded weights (no
   `pretrain/`): `cli/infer_tts.py::build_pipeline` behind `TTSServer` and
   the HTTP handler of `cli/serve.py` (the CLI's defaults; UniPC at 20
   steps, SERVE_SPEEDUP, where the config serves 100): six concurrent EN /tts requests coalesced into fewer batches,
   one chunked /tts/stream of three pieces, a ZH request answered 500
   (F2), /healthz and /metrics against the server's counters, with one K1
   launch a batch and 32 K4 launches a denoiser evaluation; every other
   sampler the CLIs can name once at T=64 and SERVE_SPEEDUP (DDPM's 1000
   steps through the fused kernel);
   the `infer_tts` CLI as a subprocess, plain and --long; K1 also at the
   server's batch sizes B=2 and B=8 (N=1024) in step 1;
8. svc: SVC long-audio inference, `TTSPipeline.infer_from_long_audio`
   through `cli/infer_tts.py::build_pipeline` (the shipped config) with a
   `UnitsEncoder` over a seeded full-width Whisper-large-v3 encoder (bf16),
   on a 32.5 s synthetic 44.1 kHz WAV (three voiced stretches of 6, 9 and
   14 s between true silences): per-step times (slicing, volume mask,
   resampling, log-mel, encoder, alignment, diffusion, vocoder, stitch),
   RTF, the output's rate, length, exact zeros in the silences and
   finiteness, the units' shape, 32 K4 launches a denoiser evaluation and
   no other kernel; the `infer_svc` CLI as a subprocess, beside the
   encoder in bf16 against f32 and stages 10 and 19 over a layout of 8 files (one K6
   launch a file, ids against the plain version); K4 at the phase's shapes
   (T up to 1344) and K6 at stage 19's ragged N, against their plain
   versions and timed;
9. trains the flagship Unit2Mel in f32 at B=48 through the port's training
   entry point (`cli/train_diffusion.py::build` + `DiffusionTrainer.train`,
   `configs/config.yaml` with the k-means unit snap) on a seeded synthetic
   data layout: one step's loss and gradients against the same step with
   the plain attention and argmin, 3 steps, a save, a resume and 12 more
   steps, with the launch counts per step (32 K4 forward, 32 K4 backward,
   1 K6), the step time, samples/s, `train/mfu` and the kernels' share of a
   step, and loads the saved checkpoint back through
   `infer/load.py::load_native_pipeline`; then the trainer's options from
   the trained weights: gradient_accumulation_steps=2 (two micro-steps
   against one update from the mean of their gradients, then the loop
   with `train/mfu` in metrics.jsonl), the learned VectorQuantize(1280,
   4096) (K4 and no K6; utilisation, the codebook sidecar), bf16 (32 bf16
   K4 forward and 32 bf16 K4 backward launches a step; loss and step time
   beside f32), remat (gradients equal, peak memory) and
   `validate_full(vocoder=)` (a WAV and the spectrogram triptych);
10. lm_train: trains the shipped RoFormer at full width (4 + 1 layers,
   C=256, H=8, FF 512, V=4099, B=32, f32, dropout 0.1) through stage 21
   (`cli/train_lm.py`: `build`, then `main` as a user runs it) on a
   synthetic EN corpus of 96 + 32 utterances written by the port's stages
   15 and 16 (tokens in stage 19's format, 150-1022 a sequence: the 448-,
   672- and 1024-token buckets) with 2 spawn loader workers and
   length-sorted batches: one step on the card (dropout off) against the
   same step on the CPU (loss rtol 1e-5, every gradient atol 1e-5 / rtol
   1e-4), the workers' first batches against the threads', 15 steps
   uninterrupted against 3, a save, a resume and 12 more (bitwise equal),
   `evaluate` and `validate_audio` once (1 K1 and 640 K4 launches); then
   serves the checkpoint through `build_pipeline(lm_ckpt=)` in bf16 (one
   `tts`: 1 K1, 640 K4; K1's greedy decode at the trained weights against
   the plain decode, as check_k1 holds it) and the `infer_tts --lm-model`
   CLI as a process; prints the step time, samples/s, non-pad tokens/s,
   the device's busy time, launches and largest kernels a step, each
   bucket's step, the smoke corpus's padding share with and without length
   sorting, validate_audio's and the serve's times, `train/mfu` of every
   logged step, and gradient_accumulation_steps=2: 5 micro-steps against 3,
   a save half-way through an update, a resume and 2 more (bitwise equal);
11. data_path: the shipped config's data stages, each through its `main`
   on the card, on a synthetic voiced corpus written as 44.1 kHz WAVs (4
   speakers, one with a non-numeric name, 64 files of 6-8 s and one of
   31 s): stages 00-02 (the long file dropped, speakers renumbered, 12
   files moved to the validation set), 15, 10 (seeded Whisper-large-v3,
   bf16), 11 (the full-width 44.1 kHz codec encoder, f32: ms a file), 17
   (the 4096 x 1280 codebook over >= 16384 unit frames: minibatches of
   8192, 4 epochs, one K6 launch a step; inertia and ms a step), 18 (EN),
   19 with the fitted codebook, 3 diffusion training steps on the stage-11
   latents (K4 forward and backward, K6), then a reference-layout
   `encoder.pth` / `decoder.pth` pair at full width served with the
   trained checkpoint and the codebook through `build_pipeline` (one EN
   `tts`); then the card against the CPU: one file's stage-11 latents, one
   stage-17 step (ids and counts equal, centroids within 1e-5 of their
   scale), a second fit bitwise equal to the first, and K6 at N = 8192
   against its plain version, timed beside cuBLAS's product and its bound;
   after stages 10 and 11, `cli/batch_preprocess.py`'s main (B=8) over
   the same files linked into a second root: its wall and ms a file
   beside stages 10 + 11's, its batches and buckets, unit frame counts
   and units against stage 10's, the latents' frame counts and their gap
   from stage 11's (R7, reported);
12. units_alt: the three other unit encoders (HuBERT-soft 256-d, XLSR-53
   and w2v-BERT 2.0 1024-d) seeded at full width through
   `UnitsEncoder.encode` on one 10 s clip, each in bf16 and f32 (the units'
   shape at 50 fps, finiteness, bf16 against f32, ms a call); the native
   reader built into one empty directory by two spawn processes at once;
   HuBERT-soft through stages 10, 17 (the shipped 4096-code codebook over
   the 256-d units, one K6 launch a step) and 19 (one K6 launch a file, ids
   against the plain version) over 8 files of 41-45 s, and one SVC call
   through `cli/infer_svc.py`'s path (a seeded 256-input `Unit2Mel`, 32 K4
   launches a denoiser evaluation, the RTF); K6 at D = 256 and 1024 against
   its plain version, timed beside cuBLAS and its bound; the diffusion
   trainer's input at B=48 on train_slice's layout three ways (items,
   `fast_batch`, `device_collate` with bf16 units): the loader's ms a batch
   and the median step; with only_mean, one device-collated step's loss and
   gradients against the host-collated step (atol 1e-5) and its launches
   (32 K4 forward, 32 K4 backward, 1 K6);
13. migrate: a full-width reference artifact set written by the inverses
   of the importers (`reference_unit2mel_state`, `reference_roformer_state`,
   `reference_codec_state`; the sklearn codebook dict; a Whisper-large-v3
   wrapper cut to 2 layers) served through
   `infer/load.py::load_reference_pipeline` in bf16 (one EN `tts`: 1 K1
   launch, 32 K4 launches a denoiser evaluation) and checked by
   `cli/verify_import.py` (in-process on the codebook: 1 K6 launch); the
   set in f32 on the card against the CPU (the Unit2Mel forward, K1's
   greedy logits); `verify_import` for every kind, CPU goldens then the
   card, each within 1e-3 of its golden (in this process; the card's
   unit2mel run also as a process, checked after the last phase);
14. codec_train: the HiFi-VAEGAN codec GAN through `cli/train_codec.py::main`
   as a user runs it, at the shipped 44.1 kHz width (hop 512, 128 latent
   channels; the `CodecTrainer` bank: STFT scales 1024 and 512, periods
   2-11), B=16 crops of 32256 samples from a synthetic WAV layout: 2
   steps, a save, a resume and 2 more, then the same with --use-vq; one
   D + G step on the card against the same step on the CPU (B=1, the same
   seeded weights and latent noise, TF32 off); the step time, samples/s,
   the VQ's codebook utilisation and the peak memory.  The codec path runs
   no custom kernel (the JAX package computes it outside any Pallas kernel);
15. llama_text: the Llama LM at the JAX `LlamaConfig`'s geometry (768
   wide, 4 heads, 4 layers, FFN 512, V = 4207) through stage 21 with
   `type: llama` on `lm_train`'s corpus (B=32, f32): dense (20.6 M) and MoE
   (E=8, top-2, cf 1.25; 53.7 M), each 3 steps, a save, a resume and 3
   more against an uninterrupted run (bitwise), one step on the card
   against the CPU (with experts, the expert choices that differ are
   counted), the median step, non-pad tokens/s, `train/mfu`, peak memory
   and the dropped share of the routed choices; the dense run evaluates
   and synthesises validation audio once; its checkpoint served through
   `build_pipeline(lm_ckpt=)` in bf16 (one `tts` of 430 decode steps,
   plain PyTorch as in the JAX package: no K1, 640 K4 launches; the LM's
   ms a step and the stage walls; `tts_batch` raises, R11) and greedy
   tokens (128 steps) on the card against the CPU's; `verify_import` on the checkpoint
   in the reference's layout (a CPU golden, then the card); a seeded BERT at
   bert-base-multilingual-cased's geometry in both layouts, f32 and bf16,
   on one sentence, against the CPU (the post-LN one through a local
   checkpoint directory, `get_bert_feature` and `verify_import --kind
   bert`); stage 16's `text` mode over a vocab the phase writes; and
   `extract_f0` and MCD / LSD on a 10 s signal against the CPU;
16. zoo_train: the block zoo's `zoo_attn` at the shipped widths trained in
   f32 (B=48, 1 s crops) through `DiffusionTrainer` with attn_impl="fused":
   3 steps, every attention module through the K4 forward and backward at
   head dim 8, the losses held to the same steps with the plain attention;
   the K4 backward also at the zoo's training shapes (B=48, T = 88-11,
   H = 32-64, D = 8) against its plain version, timed beside SDPA's
   backward and its bound (in `check_k4_bwd`);
17. dp_train: data parallelism at a world of 1 (one card): the diffusion
   CLI (flagship, B=48) and the LM CLI (the shipped RoFormer, B=32) under
   `torch.distributed.run --nproc_per_node=1`, a real NCCL group: 2 steps
   and a save (the same 4 steps without any group run meanwhile in this
   process); then this process joins a world-of-one NCCL group, where each
   CLI's main resumes and takes 2 more, its checkpoint bitwise equal to the
   steps without a group, and train_step runs with and without the group
   in turns, with the NCCL collectives and kernels a step
   (torch.profiler).  Speed over
   several cards is not measured (the machine has one);
18. int8_serve: the flagship eager bf16 pipeline of
   `cli/infer_tts.py::build_pipeline(configs/config.yaml)` without and with
   `weight_quant: int8`: `tts` (430 tokens) and `tts_batch` x4 walls, one
   denoiser forward, the UNet's weight bytes, the latents' correlation (bar
   0.99), JAX's ValueErrors and the CLI's `--weight-quant int8` as a process;
19. tp_ep: tensor and expert parallelism on CPU gloo ranks with sharded
   checkpoints: `python -m latent_diffusion_speech_tpu_torch.parallel.dryrun
   8` (JAX's nine layouts: data, dp-tp, seq-parallel, pipeline,
   roformer-pipeline, expert-parallel, tp-ep, dp-tp-pp, pp-ep), a process
   beside the ranks below; the flagship diffusion trainer at model=2 and
   the Llama with 8 experts at expert=2, full width, two CPU ranks each: a
   step, a sharded save, a second step; a world of one on the card resumes
   each checkpoint bit for bit and holds its second step to the ranks'
   (`train_slice`'s tolerance); the checkpoint's bytes a rank against the
   single file's;
20. sp_pp: sequence and pipeline parallelism on CPU gloo ranks: the
   shipped RoFormer at seq=2 (hidden dropout 0.1) and at pipe=2, and the
   Llama with 8 experts at JAX's geometry at pipe=2, full width, two CPU
   ranks each: a step, a save, a second step; a world of one on the card
   resumes each checkpoint bit for bit and holds its second step to the
   ranks' (`train_slice`'s tolerance); the ranks' step times, the P2P
   bytes a step from the shapes and the bubble fraction; then at a world of
   one on the card `pipeline_apply` over one stage against the stack, each
   LM's `loss_pp` against its `loss` (value and gradients),
   `encode_seq_parallel` against `encode` and the ring against plain
   attention.

How the time is bounded (the phases' order is not the list's): tp_ep's
and sp_pp's CPU ranks run while nvcc builds the kernels, at a lower
priority; the
kernel checks (steps 1 and 6, whose numbers make the kernels line) run
alone;
after them a second process of this script (`--phases`, CHILD_PHASES:
codec_train and llama_text) runs beside the main process's phases;
dp_train's CLI processes start before migrate; each phase's CLI processes
are checked after the last phase (DEFERRED). So the walls that the other
phases print overlap other work on the card and the host.

Any failure raises (exit code != 0).  The second-to-last line is a JSON
object with one entry per kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import re
import struct
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_TOKENS = 430  # ~5 s of 44.1 kHz audio at hop 512
# the sampler of the serve-like phases (serve_entry's server and CLIs, svc,
# units_alt's SVC, data_path's and migrate's tts): the shipped UniPC at
# speedup 50, 20 steps where the shipped config serves 100 (speedup 10), a
# depth cut that bounds the script's time
SERVE_SPEEDUP = 50
# K1 at the HTTP server's batch sizes (2 and 5-8 requests pad to B=2 and
# B=8), N=1024 (the serve default max_length), over SERVE_L encoder rows
SERVE_K1_B, SERVE_L = (2, 8), 64
TEXT = "The quick brown fox jumps over the lazy dog, and then it runs back home."
BATCH_TEXTS = [
    "Hello world, this is a test of the speech system.",
    "Good morning.",
    "Please read the following sentence slowly and clearly.",
    "How are you today?",
]
# K4 shapes on the serve path: (B, T, D) at H=8 for the four UNet
# resolutions of a 448-frame bucket at B=1 (tts) and B=4 (tts_batch), plus
# the T=1024 bucket of max_length=1024; and the four resolutions of that
# 1024-frame bucket at the HTTP server's batch sizes (one request, two
# stream pieces, and 5-8 requests padded to B=8)
K4_SHAPES = [(b, t, d) for b in (1, 4) for t, d in ((448, 32), (224, 48), (112, 64), (56, 64))] + [(1, 1024, 64)]
K4_SHAPES += [(b, t, d) for b in (1, 2, 8) for t, d in ((1024, 32), (512, 48), (256, 64), (128, 64))]
# K5 shapes: (B, Tq, Tkv, D, causal) at H=8.  The serve path's: the four
# UNet resolutions of a 448-frame bucket at B=1 (tts) and B=4 (tts_batch),
# and the 1024-frame bucket; the JAX kernel's contract shapes
# (tests/test_pallas.py): Tq=100 against Tkv=260, causal T=96; and causal
# attention with Tq != Tkv (top-left aligned) both ways
K5_SHAPES = [(b, t, t, d, False) for b in (1, 4) for t, d in ((448, 32), (224, 48), (112, 64), (56, 64), (1024, 32))]
K5_SHAPES += [(1, 100, 260, 64, False), (1, 96, 96, 32, True), (2, 70, 200, 64, True), (2, 200, 70, 48, True)]
# K4 and K5 at head dim 8, the block zoo's (below): (B, T, H) of its
# attention in a 448-frame bucket at B=1 (tts) and B=4 (tts_batch), H the
# level's width over 8
D8_SHAPES = [(b, t, h) for b in (1, 4) for t, h in ((448, 32), (224, 48), (112, 64), (56, 64))]
# the general denoiser's block zoo: four configurations that between them
# reach every down and up block type and the three mid blocks, served at the
# shipped widths; (down_block_types, up_block_types, mid_block_type)
ZOO = {
    "zoo_attn": (("ResnetDownsampleBlock2D", "AttnDownBlock2D", "SimpleCrossAttnDownBlock2D", "DownBlock2D"),
                 ("UpBlock2D", "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "ResnetUpsampleBlock2D"),
                 "UNetMidBlock2DSimpleCrossAttn"),
    "zoo_skip": (("AttnSkipDownBlock2D", "SkipDownBlock2D", "AttnSkipDownBlock2D", "SkipDownBlock2D"),
                 ("SkipUpBlock2D", "AttnSkipUpBlock2D", "SkipUpBlock2D", "AttnSkipUpBlock2D"), "UNetMidBlock2D"),
    "zoo_encdec": (("DownEncoderBlock2D", "AttnDownEncoderBlock2D", "DownEncoderBlock2D", "AttnDownEncoderBlock2D"),
                   ("AttnUpDecoderBlock2D", "UpDecoderBlock2D", "AttnUpDecoderBlock2D", "UpDecoderBlock2D"),
                   "UNetMidBlock2D"),
    "zoo_k": (("KDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D"),
              ("KCrossAttnUpBlock2D",) * 3 + ("KUpBlock2D",), None),
}
# fused UNet buckets: the smallest, the 430-token one, max_length=1024
UNET_T = (64, 448, 1024)
# K4 shapes on the training path: (T, D) at H=8, B=48 for the four UNet
# resolutions of a 1 s crop (86 frames padded to 88), and the number of
# self-attention calls at each per forward
K4_TRAIN = [(88, 32, 10), (44, 48, 10), (22, 64, 10), (11, 64, 2)]
# the block zoo's K4 backward shapes (T, D, H, 0) at head dim 8, B = TRAIN_B: each
# level of a 1 s crop, H = channels / 8 (not in the flagship step's sum: 0 calls)
K4_TRAIN_D8 = [(88, 8, 32, 0), (44, 8, 48, 0), (22, 8, 64, 0), (11, 8, 64, 0)]
TRAIN_B, TRAIN_STEPS = 48, (3, 12)  # batch; steps before and after the resume
PROFILED_STEPS = 5  # training steps under torch.profiler (CUDA activity only)
# K6 on the training path: 48 crops x 86 frames against the 4096 x 1280 codebook
K6_TRAIN = (TRAIN_B * 86, 4096, 1280)
# the previous kernels' times on the same card (chip_smoke.py of the parent
# commit, NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's: K1 bf16
# sampled at N=430 by B (ms), the K4 backward in f32 at B=48 by T (µs)
EARLIER_K1_MS = {1: 49.55, 4: 47.56}
# K1 in f32 against its plain decode: raw logits within this share of their
# scale (f32 sums of C=256 and 512 terms in other orders), correlation
K1_F32_REL, K1_F32_CORR = 1e-4, 0.999999
EARLIER_K4_BWD_US = {88: 163.0, 44: 105.3, 22: 76.2, 11: 48.4}
# H100 SXM peaks (NVIDIA datasheet, dense): HBM bytes/s, bf16 tensor FLOP/s,
# f32 FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


# every process this script starts through start_process: main stops those
# still running when it ends, on a failure too
CHILDREN: list = []
# checks of processes that a phase started, made after the last phase so
# that the processes run beside the phases that follow
DEFERRED: list = []


def start_process(cmd: list, **kw) -> subprocess.Popen:
    """`cmd` started from the checkout's root (stdout and stderr piped)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)
    CHILDREN.append(proc)
    return proc


def finish_process(proc: subprocess.Popen, cmd: list, timeout: float = 600) -> tuple:
    """(stdout, stderr) of a `start_process` process that exits 0."""
    stdout, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)}: exit {proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}")
    return stdout, stderr


def stop_children() -> None:
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def bound(bytes_moved: float, flops: float, flops_per_s: float = BF16_FLOPS) -> tuple:
    """(least ms the card could take, 'bytes' or 'operations')."""
    t_b, t_f = bytes_moved / HBM_BPS, flops / flops_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_time_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """Device ms a call: `calls` calls captured in one CUDA graph, replayed
    `replays` times between two CUDA events, so no host launch sits in the
    window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def host_us(fn, calls: int = 200) -> float:
    """Host µs a call: perf_counter around `calls` unsynchronised calls (the
    device runs behind; the wait for it is outside the window)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def in_turns(fns: dict, order=("simt", "new", "new", "simt", "sdpa", "sdpa")) -> dict:
    """Back-to-back (CUDA events) and device (CUDA graph) ms a call of each
    of `fns`, taken in the order given, both timers in turns."""
    import torch

    got = {name: {"b2b": [], "device": []} for name in fns}
    for timer, key in ((lambda f: cuda_time_ms(f, iters=50), "b2b"), (cuda_graph_time_ms, "device")):
        for name in order:
            got[name][key].append(timer(fns[name]))
    torch.cuda.synchronize()
    return {name: {k: float(np.mean(v)) for k, v in t.items()} | {k + "_all": v for k, v in t.items()}
            for name, t in got.items()}


def differing(got, ref) -> float:
    """Share of output elements whose bf16 values differ."""
    return (got != ref).float().mean().item()


def turns_line(t: dict) -> str:
    return ", ".join(f"{name} {v['b2b'] * 1e3:.1f} / {v['device'] * 1e3:.2f} us (turns b2b "
                     f"{[round(x * 1e3, 1) for x in v['b2b_all']]}, device {[round(x * 1e3, 2) for x in v['device_all']]})"
                     for name, v in t.items())


def k4_bf16_row(k4, gen, dev, B: int, T: int, D: int, H: int = 8) -> dict:
    """K4 forward at (B, T, H, D): f32 against the plain version (atol
    2e-5, LSE 1e-4); bf16 (the tensor-core kernel) against the f32 plain
    version on the same bf16-rounded inputs at atol/rtol 3e-2, its LSE
    within 1e-4 of the plain version's on the same bf16 inputs, and at most
    2% of its bf16 outputs differing from that plain version's.  Times the
    bf16 kernel beside its CUDA-core (SIMT) kernel and
    F.scaled_dot_product_attention (the yardstick; the port never calls
    it), back to back and in a CUDA graph, in turns, and the plain version;
    bound: q, k, v read and out, lse written once, and q.k and p.v
    (2 * 2 * T * T * D per head).  Prints one line; returns its row."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device=dev) for _ in range(3))
    # f32: the kernel's arithmetic against the plain version
    out, lse = k4.fused_attention_with_lse(q, k, v)
    ref, ref_lse = k4.fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    e32 = (out - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if e32 > 2e-5 or lse_err > 1e-4:
        raise AssertionError(f"K4 f32 B={B} T={T} D={D}: out err {e32}, lse err {lse_err} (atol 2e-5 / 1e-4)")
    # bf16 (the serve dtype) against the f32 plain version on the same
    # bf16-rounded inputs; atol/rtol 3e-2 as tests/test_pallas.py holds
    # the TPU kernel's bf16 output to its f32 reference
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    outb, lseb = k4.fused_attention_with_lse(qb, kb, vb)
    refb, _ = k4.fused_attention_plain(qb.float(), kb.float(), vb.float())
    plainb, plain_lse = k4.fused_attention_plain(qb, kb, vb)
    simtb, _ = k4.attention_fwd_simt(qb, kb, vb)
    torch.cuda.synchronize()
    err = (outb.float() - refb).abs()
    if not bool((err <= 3e-2 + 3e-2 * refb.abs()).all()):
        raise AssertionError(f"K4 bf16 B={B} T={T} D={D}: max err {err.max().item()} over atol/rtol 3e-2")
    lse_b = (lseb - plain_lse).abs().max().item()
    share, share_simt = differing(outb, plainb), differing(simtb, plainb)
    if lse_b > 1e-4 or share > 0.02:
        raise AssertionError(f"K4 bf16 B={B} T={T} D={D}: lse err {lse_b} (limit 1e-4), {share:.2%} of outputs "
                             "differ from the plain version (limit 2%)")
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qb, kb, vb))
    t = in_turns({"simt": lambda: k4.attention_fwd_simt(qb, kb, vb),
                  "new": lambda: k4.fused_attention(qb, kb, vb),
                  "sdpa": lambda: sdpa(qs, ks, vs)})
    plain_ms = cuda_time_ms(lambda: k4.fused_attention_plain(qb, kb, vb), iters=50)
    bound_ms, bound_by = bound(B * (4 * T * H * D * 2 + H * T * 4), 4 * B * T * T * H * D)
    print(f"K4 attention_fwd B={B} T={T} H={H} D={D}: f32 err {e32:.2e} lse err {lse_err:.2e}; "
          f"bf16 vs f32 plain max err {err.max().item():.3e}, lse err {lse_b:.2e}, outputs differing from "
          f"the plain version {share:.3%} (SIMT kernel {share_simt:.3%}); back-to-back / device: "
          f"{turns_line(t)}; plain {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return dict(B=B, T=T, H=H, D=D, ms=t["new"]["b2b"], device_ms=t["new"]["device"],
                simt_ms=t["simt"]["b2b"], simt_device_ms=t["simt"]["device"],
                library_ms=t["sdpa"]["b2b"], library_device_ms=t["sdpa"]["device"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err.max().item())


def check_k4(dev) -> dict:
    """K4 forward at every K4_SHAPES entry and, at head dim 8, every
    D8_SHAPES entry (`k4_bf16_row`), and the host time a call beside SDPA's."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = [k4_bf16_row(k4, gen, dev, B, T, D) for B, T, D in K4_SHAPES]
    d8 = [k4_bf16_row(k4, gen, dev, B, T, 8, H) for B, T, H in D8_SHAPES]
    rows += d8
    worst = max(r["max_abs_err"] for r in rows)
    # host time a call at B=1, T=56 (D=64), beside SDPA's
    q, k, v = (torch.randn((1, 56, 8, 64), generator=gen, device=dev).bfloat16() for _ in range(3))
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    host = host_us(lambda: k4.fused_attention(q, k, v))
    host_sdpa = host_us(lambda: sdpa(qs, ks, vs))
    print(f"K4 host time a call at B=1 T=56 D=64: fused_attention {host:.2f} us, "
          f"F.scaled_dot_product_attention {host_sdpa:.2f} us")
    main = rows[0]  # B=1, T=448, D=32: the tts path's largest call
    return dict(max_abs_err=worst, rows=rows, host_us=host, library_host_us=host_sdpa, **main_keys(main),
                **{"d8_" + k: v for k, v in main_keys(d8[0]).items()})  # B=1, T=448, H=32, D=8: the zoo's largest


def main_keys(row: dict) -> dict:
    """The kernels line's numbers of one timed row."""
    return {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
                                "library_device_ms", "simt_device_ms")}


def k5_pairs(Tq: int, Tkv: int, causal: bool) -> int:
    """(query, key) pairs K5 scores: all of them, or under the top-left
    causal mask those with key <= query row."""
    return sum(min(r + 1, Tkv) for r in range(Tq)) if causal else Tq * Tkv


def k5_row(k5, gen, dev, B: int, Tq: int, Tkv: int, H: int, D: int, causal: bool) -> dict:
    """K5 against its plain version at (B, Tq / Tkv, H, D), q/k/v strided
    views as the UNet hands them over: f32 at atol 2e-5 (the JAX contract,
    tests/test_pallas.py); bf16 (the tensor-core kernel) against the plain
    version on the same bf16 inputs (the same f32 arithmetic, rounded once
    at the end) within 1e-2 of max|out|, with at most 2% of its bf16 outputs
    differing from the plain version's.  Times the bf16 kernel (the serve
    dtype) beside its CUDA-core (SIMT) kernel and F.scaled_dot_product_attention
    (its is_causal is top-left aligned too; the port never calls it), back
    to back and in a CUDA graph, in turns, and the plain version, beside the
    bound: q, k, v read and out written once, 2 * 2 * D operations per
    scored (query, key) pair and head.  Prints one line; returns its row."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn((B, Tq, 3 * H * D), generator=gen, device=dev)[..., : H * D].reshape(B, Tq, H, D)
    kv = torch.randn((B, Tkv, 2 * H * D), generator=gen, device=dev)
    k, v = (x.reshape(B, Tkv, H, D) for x in kv.chunk(2, dim=-1))
    out = k5.flash_attention(q, k, v, is_causal=causal)
    ref = k5.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    e32 = (out - ref).abs().max().item()
    shape = f"B={B} Tq={Tq} Tkv={Tkv} H={H} D={D} causal={causal}"
    if not bool(torch.isfinite(out).all()) or e32 > 2e-5:
        raise AssertionError(f"K5 f32 {shape}: max err {e32} (atol 2e-5)")
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    outb = k5.flash_attention(qb, kb, vb, is_causal=causal)
    refb = k5.flash_attention_plain(qb, kb, vb, causal)
    simtb = k5.flash_attention_simt(qb, kb, vb, is_causal=causal)
    torch.cuda.synchronize()
    eb, scale = (outb.float() - refb.float()).abs().max().item(), refb.float().abs().max().item()
    share, share_simt = differing(outb, refb), differing(simtb, refb)
    if outb.dtype != torch.bfloat16 or not bool(torch.isfinite(outb).all()) or eb > 1e-2 * scale or share > 0.02:
        raise AssertionError(f"K5 bf16 {shape}: max err {eb} (limit 1e-2 of scale {scale}), {share:.2%} of outputs "
                             "differ (limit 2%)")
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qb, kb, vb))
    t = in_turns({"simt": lambda: k5.flash_attention_simt(qb, kb, vb, is_causal=causal),
                  "new": lambda: k5.flash_attention(qb, kb, vb, is_causal=causal),
                  "sdpa": lambda: sdpa(qs, ks, vs, is_causal=causal)})
    plain_ms = cuda_time_ms(lambda: k5.flash_attention_plain(qb, kb, vb, causal), iters=20)
    bound_ms, bound_by = bound(2 * H * D * (2 * B * Tq + 2 * B * Tkv), 4 * B * H * D * k5_pairs(Tq, Tkv, causal))
    print(f"K5 flash_attention {shape}: f32 err {e32:.2e}; bf16 err {eb:.2e} (scale {scale:.3f}), outputs differing "
          f"from the plain version {share:.3%} (SIMT kernel {share_simt:.3%}); back-to-back / device: "
          f"{turns_line(t)}; plain {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return dict(B=B, Tq=Tq, Tkv=Tkv, H=H, D=D, causal=causal, ms=t["new"]["b2b"], device_ms=t["new"]["device"],
                simt_ms=t["simt"]["b2b"], simt_device_ms=t["simt"]["device"],
                library_ms=t["sdpa"]["b2b"], library_device_ms=t["sdpa"]["device"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=eb)


def check_k5(dev) -> dict:
    """K5 (`k5_row`) at every K5_SHAPES entry (H=8) and, at head dim 8,
    every D8_SHAPES entry, and the host time a call beside SDPA's."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5

    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = [k5_row(k5, gen, dev, B, Tq, Tkv, 8, D, causal) for B, Tq, Tkv, D, causal in K5_SHAPES]
    d8 = [k5_row(k5, gen, dev, B, T, T, H, 8, False) for B, T, H in D8_SHAPES]
    rows += d8
    q, k, v = (torch.randn((1, 56, 8, 64), generator=gen, device=dev).bfloat16() for _ in range(3))
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        host = host_us(lambda: k5.flash_attention(q, k, v))
    host_sdpa = host_us(lambda: sdpa(qs, ks, vs))
    print(f"K5 host time a call at B=1 T=56 D=64: flash_attention {host:.2f} us, "
          f"F.scaled_dot_product_attention {host_sdpa:.2f} us")
    main = rows[0]  # B=1, T=448, D=32: the tts path's largest call
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), rows=rows, host_us=host, library_host_us=host_sdpa,
                **main_keys(main), **{"d8_" + k: v for k, v in main_keys(d8[0]).items()})


def hmma_counts(so_path: str) -> dict:
    """HMMA instructions in the SASS of each tensor-core attention kernel
    (cuobjdump -sass), by kernel and head dim, or {} where the toolkit has
    no cuobjdump."""
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            found = re.search(r"(flash_attention_mma_kernel|attention_fwd_mma_kernel)ILi(\d+)E", m.group(1))
            name = f"{found.group(1)}<D={found.group(2)}>" if found else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def k1_logits_close(m, sg, kvs, clen, what: str, rel: float = 0.02, min_corr: float = 0.9999,
                    ref=None) -> tuple:
    """Greedy: K1's raw logits (the debug-logits path) close to the plain
    decode's at every step whose inputs agree, i.e. up to and including the
    first step at which a rounding flips an argmax: max error within `rel`
    of the logits' scale and correlation >= `min_corr` (bf16: 2% and
    0.9999, a few bf16 roundings of C=256 sums apart; f32: K1_F32_REL and
    K1_F32_CORR).  `ref`: (module, cross K/V, lengths) for the plain decode
    (the same weights on another device, the CPU), else the kernel's own.
    Returns (max error, steps compared, scale, correlation); N =
    sg.max_new_tokens."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1

    toks_k, lens, lg = k1.roformer_decode(m, sg, kvs, clen, debug_logits=True)
    rm, rkvs, rclen = ref if ref is not None else (m, kvs, clen)
    toks_p, _, lg_ref = (t.to(lg.device) for t in k1.roformer_decode_plain(rm, sg, rkvs, rclen, debug_logits=True))
    differ = (toks_k != toks_p).any(dim=0).nonzero()
    n_cmp = int(differ[0]) + 1 if len(differ) else sg.max_new_tokens
    # each stream's steps up to its EOS (the kernel writes no logits after it)
    live = torch.arange(n_cmp, device=lg.device)[None, :] < lens[:, None]
    a, b = lg[:, :n_cmp][live], lg_ref[:, :n_cmp][live]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    corr = float(np.corrcoef(a.flatten().cpu().numpy(), b.flatten().cpu().numpy())[0, 1])
    if err > rel * scale or corr < min_corr:
        raise AssertionError(f"K1 {what} logits over {n_cmp} steps: max err {err} (scale {scale}), corr {corr}")
    return err, n_cmp, scale, corr


def check_k1(dev) -> dict:
    import torch

    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem
    from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig, process_logits
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1

    cfg = RoformerConfig()
    rng = np.random.default_rng(0)
    L = 48
    phones = rng.integers(1, 100, (4, L))
    tones = rng.integers(0, 10, (4, L))
    mask = np.ones((4, L), np.int64)
    mask[1, 30:] = 0
    mask[3, 17:] = 0

    def prepare(lm, B):
        m = lm.module
        with torch.no_grad():
            enc = m.encode(*(torch.as_tensor(a[:B], device=dev) for a in (phones, tones, np.ones_like(phones), mask)))
            kvs = m.compute_cross_kv(enc)
        return m, kvs, torch.as_tensor(mask[:B].sum(-1), dtype=torch.int32, device=dev)

    serve_rng = np.random.default_rng(1)
    serve_phones = serve_rng.integers(1, 100, (8, SERVE_L))
    serve_tones = serve_rng.integers(0, 10, (8, SERVE_L))
    serve_mask = (np.arange(SERVE_L)[None] < np.array([64, 50, 37, 64, 21, 58, 44, 30])[:, None]).astype(np.int64)

    def prepare_serve(lm, B):
        m = lm.module
        arrays = (serve_phones[:B], serve_tones[:B], np.ones_like(serve_phones[:B]), serve_mask[:B])
        with torch.no_grad():
            kvs = m.compute_cross_kv(m.encode(*(torch.as_tensor(a, device=dev) for a in arrays)))
        return m, kvs, torch.as_tensor(serve_mask[:B].sum(-1), dtype=torch.int32, device=dev)

    def sampling(do_sample):
        return SamplingConfig(max_new_tokens=N_TOKENS, do_sample=do_sample, eos_token_id=cfg.semantic_eos,
                              pad_token_id=cfg.semantic_pad, bos_token_id=cfg.semantic_bos)

    def placement(m, sg, kvs, clen) -> str:
        p = k1._prepare(m, sg, kvs, clen, None, False)[2]
        return (f"plan: KV cache in {'shared' if p.kv_smem else 'device'} memory, encoder K/V in "
                f"{'shared' if p.ckv_smem else 'device'} memory, weight ring {p.stages} slots")

    out = {}
    # f32 greedy, also with the end gate: tokens identical up to the first
    # step at which a rounding flips an argmax (the seeded weights draw
    # flax's initialisers, so the logits are of unit scale and top-2 gaps
    # come within reach of f32 summation order), the raw logits close up to
    # and including that step
    lm32 = RoformerSystem(cfg, dtype=torch.float32, device=dev, seed=0)
    for B, gate in ((1, None), (4, None), (4, 1e-9)):
        m, kvs, clen = prepare(lm32, B)
        sg = dataclasses.replace(sampling(False), end_gate_threshold=gate)
        err, n_cmp, scale, corr = k1_logits_close(m, sg, kvs, clen, f"f32 B={B} end gate {gate}",
                                                  K1_F32_REL, K1_F32_CORR)
        print(f"K1 ar_decode f32 greedy B={B} N={N_TOKENS} end gate {gate}: tokens identical for "
              f"{n_cmp if n_cmp == N_TOKENS else n_cmp - 1} of {N_TOKENS} steps, logits up to the first differing "
              f"step max abs err {err:.3e} (scale {scale:.3f}, limit {K1_F32_REL} of scale), corr {corr:.8f}; "
              f"{placement(m, sg, kvs, clen)}")

    # bf16 greedy: the raw logits (debug-logits path) close at every step
    # whose inputs agree, i.e. up to and including the first step at which
    # a rounding flips an argmax; sampled tokens in the processed top-k/top-p
    # support of the kernel's own logits
    # (at N=430 and at the serve default max_length=1024, whose plan keeps
    # the encoder K/V in device memory behind a two-slot weight ring)
    lm16 = RoformerSystem(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    m, kvs, clen = prepare(lm16, 4)
    errs = []

    def logits_close(m, kvs, clen, B, N):
        sg = dataclasses.replace(sampling(False), max_new_tokens=N)
        err, n_cmp, scale, corr = k1_logits_close(m, sg, kvs, clen, f"B={B} N={N}")
        errs.append(err)
        print(f"K1 ar_decode bf16 greedy B={B} N={N} L={kvs[0][0].shape[1]}: logits of the first {n_cmp} steps "
              f"(tokens agree before the last): max abs err {err:.3e} (scale {scale:.2f}, tolerance 2% of scale), "
              f"corr {corr:.6f}; {placement(m, sg, kvs, clen)}")

    def sampled_in_support(m, kvs, clen, B, N):
        sc = dataclasses.replace(sampling(True), max_new_tokens=N)
        gen = torch.Generator(device=dev).manual_seed(0)
        toks, lens, lg = k1.roformer_decode(m, sc, kvs, clen, generator=gen, debug_logits=True)
        rep = torch.zeros((B, cfg.semantic_vocab_size), dtype=torch.bool, device=dev)
        rep[:, cfg.semantic_bos] = True
        for pos in range(N):
            live = pos < lens
            processed = process_logits(lg[:, pos], rep, sc)
            cur = toks[:, pos].long()
            chosen = processed.gather(1, cur[:, None])[:, 0]
            if not bool(torch.isfinite(chosen[live]).all()):
                raise AssertionError(f"K1 B={B} N={N}: sampled token outside the top-k/top-p support at step {pos}")
            if not bool((cur[~live] == cfg.semantic_pad).all()):
                raise AssertionError(f"K1 B={B} N={N}: non-PAD token after EOS at step {pos}")
            rep[torch.arange(B, device=dev), cur] = True
        print(f"K1 ar_decode bf16 sampled (top_k=5, top_p=0.8, rep 1.2) B={B} N={N}: all tokens within "
              f"the processed support (lengths {lens.tolist()})")

    for N in (N_TOKENS, 1024):
        logits_close(m, kvs, clen, 4, N)
    sc = sampling(True)
    gen = torch.Generator(device=dev).manual_seed(0)
    sampled_in_support(m, kvs, clen, 4, N_TOKENS)

    # the HTTP server's batches (serve_entry): tts_batch pads 2 requests to
    # B=2 and 5-8 to B=8; an EN piece of up to 60 characters fills the
    # 64-phone bucket; the serve default max_length=1024
    for B in SERVE_K1_B:
        m, kvs, clen = prepare_serve(lm16, B)
        logits_close(m, kvs, clen, B, 1024)
        sampled_in_support(m, kvs, clen, B, 1024)
    out["max_abs_err"] = max(errs)

    # timing at the serve setting (bf16, sampled), per generated token, at
    # N=430 and at the serve default max_length=1024; the cluster plan and
    # how many clusters the card holds at once; the wrapper's host time.
    # Every timed call draws from a generator seeded alike, so each decodes
    # the same tokens and stops at the same step (seeded weights can emit
    # EOS before N): the time is of `n` steps
    def seed0():
        return torch.Generator(device=dev).manual_seed(0)

    for N, B in [(n, b) for n in (N_TOKENS, 1024) for b in (1, 4)] + [(1024, b) for b in SERVE_K1_B]:
        sn = dataclasses.replace(sc, max_new_tokens=N)
        m, kvs, clen = prepare(lm16, B) if B in (1, 4) else prepare_serve(lm16, B)
        t_k = cuda_time_ms(lambda: k1.roformer_decode(m, sn, kvs, clen, generator=seed0()), iters=5, warmup=1)
        n = int(k1.roformer_decode(m, sn, kvs, clen, generator=seed0())[1].max())
        plan, clusters = k1.max_active_clusters(m, sn, kvs, clen)
        host = host_us(lambda: k1._prepare(m, sn, kvs, clen, gen, False), calls=50)
        was = EARLIER_K1_MS.get(B) if N == N_TOKENS else None
        beside = f" (earlier kernel {was:.2f} ms, {was * 1e3 / N:.1f} us/step)" if was else ""
        print(f"K1 ar_decode bf16 B={B} N={N}: kernel {t_k:.3f} ms for {n} steps ({t_k * 1e3 / n:.2f} us/step)"
              f"{beside}; longest stream {n} tokens; cluster of CL={plan.CL} blocks a stream, {plan.smem_bytes} bytes "
              f"of shared memory a block (KV cache there: {plan.kv_smem}, encoder K/V there: "
              f"{plan.ckv_smem}, weight ring {plan.stages} x {plan.chunk} bytes), "
              f"cudaOccupancyMaxActiveClusters {clusters}; wrapper host time (checks, packing, seed) "
              f"{host:.1f} us")
        if plan.ckv_smem:
            # the plan keeps the encoder K/V in shared memory here: the
            # same decode with it in device memory, in turns
            device_kv = functools.partial(k1.plan, encoder_kv_smem=False)
            turns = {"shared": [], "device": []}
            for where in ("shared", "device", "device", "shared"):
                with mock.patch.object(k1, "plan", k1.plan if where == "shared" else device_kv):
                    turns[where].append(cuda_time_ms(
                        lambda: k1.roformer_decode(m, sn, kvs, clen, generator=seed0()), iters=5, warmup=1))
            print(f"K1 ar_decode bf16 B={B} N={N}: encoder K/V in shared memory "
                  f"{[round(x, 3) for x in turns['shared']]} ms against device memory "
                  f"{[round(x, 3) for x in turns['device']]} ms (in turns)")
        if N == N_TOKENS and B == 1:
            t_p = cuda_time_ms(lambda: k1.roformer_decode_plain(m, sn, kvs, clen, generator=seed0()), iters=2,
                               warmup=1)
            out.update(ms=t_k, plain_ms=t_p)
            out["bound_ms"], out["bound_by"] = k1_bound(m, kvs, cfg, B, n)
            print(f"K1 at B=1: plain loop {t_p:.2f} ms; bound {out['bound_ms'] * 1e3:.2f} us "
                  f"({out['bound_by']}) for {n} steps; no single PyTorch call computes a whole decode")
    return out


def k1_bound(m, kvs, cfg, B: int, steps: int) -> tuple:
    """Bound of one whole decode: the decoder-side parameters and the cross
    K/V read once, tokens and lengths written once; per generated token
    the decoder layer's products (self q/k/v/o, cross q/o, the FFN), the
    head transform and the tied head, and attention over the cache and the
    encoder rows."""
    dec = [p for n, p in m.named_parameters() if not n.startswith(("enc", "phone_", "tone_", "spk_"))]
    bytes_in = sum(p.numel() * p.element_size() for p in dec)
    bytes_in += sum(k.numel() * k.element_size() + v.numel() * v.element_size() for k, v in kvs)
    bytes_out = B * steps * 4 + B * 4
    C, I, V = cfg.decoder.hidden_size, cfg.decoder.intermediate_size, cfg.semantic_vocab_size
    L = kvs[0][0].shape[1]
    layers = cfg.decoder.num_hidden_layers
    macs = 0
    for pos in range(1, steps + 1):
        macs += layers * (6 * C * C + 2 * C * I + 2 * pos * C + 2 * L * C) + C * C + V * C
    return bound(bytes_in + bytes_out, 2 * B * macs)


def check_unet(dev) -> dict:
    """The fused UNet forward (K2/K3) at the flagship width, seeded random
    weights: f32 kernel against the f32 plain version (max error <= 1e-3 of
    the output's scale: f32 sums in another order, and atomic split-K sums);
    bf16 kernel against the f32 plain version on the same bf16-rounded
    weights and inputs under the K2/K3 contract (tests/test_pallas_unet.py):
    corr > 0.999, max error <= max(4 x the bf16 plain version's own error,
    2% of scale).  Times kernel, plain version and the eager UNet1D.forward
    it replaces (bf16), beside the bound."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d import UNet1D, UNet1DConfig
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23
    from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded

    cfg = UNet1DConfig()
    m32 = seeded(lambda: UNet1D(cfg), 0).to(dev).eval()
    m16 = cast_compute_dtype(copy.deepcopy(m32), torch.bfloat16)
    m32r = cast_compute_dtype(copy.deepcopy(m16), torch.float32)
    p32, p16, p32r = (k23.pack_unet_params(m, cfg) for m in (m32, m16, m32r))
    gen = torch.Generator(device=dev).manual_seed(0)
    t = torch.tensor([437.0], device=dev)
    rows, worst = {}, 0.0
    with torch.no_grad():
        for T in UNET_T:
            x = torch.randn((1, T, cfg.in_channels), generator=gen, device=dev)
            got = k23.unet_fwd(p32, x, t, cfg)
            ref = k23.unet_fwd_plain(p32, x, t, cfg)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            e32 = (got - ref).abs().max().item()
            if not bool(torch.isfinite(got).all()) or e32 > 1e-3 * scale:
                raise AssertionError(f"unet_fwd f32 T={T}: max err {e32} (scale {scale}, tolerance 1e-3 of scale)")
            xb = x.bfloat16()
            gotb = k23.unet_fwd(p16, xb, t, cfg).float()
            plainb = k23.unet_fwd_plain(p16, xb, t, cfg).float()
            ref32 = k23.unet_fwd_plain(p32r, xb.float(), t, cfg)
            torch.cuda.synchronize()
            err = (gotb - ref32).abs().max().item()
            limit = max(4 * (plainb - ref32).abs().max().item(), 0.02 * ref32.abs().max().item())
            corr = torch.corrcoef(torch.stack([gotb.flatten(), ref32.flatten()]))[0, 1].item()
            if err > limit or corr <= 0.999:
                raise AssertionError(f"unet_fwd bf16 T={T}: max err {err} (limit {limit}), corr {corr}")
            worst = max(worst, err)
            ms = cuda_time_ms(lambda: k23.unet_fwd(p16, xb, t, cfg), iters=10, warmup=2)
            ms32 = cuda_time_ms(lambda: k23.unet_fwd(p32, x, t, cfg), iters=10, warmup=2)
            plain_ms = cuda_time_ms(lambda: k23.unet_fwd_plain(p16, xb, t, cfg), iters=3, warmup=1)
            eager_ms = cuda_time_ms(lambda: m16(xb, t), iters=5, warmup=2)
            # inputs read once (packed weights and f32 params, the scale/shift
            # row, x), the output written once; operations of the op table
            moved = (p16.weights.numel() * 2 + p16.params.numel() * 4 + k23._scale_shift(p16, t).numel() * 2
                     + xb.numel() * 2 + gotb.numel() * 2)
            bound_ms, bound_by = bound(moved, k23.unet_flops(p16, T))
            rows[T] = dict(ms=ms, plain_ms=plain_ms, eager_ms=eager_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"unet_fwd T={T}: f32 err {e32:.2e} (scale {scale:.3f}); bf16 vs f32 plain max err {err:.3e} "
                  f"(limit {limit:.3e}), corr {corr:.6f}; kernel {ms * 1e3:.1f} us (f32 kernel {ms32 * 1e3:.1f} us), "
                  f"plain {plain_ms * 1e3:.1f} us, "
                  f"eager UNet1D.forward {eager_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}, "
                  f"{moved / 1e6:.1f} MB, {k23.unet_flops(p16, T) / 1e9:.2f} GFLOP); grid {k23.launch_info}")
            if T == 448:
                phase_breakdown(k23, p16, xb, t, cfg)
    return dict(max_abs_err=worst, rows=rows, **rows[448])


# The earlier design of csrc/unet_fwd.cu (a k step per tap of 32 channels,
# loads and prologue synchronous in one shared buffer, attention on the
# CUDA cores), the same forward at T=448, bf16, flagship widths, seeded
# weights: us over phases by group, as that tree's chip_smoke.py printed
# them in a run in turns with this one (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
EARLIER_PHASES_US = {
    "attention": (1637.7, 32),
    "GEMM plain k=1": (898.0, 48),
    "GEMM LayerNorm k=1": (894.9, 48),
    "GEMM GroupNorm k=3": (851.5, 31),
    "GEMM GroupNorm k=3 + GEMM plain k=1": (672.6, 14),
    "GEMM GEGLU k=1": (413.0, 16),
    "GEMM GroupNorm k=1": (323.3, 16),
    "GEMM plain k=3": (156.0, 7),
}


def phase_breakdown(k23, packed, x, t, cfg):
    """Where one fused forward's time goes: the GPU clock after every grid
    barrier, summed by the kind of record(s) in each phase, beside the
    earlier design's figures for the same groups."""
    import torch

    T = x.shape[1]
    table = k23._table(packed, T)
    ns = torch.zeros(table.phases + 1, dtype=torch.int64, device=x.device)
    for _ in range(3):
        k23.unet_fwd(packed, x, t, cfg, phase_ns=ns)
    torch.cuda.synchronize()
    d = (ns[1:] - ns[:-1]).tolist()
    f = {n: i for i, n in enumerate(k23.FIELDS)}
    pro = {k23.PRO_NONE: "plain", k23.PRO_GN: "GroupNorm", k23.PRO_LN: "LayerNorm", k23.PRO_GEGLU: "GEGLU"}
    sums, phase, kinds = {}, 0, []
    for r in table.records.tolist():
        if r[f["KIND"]] == k23.KIND_ATTN:
            kinds.append("attention")
        else:
            kinds.append(f"GEMM {pro[r[f['PRO']]]} k={r[f['TAPS']]}")
        if r[f["SYNC"]]:
            key = " + ".join(kinds)
            s = sums.setdefault(key, [0, 0])
            s[0] += d[phase]
            s[1] += 1
            phase, kinds = phase + 1, []
    print(f"unet_fwd T={T} bf16 phases: {table.phases} barriers, {sum(d) / 1e6:.3f} ms between the first "
          "and the last")
    for key, (s, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        was = EARLIER_PHASES_US.get(key)
        beside = f"; earlier: {was[0]:.1f} us over {was[1]} phases ({was[0] / was[1]:.1f} us each)" if was else ""
        print(f"  {key}: {s / 1e3:.1f} us over {n} phases ({s / n / 1e3:.1f} us each){beside}")
    print(f"  earlier design in all: {sum(v[0] for v in EARLIER_PHASES_US.values()):.1f} us over "
          f"{sum(v[1] for v in EARLIER_PHASES_US.values())} phases")


def build_pipeline(dev, dtype, seed=0):
    import torch

    from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerConfig, RoformerSystem
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder

    codebook = np.random.default_rng(seed).standard_normal((4096, 1280)).astype(np.float32)
    return TTSPipeline(
        Unit2MelSystem(Unit2MelConfig(attn_impl="fused"), dtype=dtype, device=dev, seed=seed),
        Vocoder("hifi-vaegan", VAEGANConfig(), dtype=dtype, device=dev, seed=seed),
        lm=RoformerSystem(RoformerConfig(), dtype=dtype, device=dev, seed=seed),
        codebook=codebook,
    )


def timed(stages: dict, name: str, fn):
    """Wrap fn so each call adds its synchronised wall time to stages[name]."""
    import torch

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        stages[name + "_calls"] = stages.get(name + "_calls", 0) + 1
        return out

    return wrapper


def lm_decode_split(pipe, generate, call, card: str) -> None:
    """The tts's lm_decode stage (its B=1 `generate` call, repeated) in
    parts: the encoder with the cross K/V, the K1 wrapper's host time
    (checks, weight packing, seed; the device idle before it), and the
    kernel (the rest of the decode call, synchronised)."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1

    module = pipe.lm.module
    parts: dict = {}
    real = dict(encode=module.encode, compute_cross_kv=module.compute_cross_kv, prepare=k1._prepare,
                decode=k1.roformer_decode)

    def prepare(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["prepare"](*a, **kw)
        parts["wrapper"] = parts.get("wrapper", 0.0) + time.perf_counter() - t0
        return out

    module.encode = timed(parts, "encoder", module.encode)
    module.compute_cross_kv = timed(parts, "cross_kv", module.compute_cross_kv)
    k1._prepare = prepare
    k1.roformer_decode = timed(parts, "decode", k1.roformer_decode)
    try:
        for _ in range(2):  # the first call warms up, the second is read
            parts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(*call[0], **call[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        module.encode, module.compute_cross_kv = real["encode"], real["compute_cross_kv"]
        k1._prepare, k1.roformer_decode = real["prepare"], real["decode"]
    enc = parts["encoder"] + parts["cross_kv"]
    kernel = parts["decode"] - parts["wrapper"]
    print(f"lm_decode split, tts (B=1) [{card}]: {wall * 1e3:.3f} ms in all; encoder + cross K/V "
          f"{enc * 1e3:.3f} ms; K1 wrapper host {parts['wrapper'] * 1e3:.3f} ms; K1 kernel (with its launch) "
          f"{kernel * 1e3:.3f} ms; other {(wall - enc - parts['decode']) * 1e3:.3f} ms")


def fused_pipeline(pipe, dev, dtype, seed=0):
    """`pipe` with its Unit2Mel in the fused configuration (the same seed,
    so the same weights)."""
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem

    fused = copy.copy(pipe)
    fused.diffusion = Unit2MelSystem(Unit2MelConfig(attn_impl="fused"), dtype=dtype, device=dev, seed=seed,
                                     unet_impl="pallas")
    return fused


def serve(dev, card: str) -> dict:
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    pipe = build_pipeline(dev, torch.bfloat16)
    K = pipe.lm.cfg.semantic_kmeans_num
    hop = pipe.vocoder.vocoder_hop_size
    stages: dict = {}
    generated = []

    calls = []

    def generate(*a, **kw):
        calls.append((a, kw))
        toks, lens = real_generate(*a, **kw)
        generated.append((toks.cpu().numpy(), lens.cpu().numpy()))
        return toks, lens

    real_generate = pipe.lm.generate
    pipe.lm.generate = timed(stages, "lm_decode", generate)
    pipe.diffusion.infer = timed(stages, "diffusion_20step", pipe.diffusion.infer)
    pipe.vocoder.infer = timed(stages, "vocoder", pipe.vocoder.infer)

    # warm-up request (cuDNN autotuning, allocator), not counted
    pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    stages.clear()
    generated.clear()

    k1.launches = 0
    k4.launches = k4.bwd_launches = 0
    t0 = time.perf_counter()
    wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    t_tts = time.perf_counter() - t0
    diff_tts = stages["diffusion_20step"]
    k1_after_tts, k4_after_tts = k1.launches, k4.launches
    t0 = time.perf_counter()
    outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
    t_batch = time.perf_counter() - t0
    launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches}

    # each generate call ran K1 once; each diffusion call ran K4 640 times
    # (20 denoiser evaluations x 32 self-attention calls)
    n_gen = stages["lm_decode_calls"]
    n_inf = stages["diffusion_20step_calls"]
    if k1_after_tts != 1 or launches["ar_decode"] != n_gen or n_gen != 2:
        raise AssertionError(f"K1 launches {k1_after_tts} / {launches['ar_decode']} for {n_gen} generate calls")
    if k4_after_tts != 640 or launches["attention_fwd"] != 640 * n_inf or k4.bwd_launches != 0:
        raise AssertionError(f"K4 launches {k4_after_tts} / {launches['attention_fwd']} for {n_inf} infer calls, "
                             f"K4 backward {k4.bwd_launches} (want 0: serving runs under no_grad)")

    def n_tokens(toks, lens, b):
        t = toks[b, : lens[b]]
        return int((t < K).sum())

    results = [(wav, sr, n_tokens(*generated[0], 0))]
    results += [(w, s, n_tokens(*generated[1], b)) for b, (w, s) in enumerate(outs)]
    for w, s, n in results:
        if s != 44100 or w.ndim != 1 or len(w) != n * hop or not np.isfinite(w).all() or n == 0:
            raise AssertionError(f"bad output: sr {s}, shape {w.shape}, tokens {n}")
    print(f"serve tts: {len(wav) / sr:.3f} s of audio ({results[0][2]} tokens) in {t_tts:.3f} s; "
          f"tts_batch x4: {[round(len(w) / s, 3) for w, s, _ in results[1:]]} s in {t_batch:.3f} s")
    for name in ("lm_decode", "diffusion_20step", "vocoder"):
        print(f"stage {name}: {stages[name]:.4f} s over {stages[name + '_calls']} calls "
              f"(tts + tts_batch) [{card}]")
    print(f"launches in the serve run: {launches} ({n_gen} generate, {n_inf} diffusion calls)")
    print(f"20-step diffusion of the tts (B=1): {diff_tts:.4f} s [{card}]")
    lm_decode_split(pipe, real_generate, calls[0], card)
    return dict(launches=launches, stages=stages, pipe=pipe, t_tts=t_tts, diff_tts=diff_tts)


def serve_fused(dev, card: str, eager: dict) -> int:
    """The serve path in the fused configuration: `tts` sends its 20
    denoiser forwards through unet_fwd (and no K4); `tts_batch` of 4 keeps
    B>1 on the eager module (K4, no unet_fwd) and runs a latent-length
    bucket of one request at B=1 (unet_fwd); one more `tts` with UniPC
    (method="unipc", infer_speedup=50): 20 unet_fwd launches, no K4.
    Returns the unet_fwd launches of the three calls."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23

    pipe = fused_pipeline(eager["pipe"], dev, torch.bfloat16)
    hop = pipe.vocoder.vocoder_hop_size
    stages: dict = {}
    pipe.diffusion.infer = timed(stages, "diffusion_20step", pipe.diffusion.infer)
    pipe.tts(TEXT, language="EN", max_length=N_TOKENS)  # warm-up
    stages.clear()

    k1.launches = k4.launches = k23.launches = 0
    t0 = time.perf_counter()
    wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    t_tts = time.perf_counter() - t0
    tts_launches = {"unet_fwd": k23.launches, "attention_fwd": k4.launches}
    diff_tts = stages["diffusion_20step"]
    if tts_launches != {"unet_fwd": 20, "attention_fwd": 0}:
        raise AssertionError(f"fused tts: launches {tts_launches}, want 20 unet_fwd and 0 attention_fwd")
    n = len(wav) // hop
    if sr != 44100 or wav.ndim != 1 or n == 0 or len(wav) != n * hop or not np.isfinite(wav).all():
        raise AssertionError(f"fused tts: bad output: sr {sr}, shape {wav.shape}")
    # tts_batch runs one diffusion call a latent-length bucket: a bucket
    # of one request runs at B=1 (unet_fwd), the others at B>1 (eager, K4)
    sizes, timed_infer = [], pipe.diffusion.infer
    pipe.diffusion.infer = lambda units, *a, **kw: sizes.append(units.shape[0]) or timed_infer(units, *a, **kw)
    t0 = time.perf_counter()
    outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
    t_batch = time.perf_counter() - t0
    pipe.diffusion.infer = timed_infer
    n_one, n_batch_inf = sizes.count(1), len(sizes) - sizes.count(1)
    if not n_batch_inf or k23.launches != 20 + 20 * n_one or k4.launches != 640 * n_batch_inf:
        raise AssertionError(f"fused tts_batch (diffusion batch sizes {sizes}): unet_fwd {k23.launches - 20} "
                             f"(want {20 * n_one}), attention_fwd {k4.launches} (want {640 * n_batch_inf})")
    for w, s in outs:
        if s != 44100 or w.ndim != 1 or len(w) == 0 or not np.isfinite(w).all():
            raise AssertionError(f"fused tts_batch: bad output: sr {s}, shape {w.shape}")
    # UniPC, the sampler of the shipped config: 20 steps, one unet_fwd each
    before, k4_before, diff_before = k23.launches, k4.launches, stages["diffusion_20step"]
    t0 = time.perf_counter()
    wav_u, sr_u = pipe.tts(TEXT, language="EN", max_length=N_TOKENS, method="unipc", infer_speedup=50)
    t_unipc = time.perf_counter() - t0
    diff_unipc = stages["diffusion_20step"] - diff_before
    if k23.launches - before != 20 or k4.launches != k4_before:
        raise AssertionError(f"fused UniPC tts: unet_fwd {k23.launches - before} (want 20), attention_fwd "
                             f"{k4.launches - k4_before} (want 0)")
    if sr_u != 44100 or wav_u.ndim != 1 or len(wav_u) != len(wav) or not np.isfinite(wav_u).all():
        raise AssertionError(f"fused UniPC tts: bad output: sr {sr_u}, shape {wav_u.shape}")

    e = eager["stages"]
    print(f"fused serve tts: {len(wav) / sr:.3f} s of audio in {t_tts:.3f} s (eager {eager['t_tts']:.3f} s); "
          f"20-step diffusion of the tts {diff_tts:.4f} s (eager {eager['diff_tts']:.4f} s); launches "
          f"{tts_launches} [{card}]")
    print(f"fused serve tts_batch x4: {t_batch:.3f} s (diffusion batch sizes {sizes}: B>1 on the eager module, "
          f"attention_fwd +{k4_before} over {n_batch_inf} calls; B=1 fused, unet_fwd +{20 * n_one}); diffusion "
          f"stage over both calls "
          f"{diff_before:.4f} s vs eager {e['diffusion_20step']:.4f} s [{card}]")
    print(f"fused serve tts, UniPC (20 steps): {len(wav_u) / sr_u:.3f} s of audio in {t_unipc:.3f} s; 20-step "
          f"diffusion {diff_unipc:.4f} s; unet_fwd +20 [{card}]")
    return k23.launches


def serve_k5(dev, card: str, eager: dict, what: str, cfg, batch: bool) -> tuple:
    """The serve path with a Unit2Mel whose attention is K5 (`cfg`: the
    general denoiser, or the flagship with attn_impl="pallas"), the eager
    pipeline's LM, codebook and vocoder, seeded random weights, bf16: one
    `tts` (and, if `batch`, one `tts_batch` of 4), each of its 20-step
    diffusion calls 640 K5 launches (20 denoiser evaluations x 32
    attentions), no K4 and no unet_fwd launch, no call routed to the plain
    attention; per-stage wall times.  Returns the K5 launches and the
    Unit2MelSystem."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23

    pipe = copy.copy(eager["pipe"])
    pipe.lm, pipe.vocoder = copy.copy(pipe.lm), copy.copy(pipe.vocoder)  # to time them on their own
    pipe.diffusion = Unit2MelSystem(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    hop = pipe.vocoder.vocoder_hop_size
    stages: dict = {}
    # the eager run wrapped the shared objects' methods: time the class's own
    pipe.lm.generate = timed(stages, "lm_decode", type(pipe.lm).generate.__get__(pipe.lm))
    pipe.diffusion.infer = timed(stages, "diffusion_20step", pipe.diffusion.infer)
    pipe.vocoder.infer = timed(stages, "vocoder", type(pipe.vocoder).infer.__get__(pipe.vocoder))
    pipe.tts(TEXT, language="EN", max_length=N_TOKENS)  # warm-up
    stages.clear()

    k1.launches = k4.launches = k4.bwd_launches = k23.launches = k5.launches = k5.plain_routes = 0
    t0 = time.perf_counter()
    wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    t_tts = time.perf_counter() - t0
    diff_tts = stages["diffusion_20step"]
    tts_launches = {"ar_decode": k1.launches, "flash_attention": k5.launches, "attention_fwd": k4.launches,
                    "unet_fwd": k23.launches, "plain_routes": k5.plain_routes}
    if tts_launches != {"ar_decode": 1, "flash_attention": 640, "attention_fwd": 0, "unet_fwd": 0, "plain_routes": 0}:
        raise AssertionError(f"{what} tts: launches {tts_launches}, want 1 ar_decode, 640 flash_attention, "
                             "0 attention_fwd, 0 unet_fwd, 0 plain routes")
    n = len(wav) // hop
    if sr != 44100 or wav.ndim != 1 or n == 0 or len(wav) != n * hop or not np.isfinite(wav).all():
        raise AssertionError(f"{what} tts: bad output: sr {sr}, shape {wav.shape}")
    line = (f"{what} serve tts: {len(wav) / sr:.3f} s of audio in {t_tts:.3f} s (eager flagship with K4 "
            f"{eager['t_tts']:.3f} s); 20-step diffusion {diff_tts:.4f} s (eager flagship with K4 "
            f"{eager['diff_tts']:.4f} s); launches {tts_launches} [{card}]")
    print(line)
    if batch:
        t0 = time.perf_counter()
        outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
        t_batch = time.perf_counter() - t0
        n_inf = stages["diffusion_20step_calls"]
        if (k5.launches, k4.launches, k23.launches, k5.plain_routes) != (640 * n_inf, 0, 0, 0):
            raise AssertionError(f"{what} tts + tts_batch: flash_attention {k5.launches} (want {640 * n_inf}), "
                                 f"attention_fwd {k4.launches}, unet_fwd {k23.launches}, plain routes "
                                 f"{k5.plain_routes} (want 0)")
        for w, s in outs:
            if s != 44100 or w.ndim != 1 or len(w) == 0 or not np.isfinite(w).all():
                raise AssertionError(f"{what} tts_batch: bad output: sr {s}, shape {w.shape}")
        print(f"{what} serve tts_batch x4: {[round(len(w) / s, 3) for w, s in outs]} s in {t_batch:.3f} s; "
              f"flash_attention launches over tts + tts_batch {k5.launches} ({n_inf} diffusion calls) [{card}]")
        for name in ("lm_decode", "diffusion_20step", "vocoder"):
            print(f"{what} stage {name}: {stages[name]:.4f} s over {stages[name + '_calls']} calls "
                  f"(tts + tts_batch) [{card}]")
    return k5.launches, pipe.diffusion


def compare_flagship_k4_k5(dev, card: str, k4_system, k5_system) -> None:
    """The flagship's 20-step diffusion (B=1, T=448, bf16, the same seeded
    weights, units and x_init) with its attention through K4 and through
    K5, in turns K4, K5, K5, K4 within this call: host-bound runs move
    between calls, so only a same-call comparison says which is faster."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    units = torch.randn((1, 448, 1280), generator=gen, device=dev)
    x_init = torch.randn((1, 448, 128), generator=gen, device=dev)
    spk = torch.full((1, 1), 2, dtype=torch.long, device=dev)
    times = {"K4": [], "K5": []}
    for name in ("K4", "K5", "K5", "K4"):
        system = k4_system if name == "K4" else k5_system
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.infer(units, spk_id=spk, method="dpm-solver", infer_speedup=50, x_init=x_init)  # 20 steps
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    print(f"flagship 20-step diffusion, same call, turns K4, K5, K5, K4: K4 "
          f"{[round(t, 4) for t in times['K4']]} s, K5 {[round(t, 4) for t in times['K5']]} s [{card}]")


def eager_denoiser(system):
    """A context in which `system`'s sampler (a `Unit2MelSystem`'s) calls the
    eager module at every evaluation: on the card `_denoise` replays a CUDA
    graph captured earlier, which a function patched into the UNet since
    (a plain attention for a reference run) would not reach."""
    return mock.patch.object(system.diffusion, "denoise_fn", lambda params, x, t: system.module.denoise(x, t))


def check_general_against_plain(dev):
    """The general denoiser's 20-step diffusion + vocoder with K5 against
    the same run with K5's plain version, f32, same units and x_init
    (sampler tolerance atol/rtol 2e-3, tests/test_diffusion.py, the atol
    taken relative to the waveform's peak: the seeded vocoder's N(0, 0.01)
    convolutions give a waveform far below 1)."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.ops import attention
    from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5

    pipe = build_pipeline(dev, torch.float32)
    pipe.diffusion = Unit2MelSystem(Unit2MelConfig(denoiser="general", attn_impl="pallas"), dtype=torch.float32,
                                    device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    units = pipe.semantic_to_units(np.arange(50) * 7 % 4096)
    x_init = torch.randn((1, 64, 128), generator=gen, device=dev)
    before = k5.launches
    got = pipe.infer(units, spk_id=2, x_init=x_init)
    if k5.launches - before != 640:
        raise AssertionError(f"general f32 infer: {k5.launches - before} K5 launches, want 640")
    attention.flash_attention = lambda q, k, v, bias=None, mask=None, is_causal=False, scale=None: (
        k5.flash_attention_plain(q, k, v, is_causal, scale))
    try:
        with eager_denoiser(pipe.diffusion):
            ref = pipe.infer(units, spk_id=2, x_init=x_init)
    finally:
        attention.flash_attention = k5.flash_attention
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if not bool(torch.isfinite(got).all()) or not bool(((got - ref).abs() <= 2e-3 * scale + 2e-3 * ref.abs()).all()):
        raise AssertionError(f"general f32 wav K5 vs plain attention: max err {err} (scale {scale})")
    print(f"general denoiser f32 (50 tokens, 20 steps + vocoder) with K5 vs plain attention: max wav err {err:.2e} "
          f"(scale {scale:.2e})")


def zoo_attention_modules(module) -> int:
    """The attention modules of a built Unit2Mel: each runs one attention
    call a denoiser forward."""
    from latent_diffusion_speech_tpu_torch.models.diffusion import blocks as bl

    return sum(isinstance(m, (bl.CrossAttention1D, bl.AttnBlock1D, bl.AddedKVAttention1D)) for m in module.modules())


def zoo(dev, card: str) -> dict:
    """The general denoiser's block zoo on the serve path, each ZOO
    configuration at the shipped widths ((256, 384, 512, 512), 2 layers, 8
    heads: attention heads of dim 8) with seeded weights, behind the serve
    pipeline's LM, codebook and vocoder: in bf16, with attn_impl="pallas",
    one `tts` (after a warm-up) and one `tts_batch` of 4, and with
    attn_impl="fused" one `tts` (no warm-up); K5 (K4) launches equal to the model's
    attention modules x 20 evaluations a diffusion call, no call routed to
    the plain attention, no other attention kernel; finite waveforms of the
    right length; per-stage wall times.  Then each in f32 on 50 tokens: the
    20-step diffusion + vocoder with K5 against the same run with K5's plain
    version, under check_general_against_plain's bound.  Returns the K5 and
    K4 launches."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.ops import attention
    from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    t_phase = time.perf_counter()
    pipe = build_pipeline(dev, torch.bfloat16)
    hop = pipe.vocoder.vocoder_hop_size
    launches = {"flash_attention": 0, "attention_fwd": 0}
    for name, (down, up, mid) in ZOO.items():
        blocks = dict(denoiser="general", down_block_types=down, up_block_types=up, mid_block_type=mid)
        stages: dict = {}
        runs = {}
        for impl in ("pallas", "fused"):
            pipe.diffusion = Unit2MelSystem(Unit2MelConfig(attn_impl=impl, **blocks), dtype=torch.bfloat16, device=dev,
                                            seed=0)
            n_attn = zoo_attention_modules(pipe.diffusion.module)
            pipe.diffusion.infer = timed(stages, f"{impl}_diffusion", pipe.diffusion.infer)
            if impl == "pallas":  # a warm-up, for the configuration's first tts and tts_batch
                pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
            k5.launches = k5.plain_routes = k4.launches = 0
            calls, d0 = stages.get(f"{impl}_diffusion_calls", 0), stages.get(f"{impl}_diffusion", 0.0)
            t0 = time.perf_counter()
            wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
            runs[impl] = time.perf_counter() - t0
            if impl == "pallas":
                t0 = time.perf_counter()
                outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
                runs["batch"] = time.perf_counter() - t0
            else:
                outs = []
            n_inf = stages[f"{impl}_diffusion_calls"] - calls
            want = {"flash_attention": 20 * n_attn * n_inf if impl == "pallas" else 0,
                    "attention_fwd": 20 * n_attn if impl == "fused" else 0, "plain_routes": 0}
            got = {"flash_attention": k5.launches, "attention_fwd": k4.launches, "plain_routes": k5.plain_routes}
            if got != want:
                raise AssertionError(f"zoo {name} attn_impl={impl}: launches {got}, want {want} ({n_attn} attention "
                                     f"modules x 20 evaluations x {n_inf} diffusion calls)")
            for w, rate in [(wav, sr)] + list(outs):
                if rate != 44100 or w.ndim != 1 or len(w) == 0 or len(w) % hop or not np.isfinite(w).all():
                    raise AssertionError(f"zoo {name} attn_impl={impl}: bad output: sr {rate}, shape {w.shape}")
            launches["flash_attention"] += k5.launches
            launches["attention_fwd"] += k4.launches
            print(f"zoo {name} attn_impl={impl}: {n_attn} attention modules (heads of dim 8); tts "
                  f"{len(wav) / sr:.3f} s of audio in {runs[impl]:.3f} s" + (f", tts_batch x4 in {runs['batch']:.3f} s" if outs else "")
                  + f"; 20-step diffusion {n_inf} calls {stages[f'{impl}_diffusion'] - d0:.4f} s; launches {got} "
                  f"[{card}]")
        del pipe.diffusion
        torch.cuda.empty_cache()
    # f32, 50 tokens: K5 against its plain version through diffusion + vocoder
    pipe = build_pipeline(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    units = pipe.semantic_to_units(np.arange(50) * 7 % 4096)
    x_init = torch.randn((1, 64, 128), generator=gen, device=dev)
    for name, (down, up, mid) in ZOO.items():
        pipe.diffusion = Unit2MelSystem(Unit2MelConfig(attn_impl="pallas", denoiser="general", down_block_types=down,
                                                       up_block_types=up, mid_block_type=mid),
                                        dtype=torch.float32, device=dev, seed=0)
        n_attn = zoo_attention_modules(pipe.diffusion.module)
        before = k5.launches
        got = pipe.infer(units, spk_id=2, x_init=x_init)
        if k5.launches - before != 20 * n_attn:
            raise AssertionError(f"zoo {name} f32 infer: {k5.launches - before} K5 launches, want {20 * n_attn}")
        launches["flash_attention"] += k5.launches - before
        attention.flash_attention = lambda q, k, v, bias=None, mask=None, is_causal=False, scale=None: (
            k5.flash_attention_plain(q, k, v, is_causal, scale))
        try:
            with eager_denoiser(pipe.diffusion):
                ref = pipe.infer(units, spk_id=2, x_init=x_init)
        finally:
            attention.flash_attention = k5.flash_attention
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        within = bool(((got - ref).abs() <= 2e-3 * scale + 2e-3 * ref.abs()).all())
        if not bool(torch.isfinite(got).all()) or not within:
            raise AssertionError(f"zoo {name} f32 wav K5 vs plain attention: max err {err} (scale {scale})")
        print(f"zoo {name} f32 (50 tokens, 20 steps + vocoder) with K5 vs plain attention: max wav err {err:.2e} "
              f"(scale {scale:.2e})")
    del pipe
    torch.cuda.empty_cache()
    print(f"zoo phase: {time.perf_counter() - t_phase:.1f} s; launches {launches} [{card}]")
    return launches


def check_trajectory(dev):
    """The fused configuration's 20-step diffusion (inside `pipe.infer`, 430
    tokens -> the 448-frame bucket) against the eager one from the same
    x_init: bf16 under the JAX wiring contract (tests/test_pallas_unet.py:
    corr > 0.99, max |a-b| < 0.15 max(|a|, 1)); f32 at atol/rtol 2e-3 (the
    sampler tolerance of tests/test_diffusion.py).  DPM-Solver++ in bf16
    and f32 (the serve default), UniPC in bf16 (the shipped config's
    sampler)."""
    import torch

    pipes = {}
    for dtype, method in ((torch.bfloat16, "dpm-solver"), (torch.bfloat16, "unipc"), (torch.float32, "dpm-solver")):
        if dtype not in pipes:
            eager = build_pipeline(dev, dtype)
            pipes = {dtype: (eager, fused_pipeline(eager, dev, dtype))}
        eager, fused = pipes[dtype]
        units = eager.semantic_to_units(np.arange(N_TOKENS) * 7 % 4096)
        x_init = torch.randn((1, 448, 128), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        mels, wavs = [], []
        for pipe in (eager, fused):
            real = pipe.diffusion.infer
            pipe.diffusion.infer = lambda *a, _real=real, **kw: mels.append(_real(*a, **kw)) or mels[-1]
            wavs.append(pipe.infer(units, spk_id=2, method=method, x_init=x_init).float())
            pipe.diffusion.infer = real
        a, b = (m.float() for m in mels)
        err = (a - b).abs().max().item()
        corr = torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1].item()
        if dtype == torch.bfloat16:
            ok = corr > 0.99 and err < 0.15 * max(a.abs().max().item(), 1.0)
        else:
            ok = bool(((a - b).abs() <= 2e-3 + 2e-3 * a.abs()).all())
        if not ok or not bool(torch.isfinite(b).all()):
            raise AssertionError(f"fused vs eager trajectory {dtype} {method}: max err {err}, corr {corr}")
        print(f"trajectory {str(dtype)[6:]} {method} fused vs eager (20 steps, T=448, same x_init): mel max err "
              f"{err:.3e} (scale {a.abs().max().item():.3f}), corr {corr:.6f}; wav max err "
              f"{(wavs[0] - wavs[1]).abs().max().item():.3e}")


def check_slice_against_plain(dev):
    """20-step diffusion + vocoder with the K4 kernel against the same run
    with the plain attention, f32, same units and x_init (sampler
    tolerance atol/rtol 2e-3, tests/test_diffusion.py, the atol relative
    to the waveform's peak, as in check_general_against_plain)."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    pipe = build_pipeline(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    units = pipe.semantic_to_units(np.arange(50) * 7 % 4096)
    x_init = torch.randn((1, 64, 128), generator=gen, device=dev)
    got = pipe.infer(units, spk_id=2, x_init=x_init)
    unet1d.fused_attention = lambda q, k, v: k4.fused_attention_plain(q, k, v)[0]
    try:
        with eager_denoiser(pipe.diffusion):
            ref = pipe.infer(units, spk_id=2, x_init=x_init)
    finally:
        unet1d.fused_attention = k4.fused_attention
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if not bool(((got - ref).abs() <= 2e-3 * scale + 2e-3 * ref.abs()).all()):
        raise AssertionError(f"slice f32 wav kernel vs plain attention: max err {err} (scale {scale})")
    print(f"slice f32 (50 tokens, 20 steps + vocoder) with K4 vs plain attention: max wav err {err:.2e} "
          f"(scale {scale:.2e})")


SERVE_TEXTS = [
    "Hello world, this is a test of the speech system.",
    "Please read the following sentence slowly and clearly.",
    "The quick brown fox jumps over the lazy dog.",
    "How are you today, my dear old friend?",
    "We will meet again at the station tomorrow.",
    "Good morning, and welcome to the show.",
]
# three pieces at max_chars=40 (English periods do not end a sentence for
# text/segment.py; "!" and "?" do)
STREAM_TEXT = "Good morning to everyone here! Is the weather fine today? We will start the meeting soon!"
STREAM_MAX_CHARS, PAUSE_MS = 40, 180.0
ZH_TEXT = "今天天气真好。"
CLI_TEXT = "Hello world, this is a test of the speech system."
# the samplers the serve CLIs can name beyond UniPC and DPM-Solver++ order 2
# (DDPM and DPM-Solver++ order 3 are run on their own)
CARD_SAMPLERS = ("ddim", "pndm", "dpm-solver-singlestep", "dpm-solver-adaptive", "unipc-vary")


def http_call(port: int, method: str, path: str, body=None) -> tuple:
    """(status, headers, body bytes) of one request on a connection of its
    own (http.client undoes the chunked transfer encoding)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        data = json.dumps(body) if body is not None else None
        conn.request(method, path, data, {"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def wav_pcm(body: bytes) -> tuple:
    """(sample rate, int16 samples) of a mono PCM-16 WAV body."""
    import io
    import wave

    with wave.open(io.BytesIO(body)) as wf:
        if (wf.getnchannels(), wf.getsampwidth()) != (1, 2):
            raise AssertionError(f"WAV of {wf.getnchannels()} channels, {wf.getsampwidth()}-byte samples")
        return wf.getframerate(), np.frombuffer(wf.readframes(wf.getnframes()), "<i2")


def serve_entry(dev, card: str) -> dict:
    """The port's serve entry points on the card, at flagship width with
    seeded weights (no `pretrain/` in the repository): the pipeline from
    `cli/infer_tts.py::build_pipeline(configs/config.yaml)` (bf16; the
    config's UniPC at speedup 10 is checked, and served at SERVE_SPEEDUP:
    20 steps over 1000 timesteps) behind `infer.TTSServer`
    with the serve CLI's defaults (max_batch 8, max_wait_ms 30, max_queue
    64) and `cli/serve.py::make_handler` on a `TTSHTTPServer` at
    127.0.0.1:0.  After one unmeasured POST: six concurrent EN /tts POSTs
    (200, WAVs of tokens x 512 samples at 44.1 kHz, fewer batches than
    requests), one /tts/stream of three pieces (chunked, stitched with
    pause_ms of silence), one ZH request (500 with the ZH frontend's own
    error: F2), /healthz and /metrics (equal to the server's counters).
    Counted over these requests: one K1 launch a dispatched batch, 32 K4
    launches a denoiser evaluation, no K4 backward, no unet_fwd, no K5, no
    plain route.  Then each sampler the CLIs can name beyond UniPC and
    DPM-Solver++ once through `Unit2MelSystem.infer` at T=64 from one
    x_init (DDPM, 1000 steps, through the fused kernel), DPM-Solver++
    order 3 over the same denoiser, and the `infer_tts` CLI as a
    subprocess, plain and `--long`.  Returns the phase's launches."""
    import threading

    import torch

    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline as cli_build_pipeline
    from latent_diffusion_speech_tpu_torch.cli.serve import TTSHTTPServer, make_handler
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.infer import TTSServer
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23
    from latent_diffusion_speech_tpu_torch.text import text_to_sequence
    from latent_diffusion_speech_tpu_torch.text.segment import split_sentences

    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    absent = [cfg.text2semantic.model.codebook_path, cfg.common.vocoder.ckpt]
    if any(os.path.exists(os.path.join(ROOT, p)) for p in absent):
        raise AssertionError(f"{absent}: this phase expects no pretrained files in the checkout")
    print(f"serve_entry: {absent} absent (no pretrain/ in the repository): seeded random weights, random "
          f"centroids")
    t0 = time.perf_counter()
    pipe = cli_build_pipeline(cfg)
    t_build = time.perf_counter() - t0
    method, speedup = cfg.common.infer.method, cfg.common.infer.speedup
    if (pipe.device.type, method, speedup) != ("cuda", "unipc", 10):
        raise AssertionError(f"build_pipeline on {pipe.device}, sampler {method} at speedup {speedup}")
    speedup = SERVE_SPEEDUP
    hop, sr_want = pipe.vocoder.vocoder_hop_size, pipe.vocoder.vocoder_sample_rate
    K = pipe.lm.cfg.semantic_kmeans_num

    # what the server formed: each tts_batch's texts, wall time and output
    # lengths; each generate call's token counts; denoiser evaluations;
    # calls of the plain decode
    batches, token_rows, count = [], [], {"evals": 0, "plain_decode": 0}
    real_batch, real_generate = pipe.tts_batch, pipe.lm.generate
    real_denoise, real_plain = pipe.diffusion.diffusion.denoise_fn, k1.roformer_decode_plain

    def tts_batch(texts, *a, **kw):
        t = time.perf_counter()
        out = real_batch(texts, *a, **kw)
        torch.cuda.synchronize()
        tokens = token_rows[-1][: len(texts)]
        for (w, s), n in zip(out, tokens):
            if s != sr_want or w.ndim != 1 or n == 0 or len(w) != n * hop or not np.isfinite(w).all():
                raise AssertionError(f"tts_batch: sr {s}, shape {w.shape}, {n} tokens")
        batches.append(dict(texts=list(texts), seconds=time.perf_counter() - t, tokens=tokens,
                            lengths=[len(w) for w, _ in out]))
        return out

    def generate(*a, **kw):
        toks, lens = real_generate(*a, **kw)
        t, n = toks.cpu().numpy(), lens.cpu().numpy()
        token_rows.append([int((t[b, : n[b]] < K).sum()) for b in range(len(t))])
        return toks, lens

    def denoise(*a):
        count["evals"] += 1
        return real_denoise(*a)

    def plain_decode(*a, **kw):
        count["plain_decode"] += 1
        return real_plain(*a, **kw)

    pipe.tts_batch, pipe.lm.generate, pipe.diffusion.diffusion.denoise_fn = tts_batch, generate, denoise
    server = TTSServer(pipe, max_batch=8, max_wait_ms=30.0, method=method, infer_speedup=speedup, max_queue=64)
    httpd = TTSHTTPServer(("127.0.0.1", 0), make_handler(server))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with mock.patch.object(k1, "roformer_decode_plain", plain_decode):
            t0 = time.perf_counter()
            status, _, _ = http_call(port, "POST", "/tts", {"text": SERVE_TEXTS[0], "language": "EN"})
            t_warm = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"warm-up POST: {status}")
            batches.clear()
            token_rows.clear()
            count.update(evals=0, plain_decode=0)
            k1.launches = k4.launches = k4.bwd_launches = k23.launches = k5.launches = k5.plain_routes = 0

            # six EN requests from six client threads at once
            replies = [None] * len(SERVE_TEXTS)
            go = threading.Barrier(len(SERVE_TEXTS))

            def client(i):
                go.wait()
                t = time.perf_counter()
                got = http_call(port, "POST", "/tts", {"text": SERVE_TEXTS[i], "language": "EN", "spk_id": i + 1})
                replies[i] = got + (time.perf_counter() - t,)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(SERVE_TEXTS))]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            t_burst = time.perf_counter() - t0
            burst = list(batches)
            length_of = {txt: n for b in burst for txt, n in zip(b["texts"], b["lengths"])}
            audio_s = []
            for txt, reply in zip(SERVE_TEXTS, replies):
                if reply is None:
                    raise AssertionError(f"no reply to {txt!r}")
                status, headers, body, wall = reply
                if status != 200 or headers.get("content-type") != "audio/wav":
                    raise AssertionError(f"/tts {txt!r}: {status} {headers}: {body[:200]!r}")
                sr, pcm = wav_pcm(body)
                if sr != sr_want or len(pcm) != length_of[txt]:
                    raise AssertionError(f"/tts {txt!r}: {sr} Hz, {len(pcm)} samples, want {length_of[txt]}")
                audio_s.append(len(pcm) / sr)
            if len(burst) >= len(SERVE_TEXTS):
                raise AssertionError(f"six concurrent requests in {len(burst)} batches: no coalescing")
            walls = [r[3] for r in replies]
            print(f"serve_entry HTTP [{card}]: six concurrent EN /tts requests in {t_burst:.3f} s; batches formed "
                  f"{[len(b['texts']) for b in burst]} (padded to {[1 << (len(b['texts']) - 1).bit_length() for b in burst]}) "
                  f"taking {[round(b['seconds'], 3) for b in burst]} s; tokens {[b['tokens'] for b in burst]}")
            print(f"serve_entry HTTP [{card}]: request wall times {[round(w, 3) for w in walls]} s, audio "
                  f"{[round(a, 3) for a in audio_s]} s, RTF per request {[round(w / a, 4) for w, a in zip(walls, audio_s)]}; "
                  f"burst RTF {t_burst / sum(audio_s):.4f} (wall over all audio); warm-up request {t_warm:.3f} s; "
                  f"build_pipeline {t_build:.3f} s")

            # one stream of three pieces: the first dispatched alone, the
            # other two as one batch
            pieces = split_sentences(STREAM_TEXT, max_chars=STREAM_MAX_CHARS)
            if len(pieces) != 3:
                raise AssertionError(f"stream text splits into {pieces}")
            n_before = len(batches)
            t0 = time.perf_counter()
            status, headers, body = http_call(port, "POST", "/tts/stream", {
                "text": STREAM_TEXT, "language": "EN", "max_chars": STREAM_MAX_CHARS, "pause_ms": PAUSE_MS})
            t_stream = time.perf_counter() - t0
            formed = batches[n_before:]
            if status != 200 or headers.get("transfer-encoding") != "chunked":
                raise AssertionError(f"/tts/stream: {status} {headers}: {body[:200]!r}")
            if (body[:4], body[8:12], struct.unpack_from("<II", body, 4)[0], struct.unpack_from("<I", body, 40)[0]) \
                    != (b"RIFF", b"WAVE", 0xFFFFFFFF, 0xFFFFFFFF) or struct.unpack_from("<I", body, 24)[0] != sr_want:
                raise AssertionError(f"/tts/stream header {body[:44]!r}")
            pcm = np.frombuffer(body[44:], "<i2")
            piece_len = {txt: n for b in formed for txt, n in zip(b["texts"], b["lengths"])}
            lens = [piece_len[p] for p in pieces]
            gap = int(round(sr_want * PAUSE_MS / 1000.0))
            if [len(b["texts"]) for b in formed] != [1, 2] or len(pcm) != sum(lens) + 2 * gap:
                raise AssertionError(f"/tts/stream: batches {[b['texts'] for b in formed]}, {len(pcm)} samples, "
                                     f"want {lens} + 2 x {gap}")
            cut = [lens[0], lens[0] + gap, lens[0] + gap + lens[1], lens[0] + 2 * gap + lens[1]]
            if pcm[cut[0]:cut[1]].any() or pcm[cut[2]:cut[3]].any():
                raise AssertionError("/tts/stream: the pauses between pieces are not silent")
            print(f"serve_entry HTTP stream [{card}]: 3 pieces {[round(n / sr_want, 3) for n in lens]} s of audio "
                  f"(batches {[len(b['texts']) for b in formed]}: the first alone, taking "
                  f"{[round(b['seconds'], 3) for b in formed]} s) + 2 pauses of {gap} samples, chunked, in "
                  f"{t_stream:.3f} s; RTF {t_stream / (len(pcm) / sr_want):.4f}")

            # ZH: the frontend's own error (F2), answered 500
            try:
                text_to_sequence(ZH_TEXT, "ZH")
            except Exception as e:  # noqa: BLE001 - the expected failure, compared below
                zh_error = str(e)
                zh_kind = type(e).__name__
            else:
                raise AssertionError("the ZH frontend ran: F2 is closed, update serve_entry")
            status, _, body = http_call(port, "POST", "/tts", {"text": ZH_TEXT})
            if status != 500 or json.loads(body)["error"] != zh_error:
                raise AssertionError(f"ZH /tts: {status} {body[:300]!r}, want 500 {zh_error!r}")
            print(f"serve_entry HTTP ZH: 500 with the ZH frontend's {zh_kind}: {zh_error!r}")

            health = json.loads(http_call(port, "GET", "/healthz")[2])
            metrics = {line.split()[0]: float(line.split()[1])
                       for line in http_call(port, "GET", "/metrics")[2].decode().splitlines()
                       if line and not line.startswith("#")}
            counters = {k: getattr(server, k) for k in
                        ("requests_served", "requests_failed", "requests_rejected", "batches_served")}
            if any(health[k] != v or metrics[f"tts_{k}_total"] != v for k, v in counters.items()) \
                    or health["queue_depth"] != 0 or metrics["tts_queue_depth"] != 0:
                raise AssertionError(f"/healthz {health}, /metrics {metrics}, server {counters}")
            if not (server.batches_served < server.requests_served and server.requests_failed == 1):
                raise AssertionError(f"server counters {counters}")
            print(f"serve_entry probes: /healthz and /metrics agree with the server: {counters}; audio served "
                  f"{metrics['tts_audio_seconds_served_total']:.3f} s in {metrics['tts_batch_seconds_total']:.3f} s "
                  f"of batches")

            launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches}
            dispatched = len(batches)  # the ZH batch failed before its decode
            want = {"ar_decode": dispatched, "attention_fwd": 32 * count["evals"]}
            other = {"attention_bwd": k4.bwd_launches, "unet_fwd": k23.launches, "flash_attention": k5.launches,
                     "plain_attention": k5.plain_routes, "plain_decode": count["plain_decode"]}
            if launches != want or len(token_rows) != dispatched or any(other.values()):
                raise AssertionError(f"serve_entry launches {launches}, want {want} ({dispatched} decoded batches, "
                                     f"{count['evals']} denoiser evaluations); others {other} (want 0)")
            print(f"serve_entry launches over the measured requests: {launches} ({dispatched} decoded batches, "
                  f"{count['evals']} denoiser evaluations); {other}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    pipe.tts_batch, pipe.lm.generate = real_batch, real_generate
    clis = start_cli()
    DEFERRED.append(lambda: wait_cli(card, clis))
    launches["unet_fwd"], n = card_samplers(pipe, dev, card, count)
    launches["attention_fwd"] += n
    return launches


def card_samplers(pipe, dev, card: str, count: dict) -> tuple:
    """Each sampler the CLIs can name beyond UniPC and DPM-Solver++ order 2
    once at flagship width, T=64, from one x_init: through
    `Unit2MelSystem.infer` (the eager UNet, 32 K4 launches an evaluation),
    DPM-Solver++ order 3 over the same denoiser, and DDPM's 1000 steps with
    `unet_impl="pallas"` (one unet_fwd launch a step).  Finite outputs.
    Returns (unet_fwd launches, K4 launches)."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.samplers import dpmpp_sample
    from latent_diffusion_speech_tpu_torch.models.diffusion.schedule import NoiseSchedule
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23

    system = pipe.diffusion
    units = pipe.semantic_to_units(np.arange(64) * 7 % pipe.lm.cfg.semantic_kmeans_num)
    spk = torch.full((1, 1), 2, device=dev)
    x_init = torch.randn((1, 64, system.cfg.out_dims), generator=torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    k4_total = k23_total = 0

    def run(what, fn, unet_launches=0):
        nonlocal k4_total, k23_total
        k4_before, k23_before, evals_before = k4.launches, k23.launches, count["evals"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        evals, n_k4, n_k23 = count["evals"] - evals_before, k4.launches - k4_before, k23.launches - k23_before
        if mel.shape != (1, 64, system.cfg.out_dims) or not bool(torch.isfinite(mel).all()):
            raise AssertionError(f"sampler {what}: shape {tuple(mel.shape)}, finite {bool(torch.isfinite(mel).all())}")
        if (n_k4, n_k23) != ((32 * evals, 0) if not unet_launches else (0, unet_launches)):
            raise AssertionError(f"sampler {what}: {n_k4} K4 and {n_k23} unet_fwd launches for {evals} evaluations")
        k4_total, k23_total = k4_total + n_k4, k23_total + n_k23
        print(f"sampler {what} on the card (flagship, bf16, T=64) [{card}]: {took:.3f} s, "
              f"{evals or unet_launches} denoiser evaluations, finite (max |mel| {mel.float().abs().max().item():.3f})")

    for method in CARD_SAMPLERS:
        run(f"{method} (speedup {SERVE_SPEEDUP})",
            lambda: system.infer(units, spk_id=spk, method=method, infer_speedup=SERVE_SPEEDUP, x_init=x_init))
    cond = system.condition(units, spk_id=spk)

    @torch.no_grad()
    def order3():
        def eps_fn(x, t):
            return system.diffusion.denoise_fn(None, torch.cat([x, cond.to(x.dtype)], dim=-1), t)

        ns = NoiseSchedule(system.diffusion.schedule.betas[: system.diffusion.k_step])
        x = dpmpp_sample(eps_fn, ns, x_init.to(cond.dtype), steps=system.diffusion.k_step // SERVE_SPEEDUP, order=3)
        return system.diffusion.denorm_spec(x)

    run(f"dpm-solver order 3 ({system.diffusion.k_step // SERVE_SPEEDUP} steps)", order3)
    # DDPM's 1000 steps through the fused kernel (build_pipeline's seed: the same weights)
    fused = Unit2MelSystem(system.cfg, dtype=torch.bfloat16, device=dev, unet_impl="pallas")
    run("ddpm (1000 steps, unet_impl=pallas)", lambda: fused.infer(
        units, torch.Generator(device=dev).manual_seed(4), spk_id=spk, method="ddpm", x_init=x_init),
        unet_launches=system.diffusion.k_step)
    return k23_total, k4_total


def start_cli() -> list:
    """`python -m latent_diffusion_speech_tpu_torch.cli.infer_tts` as a user
    runs it, plain and with --long, both processes at once; `wait_cli`
    checks them after the last phase (DEFERRED)."""
    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    runs = []
    for name, text, extra in (("serve_entry_cli", CLI_TEXT, []), ("serve_entry_cli_long", STREAM_TEXT, ["--long"])):
        out = os.path.join("exp", name + ".wav")
        cmd = [sys.executable, "-m", "latent_diffusion_speech_tpu_torch.cli.infer_tts", "-c", "configs/config.yaml",
               "-l", "EN", "-i", text, "-o", out, "--speedup", str(SERVE_SPEEDUP), *extra]
        runs.append((out, cmd, extra, time.perf_counter(), start_process(cmd)))
    return runs


def wait_cli(card: str, runs: list) -> None:
    """Each `start_cli` process: exit 0 and a readable 44.1 kHz WAV under
    exp/ (removed after)."""
    from latent_diffusion_speech_tpu_torch.ops.audio_io import read_wav

    for out, cmd, extra, t0, proc in runs:
        stdout, _ = finish_process(proc, cmd)
        took = time.perf_counter() - t0
        wav, sr = read_wav(os.path.join(ROOT, out))
        os.remove(os.path.join(ROOT, out))
        if sr != 44100 or wav.ndim != 1 or len(wav) == 0 or not np.isfinite(wav).all():
            raise AssertionError(f"{out}: {sr} Hz, shape {wav.shape}")
        print(f"CLI infer_tts {' '.join(extra) or '(plain)'} [{card}]: exit 0, checked {took:.1f} s after its "
              f"start (a new process, the two at once, started by serve_entry and running beside the phases "
              f"that follow: imports, the kernel library, build_pipeline, one request); {out}: "
              f"{len(wav) / sr:.3f} s at {sr} Hz; {stdout.strip().splitlines()[-1]}")


# input of the svc phase: 44.1 kHz, (seconds, f0) a stretch, f0 None for
# true silence; three voiced stretches, each longer than the slicer's 5 s
# min_length_ms so that each is its own segment
SVC_SR = 44100
SVC_PARTS = ((0.5, None), (6.0, 110.0), (1.5, None), (9.0, 150.0), (1.5, None), (14.0, 190.0))
# stage 10 / 19 layout: seconds a file (44.1 kHz), two speakers
SVC_FILES = (2.0, 3.3, 4.7, 5.9, 7.4, 8.6, 10.3, 12.0)
# the mask's reach past voice: extract_volume's frames are centred
# (half a hop), the 9-tap running max dilates by 4 frames and the linear
# upsampling by one more; a stitch's cross-fade sits at a segment's edge
SVC_MARGIN_HOPS = 6
# the Whisper encoder in bf16 against the same weights in f32 (relative
# Frobenius error of the units)
WHISPER_BF16_REL = 5e-2


def svc_signal(parts=SVC_PARTS, sr: int = SVC_SR) -> tuple:
    """(audio f32, voiced (start, end) sample spans): harmonic tones (five
    harmonics, 4 Hz amplitude modulation between 0.3 and 1.0 of the peak)
    and true silence (zeros)."""
    out, spans, pos = [], [], 0
    for sec, f0 in parts:
        n = int(round(sec * sr))
        if f0 is None:
            out.append(np.zeros(n))
        else:
            t = np.arange(n) / sr
            tone = sum(np.sin(2 * np.pi * f0 * h * t + h) / h for h in range(1, 6))
            out.append(0.15 * tone * (0.65 + 0.35 * np.sin(2 * np.pi * 4 * t)))
            spans.append((pos, pos + n))
        pos += n
    return np.concatenate(out).astype(np.float32), spans


def svc(dev, card: str) -> dict:
    """SVC long-audio inference as a user runs it, on the card at full
    width with seeded weights (no `pretrain/`): `cli/infer_tts.py::build_pipeline(configs/config.yaml)`
    (bf16, the flagship UNet with K4, UniPC at SERVE_SPEEDUP: 20 steps,
    HiFi-VAEGAN at 44.1 kHz) with a `UnitsEncoder` over a seeded
    Whisper-large-v3 encoder (128 mels, 1280 wide, 20 heads, 32 layers,
    bf16), on `svc_signal()` written as a WAV and read back through
    `load_audio`.  `TTSPipeline.infer_from_long_audio` once, each step timed
    with synchronisation: slicing, the volume mask, per segment resampling
    to 16 kHz, log-mel, the encoder, alignment, diffusion and vocoder, and
    the stitch; wall and RTF.  Checks: 44.1 kHz out; the input's length
    within a hop a segment; every sample of each silence further than
    SVC_MARGIN_HOPS hops from voice exactly 0; all finite; units (1,
    T_16k // 320, 1280) f32; 32 K4 launches a denoiser evaluation, the same
    evaluations each segment; no unet_fwd, K5, K1, K4 backward or K6 launch.
    Then the `infer_svc` CLI as a new process on that WAV (checked after the
    last phase, DEFERRED), while this process runs `svc_checks`: the
    encoder in bf16 against the same weights
    in f32 on one segment's mel (relative error <= WHISPER_BF16_REL), and
    stages 10 and 19 (`process_units`, `tokenize_units`) over a layout of
    SVC_FILES: one K6 launch a file, the ids equal to `kmeans_argmin_plain`
    on the card but for f64 ties.  Last,
    K4 at every shape the phase launched it at and K6 at every N of stage
    19, against their plain versions and timed.  Returns the phase's launches."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline as cli_build_pipeline
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.infer import tts
    from latent_diffusion_speech_tpu_torch.models import units as units_mod
    from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d
    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
    from latent_diffusion_speech_tpu_torch.models.whisper import WhisperDims
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio, read_wav, write_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import flash_attention as k5
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.ops.kernels import unet_fused as k23

    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    whisper_ckpt = os.path.join(ROOT, "pretrain", "large-v3_encoder.pt")
    if os.path.exists(whisper_ckpt):
        raise AssertionError(f"{whisper_ckpt}: this phase expects no pretrained files in the checkout")
    t0 = time.perf_counter()
    pipe = cli_build_pipeline(cfg)
    t_build = time.perf_counter() - t0
    method, speedup = cfg.common.infer.method, SERVE_SPEEDUP
    t0 = time.perf_counter()
    encoder = UnitsEncoder(cfg.data.encoder, cfg.data.encoder_sample_rate, cfg.data.encoder_hop_size,
                           cfg.data.units_forced_mode, ckpt_path=whisper_ckpt, device=dev)
    torch.cuda.synchronize()
    t_whisper = time.perf_counter() - t0
    whisper = encoder.model.model
    n_params = sum(p.numel() for p in whisper.parameters())
    if encoder.model.dims != WhisperDims() or whisper.conv1.weight.dtype != torch.bfloat16:
        raise AssertionError(f"Whisper {encoder.model.dims}, {whisper.conv1.weight.dtype}: not large-v3 in bf16")
    pipe.units_encoder = encoder
    hop, out_sr = pipe.vocoder.vocoder_hop_size, pipe.vocoder.vocoder_sample_rate
    print(f"svc [{card}]: build_pipeline {t_build:.3f} s; Whisper-large-v3 encoder {encoder.model.dims} "
          f"seeded on the card in {t_whisper:.3f} s ({n_params / 1e6:.1f} M parameters, bf16); sampler {method} "
          f"at speedup {speedup}")

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    src = os.path.join(ROOT, "exp", "svc_in.wav")
    signal, spans = svc_signal()
    write_wav(src, signal, SVC_SR)
    audio, sr = load_audio(src)
    if sr != SVC_SR or len(audio) != len(signal):
        raise AssertionError(f"load_audio: {sr} Hz, {len(audio)} samples")

    # each step's synchronised wall time per call; the units of each
    # segment; denoiser evaluations; K4's shapes (a denoiser graph's replays
    # launch K4 without calling Python: shapes only, no calls)
    steps: dict = {}
    units_seen, count, k4_shapes = [], {"evals": 0}, set()

    def each(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            steps.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return wrapper

    real_encode, real_denoise, real_attention = encoder.encode, pipe.diffusion.diffusion.denoise_fn, unet1d.fused_attention

    def encode(seg, rate, *a, **kw):
        out = real_encode(seg, rate, *a, **kw)
        units_seen.append((len(seg), tuple(out.shape), out.dtype))
        return out

    def denoise(*a):
        count["evals"] += 1
        return real_denoise(*a)

    def attention(q, *a, **kw):
        k4_shapes.add(tuple(q.shape))
        return real_attention(q, *a, **kw)

    patches = [mock.patch.object(tts, name, each(label, getattr(tts, name))) for name, label in (
        ("split_voiced", "slicing"), ("extract_volume", "volume mask"), ("get_volume_mask", "volume mask"),
        ("units_forced_alignment", "alignment"), ("_stitch", "stitch"))]
    patches += [mock.patch.object(units_mod, "resample", each("resample to 16 kHz", units_mod.resample)),
                mock.patch.object(units_mod, "whisper_log_mel", each("log-mel", units_mod.whisper_log_mel)),
                mock.patch.object(whisper, "forward", each("Whisper encoder", whisper.forward)),
                mock.patch.object(encoder, "encode", encode),
                mock.patch.object(pipe.diffusion, "infer", each("diffusion", pipe.diffusion.infer)),
                mock.patch.object(pipe.vocoder, "infer", each("vocoder", pipe.vocoder.infer)),
                mock.patch.object(pipe.diffusion.diffusion, "denoise_fn", denoise),
                mock.patch.object(unet1d, "fused_attention", attention)]
    for p in patches:
        p.start()
    try:
        k1.launches = k4.launches = k4.bwd_launches = k23.launches = k5.launches = k5.plain_routes = 0
        k6.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, got_sr = pipe.infer_from_long_audio(audio, sr, method=method, infer_speedup=speedup)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(ar_decode=k1.launches, attention_fwd=k4.launches, attention_bwd=k4.bwd_launches,
                        unet_fwd=k23.launches, flash_attention=k5.launches, plain_k5=k5.plain_routes,
                        kmeans_argmin=k6.launches)
    finally:
        for p in reversed(patches):
            p.stop()

    n_seg = len(units_seen)
    if got_sr != 44100 or out.ndim != 1 or not np.isfinite(out).all():
        raise AssertionError(f"svc output: {got_sr} Hz, shape {out.shape}, finite {np.isfinite(out).all()}")
    if n_seg != len(spans) or abs(len(out) - len(audio)) > hop * n_seg:
        raise AssertionError(f"svc output: {len(out)} samples for {len(audio)} in, {n_seg} segments "
                             f"(within {hop} a segment)")
    for n_in, shape, dtype in units_seen:
        t16 = max(400, -(-n_in * 16000 // sr))
        if shape != (1, t16 // 320, 1280) or dtype != torch.float32:
            raise AssertionError(f"units for {n_in} samples: {shape} {dtype}, want (1, {t16 // 320}, 1280) f32")
    margin = SVC_MARGIN_HOPS * hop
    gaps = [(0, spans[0][0])] + [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
    zeros = 0
    for a, b in gaps:
        lo, hi = (a + margin if a else 0), b - margin
        if np.any(out[lo:hi]):
            raise AssertionError(f"svc output: nonzero samples in silence [{lo}, {hi})")
        zeros += hi - lo
    evals = count["evals"]
    if (evals % n_seg or launched["attention_fwd"] != 32 * evals
            or any(launched[k] for k in ("ar_decode", "attention_bwd", "unet_fwd", "flash_attention", "plain_k5",
                                         "kmeans_argmin"))):
        raise AssertionError(f"svc launches {launched} for {evals} denoiser evaluations over {n_seg} segments "
                             "(want 32 K4 launches an evaluation, the same evaluations each segment, no other)")
    seconds = len(audio) / sr
    print(f"svc infer_from_long_audio [{card}]: {seconds:.3f} s of 44.1 kHz audio in, {len(out) / got_sr:.3f} s "
          f"out, {n_seg} segments (units {[s for _, s, _ in units_seen]}), wall {wall:.3f} s, RTF "
          f"{wall / seconds:.4f}; {evals} denoiser evaluations ({evals // n_seg} a segment), launches {launched}; "
          f"{zeros} silent samples exactly 0; finite")
    for name in ("slicing", "volume mask", "resample to 16 kHz", "log-mel", "Whisper encoder", "alignment",
                 "diffusion", "vocoder", "stitch"):
        t = steps.get(name, [])
        print(f"  svc step {name}: {sum(t) * 1e3:.3f} ms in all, per call {[round(x * 1e3, 3) for x in t]} ms")
    steps_sum = sum(sum(t) for t in steps.values())
    print(f"  svc other (host copies, mask gating, unmeasured): {(wall - steps_sum) * 1e3:.3f} ms")

    # the CLI as a user runs it, a new process, checked after the last phase
    dst = os.path.join("exp", "svc_out.wav")
    cmd = [sys.executable, "-m", "latent_diffusion_speech_tpu_torch.cli.infer_svc", "-c", "configs/config.yaml",
           "-i", os.path.join("exp", "svc_in.wav"), "-o", dst, "--speedup", str(SERVE_SPEEDUP)]
    t_cli = time.perf_counter()
    cli = start_process(cmd)

    def check_cli() -> None:
        stdout, _ = finish_process(cli, cmd)
        took = time.perf_counter() - t_cli
        wav, wav_sr = read_wav(os.path.join(ROOT, dst))
        os.remove(os.path.join(ROOT, dst))
        os.remove(src)
        if wav_sr != 44100 or wav.ndim != 1 or abs(len(wav) - len(audio)) > hop * n_seg or not np.isfinite(wav).all():
            raise AssertionError(f"{dst}: {wav_sr} Hz, shape {wav.shape}")
        print(f"CLI infer_svc [{card}]: exit 0, checked {took:.1f} s after its start (a new process, started by svc "
              f"and running beside the phases that follow: imports, the kernel library, build_pipeline, the Whisper "
              f"init, {n_seg} segments); {dst}: {len(wav) / wav_sr:.3f} s at {wav_sr} Hz; "
              f"{stdout.strip().splitlines()[-1]}")

    DEFERRED.append(check_cli)
    k4_rows = svc_checks(card, dev, cfg, pipe, encoder, whisper, audio, sr, spans, k4_shapes)

    # K4 at every shape the svc call launched it at
    gen = torch.Generator(device=dev).manual_seed(5)
    print(f"svc K4 shapes (B, T, H, D): {sorted(k4_shapes)}")
    for B, T, H, D in k4_rows:
        k4_bf16_row(k4, gen, dev, B, T, D)
    del pipe, encoder, whisper
    torch.cuda.empty_cache()
    return {"attention_fwd": launched["attention_fwd"], "kmeans_argmin": len(SVC_FILES)}


def svc_checks(card: str, dev, cfg, pipe, encoder, whisper, audio, sr: int, spans, k4_shapes) -> list:
    """svc's checks beside its CLI process: the Whisper encoder in bf16
    against f32, stages 10 and 19 over a layout of SVC_FILES.  Returns the
    K4 shapes to time once the CLI is done."""
    import shutil

    import torch

    from latent_diffusion_speech_tpu_torch.cli import preprocess_token, preprocess_unit
    from latent_diffusion_speech_tpu_torch.models import units as units_mod
    from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.ops.stft import whisper_log_mel

    # the encoder in bf16 against the same weights in f32, on the first segment's mel
    with torch.no_grad():
        audio16 = units_mod.resample(torch.from_numpy(audio[: spans[0][1]]).to(dev)[None], sr, 16000)
        mel = whisper_log_mel(audio16, n_mels=encoder.model.dims.n_mels)
        got = whisper(mel)
        f32 = copy.deepcopy(whisper).float()
        ref = f32(mel)
        torch.cuda.synchronize()
        rel = ((got - ref).norm() / ref.norm()).item()
        max_err = (got - ref).abs().max().item()
        del f32
    torch.cuda.empty_cache()
    if not rel <= WHISPER_BF16_REL:
        raise AssertionError(f"Whisper bf16 vs f32: relative error {rel} over {WHISPER_BF16_REL}")
    print(f"svc Whisper encoder bf16 vs the same weights in f32 on the card, units {tuple(ref.shape)}: relative "
          f"error {rel:.4e} (limit {WHISPER_BF16_REL}), max abs error {max_err:.4f} at max |units| "
          f"{ref.abs().max().item():.3f}")

    # stages 10 and 19 over a written layout
    root = os.path.join(ROOT, "exp", "svc_layout")
    shutil.rmtree(root, ignore_errors=True)
    for i, sec in enumerate(SVC_FILES):
        path = os.path.join(root, "audio", f"spk{i % 2}", f"f{i}.wav")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(path, svc_signal(((sec, 120.0 + 10 * i),))[0], SVC_SR)
    codebook = pipe.codebook.codebook.float().cpu().numpy()
    try:
        for stage, it in (("10 (units)", preprocess_unit.process_units(root, encoder, SVC_SR,
                                                                       device_sr=cfg.data.encoder_sample_rate)),
                          ("19 (tokens)", preprocess_token.tokenize_units(root, codebook, device=dev))):
            k6.launches = 0
            times, shapes = [], []
            t0 = time.perf_counter()
            for name, shape in it:
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                shapes.append(shape)
                t0 = time.perf_counter()
            want_k6 = len(SVC_FILES) if stage.startswith("19") else 0
            if len(shapes) != len(SVC_FILES) or k6.launches != want_k6:
                raise AssertionError(f"stage {stage}: {len(shapes)} files, {k6.launches} K6 launches")
            print(f"stage {stage} [{card}]: {len(shapes)} files, shapes {shapes}, K6 launches {k6.launches}; "
                  f"per file {[round(t * 1e3, 1) for t in times]} ms (the first with the warm-up)")
        cb = torch.from_numpy(codebook).to(dev)
        differ, rows_total = 0, 0
        for dirpath, _, files in sorted(os.walk(os.path.join(root, "units"))):
            for fn in sorted(files):
                x = torch.from_numpy(np.load(os.path.join(dirpath, fn))).to(dev)
                ids = np.load(os.path.join(dirpath.replace("units", "semantic_token", 1), fn))
                row = k6_row(k6, x, cb, "stage 19")
                if not np.array_equal(ids, row["ids"].cpu().numpy()):
                    raise AssertionError(f"stage 19 {fn}: saved ids differ from the kernel's")
                differ, rows_total = differ + row["differ"], rows_total + row["N"]
        print(f"stage 19 ids against kmeans_argmin_plain on the card: {differ} of {rows_total} rows differ "
              f"({differ / rows_total:.4%}, each an f64 tie)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return sorted(k4_shapes)


def check_k4_bwd(dev) -> dict:
    """K4 at the training shapes, B=48, H=8: the f32 forward kernel's out
    and lse against the plain forward (atol 2e-5 / 1e-4, as check_k4); the
    f32 backward kernel, fed the forward kernel's out and lse as the trainer
    feeds it, against the plain backward fed the plain forward's, at atol
    3e-5 / rtol 1e-4 (the JAX contract, tests/test_pallas.py); bf16 kernel against the f32 plain backward of the
    same bf16-rounded inputs within 2^-5 of each gradient's scale (p, ds, out
    and the outputs are each rounded to bf16 once, 2^-9 relative, and the
    sums over T add those roundings with random signs, so the error stays a
    few roundings of the scale).  Times the f32 kernel (the trainer's
    dtype), its plain version and the backward of F.scaled_dot_product_attention
    (autograd forward + backward minus the forward; the port never calls it).
    The same at head dim 8, the block zoo's training shapes (K4_TRAIN_D8:
    B=48, H = channels / 8 at each level of a 1 s crop)."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, worst = [], 0.0
    for T, D, H, calls in [(T, D, 8, c) for T, D, c in K4_TRAIN] + K4_TRAIN_D8:
        q, k, v, dout = (torch.randn((TRAIN_B, T, H, D), generator=gen, device=dev) for _ in range(4))
        out, lse = k4.fused_attention_with_lse(q, k, v)
        out_p, lse_p = k4.fused_attention_plain(q, k, v)
        got = k4.attention_bwd(q, k, v, out, dout, lse)
        ref = k4.fused_attention_bwd_plain(q, k, v, out_p, dout, lse_p)
        torch.cuda.synchronize()
        e_out, e_lse = (out - out_p).abs().max().item(), (lse - lse_p).abs().max().item()
        if e_out > 2e-5 or e_lse > 1e-4:
            raise AssertionError(f"K4 fwd f32 B={TRAIN_B} T={T} D={D}: out err {e_out}, lse err {e_lse} "
                                 "(atol 2e-5 / 1e-4)")
        e32 = 0.0
        for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
            if not bool(((g - r).abs() <= 3e-5 + 1e-4 * r.abs()).all()):
                raise AssertionError(f"K4 bwd f32 T={T} D={D} {name}: max err {(g - r).abs().max().item()} "
                                     "over atol 3e-5 / rtol 1e-4")
            e32 = max(e32, (g - r).abs().max().item())
        qb, kb, vb, db = (x.bfloat16() for x in (q, k, v, dout))
        outb, lseb = k4.fused_attention_with_lse(qb, kb, vb)
        out32, lse32 = k4.fused_attention_plain(qb.float(), kb.float(), vb.float())
        ref32 = k4.fused_attention_bwd_plain(qb.float(), kb.float(), vb.float(), out32, db.float(), lse32)
        gotb = k4.attention_bwd(qb, kb, vb, outb, db, lseb)
        torch.cuda.synchronize()
        eb = []
        for g, r, name in zip(gotb, ref32, ("dq", "dk", "dv")):
            err, scale = (g.float() - r).abs().max().item(), r.abs().max().item()
            if err > 2**-5 * scale:
                raise AssertionError(f"K4 bwd bf16 T={T} D={D} {name}: max err {err} over 2^-5 of scale {scale}")
            eb.append(err / scale)
        worst = max(worst, e32)
        # two calls on the same inputs give bit-identical gradients (the
        # trainer's bitwise resume depends on it)
        for args in ((q, k, v, out, dout, lse), (qb, kb, vb, outb, db, lseb)):
            again = k4.attention_bwd(*args)
            first = k4.attention_bwd(*args)
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f"K4 bwd {args[0].dtype} T={T} D={D}: two calls differ")
        ms = cuda_time_ms(lambda: k4.attention_bwd(q, k, v, out, dout, lse), iters=50)
        device_ms = cuda_graph_time_ms(lambda: k4.attention_bwd(q, k, v, out, dout, lse))
        if k4.bwd_plan(TRAIN_B, T, H, D)["tile"] == 16:
            # the 16-key path (four heads a block) against 32-key tiles, which
            # give the same gradients bit for bit: device µs in turns
            wide = functools.partial(k4.bwd_plan, tile=32)
            with mock.patch.object(k4, "bwd_plan", wide):
                if not all(torch.equal(x, y) for x, y in zip(k4.attention_bwd(q, k, v, out, dout, lse), got)):
                    raise AssertionError(f"K4 bwd f32 T={T} D={D}: 32-key tiles differ from 16-key tiles")
            turns = {16: [], 32: []}
            for tile in (16, 32, 32, 16):
                with mock.patch.object(k4, "bwd_plan", k4.bwd_plan if tile == 16 else wide):
                    turns[tile].append(cuda_graph_time_ms(lambda: k4.attention_bwd(q, k, v, out, dout, lse)) * 1e3)
            print(f"K4 attention_bwd f32 B={TRAIN_B} T={T} H={H} D={D}: device us, 16-key tiles four heads a block "
                  f"{[round(x, 2) for x in turns[16]]} against 32-key tiles {[round(x, 2) for x in turns[32]]} "
                  f"(in turns; gradients bit-identical)")
        host = host_us(lambda: k4.attention_bwd(q, k, v, out, dout, lse))
        plain_ms = cuda_time_ms(lambda: k4.fused_attention_bwd_plain(q, k, v, out, dout, lse), iters=20)
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        dos = dout.transpose(1, 2).contiguous()
        t_fwd = cuda_time_ms(lambda: sdpa(qs, ks, vs), iters=50)
        t_both = cuda_time_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs), (qs, ks, vs), dos), iters=50)
        n = TRAIN_B * T * H * D
        # reads q, k, v, out, dout and the lse, writes dq, dk, dv; five T x T x D products a head
        bound_ms, bound_by = bound(8 * n * 4 + TRAIN_B * H * T * 4, 5 * 2 * T * T * D * TRAIN_B * H, F32_FLOPS)
        earlier = f" (earlier kernel {EARLIER_K4_BWD_US[T]:.1f} us)" if D != 8 else ""
        rows.append(dict(T=T, D=D, H=H, calls=calls, ms=ms, plain_ms=plain_ms, library_ms=t_both - t_fwd,
                         bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms))
        print(f"K4 attention_bwd B={TRAIN_B} T={T} H={H} D={D}: forward f32 out err {e_out:.2e} lse err "
              f"{e_lse:.2e}; backward f32 max err {e32:.2e}; bf16 vs f32 plain max err "
              f"{max(eb):.2e} of scale (limit 2^-5); two calls bit-identical (f32, bf16); kernel "
              f"{ms * 1e3:.1f} us/call back to back{earlier}, device "
              f"{device_ms * 1e3:.1f} us (CUDA graph), host {host:.1f} us; plain {plain_ms * 1e3:.1f} us, "
              f"SDPA backward {(t_both - t_fwd) * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}); "
              f"{calls} calls per forward")
    d8 = [r for r in rows if r["D"] == 8]
    rows = [r for r in rows if r["D"] != 8]
    step_ms = sum(r["ms"] * r["calls"] for r in rows)
    print(f"K4 attention_bwd per training step (32 calls): {step_ms * 1e3:.1f} us of kernel time back to back, "
          f"{sum(r['device_ms'] * r['calls'] for r in rows) * 1e3:.1f} us device (earlier kernel "
          f"{sum(EARLIER_K4_BWD_US[r['T']] * r['calls'] for r in rows):.1f} us back to back; plain "
          f"{sum(r['plain_ms'] * r['calls'] for r in rows) * 1e3:.1f} us)")
    print(f"K4 attention_bwd at head dim 8, B={TRAIN_B}: " + "; ".join(
        f"T={r['T']} H={r['H']} {r['device_ms'] * 1e3:.2f} us device, {r['ms'] * 1e3:.2f} us back to back, plain "
        f"{r['plain_ms'] * 1e3:.1f} us, SDPA backward {r['library_ms'] * 1e3:.1f} us, bound "
        f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})" for r in d8))
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms")
    return dict(max_abs_err=worst, rows=rows, step_ms=step_ms, d8_rows=d8, **{k: rows[0][k] for k in keys[:5]},
                **{"d8_" + k: d8[0][k] for k in keys})  # T=88, H=32: the zoo's largest


def f64_ties(x, cb, got, ref, what: str) -> tuple:
    """The rows where two argmins over the same codes (`got`, `ref`)
    differ, each required to be a tie that f32 cannot resolve: its two
    squared distances, recomputed in f64, within 1e-6 of the magnitude of
    the terms an f32 score ||c||^2 - 2 x.c sums (||c||^2 + 2 |x.c|, the
    larger of the two codes').  The score loses its low bits to that
    magnitude, not to the distance that is left after the cancellation, so
    sums in another order can flip a tie that close.  Returns (the rows,
    the largest f64 distance gap among them)."""
    import torch

    differ = (got.to(ref.device) != ref).nonzero()[:, 0]
    if not len(differ):
        return differ, 0.0
    x64, cb64 = x[differ.to(x.device)].double(), cb.double()
    c_got, c_ref = cb64[got[differ.to(got.device)].long()], cb64[ref[differ].long().to(cb.device)]
    d_got, d_ref = ((x64 - c_got) ** 2).sum(-1), ((x64 - c_ref) ** 2).sum(-1)
    scale = torch.maximum((c_got ** 2).sum(-1) + 2 * (x64 * c_got).sum(-1).abs(),
                          (c_ref ** 2).sum(-1) + 2 * (x64 * c_ref).sum(-1).abs())
    gap = (d_got - d_ref).abs()
    if not bool((gap <= 1e-6 * scale).all()):
        worst = int((gap / scale).argmax())
        raise AssertionError(f"K6 {what} {tuple(x.shape)} x {len(cb)}: {len(differ)} rows differ, not all f64 ties "
                             f"(largest gap {gap[worst].item():.3e} at a term magnitude {scale[worst].item():.3e})")
    return differ, gap.max().item()


def k6_row(k6, x, cb, what: str) -> dict:
    """K6 on (x, cb) against its plain version: ids equal, except that a
    row may differ on a tie f32 cannot resolve (`f64_ties`).  Times the kernel, its plain version and the cuBLAS f32
    product x @ cb.T alone (the yardstick; TF32 off); bound: x and cb read,
    the ids written, 2 N K D f32 operations.  Prints one line; returns its
    row with the kernel's ids."""
    import torch

    (N, D), K = x.shape, cb.shape[0]
    got = k6.kmeans_argmin(x, cb)
    differ, dist_err = f64_ties(x, cb, got, k6.kmeans_argmin_plain(x, cb), what)
    ms = cuda_time_ms(lambda: k6.kmeans_argmin(x, cb), iters=20)
    plain_ms = cuda_time_ms(lambda: k6.kmeans_argmin_plain(x, cb), iters=10)
    library_ms = cuda_time_ms(lambda: x @ cb.T, iters=20)
    bound_ms, bound_by = bound((N * D + K * D) * 4 + N * 4, 2 * N * K * D, F32_FLOPS)
    print(f"K6 kmeans_argmin {what} N={N} K={K} D={D}: {len(differ)} of {N} rows differ from the plain version "
          f"({len(differ) / N:.3%}; each an f64 tie, `f64_ties`; largest distance gap {dist_err:.3e}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS x @ codebook.T {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {2 * N * K * D / 1e9:.2f} GFLOP f32)")
    return dict(N=N, K=K, D=D, ids=got, differ=len(differ), max_abs_err=dist_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k6(dev) -> dict:
    """K6 against its plain version: exactly equal ids at the contract
    shapes (tests/test_pallas.py:119-131); at the trainer's size with a
    seeded random codebook `k6_row`, and its code-range split against one
    block per row tile."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6

    gen = torch.Generator(device=dev).manual_seed(0)
    for n, k, d in [(300, 700, 32), (256, 512, 64)]:
        x, cb = torch.randn((n, d), generator=gen, device=dev), torch.randn((k, d), generator=gen, device=dev)
        if not torch.equal(k6.kmeans_argmin(x, cb), k6.kmeans_argmin_plain(x, cb)):
            raise AssertionError(f"K6 at ({n}, {k}, {d}): ids differ from the plain version")
    N, K, D = K6_TRAIN
    x, cb = torch.randn((N, D), generator=gen, device=dev), torch.randn((K, D), generator=gen, device=dev)
    row = k6_row(k6, x, cb, "training (contract shapes: ids identical)")
    # the code-range split against one block per row tile (no merge kernel)
    splits = k6.split_codes(N, K, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    chosen, k6.split_codes = k6.split_codes, lambda n, k, sms: (1, -(-k // k6.BLOCK_CODES) * k6.BLOCK_CODES)
    try:
        if not torch.equal(k6.kmeans_argmin(x, cb), row["ids"]):
            raise AssertionError(f"K6 at ({N}, {K}, {D}): ids with one split differ from {splits} splits")
        ms_1 = cuda_time_ms(lambda: k6.kmeans_argmin(x, cb), iters=20)
    finally:
        k6.split_codes = chosen
    print(f"K6 at N={N}: {splits} code splits {row['ms']:.3f} ms vs 1 split {ms_1:.3f} ms")
    return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}


def write_train_layout(root: str, codebook: np.ndarray, seed: int = 0, speakers: int = 4) -> None:
    """A data/train layout: `speakers` x 96 files (with 4, 8 batches of 48 an
    epoch, so most steps find their batch prefetched as on a real corpus, and
    not every other one waits for an epoch's first batch); mel stats (T, 256) with
    T in [120, 160) latent frames (86.13 a second); units (T_u, 1280) at the
    encoder's 50 a second, each near a codebook row as k-means units are."""
    rng = np.random.default_rng(seed)
    for spk in range(1, speakers + 1):
        for n in range(96):
            T = int(rng.integers(120, 160))
            T_u = int(round(T * 50 / (44100 / 512)))
            ids = rng.integers(0, len(codebook), T_u)
            units = codebook[ids] + 0.3 * rng.standard_normal((T_u, codebook.shape[1])).astype(np.float32)
            stats = np.concatenate([rng.standard_normal((T, 128)), rng.uniform(-4, -1, (T, 128))], axis=1)
            for kind, arr in (("mel", stats), ("units", units)):
                os.makedirs(os.path.join(root, kind, str(spk)), exist_ok=True)
                np.save(os.path.join(root, kind, str(spk), f"{n}.wav.npy"), arr.astype(np.float32))
            os.makedirs(os.path.join(root, "audio", str(spk)), exist_ok=True)
            open(os.path.join(root, "audio", str(spk), f"{n}.wav"), "wb").close()


class StepLog:
    """Trainer logger (interval_log = 1): each step's loss, and the wall time
    between consecutive steps (the loss read synchronises the card)."""

    def __init__(self):
        self.losses, self.times, self.mfu = [], [], []

    def log(self, step: int, metrics: dict) -> None:
        self.losses.append(metrics["train/loss"])
        self.times.append(time.perf_counter())
        self.mfu.append(metrics.get("train/mfu"))


def compare_train_step(trainer, loader, dev):
    """One step's loss and gradients with K4 (forward and backward) and K6
    against the same step with the plain attention and plain argmin, f32,
    same batch and generator: loss within 1e-5 relative, every parameter's
    gradient within 1e-3 of its norm and all of them within 1e-4 of the
    global norm (L2; f32 sums in another order through the whole network)."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion import unet1d
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.quantize import codebook
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import step_generator

    loader.set_epoch(0)
    batch = trainer.device_put_batch(next(iter(loader)))
    results = []
    for plain in (False, True):
        if plain:
            unet1d.fused_attention = lambda q, k, v: k4.fused_attention_plain(q, k, v)[0]
            codebook.kmeans_argmin = k6.kmeans_argmin_plain
        try:
            trainer.optimizer.zero_grad(set_to_none=True)
            ids = trainer.quantizer.quantize(batch["units"])
            loss = trainer.loss(batch, step_generator(0, 0, dev))
            loss.backward()
        finally:
            unet1d.fused_attention = k4.fused_attention
            codebook.kmeans_argmin = k6.kmeans_argmin
        results.append((ids, loss.item(), {n: p.grad.clone() for n, p in trainer.system.module.named_parameters()
                                           if p.grad is not None}))
    trainer.optimizer.zero_grad(set_to_none=True)
    (ids, loss, grads), (ids_p, loss_p, grads_p) = results
    if not torch.equal(ids, ids_p):
        raise AssertionError(f"train step: K6 ids differ from the plain argmin in {(ids != ids_p).sum().item()} frames")
    if grads.keys() != grads_p.keys() or abs(loss - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"train step: loss {loss} vs plain {loss_p}")
    worst, worst_name = 0.0, ""
    for n, g in grads.items():
        rel = ((g - grads_p[n]).norm() / grads_p[n].norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, n
    total = (sum(((g - grads_p[n]) ** 2).sum() for n, g in grads.items()).sqrt()
             / sum((g ** 2).sum() for g in grads_p.values()).sqrt()).item()
    if worst > 1e-3 or total > 1e-4:
        raise AssertionError(f"train step gradients vs plain: worst {worst} ({worst_name}), global {total}")
    print(f"train step with K4 fwd/bwd + K6 vs plain attention + plain argmin (f32, B={TRAIN_B}): loss {loss:.6f} "
          f"vs {loss_p:.6f}; K6 ids identical ({ids.numel()} frames); gradients of {len(grads)} tensors: worst "
          f"relative L2 error {worst:.2e} ({worst_name}; limit 1e-3), global {total:.2e} (limit 1e-4)")


def step_breakdown(trainer, loader, dev) -> dict:
    """Where a training step's time goes: the loader alone (host ms a batch
    over one epoch, nothing else running), train_step on one batch already
    on the card (ms a step, no data path), and the device time per step by
    kernel (torch.profiler, CUDA activity only, over PROFILED_STEPS steps):
    K4 forward, K4 backward, K6 and all kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import step_generator

    loader.set_epoch(0)
    t0, n = time.perf_counter(), 0
    for batch in loader:
        n += 1
    loader_ms = (time.perf_counter() - t0) / n * 1e3
    batch = trainer.device_put_batch(batch)
    trainer.train_step(batch, step_generator(0, trainer.step, dev))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2 * PROFILED_STEPS):
        trainer.train_step(batch, step_generator(0, trainer.step, dev))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (2 * PROFILED_STEPS) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            trainer.train_step(batch, step_generator(0, trainer.step, dev))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / PROFILED_STEPS
    sums = {"attention_fwd": 0.0, "attention_bwd": 0.0, "kmeans_argmin": 0.0, "all": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else e.self_cuda_time_total
        sums["all"] += us
        for name, patterns in (("attention_fwd", ("attention_fwd_kernel",)),
                               ("attention_bwd", ("attention_bwd_kernel",)),
                               ("kmeans_argmin", ("kmeans_argmin_kernel", "kmeans_merge_kernel"))):
            if any(pattern in e.key for pattern in patterns):
                sums[name] += us
    return dict(wall_ms=wall * 1e3, loader_ms=loader_ms, step_ms=step_ms,
                **{k: v / 1e3 / PROFILED_STEPS for k, v in sums.items()})


def check_native_checkpoint(cfg, dev) -> None:
    """`infer/load.py::load_native_pipeline` over the training phase's
    experiment directory: its Unit2Mel's state equals the trainer's saved
    state (the EMA sidecar's parameters where the trainer saved one)."""
    import torch

    from latent_diffusion_speech_tpu_torch.infer.load import load_native_pipeline
    from latent_diffusion_speech_tpu_torch.train.checkpoint import load_checkpoint, load_checkpoint_extra

    expdir = cfg.diffusion.train.expdir
    step, params, _ = load_checkpoint(expdir)
    ema = load_checkpoint_extra(expdir, "ema", step)
    want = {**params, **(ema or {})}
    pipe = load_native_pipeline(cfg, expdir, dtype=torch.float32, device=dev)
    got = pipe.diffusion.module.state_dict()
    differ = sorted(n for n in want if n not in got or not torch.equal(got[n].cpu(), want[n]))
    if got.keys() != want.keys() or differ:
        raise AssertionError(f"load_native_pipeline: state differs from model_{step}.ckpt at {differ[:5]}")
    print(f"load_native_pipeline({expdir}): the Unit2Mel's {len(got)} tensors equal model_{step}.ckpt"
          f"{' with its EMA sidecar' if ema is not None else ' (no EMA sidecar: ema_decay 0)'}")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block (restored after)."""
    import torch

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


class LaunchNames:
    """Counts the K4 C entries launched (by name) while active: the entry
    says the dtype (`attention_fwd_bf16`, `attention_bwd_f32`, ...)."""

    def __init__(self):
        from latent_diffusion_speech_tpu_torch.ops.kernels import build

        self.build, self.names = build, {}

    def __enter__(self):
        real = self.build.launch_packed

        def launch(name, index, pack):
            self.names[name] = self.names.get(name, 0) + 1
            return real(name, index, pack)

        self._patch = mock.patch.object(self.build, "launch_packed", launch)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def relative_l2(got: dict, ref: dict) -> float:
    """sqrt(sum |got - ref|^2) / sqrt(sum |ref|^2) over tensors of the same names."""
    import torch

    num = sum(((got[n].float().cpu() - r.float().cpu()) ** 2).sum() for n, r in ref.items())
    return (torch.sqrt(num) / torch.sqrt(sum((r.float().cpu() ** 2).sum() for r in ref.values()))).item()


def train_options(cfg, trainer, loader, dev, card: str) -> dict:
    """The trainer's options at flagship width (B=48, the k-means snap),
    each from the weights of the entry point's trainer: accumulation (k=2:
    two micro-steps against one update from the mean gradient, then the
    loop with `train/mfu` in metrics.jsonl), the learned VQ, bf16 (K4's
    bf16 entries; loss and step time beside f32), remat (gradients equal,
    peak memory), and `validate_full` with a vocoder.  Returns the K4 and K6
    launches these runs made."""
    import torch

    from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.audio_io import read_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.quantize.codebook import VectorQuantize
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer, step_generator
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import deterministic_algorithms
    from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger

    weights = {k: v.clone() for k, v in trainer.system.module.state_dict().items()}
    expdir = cfg.diffusion.train.expdir
    k4.launches = k4.bwd_launches = k6.launches = 0

    def make(name, **kw):
        c = copy.deepcopy(cfg)
        c.diffusion.train.expdir = os.path.join(expdir + "_options", name)
        for k, v in kw.pop("train", {}).items():
            setattr(c.diffusion.train, k, v)
        t = DiffusionTrainer(c, quantizer=kw.pop("quantizer", trainer.quantizer), device=dev, **kw)
        t.system.module.load_state_dict(weights)
        return t

    loader.set_epoch(0)
    it = iter(loader)
    b1, b2 = (trainer.device_put_batch(next(it)) for _ in range(2))
    gen = functools.partial(step_generator, cfg.diffusion.train.seed, device=dev)

    # accumulation: two micro-steps against the mean of the two gradients,
    # deterministic kernels in both (cuDNN's and the embedding backward's)
    t_acc = make("accumulate", train={"gradient_accumulation_steps": 2})
    t_ref = make("reference")
    with deterministic_cudnn(), deterministic_algorithms():
        t_acc.train_step(b1, gen(0))
        t_acc.train_step(b2, gen(1))
        grads = []
        for s, b in enumerate((b1, b2)):
            t_ref.optimizer.zero_grad(set_to_none=True)
            t_ref.loss(b, gen(s)).backward()
            grads.append([p.grad.clone() for p in t_ref._params])
        for p, a, c in zip(t_ref._params, *grads):
            p.grad = a + (c - a) / 2  # MultiSteps' running mean of two
        t_ref.apply_update()
    got = dict(t_acc.system.module.named_parameters())
    ref = dict(t_ref.system.module.named_parameters())
    acc_err = max((got[n] - r).abs().max().item() for n, r in ref.items())
    moved = relative_l2(ref, weights)
    if t_acc.opt_count != 1 or acc_err > 1e-6:
        raise AssertionError(f"accumulation: {t_acc.opt_count} updates, parameters differ by {acc_err}")
    del t_ref
    logger = MetricsLogger(t_acc.cfg.diffusion.train.expdir, use_tensorboard=False)
    t_acc.cfg.diffusion.train.interval_log = 1
    t_acc.train(loader, max_steps=6, logger=logger)
    logger.close()
    rows = [json.loads(x) for x in open(os.path.join(t_acc.cfg.diffusion.train.expdir, "logs", "metrics.jsonl"))]
    mfu = [r["train/mfu"] for r in rows if "train/mfu" in r]
    if t_acc.opt_count != 3 or len(mfu) != len(rows) or not rows:
        raise AssertionError(f"accumulation loop: {t_acc.opt_count} updates after 6 micro-steps; metrics {rows}")
    print(f"train option gradient_accumulation_steps=2 [{card}]: the update after two micro-steps (B={TRAIN_B} each) "
          f"equals one update from the mean of their gradients within {acc_err:.2e} (limit 1e-6; the update moved "
          f"the weights by {moved:.2e} of their norm); 6 micro-steps through train() = {t_acc.opt_count} updates; "
          f"train/mfu in metrics.jsonl: {[round(x, 4) for x in mfu]}")
    del t_acc

    # the learned VQ: K4 runs, K6 does not
    before = (k4.launches, k4.bwd_launches, k6.launches)
    t_vq = make("vq", quantizer=VectorQuantize(1280, 4096))
    t_vq.train(loader, max_steps=2)
    vq_launches = (k4.launches - before[0], k4.bwd_launches - before[1], k6.launches - before[2])
    util = t_vq._vq.utilization(t_vq.vq_state).item()
    sidecar = os.path.join(t_vq.cfg.diffusion.train.expdir, "model_2_semantic_codebook.ckpt")
    if vq_launches != (64, 64, 0) or not util > 0 or not os.path.exists(sidecar):
        raise AssertionError(f"VQ training: launches {vq_launches} (want 64 / 64 / 0 over 2 steps), "
                             f"utilisation {util}, sidecar {os.path.exists(sidecar)}")
    print(f"train option quantizer=VectorQuantize(1280, 4096) [{card}]: 2 steps, K4 fwd/bwd/K6 launches {vq_launches}; "
          f"codebook utilisation {util:.4f}; {os.path.basename(sidecar)} written")
    del t_vq

    # bf16 against f32 from the same weights, batch and generator
    losses, step_ms, names = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        t = make(f"dtype_{dtype}".replace("torch.", ""), dtype=dtype)
        with LaunchNames() as ln:
            losses[dtype] = t.train_step(b1, gen(0))["loss"].item()
        names[dtype] = ln.names
        for _ in range(2):
            t.train_step(b1, gen(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(5):
            t.train_step(b1, gen(2 + s))
        torch.cuda.synchronize()
        step_ms[dtype] = (time.perf_counter() - t0) / 5 * 1e3
        del t
    if names[torch.bfloat16] != {"attention_fwd_bf16": 32, "attention_bwd_bf16": 32}:
        raise AssertionError(f"bf16 step launched {names[torch.bfloat16]}, want 32 bf16 K4 forward and backward")
    rel = abs(losses[torch.bfloat16] - losses[torch.float32]) / abs(losses[torch.float32])
    if not np.isfinite(losses[torch.bfloat16]) or rel > 5e-2:
        raise AssertionError(f"bf16 loss {losses[torch.bfloat16]} vs f32 {losses[torch.float32]}")
    print(f"train option dtype=torch.bfloat16 [{card}]: one step's entries {names[torch.bfloat16]} (f32: "
          f"{names[torch.float32]}); loss {losses[torch.bfloat16]:.6f} vs f32 {losses[torch.float32]:.6f} "
          f"(relative {rel:.2e}, limit 5e-2); train_step {step_ms[torch.bfloat16]:.2f} ms vs f32 "
          f"{step_ms[torch.float32]:.2f} ms (B={TRAIN_B}, 5 steps each after 2 warm-up, batch on the card)")

    # remat: the same gradients, less memory
    res = {}
    for remat in (False, True):
        t = make(f"remat_{remat}", remat=remat)
        t.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with LaunchNames() as ln, deterministic_cudnn(), deterministic_algorithms():
            loss = t.loss(b1, gen(0))
            loss.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        res[remat] = (loss.item(), {n: p.grad.clone() for n, p in t.system.module.named_parameters()}, peak, ln.names)
        del t
    (l0, g0, p0, n0), (l1, g1, p1, n1) = res[False], res[True]
    worst = max(((g1[n] - g).norm() / g.norm().clamp_min(1e-30)).item() for n, g in g0.items())
    same = all(torch.equal(g1[n], g) for n, g in g0.items())
    if abs(l1 - l0) > 1e-6 * abs(l0) or worst > 1e-5:
        raise AssertionError(f"remat: loss {l1} vs {l0}, gradients' worst relative error {worst}")
    print(f"train option remat=True [{card}]: loss {l1:.7f} vs {l0:.7f}; gradients {'bitwise equal' if same else ''}"
          f" (worst relative L2 error {worst:.2e}, limit 1e-5); peak memory of the forward + backward "
          f"{p1:.2f} GiB vs {p0:.2f} GiB without; launches {n1} vs {n0}")

    # validate_full with a vocoder: the spectrogram triptych and a WAV
    t = make("validate")
    vdir = t.cfg.diffusion.train.expdir
    logger = MetricsLogger(vdir, use_tensorboard=False)
    voc = Vocoder("hifi-vaegan", device=dev)
    t0 = time.perf_counter()
    metrics = t.validate_full(DataLoader(loader.dataset, 4, shuffle=False),
                              step_generator(cfg.diffusion.train.seed, 0, dev, 1), logger=logger, vocoder=voc,
                              max_batches=1)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    logger.close()
    wav, sr = read_wav(os.path.join(vdir, "logs", "audio", "val_audio_0.wav"))
    spec = np.load(os.path.join(vdir, "logs", "spec", "val_spec_0.npz"))
    if sr != voc.vocoder_sample_rate or not len(wav) or spec["pred"].shape != spec["gt"].shape or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"validate_full: {metrics}, {sr} Hz, {len(wav)} samples, spec {spec['pred'].shape}")
    print(f"validate_full(vocoder=) [{card}]: {metrics} in {val_s:.2f} s (B=4, {cfg.common.infer.method} at speedup "
          f"{cfg.common.infer.speedup}); val_audio_0.wav {len(wav) / sr:.3f} s at {sr} Hz; val_spec_0.npz "
          f"{spec['pred'].shape} x 3")
    return {"attention_fwd": k4.launches, "attention_bwd": k4.bwd_launches, "kmeans_argmin": k6.launches}


def train_slice(dev, card: str, k4_bwd: dict, k6_res: dict) -> dict:
    """The diffusion training slice at flagship width: `configs/config.yaml`
    through the port's entry point, f32, B=48, the k-means snap on."""
    import tempfile

    import torch

    from latent_diffusion_speech_tpu_torch.cli.train_diffusion import build
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        cb = np.random.default_rng(1).standard_normal((4096, 1280)).astype(np.float32)
        write_train_layout(os.path.join(tmp, "train"), cb)
        np.savez(os.path.join(tmp, "codebook.npz"), cluster_centers_=cb)
        cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
        cfg.data.train_path = os.path.join(tmp, "train")
        cfg.text2semantic.model.codebook_path = os.path.join(tmp, "codebook.npz")
        cfg.diffusion.train.expdir = os.path.join(tmp, "exp")
        cfg.diffusion.train.interval_log = 1
        tcfg = cfg.diffusion.train
        if (tcfg.batch_size, cfg.data.duration, tcfg.gradient_accumulation_steps) != (TRAIN_B, 1.0, 1):
            raise AssertionError("configs/config.yaml no longer trains at B=48 on 1 s crops")

        # the entry point itself must turn TF32 off: f32 training
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        trainer, loader = build(cfg, device=dev)
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise AssertionError("the training entry point left TF32 on")
        compare_train_step(trainer, loader, dev)

        torch.cuda.reset_peak_memory_stats(dev)
        k4.launches = k4.bwd_launches = k6.launches = 0
        logs = []
        t0 = time.perf_counter()
        for steps in (TRAIN_STEPS[0], sum(TRAIN_STEPS)):
            if logs:  # the second leg resumes from the first leg's checkpoint
                trainer, loader = build(cfg, device=dev)
                if trainer.step != TRAIN_STEPS[0]:
                    raise AssertionError(f"resume: step {trainer.step}, want {TRAIN_STEPS[0]}")
            logs.append(StepLog())
            start = time.perf_counter()
            trainer.train(loader, max_steps=steps, logger=logs[-1])
            logs[-1].times.insert(0, start)
        wall = time.perf_counter() - t0
        n = sum(TRAIN_STEPS)
        launches = {"attention_fwd": k4.launches, "attention_bwd": k4.bwd_launches, "kmeans_argmin": k6.launches}
        if launches != {"attention_fwd": 32 * n, "attention_bwd": 32 * n, "kmeans_argmin": n}:
            raise AssertionError(f"training launches {launches} over {n} steps, want 32 / 32 / 1 per step")
        losses = [x for log in logs for x in log.losses]
        if len(losses) != n or not all(np.isfinite(losses)):
            raise AssertionError(f"training losses {losses}")
        saved = sorted(os.listdir(tcfg.expdir))
        if f"model_{TRAIN_STEPS[0]}.ckpt" not in saved or f"model_{n}.ckpt" not in saved:
            raise AssertionError(f"checkpoints {saved}")
        # step times: the first step of each leg includes its start-up
        step_s = [b - a for log in logs for a, b in zip(log.times, log.times[1:])]
        steady = [s for i, s in enumerate(step_s) if i not in (0, TRAIN_STEPS[0])]
        median = float(np.median(steady))
        q1, q3 = (float(v) for v in np.percentile(steady, [25, 75]))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        shares = step_breakdown(trainer, loader, dev)
        check_native_checkpoint(cfg, dev)
        mfu = [x for log in logs for x in log.mfu]
        if any(x is None for x in mfu):
            raise AssertionError(f"train/mfu missing from logged steps: {mfu}")
        options = train_options(cfg, trainer, loader, dev, card)

    kern = k4_bwd["rows"]
    est = {
        "attention_bwd": k4_bwd["step_ms"],
        "kmeans_argmin": k6_res["ms"],
    }
    print(f"training slice [{card}]: {n} steps at B={TRAIN_B} f32 ({TRAIN_STEPS[0]}, save, resume, "
          f"{TRAIN_STEPS[1]} more) in {wall:.3f} s; losses {[round(x, 5) for x in losses]}")
    print(f"training step [{card}]: median {median * 1e3:.2f} ms over {len(steady)} steps after the first "
          f"step of each leg (quartiles {q1 * 1e3:.2f} / {q3 * 1e3:.2f} ms; all: "
          f"{[round(s * 1e3, 2) for s in step_s]} ms); {TRAIN_B / median:.1f} samples/s; "
          f"peak allocated {peak:.2f} GiB; train/mfu (products a step x steps/s / bf16 peak) median "
          f"{float(np.median(mfu)):.4f}")
    print(f"training launches over {n} steps: {launches} (per step: 32 / 32 / 1); the options' runs: {options}")
    if shares["all"] > 0:
        # idle shares against unprofiled steps: the profiler's own host
        # cost lengthens the profiled ones
        print(f"training step parts [{card}]: loader alone {shares['loader_ms']:.2f} ms a batch; train_step on "
              f"a batch already on the card {shares['step_ms']:.2f} ms; {PROFILED_STEPS} profiled steps "
              f"{shares['wall_ms']:.2f} ms wall each, device busy {shares['all']:.2f} ms a step: "
              f"{1 - shares['all'] / shares['step_ms']:.1%} idle of the train_step alone, "
              f"{1 - shares['all'] / (median * 1e3):.1%} of the median step through train(); K4 forward "
              f"{shares['attention_fwd']:.3f} ms ({shares['attention_fwd'] / shares['all']:.1%} of busy), "
              f"K4 backward {shares['attention_bwd']:.3f} ms ({shares['attention_bwd'] / shares['all']:.1%}), "
              f"K6 {shares['kmeans_argmin']:.3f} ms ({shares['kmeans_argmin'] / shares['all']:.1%})")
    else:
        print("profiled training steps: the profiler reported no device time (shares not measured)")
    print(f"from the standalone kernel times [{card}]: K4 backward {est['attention_bwd']:.3f} ms and K6 "
          f"{est['kmeans_argmin']:.3f} ms per step = {(est['attention_bwd'] + est['kmeans_argmin']) / (median * 1e3):.1%} "
          f"of the median step (K4 backward rows: "
          f"{[(r['T'], r['D'], round(r['ms'] * 1e3, 1)) for r in kern]} us)")
    return dict(launches=launches, options=options, median_ms=median * 1e3, shares=shares)


# lm_train: the shipped RoFormer at full width (configs/config.yaml: 4 + 1
# layers, C=256, H=8, FF 512, V=4099, B=32, f32, dropout 0.1) trained through
# stage 21 on a synthetic corpus written by the port's stages 15 and 16
LM_B, LM_STEPS, LM_VAL_AT = 32, (3, 12), 10  # batch; steps before / after the resume; the interval_val step
LM_UTTS = (96, 32)  # train and valid utterances over spk0-spk3
LM_WORDS = tuple((
    "the a quick brown fox jumps over lazy dog and then it runs back home we will start meeting soon "
    "is weather fine today please read following sentence slowly clearly how are you good morning "
    "everyone here bring book table water music light window garden river mountain city people "
    "little great small house after before never always very often together between story world").split())


def write_lm_corpus(root: str, n: int, seed: int) -> dict:
    """The LM's training layout through the port's own stages: `n` EN
    utterances over spk0-spk3 (6-33 seeded words, one `.txt` label and an
    empty `.wav` each), stage 15 (`merge_labels`), stage 16 (`process_tts`,
    EN: the card machine has no jieba), then seeded token ids in stage 19's
    format (`semantic_token/<spk>/<i>.wav.npy`, int32), ~7 a phone, 150-1022
    of them.  Returns {name: semantic length}."""
    from latent_diffusion_speech_tpu_torch.cli.preprocess_text import merge_labels
    from latent_diffusion_speech_tpu_torch.cli.preprocess_tts import process_tts

    rng, tok_rng = np.random.default_rng(seed), np.random.default_rng(seed + 1)
    for i in range(n):
        spk_dir = os.path.join(root, "audio", f"spk{i % 4}")
        os.makedirs(spk_dir, exist_ok=True)
        words = rng.choice(LM_WORDS, int(rng.integers(6, 34)))
        open(os.path.join(spk_dir, f"{i // 4}.wav"), "wb").close()
        with open(os.path.join(spk_dir, f"{i // 4}.txt"), "w", encoding="utf-8") as f:
            f.write(" ".join(words).capitalize() + ".\n")
    n_labels = merge_labels(root)
    phones = dict(process_tts(root, language="EN"))
    if n_labels != n or len(phones) != n:
        raise AssertionError(f"stages 15/16: {n_labels} labels, {len(phones)} utt files for {n} utterances")
    lens = {}
    for name, n_ph in phones.items():
        lens[name] = int(np.clip(round(7 * n_ph * rng.uniform(0.9, 1.1)), 150, 1022))
        path = os.path.join(root, "semantic_token", name + ".npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, tok_rng.integers(0, 4096, lens[name]).astype(np.int32))
    return lens


def same_state(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, bitwise equal."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def lm_batch_stats(loader, epochs) -> list:
    """(semantic bucket, non-pad semantic tokens, semantic pad share) of
    every batch of `epochs`, as the trainer sees them."""
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        for b in loader:
            mask = b["attention_mask"]
            out.append((mask.shape[1], int(mask.sum()), 1.0 - mask.sum() / mask.size))
    return out


def compare_lm_step(cfg, batch, dev) -> str:
    """One LMTrainer step with dropout off on the card (TF32 off) against
    the same step on the CPU, from the same seeded weights and batch: the
    loss within rtol 1e-5 and every gradient element within atol 1e-5,
    rtol 1e-4 (the CPU tests' tolerance against jax.grad)."""
    from latent_diffusion_speech_tpu_torch.models.lm.registry import roformer_config_from
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    lm_cfg = roformer_config_from(cfg)
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    lm_cfg = dataclasses.replace(lm_cfg, encoder=dataclasses.replace(lm_cfg.encoder, **off),
                                 decoder=dataclasses.replace(lm_cfg.decoder, **off))
    got = []
    for device in (dev, "cpu"):
        trainer = LMTrainer(cfg, lm_cfg=lm_cfg, device=device)
        t0 = time.perf_counter()
        loss = trainer.train_step(trainer.device_put_batch(batch))["loss"].item()
        got.append((loss, {n: p.grad.cpu() for n, p in trainer.system.module.named_parameters()},
                    time.perf_counter() - t0))
        del trainer
    (loss, grads, t_card), (loss_p, grads_p, t_cpu) = got
    if abs(loss - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"LM step: loss {loss} on the card vs {loss_p} on the CPU")
    worst, worst_name, worst_margin = 0.0, "", -1.0
    for n, g in grads.items():
        d = (g - grads_p[n]).abs()
        margin = (d - 1e-5 - 1e-4 * grads_p[n].abs()).max().item()
        if margin > 0:
            raise AssertionError(f"LM step gradient {n}: max err {d.max().item()} beyond atol 1e-5 + rtol 1e-4")
        if d.max().item() > worst:
            worst, worst_name = d.max().item(), n
        worst_margin = max(worst_margin, margin)
    return (f"loss {loss:.7f} on the card vs {loss_p:.7f} on the CPU; gradients of {len(grads)} tensors within "
            f"atol 1e-5 + rtol 1e-4, largest error {worst:.3e} ({worst_name}); step {t_card * 1e3:.1f} ms on "
            f"the card (first call) and {t_cpu:.2f} s on the CPU")


def lm_train(dev, card: str) -> dict:
    """The LM training slice (stages 15, 16, 21) and the serve of its
    checkpoint through K1, at the shipped config's full LM width."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from latent_diffusion_speech_tpu_torch.cli import train_lm
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.config import load_config, save_config
    from latent_diffusion_speech_tpu_torch.data.lm_dataset import TextDataset
    from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
    from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig
    from latent_diffusion_speech_tpu_torch.ops.audio_io import read_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.train.checkpoint import load_checkpoint
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
    from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        t0 = time.perf_counter()
        lens = write_lm_corpus(os.path.join(tmp, "train"), LM_UTTS[0], 0)
        write_lm_corpus(os.path.join(tmp, "val"), LM_UTTS[1], 1)
        corpus_s = time.perf_counter() - t0
        cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
        m, tcfg = cfg.text2semantic.model, cfg.text2semantic.train
        shipped = (tcfg.batch_size, m.encoder.num_hidden_layers, m.decoder.num_hidden_layers, m.encoder.hidden_size,
                   m.encoder.num_attention_heads, m.encoder.intermediate_size, m.semantic_kmeans_num + 3,
                   m.encoder.hidden_dropout_prob, m.encoder.attention_probs_dropout_prob, tcfg.length_sorted,
                   tcfg.gradient_accumulation_steps)
        if shipped != (LM_B, 4, 1, 256, 8, 512, 4099, 0.1, 0.1, True, 1):
            raise AssertionError(f"configs/config.yaml no longer trains the LM at this phase's width: {shipped}")
        cfg.data.train_path, cfg.data.valid_path = os.path.join(tmp, "train"), os.path.join(tmp, "val")
        cfg.text2semantic.model.codebook_path = os.path.join(tmp, "no-codebook.npz")
        cfg.diffusion.train.expdir = os.path.join(tmp, "no-diffusion")  # the frozen stack: seeded weights
        tcfg.loader_processes, tcfg.interval_log, tcfg.interval_val = 2, 1, LM_VAL_AT
        tcfg.expdir = os.path.join(tmp, "exp_lm")
        cfg_path = os.path.join(tmp, "config.yaml")
        save_config(cfg, cfg_path)
        n = sum(LM_STEPS)

        # the reference run: 15 steps uninterrupted (no validation), through build
        cfg_a = copy.deepcopy(cfg)
        cfg_a.text2semantic.train.expdir = os.path.join(tmp, "exp_lm_a")
        cfg_a.text2semantic.train.interval_val = 10 ** 9
        trainer_a, loader_a, val_a, logger_a, pipe_a = train_lm.build(cfg_a, device=dev)
        if pipe_a is None:
            raise AssertionError("stage 21 built no validation pipeline on the card")
        del pipe_a
        threads = DataLoader(loader_a.dataset, LM_B, collate=loader_a.collate, seed=tcfg.seed, length_sorted=True)
        stats = lm_batch_stats(threads, range(n // len(threads)))
        unsorted = lm_batch_stats(DataLoader(loader_a.dataset, LM_B, collate=loader_a.collate, seed=tcfg.seed),
                                  range(n // len(threads)))
        buckets = sorted({s for s, _, _ in stats[: len(threads)]})
        if len(stats) != n or not {448, 1024} <= set(buckets):
            raise AssertionError(f"{len(stats)} batches in {n // len(threads)} epochs; epoch 0 buckets {buckets}")
        longest = max(range(len(threads)), key=lambda i: stats[i][0])
        threads.set_epoch(0)
        step_batch = [b for i, b in zip(range(longest + 1), threads)][-1]
        print(f"lm_train corpus: {LM_UTTS[0]} + {LM_UTTS[1]} EN utterances through stages 15 and 16 and stage-19 "
              f"format tokens in {corpus_s:.2f} s; semantic lengths {min(lens.values())}-{max(lens.values())} "
              f"(with BOS/EOS); epoch 0 buckets {buckets}")
        print(f"lm_train step, card vs CPU (dropout off, f32, B={LM_B}, S={step_batch['semantic'].shape[1]}) "
              f"[{card}]: {compare_lm_step(cfg, step_batch, dev)}")

        # spawn workers against the threads: epoch 0's first two batches
        loader_a.set_epoch(0)
        threads.set_epoch(0)
        t0 = time.perf_counter()
        from_workers = [b for _, b in zip(range(2), loader_a)]
        workers_s = time.perf_counter() - t0
        for bw, bt in zip(from_workers, [b for _, b in zip(range(2), threads)], strict=True):
            if bw.keys() != bt.keys() or not all(np.array_equal(bw[k], bt[k]) for k in bt):
                raise AssertionError("lm_train: a worker batch differs from the threaded loader's")
        print(f"lm_train loader: the first 2 batches from {tcfg.loader_processes} spawn workers equal the threaded "
              f"loader's ({workers_s:.2f} s to the second batch, the pool's start-up included)")
        trainer_a.train(loader_a, max_steps=n)
        loader_a.close()
        val_a.close()
        logger_a.close()
        if trainer_a.step != n:
            raise AssertionError(f"reference run ended at step {trainer_a.step}")

        # the main path: stage 21's main as a user runs it, 3 steps; again:
        # resume, 12 more (evaluate + validate_audio at step 10); then serve
        times, losses, val_logs, val = [], [], [], {}
        real_log, real_validate = MetricsLogger.log, LMTrainer.validate_audio

        def log(self, step, metrics):
            if "train/loss" in metrics:
                times[-1].append(time.perf_counter())
                losses.append(metrics["train/loss"])
            else:
                val_logs.append((step, metrics))
            return real_log(self, step, metrics)

        def validate_audio(self, *a, **kw):
            torch.cuda.synchronize()
            before, t0 = k1.launches, time.perf_counter()
            out = real_validate(self, *a, **kw)
            torch.cuda.synchronize()
            val.update(step=self.step, s=time.perf_counter() - t0, k1=k1.launches - before)
            return out

        k1.launches = 0
        k4.launches = k4.bwd_launches = 0
        with mock.patch.object(MetricsLogger, "log", log), mock.patch.object(LMTrainer, "validate_audio",
                                                                              validate_audio):
            for steps in (LM_STEPS[0], n):
                times.append([time.perf_counter()])
                train_lm.main(["-c", cfg_path, "--max-steps", str(steps)])
        if len(losses) != n or not all(np.isfinite(losses)):
            raise AssertionError(f"lm_train losses {losses}")
        if val.get("step") != LM_VAL_AT or val["k1"] != 1 or [s for s, _ in val_logs] != [LM_VAL_AT]:
            raise AssertionError(f"lm_train validation: {val}, {val_logs}")
        audio = os.path.join(tcfg.expdir, "logs", "audio", f"val_audio_0_{LM_VAL_AT}.wav")
        wav, sr = read_wav(audio)
        if sr != 44100 or not len(wav) or not np.isfinite(wav).all():
            raise AssertionError(f"{audio}: {sr} Hz, {wav.shape}")

        # the resumed run bitwise equals the uninterrupted one
        expdir_a = cfg_a.text2semantic.train.expdir
        (step_a, params_a, opt_a), (step_b, params_b, opt_b) = (load_checkpoint(e) for e in (expdir_a, tcfg.expdir))
        differ = [k for k in params_a if not torch.equal(params_a[k], params_b[k])]
        if (step_a, step_b) != (n, n) or params_a.keys() != params_b.keys() or differ or not same_state(opt_a, opt_b):
            raise AssertionError(f"resume: steps {step_a} / {step_b}, parameters differ at {differ[:5]}")

        # train/mfu beside every logged step of stage 21's run
        rows = [json.loads(x) for x in open(os.path.join(tcfg.expdir, "logs", "metrics.jsonl"))]
        lm_mfu = [r.get("train/mfu") for r in rows if "train/loss" in r]
        if len(lm_mfu) != n or any(x is None for x in lm_mfu):
            raise AssertionError(f"lm_train: train/mfu in metrics.jsonl {lm_mfu}")

        # the infer_tts CLI with --lm-model, a process on a copy of the last
        # checkpoint and the config, checked after the last phase
        cli_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, "exp"))
        shutil.copy(os.path.join(tcfg.expdir, f"model_{n}.ckpt"), cli_dir)
        shutil.copy(cfg_path, cli_dir)
        cli_out = os.path.join(cli_dir, "lm_cli.wav")
        cli_cmd = [sys.executable, "-m", "latent_diffusion_speech_tpu_torch.cli.infer_tts", "-c",
                   os.path.join(cli_dir, os.path.basename(cfg_path)), "-l", "EN", "-i", CLI_TEXT, "-o", cli_out,
                   "--lm-model", cli_dir]
        t_cli = time.perf_counter()
        cli = start_process(cli_cmd)

        def check_cli() -> None:
            finish_process(cli, cli_cmd)
            cli_s = time.perf_counter() - t_cli
            cli_wav, cli_sr = read_wav(cli_out)
            shutil.rmtree(cli_dir)
            if cli_sr != 44100 or not len(cli_wav) or not np.isfinite(cli_wav).all():
                raise AssertionError(f"{cli_out}: {cli_sr} Hz, {cli_wav.shape}")
            print(f"lm_train CLI infer_tts --lm-model [{card}]: exit 0, checked {cli_s:.1f} s after its start (a new "
                  f"process, started by lm_train and running beside the phases that follow); "
                  f"{len(cli_wav) / cli_sr:.3f} s at {cli_sr} Hz")

        DEFERRED.append(check_cli)

        # gradient accumulation (k = 2): 5 micro-steps in one go against 3,
        # a save half-way through an update, a resume and 2 more
        acc = {}
        for name in ("c", "d"):
            cfg_k = copy.deepcopy(cfg)
            tk = cfg_k.text2semantic.train
            tk.gradient_accumulation_steps, tk.save_opt, tk.interval_val = 2, True, 10 ** 9
            tk.expdir = os.path.join(tmp, f"exp_lm_accumulate_{name}")
            t_k = LMTrainer(cfg_k, device=dev)
            t_k.train(threads, max_steps=5 if name == "c" else 3)
            if name == "d":
                t_k = LMTrainer(cfg_k, device=dev)
                if not t_k.resume() or (t_k.step, t_k.mini_step, t_k.opt_count) != (3, 1, 1):
                    raise AssertionError(f"lm accumulation resume: step {t_k.step}, mini-step {t_k.mini_step}")
                t_k.train(threads, max_steps=5)
            acc[name] = t_k
        pc, pd = (dict(acc[k].system.module.named_parameters()) for k in ("c", "d"))
        acc_differ = [k for k in pc if not torch.equal(pc[k], pd[k])]
        if acc_differ or acc["c"].opt_count != 2 or not all(torch.equal(a, b) for a, b in zip(acc["c"]._acc,
                                                                                              acc["d"]._acc)):
            raise AssertionError(f"lm accumulation: the resumed run differs at {acc_differ[:5]}")
        del acc, pc, pd

        # serve the checkpoint: build_pipeline(lm_ckpt=) in bf16, one tts
        pipe = build_pipeline(cfg, lm_ckpt=tcfg.expdir)
        served = pipe.lm.module.state_dict()
        if any(not torch.equal(served[k].cpu(), v.to(served[k].dtype)) for k, v in params_b.items()):
            raise AssertionError("build_pipeline(lm_ckpt=): the served LM's weights are not the checkpoint's")
        stages: dict = {}
        pipe.lm.generate = timed(stages, "lm_decode", pipe.lm.generate)
        t0 = time.perf_counter()
        wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
        t_tts = time.perf_counter() - t0
        launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches}
        if launches != {"ar_decode": 2, "attention_fwd": 2 * 640} or k4.bwd_launches:
            raise AssertionError(f"lm_train launches {launches} (want 1 K1 and 640 K4 in validate_audio and in the "
                                 f"serve's tts), K4 backward {k4.bwd_launches}")
        if sr != 44100 or not len(wav) or not np.isfinite(wav).all():
            raise AssertionError(f"lm_train serve: {sr} Hz, {wav.shape}")

        # K1 at the trained weights against the plain decode (not counted)
        vb = next(iter(DataLoader(TextDataset(cfg.data.valid_path, pipe.lm.cfg.semantic_bos, pipe.lm.cfg.semantic_eos,
                                              n_spk=cfg.common.n_spk), 4, collate=loader_a.collate, shuffle=False)))
        lm_m = pipe.lm.module
        with torch.no_grad():
            enc = lm_m.encode(*(torch.as_tensor(vb[k], device=dev) for k in ("phone", "tone", "spk_id",
                                                                             "encoder_attention_mask")))
            kvs = lm_m.compute_cross_kv(enc)
        clen = torch.as_tensor(vb["encoder_attention_mask"].sum(-1), dtype=torch.int32, device=dev)
        sg = SamplingConfig(max_new_tokens=N_TOKENS, do_sample=False, eos_token_id=pipe.lm.cfg.semantic_eos,
                            pad_token_id=pipe.lm.cfg.semantic_pad, bos_token_id=pipe.lm.cfg.semantic_bos)
        err, n_cmp, scale, corr = k1_logits_close(lm_m, sg, kvs, clen, "trained checkpoint B=4")
        same = n_cmp == N_TOKENS and torch.equal(k1.roformer_decode(lm_m, sg, kvs, clen)[0],
                                                 k1.roformer_decode_plain(lm_m, sg, kvs, clen)[0])

        # the device's share of a step: the epoch-0 batches on the card
        threads.set_epoch(0)
        batches = [trainer_a.device_put_batch(b) for b in threads]
        for b in batches:  # warm-up
            trainer_a.train_step(b)

        def step_ms(b) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer_a.train_step(b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        # each bucket's step, as train_step runs it (deterministic backward);
        # its A/B against the atomic embedding backward: scripts/lm_backward_ab.py
        per_bucket = np.mean([[step_ms(b) for b in batches] for _ in range(2)], axis=0)
        alone_ms = float(per_bucket.mean())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in batches:
                trainer_a.train_step(b)
            torch.cuda.synchronize()
        busy_us, kernels, by_kernel = 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                us = us if us is not None else e.self_cuda_time_total
                busy_us += us
                kernels += e.count
                by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us

    # step times: each leg's first step includes its start-up, and the step
    # after the validation includes evaluate, validate_audio and a save
    step_s = [b - a for leg in times for a, b in zip(leg, leg[1:])]
    skip = {0, LM_STEPS[0], LM_VAL_AT}  # step indices: each leg's first, the one after step 10's validation
    steady = [s for i, s in enumerate(step_s) if i not in skip]
    median = float(np.median(steady))
    q1, q3 = (float(v) for v in np.percentile(steady, [25, 75]))
    tokens = float(np.mean([t for _, t, _ in stats]))
    pad_sorted = 1.0 - sum(t for _, t, _ in stats) / sum(s * LM_B for s, _, _ in stats)
    pad_unsorted = 1.0 - sum(t for _, t, _ in unsorted) / sum(s * LM_B for s, _, _ in unsorted)
    busy_ms = busy_us / 1e3 / len(batches)
    print(f"lm_train [{card}]: {n} steps at B={LM_B} f32, dropout 0.1 ({LM_STEPS[0]} through stage 21's main, then "
          f"main again: resume, {LM_STEPS[1]} more); losses {[round(x, 4) for x in losses]}; the resumed run's "
          f"{len(params_b)} parameter tensors and AdamW state bitwise equal to the uninterrupted run's")
    print(f"lm_train step [{card}]: median {median * 1e3:.2f} ms over {len(steady)} steps (quartiles "
          f"{q1 * 1e3:.2f} / {q3 * 1e3:.2f} ms; all: {[round(s * 1e3, 2) for s in step_s]} ms); "
          f"{LM_B / median:.1f} samples/s; {tokens / median:.0f} non-pad semantic tokens/s ({tokens:.0f} a batch)")
    print(f"lm_train step parts [{card}]: train_step on the epoch-0 batches already on the card {alone_ms:.2f} ms a "
          f"step; device busy {busy_ms:.2f} ms a step (CUDA-only profile, {len(batches)} steps): "
          f"{1 - busy_ms / alone_ms:.1%} idle of train_step alone, {1 - busy_ms / (median * 1e3):.1%} of the median "
          f"step through train(); {kernels / len(batches):.0f} kernel launches a step")
    buckets_ms = ", ".join(f"S={b['semantic'].shape[1]}: {d:.2f} ms" for b, d in zip(batches, per_bucket))
    print(f"lm_train step by bucket, train_step alone (2 passes) [{card}]: {buckets_ms}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"lm_train device time by kernel, ms a step (of {busy_ms:.2f}): "
          + "; ".join(f"{k[:70]} {us / 1e3 / len(batches):.3f}" for k, us in top))
    print(f"lm_train padding of this {LM_UTTS[0]}-utterance smoke corpus (semantic side, {len(stats)} batches; "
          f"a property of the corpus's size, scripts/lm_padding.py measures it at larger ones): {pad_sorted:.1%} "
          f"with length_sorted, {pad_unsorted:.1%} without")
    print(f"lm_train validate_audio at step {val['step']} [{card}]: {val['s']:.3f} s wall, {val['k1']} K1 launch; "
          f"val/loss {val_logs[0][1]['val/loss']:.4f}, val/top5_acc {val_logs[0][1]['val/top5_acc']:.4f}")
    print(f"lm_train serve of model_{n}.ckpt through build_pipeline(lm_ckpt=) in bf16 [{card}]: tts "
          f"{len(wav) / sr:.3f} s of audio in {t_tts:.3f} s, lm_decode {stages['lm_decode'] * 1e3:.1f} ms; K1 greedy "
          f"at the trained weights vs the plain decode (B=4, N={N_TOKENS}): tokens "
          f"{'identical' if same else f'agree up to step {n_cmp - 1}'}, logits max abs err {err:.3e} over {n_cmp} "
          f"steps (scale {scale:.2f}, tolerance 2% of scale), corr {corr:.6f}")
    print(f"lm_train gradient_accumulation_steps=2 [{card}]: 5 micro-steps (2 updates) in one go against 3, a save "
          f"half-way through an update, a resume and 2 more: parameters and accumulator bitwise equal; train/mfu "
          f"of stage 21's steps (products a step x steps/s / bf16 peak): {[round(x, 4) for x in lm_mfu]}")
    print(f"lm_train launches: {launches} (validate_audio and the serve's tts: 1 K1 and 640 K4 each)")
    return dict(launches=launches)


# data_path: the shipped config's data stages through their `main`
# functions on a synthetic voiced corpus: 4 speakers x DATA_FILES files of
# 6-8 s at 44.1 kHz ("alto" has no number: stage 01 renumbers it), one file
# of DATA_LONG_S for stage 00 to drop; stage 02 moves 3 files of each
# speaker to the validation set, which leaves >= 2 x 8192 unit frames for
# stage 17 (two minibatches an epoch, 4 epochs: 8 K6 launches at N = 8192)
DATA_SPEAKERS = ("1", "2", "4", "alto")
DATA_FILES, DATA_LONG_S = 16, 31.0
STAGE17_B, STAGE17_EPOCHS = 8192, 4
# one stage-17 step on the card against the CPU: centroids within this share
# of their largest magnitude (f32 sums of 8192 rows in other orders)
STAGE17_CENTROID_REL = 1e-5
# one file's stage-11 latents on the card against the CPU (f32, TF32 off):
# within this share of their largest magnitude
STAGE11_REL = 1e-4
BATCH_B = 8  # cli/batch_preprocess.py's batch size in data_path (its default)


# units_alt: the three other unit encoders at full width (seeded), on a
# 10 s clip; HuBERT-soft through stages 10, 17 and 19 over 8 files long
# enough for stage 17's codebook (>= 2 x 8192 frames of 50 fps units) and
# through one SVC call; K6 at D = 256 and 1024; then the diffusion trainer's
# input path three ways at B = 48 on train_slice's layout
ALT_ENCODERS = (("hubert_soft", 256), ("xlsr_53_56k", 1024), ("w2v-bert", 1024))
ALT_CLIP_S = 10.0
ALT_FILES = (41.0, 41.5, 42.0, 42.5, 43.0, 43.5, 44.0, 44.5)  # seconds a file (44.1 kHz)
# each encoder in bf16 against the same weights in f32 (relative Frobenius error of the units)
ALT_BF16_REL = 5e-2
ALT_SVC_PARTS = ((0.5, None), (4.0, 120.0), (1.0, None), (4.5, 165.0))
# K6 rows: (N, D) against the 4096-code shipped codebook size
ALT_K6 = ((8192, 256), (400, 256), (8192, 1024), (400, 1024))
ALT_TRAIN_STEPS = 10  # steps a way, after one warm-up step
# a device-collated step against the host-collated one under only_mean
ALT_GRAD_ATOL = 1e-5


def _native_build_child(build_dir: str, barrier, out) -> None:
    """A spawn worker: build and load the native reader in `build_dir`."""
    os.environ["LDS_TORCH_BUILD_DIR"] = build_dir
    sys.path.insert(0, ROOT)
    from latent_diffusion_speech_tpu_torch.data import native_loader

    barrier.wait()
    try:
        native_loader.NativeNpyReader(num_threads=1)
        out.put(("ok", str(native_loader.library_path())))
    except Exception as e:  # noqa: BLE001 - the parent raises it
        out.put(("failed", repr(e)))


def alt_signal(sec: float, f0: float, seed: int) -> np.ndarray:
    """A voiced 44.1 kHz stretch for the units_alt corpus: five harmonics
    with a 5 Hz +-3% vibrato, 4 Hz amplitude modulation and white noise at
    -24 dB of the peak, between 0.25 s silences.  A steady tone gives the
    seeded HuBERT-soft rows so alike that bf16 units repeat (178 distinct
    of 1025 over 20 s), too few for a 4096-code k-means++."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(sec * SVC_SR))) / SVC_SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / SVC_SR
    voiced = 0.15 * sum(np.sin(h * phase) / h for h in range(1, 6)) * (0.65 + 0.35 * np.sin(2 * np.pi * 4 * t))
    voiced += 0.01 * rng.standard_normal(t.size)
    silence = np.zeros(int(0.25 * SVC_SR))
    return np.concatenate([silence, voiced, silence]).astype(np.float32)


def stack_items(items: list) -> dict:
    """The default collate written out: numpy items stacked key by key."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def native_build_race() -> str:
    """Two spawn processes build the native reader into one empty build
    directory at once: both must load the same library."""
    import multiprocessing as mp
    import tempfile

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        ctx = mp.get_context("spawn")
        barrier, out = ctx.Barrier(2), ctx.Queue()
        procs = [ctx.Process(target=_native_build_child, args=(tmp, barrier, out)) for _ in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            results = [out.get(timeout=120) for _ in procs]
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        wall = time.perf_counter() - t0
        libs = sorted(f for f in os.listdir(tmp) if f.endswith(".so"))
        if any(r[0] != "ok" for r in results) or len({r[1] for r in results}) != 1 or len(libs) != 1:
            raise AssertionError(f"native reader build race: {results}, libraries {libs}")
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"native reader build race: exit codes {[p.exitcode for p in procs]}")
    return f"two spawn processes built and loaded {libs[0]} from one empty directory in {wall:.2f} s"


def alt_encoders(dev, card: str) -> None:
    """Each other encoder through `UnitsEncoder.encode` on one 10 s clip at
    44.1 kHz, seeded at full width, in bf16 (the default) and f32 from the
    same seed: the units' shape (50 fps), finiteness, bf16 against f32 and
    ms a call."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder

    clip = alt_signal(ALT_CLIP_S, 140.0, seed=0)[int(0.25 * SVC_SR):-int(0.25 * SVC_SR)]
    frames = -(-len(clip) * 16000 // SVC_SR) // 320  # the resampled length // hop
    for name, width in ALT_ENCODERS:
        units, ms = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(None):
                enc = UnitsEncoder(name, ckpt_path="no-such-checkpoint.pt", device=dev, dtype=dtype)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            units[dtype] = enc.encode(clip, SVC_SR).float()
            ms[dtype] = cuda_time_ms(lambda: enc.encode(clip, SVC_SR), iters=5, warmup=1)
            n_params = sum(p.numel() for p in enc.model.model.parameters())
            del enc
            torch.cuda.empty_cache()
        u32, u16 = units[torch.float32], units[torch.bfloat16]
        rel = ((u16 - u32).norm() / u32.norm()).item()
        # XLSR's unpadded convolutions give one frame fewer when the input
        # fills its half-second bucket exactly (as in the JAX package)
        if (u32.shape[0], u32.shape[2]) != (1, width) or not 0 <= frames - u32.shape[1] <= 1 \
                or u16.shape != u32.shape:
            raise AssertionError(f"{name}: units {tuple(u32.shape)}, want (1, {frames}, {width})")
        if not (torch.isfinite(u32).all() and torch.isfinite(u16).all()) or rel > ALT_BF16_REL:
            raise AssertionError(f"{name}: finite {bool(torch.isfinite(u16).all())}, bf16 vs f32 {rel}")
        print(f"units_alt {name} [{card}]: {n_params / 1e6:.1f} M parameters seeded on the card in {build_s:.2f} s; "
              f"{ALT_CLIP_S:.0f} s clip -> units {tuple(u16.shape)} (50 fps), finite; bf16 vs f32 relative error "
              f"{rel:.2e} (limit {ALT_BF16_REL}); {ms[torch.bfloat16]:.2f} ms a call in bf16, "
              f"{ms[torch.float32]:.2f} ms in f32")


def alt_hubert_path(dev, card: str, tmp: str) -> dict:
    """HuBERT-soft through stages 10, 17 and 19 (each its `main`) over
    ALT_FILES, then one SVC call as `cli/infer_svc.py` makes it: the
    shipped config with `encoder: hubert_soft`, a seeded 256-input
    `Unit2Mel`.  Returns the launches."""
    import io

    import torch

    from latent_diffusion_speech_tpu_torch.cli import preprocess_cluster, preprocess_token, preprocess_unit
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline as cli_build_pipeline
    from latent_diffusion_speech_tpu_torch.config import load_config, save_config
    from latent_diffusion_speech_tpu_torch.models.units import UnitsEncoder
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio, write_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook

    for i, sec in enumerate(ALT_FILES):
        os.makedirs(os.path.join(tmp, "train", "audio", str(i % 2 + 1)), exist_ok=True)
        audio = alt_signal(sec, 100.0 + 9 * i, seed=i)
        write_wav(os.path.join(tmp, "train", "audio", str(i % 2 + 1), f"{i}.wav"), audio, SVC_SR)
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    cfg.data.encoder = "hubert_soft"
    cfg.data.train_path = os.path.join(tmp, "train")
    cfg.text2semantic.model.codebook_path = os.path.join(tmp, "codebook.npz")
    cfg_path = os.path.join(tmp, "config.yaml")
    save_config(cfg, cfg_path)
    ckpt = ["--ckpt", os.path.join(tmp, "no-hubert.pt")]
    launches = {"attention_fwd": 0, "kmeans_argmin": 0}

    def stage(name, fn, argv) -> tuple:
        buf = io.StringIO()
        k6.launches = 0
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        torch.cuda.synchronize()
        launches["kmeans_argmin"] += k6.launches
        return time.perf_counter() - t, k6.launches, buf.getvalue().splitlines()

    wall10, n10, _ = stage("10", preprocess_unit.main, ["-c", cfg_path, *ckpt])
    unit_root = os.path.join(tmp, "train", "units")
    units = {f: np.load(os.path.join(unit_root, f)) for f in sorted(
        os.path.relpath(os.path.join(d, f), unit_root) for d, _, fs in os.walk(unit_root) for f in fs)}
    frames = sum(len(u) for u in units.values())
    if len(units) != len(ALT_FILES) or any(u.shape[1] != 256 or not np.isfinite(u).all() for u in units.values()):
        raise AssertionError(f"stage 10 (hubert_soft): {[(f, u.shape) for f, u in units.items()]}")
    wall17, n17, lines17 = stage("17", preprocess_cluster.main, ["-c", cfg_path])
    cb = load_codebook(cfg.text2semantic.model.codebook_path)
    want17 = STAGE17_EPOCHS * (frames // STAGE17_B)
    if cb.shape != (cfg.text2semantic.model.semantic_kmeans_num, 256) or n17 != want17:
        raise AssertionError(f"stage 17: codebook {cb.shape}, {n17} K6 launches (want {want17})")
    wall19, n19, _ = stage("19", preprocess_token.main, ["-c", cfg_path])
    cb_dev = torch.from_numpy(cb).to(dev)
    ties = 0
    for f, u in units.items():
        ids = np.load(os.path.join(tmp, "train", "semantic_token", f))
        x = torch.from_numpy(u).to(dev)
        ref = k6.kmeans_argmin_plain(x, cb_dev)
        ties += len(f64_ties(x, cb_dev, torch.from_numpy(ids).to(dev), ref, "stage 19 (256-d)")[0])
    if n19 != len(units):
        raise AssertionError(f"stage 19: {n19} K6 launches for {len(units)} files")
    print(f"units_alt hubert_soft data path [{card}]: stage 10 over {len(units)} files of {ALT_FILES[0]}-"
          f"{ALT_FILES[-1]} s ({frames} unit frames, 256-d) {wall10:.2f} s; stage 17 ({cb.shape[0]} x 256, "
          f"{n17} K6 launches, one a step) {wall17:.2f} s: {lines17[-1] if lines17 else ''}; stage 19 "
          f"{wall19:.2f} s, {n19} K6 launches (one a file), ids equal to the plain version but {ties} f64 ties")

    # one SVC call through cli/infer_svc.py's path
    t0 = time.perf_counter()
    pipe = cli_build_pipeline(cfg)
    width = pipe.diffusion.cfg.input_channel
    if width != 256:
        raise AssertionError(f"build_pipeline with encoder hubert_soft: Unit2Mel input {width}")
    with contextlib.redirect_stdout(None):
        pipe.units_encoder = UnitsEncoder(cfg.data.encoder, cfg.data.encoder_sample_rate, cfg.data.encoder_hop_size,
                                          cfg.data.units_forced_mode, ckpt_path=ckpt[1], device=pipe.device)
    build_s = time.perf_counter() - t0
    src = os.path.join(tmp, "svc_in.wav")
    signal, _ = svc_signal(ALT_SVC_PARTS)
    write_wav(src, signal, SVC_SR)
    audio, sr = load_audio(src)
    count = {"evals": 0}
    real_denoise = pipe.diffusion.diffusion.denoise_fn

    def denoise(*a):
        count["evals"] += 1
        return real_denoise(*a)

    with mock.patch.object(pipe.diffusion.diffusion, "denoise_fn", denoise):
        k4.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, out_sr = pipe.infer_from_long_audio(audio, sr, method=cfg.common.infer.method,
                                                 infer_speedup=SERVE_SPEEDUP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n4 = k4.launches
    launches["attention_fwd"] += n4
    out = np.asarray(out)
    hop = pipe.vocoder.vocoder_hop_size
    if (out_sr != SVC_SR or abs(len(out) - len(signal)) > 2 * hop or not np.isfinite(out).all()
            or not count["evals"] or n4 != 32 * count["evals"]):
        raise AssertionError(f"svc (hubert_soft): {out_sr} Hz, {len(out)} samples for {len(signal)}, finite "
                             f"{bool(np.isfinite(out).all())}, {n4} K4 launches / {count['evals']} evaluations")
    print(f"units_alt hubert_soft svc [{card}]: build_pipeline + HuBERT-soft {build_s:.2f} s (Unit2Mel input "
          f"{width}); {len(signal) / SVC_SR:.1f} s in -> {len(out) / out_sr:.3f} s out at {out_sr} Hz, finite; "
          f"{count['evals']} denoiser evaluations x 32 = {n4} K4 launches; wall {wall:.3f} s, "
          f"RTF {wall / (len(signal) / SVC_SR):.4f}")
    del pipe
    torch.cuda.empty_cache()
    return launches


def alt_k6(dev, card: str) -> dict:
    """K6 against its plain version at D = 256 and D = 1024 (`k6_row`), with
    the split plan `split_codes` picks at each N."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6

    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for n, d in ALT_K6:
        x = torch.randn((n, d), generator=gen, device=dev)
        cb = torch.randn((4096, d), generator=gen, device=dev)
        splits, per = k6.split_codes(n, 4096, sms)
        row = k6_row(k6, x, cb, f"units_alt [{card}] (D={d}; {splits} splits of {per} codes, "
                                f"{-(-n // k6.BLOCK_ROWS) * splits} blocks on {sms} SMs)")
        rows[(n, d)] = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    return rows


def alt_train_input(dev, card: str, tmp: str) -> dict:
    """The diffusion trainer's input path at B = 48 on train_slice's layout,
    three ways through `cli/train_diffusion.py::build`: host collation of
    numpy items (an explicit collate), the native `fast_batch`, and
    `device_collate` with `transfer_dtype: bfloat16` (raw batches finished
    on the card).  Each way: the loader alone over its second epoch (ms a
    batch) and the median step through `train()`.  Then, with only_mean,
    one device-collated step's loss and gradients against the host-collated
    step on the same crops (the units rounded to bf16 in both), and the
    launches of one device-collated step.  Returns the launches."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli.train_diffusion import build
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.data.diffusion_dataset import DiffusionDataset, bf16_bits
    from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import step_generator

    cb = np.random.default_rng(1).standard_normal((4096, 1280)).astype(np.float32)
    write_train_layout(os.path.join(tmp, "train"), cb)
    np.savez(os.path.join(tmp, "codebook.npz"), cluster_centers_=cb)
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    cfg.data.train_path = os.path.join(tmp, "train")
    cfg.text2semantic.model.codebook_path = os.path.join(tmp, "codebook.npz")
    cfg.diffusion.train.interval_log = 1
    cfg.diffusion.train.interval_val = 10 ** 9
    launches = {"attention_fwd": 0, "attention_bwd": 0, "kmeans_argmin": 0}
    results = {}
    for way in ("items", "fast_batch", "device_collate bf16"):
        cfg.diffusion.train.expdir = os.path.join(tmp, "exp_" + way.split()[0])
        cfg.diffusion.train.device_collate = way.startswith("device")
        cfg.diffusion.train.transfer_dtype = "bfloat16" if way.startswith("device") else None
        with contextlib.redirect_stdout(None):
            trainer, loader = build(cfg, device=dev)
        if way == "items":  # an explicit collate: the loader assembles the batch from items
            loader = DataLoader(loader.dataset, loader.batch_size, collate=stack_items, seed=loader.seed,
                                device_put=trainer.pin_batch)
        for epoch in (0, 1):  # the first epoch also probes the files and builds the reader
            loader.set_epoch(epoch)
            t0, n = time.perf_counter(), 0
            for batch in loader:
                n += 1
            loader_ms = (time.perf_counter() - t0) / n * 1e3
        log = StepLog()
        k4.launches = k4.bwd_launches = k6.launches = 0
        start = time.perf_counter()
        trainer.train(loader, max_steps=ALT_TRAIN_STEPS + 1, logger=log)
        launches["attention_fwd"] += k4.launches
        launches["attention_bwd"] += k4.bwd_launches
        launches["kmeans_argmin"] += k6.launches
        steps = ALT_TRAIN_STEPS + 1
        if (k4.launches, k4.bwd_launches, k6.launches) != (32 * steps, 32 * steps, steps):
            raise AssertionError(f"{way}: launches {k4.launches} / {k4.bwd_launches} / {k6.launches} "
                                 f"over {steps} steps, want 32 / 32 / 1 a step")
        times = [start] + log.times
        step_ms = [1e3 * (b - a) for a, b in zip(times, times[1:])][1:]  # the first includes start-up
        results[way] = dict(loader_ms=loader_ms, step_ms=float(np.median(step_ms)),
                            q=[float(v) for v in np.percentile(step_ms, [25, 75])])
        if not all(np.isfinite(log.losses)):
            raise AssertionError(f"{way}: losses {log.losses}")
        del trainer, loader
        torch.cuda.empty_cache()
    for way, r in results.items():
        print(f"units_alt training input [{card}] {way}: loader alone {r['loader_ms']:.2f} ms a batch (second epoch, "
              f"B={TRAIN_B}); median train step {r['step_ms']:.2f} ms over {ALT_TRAIN_STEPS} steps "
              f"(quartiles {r['q'][0]:.2f} / {r['q'][1]:.2f} ms)")

    # only_mean: the device-collated step against the host-collated one
    args = dict(waveform_sec=cfg.data.duration, hop_size=cfg.data.block_size, sample_rate=cfg.data.sampling_rate,
                n_spk=cfg.common.n_spk, only_mean=True, clamp=cfg.common.vocoder.clamp)
    idx = list(range(TRAIN_B))
    host = DiffusionDataset(cfg.data.train_path, **args).fast_batch(idx)
    raw = DiffusionDataset(cfg.data.train_path, device_collate=True, transfer_dtype="bfloat16", **args).fast_batch(idx)
    host["units"] = (bf16_bits(host["units"]).astype(np.uint32) << 16).view(np.float32)  # bf16 values
    cfg.common.vocoder.only_mean = True
    cfg.diffusion.train.expdir = os.path.join(tmp, "exp_equal")
    with contextlib.redirect_stdout(None):
        trainer, _ = build(cfg, device=dev)
    grads, losses = [], []
    with deterministic_cudnn():
        for batch in (host, raw):
            trainer.optimizer.zero_grad(set_to_none=True)
            k4.launches = k4.bwd_launches = k6.launches = 0
            loss = trainer.loss(trainer.device_put_batch(batch), step_generator(0, 0, dev))
            loss.backward()
            torch.cuda.synchronize()
            counts = (k4.launches, k4.bwd_launches, k6.launches)
            if counts != (32, 32, 1):
                raise AssertionError(f"one step: launches {counts}, want 32 / 32 / 1")
            launches["attention_fwd"] += 32
            launches["attention_bwd"] += 32
            launches["kmeans_argmin"] += 1
            losses.append(loss.item())
            grads.append({n: p.grad.clone() for n, p in trainer.system.module.named_parameters()
                          if p.grad is not None})
    trainer.optimizer.zero_grad(set_to_none=True)
    worst = max((grads[0][n] - g).abs().max().item() for n, g in grads[1].items())
    if grads[0].keys() != grads[1].keys() or abs(losses[0] - losses[1]) > ALT_GRAD_ATOL or worst > ALT_GRAD_ATOL:
        raise AssertionError(f"device-collated step vs host: loss {losses[1]} vs {losses[0]}, gradients {worst}")
    print(f"units_alt device-collated step vs host-collated [{card}] (only_mean, B={TRAIN_B}, deterministic "
          f"cuDNN): loss {losses[1]:.7f} vs {losses[0]:.7f}; largest gradient difference {worst:.2e} over "
          f"{len(grads[0])} tensors (atol {ALT_GRAD_ATOL}); launches a step 32 K4 forward / 32 K4 backward / 1 K6")
    del trainer
    torch.cuda.empty_cache()
    return launches


def units_alt(dev, card: str) -> dict:
    """The three other unit encoders, HuBERT-soft's data and SVC path, K6 at
    D = 256 and 1024, and the trainer's input path (see the module
    docstring, step 12).  Returns the launches and the K6 rows."""
    import tempfile

    t0 = time.perf_counter()
    alt_encoders(dev, card)
    print(f"units_alt native reader [{card}]: {native_build_race()}")
    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        launches = alt_hubert_path(dev, card, tmp)
    k6_rows = alt_k6(dev, card)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        train = alt_train_input(dev, card, tmp)
    for name, n in train.items():
        launches[name] = launches.get(name, 0) + n
    print(f"units_alt [{card}]: phase wall {time.perf_counter() - t0:.1f} s; launches {launches}")
    return dict(launches=launches, k6=k6_rows)


def reference_codec_state(module, cfg, gen, stage: str) -> dict:
    """A reference-layout HiFi-VAEGAN state dict (`encoder.pth` /
    `decoder.pth`'s "model") for the port's `VAEEncoder` (stage "down") or
    `Generator` ("up") of `cfg`: `ups.{i}`, `resblocks.{i * n + j}.convs1.{m}`
    ..., every weight as weight norm's `weight_v` ~ N(0, 1) and `weight_g`
    ~ U(0.5, 1.5) (each folded row of unit norm, give or take: activations
    of unit scale, as in a trained codec), biases N(0, 0.01), drawn from
    `gen`."""
    import torch

    n = len(cfg.resblock_kernel_sizes)
    convs = {"conv1": "convs1", "conv2": "convs2", "conv": "convs"}
    out = {}
    for key, t in module.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if mod.startswith(stage + "_"):
            mod = "ups." + mod[len(stage) + 1:]
        elif mod.startswith("res_"):
            block, conv = mod.split(".")
            i, j = (int(x) for x in block[4:].split("_"))
            kind, m = conv.rsplit("_", 1)
            mod = f"resblocks.{i * n + j}.{convs[kind]}.{m}"
        if leaf == "bias":
            out[f"{mod}.bias"] = 0.01 * torch.randn(t.shape, generator=gen)
            continue
        out[f"{mod}.weight_v"] = torch.randn(t.shape, generator=gen)
        out[f"{mod}.weight_g"] = 0.5 + torch.rand((t.shape[0],) + (1,) * (t.dim() - 1), generator=gen)
    return out


# the port's flagship UNet1D names -> the reference UNet1DConditionModel's
# (`models/diffusion/import_torch.py` reads these)
_UNET_TOP = ((r"(down|up)_(\d+)_res_(\d+)", r"\1_blocks.\2.resnets.\3"),
             (r"(down|up)_(\d+)_attn_(\d+)", r"\1_blocks.\2.attentions.\3"),
             (r"(down|up)_(\d+)_(downsample|upsample)", r"\1_blocks.\2.\3rs.0"),
             (r"mid_res_(\d)", r"mid_block.resnets.\1"), (r"mid_attn", "mid_block.attentions.0"),
             (r"time_mlp1", "time_embedding.linear_1"), (r"time_mlp2", "time_embedding.linear_2"))
_TRANSFORMER = {"norm1": "transformer_blocks.0.norm1", "norm2": "transformer_blocks.0.norm2",
                "norm3": "transformer_blocks.0.norm3", "ff_proj": "transformer_blocks.0.ff.net.0.proj",
                "ff_out": "transformer_blocks.0.ff.net.2"}


def reference_unit2mel_state(state: dict) -> dict:
    """A reference-layout Unit2Mel state dict (`exp/diffusion/model_<step>.pt`'s
    "model") holding the weights of the port's flagship `Unit2Mel` state dict
    `state`: the embeddings keep their names, the UNet goes under
    `decoder.denoise_fn.` with diffusers' names, and `proj_in` / `proj_out`
    become k=1 convolutions.  The inverse of `unit2mel_state_from_torch`."""
    out = {}
    for key, t in state.items():
        if not key.startswith("unet."):
            out[key] = t
            continue
        top, *rest, leaf = key[len("unet."):].split(".")
        head = top
        for pattern, repl in _UNET_TOP:
            if re.fullmatch(pattern, top):
                head = re.sub(pattern, repl, top)
                break
        if "attn" in top:  # a transformer block
            sub = rest[0]
            if sub in ("attn1", "attn2"):
                rest = ["transformer_blocks.0", sub, "to_out.0" if rest[1] == "to_out" else rest[1]]
            elif sub in _TRANSFORMER:
                rest = [_TRANSFORMER[sub]]
            elif sub in ("proj_in", "proj_out") and leaf == "weight":
                t = t[:, :, None]
        out[".".join(["decoder.denoise_fn", head, *rest, leaf])] = t
    return out


_ROFORMER_TOP = {"phone_embed": "text_encoder.embeddings.word_embeddings",
                 "tone_embed": "text_encoder.embeddings.token_type_embeddings",
                 "enc_emb_ln": "text_encoder.embeddings.LayerNorm",
                 "semantic_embed": "semantic_decoder.roformer.embeddings.word_embeddings",
                 "dec_type_embed": "semantic_decoder.roformer.embeddings.token_type_embeddings",
                 "dec_emb_ln": "semantic_decoder.roformer.embeddings.LayerNorm",
                 "head_transform": "semantic_decoder.cls.predictions.transform.dense",
                 "head_ln": "semantic_decoder.cls.predictions.transform.LayerNorm",
                 "spk_embed": "spk_emb"}
_ROFORMER_LAYER = {"self_attn.query": "attention.self.query", "self_attn.key": "attention.self.key",
                   "self_attn.value": "attention.self.value", "self_attn.out": "attention.output.dense",
                   "self_ln": "attention.output.LayerNorm", "ff_in": "intermediate.dense",
                   "ff_out": "output.dense", "ff_ln": "output.LayerNorm",
                   "cross_attn.query": "crossattention.self.query", "cross_attn.key": "crossattention.self.key",
                   "cross_attn.value": "crossattention.self.value",
                   "cross_attn.out": "crossattention.output.dense", "cross_ln": "crossattention.output.LayerNorm"}


def reference_roformer_state(state: dict, cfg) -> dict:
    """A reference-layout RoFormer state dict (`exp/lm/model_<step>.pt`'s
    "model": HF `RoFormerModel` + `RoFormerForCausalLM` + `spk_emb`, the
    keys of the HF modules' `state_dict()`) holding the weights of the
    port's `Roformer` state dict `state`: the tied LM-head decoder repeats
    the semantic embeddings and the head bias, and each stack has HF's
    sinusoidal `embed_positions` table.  The inverse of
    `roformer_state_from_torch`."""
    import torch

    out = {}
    for key, t in state.items():
        if key == "head_bias":
            out["semantic_decoder.cls.predictions.bias"] = t
            out["semantic_decoder.cls.predictions.decoder.bias"] = t
            continue
        mod, leaf = key.rsplit(".", 1)
        m = re.fullmatch(r"(enc|dec)_(\d+)\.(.+)", mod)
        if m:
            stack = "text_encoder" if m[1] == "enc" else "semantic_decoder.roformer"
            out[f"{stack}.encoder.layer.{m[2]}.{_ROFORMER_LAYER[m[3]]}.{leaf}"] = t
        else:
            out[f"{_ROFORMER_TOP[mod]}.{leaf}"] = t
    out["semantic_decoder.cls.predictions.decoder.weight"] = state["semantic_embed.weight"]
    for stack, scfg in (("text_encoder", cfg.encoder), ("semantic_decoder.roformer", cfg.decoder)):
        dim = scfg.hidden_size // scfg.num_attention_heads
        pos = np.arange(scfg.max_position_embeddings)[:, None] / np.power(10000, 2 * (np.arange(dim) // 2) / dim)
        table = np.concatenate([np.sin(pos[:, 0::2]), np.cos(pos[:, 1::2])], axis=1)
        out[f"{stack}.encoder.embed_positions.weight"] = torch.from_numpy(table.astype(np.float32))
    return out


_LLAMA_BLOCK = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
                "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
                "o_proj": "self_attn.o_proj", "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                "down_proj": "mlp.down_proj"}
_LLAMA_TOP = {"embed_tokens": "model.embed_tokens", "final_ln": "model.norm", "lm_head": "lm_head"}


def reference_llama_state(state: dict, prefix: str = "llama.") -> dict:
    """A reference-layout Llama state dict (HF `LlamaForCausalLM` keys under
    `prefix`, the reference's `Llama` wrapper) holding the weights of the
    port's dense `Llama` state dict `state`: the inverse of
    `llama_state_from_torch` (both keep torch's (out, in) product layout)."""
    out = {}
    for key, t in state.items():
        mod, leaf = key.rsplit(".", 1)
        m = re.fullmatch(r"block_(\d+)\.(\w+)", mod)
        name = f"model.layers.{m[1]}.{_LLAMA_BLOCK[m[2]]}" if m else _LLAMA_TOP[mod]
        out[f"{prefix}{name}.{leaf}"] = t
    return out


_BERT_TOP = {"word_embeddings": "embeddings.word_embeddings", "position_embeddings": "embeddings.position_embeddings",
             "token_type_embeddings": "embeddings.token_type_embeddings", "emb_ln": "embeddings.LayerNorm",
             "final_ln": "encoder.ln"}
_BERT_LAYER = {"attn.query": "attention.self.query", "attn.key": "attention.self.key",
               "attn.value": "attention.self.value", "attn.out": "attention.output.dense",
               "ffn_in": "intermediate.dense", "ffn_out": "output.dense"}


def reference_bert_state(state: dict, pre_ln: bool) -> dict:
    """An HF `BertModel` (post-LN) or `MegatronBertModel` (`pre_ln`) state
    dict holding the weights of the port's `BertEncoderModel` state dict
    `state`: the inverse of `bert_params_from_torch` + `convert.bert_from_jax`."""
    norms = ({"attn_ln": "attention.ln", "ffn_ln": "ln"} if pre_ln
             else {"attn_ln": "attention.output.LayerNorm", "ffn_ln": "output.LayerNorm"})
    out = {}
    for key, t in state.items():
        mod, leaf = key.rsplit(".", 1)
        m = re.fullmatch(r"layer_(\d+)\.(.+)", mod)
        name = f"encoder.layer.{m[1]}.{_BERT_LAYER.get(m[2]) or norms[m[2]]}" if m else _BERT_TOP[mod]
        out[f"{name}.{leaf}"] = t
    return out


def batched_preprocessing(tmp: str, cfg, wavs: list, stage, files, walls: dict, card: str) -> None:
    """`cli/batch_preprocess.py`'s main (B = BATCH_B) over a second root
    whose `audio/` holds hard links to stage 10's and 11's training files
    (their outputs stay as they are), against those stages: the same unit
    frame counts and units within WHISPER_BF16_REL (relative Frobenius
    error: both bf16 Whisper on the same zero-padded 16 kHz buckets, the
    batch's log-mel floor (R8) and another batch shape apart); the latents'
    frame counts are JAX's crop of the 16 kHz length (stage 11's, or one
    fewer where stage 11 pads to a whole hop) and their difference from
    stage 11's (R7: the codec reads 16 kHz audio resampled to 44.1 kHz) is
    reported."""
    from latent_diffusion_speech_tpu_torch.cli import batch_preprocess
    from latent_diffusion_speech_tpu_torch.config import save_config

    root = os.path.join(tmp, "batch")
    for f in wavs:
        os.makedirs(os.path.dirname(os.path.join(root, "audio", f)), exist_ok=True)
        os.link(os.path.join(cfg.data.train_path, "audio", f), os.path.join(root, "audio", f))
    bcfg = copy.deepcopy(cfg)
    bcfg.data.train_path = root
    cfg_path = os.path.join(tmp, "config_batch.yaml")
    save_config(bcfg, cfg_path)
    seen = []

    def record(lengths, batch_size, step, _buckets=batch_preprocess._buckets):
        seen.append((lengths, step, _buckets(lengths, batch_size, step)))
        return seen[-1][2]

    with mock.patch.object(batch_preprocess, "_buckets", record):
        lines = stage(f"batched units + latents (B={BATCH_B})", batch_preprocess.main,
                      ["-c", cfg_path, "--batch-size", str(BATCH_B)])
    lengths, step, batches = seen[0]
    n_buckets = len({max(step, -(-n // step) * step) for n in lengths.values()})
    progress = [line for line in lines if line.startswith("batch_preprocess: ")]
    if len(progress) != len(batches) or files("batch", "units") != files("train", "units") or \
            files("batch", "mel") != files("train", "mel"):
        raise AssertionError(f"batch_preprocess: {len(progress)} progress lines for {len(batches)} batches, "
                             f"{len(files('batch', 'units'))} unit and {len(files('batch', 'mel'))} latent files")
    hop, ratio = 512, cfg.data.sampling_rate / cfg.data.encoder_sample_rate
    du = su = dl = sl = 0.0
    max_u = max_l = scale_u = scale_l = 0.0
    shorter = 0
    for name in files("train", "units"):
        a, b = (np.load(os.path.join(tmp, r, "units", name)) for r in ("batch", "train"))
        if a.shape != b.shape:
            raise AssertionError(f"batch_preprocess units {name}: {a.shape}, stage 10 {b.shape}")
        du, su = du + float(np.sum((a - b) ** 2)), su + float(np.sum(b ** 2))
        max_u, scale_u = max(max_u, float(np.abs(a - b).max())), max(scale_u, float(np.abs(b).max()))
        a, b = (np.load(os.path.join(tmp, r, "mel", name)) for r in ("batch", "train"))
        want = int(lengths[name[:-len(".npy")]] * ratio) // hop
        if a.shape[0] != want or a.shape[1:] != b.shape[1:] or not b.shape[0] - 1 <= a.shape[0] <= b.shape[0]:
            raise AssertionError(f"batch_preprocess latents {name}: {a.shape}, stage 11 {b.shape}, crop {want}")
        shorter += a.shape[0] < b.shape[0]
        b = b[: a.shape[0]]
        dl, sl = dl + float(np.sum((a - b) ** 2)), sl + float(np.sum(b ** 2))
        max_l, scale_l = max(max_l, float(np.abs(a - b).max())), max(scale_l, float(np.abs(b).max()))
    rel_u, rel_l = (du / su) ** 0.5, (dl / sl) ** 0.5
    if not rel_u <= WHISPER_BF16_REL:
        raise AssertionError(f"batch_preprocess units vs stage 10: relative error {rel_u} over {WHISPER_BF16_REL}")
    n = len(wavs)
    print(f"data_path batched preprocessing [{card}]: {n} files in {len(batches)} batches of <= {BATCH_B} over "
          f"{n_buckets} half-second buckets; {walls[f'batched units + latents (B={BATCH_B})']:.3f} s wall, "
          f"{walls[f'batched units + latents (B={BATCH_B})'] * 1e3 / n:.1f} ms a file, against stage 10 + 11's "
          f"{walls['10 (units)'] + walls['11 (latents)']:.3f} s "
          f"({(walls['10 (units)'] + walls['11 (latents)']) * 1e3 / n:.1f} ms a file; stage 11 also writes the "
          f"augmented copy)")
    print(f"data_path batched units vs stage 10 [{card}]: frame counts equal; relative error {rel_u:.4e} (limit "
          f"{WHISPER_BF16_REL}), max abs err {max_u:.4f} at scale {scale_u:.3f}")
    print(f"data_path batched latents vs stage 11 (R7, reported, not held) [{card}]: {shorter} of {n} files one "
          f"frame shorter (JAX's crop of the 16 kHz length); over the common frames relative error {rel_l:.4e}, "
          f"max abs err {max_l:.3e} at scale {scale_l:.3e}")


def data_path(dev, card: str) -> dict:
    """The shipped config's data path on the card at full width, each stage
    through its `main` as a user runs it: stages 00-02, 15, 10 (seeded
    Whisper-large-v3, bf16), 11 (the 44.1 kHz codec encoder, f32), 17 (the
    4096 x 1280 codebook, K6 at N = 8192), 18 (EN), 19, three diffusion
    training steps on the stage-11 latents and the fitted codebook, then a
    reference-layout `encoder.pth` / `decoder.pth` pair at full width served
    with the trained checkpoint through `build_pipeline` (one EN `tts`).
    Then the card against the CPU: one file's stage-11 latents, one stage-17
    step, a second fit bitwise equal to the first, K6 at N = 8192."""
    import contextlib
    import io
    import tempfile

    import torch

    from latent_diffusion_speech_tpu_torch.cli import (
        batch_preprocess, prepare_audio, preprocess_cluster, preprocess_mel, preprocess_text, preprocess_token,
        preprocess_unit, preprocess_val, train_diffusion)
    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.config import load_config, save_config
    from latent_diffusion_speech_tpu_torch.models.vaegan.codec import HifiVAEGAN
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vaegan.import_torch import generator_state_from_torch
    from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator, VAEEncoder
    from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio, write_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.quantize import kmeans as km
    from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        raw, val_audio = os.path.join(tmp, "train", "audio"), os.path.join(tmp, "val", "audio")
        rng = np.random.default_rng(3)
        t0 = time.perf_counter()
        for s, spk in enumerate(DATA_SPEAKERS):
            os.makedirs(os.path.join(raw, spk))
            for i in range(DATA_FILES):
                sec = float(rng.uniform(6.0, 8.0))
                audio = svc_signal(((0.25, None), (sec, 95.0 + 15 * s + 4 * i), (0.25, None)))[0]
                write_wav(os.path.join(raw, spk, f"{i}.wav"), audio, SVC_SR)
                with open(os.path.join(raw, spk, f"{i}.txt"), "w", encoding="utf-8") as f:
                    f.write(" ".join(rng.choice(LM_WORDS, int(rng.integers(6, 14)))).capitalize() + ".\n")
        write_wav(os.path.join(raw, "2", "long.wav"), svc_signal(((DATA_LONG_S, 130.0),))[0], SVC_SR)
        corpus_s = time.perf_counter() - t0
        cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
        vcfg = VAEGANConfig()
        shipped = (cfg.data.encoder, cfg.data.sampling_rate, cfg.text2semantic.model.semantic_kmeans_num,
                   vcfg.upsample_initial_channel, vcfg.inter_channels, cfg.common.vocoder.type)
        if shipped != ("whisper_large_v3", 44100, 4096, 512, 128, "hifi-vaegan"):
            raise AssertionError(f"the shipped data path changed: {shipped}")
        cfg.data.train_path, cfg.data.valid_path = os.path.join(tmp, "train"), os.path.join(tmp, "val")
        cfg.text2semantic.model.codebook_path = os.path.join(tmp, "codebook.npz")
        cfg.common.vocoder.ckpt = os.path.join(tmp, "hifi-vaegan")  # written in step 5
        cfg.diffusion.train.expdir = os.path.join(tmp, "exp_diffusion")
        cfg_path = os.path.join(tmp, "config.yaml")
        save_config(cfg, cfg_path)
        print(f"data_path corpus: {len(DATA_SPEAKERS)} speakers x {DATA_FILES} voiced files of 6-8 s + one of "
              f"{DATA_LONG_S} s at 44.1 kHz, with EN labels, written in {corpus_s:.2f} s")

        walls = {}

        def stage(name: str, fn, *args) -> list:
            """Runs a stage's main with its standard output captured; returns its lines."""
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                fn(*args)
            torch.cuda.synchronize()
            lines = buf.getvalue().splitlines()
            walls[name] = time.perf_counter() - t
            print(f"data_path stage {name} [{card}]: {walls[name]:.3f} s; {len(lines)} lines, the last: "
                  f"{lines[-1] if lines else ''}")
            return lines

        def files(*parts) -> list:
            root = os.path.join(tmp, *parts)
            return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

        k1.launches = k4.launches = k4.bwd_launches = k6.launches = 0
        stage("00-02 (drop >= 30 s, renumber, validation split)", prepare_audio.main,
              [raw, "--max-sec", "30", "--renumber", "--valset", val_audio, "--seed", "0"])
        wavs, val_wavs = [f for f in files("train", "audio") if f.endswith(".wav")], files("val", "audio")
        if (sorted(os.listdir(raw)) != ["1", "2", "3", "4"] or any("long" in f for f in wavs + val_wavs)
                or len([f for f in val_wavs if f.endswith(".wav")]) != 3 * len(DATA_SPEAKERS)):
            raise AssertionError(f"stages 00-02: speakers {sorted(os.listdir(raw))}, {len(wavs)} train, val {val_wavs}")
        stage("15 (labels)", preprocess_text.main, ["-c", cfg_path])
        stage("10 (units)", preprocess_unit.main, ["-c", cfg_path])
        frames = sum(np.load(os.path.join(tmp, "train", "units", f), mmap_mode="r").shape[0]
                     for f in files("train", "units"))
        if frames < 2 * STAGE17_B:
            raise AssertionError(f"{frames} unit frames: stage 17 needs >= {2 * STAGE17_B}")
        lines = stage("11 (latents)", preprocess_mel.main, ["-c", cfg_path])
        mels = files("train", "mel")
        if len(mels) != len(wavs) or files("train", "aug_mel") != mels:
            raise AssertionError(f"stage 11: {len(mels)} mel files for {len(wavs)} wavs")
        print(f"data_path stage 11 [{card}]: {walls['11 (latents)'] * 1e3 / len(wavs):.1f} ms a file (latents "
              f"and the volume-augmented copy, f32) over {len(wavs)} files; e.g. {lines[0]}")
        batched_preprocessing(tmp, cfg, wavs, stage, files, walls, card)
        before = k6.launches
        lines = stage("17 (codebook)", preprocess_cluster.main, ["-c", cfg_path])
        k6_17 = k6.launches - before
        want = STAGE17_EPOCHS * (frames // STAGE17_B)
        if k6_17 != want:
            raise AssertionError(f"stage 17: {k6_17} K6 launches, want {want}")
        for line in lines:
            print(f"  stage 17: {line}")
        print(f"data_path stage 17 [{card}]: {frames} unit frames, K6 launches {k6_17} "
              f"({frames // STAGE17_B} minibatches of {STAGE17_B} an epoch x {STAGE17_EPOCHS} epochs)")
        stage("18 (validation, EN)", preprocess_val.main, ["-c", cfg_path, "--language", "EN"])
        for kind in ("mel", "aug_mel", "units", "utt"):
            if len(files("val", kind)) != 3 * len(DATA_SPEAKERS):
                raise AssertionError(f"stage 18: {files('val', kind)} under val/{kind}")
        before = k6.launches
        stage("19 (tokens)", preprocess_token.main, ["-c", cfg_path])
        if k6.launches - before != len(wavs) + 3 * len(DATA_SPEAKERS):
            raise AssertionError(f"stage 19: {k6.launches - before} K6 launches")
        counts = (k4.launches, k4.bwd_launches, k6.launches)
        lines = stage("20 (3 diffusion training steps)", train_diffusion.main,
                      ["-c", cfg_path, "--max-steps", "3"])
        train_launches = (k4.launches - counts[0], k4.bwd_launches - counts[1], k6.launches - counts[2])
        if latest_checkpoint_step(cfg.diffusion.train.expdir) != 3:
            raise AssertionError(f"stage 20: no checkpoint of step 3 in {os.listdir(cfg.diffusion.train.expdir)}")
        if train_launches != (96, 96, 3):
            raise AssertionError(f"training launches (K4 fwd, bwd, K6) {train_launches}, want (96, 96, 3)")
        print(f"data_path training [{card}]: launches K4 forward / backward / K6 {train_launches}; {lines[-3:]}")

        # step 5: a reference-layout pair at full width, then the serve path over it
        gen = torch.Generator().manual_seed(4)
        h = {k: (list(map(list, v)) if k == "resblock_dilation_sizes" else list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(vcfg).items()}
        os.makedirs(cfg.common.vocoder.ckpt)
        dec_state = reference_codec_state(Generator(vcfg), vcfg, gen, "up")
        for name, module, state in (("encoder", VAEEncoder(vcfg), None), ("decoder", None, dec_state)):
            state = state if state is not None else reference_codec_state(module, vcfg, gen, "down")
            torch.save({"model": state, "config": h}, os.path.join(cfg.common.vocoder.ckpt, f"{name}.pth"))
        t = time.perf_counter()
        pipe = build_pipeline(cfg, diffusion_ckpt=cfg.diffusion.train.expdir, device=dev)
        built = time.perf_counter() - t
        want_state = generator_state_from_torch(dec_state, vcfg)
        for key, val in pipe.vocoder.generator.state_dict().items():
            if not torch.equal(val.cpu(), want_state[key].to(val.dtype)):
                raise AssertionError(f"build_pipeline: vocoder {key} is not the checkpoint's")
        before = (k1.launches, k4.launches)
        t = time.perf_counter()
        wav, sr = pipe.tts(TEXT, language="EN", method=cfg.common.infer.method, infer_speedup=SERVE_SPEEDUP)
        torch.cuda.synchronize()
        walls["22 (tts)"] = time.perf_counter() - t
        wav = np.asarray(wav)
        if sr != 44100 or wav.ndim != 1 or not len(wav) or not np.isfinite(wav).all():
            raise AssertionError(f"tts over the reference pair: {sr} Hz, shape {wav.shape}")
        print(f"data_path serve [{card}]: build_pipeline over the written encoder.pth / decoder.pth (full width, "
              f"vocoder weights equal the checkpoint's) with the trained diffusion checkpoint and the fitted "
              f"codebook in {built:.2f} s; one EN tts {walls['22 (tts)']:.3f} s for {len(wav) / sr:.3f} s of audio; "
              f"launches K1 {k1.launches - before[0]}, K4 {k4.launches - before[1]}")
        launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches, "attention_bwd": k4.bwd_launches,
                    "kmeans_argmin": k6.launches}
        print(f"data_path launches (main path) [{card}]: {launches}; stage walls "
              f"{ {k: round(v, 3) for k, v in walls.items()} }")
        del pipe
        torch.cuda.empty_cache()

        # the card against the CPU: one file's stage-11 latents (f32, TF32 off),
        # with the seeded codec stage 11 ran (its N(0, 0.01) layers shrink the
        # signal to a small scale) and with the written pair (unit-scale layers)
        name = wavs[0]
        audio, _ = load_audio(os.path.join(raw, name), target_sr=44100)
        saved = torch.from_numpy(np.load(os.path.join(tmp, "train", "mel", name + ".npy")))
        for what, kw in (("seeded, as stage 11 ran", {}), ("the written pair", {"ckpt": cfg.common.vocoder.ckpt})):
            got = Vocoder(device=dev, **kw).extract(audio[None], 44100)[0].cpu()
            ref = Vocoder(device="cpu", **kw).extract(audio[None], 44100)[0]
            err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
            if not kw:
                err = max(err, (saved - ref).abs().max().item())
            if not err <= STAGE11_REL * scale:
                raise AssertionError(f"stage 11 {name} ({what}): card vs CPU max err {err} (scale {scale})")
            print(f"data_path stage 11 card vs CPU [{card}], codec {what}: {name} latents {tuple(got.shape)} max abs "
                  f"err {err:.3e} at scale {scale:.3e} (limit {STAGE11_REL} of scale)")

        # one stage-17 step on the card against the CPU, and a second fit
        units = np.concatenate([np.load(os.path.join(tmp, "train", "units", f)) for f in files("train", "units")])
        codebook = km.load_codebook(cfg.text2semantic.model.codebook_path)
        batch = units[np.random.default_rng(0).permutation(len(units))[:STAGE17_B]]
        counts = np.random.default_rng(1).integers(0, 8, len(codebook)).astype(np.float32)
        # the ids equal but for f64 ties (K6's contract, `f64_ties`: which
        # ties this corpus holds depends on stage 02's split, and that on
        # the file system's order of speakers with equal file counts); the
        # update (counts, one-hot centroid sums, EMA) on the card against
        # the CPU's from the card's ids
        c, n_, x = (torch.from_numpy(a) for a in (codebook, counts, batch))
        c_card, n_card, i_card = (t.cpu() for t in km._assign_update(c.to(dev), n_.to(dev), x.to(dev)))
        ids_card = k6.kmeans_argmin(x.to(dev), c.to(dev)).cpu()
        ties, gap = f64_ties(x, c, ids_card, k6.kmeans_argmin_plain(x, c), "stage 17 step")
        with mock.patch.object(km, "kmeans_argmin", lambda b, cb: ids_card):
            c_cpu, n_cpu, i_cpu = km._assign_update(c, n_, x)
        c_err, c_scale = (c_card - c_cpu).abs().max().item(), c_cpu.abs().max().item()
        if not torch.equal(n_card, n_cpu) or c_err > STAGE17_CENTROID_REL * c_scale:
            raise AssertionError(f"stage 17 step card vs CPU: counts equal {torch.equal(n_card, n_cpu)}, centroid "
                                 f"err {c_err} (scale {c_scale})")
        print(f"data_path stage 17 step card vs CPU [{card}]: N={STAGE17_B} ids equal but {len(ties)} f64 ties "
              f"(largest distance gap {gap:.3e}); from the same ids, counts equal and centroids max abs err "
              f"{c_err:.3e} at scale {c_scale:.3f} (limit {STAGE17_CENTROID_REL} of scale); inertia "
              f"{i_card.item():.6e} vs {i_cpu.item():.6e}")
        again, _ = preprocess_cluster.fit_codebook(cfg.data.train_path, k=len(codebook), verbose=False, device=dev)
        if not np.array_equal(again, codebook):
            raise AssertionError("stage 17: a second fit with the same seed differs from the first")
        print(f"data_path stage 17 [{card}]: a second fit with the same seed equals the first bit for bit")

        # K6 at stage 17's N against its plain version, the split covering all codes
        x, cb = torch.from_numpy(batch).to(dev), torch.from_numpy(codebook).to(dev)
        splits, per = k6.split_codes(STAGE17_B, len(codebook), torch.cuda.get_device_properties(dev).multi_processor_count)
        if splits * per < len(codebook) or (splits - 1) * per >= len(codebook):
            raise AssertionError(f"K6 split_codes at N={STAGE17_B}: {splits} x {per} codes")
        print(f"K6 at N={STAGE17_B}: {-(-STAGE17_B // k6.BLOCK_ROWS)} row tiles, {splits} code splits of {per} "
              f"(the last {len(codebook) - (splits - 1) * per} codes): all {len(codebook)} codes covered")
        row = k6_row(k6, x, cb, "stage 17")
    print(f"data_path phase [{card}]: {time.perf_counter() - t_phase:.1f} s of wall in all (stages, the serve, "
          f"the comparisons with the CPU)")
    return {"launches": launches, "k6_stage17": row, "k6_stage17_launches": k6_17, "walls": walls}


# migrate: the reference's artifact set at full width (seeded flax-init
# weights of the port, written in the reference's layouts by the inverses
# above), served through load_reference_pipeline and checked one by one by
# cli/verify_import.py as a user runs it
MIGRATE_STEPS = {"diffusion": 400000, "lm": 200000}  # the step numbers in the checkpoints' names
WHISPER_MIGRATE_LAYERS = 2  # of large-v3's 32: bounds the checkpoint's size and the phase's time
# the f32 Unit2Mel forward on the card against the CPU (TF32 off): within
# this share of the output's largest magnitude
MIGRATE_U2M_REL = 1e-4
VERIFY_TOL = 1e-3  # verify_import's default --tol


def write_reference_artifacts(tmp: str, cfg) -> dict:
    """The reference's artifact set under `tmp` for the shipped config, at
    full width: `exp/diffusion/model_<step>.pt` (the flagship Unit2Mel) with
    `config.yaml` beside it, `exp/lm/model_<step>.pt` (the RoFormer, HF
    keys), `pretrain/semantic_codebook.pt` (4096 x 1280, sklearn's dict),
    `pretrain/hifi-vaegan/{encoder,decoder}.pth` and a Whisper-large-v3
    `{dims, model_state_dict}` wrapper with WHISPER_MIGRATE_LAYERS layers.
    `cfg` is pointed at the codebook and the pair.  Returns the paths."""
    import torch

    from latent_diffusion_speech_tpu_torch.config import save_config
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2Mel, Unit2MelConfig
    from latent_diffusion_speech_tpu_torch.models.lm.registry import roformer_config_from
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import Roformer
    from latent_diffusion_speech_tpu_torch.models.units import get_encoder_out_channels
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.models.vaegan.models import Generator, VAEEncoder
    from latent_diffusion_speech_tpu_torch.models.whisper.model import WhisperDims, WhisperEncoder, sinusoids
    from latent_diffusion_speech_tpu_torch.ops.layers import init_weights, seeded

    paths = {"pair": os.path.join(tmp, "pretrain", "hifi-vaegan"),
             "codebook": os.path.join(tmp, "pretrain", "semantic_codebook.pt"),
             "whisper": os.path.join(tmp, "pretrain", "large-v3_encoder.pt"),
             "diffusion": os.path.join(tmp, "exp", "diffusion"), "lm": os.path.join(tmp, "exp", "lm")}
    for d in ("pair", "diffusion", "lm"):
        os.makedirs(paths[d])
    vcfg = VAEGANConfig()
    h = {k: (list(map(list, v)) if k == "resblock_dilation_sizes" else list(v) if isinstance(v, tuple) else v)
         for k, v in dataclasses.asdict(vcfg).items()}
    gen = torch.Generator().manual_seed(4)
    for name, module, stage in (("encoder", VAEEncoder(vcfg), "down"), ("decoder", Generator(vcfg), "up")):
        torch.save({"model": reference_codec_state(module, vcfg, gen, stage), "config": h},
                   os.path.join(paths["pair"], f"{name}.pth"))
    K, D = cfg.text2semantic.model.semantic_kmeans_num, get_encoder_out_channels(cfg.data.encoder)
    centroids = torch.from_numpy(np.random.default_rng(5).standard_normal((K, D)).astype(np.float32))
    torch.save({"n_features_in_": D, "_n_threads": 8, "cluster_centers_": centroids, "n_clusters": K},
               paths["codebook"])
    cfg.common.vocoder.ckpt, cfg.text2semantic.model.codebook_path = paths["pair"], paths["codebook"]

    m = cfg.diffusion.model
    model_cfg = Unit2MelConfig(input_channel=D, n_spk=cfg.common.n_spk, use_pitch_aug=m.use_pitch_aug,
                               out_dims=vcfg.inter_channels, n_layers=m.n_layers,
                               block_out_channels=tuple(m.block_out_channels), n_heads=m.n_heads, n_hidden=m.n_hidden)
    step = MIGRATE_STEPS["diffusion"]
    state = reference_unit2mel_state(seeded(lambda: Unit2Mel(model_cfg), 0).state_dict())
    torch.save({"global_step": step, "model": state}, os.path.join(paths["diffusion"], f"model_{step}.pt"))
    save_config(cfg, os.path.join(paths["diffusion"], "config.yaml"))
    lm_cfg = roformer_config_from(cfg)
    step = MIGRATE_STEPS["lm"]
    state = reference_roformer_state(seeded(lambda: Roformer(lm_cfg), 0).state_dict(), lm_cfg)
    torch.save({"global_step": step, "model": state}, os.path.join(paths["lm"], f"model_{step}.pt"))

    dims = WhisperDims(n_audio_layer=WHISPER_MIGRATE_LAYERS)
    whisper = WhisperEncoder(dims)
    init_weights(whisper, torch.Generator().manual_seed(0))
    state = {**whisper.state_dict(), "positional_embedding": sinusoids(dims.n_audio_ctx, dims.n_audio_state)}
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": state}, paths["whisper"])
    return paths


def verify_runs(jobs: dict, device: str, flags) -> dict:
    """`cli/verify_import.py`'s main on every kind's path with `--json
    --device <device> <flags(kind)>`, in this process; returns each kind's
    (report, wall seconds)."""
    from latent_diffusion_speech_tpu_torch.cli import verify_import

    out = {}
    for kind, path in jobs.items():
        argv = [path, "--json", "--device", device, *flags(kind)]
        t0, buf = time.perf_counter(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = verify_import.main(argv)
        if rc != 0:
            raise AssertionError(f"verify_import.main({argv}): {rc}\n{buf.getvalue()[-2000:]}")
        out[kind] = (json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0)
    return out


def verify_process(card: str, ckpt: str, golden: str, want: dict) -> None:
    """`python -m latent_diffusion_speech_tpu_torch.cli.verify_import` on the
    card against a CPU golden, as a user runs it, on links to the files and
    the config beside the checkpoint (they outlive migrate's directory):
    exit 0 within VERIFY_TOL, the
    report's kind, geometry and output shape equal to `want`'s.  Checked
    after the last phase (DEFERRED)."""
    import shutil
    import tempfile

    keep = tempfile.mkdtemp(dir=os.path.join(ROOT, "exp"))
    paths = []
    for src in (ckpt, golden, os.path.join(os.path.dirname(ckpt), "config.yaml")):  # the config beside the ckpt
        paths.append(os.path.join(keep, os.path.basename(src)))
        try:
            os.link(src, paths[-1])
        except OSError:
            shutil.copy(src, paths[-1])
    cmd = [sys.executable, "-m", "latent_diffusion_speech_tpu_torch.cli.verify_import", paths[0], "--json",
           "--device", "cuda", "--golden", paths[1]]
    t0 = time.perf_counter()
    proc = start_process(cmd)

    def check() -> None:
        stdout, _ = finish_process(proc, cmd)
        took = time.perf_counter() - t0
        shutil.rmtree(keep)
        got = json.loads(stdout.strip().splitlines()[-1])
        same = {k: got.get(k) == want.get(k) for k in ("kind", "geometry", "output_shape", "imported_elements")}
        if not got.get("golden_match") or not got["golden_rel_diff"] <= VERIFY_TOL or not all(same.values()):
            raise AssertionError(f"{' '.join(cmd)}: {got}; same as in this process {same}")
        print(f"migrate verify_import {got['kind']} as a process on the card [{card}]: exit 0, checked {took:.1f} s "
              f"after its start (started by migrate, running beside the phases that follow); golden_rel_diff "
              f"{got['golden_rel_diff']:.3e} (limit {VERIFY_TOL}) against the CPU's golden")

    DEFERRED.append(check)


def migrate(dev, card: str) -> dict:
    """The migration path on the card at full width: the reference's
    artifact set (`write_reference_artifacts`) through
    `infer/load.py::load_reference_pipeline` in bf16 and one EN `tts` (1 K1
    launch, 32 K4 launches a denoiser evaluation), and `cli/verify_import.py`'s
    `verify` on the codebook in-process (1 K6 launch, ids equal to the
    CPU's).  Then the set in f32 on the card against the CPU: the Unit2Mel
    forward at verify_import's inputs within MIGRATE_U2M_REL of its scale,
    K1's greedy logits up to the first flipped argmax (K1_F32_REL); and
    `verify_import` for every kind, `--device cpu --save-golden`, then
    `--device cuda --golden` (exit 0, within VERIFY_TOL; the codebook's ids
    equal), through its `main` in this process; and the card's unit2mel
    run once more as a process, as a user starts it (`verify_process`,
    checked after the last phase).  Returns the launches."""
    import argparse
    import tempfile

    import torch

    from latent_diffusion_speech_tpu_torch.cli import verify_import
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.infer.load import load_reference_pipeline
    from latent_diffusion_speech_tpu_torch.models.lm.sampling import SamplingConfig
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
        t0 = time.perf_counter()
        paths = write_reference_artifacts(tmp, cfg)
        ckpt = {k: os.path.join(paths[k], f"model_{MIGRATE_STEPS[k]}.pt") for k in ("diffusion", "lm")}
        mb = {k: os.path.getsize(p) / 2 ** 20 for k, p in (("diffusion", ckpt["diffusion"]), ("lm", ckpt["lm"]),
                                                             ("codebook", paths["codebook"]),
                                                             ("whisper", paths["whisper"]))}
        mb["pair"] = sum(os.path.getsize(os.path.join(paths["pair"], f)) for f in os.listdir(paths["pair"])) / 2 ** 20
        print(f"migrate artifacts: the reference's layouts at full width written in {time.perf_counter() - t0:.1f} s "
              f"(MiB: {', '.join(f'{k} {v:.1f}' for k, v in mb.items())}; Whisper cut to {WHISPER_MIGRATE_LAYERS} "
              f"of 32 layers)")
        lm_args = dict(lm_ckpt=paths["lm"], codebook_path=paths["codebook"], vocoder_path=paths["pair"])

        # 1. the serve path over the set, bf16, as a user migrates
        k1.launches = k4.launches = k4.bwd_launches = k6.launches = 0
        t = time.perf_counter()
        pipe = load_reference_pipeline(paths["diffusion"], device=dev, **lm_args)
        t_load = time.perf_counter() - t
        geometry = (pipe.diffusion.cfg.out_dims, pipe.diffusion.cfg.block_out_channels, pipe.lm.cfg.decoder.hidden_size,
                    pipe.lm.cfg.semantic_vocab_size, tuple(pipe.codebook.codebook.shape), pipe.vocoder.cfg.sampling_rate)
        if geometry != (128, (256, 384, 512, 512), 256, 4099, (4096, 1280), 44100):
            raise AssertionError(f"load_reference_pipeline geometry {geometry}")
        evaluations = []
        denoise = pipe.diffusion.diffusion.denoise_fn
        pipe.diffusion.diffusion.denoise_fn = lambda *a: evaluations.append(1) or denoise(*a)
        t = time.perf_counter()
        wav, sr = pipe.tts(TEXT, language="EN", method=cfg.common.infer.method, infer_speedup=SERVE_SPEEDUP)
        torch.cuda.synchronize()
        t_tts = time.perf_counter() - t
        wav = np.asarray(wav)
        n_eval = len(evaluations)
        if (k1.launches, k4.launches, k4.bwd_launches) != (1, 32 * n_eval, 0) or not n_eval:
            raise AssertionError(f"migrate tts: K1 {k1.launches}, K4 {k4.launches} for {n_eval} denoiser "
                                 f"evaluations, K4 backward {k4.bwd_launches}")
        if sr != 44100 or wav.ndim != 1 or not len(wav) or not np.isfinite(wav).all():
            raise AssertionError(f"migrate tts: {sr} Hz, shape {wav.shape}")
        report = verify_import.verify(argparse.Namespace(path=paths["codebook"], kind="auto", heads=0, golden=None,
                                                         save_golden=os.path.join(tmp, "codebook_card.npz"),
                                                         tol=VERIFY_TOL, json=True, device=dev))
        if k6.launches != 1 or report["kind"] != "codebook":
            raise AssertionError(f"verify_import on the codebook: kind {report['kind']}, K6 launches {k6.launches}")
        launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches, "kmeans_argmin": k6.launches}
        print(f"migrate serve [{card}]: load_reference_pipeline (bf16) {t_load:.2f} s; one EN tts {t_tts:.3f} s for "
              f"{len(wav) / sr:.3f} s of audio ({cfg.common.infer.method}, speedup {SERVE_SPEEDUP}: "
              f"{n_eval} denoiser evaluations); verify_import's verify on the codebook in-process; launches {launches}")
        del pipe
        torch.cuda.empty_cache()

        # 2. the set in f32: the card against the CPU
        p32 = {str(d): load_reference_pipeline(paths["diffusion"], dtype=torch.float32, device=d, **lm_args)
               for d in (dev, "cpu")}
        rng = np.random.default_rng(0)  # verify_import's unit2mel inputs
        u2m = p32["cpu"].diffusion.cfg
        units = rng.standard_normal((1, 64, u2m.input_channel)).astype(np.float32)
        x_t = rng.standard_normal((1, 64, u2m.out_dims)).astype(np.float32)
        outs = {}
        for d, p in p32.items():
            module = p.diffusion.module
            with torch.no_grad():
                cond = module.condition(torch.from_numpy(units).to(d), None, torch.ones(1, 1, dtype=torch.long,
                                                                                         device=d), None)
                x = torch.cat([torch.from_numpy(x_t).to(d), cond.float()], dim=-1)
                outs[d] = module.denoise(x, torch.full((1,), 10, device=d)).float().cpu()
        err, scale = (outs[str(dev)] - outs["cpu"]).abs().max().item(), outs["cpu"].abs().max().item()
        if not err <= MIGRATE_U2M_REL * scale:
            raise AssertionError(f"migrate Unit2Mel f32 card vs CPU: max err {err} (scale {scale})")
        print(f"migrate Unit2Mel f32 card vs CPU [{card}]: verify_import's forward (B=1, T=64, t=10) max abs err "
              f"{err:.3e} at scale {scale:.3f} (limit {MIGRATE_U2M_REL} of scale)")
        phones, tones = p32["cpu"].text_to_phones(TEXT, "EN")
        decode = {}
        for d, p in p32.items():
            arrays = (phones[None], tones[None], np.ones((1, len(phones)), np.int64), np.ones((1, len(phones)), np.int64))
            m = p.lm.module
            with torch.no_grad():
                kvs = m.compute_cross_kv(m.encode(*(torch.as_tensor(a, device=d).long() for a in arrays)))
            decode[d] = (m, kvs, torch.full((1,), len(phones), dtype=torch.int32, device=d))
        lm_cfg = p32["cpu"].lm.cfg
        sg = SamplingConfig(max_new_tokens=N_TOKENS, do_sample=False, eos_token_id=lm_cfg.semantic_eos,
                            pad_token_id=lm_cfg.semantic_pad, bos_token_id=lm_cfg.semantic_bos)
        m, kvs, clen = decode[str(dev)]
        err, n_cmp, scale, corr = k1_logits_close(m, sg, kvs, clen, "migrate f32 card vs CPU", K1_F32_REL,
                                                  K1_F32_CORR, ref=decode["cpu"])
        print(f"migrate K1 f32 greedy on the card vs the plain decode on the CPU [{card}]: {n_cmp} steps compared "
              f"(up to the first flipped argmax or N={N_TOKENS}), logits max abs err {err:.3e} at scale {scale:.3f} "
              f"(limit {K1_F32_REL} of scale), corr {corr:.8f}")
        del p32, decode
        torch.cuda.empty_cache()

        # 3. verify_import for every kind: CPU goldens, then the card
        jobs = {"codebook": paths["codebook"], "unit2mel": ckpt["diffusion"], "roformer": ckpt["lm"],
                "vaegan-encoder": os.path.join(paths["pair"], "encoder.pth"),
                "vaegan-decoder": os.path.join(paths["pair"], "decoder.pth"), "whisper": paths["whisper"]}

        def golden(kind, where):
            return os.path.join(tmp, f"{kind}_{where}.npz")

        cpu = verify_runs(jobs, "cpu", lambda k: ["--save-golden", golden(k, "cpu")])
        gpu = verify_runs(jobs, "cuda", lambda k: ["--golden", golden(k, "cpu"), "--save-golden", golden(k, "cuda")])
        verify_process(card, jobs["unit2mel"], golden("unit2mel", "cpu"), gpu["unit2mel"][0])
        for kind in jobs:
            (want, t_cpu), (got, t_gpu) = cpu[kind], gpu[kind]
            same = {key: got.get(key) == want.get(key) for key in ("kind", "geometry", "output_shape",
                                                                    "torch_keys_unused", "imported_elements")}
            if (got["kind"] != kind or not got["golden_match"] or not got["golden_rel_diff"] <= VERIFY_TOL
                    or not all(same.values())):
                raise AssertionError(f"verify_import {kind} on the card against its CPU golden: {got}; same {same}")
            print(f"migrate verify_import {kind} [{card}]: CPU {t_cpu:.1f} s, card {t_gpu:.1f} s (in this process); "
                  f"golden_rel_diff {got['golden_rel_diff']:.3e} (limit {VERIFY_TOL}); output {got['output_shape']}; "
                  f"torch elements {got.get('torch_elements')}, imported {got['imported_elements']}; unused keys "
                  f"{got.get('torch_keys_unused', 'not tracked')}")
        ids = [np.load(golden("codebook", w))["output"] for w in ("cpu", "cuda")]
        if not np.array_equal(*ids):
            raise AssertionError(f"verify_import codebook ids: CPU {ids[0]}, card {ids[1]}")
        in_process = np.load(os.path.join(tmp, "codebook_card.npz"))["output"]
        if not np.array_equal(in_process, ids[0]):
            raise AssertionError(f"verify_import codebook ids in-process {in_process}, CPU process {ids[0]}")
        print(f"migrate verify_import codebook ids [{card}]: card (K6) equal to the CPU's: {ids[1].tolist()}")
    print(f"migrate phase [{card}]: {time.perf_counter() - t_phase:.1f} s of wall in all")
    return {"launches": launches}


# codec_train: the HiFi-VAEGAN codec trained through cli/train_codec.py at the
# shipped 44.1 kHz width (hop 512, 128 latent channels), the CodecTrainer's
# bank (STFT scales 1024 and 512, periods 2-11), B=16 crops of 0.74 s
CODEC_B, CODEC_CROP, CODEC_STEPS = 16, 32256, (2, 2)  # batch; samples a crop; steps before and after the resume
CODEC_FILES = 8  # synthetic voiced WAVs of 2-3.75 s
CODEC_CPU_B = 1  # the card-against-CPU step's batch


def write_codec_layout(root: str, sr: int, seed: int = 0) -> None:
    """`<root>/audio/<i>.wav`: vibrato tones with harmonics and a little
    noise, 2-3.75 s each (every crop of 0.74 s is a real excerpt)."""
    from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    for i in range(CODEC_FILES):
        t = np.arange(int((2.0 + 0.25 * i) * sr)) / sr
        phase = 2 * np.pi * (110 + 25 * i) * (t + 0.02 * np.sin(2 * np.pi * 5 * t))
        wav = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3)) + 0.01 * rng.standard_normal(len(t))
        write_wav(os.path.join(root, "audio", f"{i}.wav"), wav.astype(np.float32), sr)


def compare_codec_step(vcfg, audio: np.ndarray, dev) -> str:
    """One D + G step of `CodecTrainer` (seed 0) on the card against the
    same step on the CPU: the same seeded weights, audio and latent noise
    (drawn on the CPU), TF32 off.  The losses within rtol 1e-4 (the KL
    also within atol 1e-5: at the seeded weights logs ~ 0, and each of the
    128 channels' e^logs - logs - 1 cancels to f32 rounding, ~1e-7); each
    network's gradients (taken as the optimiser is called) within 1e-3 of
    their norm (L2); each parameter after the update within 2 lr (1 + 1e-3)
    of the CPU's: Adam's first step is lr * g / (|g| + eps), about
    lr * sign(g), so a gradient that rounds to the other sign near 0 moves
    its element by up to 2 lr, and the share of such elements is reported."""
    import torch

    from latent_diffusion_speech_tpu_torch.train.codec_trainer import CodecTrainer

    runs = []
    for device in (dev, "cpu"):
        t = CodecTrainer(vcfg, device=device)
        nets = {"encoder": t.encoder, "generator": t.generator, "disc": t.disc}
        grads = {}

        def recording(opt, names):
            real = opt.apply_update

            def apply_update(*args, **kwargs):
                grads.update({n: p.grad.detach().cpu().clone() for n, p in zip(names, opt._params)})
                return real(*args, **kwargs)
            return apply_update

        t.gen_opt.apply_update = recording(t.gen_opt, [f"encoder.{n}" for n, _ in t.encoder.named_parameters()]
                                           + [f"generator.{n}" for n, _ in t.generator.named_parameters()])
        t.disc_opt.apply_update = recording(t.disc_opt, [f"disc.{n}" for n, _ in t.disc.named_parameters()])
        before = {f"{k}.{n}": p.detach().cpu().clone() for k, m in nets.items() for n, p in m.named_parameters()}
        a = torch.from_numpy(audio).to(t.device)
        g = torch.Generator().manual_seed(7)
        eps_d, eps_g = t.latent_noise(a, g), t.latent_noise(a, g)
        t0 = time.perf_counter()
        d = t.disc_step(a, eps_d).item()
        gl, aux = t.gen_step(a, eps_g)
        losses = {"disc/loss": d, "gen/loss": gl.item(), **{k: v.item() for k, v in aux.items()}}
        secs = time.perf_counter() - t0
        after = {f"{k}.{n}": p.detach().cpu().clone() for k, m in nets.items() for n, p in m.named_parameters()}
        runs.append((losses, grads, before, after, secs))
        lr = t.gen_opt.schedule(0)
        del t
    (lc, gc, bc, ac, sc), (lp, gp, bp, ap, sp) = runs
    for k, v in lp.items():
        if abs(lc[k] - v) > 1e-4 * abs(v) + (1e-5 if k == "gen/kl" else 1e-7):
            raise AssertionError(f"codec step {k}: {lc[k]} on the card vs {v} on the CPU")
    if not all(torch.equal(bc[n], bp[n]) for n in bp):
        raise AssertionError("codec step: the card's seeded weights differ from the CPU's")
    rows = []
    for net in ("encoder", "generator", "disc"):
        names = [n for n in gp if n.startswith(net + ".")]
        g_err = relative_l2({n: gc[n] for n in names}, {n: gp[n] for n in names})
        gap = max((ac[n] - ap[n]).abs().max().item() for n in names)
        flips = sum(((ac[n] - bc[n]).sign() != (ap[n] - bp[n]).sign()).sum().item() for n in names)
        total = sum(ap[n].numel() for n in names)
        if g_err > 1e-3 or gap > 2 * lr * (1 + 1e-3):
            raise AssertionError(f"codec step {net}: gradient error {g_err}, parameter gap {gap} (2 lr = {2 * lr})")
        p_err = relative_l2({n: ac[n] for n in names}, {n: ap[n] for n in names})
        rows.append(f"{net} gradients {g_err:.2e}, parameters after the update {p_err:.2e} (relative L2), largest "
                    f"parameter gap {gap:.2e} ({gap / lr:.2f} lr), update signs differing in {flips} of {total}")
    return (f"losses {', '.join(f'{k} {lc[k]:.6g} vs {v:.6g}' for k, v in lp.items())}; " + "; ".join(rows)
            + f" (limits: gradients 1e-3 relative L2, parameters 2 lr); the step {sc * 1e3:.1f} ms on the card "
            f"(first call) and {sp:.2f} s on the CPU")


def codec_train(dev, card: str) -> dict:
    """Codec GAN training through `cli/train_codec.py::main` at the shipped
    width, on a synthetic WAV layout: CODEC_STEPS (a save, a resume between),
    then again with --use-vq; one step on the card against the CPU."""
    import tempfile

    import torch

    from latent_diffusion_speech_tpu_torch.cli import train_codec
    from latent_diffusion_speech_tpu_torch.config import load_config, save_config
    from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
    from latent_diffusion_speech_tpu_torch.ops.audio_io import load_audio
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.train.checkpoint import latest_checkpoint_step
    from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger

    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
        vcfg = VAEGANConfig(sampling_rate=cfg.data.sampling_rate)
        crop = int(0.74 * cfg.data.sampling_rate)
        crop -= crop % vcfg.hop_size
        if (vcfg.sampling_rate, vcfg.hop_size, vcfg.inter_channels, crop) != (44100, 512, 128, CODEC_CROP):
            raise AssertionError(f"the shipped codec geometry changed: {vcfg}, crop {crop}")
        sr = vcfg.sampling_rate
        write_codec_layout(os.path.join(tmp, "train"), sr)
        cfg.data.train_path = os.path.join(tmp, "train")
        cfg_path = os.path.join(tmp, "config.yaml")
        save_config(cfg, cfg_path)

        clips = [load_audio(os.path.join(tmp, "train", "audio", f"{i}.wav"), target_sr=vcfg.sampling_rate)[0]
                 for i in range(CODEC_CPU_B)]
        audio = np.stack([c[1000:1000 + CODEC_CROP] for c in clips]).astype(np.float32)
        print(f"codec_train step, card vs CPU (B={CODEC_CPU_B}, f32, TF32 off) [{card}]: "
              f"{compare_codec_step(vcfg, audio, dev)}")

        times, metrics = [], []
        real_log = MetricsLogger.log

        def log(self, step, m):
            times[-1].append(time.perf_counter())
            metrics.append(m)
            return real_log(self, step, m)

        k4.launches = k4.bwd_launches = k6.launches = 0
        runs = {}
        # with a resume after CODEC_STEPS[0] steps, plain and --use-vq; then
        # plain without the resume (which restarts the optimisers, R9)
        n = sum(CODEC_STEPS)
        for name, vq, legs in (("", False, (CODEC_STEPS[0], n)), (" --use-vq", True, (CODEC_STEPS[0], n)),
                               (" uninterrupted", False, (n,))):
            expdir = os.path.join(tmp, "codec" + name.strip().replace("-", ""))
            args = ["-c", cfg_path, "--expdir", expdir, "--interval-log", "1", "--interval-save", "1000"]
            args += ["--use-vq"] if vq else []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with mock.patch.object(MetricsLogger, "log", log):
                for steps in legs:
                    times.append([time.perf_counter()])
                    trainer = train_codec.main(args + ["--max-steps", str(steps)])
                    if latest_checkpoint_step(expdir) != steps or trainer.step != steps:
                        raise AssertionError(f"codec_train: step {trainer.step}, checkpoint "
                                             f"{latest_checkpoint_step(expdir)}, want {steps}")
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            util = trainer.vq.utilization(trainer.vq_state).item() if vq else None
            if vq and not util > 0:
                raise AssertionError(f"codec_train --use-vq: codebook utilisation {util}")
            runs[name] = (times[-len(legs):], metrics[-n:], peak, util)
            del trainer
        if k4.launches or k4.bwd_launches or k6.launches:
            raise AssertionError("codec_train launched a K4 or K6 kernel: the codec path has none")
    for name, (legs, ms, peak, util) in runs.items():
        step_s = [b - a for leg in legs for a, b in zip(leg, leg[1:])]
        steady = [s for i, s in enumerate(step_s) if i not in (0, CODEC_STEPS[0] if len(legs) > 1 else 0)]
        med = float(np.median(steady))
        bad = [m for m in ms if not all(np.isfinite(v) for v in m.values())]
        if len(ms) != n or bad:
            raise AssertionError(f"codec_train metrics {ms}")
        how = f"{CODEC_STEPS[0]}, save, resume, {CODEC_STEPS[1]} more" if len(legs) > 1 else "one run"
        print(f"codec_train{name} [{card}]: {n} steps at B={CODEC_B} x {CODEC_CROP} samples f32 ({how}) through "
              f"cli/train_codec.py; step median {med * 1e3:.1f} ms over {len(steady)} steps (all: "
              f"{[round(s * 1e3, 1) for s in step_s]} ms; each leg's first includes its start-up); "
              f"{CODEC_B / med:.1f} samples/s, {CODEC_B * CODEC_CROP / med / sr:.1f} s of audio a second; peak "
              f"allocated {peak:.2f} GiB; gen/loss {[round(m['gen/loss'], 3) for m in ms]}, disc/loss "
              f"{[round(m['disc/loss'], 3) for m in ms]}"
              + (f"; VQ codebook utilisation {util:.4f}" if util is not None else ""))
    return runs


# llama_text: the Llama LM (dense and MoE) served and trained at the
# reference geometry, the text-mode front end and the leftovers
LLAMA_GEOM = (768, 4, 4, 512)  # width, heads, layers, FFN: the JAX LlamaConfig's defaults
LLAMA_MOE = (8, 2, 1.25)  # experts, top-k, capacity factor
LLAMA_PARAMS = {"dense": 20_624_640, "moe": 53_679_360}  # 20.6 M and 53.7 M
LLAMA_B, LLAMA_STEPS, LLAMA_VAL_AT = 32, (3, 3), 4  # batch; steps before / after the resume; interval_val
LLAMA_CPU_B = 2  # the card-against-CPU step's batch (the longest batch's first rows)
LLAMA_GREEDY_N = 128  # decode steps of the greedy card-against-CPU comparison
BERT_TEXT = "Please read the following sentence slowly and clearly, then bring the book back home."
F0_SIGNAL_S = 10.0


def llama_corpus_config(tmp: str, moe: bool):
    """The shipped config with `type: llama` at LLAMA_GEOM over the
    phase's corpus (`write_lm_corpus`, stages 15 and 16), threaded loader,
    every step logged, seeded diffusion behind validation audio."""
    from latent_diffusion_speech_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    m, tcfg = cfg.text2semantic.model, cfg.text2semantic.train
    m.type = "llama"
    d = m.decoder
    d.hidden_size, d.num_attention_heads, d.num_hidden_layers, d.intermediate_size = LLAMA_GEOM
    if moe:
        m.moe_experts, m.moe_top_k, m.moe_capacity_factor = LLAMA_MOE
    m.codebook_path = os.path.join(tmp, "no-codebook.npz")
    cfg.data.train_path, cfg.data.valid_path = os.path.join(tmp, "train"), os.path.join(tmp, "val")
    cfg.diffusion.train.expdir = os.path.join(tmp, "no-diffusion")
    tcfg.batch_size, tcfg.loader_processes, tcfg.interval_log = LLAMA_B, 0, 1
    tcfg.interval_val = LLAMA_VAL_AT if not moe else 10 ** 9
    tcfg.expdir = os.path.join(tmp, "exp_llama_moe" if moe else "exp_llama")
    if moe:  # no validation, so no validation pipeline: a weight_quant value
        # the diffusion model refuses (ValueError) makes stage 21's build skip it
        cfg.common.infer.weight_quant = "none"
    return cfg


def compare_llama_step(cfg, batch, dev) -> str:
    """One Llama trainer step on the card (TF32 off) against the same step
    on the CPU from the same seeded weights and batch: the loss's relative
    error and the largest relative L2 error of a gradient tensor.  With
    experts, each call's top-k expert choices are recorded: where a near
    tie in the router's f32 probabilities falls the other way on the card,
    the routing (and which tokens a full expert drops) differs, and so does
    the step.  The step is held to the CPU's when the routing agrees; the
    choices that differ are counted and reported otherwise."""
    from latent_diffusion_speech_tpu_torch.ops import moe
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    got = []
    for device in (dev, "cpu"):
        trainer = LMTrainer(cfg, device=device)
        choices, real_top_k = [], moe.top_k_lowest_index

        def top_k(probs, k):
            vals, idx = real_top_k(probs, k)
            choices.append(idx.cpu())
            return vals, idx

        t0 = time.perf_counter()
        with mock.patch.object(moe, "top_k_lowest_index", top_k):
            loss = trainer.train_step(trainer.device_put_batch(batch))["loss"].item()
        got.append((loss, {n: p.grad.cpu() for n, p in trainer.system.module.named_parameters()},
                    time.perf_counter() - t0, choices))
        del trainer
    (loss, grads, t_card, ch), (loss_p, grads_p, t_cpu, ch_p) = got
    flips = sum(int((a != b).sum()) for a, b in zip(ch, ch_p))
    routed = sum(a.numel() for a in ch_p)
    rel = {n: ((g - grads_p[n]).norm() / grads_p[n].norm().clamp_min(1e-30)).item() for n, g in grads.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    if loss_rel > (1e-5 if not flips else 1e-4) or (not flips and rel[worst] > 1e-3):
        raise AssertionError(f"Llama step: loss {loss} on the card vs {loss_p} on the CPU, gradient {worst} "
                             f"relative L2 error {rel[worst]:.3e}, {flips} of {routed} expert choices differ")
    routing = (f"; expert choices: {flips} of {routed} differ (near ties; the gradients are held to the CPU's "
               f"only when none does)" if ch_p else "")
    return (f"loss {loss:.7f} on the card vs {loss_p:.7f} on the CPU (relative error {loss_rel:.2e}); "
            f"{len(grads)} gradient tensors, largest relative L2 error {rel[worst]:.2e} ({worst}), median "
            f"{float(np.median(list(rel.values()))):.2e}{routing}; step {t_card * 1e3:.1f} ms on the card (first "
            f"call), {t_cpu:.2f} s on the CPU")


def llama_train_run(tmp: str, moe: bool, dev, card: str) -> dict:
    """Stage 21 with `type: llama`: `build` + `train` for all steps, then
    `main` for LLAMA_STEPS[0] and again (resume) to the end; the two
    checkpoints bitwise equal; step times, tokens/s, train/mfu, peak
    memory; with experts the dropped share of the routed choices."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli import train_lm
    from latent_diffusion_speech_tpu_torch.config import save_config
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.moe import MoEMLP
    from latent_diffusion_speech_tpu_torch.train.checkpoint import load_checkpoint
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer
    from latent_diffusion_speech_tpu_torch.utils.logger import MetricsLogger

    name = "moe" if moe else "dense"
    cfg = llama_corpus_config(tmp, moe)
    tcfg = cfg.text2semantic.train
    cfg_path = os.path.join(tmp, f"config_{name}.yaml")
    save_config(cfg, cfg_path)
    n = sum(LLAMA_STEPS)

    cfg_a = copy.deepcopy(cfg)
    cfg_a.text2semantic.train.expdir = tcfg.expdir + "_a"
    cfg_a.text2semantic.train.interval_val = 10 ** 9
    trainer_a, loader_a, val_a, logger_a, pipe_a = train_lm.build(cfg_a, device=dev)
    del pipe_a
    n_params = sum(p.numel() for p in trainer_a.system.module.parameters())
    if n_params != LLAMA_PARAMS[name] or trainer_a.lm_cfg.vocab_size != 4207:
        raise AssertionError(f"llama {name}: {n_params} parameters, V={trainer_a.lm_cfg.vocab_size}")
    stats = lm_batch_stats(loader_a, range(n // len(loader_a) + 1))[:n]
    longest = max(range(len(loader_a)), key=lambda i: stats[i][0])
    loader_a.set_epoch(0)
    step_batch = [b for _, b in zip(range(longest + 1), loader_a)][-1]
    small = {k: v[:LLAMA_CPU_B] for k, v in step_batch.items()}
    print(f"llama_text {name} step, card vs CPU (f32, B={LLAMA_CPU_B}, T={small['input_ids'].shape[1]}) [{card}]: "
          f"{compare_llama_step(cfg, small, dev)}")
    trainer_a.train(loader_a, max_steps=n)
    for x in (loader_a, val_a, logger_a):
        x.close()

    times, val = [], {}
    real_log, real_validate = MetricsLogger.log, LMTrainer.validate_audio

    def log(self, step, metrics):
        if "train/loss" in metrics:
            times[-1].append(time.perf_counter())
        return real_log(self, step, metrics)

    def validate_audio(self, *a, **kw):
        torch.cuda.synchronize()
        t0, before = time.perf_counter(), k4.launches
        out = real_validate(self, *a, **kw)
        torch.cuda.synchronize()
        val.update(step=self.step, s=time.perf_counter() - t0, k4=k4.launches - before)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(MetricsLogger, "log", log), mock.patch.object(LMTrainer, "validate_audio",
                                                                          validate_audio):
        for steps in (LLAMA_STEPS[0], n):
            times.append([time.perf_counter()])
            train_lm.main(["-c", cfg_path, "--max-steps", str(steps)])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    (step_a, params_a, opt_a), (step_b, params_b, opt_b) = (load_checkpoint(e) for e in
                                                            (cfg_a.text2semantic.train.expdir, tcfg.expdir))
    differ = [k for k in params_a if not torch.equal(params_a[k], params_b[k])]
    if (step_a, step_b) != (n, n) or differ or not same_state(opt_a, opt_b):
        raise AssertionError(f"llama {name} resume: steps {step_a} / {step_b}, parameters differ at {differ[:5]}")
    if not moe and (val.get("step") != LLAMA_VAL_AT or val["k4"] not in (0, 640)):
        raise AssertionError(f"llama validation: {val} (want one call at step {LLAMA_VAL_AT}, 640 K4 launches "
                             "when it synthesises)")
    rows = [json.loads(x) for x in open(os.path.join(tcfg.expdir, "logs", "metrics.jsonl"))]
    train_rows = [r for r in rows if "train/loss" in r]
    mfu = [r.get("train/mfu") for r in train_rows]
    losses = [r["train/loss"] for r in train_rows]
    vals = [r for r in rows if "val/loss" in r]
    if len(train_rows) != n or any(x is None for x in mfu) or not all(np.isfinite(losses)):
        raise AssertionError(f"llama {name} metrics: {train_rows}")

    drop = None
    if moe:  # the routed choices without a slot, layer by layer, on the longest batch
        with torch.no_grad():
            trainer_a.system.module(*(torch.as_tensor(step_batch[k], device=dev) for k in ("input_ids",
                                                                                          "attention_mask")))
        drop = [m.drop_fraction.item() for m in trainer_a.system.module.modules() if isinstance(m, MoEMLP)]
    del trainer_a

    step_s = [b - a for leg in times for a, b in zip(leg, leg[1:])]
    skip = {0, LLAMA_STEPS[0]} | ({LLAMA_VAL_AT} if not moe else set())
    steady = [s for i, s in enumerate(step_s) if i not in skip]
    median = float(np.median(steady))
    tokens = float(np.mean([t for _, t, _ in stats]))
    print(f"llama_text {name} training [{card}]: {n_params / 1e6:.1f} M parameters, {n} steps at B={LLAMA_B} f32 "
          f"({LLAMA_STEPS[0]} through stage 21's main, then main again: resume, {LLAMA_STEPS[1]} more; buckets "
          f"{sorted({s for s, _, _ in stats})}); losses {[round(x, 4) for x in losses]}; the resumed run's "
          f"{len(params_b)} parameter tensors and AdamW state bitwise equal to the uninterrupted run's")
    print(f"llama_text {name} step [{card}]: median {median * 1e3:.2f} ms over {len(steady)} steps (all: "
          f"{[round(s * 1e3, 2) for s in step_s]} ms); {LLAMA_B / median:.1f} samples/s; {tokens / median:.0f} "
          f"non-pad tokens/s ({tokens:.0f} a batch); train/mfu {[round(x, 4) for x in mfu]}; peak allocated "
          f"{peak:.2f} GiB" + (f"; dropped share of the routed choices by layer {[round(x, 4) for x in drop]}"
                               if moe else ""))
    if vals:
        print(f"llama_text {name} evaluate + validate_audio at step {val['step']} [{card}]: {val['s']:.3f} s wall, "
              f"{val['k4']} K4 launches; val/loss {vals[0]['val/loss']:.4f}, val/top5_acc "
              f"{vals[0]['val/top5_acc']:.4f}")
    return dict(cfg=cfg, params=params_b, median=median, peak=peak, drop=drop, val_k4=val.get("k4", 0))


def llama_serve(cfg, params, dev, card: str) -> dict:
    """The trained dense checkpoint served through `build_pipeline(lm_ckpt=)`
    in bf16: one warm-up and one measured `tts` of N_TOKENS decode steps;
    tts_batch raises (R11); LLAMA_GREEDY_N greedy tokens on the card against
    the CPU's."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaSystem
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    tcfg = cfg.text2semantic.train
    pipe = build_pipeline(cfg, lm_ckpt=tcfg.expdir)
    if not isinstance(pipe.lm, LlamaSystem) or pipe.lm.module.lm_head.weight.dtype != torch.bfloat16:
        raise AssertionError(f"build_pipeline served {type(pipe.lm).__name__}")
    served = pipe.lm.module.state_dict()
    if any(not torch.equal(served[k].cpu(), v.to(served[k].dtype)) for k, v in params.items()):
        raise AssertionError("build_pipeline(lm_ckpt=): the served Llama's weights are not the checkpoint's")
    stages: dict = {}
    generated = []
    real_generate = pipe.lm.generate

    def generate(*a, **kw):
        toks, lens = real_generate(*a, **kw)
        generated.append(int(lens[0]))
        return toks, lens

    pipe.lm.generate = timed(stages, "lm_decode", generate)
    pipe.diffusion.infer = timed(stages, "diffusion_20step", pipe.diffusion.infer)
    pipe.vocoder.infer = timed(stages, "vocoder", pipe.vocoder.infer)
    before = k4.launches
    pipe.tts(TEXT, language="EN", max_length=N_TOKENS)  # warm-up
    stages.clear()
    t0 = time.perf_counter()
    wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
    t_tts = time.perf_counter() - t0
    n_k4 = k4.launches - before
    if n_k4 != 2 * 640 or sr != 44100 or not len(wav) or not np.isfinite(wav).all():
        raise AssertionError(f"llama tts: {n_k4} K4 launches (want 2 x 640), {sr} Hz, {wav.shape}")
    try:
        pipe.tts_batch(BATCH_TEXTS, language="EN", max_length=N_TOKENS)
        raise AssertionError("tts_batch served a Llama pipeline (the JAX package cannot: R11)")
    except TypeError as err:
        r11 = str(err)
    print(f"llama_text serve (bf16, build_pipeline over model_{sum(LLAMA_STEPS)}.ckpt) [{card}]: tts "
          f"{len(wav) / sr:.3f} s of audio ({generated[-1]} tokens) in {t_tts:.3f} s; lm_decode "
          f"{stages['lm_decode'] * 1e3:.1f} ms for {N_TOKENS} steps ({stages['lm_decode'] * 1e3 / N_TOKENS:.3f} ms a "
          f"step, the prompt's prefill included), diffusion {stages['diffusion_20step']:.4f} s, vocoder "
          f"{stages['vocoder']:.4f} s; {n_k4} K4 launches (warm-up and measured); tts_batch raised: {r11[:60]}...")

    phones, _ = pipe.text_to_phones(TEXT, "EN")
    greedy = {}
    for where, dtype in ((dev, torch.float32), ("cpu", torch.float32), (dev, torch.bfloat16)):
        lm = LlamaSystem(pipe.lm.cfg, state_dict=params, dtype=dtype, device=where)
        t0 = time.perf_counter()
        toks, lens = lm.generate(phones[None], max_length=LLAMA_GREEDY_N, do_sample=False)
        greedy[(str(where), dtype)] = (toks[0].cpu().numpy(), int(lens[0]), time.perf_counter() - t0)
        del lm
    card32, cpu32, card16 = (greedy[k] for k in ((str(dev), torch.float32), ("cpu", torch.float32),
                                                 (str(dev), torch.bfloat16)))

    def agree(a, b) -> str:
        diff = np.nonzero(a[0] != b[0])[0]
        return ("identical" if not len(diff) and a[1] == b[1]
                else f"agree up to step {int(diff[0]) if len(diff) else LLAMA_GREEDY_N}")

    print(f"llama_text greedy decode, {LLAMA_GREEDY_N} steps [{card}]: f32 card vs f32 CPU tokens {agree(card32, cpu32)} "
          f"(lengths {card32[1]} / {cpu32[1]}; {card32[2]:.3f} s on the card, {cpu32[2]:.3f} s on the CPU); bf16 "
          f"card vs f32 CPU {agree(card16, cpu32)} ({card16[2]:.3f} s)")
    return dict(k4=n_k4, t_tts=t_tts, stages=stages)


def bert_phase(tmp: str, dev, card: str) -> None:
    """Seeded BertEncoderModel at bert-base-multilingual-cased's geometry
    (JAX BertConfig's default), post-LN (through a local checkpoint
    directory, `get_bert_feature`) and MegatronBert's pre-LN, f32 and bf16,
    against the CPU; stage 16's text mode over the phase's vocab;
    verify_import on the checkpoint."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli import verify_import
    from latent_diffusion_speech_tpu_torch.cli.preprocess_text import merge_labels
    from latent_diffusion_speech_tpu_torch.cli.preprocess_tts import process_tts
    from latent_diffusion_speech_tpu_torch.models.bert import BertConfig, BertEncoderModel
    from latent_diffusion_speech_tpu_torch.ops.layers import init_weights
    from latent_diffusion_speech_tpu_torch.text.bert import NativeBertFeatures, get_bert_feature, get_bert_token

    vocab = os.path.join(tmp, "vocab.txt")
    words = sorted(set(LM_WORDS) | set(re.findall(r"[a-z]+", BERT_TEXT.lower())))
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ",", ".", "!", "?", *words]))
    ids, tokens = get_bert_token(BERT_TEXT, vocab_file=vocab)
    if "[UNK]" in tokens or ids[0] != 2 or ids[-1] != 3:
        raise AssertionError(f"WordPiece over the phase's vocab: {tokens}")

    for pre_ln in (False, True):
        cfg = BertConfig(pre_ln=pre_ln)
        with torch.device("meta"):
            module = BertEncoderModel(cfg)
        module = module.to_empty(device=dev)
        init_weights(module, torch.Generator(device=dev).manual_seed(int(pre_ln)))
        n_params = sum(p.numel() for p in module.parameters())
        state = {k: v.cpu() for k, v in module.state_dict().items()}
        layout = "MegatronBert pre-LN" if pre_ln else "BERT post-LN"
        hf_cfg = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
                      num_attention_heads=cfg.num_attention_heads, intermediate_size=cfg.intermediate_size,
                      max_position_embeddings=cfg.max_position_embeddings, type_vocab_size=cfg.type_vocab_size,
                      layer_norm_eps=cfg.layer_norm_eps, model_type="megatron-bert" if pre_ln else "bert")
        ref_state = reference_bert_state(state, pre_ln)
        if pre_ln:  # handed in, as an HF model would be
            hf = type("HF", (), {"config": type("Cfg", (), hf_cfg)(), "state_dict": lambda self: ref_state})()
            extractors = {torch.float32: NativeBertFeatures(hf_model=hf), torch.bfloat16:
                          NativeBertFeatures(hf_model=hf, dtype=torch.bfloat16)}
            cpu = NativeBertFeatures(hf_model=hf, device="cpu")
        else:  # a local HF checkpoint directory, read without transformers
            ckpt = os.path.join(tmp, "bert-base-multilingual-cased")
            os.makedirs(ckpt)
            with open(os.path.join(ckpt, "config.json"), "w") as f:
                json.dump(hf_cfg, f)
            torch.save(ref_state, os.path.join(ckpt, "pytorch_model.bin"))
            extractors = {torch.float32: NativeBertFeatures(cache_dir=ckpt),
                          torch.bfloat16: NativeBertFeatures(cache_dir=ckpt, dtype=torch.bfloat16)}
            cpu = NativeBertFeatures(cache_dir=ckpt, device="cpu")
            word2ph = [1] + [2] * (len(ids) - 2) + [1]
            feats = get_bert_feature(BERT_TEXT, word2ph, vocab_file=vocab, cache_dir=ckpt)
            if feats.shape != (cfg.hidden_size, sum(word2ph)) or not np.isfinite(feats).all():
                raise AssertionError(f"get_bert_feature: {feats.shape}")
            rep = verify_import.verify(argparse.Namespace(path=os.path.join(ckpt, "pytorch_model.bin"), kind="auto",
                                                          heads=0, golden=None, save_golden=None, tol=1e-3,
                                                          json=True, device=str(dev)))
            if rep["kind"] != "bert" or rep["geometry"] != {"vocab": 119547, "hidden": 768, "layers": 12} or \
                    rep["imported_elements"] != n_params or not rep["output_finite"]:
                raise AssertionError(f"verify_import --kind bert: {rep}")
            print(f"llama_text verify_import bert [{card}]: geometry {rep['geometry']}, {rep['imported_elements']} "
                  f"elements imported, leaf statistics mean {rep['output_mean']:.5f}")
        del module
        ref = cpu.features(ids)
        out = {}
        for dtype, ex in extractors.items():
            ex.features(ids)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                f_card = ex.features(ids)
            out[dtype] = (f_card, (time.perf_counter() - t0) / 5)
        rel = {dtype: float(np.abs(f - ref).max() / np.abs(ref).max()) for dtype, (f, _) in out.items()}
        if rel[torch.float32] > 1e-4 or rel[torch.bfloat16] > 0.1 or not np.isfinite(out[torch.bfloat16][0]).all():
            raise AssertionError(f"BERT {layout}: hidden_states[-3] card vs CPU relative errors {rel}")
        print(f"llama_text {layout} seeded at bert-base-multilingual-cased's geometry ({n_params / 1e6:.1f} M) "
              f"[{card}]: hidden_states[-3] of {len(ids)} tokens, f32 card vs CPU max error {rel[torch.float32]:.2e} "
              f"of scale, bf16 card vs f32 CPU {rel[torch.bfloat16]:.2e}; {out[torch.float32][1] * 1e3:.2f} ms f32, "
              f"{out[torch.bfloat16][1] * 1e3:.2f} ms bf16 a forward (back to back, host clock)")
        del extractors, cpu

    root = os.path.join(tmp, "text_mode")
    for i in range(8):
        spk_dir = os.path.join(root, "audio", f"spk{i % 2}")
        os.makedirs(spk_dir, exist_ok=True)
        open(os.path.join(spk_dir, f"{i // 2}.wav"), "wb").close()
        with open(os.path.join(spk_dir, f"{i // 2}.txt"), "w", encoding="utf-8") as f:
            f.write(" ".join(np.random.default_rng(i).choice(LM_WORDS, 8)).capitalize() + ".\n")
    merge_labels(root)
    with mock.patch.dict(os.environ, {"LDS_BERT_VOCAB": vocab}):
        written = dict(process_tts(root, mode="text"))
    files = [np.load(os.path.join(root, "utt", k + ".npy"), allow_pickle=True) for k in written]
    if len(files) != 8 or any(f[0][0] != 2 or f[0][-1] != 3 or 1 in f[0] or any(len(x) for x in f[1:])
                              for f in files):
        raise AssertionError(f"stage 16 text mode: {written}")
    print(f"llama_text stage 16 text mode: 8 labels -> (WordPiece ids, [], [], []) files, {sorted(written.values())} "
          f"ids each (CLS ... SEP, no [UNK])")


def leftovers(dev, card: str) -> None:
    """extract_f0 and MCD / LSD on a 10 s 44.1 kHz signal, the card against the CPU."""
    import torch

    from latent_diffusion_speech_tpu_torch.ops.f0 import extract_f0
    from latent_diffusion_speech_tpu_torch.ops.metrics import log_spectral_distance, mcd
    from latent_diffusion_speech_tpu_torch.ops.stft import MelSpectrogram

    sr = 44100
    t = np.arange(int(F0_SIGNAL_S * sr)) / sr
    f0_true = np.where(t < 4.5, 120 + 40 * t, np.where(t < 5.5, 0.0, 220.0))
    audio = (0.5 * np.sin(2 * np.pi * np.cumsum(f0_true) / sr) * (f0_true > 0)).astype(np.float32)
    got = {}
    for where in (dev, "cpu"):
        x = torch.from_numpy(audio).to(where)
        extract_f0(x)  # warm-up
        if where == dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        f0, voiced = extract_f0(x)
        if where == dev:
            torch.cuda.synchronize()
        got[str(where)] = (f0.cpu().numpy(), voiced.cpu().numpy(), time.perf_counter() - t0)
    (f_c, v_c, t_c), (f_p, v_p, t_p) = got[str(dev)], got["cpu"]
    both = v_c & v_p
    f0_rel = float(np.max(np.abs(f_c[both] - f_p[both]) / f_p[both]))
    if (v_c != v_p).mean() > 0.01 or f0_rel > 1e-3 or both.mean() < 0.8:
        raise AssertionError(f"extract_f0 card vs CPU: voicing differs on {(v_c != v_p).sum()} frames, f0 {f0_rel}")
    mel = MelSpectrogram()
    # two takes of the signal over a noise floor 40 dB down: the second 5%
    # louder, with other noise
    noise = np.random.default_rng(0).standard_normal((2, len(audio))).astype(np.float32) * 0.005
    takes = (audio + noise[0], 1.05 * audio + noise[1])
    res = {}
    for where in (dev, "cpu"):
        a, b = (mel(torch.from_numpy(x).to(where)[None]).transpose(1, 2) for x in takes)
        if where == dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, l = mcd(a, b).item(), log_spectral_distance(a, b).item()
        res[str(where)] = (m, l, time.perf_counter() - t0)
    (m_c, l_c, tm), (m_p, l_p, _) = res[str(dev)], res["cpu"]
    if abs(m_c - m_p) > 1e-3 * abs(m_p) or abs(l_c - l_p) > 1e-3 * abs(l_p):
        raise AssertionError(f"mcd / LSD card vs CPU: {m_c} / {m_p}, {l_c} / {l_p}")
    print(f"llama_text leftovers on a {F0_SIGNAL_S:.0f} s signal [{card}]: extract_f0 {len(f_c)} frames, voicing "
          f"equal on {(v_c == v_p).mean():.2%} of frames, f0 max relative error {f0_rel:.2e} where both voiced; "
          f"{t_c * 1e3:.2f} ms on the card, {t_p * 1e3:.1f} ms on the CPU; MCD {m_c:.5f} dB (CPU {m_p:.5f}), "
          f"LSD {l_c:.5f} dB (CPU {l_p:.5f}), {tm * 1e3:.2f} ms for both on the card")


def llama_text(dev, card: str) -> dict:
    """The Llama LM trained (dense and MoE) and served, the text-mode front
    end and the leftovers; returns the phase's kernel launches."""
    import tempfile

    import torch

    from latent_diffusion_speech_tpu_torch.cli import verify_import
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    t_phase = time.perf_counter()
    k1.launches = k4.launches = k4.bwd_launches = 0
    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp")) as tmp:
        t0 = time.perf_counter()
        write_lm_corpus(os.path.join(tmp, "train"), LM_UTTS[0], 0)
        write_lm_corpus(os.path.join(tmp, "val"), LM_UTTS[1], 1)
        print(f"llama_text corpus: {LM_UTTS[0]} + {LM_UTTS[1]} EN utterances through stages 15 and 16 in "
              f"{time.perf_counter() - t0:.2f} s")
        dense = llama_train_run(tmp, False, dev, card)
        moe = llama_train_run(tmp, True, dev, card)
        print(f"llama_text dense vs MoE (E={LLAMA_MOE[0]}, top-{LLAMA_MOE[1]}, cf {LLAMA_MOE[2]}) [{card}]: median "
              f"step {dense['median'] * 1e3:.2f} / {moe['median'] * 1e3:.2f} ms, peak {dense['peak']:.2f} / "
              f"{moe['peak']:.2f} GiB")
        served = llama_serve(dense["cfg"], dense["params"], dev, card)

        # verify_import on the trained checkpoint in the reference's layout:
        # a CPU golden, then the card against it
        path = os.path.join(tmp, "llama_model.pt")
        torch.save({"model": reference_llama_state(dense["params"])}, path)
        reps = {}
        for device, extra in (("cpu", {"save_golden": path + ".golden.npz", "golden": None}),
                              (str(dev), {"save_golden": None, "golden": path + ".golden.npz"})):
            reps[device] = verify_import.verify(argparse.Namespace(path=path, kind="auto", heads=LLAMA_GEOM[1],
                                                                   tol=1e-3, json=True, device=device, **extra))
        rep = reps[str(dev)]
        if rep["kind"] != "llama" or not rep["golden_match"] or rep["torch_keys_unused"]:
            raise AssertionError(f"verify_import --kind llama: {rep}")
        print(f"llama_text verify_import llama [{card}]: geometry {rep['geometry']}, {rep['torch_keys_read']} keys "
              f"read, none unused; card vs CPU golden relative error {rep['golden_rel_diff']:.2e}")
        bert_phase(tmp, dev, card)
    leftovers(dev, card)
    launches = {"ar_decode": k1.launches, "attention_fwd": k4.launches}
    want = served["k4"] + dense["val_k4"]
    if k1.launches or k4.bwd_launches or k4.launches != want:
        raise AssertionError(f"llama_text launches {launches}, K4 backward {k4.bwd_launches} (want no K1 launch: "
                             f"the Llama decode is plain PyTorch; {want} K4 launches)")
    print(f"llama_text launches: {launches} (no K1: the Llama's decode is plain PyTorch, as in the JAX package; "
          f"K4 in the flagship UNet behind validate_audio and the serve's two tts); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# The block zoo trained through the K4 backward at head dim 8, and data
# parallelism on torch.distributed
# ---------------------------------------------------------------------------

ZOO_TRAIN = "zoo_attn"  # the block zoo configuration zoo_train trains
ZOO_TRAIN_STEPS = 3
DP_STEPS = (2, 2)  # steps before the save and after the resume, each trainer
DP_AB_STEPS = 3  # train_step calls a turn in the with / without group A/B
DP_PROFILED = 3  # steps under torch.profiler (CPU and CUDA activities) with the group
DP_LM_UTTS = 64  # the LM corpus: two batches of 32
DP_BACKEND = "nccl"  # the process group the card's ranks join


def zoo_train(dev, card: str) -> dict:
    """A few f32 steps of the ZOO_TRAIN configuration at the shipped widths
    through `DiffusionTrainer` with attn_impl="fused", so every attention
    module runs the K4 forward and backward at head dim 8 (B=48, 1 s crops:
    T = 86 frames, H = 32-64), against the same steps from the same seeded
    weights with attn_impl="xla" (the plain attention): the first loss
    within 1e-5 relative (compare_train_step's bar), each later one within
    1e-4 (f32 sums in another order, carried through the AdamW updates).
    Returns the K4 launches."""
    import torch

    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer, step_generator

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    down, up, mid = ZOO[ZOO_TRAIN]
    rng = np.random.default_rng(5)
    frames = int(cfg.data.duration * cfg.data.sampling_rate / cfg.data.block_size)
    batches = [{"units": rng.standard_normal((TRAIN_B, frames, 1280)).astype(np.float32),
                "mel": rng.standard_normal((TRAIN_B, frames, 128)).astype(np.float32),
                "spk_id": rng.integers(1, 5, (TRAIN_B, 1)).astype(np.int32),
                "aug_shift": np.zeros((TRAIN_B, 1), np.float32)} for _ in range(ZOO_TRAIN_STEPS)]
    losses, launches, walls = {}, {}, {}
    for impl in ("fused", "xla"):
        model_cfg = Unit2MelConfig(attn_impl=impl, denoiser="general", down_block_types=down, up_block_types=up,
                                   mid_block_type=mid)
        trainer = DiffusionTrainer(cfg, model_cfg=model_cfg, device=dev)
        n_attn = zoo_attention_modules(trainer.system.module)
        k4.launches = k4.bwd_launches = 0
        losses[impl], walls[impl] = [], []
        for step, b in enumerate(batches):
            batch = trainer.device_put_batch(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[impl].append(trainer.train_step(batch, step_generator(0, step, dev))["loss"].item())
            walls[impl].append(time.perf_counter() - t0)
        launches[impl] = {"attention_fwd": k4.launches, "attention_bwd": k4.bwd_launches}
        del trainer
        torch.cuda.empty_cache()
    want = {"attention_fwd": n_attn * ZOO_TRAIN_STEPS, "attention_bwd": n_attn * ZOO_TRAIN_STEPS}
    if launches != {"fused": want, "xla": {"attention_fwd": 0, "attention_bwd": 0}}:
        raise AssertionError(f"zoo_train launches {launches}, want {want} with attn_impl='fused' ({n_attn} "
                             f"attention modules x {ZOO_TRAIN_STEPS} steps) and none with 'xla'")
    fused, plain = losses["fused"], losses["xla"]
    errs = [abs(a - b) / abs(b) for a, b in zip(fused, plain)]
    if not all(np.isfinite(fused)) or errs[0] > 1e-5 or max(errs) > 1e-4:
        raise AssertionError(f"zoo_train losses with K4 {fused} against the plain attention {plain}: relative "
                             f"errors {errs} (bars 1e-5 first, 1e-4 after)")
    print(f"zoo_train {ZOO_TRAIN} [{card}]: f32, B={TRAIN_B}, T={frames}, {n_attn} attention modules at head dim 8; "
          f"losses with K4 (attn_impl='fused') {[round(x, 6) for x in fused]} against the plain attention "
          f"{[round(x, 6) for x in plain]} (relative errors {[f'{e:.1e}' for e in errs]}); launches {launches}; "
          f"steps after the first {[round(w * 1e3, 1) for w in walls['fused'][1:]]} ms with K4, "
          f"{[round(w * 1e3, 1) for w in walls['xla'][1:]]} ms plain; phase {time.perf_counter() - t_phase:.1f} s")
    return launches["fused"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


DETERMINISTIC_MAIN = """import runpy, sys
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
module = sys.argv.pop(1)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def torchrun_start(jobs: dict) -> dict:
    """One process a job under `torch.distributed.run` (a world of 1 on this
    card, a real NCCL group), all at once: {name: (module, config path,
    steps)}; each runs with cuDNN's deterministic algorithms (a script beside
    its config sets them, then runs the module as __main__).  Returns the
    processes for `torchrun_wait`."""
    procs = {}
    try:
        for name, (module, cfg_path, steps) in jobs.items():
            main = os.path.join(os.path.dirname(cfg_path), "deterministic_main.py")
            with open(main, "w") as fh:
                fh.write(DETERMINISTIC_MAIN)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", "--nproc_per_node=1",
                   "--master_addr=localhost", f"--master_port={free_port()}", main, module, "-c", cfg_path,
                   "--max-steps", str(steps)]
            procs[name] = (cmd, start_process(cmd, env=dict(os.environ, PYTHONPATH=ROOT)))
    except BaseException:
        torchrun_wait(procs, kill=True)
        raise
    return procs


def torchrun_wait(procs: dict, kill: bool = False) -> dict:
    """Each `torchrun_start` job's output once it exits 0 (all killed when
    one fails, or at once with `kill`)."""
    outs = {}
    try:
        for name, (cmd, proc) in procs.items():
            if kill:
                break
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0 or f"rank 0 of 1: {DP_BACKEND} process group" not in out:
                raise AssertionError(f"{' '.join(cmd)}: exit {proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
            outs[name] = out
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def dp_ab(trainer, step, card: str, what: str) -> dict:
    """`step()` (one train_step on a batch already on the card) timed with the
    trainer's mesh without a group and with the world-of-one NCCL group, in
    turns (without, with, with, without; DP_AB_STEPS calls each, the median
    of each turn's calls), then the NCCL kernels a step under torch.profiler
    over DP_PROFILED steps with the group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, build_mesh

    meshes = {"without": Mesh(build_mesh().spec), "with": build_mesh()}
    if meshes["with"].group is None:
        raise AssertionError("dp_ab: no process group")
    step()  # warm-up
    turns = {"without": [], "with": []}
    for name in ("without", "with", "with", "without"):
        trainer.mesh = meshes[name]
        times = []
        for _ in range(DP_AB_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        turns[name].append(float(np.median(times)) * 1e3)
    trainer.mesh = meshes["with"]
    # the reduce alone: every gradient and a loss through the group
    tensors = [p.grad for p in trainer._params] + [torch.zeros((), device=trainer.device)]
    host, synced = [], []
    for _ in range(DP_AB_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.mesh.all_reduce_mean_(tensors)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        synced.append(time.perf_counter() - t0)
    reduce_ms = (float(np.median(host)) * 1e3, float(np.median(synced)) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(DP_PROFILED):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the collectives as the process groups record them ("nccl:all_reduce" on
    # the card's group, "gloo:..." on the host group), and NCCL's kernels
    calls = {e.key: e.count / DP_PROFILED for e in events if re.match(r"(nccl|gloo):", e.key)}
    device = {e.key: e.count / DP_PROFILED for e in events if "nccl" in e.key.lower()
              and not e.key.startswith("nccl:") and e.device_type == torch.autograd.DeviceType.CUDA}
    print(f"dp_train {what} [{card}]: train_step on a batch on the card, median of {DP_AB_STEPS} calls a turn: "
          f"without a group {[round(x, 2) for x in turns['without']]} ms, with the world-of-one {DP_BACKEND} group "
          f"{[round(x, 2) for x in turns['with']]} ms (in turns); the gradient all-reduce alone ({len(tensors)} "
          f"tensors, {sum(t.numel() for t in tensors) * 4 / 2**20:.1f} MiB) {reduce_ms[0]:.2f} ms of host, "
          f"{reduce_ms[1]:.2f} ms to the card's end; collectives a step {calls}, NCCL device kernels a step "
          f"{device} (torch.profiler, {DP_PROFILED} steps)")
    return dict(turns=turns, nccl_calls=calls, nccl_kernels=device, reduce_ms=reduce_ms)


class DpStart:
    """dp_train's data layout and configs (`tmp`, `cfg`, `cfg_lm`, `paths`)
    and its two CLI processes under `torch.distributed.run` (`procs`,
    DP_STEPS[0] steps each), started ahead of the phase so that their
    start-up runs beside the phases before it; `dp_train` takes them."""

    def __init__(self):
        import tempfile

        from latent_diffusion_speech_tpu_torch.config import load_config, save_config

        os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
        self.dir = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp"))
        tmp = self.tmp = self.dir.name
        cb = np.random.default_rng(1).standard_normal((4096, 1280)).astype(np.float32)
        write_train_layout(os.path.join(tmp, "train"), cb, speakers=1)
        np.savez(os.path.join(tmp, "codebook.npz"), cluster_centers_=cb)
        write_lm_corpus(os.path.join(tmp, "lm_train"), DP_LM_UTTS, 0)
        write_lm_corpus(os.path.join(tmp, "lm_val"), 8, 1)
        cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
        cfg.data.train_path, cfg.data.valid_path = os.path.join(tmp, "train"), os.path.join(tmp, "lm_val")
        cfg.text2semantic.model.codebook_path = os.path.join(tmp, "codebook.npz")
        d, lm = cfg.diffusion.train, cfg.text2semantic.train
        d.expdir, d.interval_log, d.interval_val, d.save_opt = os.path.join(tmp, "exp_diff"), 1, 10 ** 9, True
        lm.expdir, lm.interval_log, lm.interval_val = os.path.join(tmp, "exp_lm"), 1, 10 ** 9
        d.loader_processes = lm.loader_processes = 0  # threaded loaders: no spawn workers to start
        if (d.batch_size, cfg.data.duration, lm.batch_size) != (TRAIN_B, 1.0, LM_B):
            raise AssertionError("configs/config.yaml no longer trains at B=48 on 1 s crops and the LM at B=32")
        cfg_lm = copy.deepcopy(cfg)
        cfg_lm.data.train_path = os.path.join(tmp, "lm_train")
        cfg_lm.text2semantic.model.codebook_path = os.path.join(tmp, "no-codebook.npz")
        cfg_lm.diffusion.train.expdir = os.path.join(tmp, "no-diffusion")
        # no validation pipeline (lm_train runs it): a weight_quant value the
        # diffusion model refuses (ValueError) makes stage 21's build skip it
        # at once instead of seeding one
        cfg_lm.common.infer.weight_quant = "none"
        paths = {"diffusion": os.path.join(tmp, "diffusion.yaml"), "lm": os.path.join(tmp, "lm.yaml")}
        save_config(cfg, paths["diffusion"])
        save_config(cfg_lm, paths["lm"])

        self.cfg, self.cfg_lm, self.paths = cfg, cfg_lm, paths
        self.t0 = time.perf_counter()
        self.procs = torchrun_start({w: (f"latent_diffusion_speech_tpu_torch.cli.train_{w}", paths[w], DP_STEPS[0])
                                     for w in ("diffusion", "lm")})

    def close(self) -> None:
        torchrun_wait(self.procs, kill=True)
        self.dir.cleanup()


def dp_train(dev, card: str, started: DpStart) -> dict:
    """Data parallelism at a world of 1 (the card host has one card): the
    diffusion trainer (flagship width, B=48, 1 s crops, the k-means snap)
    and the shipped RoFormer (B=32), each through its training CLI under
    `torch.distributed.run --nproc_per_node=1` (the CLI joins a real NCCL
    group), DP_STEPS[0] steps and a save, while this process runs all the
    steps through `build` with no group at all.  Then this process joins a
    world-of-one NCCL group: each CLI's main resumes and trains DP_STEPS[1]
    more, its checkpoint bitwise equal to the run without a group; each
    trainer's train_step with and without the group (`dp_ab`) and the NCCL
    kernels a step.  Returns the kernels' launches of the in-process runs."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli import train_diffusion, train_lm
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
    from latent_diffusion_speech_tpu_torch.parallel.dist import initialize_distributed, shutdown_distributed
    from latent_diffusion_speech_tpu_torch.train.checkpoint import load_checkpoint
    from latent_diffusion_speech_tpu_torch.train.optim import step_generator

    t_phase = time.perf_counter()
    n = sum(DP_STEPS)
    k4.launches = k4.bwd_launches = k6.launches = 0
    results = {}
    cfg, cfg_lm, paths, procs, t0 = started.cfg, started.cfg_lm, started.paths, started.procs, started.t0
    lm = cfg.text2semantic.train
    modules = {"diffusion": train_diffusion, "lm": train_lm}
    try:
        # the same steps in this process with no group, the reference
        # (cuDNN's deterministic algorithms, as the CLIs)
        ref_dirs = {}
        t_ref = time.perf_counter()
        for what, c in (("diffusion", cfg), ("lm", cfg_lm)):
            c = copy.deepcopy(c)
            tc = c.diffusion.train if what == "diffusion" else c.text2semantic.train
            tc.expdir = ref_dirs[what] = tc.expdir + "_ref"
            with deterministic_cudnn():
                if what == "diffusion":
                    trainer, loader = train_diffusion.build(c, device=dev)
                    trainer.train(loader, max_steps=n)
                else:
                    trainer, loader, val_loader, logger, _ = train_lm.build(c, device=dev)
                    try:
                        trainer.train(loader, max_steps=n)
                    finally:
                        val_loader.close()
                        logger.close()
            results[what] = dict(trainer=trainer, loader=loader)
        ref_s = time.perf_counter() - t_ref
        legs = [torchrun_wait(procs)]
        cli_s = time.perf_counter() - t0

        # this process joins a world-of-one NCCL group: each CLI's main
        # resumes there and takes the other DP_STEPS[1] steps; then train_step
        # with and without the group
        t0 = time.perf_counter()
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                          MASTER_PORT=str(free_port()))
        try:
            if not initialize_distributed(dev) or torch.distributed.get_backend() != DP_BACKEND:
                raise AssertionError(f"dp_train: no {DP_BACKEND} process group")
            legs.append({})
            for what, module in modules.items():
                buf = io.StringIO()
                with deterministic_cudnn(), contextlib.redirect_stdout(buf):
                    module.main(["-c", paths[what], "--max-steps", str(n)])
                legs[1][what] = buf.getvalue()
                if f"resumed at step {DP_STEPS[0]}" not in legs[1][what]:
                    raise AssertionError(f"dp_train {what}: main did not resume\n{legs[1][what][-2000:]}")
            resume_s = time.perf_counter() - t0
            differs = {}
            for what in modules:
                expdir = cfg.diffusion.train.expdir if what == "diffusion" else lm.expdir
                (step_a, params_a, opt_a), (step_b, params_b, opt_b) = (load_checkpoint(e) for e in (ref_dirs[what],
                                                                                                    expdir))
                differ = [k for k in params_a if not torch.equal(params_a[k].cpu(), params_b[k].cpu())]
                if (step_a, step_b) != (n, n) or params_a.keys() != params_b.keys() or differ or not same_state(
                        opt_a, opt_b):
                    worst = max((((params_a[k].cpu() - params_b[k].cpu()).abs().max()
                                  / params_a[k].cpu().abs().max().clamp_min(1e-30)).item() for k in differ),
                                default=None)
                    differs[what] = (f"steps {step_a} / {step_b}, {len(differ)} of {len(params_a)} parameters "
                                     f"differ (largest relative {worst}), optimizer state equal: "
                                     f"{same_state(opt_a, opt_b)}")
            if differs:
                raise AssertionError(f"dp_train: the resumed world-of-one runs differ from the uninterrupted runs "
                                     f"without a group: {differs}")
            steps_s = [1 / json.loads(x)["train/steps_per_sec"] for out in legs for x in out["diffusion"].splitlines()
                       if x.startswith("{") and "train/steps_per_sec" in x]
            results["diffusion"].update(cli_steps_ms=[round(x * 1e3, 2) for x in steps_s])
            rows = [json.loads(x) for x in open(os.path.join(lm.expdir, "logs", "metrics.jsonl"))]
            results["lm"].update(cli_steps_ms=[round(1e3 / r["train/steps_per_sec"], 2) for r in rows
                                               if "train/steps_per_sec" in r])

            t0 = time.perf_counter()
            trainer, loader = results["diffusion"].pop("trainer"), results["diffusion"].pop("loader")
            loader.set_epoch(0)
            batch = trainer.device_put_batch(next(iter(loader)))
            results["diffusion"].update(dp_ab(trainer, lambda: trainer.train_step(batch, step_generator(0, 0, dev)),
                                              card, "diffusion (flagship, B=48)"))
            trainer, loader = results["lm"].pop("trainer"), results["lm"].pop("loader")
            loader.set_epoch(0)
            lm_batch = trainer.device_put_batch(next(iter(loader)))
            results["lm"].update(dp_ab(trainer, lambda: trainer.train_step(lm_batch), card, "RoFormer LM (B=32)"))
        finally:
            shutdown_distributed()
            for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
                os.environ.pop(k, None)
            if "loader" in results["lm"]:
                results["lm"]["loader"].close()
        del trainer, loader
        ab_s = time.perf_counter() - t0
    finally:
        started.close()
    torch.cuda.empty_cache()
    for what in ("diffusion", "lm"):
        r = results[what]
        print(f"dp_train {what} CLI under torch.distributed.run [{card}]: {DP_STEPS[0]} steps, save; its main "
              f"in this process under the world-of-one group resumed and took {DP_STEPS[1]} more; step walls "
              f"{r['cli_steps_ms']} ms; its checkpoint equals the uninterrupted run without a group, bit for bit; "
              f"median train_step without / with the group {float(np.median(r['turns']['without'])):.2f} / "
              f"{float(np.median(r['turns']['with'])):.2f} ms; the all-reduce alone {r['reduce_ms'][1]:.2f} ms")
    launches = {"attention_fwd": k4.launches, "attention_bwd": k4.bwd_launches, "kmeans_argmin": k6.launches}
    print(f"dp_train phase: {time.perf_counter() - t_phase:.1f} s (the two CLI processes, started before migrate, "
          f"done {cli_s:.1f} s after their start; the references without a group {ref_s:.1f} s; the resumes in this "
          f"process {resume_s:.1f} s; the A/B {ab_s:.1f} s); in-process "
          f"launches {launches} [{card}]")
    return launches


# int8_serve: the flagship eager bf16 pipeline without and with int8 UNet
# weights; tp_ep: tensor and expert parallelism with sharded checkpoints
INT8_CORR = 0.99  # the JAX package's bar for int8 latents against bf16 (tests/test_weight_quant.py)
TP_DIFF_B, TP_DIFF_F = 2, 86  # the flagship diffusion step over two CPU ranks: B=2 crops of 1 s (86 frames)
TP_LLAMA_B, TP_LLAMA_T = 4, 64  # the Llama with 8 experts over two CPU ranks


def int8_serve(dev, card: str) -> dict:
    """int8 serving weights on the card, at flagship width with seeded
    weights: `cli/infer_tts.py::build_pipeline(configs/config.yaml)` (bf16)
    without and with `common.infer.weight_quant: int8`.  For each: one
    unmeasured `tts`, then the `tts` walls (430 tokens) and a `tts_batch` of
    4, one denoiser forward at the tts's shape (B=1, T=432; for int8 the
    dequantization to bf16 included), and the UNet's weight bytes (int8
    values and bf16 scales against bf16).  The latents of one 20-step
    DPM-Solver++ call from one x_init correlate above 0.99 between the two;
    `Unit2MelSystem` raises JAX's ValueErrors (another value, int8 with
    unet_impl="pallas"); the `infer_tts` CLI with `--weight-quant int8`
    writes its WAV as a process.  Returns the int8 pipeline's launches
    (counted from zero just before its `tts` and `tts_batch`)."""
    import torch

    from latent_diffusion_speech_tpu_torch.cli import infer_tts
    from latent_diffusion_speech_tpu_torch.config import load_config
    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
    from latent_diffusion_speech_tpu_torch.ops.audio_io import read_wav
    from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4
    from latent_diffusion_speech_tpu_torch.ops.weight_quant import tree_bytes

    t_phase = time.perf_counter()
    errors = []
    for kw in (dict(weight_quant="fp4"), dict(weight_quant="int8", unet_impl="pallas")):
        try:
            Unit2MelSystem(Unit2MelConfig(), device=dev, **kw)
        except ValueError as e:
            errors.append(str(e))
        else:
            raise AssertionError(f"Unit2MelSystem({kw}) did not raise")
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    res, latents, launches = {}, {}, {}
    for quant in ("bf16", "int8"):
        cfg.common.infer.weight_quant = "int8" if quant == "int8" else ""
        pipe = infer_tts.build_pipeline(cfg)
        diffusion = pipe.diffusion
        if diffusion.weight_quant != ("int8" if quant == "int8" else None):
            raise AssertionError(f"build_pipeline: weight_quant {diffusion.weight_quant}")
        pipe.tts(TEXT, language="EN", max_length=N_TOKENS)  # warm-up
        torch.cuda.synchronize()
        calls, real_infer = [], diffusion.infer
        diffusion.infer = lambda *a, **kw: (calls.append(1), real_infer(*a, **kw))[1]
        k1.launches = k4.launches = k4.bwd_launches = 0
        t0 = time.perf_counter()
        wav, sr = pipe.tts(TEXT, language="EN", max_length=N_TOKENS)
        torch.cuda.synchronize()
        t_tts = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = pipe.tts_batch(BATCH_TEXTS, language="EN", spk_ids=[1, 2, 3, 4], max_length=N_TOKENS)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        launches[quant] = {"ar_decode": k1.launches, "attention_fwd": k4.launches}
        diffusion.infer, n_inf = real_infer, len(calls)
        # 20 denoiser evaluations a diffusion call, 32 K4 launches each; one K1 launch a generate
        if k4.launches != 640 * n_inf or k1.launches != 2 or k4.bwd_launches:
            raise AssertionError(f"{quant} serve launches {launches[quant]} over {n_inf} diffusion calls")
        for w, s in [(wav, sr)] + list(outs):
            if s != 44100 or w.ndim != 1 or not len(w) or not np.isfinite(w).all():
                raise AssertionError(f"{quant} serve: {s} Hz, shape {w.shape}")
        with torch.no_grad():
            prepared = diffusion._prepare_sample_params()
            mc = diffusion.cfg
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn((1, 432, mc.out_dims + mc.n_hidden), generator=g, device=dev, dtype=torch.bfloat16)
            t = torch.full((1,), 500, device=dev, dtype=torch.long)
            fwd_ms = cuda_time_ms(lambda: diffusion._denoise(prepared, x, t), iters=20, warmup=3)
            unet = dict(diffusion.module.unet.named_parameters())
            nbytes = tree_bytes(prepared.qparams) if quant == "int8" else tree_bytes(unet)
            table = pipe.codebook.codebook  # the k-means centroids (EuclideanCodebook)
            rows = torch.as_tensor(np.random.default_rng(3).integers(0, table.shape[0], 432), device=table.device)
            units = table[rows][None].to(dev, torch.bfloat16)
            x0 = torch.randn((1, 432, mc.out_dims), generator=torch.Generator(device=dev).manual_seed(4), device=dev)
            latents[quant] = diffusion.infer(units, torch.Generator(device=dev).manual_seed(5),
                                             spk_id=torch.ones((1, 432), dtype=torch.long, device=dev),
                                             method="dpm-solver", infer_speedup=50, x_init=x0).float().cpu()
        res[quant] = dict(t_tts=t_tts, t_batch=t_batch, fwd_ms=fwd_ms, bytes=nbytes, audio_s=len(wav) / sr)
        del pipe, diffusion, prepared
        torch.cuda.empty_cache()
    cfg.common.infer.weight_quant = ""
    corr = float(np.corrcoef(latents["bf16"].flatten().numpy(), latents["int8"].flatten().numpy())[0, 1])
    if not np.isfinite(latents["int8"].numpy()).all() or corr <= INT8_CORR:
        raise AssertionError(f"int8 latents against bf16: correlation {corr} (bar {INT8_CORR})")
    os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
    out = os.path.join(ROOT, "exp", "int8_serve_cli.wav")
    built = []  # the CLI's pipeline, in this process (the kernel library is loaded)
    real_build = infer_tts.build_pipeline
    t0 = time.perf_counter()
    with mock.patch.object(infer_tts, "build_pipeline", lambda *a, **kw: built.append(real_build(*a, **kw)) or built[-1]):
        infer_tts.main(["-c", os.path.join(ROOT, "configs", "config.yaml"), "-l", "EN", "-i", CLI_TEXT, "-o", out,
                        "--weight-quant", "int8"])
    cli_s = time.perf_counter() - t0
    if [p.diffusion.weight_quant for p in built] != ["int8"]:
        raise AssertionError(f"the CLI's --weight-quant int8 built {[p.diffusion.weight_quant for p in built]}")
    del built
    cli_wav, cli_sr = read_wav(out)
    os.remove(out)
    if cli_sr != 44100 or not len(cli_wav) or not np.isfinite(cli_wav).all():
        raise AssertionError(f"{out}: {cli_sr} Hz, shape {cli_wav.shape}")
    for quant in ("bf16", "int8"):
        r = res[quant]
        print(f"int8_serve {quant} [{card}]: tts {r['t_tts']:.3f} s ({r['audio_s']:.3f} s of audio, {N_TOKENS} "
              f"tokens max); tts_batch x4 {r['t_batch']:.3f} s; one denoiser forward B=1 T=432 {r['fwd_ms']:.3f} ms"
              f"{' (dequantization included)' if quant == 'int8' else ''}; UNet weights {r['bytes'] / 1e6:.3f} MB")
    print(f"int8_serve [{card}]: int8 / bf16 tts {res['int8']['t_tts'] / res['bf16']['t_tts']:.3f}x, denoiser "
          f"forward {res['int8']['fwd_ms'] / res['bf16']['fwd_ms']:.3f}x, UNet bytes "
          f"{res['int8']['bytes'] / res['bf16']['bytes']:.3f}x; latents' correlation {corr:.6f} (bar {INT8_CORR}); "
          f"launches {launches}; the CLI's main with --weight-quant int8 in {cli_s:.1f} s, "
          f"{len(cli_wav) / cli_sr:.3f} s of audio; ValueErrors: {errors}")
    print(f"int8_serve phase: {time.perf_counter() - t_phase:.1f} s")
    return launches["int8"]


def tp_config(case: str, tmp: str, layout: bool):
    """The shipped config for tp_ep's `case`: 'diffusion' (the flagship
    Unit2Mel, model=2 when `layout`) or 'llama' (the Llama with 8 experts at
    LLAMA_GEOM, expert=2 when `layout`).  The second step's loss and
    gradients need only the weights, so `save_opt` stays as shipped (off
    for the diffusion, on for the LM)."""
    from latent_diffusion_speech_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    if case == "diffusion":
        cfg.diffusion.train.expdir = os.path.join(tmp, "diffusion")
    else:
        m = cfg.text2semantic.model
        m.type = "llama"
        d = m.decoder
        d.hidden_size, d.num_attention_heads, d.num_hidden_layers, d.intermediate_size = LLAMA_GEOM
        m.moe_experts, m.moe_top_k, m.moe_capacity_factor = LLAMA_MOE
        cfg.text2semantic.train.expdir = os.path.join(tmp, "llama")
    if layout:
        cfg.parallel.data = 1
        setattr(cfg.parallel, "model" if case == "diffusion" else "expert", 2)
    return cfg


def tp_trainer(case: str, tmp: str, device, layout: bool):
    from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    cfg = tp_config(case, tmp, layout)
    return DiffusionTrainer(cfg, device=device) if case == "diffusion" else LMTrainer(cfg, device=device)


def tp_batches(case: str, vocab: int = 0) -> list:
    """tp_ep's two global batches (numpy, seeded)."""
    g = np.random.default_rng(7)
    if case == "diffusion":
        B, F = TP_DIFF_B, TP_DIFF_F
        return [{"units": g.standard_normal((B, F, 1280)).astype(np.float32),
                 "mel": (0.5 * g.standard_normal((B, F, 128))).astype(np.float32),
                 "spk_id": g.integers(1, 5, (B, 1)).astype(np.int32), "aug_shift": np.zeros((B, 1), np.float32)}
                for _ in range(2)]
    ids = [g.integers(0, vocab, (TP_LLAMA_B, TP_LLAMA_T)).astype(np.int64) for _ in range(2)]
    return [{"input_ids": i, "labels": i.copy(), "attention_mask": np.ones_like(i)} for i in ids]


def tp_step(trainer, case: str, batch, step: int) -> tuple:
    """One train_step (the diffusion draws from a CPU generator, which
    draws on the host: the card's step draws the CPU's numbers); returns
    (loss, the gradients AdamW saw, the MoE's expert choices)."""
    from latent_diffusion_speech_tpu_torch.ops import moe
    from latent_diffusion_speech_tpu_torch.train.optim import step_generator

    seen, choices = {}, []
    real_step, real_top_k = trainer.optimizer.step, moe.top_k_lowest_index

    def opt_step(*a, **k):
        seen.update({n: p.grad.detach().cpu().clone() for n, p in trainer.system.module.named_parameters()})
        return real_step(*a, **k)

    def top_k(probs, k):
        vals, idx = real_top_k(probs, k)
        choices.append(idx.cpu())
        return vals, idx

    trainer.optimizer.step = opt_step
    try:
        with mock.patch.object(moe, "top_k_lowest_index", top_k):
            b = trainer.device_put_batch(batch)
            if case == "diffusion":
                out = trainer.train_step(b, step_generator(0, step, "cpu"))
            else:
                out = trainer.train_step(b)
    finally:
        trainer.optimizer.step = real_step
    return float(out["loss"]), seen, choices


def tp_rank(process: int, tmp: str, ports: dict) -> None:
    """One CPU process of tp_ep: processes 0-1 are the two gloo ranks of the
    'diffusion' case, 2-3 those of 'llama' (each case its own group, on
    `ports[case]`).  The rank takes `case` at full width: one step, a
    sharded save, a second step; writes its chunks at the save, the second
    step's loss, gradient chunks and expert choices, its coordinates and the
    shardings to `<tmp>/<case>_rank<index>.pt`."""
    case, index, n = ("diffusion", "llama")[process // 2], process % 2, 2
    os.nice(10)  # below the kernels' build, which runs beside the ranks
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(ports[case]), CUDA_VISIBLE_DEVICES="")
    sys.path.insert(0, ROOT)
    import torch

    from latent_diffusion_speech_tpu_torch.parallel.dist import initialize_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    initialize_distributed("cpu")
    trainer = tp_trainer(case, tmp, "cpu", layout=True)
    batches = tp_batches(case, getattr(getattr(trainer, "lm_cfg", None), "vocab_size", 0))
    t0 = time.perf_counter()
    first = tp_step(trainer, case, batches[0], 0)[0]
    step_s = time.perf_counter() - t0
    trainer.save()
    saved = {k: p.detach().clone() for k, p in trainer.system.module.named_parameters()}
    loss, grads, choices = tp_step(trainer, case, batches[1], 1)
    torch.save(dict(saved=saved, loss=loss, first=first, grads=grads, choices=choices, step_s=step_s,
                    shardings=trainer.shardings, coords=trainer.mesh.coords, spec=dataclasses.asdict(trainer.mesh.spec)),
               os.path.join(tmp, f"{case}_rank{index}.pt"))
    torch.distributed.destroy_process_group()


def tp_whole(ranks: list, key: str) -> dict:
    """A tree put together from the ranks' chunks (each split leaf's chunk at
    its rank's coordinate)."""
    import torch

    from latent_diffusion_speech_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from latent_diffusion_speech_tpu_torch.parallel.sharding import global_shape, local_chunk

    out = {}
    for name, t0 in ranks[0][key].items():
        spec = ranks[0]["shardings"].get(name, (None,) * t0.dim())
        meshes = [Mesh(MeshSpec(**r["spec"]), coords=r["coords"]) for r in ranks]
        whole = torch.empty(global_shape(t0.shape, spec, meshes[0]), dtype=t0.dtype)
        for r, mesh in zip(ranks, meshes):
            local_chunk(whole, spec, mesh).copy_(r[key][name])
        out[name] = whole
    return out


class TpRanks:
    """tp_ep's CPU part, started in the background before the kernels are
    built (it needs none of them, and the build leaves cores idle): the
    dry run as `python -m latent_diffusion_speech_tpu_torch.parallel.dryrun
    8` (JAX's nine layouts) and tp_ep's four gloo rank processes
    (`tp_rank`), each case's
    ranks writing to `tmp`.  `wait` joins both and checks the dry run."""

    def __init__(self):
        import tempfile

        import torch.multiprocessing as mp

        os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
        self.dir = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp"))
        self.tmp = self.dir.name
        self.t0 = time.perf_counter()
        self.dry_cmd = [sys.executable, "-m", "latent_diffusion_speech_tpu_torch.parallel.dryrun", "8"]
        self.dry = start_process(self.dry_cmd, preexec_fn=lambda: os.nice(10))
        ports = {"diffusion": free_port()}
        while (port := free_port()) == ports["diffusion"]:
            pass
        ports["llama"] = port
        try:
            self.ranks = mp.start_processes(tp_rank, args=(self.tmp, ports), nprocs=4, start_method="spawn",
                                            join=False)
        except BaseException:
            self.close()
            raise
        self.done = None

    def wait(self) -> None:
        from latent_diffusion_speech_tpu_torch.parallel.dryrun import LAYOUTS

        try:
            while not self.ranks.join():
                pass
            self.ranks_s = time.perf_counter() - self.t0
            out, err = self.dry.communicate(timeout=600)
            self.dry_s = time.perf_counter() - self.t0
        except BaseException:
            self.close()
            raise
        done = [line for line in out.splitlines() if line.startswith("dryrun_multichip(8): ")]
        ran = {line.split()[1].split("/")[0] if "/" in line.split()[1] else "data-parallel" for line in done}
        if self.dry.returncode != 0 or ran != set(LAYOUTS) or not all(line.split()[2] == "ok," for line in done):
            self.close()
            raise AssertionError(f"{' '.join(self.dry_cmd)}: exit {self.dry.returncode}, cases {done}, want every "
                                 f"layout of {LAYOUTS}\n{out[-2000:]}\n{err[-3000:]}")
        self.done = done

    def close(self) -> None:
        """Stops what still runs and removes the ranks' files."""
        if self.dry.poll() is None:
            self.dry.kill()
            self.dry.communicate()
        ranks = getattr(self, "ranks", None)
        for proc in ranks.processes if ranks is not None else ():
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.dir.cleanup()


def tp_ep(dev, card: str, cpu: TpRanks) -> dict:
    """Tensor and expert parallelism (`cpu`: the CPU part, `TpRanks`, done):
    (a) `parallel/dryrun.py`'s main with 8 CPU gloo ranks, JAX's nine
    layouts (data, dp-tp, seq-parallel, pipeline, roformer-pipeline,
    expert-parallel, tp-ep, dp-tp-pp, pp-ep); (b) at full width, two CPU
    gloo ranks with model=2 take one
    step of the flagship diffusion trainer (the shipped config, B=2 crops of
    1 s, clipping at 1.0 over the global gradients) and save a sharded
    checkpoint, then a second step; a world of one on the card resumes the
    checkpoint: its parameters equal the ranks' chunks put together, bit for
    bit, and its second step holds `train_slice`'s tolerance against the
    ranks' (the loss within 1e-5 relative, every gradient tensor within 1e-3
    of its norm and all within 1e-4 of the global norm; the same draws, from
    a CPU generator); (c) the same for the Llama with 8 experts at JAX's
    geometry (LLAMA_GEOM) under expert=2 (the gradients held where no
    expert choice differs, as `compare_llama_step`).  Prints the checkpoint's
    bytes a rank against the single file a world of one writes.  Returns the
    card's launches."""
    import shutil

    import torch

    from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

    t_phase = time.perf_counter()
    launches = {"attention_fwd": 0, "attention_bwd": 0}
    tmp, ranks_s, dry_s = cpu.tmp, cpu.ranks_s, cpu.dry_s
    print("\n".join(cpu.done))
    for case in ("diffusion", "llama"):
        ranks = [torch.load(os.path.join(tmp, f"{case}_rank{r}.pt"), weights_only=False) for r in range(2)]
        if ranks[0]["loss"] != ranks[1]["loss"] or ranks[0]["first"] != ranks[1]["first"]:
            raise AssertionError(f"tp_ep {case}: the ranks' losses differ")
        saved, grads_p = tp_whole(ranks, "saved"), tp_whole(ranks, "grads")
        split = [k for k, s in ranks[0]["shardings"].items() if any(s)]
        ckpt = os.path.join(tmp, case, "model_1.sharded")
        shard_mb = [os.path.getsize(os.path.join(ckpt, f"shard_p{r}.pt")) / 1e6 for r in range(2)]

        trainer = tp_trainer(case, tmp, dev, layout=False)
        if not trainer.resume() or trainer.step != 1 or trainer.shardings:
            raise AssertionError(f"tp_ep {case}: the world of one did not resume the sharded checkpoint")
        for k, p in trainer.system.module.named_parameters():
            if not torch.equal(p.detach().cpu(), saved[k]):
                raise AssertionError(f"tp_ep {case}: resumed {k} differs from the ranks' chunks")
        # the single file a world of one writes of the same state
        tcfg = trainer.cfg.diffusion.train if case == "diffusion" else trainer.cfg.text2semantic.train
        tcfg.expdir = os.path.join(tmp, case + "_single")
        trainer.save()
        single_mb = sum(os.path.getsize(os.path.join(tcfg.expdir, f)) for f in os.listdir(tcfg.expdir)
                        if f.endswith(".ckpt")) / 1e6
        batch = tp_batches(case, getattr(getattr(trainer, "lm_cfg", None), "vocab_size", 0))[1]
        k4.launches = k4.bwd_launches = 0
        t0 = time.perf_counter()
        loss, grads, choices = tp_step(trainer, case, batch, 1)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches["attention_fwd"] += k4.launches
        launches["attention_bwd"] += k4.bwd_launches
        if case == "diffusion" and (k4.launches, k4.bwd_launches) != (32, 32):
            raise AssertionError(f"tp_ep diffusion step: K4 {k4.launches} / {k4.bwd_launches}, want 32 / 32")
        flips = sum(int((a != b).sum()) for a, b in zip(choices, ranks[0]["choices"]))
        routed = sum(a.numel() for a in choices)
        loss_p = ranks[0]["loss"]
        loss_rel = abs(loss - loss_p) / abs(loss_p)
        rel = {k: ((g - grads_p[k]).norm() / grads_p[k].norm().clamp_min(1e-30)).item() for k, g in grads.items()}
        worst = max(rel, key=rel.get)
        total = (sum(((g - grads_p[k]) ** 2).sum() for k, g in grads.items()).sqrt()
                 / sum((g ** 2).sum() for g in grads_p.values()).sqrt()).item()
        if loss_rel > (1e-5 if not flips else 1e-4) or (not flips and (rel[worst] > 1e-3 or total > 1e-4)):
            raise AssertionError(f"tp_ep {case}: the card's second step against the ranks': loss {loss} vs "
                                 f"{loss_p}, worst gradient {worst} {rel[worst]:.3e}, global {total:.3e}, "
                                 f"{flips} of {routed} expert choices differ")
        routing = f"; expert choices: {flips} of {routed} differ" if routed else ""
        print(f"tp_ep {case} [{card}]: two CPU gloo ranks ({dict(ranks[0]['spec'])}; both cases' four "
              f"processes at once in {ranks_s:.1f} s, during the kernels' build) "
              f"(first step {ranks[0]['step_s']:.2f} s a rank), {len(split)} of {len(saved)} parameters split; "
              f"losses {ranks[0]['first']:.6f}, {loss_p:.6f}; the sharded checkpoint {shard_mb[0]:.1f} + "
              f"{shard_mb[1]:.1f} MB (rank 0, rank 1) against the single file's {single_mb:.1f} MB; the world "
              f"of one on the card resumed it bit for bit and its second step {card_s * 1e3:.1f} ms: loss "
              f"{loss:.7f} (relative {loss_rel:.2e}), worst gradient {rel[worst]:.2e} ({worst}), global "
              f"{total:.2e}{routing}")
        del trainer
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(tmp, case), ignore_errors=True)
    print(f"tp_ep phase: {time.perf_counter() - t_phase:.1f} s on the card; its CPU part before, during the "
          f"kernels' build: the ranks {ranks_s:.1f} s, dryrun_multichip(8), a process beside them, {dry_s:.1f} s; "
          f"card launches "
          f"{launches} [{card}]")
    return launches


# sp_pp: sequence and pipeline parallelism, the shipped RoFormer and the
# 8-expert Llama over two CPU gloo ranks each, resumed on the card
SP_CASES = {"roformer_seq": ("roformer", {"seq": 2}), "roformer_pipe": ("roformer", {"pipe": 2}),
            "llama_pipe": ("llama", {"pipe": 2})}
SP_ROF_B, SP_ROF_L, SP_ROF_S = 4, 64, 128  # the RoFormer's global batch: rows, phone and semantic tokens
SP_LLAMA_B, SP_LLAMA_T = 4, 64  # the Llama's (pipe_microbatches 4: one row a microbatch)


def sp_config(case: str, tmp: str, layout: bool):
    """The shipped config for sp_pp's `case`: the RoFormer of
    configs/config.yaml (C=256, 8 heads, FF 512, 4 + 1 layers) at seq=2 with
    attention dropout 0 (the ring has none) and the shipped hidden dropout
    0.1, or at pipe=2 with dropout 0 (the pipeline is deterministic); the
    Llama with 8 experts at LLAMA_GEOM at pipe=2.  `pipe_microbatches` 4, as
    shipped."""
    from latent_diffusion_speech_tpu_torch.config import load_config

    lm_type, axes = SP_CASES[case]
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    m = cfg.text2semantic.model
    m.type = lm_type
    if lm_type == "llama":
        d = m.decoder
        d.hidden_size, d.num_attention_heads, d.num_hidden_layers, d.intermediate_size = LLAMA_GEOM
        m.moe_experts, m.moe_top_k, m.moe_capacity_factor = LLAMA_MOE
    for stack in (m.encoder, m.decoder):
        stack.attention_probs_dropout_prob = 0.0
        if case == "roformer_pipe":
            stack.hidden_dropout_prob = 0.0
    cfg.text2semantic.train.expdir = os.path.join(tmp, case)
    if layout:
        cfg.parallel.data = 1
        for k, v in axes.items():
            setattr(cfg.parallel, k, v)
    return cfg


def sp_batches(case: str, vocab: int) -> list:
    """sp_pp's two global batches (numpy, seeded), padded unevenly."""
    g = np.random.default_rng(9)
    out = []
    for _ in range(2):
        if case.startswith("roformer"):
            B, L, S = SP_ROF_B, SP_ROF_L, SP_ROF_S
            em = (np.arange(L)[None] < g.integers(L // 2, L + 1, B)[:, None]).astype(np.int64)
            dm = (np.arange(S)[None] < g.integers(S // 2, S + 1, B)[:, None]).astype(np.int64)
            semantic = g.integers(0, 4096, (B, S))
            out.append({"phone": g.integers(1, 80, (B, L)) * em, "tone": g.integers(0, 6, (B, L)) * em,
                        "semantic": semantic, "labels": np.where(dm > 0, semantic, -100),
                        "spk_id": np.repeat(g.integers(1, 300, (B, 1)), L, axis=1),
                        "encoder_attention_mask": em, "attention_mask": dm})
        else:
            ids = g.integers(0, vocab, (SP_LLAMA_B, SP_LLAMA_T))
            out.append({"input_ids": ids, "labels": ids.copy(), "attention_mask": np.ones_like(ids)})
    return out


def sp_step(trainer, batch, microbatched: bool = False) -> tuple:
    """One LM train_step whose dropout draws come from a CPU generator (on
    the host, so a step on the card draws the CPU ranks' numbers);
    `microbatched`: a world of one takes the loss through `loss_pp` (its
    microbatches through every layer in turn, an expert's capacity a
    microbatch's: what the pipe ranks compute); returns (loss, the
    gradients AdamW saw, the MoE's expert choices, seconds)."""
    from latent_diffusion_speech_tpu_torch.ops import moe
    from latent_diffusion_speech_tpu_torch.train import lm_trainer, optim

    seen, choices = {}, []
    real_step, real_top_k = trainer.optimizer.step, moe.top_k_lowest_index

    def opt_step(*a, **k):
        seen.update({n: p.grad.detach().cpu().clone() for n, p in trainer.system.module.named_parameters()})
        return real_step(*a, **k)

    def top_k(probs, k):
        vals, idx = real_top_k(probs, k)
        choices.append(idx.cpu())
        return vals, idx

    trainer.optimizer.step = opt_step
    try:
        with mock.patch.object(moe, "top_k_lowest_index", top_k), \
                mock.patch.object(lm_trainer, "step_generator", lambda seed, step, device: optim.step_generator(
                    seed, step, "cpu")), \
                mock.patch.object(trainer, "loss", (lambda b, generator: trainer._loss_pp(b, None)) if microbatched
                                  else trainer.loss):
            t0 = time.perf_counter()
            out = trainer.train_step(trainer.device_put_batch(batch))
            loss = float(out["loss"])
            seconds = time.perf_counter() - t0
    finally:
        trainer.optimizer.step = real_step
    return loss, seen, choices, seconds


def sp_rank(process: int, tmp: str, ports: dict, t0: float) -> None:
    """One CPU process of sp_pp: processes 2c and 2c + 1 are the two gloo
    ranks of the c-th case of SP_CASES (each case its own group, on
    `ports[case]`).  The rank takes its case at full width: one step, a
    save, a second step; writes the parameters at the save, the second
    step's loss, gradients and expert choices, both steps' seconds and its
    end's seconds after `t0` (the parent's `time.time()` at the start) to
    `<tmp>/<case>_rank<index>.pt`."""
    case, index, n = list(SP_CASES)[process // 2], process % 2, 2
    os.nice(10)  # below the kernels' build, which runs beside the ranks
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(ports[case]), CUDA_VISIBLE_DEVICES="")
    sys.path.insert(0, ROOT)
    import torch

    from latent_diffusion_speech_tpu_torch.parallel.dist import initialize_distributed
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    trainer = LMTrainer(sp_config(case, tmp, layout=True), device="cpu")
    batches = sp_batches(case, getattr(trainer.lm_cfg, "vocab_size", 0))
    first, _, _, first_s = sp_step(trainer, batches[0])
    trainer.save()
    saved = {k: p.detach().clone() for k, p in trainer.system.module.named_parameters()}
    loss, grads, choices, second_s = sp_step(trainer, batches[1])
    torch.save(dict(saved=saved, loss=loss, first=first, grads=grads, choices=choices, step_s=(first_s, second_s),
                    coords=trainer.mesh.coords, spec=dict(trainer.mesh.shape), done_s=time.time() - t0),
               os.path.join(tmp, f"{case}_rank{index}.pt"))
    torch.distributed.destroy_process_group()


class SpRanks:
    """sp_pp's CPU part, started in the background before the kernels are
    built, beside `TpRanks`: six gloo rank processes (`sp_rank`), each
    case's two writing to `tmp`.  `wait` joins them (they end long before
    sp_pp runs)."""

    def __init__(self):
        import tempfile

        import torch.multiprocessing as mp

        os.makedirs(os.path.join(ROOT, "exp"), exist_ok=True)
        self.dir = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "exp"))
        self.tmp = self.dir.name
        ports: dict = {}
        for case in SP_CASES:
            while (port := free_port()) in ports.values():
                pass
            ports[case] = port
        self.ranks = None
        try:
            self.ranks = mp.start_processes(sp_rank, args=(self.tmp, ports, time.time()), nprocs=2 * len(SP_CASES),
                                            start_method="spawn", join=False)
        except BaseException:
            self.close()
            raise

    def wait(self) -> None:
        try:
            while not self.ranks.join():
                pass
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stops what still runs and removes the ranks' files."""
        for proc in self.ranks.processes if self.ranks is not None else ():
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.dir.cleanup()


def sp_p2p_bytes(case: str, cfg, spec: dict) -> tuple:
    """(the P2P bytes a rank sends in one step, worked out from the shapes,
    and how): the ring's 2 (n - 1) B (T / n) H D f32 per attention call
    forward, 2 (n - 1) + 2 n chunks' worth backward (k, v and their
    gradients, which travel home), and the cross-attention's gathered
    encoder states (keys and values, forward; their gradients summed
    backward); the pipeline's activation per microbatch times 2 (S - 1)."""
    m = cfg.text2semantic.model
    if case == "roformer_seq":
        n, B, C = spec["seq"], SP_ROF_B, m.encoder.hidden_size
        fwd = lambda T: 2 * (n - 1) * B * (T // n) * C * 4  # noqa: E731
        bwd = lambda T: (2 * (n - 1) + 2 * n) * B * (T // n) * C * 4  # noqa: E731
        ring = (m.encoder.num_hidden_layers * (fwd(SP_ROF_L) + bwd(SP_ROF_L))
                + m.decoder.num_hidden_layers * (fwd(SP_ROF_S) + bwd(SP_ROF_S)))
        gather = m.decoder.num_hidden_layers * (2 * (n - 1) * B * (SP_ROF_L // n) * C * 4
                                                + 2 * 2 * (n - 1) * B * SP_ROF_L * C * 4 // n)
        return ring + gather, (f"ring {ring} B (forward {fwd(SP_ROF_L)} B a call at T={SP_ROF_L}, "
                               f"{fwd(SP_ROF_S)} B at T={SP_ROF_S}), cross-attention gathers {gather} B")
    S, M = spec["pipe"], cfg.parallel.pipe_microbatches
    if case == "roformer_pipe":
        mb, C = SP_ROF_B // M, m.encoder.hidden_size
        act = mb * (SP_ROF_L + SP_ROF_S) * C * 4 + mb * (SP_ROF_L + SP_ROF_S)  # both streams f32, both masks bytes
    else:
        mb, C = SP_LLAMA_B // M, m.decoder.hidden_size
        act = mb * SP_LLAMA_T * C * 4 + mb * SP_LLAMA_T + m.decoder.num_hidden_layers * 2 * m.moe_experts * 4
    total = act * 2 * (S - 1) * M
    return total, f"activation {act} B a microbatch x 2 (S - 1) = {2 * (S - 1)} x M = {M}"


def sp_card_checks(dev, card: str) -> str:
    """At a world of one on the card: `pipeline_apply` over one stage
    against the sequential stack, each LM's `loss_pp` against its `loss`
    (value rtol 2e-5; gradients rtol 5e-4, atol 1e-5), `encode_seq_parallel`
    against `encode`, and the ring (one block) against plain attention."""
    import torch

    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaConfig, LlamaSystem
    from latent_diffusion_speech_tpu_torch.models.lm.registry import roformer_config_from
    from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerSystem
    from latent_diffusion_speech_tpu_torch.ops.attention import dot_product_attention
    from latent_diffusion_speech_tpu_torch.ops.ring_attention import ring_attention
    from latent_diffusion_speech_tpu_torch.parallel.pipeline import pipeline_apply

    g = torch.Generator().manual_seed(3)
    w = (torch.randn((4, 256, 256), generator=g) * 0.06).to(dev)
    x = torch.randn((4, 2, 64, 256), generator=g).to(dev)
    got = pipeline_apply(None, lambda p, h: torch.tanh(h @ p), w, x)
    want = x.clone()
    for s in range(4):
        want = torch.tanh(want @ w[s])
    pipe_err = (got - want).abs().max().item()
    if pipe_err > 1e-6:
        raise AssertionError(f"sp_pp: pipeline_apply over one stage differs from the stack by {pipe_err}")
    lines = [f"pipeline_apply (S=1, 4 stages of 256 x 256) against the sequential stack: max err {pipe_err:.1e}"]
    cfg = sp_config("roformer_pipe", "unused", layout=False)
    rof = RoformerSystem(roformer_config_from(cfg), device=dev, training=True)
    b = {k: torch.as_tensor(v, device=dev) for k, v in sp_batches("roformer_pipe", 0)[0].items()}
    llama = LlamaSystem(LlamaConfig(*LLAMA_GEOM, semantic_kmeans_num=4096), device=dev, training=True)
    ids = torch.as_tensor(sp_batches("llama_pipe", llama.cfg.vocab_size)[0]["input_ids"], device=dev)
    for name, lm, base_fn, pp_fn in (
            ("RoFormer", rof, lambda: rof.loss(b),
             lambda: rof.loss_pp(b["phone"], b["tone"], b["semantic"], b["labels"], None, spk_id=b["spk_id"],
                                 encoder_attention_mask=b["encoder_attention_mask"],
                                 attention_mask=b["attention_mask"])),
            ("Llama (dense, LLAMA_GEOM)", llama, lambda: llama.loss({"input_ids": ids, "labels": ids}),
             lambda: llama.loss_pp(ids, ids, None))):
        params = list(lm.module.parameters())
        vals, grads = [], []
        for fn in (base_fn, pp_fn):
            loss = fn()
            vals.append(loss.item())
            grads.append(torch.autograd.grad(loss, params, allow_unused=True))
        worst = 0.0
        for a, ref in zip(grads[1], grads[0]):
            if ref is None:
                continue
            margin = ((a - ref).abs() - 1e-5 - 5e-4 * ref.abs()).max().item()
            if margin > 0:
                raise AssertionError(f"sp_pp: {name} loss_pp gradient beyond rtol 5e-4, atol 1e-5")
            worst = max(worst, (a - ref).abs().max().item())
        if abs(vals[1] - vals[0]) > 2e-5 * abs(vals[0]):
            raise AssertionError(f"sp_pp: {name} loss_pp {vals[1]} against loss {vals[0]}")
        lines.append(f"{name} loss_pp (4 microbatches) {vals[1]:.7f} against loss {vals[0]:.7f}, gradients within "
                     f"rtol 5e-4 + atol 1e-5 (largest error {worst:.2e})")
    with torch.no_grad():
        enc = rof.encode_seq_parallel(b["phone"], b["tone"], b["spk_id"], mesh=None)
        ref = rof.module.encode(b["phone"], b["tone"], b["spk_id"])
        enc_err = (enc - ref).abs().max().item()
        q, k, v = (torch.randn((2, 256, 8, 32), generator=g).to(dev) for _ in range(3))
        mask = torch.arange(256, device=dev)[None] < torch.tensor([[256], [100]], device=dev)
        ring_err = (ring_attention(q, k, v, None, is_causal=True, kv_mask=mask)
                    - dot_product_attention(q, k, v, mask=mask[:, None, None, :], is_causal=True)).abs().max().item()
    if enc_err > 0 or ring_err > 2e-5:
        raise AssertionError(f"sp_pp: encode_seq_parallel differs from encode by {enc_err}, the ring from "
                             f"plain attention by {ring_err}")
    lines.append(f"encode_seq_parallel against encode: max err {enc_err:.1e}; the ring (one block, causal, a key "
                 f"mask; B=2, T=256, H=8, D=32) against plain attention: max err {ring_err:.1e}")
    return "\n".join(f"sp_pp card [{card}]: {line}" for line in lines)


def sp_pp(dev, card: str, cpu: SpRanks) -> dict:
    """Sequence and pipeline parallelism (`cpu`: the CPU part, `SpRanks`):
    at full width, two CPU gloo ranks each take a step of the shipped
    RoFormer at seq=2 (hidden dropout 0.1, attention dropout 0), of the same
    RoFormer at pipe=2 (dropout 0) and of the Llama with 8 experts at JAX's
    geometry at pipe=2, save a checkpoint, then a second step; a world of
    one on the card resumes each checkpoint: its parameters equal the
    ranks', bit for bit, and its second step (under `pipe` through
    `loss_pp` over the same microbatches) holds `train_slice`'s
    tolerance against the ranks' (as `tp_ep`: the loss within 1e-5
    relative, every gradient tensor within 1e-3 of its norm and all within
    1e-4 of the global norm; a gradient at rounding level, such as the
    attention's key biases', which the softmax cancels, to the global bound
    only; the same dropout draws, from
    a CPU generator; the Llama's gradients held where no expert choice
    differs).  Prints the
    ranks' step times, the P2P bytes a step from the shapes and the
    pipeline's bubble fraction, then `sp_card_checks`."""
    import shutil

    import torch

    from latent_diffusion_speech_tpu_torch.parallel.pipeline import bubble_fraction
    from latent_diffusion_speech_tpu_torch.train.lm_trainer import LMTrainer

    t_phase = time.perf_counter()
    cpu.wait()
    tmp, done_s = cpu.tmp, 0.0
    for case in SP_CASES:
        ranks = [torch.load(os.path.join(tmp, f"{case}_rank{r}.pt"), weights_only=False) for r in range(2)]
        if ranks[0]["loss"] != ranks[1]["loss"] or ranks[0]["first"] != ranks[1]["first"]:
            raise AssertionError(f"sp_pp {case}: the ranks' losses differ")
        done_s = max([done_s] + [r["done_s"] for r in ranks])
        for k, p in ranks[0]["grads"].items():
            if not torch.equal(p, ranks[1]["grads"][k]):
                raise AssertionError(f"sp_pp {case}: the ranks' reduced gradients of {k} differ")
        trainer = LMTrainer(sp_config(case, tmp, layout=False), device=dev)
        if not trainer.resume() or trainer.step != 1:
            raise AssertionError(f"sp_pp {case}: the world of one did not resume the ranks' checkpoint")
        for k, p in trainer.system.module.named_parameters():
            if not torch.equal(p.detach().cpu(), ranks[0]["saved"][k]):
                raise AssertionError(f"sp_pp {case}: resumed {k} differs from the ranks'")
        spec = ranks[0]["spec"]
        S, M = spec["pipe"], trainer.cfg.parallel.pipe_microbatches
        batch = sp_batches(case, getattr(trainer.lm_cfg, "vocab_size", 0))[1]
        loss, grads, choices, card_s = sp_step(trainer, batch, microbatched=S > 1)
        grads_p, loss_p = ranks[0]["grads"], ranks[0]["loss"]
        theirs = ranks[0]["choices"]
        if choices and S > 1:  # the card's (microbatch, layer) order from each stage's layers
            per = trainer.lm_cfg.num_hidden_layers // S
            theirs = [ranks[layer // per]["choices"][m * per + layer % per]
                      for m in range(M) for layer in range(per * S)]
        flips = sum(int((a != b).sum()) for a, b in zip(choices, theirs))
        routed = sum(a.numel() for a in choices)
        loss_rel = abs(loss - loss_p) / abs(loss_p)
        # a gradient at rounding level (a key projection's bias shifts a
        # query's every logit alike, so the softmax cancels it) is held to
        # the global bound only: those whose norm in the ranks' step is below
        # 1e-6 of the global norm
        norm_p = sum((g ** 2).sum() for g in grads_p.values()).sqrt().item()
        tiny = {k: g.norm().item() for k, g in grads_p.items() if g.norm().item() < 1e-6 * norm_p}
        rel = {k: ((g - grads_p[k]).norm() / grads_p[k].norm().clamp_min(1e-30)).item() for k, g in grads.items()
               if k not in tiny}
        worst = max(rel, key=rel.get)
        total = sum(((g - grads_p[k]) ** 2).sum() for k, g in grads.items()).sqrt().item() / norm_p
        if loss_rel > (1e-5 if not flips else 1e-4) or (not flips and (rel[worst] > 1e-3 or total > 1e-4)):
            raise AssertionError(f"sp_pp {case}: the card's second step against the ranks': loss {loss} vs {loss_p}, "
                                 f"worst gradient {worst} {rel[worst]:.3e}, global {total:.3e}, {flips} of {routed} "
                                 "expert choices differ")
        p2p, how = sp_p2p_bytes(case, trainer.cfg, spec)
        bubble = f"; bubble fraction (S - 1) / (M + S - 1) = {bubble_fraction(S, M):.3f}" if S > 1 else ""
        routing = f"; expert choices: {flips} of {routed} differ" if routed else ""
        exempt = (f"; {len(tiny)} gradient tensors at rounding level (largest norm {max(tiny.values()):.2e}, global "
                  f"{norm_p:.3e}) held to the global bound only" if tiny else f"; global gradient norm {norm_p:.3e}")
        print(f"sp_pp {case} [{card}]: two CPU gloo ranks ({spec}; the six processes of sp_pp at once, beside "
              f"tp_ep's and the kernels' build); step time a rank: first {ranks[0]['step_s'][0]:.2f} / "
              f"{ranks[1]['step_s'][0]:.2f} s, second {ranks[0]['step_s'][1]:.2f} / {ranks[1]['step_s'][1]:.2f} s "
              f"(rank 0 / rank 1, CPU); P2P a rank a step {p2p / 1e6:.3f} MB from the shapes ({how}){bubble}; "
              f"losses {ranks[0]['first']:.6f}, {loss_p:.6f}; the world of one on the card resumed the checkpoint "
              f"bit for bit and its second step {card_s * 1e3:.1f} ms: loss {loss:.7f} (relative {loss_rel:.2e}), "
              f"worst gradient {rel[worst]:.2e} ({worst}), global {total:.2e}{routing}{exempt}")
        del trainer
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(tmp, case), ignore_errors=True)
    print(sp_card_checks(dev, card))
    torch.cuda.empty_cache()
    print(f"sp_pp phase: {time.perf_counter() - t_phase:.1f} s on the card; its six CPU ranks, started before the "
          f"kernels' build, the last done {done_s:.1f} s after their start [{card}]")
    return {}


# phases that a second process of this script runs (`--phases`), started
# after the kernel checks and beside the main process's phases: they share
# nothing with those; their launches come back in its last line
CHILD_PHASES = ("codec_train", "llama_text")


def start_child_phases() -> tuple:
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases", ",".join(CHILD_PHASES)]
    return cmd, time.perf_counter(), start_process(cmd)


def finish_child_phases(started: tuple) -> dict:
    """The second process's lines, printed here, and each phase's result."""
    cmd, t0, proc = started
    stdout, _ = finish_process(proc, cmd, timeout=1200)
    lines = stdout.rstrip().splitlines()
    print("\n".join(lines[:-1]))
    print(f"{', '.join(CHILD_PHASES)}: a second process, started after the kernel checks, done "
          f"{time.perf_counter() - t0:.1f} s after its start")
    return json.loads(lines[-1])["phases"]


def run_child_phases(dev, card: str, names: list) -> int:
    """`--phases`: each named phase, then a last line {"phases": {name: {"launches": ...}}}."""
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import load_library

    load_library()  # built by the parent
    t0, results = time.perf_counter(), {}
    for name in names:
        if name not in CHILD_PHASES:
            raise ValueError(f"--phases: {name!r} is not one of {CHILD_PHASES}")
        out = globals()[name](dev, card)
        results[name] = {"launches": out["launches"]} if isinstance(out, dict) and "launches" in out else {}
        print(f"timeline: {name} done at {time.perf_counter() - t0:.1f} s of the second process", flush=True)
    print(json.dumps({"phases": results}))
    return 0


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description="Chip smoke run of the PyTorch port on one NVIDIA Hopper card.")
    ap.add_argument("--phases", default=None,
                    help=f"run only these phases, comma-separated, of {CHILD_PHASES} (the script's second process)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import latent_diffusion_speech_tpu_torch  # noqa: F401 - fails here outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()

    def mark(phase: str) -> None:  # where the script's time goes, phase by phase
        print(f"timeline: {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    print(f"card: {card}")
    cap = torch.cuda.get_device_capability(0)
    print(f"capability: {cap}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; this card is {cap}")
    if args.phases:
        try:
            return run_child_phases(dev, card, args.phases.split(","))
        finally:
            stop_children()
    tp_cpu = TpRanks()  # tp_ep's and sp_pp's CPU ranks meanwhile: the build leaves cores idle
    sp_cpu = None
    try:
        sp_cpu = SpRanks()
        return run_phases(dev, card, tp_cpu, sp_cpu, mark)
    finally:
        tp_cpu.close()
        if sp_cpu is not None:
            sp_cpu.close()
        stop_children()


def run_phases(dev, card: str, tp_cpu: TpRanks, sp_cpu: SpRanks, mark) -> int:
    """Every phase after the card's checks (see the module's docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig
    from latent_diffusion_speech_tpu_torch.ops.kernels.build import build_info, load_library

    t0 = time.perf_counter()
    load_library()
    info = build_info()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())
    with ThreadPoolExecutor(1) as pool:  # cuobjdump while tp_ep's CPU ranks finish
        hmma = pool.submit(hmma_counts, info["path"])
        tp_cpu.wait()
        hmma = hmma.result()
    print(f"HMMA instructions (cuobjdump -sass): {hmma if hmma else 'not measured (no cuobjdump)'}")
    mark("kernel build, tp_ep's CPU ranks")

    k4 = check_k4(dev)
    k5 = check_k5(dev)
    k4_bwd = check_k4_bwd(dev)
    k6 = check_k6(dev)
    k1 = check_k1(dev)
    k23 = check_unet(dev)
    mark("kernel checks")
    child = start_child_phases()  # CHILD_PHASES in a second process, beside the phases below
    eager = serve(dev, card)
    launches = eager["launches"]
    launches["unet_fwd"] = serve_fused(dev, card, eager)
    launches["flash_attention"], _ = serve_k5(
        dev, card, eager, "general denoiser (K5)", Unit2MelConfig(denoiser="general", attn_impl="pallas"), True)
    n, flagship_k5 = serve_k5(
        dev, card, eager, "flagship attn_impl=pallas (K5)", Unit2MelConfig(attn_impl="pallas"), False)
    launches["flash_attention"] += n
    compare_flagship_k4_k5(dev, card, eager["pipe"].diffusion, flagship_k5)
    del eager, flagship_k5
    check_slice_against_plain(dev)
    check_general_against_plain(dev)
    zoo_launches = zoo(dev, card)
    launches["flash_attention"] += zoo_launches["flash_attention"]
    launches["attention_fwd"] += zoo_launches["attention_fwd"]
    check_trajectory(dev)
    mark("serve, fused, K5, zoo")
    torch.cuda.empty_cache()
    entry = serve_entry(dev, card)
    for name, n in entry.items():
        launches[name] += n
    print(f"launches with serve_entry's: {launches}")
    mark("serve_entry")
    torch.cuda.empty_cache()
    svc_launches = svc(dev, card)
    launches["attention_fwd"] += svc_launches["attention_fwd"]
    print(f"launches with svc's: {launches}, kmeans_argmin {svc_launches['kmeans_argmin']} (stage 19)")
    mark("svc")
    torch.cuda.empty_cache()
    train = train_slice(dev, card, k4_bwd, k6)
    print(f"attention_fwd launches: {launches['attention_fwd']} serving (svc {svc_launches['attention_fwd']}) "
          f"+ {train['launches']['attention_fwd']} training; kmeans_argmin launches: "
          f"{svc_launches['kmeans_argmin']} stage 19 + {train['launches']['kmeans_argmin']} training")
    launches["attention_fwd"] += train["launches"]["attention_fwd"] + train["options"]["attention_fwd"]
    mark("train_slice")
    torch.cuda.empty_cache()
    lm = lm_train(dev, card)
    launches["ar_decode"] += lm["launches"]["ar_decode"]
    launches["attention_fwd"] += lm["launches"]["attention_fwd"]
    print(f"launches with lm_train's: {launches}")
    mark("lm_train")
    torch.cuda.empty_cache()
    data = data_path(dev, card)
    for name in ("ar_decode", "attention_fwd"):
        launches[name] += data["launches"][name]
    print(f"launches with data_path's: {launches}, attention_bwd {data['launches']['attention_bwd']}, "
          f"kmeans_argmin {data['launches']['kmeans_argmin']} (stage 17 {data['k6_stage17_launches']})")
    s17 = data["k6_stage17"]
    mark("data_path")
    torch.cuda.empty_cache()
    alt = units_alt(dev, card)
    launches["attention_fwd"] += alt["launches"]["attention_fwd"]
    print(f"launches with units_alt's: {launches}, attention_bwd {alt['launches']['attention_bwd']}, "
          f"kmeans_argmin {alt['launches']['kmeans_argmin']}")
    mark("units_alt")
    torch.cuda.empty_cache()
    dp_started = DpStart()  # dp_train's CLI processes, beside migrate
    mig = migrate(dev, card)
    for name in ("ar_decode", "attention_fwd"):
        launches[name] += mig["launches"][name]
    print(f"launches with migrate's: {launches}, kmeans_argmin {mig['launches']['kmeans_argmin']} (verify_import)")
    mark("migrate")
    torch.cuda.empty_cache()
    zoo_t = zoo_train(dev, card)
    torch.cuda.empty_cache()
    dp = dp_train(dev, card, dp_started)
    launches["attention_fwd"] += zoo_t["attention_fwd"] + dp["attention_fwd"]
    print(f"launches with zoo_train's and dp_train's: {launches}, attention_bwd {zoo_t['attention_bwd']} + "
          f"{dp['attention_bwd']}, kmeans_argmin {dp['kmeans_argmin']}")
    mark("zoo_train, dp_train")
    torch.cuda.empty_cache()
    q8 = int8_serve(dev, card)
    launches["ar_decode"] += q8["ar_decode"]
    launches["attention_fwd"] += q8["attention_fwd"]
    mark("int8_serve")
    torch.cuda.empty_cache()
    tp = tp_ep(dev, card, tp_cpu)
    launches["attention_fwd"] += tp["attention_fwd"]
    print(f"launches with int8_serve's and tp_ep's: {launches}, attention_bwd {tp['attention_bwd']}")
    mark("tp_ep")
    sp_pp(dev, card, sp_cpu)  # no kernel lies on its path (the LMs' plain attention, the ring's products)
    mark("sp_pp")
    for check in DEFERRED:
        check()
    mark("the checks of the processes that the phases started")
    llama = finish_child_phases(child)["llama_text"]
    launches["attention_fwd"] += llama["launches"]["attention_fwd"]
    print(f"launches with llama_text's: {launches}")
    mark(f"{', '.join(CHILD_PHASES)} (a second process)")

    src = "latent_diffusion_speech_tpu_torch/csrc/"
    kernels = [
        dict(name="ar_decode", route="cuda", source=src + "ar_decode.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/ar_decode.py:374",
             launches=launches["ar_decode"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
             library_ms=None),
        dict(name="attention_fwd", route="cuda", source=src + "attention_fwd.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/fused_attention.py:127",
             launches=launches["attention_fwd"], max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
             library_ms=k4["library_ms"], device_ms=k4["device_ms"], library_device_ms=k4["library_device_ms"],
             simt_device_ms=k4["simt_device_ms"], host_us=k4["host_us"],
             **{k: v for k, v in k4.items() if k.startswith("d8_")}),
        dict(name="unet_fwd", route="cuda", source=src + "unet_fwd.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/unet1d_fused.py:712 + "
                      "latent_diffusion_speech_tpu/ops/pallas/unet1d_stream.py:519",
             launches=launches["unet_fwd"], max_abs_err=k23["max_abs_err"],
             ms=k23["ms"], plain_ms=k23["plain_ms"], bound_ms=k23["bound_ms"], bound_by=k23["bound_by"],
             library_ms=None),
        dict(name="attention_bwd", route="cuda", source=src + "attention_bwd.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/fused_attention.py:149",
             launches=train["launches"]["attention_bwd"] + train["options"]["attention_bwd"]
             + data["launches"]["attention_bwd"] + alt["launches"]["attention_bwd"] + zoo_t["attention_bwd"]
             + dp["attention_bwd"] + tp["attention_bwd"],
             max_abs_err=k4_bwd["max_abs_err"],
             ms=k4_bwd["ms"], plain_ms=k4_bwd["plain_ms"], bound_ms=k4_bwd["bound_ms"],
             bound_by=k4_bwd["bound_by"], library_ms=k4_bwd["library_ms"],
             **{k: v for k, v in k4_bwd.items() if k.startswith("d8_") and k != "d8_rows"}),
        dict(name="flash_attention", route="cuda", source=src + "flash_attention.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/flash_attention.py:89",
             launches=launches["flash_attention"], max_abs_err=k5["max_abs_err"],
             ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"], bound_by=k5["bound_by"],
             library_ms=k5["library_ms"], device_ms=k5["device_ms"], library_device_ms=k5["library_device_ms"],
             simt_device_ms=k5["simt_device_ms"], host_us=k5["host_us"],
             **{k: v for k, v in k5.items() if k.startswith("d8_")}),
        dict(name="kmeans_argmin", route="cuda", source=src + "kmeans_argmin.cu",
             replaces="latent_diffusion_speech_tpu/ops/pallas/kmeans.py:54",
             launches=train["launches"]["kmeans_argmin"] + train["options"]["kmeans_argmin"]
             + svc_launches["kmeans_argmin"]
             + data["launches"]["kmeans_argmin"] + alt["launches"]["kmeans_argmin"]
             + mig["launches"]["kmeans_argmin"] + dp["kmeans_argmin"],
             max_abs_err=k6["max_abs_err"],
             ms=k6["ms"], plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"], bound_by=k6["bound_by"],
             library_ms=k6["library_ms"], stage17_ms=s17["ms"], stage17_plain_ms=s17["plain_ms"],
             stage17_bound_ms=s17["bound_ms"], stage17_library_ms=s17["library_ms"],
             **{f"n{n}_d{d}_{k}": v for (n, d), row in alt["k6"].items() for k, v in row.items()
                if k != "bound_by"}),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
