#!/usr/bin/env python3
"""Drive the PyTorch port (ctts_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure makes the exit code 1 and
suppresses the final line:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``ctts_torch/csrc/`` (into the gitignored ``build/``);
2. each kernel against its plain PyTorch version at the served shapes,
   with the tolerance stated, and its time beside the plain version's, one
   library call's and the bound computed from the shapes; the attention
   also at the train step's decoder and encoder shapes, with the registers
   and spills of its instances and its fraction of the bound; the row
   gather also at the train step's upsample and the reformer's sorted-row
   shapes, each with its fraction of the bound;
3. the trained-weights probe: ``assets/ljdemo_ckpt.npz`` with the
   ``configs/LJSpeech.yaml`` defaults (bf16 stacks) on the 4 texts of
   ``assets/ljdemo_ckpt_manifest.json`` at the 1152-frame budget, held to
   the manifest; the launch counters are zeroed just before this forward
   and read just after it;
4. HiFi-GAN V1 at full width with seeded random weights on the probe mels,
   then the synthesize CLI once on one text;
5. the training kernels against their plain versions at the train step's
   shapes (B=16, T_s=128, T_m=896, ragged lengths from a seed): the row
   scatter, MAS (bit-exact), the CTC lattice (alpha and beta in one
   launch) and the elementwise CTC gradient, and the attention backward;
   each with its time, its bound, the barrier-chain floor where the work is
   a chain of frames (for MAS also the warp-chain floor of its one-warp
   chain, its wrapper's time, and its logarithm held bit for bit to the
   wrapper's torch expression), and one library call as a yardstick; the
   scatter also
   at the reformer's un-sort and LSH chunk-backward shapes;
6. the ``train_unsup`` step of ``ctts_torch.parallel.train_step`` at full
   width and depth in bf16, from ``assets/ljdemo_ckpt.npz`` (step 13301, the
   hard-upsample regime): three steps on one seeded batch with the launch
   counters zeroed before each and read after it, one step below
   ``binarization_start_steps`` (soft upsample), one above
   ``var_start_steps``, then timed steps and one under ``torch.profiler``;
6b. supervised training, "LJSpeech supervised" (``learn_alignment:
   False``, seeded weights, bf16): three ``train_sup`` steps at [16, 128
   tokens, 896 frames] with durations summing to the mel lengths, counted
   (attention 10, gather 2, scatter 2, no MAS, no CTC), one with the
   variance losses on, then timed and profiled beside phase 6's step;
   ``python -m ctts_torch.train`` on a synthetic supervised store (8
   steps, and a resume from their step-4 checkpoint for steps 5-8,
   validating every 4) and
   ``python -m ctts_torch.synthesize`` from its step-8 checkpoint on the
   probe texts; the four variance configurations (frame and ph pitch,
   ``pitch_ar``, frame energy, huber, mog and crf durations, LEFT padding,
   the ssim CWT loss): a counted bf16 step, a probe forward at budget
   1152 (pitch_ar's frame loop profiled), and one float32 step with
   dropout off on the card against the port's CPU path;
7. the relative-position attention kernels (the conformer's) against
   their plain version at the decoder's and the encoder's training shapes,
   the probe's budget and text lengths (96 padded, 87 unpadded), and at
   heads of 16 and 64, bf16 and f32, masked and not, dropout off and on;
   two backward runs bit-identical; their times beside the plain
   version's, SDPA's with the shifted positional score as its mask, the
   bounds, and the times PERF.md records (those before the redesign for
   the tensor cores in brackets);
8. the conformer (``block_type: conformer``, full width and depth, seeded
   weights) on the probe texts at budget 1152: launch counters zeroed just
   before the forward and read just after, latency, and the same model with
   the plain relpos on the card (the encoder on the probe texts, the decoder
   on seeded frames with seeded lengths near the budget, the durations);
9. ``python -m ctts_torch.train`` on a synthetic LJSpeech-shaped store with
   the conformer config: 8 steps, and a resume from their step-4
   checkpoint for steps 5-8, the loss
   falling and the resumed losses matching; then steps of the same model in
   this process with the counters zeroed just before one step and read
   just after, and one step under ``torch.profiler``;
10. the reformer's kernels (local window; LSH chunk, fused route) against
   their plain versions at the shapes its heads give them (d=128, bf16 and
   f32, ragged validity, the chunk-0 wrap); two backward runs bit-identical
   at the train shape; the registers and spills nvcc reported for each
   instance; their times beside the plain versions', SDPA's on the
   windowed or chunked tensors with a float mask, the bounds and each
   kernel's fraction of its bound, and the times PERF.md records (those
   before the redesign for the tensor cores in brackets);
11. the reformer (``block_type: reformer``, full width and depth, seeded
   weights) on the probe texts at budget 1152 on both LSH routes (default,
   and ``CTTS_FUSED_LSH=1``): counted forward, latency, profile, and the
   same model with the plain versions on the card fed the same hash sorts;
12. ``python -m ctts_torch.train`` with the reformer config: 6 steps, and
   a resume from their step-3 checkpoint for steps 4-6; then counted,
   timed and profiled steps at
   [16, 128 tokens, 896 frames] on both routes;
12b. the classic ``transformer``, ``fastformer`` and ``lstransformer``
   blocks (``configs/LJSpeech.yaml`` with only ``block_type`` changed,
   full width and depth, bf16, seeded weights): the probe forward at budget
   1152 (counted, median of 20, profiled), one counted ``train_unsup`` step
   at [16, 128 tokens, 896 frames], timed and profiled, and one float32
   step with dropout off on the card against the port's CPU path at [4,
   128, 896]; then the VCTK recipe (``configs/VCTK.yaml`` as shipped:
   ``transformer_fs2``, external 512-d speaker embeddings, seeded weights):
   ``python -m ctts_torch.train --dataset VCTK`` on a synthetic store of 8
   speakers (6 steps, validating at 3 and 6, and a resume from step 3 for
   steps 4-6), one counted,
   timed and profiled step at exactly [16, 128, 1298] (VCTK's longest
   utterance), the attention, gather, scatter, MAS and CTC kernels at that
   shape against their plain versions with their bounds, and the
   synthesize CLI with ``--speaker_id`` for two speakers;
12c. the prosody models, "LJSpeech du2021" and "LJSpeech liu2021"
   (``configs/LJSpeech.yaml`` with ``learn_alignment: False`` and
   ``prosody_modeling.model_type`` changed, full width and depth, bf16,
   seeded weights): the probe forward at budget 1152 (counted, median of
   10, profiled, repeated bit for bit), one counted ``train_sup`` step at
   [16, 128 tokens, 896 frames] with the prosody term on, timed and
   profiled (liu2021 also one counted ``train_unsup`` step with MAS and the
   CTC pair), the same step in float32 with dropout off on the card and on
   the CPU at [4, 128, 896] (and with TF32 on the card, a control that must
   fail that check), ``python -m ctts_torch.train`` on a synthetic
   supervised store (4 steps, and a resume from step 2 for steps 3-4;
   validation's prosody term 0) and the
   synthesize CLI (its ``main``, in this process) from its step-4
   checkpoint;
12d. from a raw corpus to a validated checkpoint: an LJSpeech-layout
   corpus the smoke writes (40 utterances of 1.5-9.5 s, speech-like
   signals between digital silences, labs spelled through its lexicon,
   TextGrids) through ``python -m ctts_torch.preprocess`` on the card
   (``configs/LJSpeech.yaml``, ``val_size: 8``), held to the port's
   Preprocessor on the CPU (mel, energy and CWT within 1e-4, f0 within
   1e-6 relative off the frames whose lag is rounding noise, the integer
   arrays, priors and texts equal), again with two spawned workers bit
   for bit, with each run's wall seconds and CUDA-event times of the
   batched mel and the f0 tracker; a VCTK-layout corpus (2 speakers × 4
   utterances, ``configs/VCTK.yaml``, the ResCNN at seed 0) the same
   way, speaker embeddings within 1e-5, and the ResCNN's time; then
   ``python -m ctts_torch.train`` of the LJSpeech default on the card's
   store (6 steps; previews at 3 and 6 with HiFi-GAN at seed 0;
   validation at 3 and 6; steps 4-5 traced), the launches per step of
   each log line, the previews' device part counted in this process,
   ``python -m ctts_torch.evaluate --restore_step 6`` within 1e-5
   relative of the step-6 validation line, and the synthesize CLI;
13. serving: the fused HiFi-GAN ResBlock1 kernel against its plain version
   at levels 1-3 of the probe (C = 128, 64, 32; k = 3, 7, 11; bf16 and
   f32; the generator's own weights and inputs) plus two and ragged tiles,
   with its times beside the plain version's, the unfused cuDNN block's and
   the bound, and at level 1, k=11, beside the tile lengths the wrapper
   passed over; HiFi-GAN on the probe mels with ``CTTS_FUSE_RESBLOCK=1``
   against unfused (9 launches); ``ctts_torch.serve`` in a thread with the
   trained weights (/healthz, the 4 probe texts as 4 concurrent requests,
   one streamed request, and the same streamed with the fused resblocks,
   counted); ``python -m ctts_torch.synthesize`` in batch mode with
   ``--stream_chunk``; the relpos flip tool
   (``python -m ctts_torch.tools.bench_flip``), counted, and each of its
   variants bit-exact against its plain version;
14. the (data, model) process grid (``ctts_torch.parallel.mesh``): two
   ranks on this card over gloo with the LJSpeech default at full width and
   depth on the global batch of 16 × [128, 896]: at (data 2, model 1) and
   (data 1, model 2) the f32 ``train_sup`` step (dropout off, 2 steps) held
   to one process's losses and parameters, the f32 ``train_unsup`` step
   with its moved MAS frames printed, one bf16 step with dropout on (the
   replicated parameters bit-identical on both ranks) timed on each rank
   beside the one-process step; the conformer (relpos on 4 of 8 heads a
   rank) and the reformer (``CTTS_FUSED_LSH=1``: the window kernels on one
   rank, the LSH chunk kernels on the other) at (1, 2), one bf16 step each
   and one f32 step held to one process; each rank's launches per kernel,
   and each kernel's first call on each rank held to its plain version at
   that rank's shape; then ``python -m ctts_torch.train --coordinator``
   at world size 1 over NCCL (4 steps, and a resume from step 2);
15. long utterances: the CTC lattice at S = 1023, 1025, 2049 and 4097 and
   MAS at [T_m, T_s] = (1443, 1024), (10307, 128), (2560, 640) and
   (1200, 1100), each straddling a limit the kernels had, bit-exact against
   their plain versions (the CTC gradient within ``CTC_GRAD_TOL``), with
   the instance or route each took and its device time; one counted,
   timed and profiled bf16 ``train_unsup`` step of the LJSpeech default at
   full width and depth (seeded weights, ``max_seq_len`` 3000 and nothing
   else changed) on 4 utterances of up to 640 phones and 2560 frames
   (about 30 s of audio), MAS and the CTC lattice on their long routes,
   the step's hard alignment against ``b_mas_plain`` of its soft
   attention, and both kernels timed at the step's inputs beside their
   plain versions and bounds; then ``python -m ctts_torch.train`` with the
   device cache off (the streaming loader, reading through the native
   ``.npy`` prefetcher) for 2 steps;
16. the ``kernels`` JSON line, the card line, and the result line.

Each phase prints its own seconds. Exits non-zero without a result when no
CUDA device is present.

    python3 chip_smoke.py --grid-cards

runs the build and phase 14 alone on every card of a host (an even count
of at least 4), one rank a card over NCCL: grids (n, 1) and (2, n/2) for
the fs2 jobs, (1, n) for the conformer and the reformer, and the train CLI
on n processes at ``train.mesh`` (2, n/2).
"""

import atexit
import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(REPO, "assets", "ljdemo_ckpt.npz")
MANIFEST = os.path.join(REPO, "assets", "ljdemo_ckpt_manifest.json")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16 attention, row by row: max|kernel - plain f32| over a query row over
# that row's largest |plain|. The kernel rounds P and the output to bf16
# (2^-9 each); its numpy model (tests/test_torch_attention_tiles.py) reaches
# 5.7e-3 at these shapes, a wrong or stale K/V tile 0.28 and more, where the
# absolute ATTN_TOL can miss a fault on the long rows' small outputs
ATTN_ROW_TOL_BF16 = 1e-2
# the train step's shapes
B_TRAIN, T_S, T_M = 16, 128, 896
# the VCTK recipe's longest utterance (configs/VCTK.yaml, max_seq_len's
# comment): its train step's mel axis
T_VCTK = 1298
# phase 15, long utterances: the step's 4 utterances, the longest 640 phones
# over 2560 frames (29.7 s at 22050 Hz and hop 256); MAS one frame past the
# warp kernel's shared memory at T_s = 1024 and 128, at the step's axes and
# past 1024 columns; CTC at text axes of 511, 512, 1024 and 2048 tokens
# (S = 1023, 1025, 2049, 4097)
LONG_B, LONG_T_S, LONG_T_M = 4, 640, 2560
LONG_SRC = (640, 517, 402, 290)
LONG_MEL = (2560, 2103, 1650, 1222)
LONG_MAS_SHAPES = ((2, 1443, 1024), (1, 10307, 128), (2, 2560, 640),
                   (2, 1200, 1100))
LONG_CTC_TEXT = (511, 512, 1024, 2048)
# scatter: float32 sums of up to ~20 rows in another order than the plain
# version's atomics; bfloat16 adds one rounding of the float32 sum on each
# side, which may land on neighbouring values
SCATTER_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# alpha and beta: relative to max(1, |alpha|); ~900 dependent float32
# log-sum-exps whose expf/logf differ from PyTorch's by ulps
CTC_ALPHA_TOL = 2e-5
# gradient: relative to its largest entry; exp(alpha + beta - logL) with
# |alpha| in the thousands turns float32 rounding of the sums (~1e-4
# absolute) into that much relative error
CTC_GRAD_TOL = 5e-3
# relpos: relative to the largest entry of the plain version on the same
# (rounded) inputs; bf16 output and gradients are rounded once (2^-8), the
# sums run in another order
RELPOS_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# the conformer's bf16 stacks through the kernels against the same model
# with the plain relpos (bf16 probabilities and bias there): relative to
# the largest output entry, after 4 (encoder) and 6 (decoder) layers
CONFORMER_TOL = 5e-2
# the reformer's kernels: relative to the largest entry of the plain version
# in float32 on the same (rounded) inputs; bf16 rounds the output and each
# gradient once (2^-8), the sums run in another order
WINDOW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the reformer's bf16 stacks through the kernels against the same model with
# the plain versions on the card and the kernel run's hash sorts: relative to
# the largest output entry, after 6 layers
REFORMER_TOL = 5e-2
# the fused ResBlock1 against its plain version, relative to the largest
# plain entry: both round at the same places (the leaky ReLU, each conv
# after its float32 sum and bias, the residual); only the order of the
# float32 sums differs, so in bf16 a value within float32 rounding of a
# rounding boundary may land on its neighbour (2^-8) and carry through the
# rest of the chain
FUSED_RESBLOCK_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# HiFi-GAN fused against unfused: float32, max |difference| on the tanh
# output (sum order only); bf16, RMS of the difference over RMS of the
# output, since cuDNN's bf16 conv rounds before adding the bias and the
# fused chain after, which moves many values by one bf16 step
VOCODER_F32_TOL = 1e-4
VOCODER_BF16_RMS_TOL = 5e-2
# served PCM (bf16 vocoder), streamed against the full response: RMS of
# the difference over RMS of the full PCM; the window's cuDNN convs may sum
# in another order than the full pass's, and bf16 rounding carries that
SERVE_PCM_RMS_TOL = 5e-2
# resumed against straight train steps on the card: the same weights,
# batches and dropout seeds; cuDNN and embedding backward sums are not
# bitwise reproducible on the card, so the losses agree to float rounding
RESUME_TOL = 1e-3
# the variance configurations in float32 with dropout off, the card against
# the port's CPU path on the same weights and batch: the postnet mel's max
# |difference| over its largest entry, and each loss term relative to its
# CPU value (both through float32 sums in another order, cuDNN's convs and
# the attention kernel's bf16 hi + lo products)
VARIANCE_MEL_TOL = 1e-3
VARIANCE_LOSS_TOL = 1e-4
# the prosody models in float32 with dropout off, the card against the
# port's CPU path as for the variance configurations: the postnet mel, each
# loss term, and the gradient norm (through every backward sum, cuDNN's GRUs
# among them). Sound runs on an H100 read at most 2.52e-6, 1.18e-6 (sdur)
# and 1.16e-5; the same step with TF32 matmuls and convs on the card must
# fail the check (the control)
PROSODY_MEL_TOL = 1e-5
PROSODY_LOSS_TOL = 1e-5
PROSODY_GRAD_NORM_TOL = 5e-5
# the transformer, fastformer and lstransformer models in float32 with
# dropout off, one train_unsup step on the card against the port's CPU path
# on the same weights and batch: the postnet mel's max |difference| over its
# largest entry, and each loss term relative to its CPU value
ZOO_MEL_TOL = 1e-4
ZOO_LOSS_TOL = 1e-4
# the (data, model) grid of two ranks against one process, f32 with dropout
# off: each loss term and the gradient norm relative (the JAX package's
# tests/test_mesh.py tolerance), the parameters after two updates absolute
# (a fresh optimizer's rate is ~2.5e-7, so they hold the running statistics
# more than the update), and the first update's gradients leaf by leaf (the
# optimizer's first moments): each leaf's largest difference relative to
# its largest entry, or to GRID_GRAD_FLOOR times the largest entry of any
# leaf where that is more (a leaf whose gradient is zero but for rounding,
# a conv bias before a BatchNorm in training, holds rounding noise alone)
GRID_LOSS_RTOL = 5e-4
GRID_PARAM_ATOL = 1e-5
GRID_GRAD_RTOL = 1e-3
GRID_GRAD_FLOOR = 1e-3
# model-group peers' own gradients of the replicated parameters, bf16 with
# dropout on, before the optimizer's collectives: the worst leaf by the same
# measure (peers drawing different masks differ by far more: the smoke's
# control step shows by how much)
GRID_PEER_RTOL = 5e-2
# a rank of the grid past this is killed and the phase fails
GRID_TIMEOUT_S = 420


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def demangled(names):
    """The kernels' names without their parameters, through the CUDA
    toolkit's cu++filt; as ptxas gives them where it cannot run."""
    from ctts_torch.ops.kernels import _nvcc
    try:
        out = subprocess.run(
            [os.path.join(os.path.dirname(_nvcc()), "cu++filt"), "-p",
             *names], capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def ptxas_entries():
    """{source: [(kernel, "N registers; spills")]} from the build's ptxas
    report, the kernels named through cu++filt."""
    from ctts_torch.ops.kernels import LIBRARY
    out, src, entry, spill, names = {}, None, None, None, []
    for ln in LIBRARY.ptxas_log.splitlines():
        if ln.startswith("--- "):
            src = ln[4:].strip()
            out[src] = []
        elif "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ", ".join(x.strip() for x in ln.split(",")[1:])
        elif "Used" in ln and entry is not None:
            regs = ln.split("info    : ")[-1].split(",")[0]
            out[src].append([entry, f"{regs}; {spill}"])
            names.append(entry)
            entry = None
    plain = iter(demangled(names))
    for entries in out.values():
        for e in entries:
            e[0] = next(plain)
    return {k: [tuple(e) for e in v] for k, v in out.items()}


def recorded_ms(row):
    """The device-ms cell of a row of PERF.md's kernel table, as written."""
    try:
        with open(os.path.join(REPO, "PERF.md")) as f:
            for ln in f:
                if ln.startswith(f"| {row} | `"):
                    return ln.split("|")[5].strip()
    except OSError:
        pass
    return "not found"


def cuda_ms(fn, warmup=10, iters=100):
    """Mean time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# torch.cuda._sleep's kernel: leading markers open each profile, one closes
# it; a try that loses more than its leading markers retries with more
MARKER = "spin_kernel"
LEADS = (8, 64, 512)
# profiles kept, those of them that lost leading markers, the most lost,
# and profiles rejected after every try
PROFILES = {"whole": 0, "lost_lead": 0, "most_lost": 0, "rejected": 0}


def profiled(body, cpu=False, inner=0, leads=None):
    """Run ``body()`` under torch.profiler between marker kernels, a run of
    leading ones before it and one after. In a process that has taken many
    profiles, each profile loses its first records (PERF.md §7); the
    leading markers are those records, so a profile is kept while at least
    one of them, the ``inner`` markers that ``body`` launches itself and
    the closing one came back. Returns (the device events other than the
    markers, host ms of ``body``, those events cut at the inner markers),
    or None when every try lost more. ``leads``: the tries' leading marker
    counts (``LEADS``); a body that takes part in collectives gets one try,
    since a retry on one rank alone would wait for the others forever."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    for n_lead in leads or LEADS:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(n_lead):
                torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            body()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [MARKER in e.name for e in events]
        lead = marks.index(False) if False in marks else len(marks)
        if lead >= 1 and marks[-1] and sum(marks) == lead + 1 + inner:
            PROFILES["whole"] += 1
            if lead < n_lead:
                PROFILES["lost_lead"] += 1
                PROFILES["most_lost"] = max(PROFILES["most_lost"],
                                            n_lead - lead)
            parts = [[]]
            for e, m in zip(events[lead:-1], marks[lead:-1]):
                if m:
                    parts.append([])
                else:
                    parts[-1].append(e)
            return [e for e, m in zip(events, marks) if not m], wall_ms, parts
        print(f"  (the profile lost {n_lead - lead} of its {n_lead} leading "
              f"markers{'' if marks and marks[-1] else ' and the closing one'}"
              f")")
    PROFILES["rejected"] += 1
    return None


def device_ms(fn, iters=50, only=None):
    """Device time of one call: the summed duration of every kernel the
    profiler (CUPTI) records over ``iters`` calls (of those whose name
    contains ``only``, when given), divided by ``iters``. Unlike CUDA events
    around a stream of calls, it leaves out the gaps in which the device
    waits for the host to launch. A marker kernel follows each call but the
    last, so a record lost inside the run shows: None unless the profile is
    whole (see :func:`profiled`) and every call holds the same positive
    number of kernels."""
    fn()

    def body():
        for i in range(iters):
            fn()
            if i < iters - 1:
                torch.cuda._sleep(1000)

    got = profiled(body, inner=iters - 1)
    if got is None:
        return None
    counts = {len([e for e in part if only is None or only in e.name])
              for part in got[2]}
    if len(counts) != 1 or 0 in counts:
        print(f"  (the profile holds {sorted(counts)} kernels a call)")
        return None
    kernels = [e for e in got[0] if only is None or only in e.name]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters


def timings(fn, iters=50, only=None):
    """(ms, event ms): ms is the device time from a whole profile, else the
    event time; the event time includes launch gaps."""
    ev = cuda_ms(fn, warmup=min(10, iters), iters=2 * iters)
    dev = device_ms(fn, iters=iters, only=only)
    if dev is None:
        print("  (no whole profile: event time used)")
    return (ev if dev is None else dev), ev


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def randn(gen, *shape):
    return torch.randn(*shape, generator=gen)


def row_err(got, ref):
    """max over query rows of max|got - ref| / max|ref| of the row"""
    return ((got.float() - ref).abs().amax(-1)
            / ref.abs().amax(-1).clamp(min=1e-30)).max().item()


class Smoke:
    def __init__(self):
        self.failures = []
        self.kernels = {}
        self.card = None

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception:                                # report, go on
            traceback.print_exc()
            print(f"FAILED: {name}", flush=True)
            self.failures.append(name)
            return None
        finally:
            print(f"   ({name}: {time.perf_counter() - t0:.1f} s)",
                  flush=True)

    # ---- phase 1 ----------------------------------------------------- #
    def build(self):
        from ctts_torch.ops.kernels import LIBRARY
        LIBRARY.get()
        print(f"kernel build: {LIBRARY.build_seconds:.2f} s (nvcc -c per "
              f"source in parallel, one link) → {LIBRARY.target()}")
        # one line per kernel entry: its registers and spills (ptxas -v)
        for src, entries in ptxas_entries().items():
            print(f"  --- {src}")
            for name, text in entries:
                print(f"    {name}: {text}")

    @staticmethod
    def instances(src):
        """Print and return the registers and spills nvcc reported for each
        kernel instance of one source."""
        entries = ptxas_entries().get(src, [])
        for name, text in entries:
            print(f"  nvcc {name}: {text}")
        if not entries:
            print(f"  nvcc: no report for {src} (the library was not built "
                  f"by this process)")
        return {name: text for name, text in entries}

    # ---- phase 2 ----------------------------------------------------- #
    def attention(self):
        from ctts_torch.ops import attention
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(0)
        d = 128
        worst = 0.0
        src_lens, mel_lens = self.train_lengths()
        # the probe's shapes with lengths of every kind (0, 1, ragged,
        # full), then the train step's decoder and encoder
        cases = [(T, [T, T, T - 9, T - 9, T // 2, T // 2 + 1, 1, 0])
                 for T in (96, 1152)]
        cases += [(T_M, np.repeat(mel_lens, 2).tolist()),
                  (T_S, np.repeat(src_lens, 2).tolist())]
        for T, per_row in cases:
            lens = torch.tensor(per_row, dtype=torch.int32, device=dev)
            N = len(per_row)
            q, k, v = (randn(gen, N, T, d).to(dev) for _ in range(3))
            for dtype in (torch.bfloat16, torch.float32):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                got = attention.fused_attention(qd, kd, vd, lens, d ** -0.5)
                again = attention.fused_attention(qd, kd, vd, lens,
                                                  d ** -0.5)
                ref = attention.attention_plain(qd.float(), kd.float(),
                                                vd.float(), lens, d ** -0.5)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item()
                rows = row_err(got, ref)
                ok = err <= ATTN_TOL[dtype] and bool(torch.isfinite(got).all())
                if dtype == torch.bfloat16:
                    ok = ok and rows <= ATTN_ROW_TOL_BF16
                same = torch.equal(got, again)
                print(f"attention N={N} T={T} {str(dtype)[6:]}: max|kernel - "
                      f"plain f32| = {err:.3e} (tol {ATTN_TOL[dtype]:g}), of "
                      f"its row's largest |plain| {rows:.3e}"
                      + (f" (tol {ATTN_ROW_TOL_BF16:g})"
                         if dtype == torch.bfloat16 else "")
                      + f" {'ok' if ok else 'MISMATCH'}; two runs "
                      f"{'bit-identical' if same else 'DIFFER'}")
                if not (ok and same):
                    raise AssertionError(f"attention T={T} {dtype}: {err}, "
                                         f"by row {rows}, two runs equal "
                                         f"{same}")
                worst = max(worst, err)

        man = json.load(open(MANIFEST))["probe"]
        self.instances("attention.cu")
        per_shape = {}
        # the probe's decoder and encoder (4 texts, 2 heads), then the
        # train step's decoder and encoder (16 utterances, 2 heads)
        for what, T, per_utt in (("probe", 1152, man["expect_mel_lens"]),
                                 ("probe", 96, man["src_lens"]),
                                 ("train", T_M, mel_lens),
                                 ("train", T_S, src_lens)):
            lens = torch.tensor(np.repeat(per_utt, 2), dtype=torch.int32,
                                device=dev)
            N = len(lens)
            q, k, v = (randn(gen, N, T, d).to(dev, torch.bfloat16)
                       for _ in range(3))
            scale = d ** -0.5
            add_mask = torch.where(
                torch.arange(T, device=dev)[None, None, :] < lens[:, None, None],
                0.0, attention.NEG).to(torch.bfloat16)
            ms, ev_ms = timings(
                lambda: attention.fused_attention(q, k, v, lens, scale))
            plain_ms, ev_plain = timings(lambda: attention.attention_plain(
                q, k, v, lens, scale))
            lib_ms, ev_lib = timings(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=add_mask, scale=scale))
            # the output depends on the first lengths[n] keys only (a 0 row
            # on all T): q and o over T, k and v up to kv_n, bf16
            kv = [int(x) if x > 0 else T for x in lens.tolist()]
            flops = 4 * d * T * sum(kv)
            nbytes = 2 * N * T * d * 2 + 2 * d * 2 * sum(kv) + N * 4
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            per_shape[what, T] = (ms, plain_ms, lib_ms, b_ms, b_by)
            print(f"attention timing, {what} shape, bf16 N={N} T={T} d={d} "
                  f"lengths={lens.tolist()}: device ms kernel {ms:.4f}, plain "
                  f"{plain_ms:.4f}, sdpa {lib_ms:.4f}; event ms (launch gaps "
                  f"included) kernel {ev_ms:.4f}, plain {ev_plain:.4f}, sdpa "
                  f"{ev_lib:.4f}; bound {b_ms:.5f} ms ({b_by}), the kernel at "
                  f"{b_ms / ms:.3f} of it, {flops / ms / 1e9:.1f} TFLOP/s")
        print(f"attention: PERF.md row 1 records {recorded_ms(1)}")
        ms, plain_ms, lib_ms, b_ms, b_by = per_shape["probe", 1152]
        self.kernels["fused_attention"] = {
            "name": "fused_attention", "route": "cuda",
            "source": "ctts_torch/csrc/attention.cu",
            "replaces": "ctts_tpu/ops/attention.py:41", "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": "bf16 N=8 T=1152 d=128, probe mel lengths"}

    def gather(self):
        from ctts_torch.ops import sort_gather
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(1)
        G, N, M, F = 4, 97, 1152, 256
        idx = torch.randint(0, N, (G, M), generator=gen,
                            dtype=torch.int32).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            vals = randn(gen, G, N, F).to(dev, dtype)
            got = sort_gather.gather_rows(vals, idx)
            ref = sort_gather.gather_rows_plain(vals, idx)
            torch.cuda.synchronize()
            exact = torch.equal(got, ref)
            print(f"gather G={G} N={N} M={M} F={F} {str(dtype)[6:]}: "
                  f"{'bit-exact' if exact else 'MISMATCH'}")
            if not exact:
                raise AssertionError(f"gather {dtype} differs from plain")
        # an index outside [0, N) gives a zero row on both paths
        bad = idx.clone()
        bad[:, :3] = torch.tensor([-1, N, N + 5], dtype=torch.int32)
        got = sort_gather.gather_rows(vals, bad)
        if not (torch.equal(got, sort_gather.gather_rows_plain(vals, bad))
                and not bool(got[:, :3].any())):
            raise AssertionError("gather: out-of-range rows are not zero")
        print("gather out-of-range indices: zero rows, bit-exact")
        # the probe's upsample, the fs2 train step's (x_up and the energy
        # embedding), the reformer default route's sorted-row gather
        per_shape = {}
        for what, dtype, (G, N, M, F) in (
                ("probe", torch.float32, (4, 97, 1152, 256)),
                ("fs2 train step", torch.bfloat16, (16, 129, 896, 256)),
                ("reformer sorted rows", torch.bfloat16, (64, 896, 3584, 256))):
            vals = randn(gen, G, N, F).to(dev, dtype)
            idx = torch.randint(0, N, (G, M), generator=gen,
                                dtype=torch.int32).to(dev)
            if not torch.equal(sort_gather.gather_rows(vals, idx),
                               sort_gather.gather_rows_plain(vals, idx)):
                raise AssertionError(f"gather {what} differs from plain")
            idx_full = idx.long()[..., None].expand(G, M, F).contiguous()
            ms, ev_ms = timings(lambda: sort_gather.gather_rows(vals, idx))
            plain_ms, ev_plain = timings(
                lambda: sort_gather.gather_rows_plain(vals, idx))
            lib_ms, ev_lib = timings(lambda: torch.gather(vals, 1, idx_full))
            nbytes = (G * N * F + G * M * F) * vals.element_size() + G * M * 4
            b_ms, b_by = bound(0, nbytes, PEAK_BF16_FLOPS)
            per_shape[what] = (ms, ev_ms, plain_ms, lib_ms, b_ms, b_by)
            print(f"gather timing, {what}, {str(dtype)[6:]} G={G} N={N} M={M} "
                  f"F={F}: bit-exact; device ms kernel {ms:.4f}, plain "
                  f"{plain_ms:.4f}, torch.gather {lib_ms:.4f}; event ms "
                  f"(launch gaps included) kernel {ev_ms:.4f}, plain "
                  f"{ev_plain:.4f}, torch.gather {ev_lib:.4f}; bound "
                  f"{b_ms:.5f} ms ({b_by}), the kernel at {b_ms / ms:.3f} of "
                  f"it")
        print(f"gather: PERF.md row 2 records {recorded_ms(2)}")
        ms, ev_ms, plain_ms, lib_ms, b_ms, b_by = per_shape["probe"]
        self.kernels["gather_rows"] = {
            "name": "gather_rows", "route": "cuda",
            "source": "ctts_torch/csrc/gather_rows.cu",
            "replaces": "ctts_tpu/ops/sort_gather.py:84", "launches": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": "f32 G=4 N=97 M=1152 F=256",
            "other_shapes": {k: {"ms": v[0], "event_ms": v[1],
                                 "plain_ms": v[2], "library_ms": v[3],
                                 "bound_ms": v[4]}
                             for k, v in per_shape.items() if k != "probe"}}

    # ---- phase 3 ----------------------------------------------------- #
    def probe(self):
        from ctts_torch.config import get_configs_of
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.synthesize import infer_mels
        from ctts_torch.utils.model import get_model
        configs = get_configs_of("LJSpeech")
        print(f"compute_dtype={configs[1]['compute_dtype']}")
        t0 = time.perf_counter()
        model = get_model(0, configs, packed_ckpt=NPZ, device="cuda")
        print(f"model load: {time.perf_counter() - t0:.2f} s")
        man = json.load(open(MANIFEST))["probe"]
        batch = {"speakers": np.zeros(len(man["src_lens"]), np.int64),
                 "texts": np.asarray(man["texts"], np.int64),
                 "src_lens": np.asarray(man["src_lens"], np.int64)}

        def forward():
            out = infer_mels(model, batch, configs,
                             max_mel_len=man["budget"])
            torch.cuda.synchronize()
            return out

        forward()                                      # warm-up
        reset_launch_counts()
        t0 = time.perf_counter()
        out = forward()
        latency = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        repeats = []
        for _ in range(20):
            t0 = time.perf_counter()
            forward()
            repeats.append(time.perf_counter() - t0)
        print(f"launches in the probe forward: {counts}")
        self.breakdown(forward)
        print(f"request latency (4 texts, budget {man['budget']}, host clock "
              f"around a synchronised forward): {latency * 1e3:.2f} ms; 20 "
              f"more: median {np.median(repeats) * 1e3:.2f} ms, min "
              f"{min(repeats) * 1e3:.2f}, max {max(repeats) * 1e3:.2f}")
        for name, n in counts.items():
            self.kernels.setdefault(name, {})["launches"] = n
        if counts != {"fused_attention": 10, "gather_rows": 2}:
            raise AssertionError(f"expected 10 attention and 2 gather "
                                 f"launches per forward, got {counts}")

        mel = out["postnet_mel_predictions"].float().cpu().numpy()
        mel_lens = out["mel_lens"].cpu().numpy()
        want = np.asarray(man["expect_mel_lens"])
        means = [float(mel[i, :mel_lens[i]].mean()) for i in range(len(want))]
        print(f"mel lens {mel_lens.tolist()} (manifest {want.tolist()}); "
              f"means {[round(m, 4) for m in means]} (manifest "
              f"{man['expect_mel_mean']})")
        if not np.isfinite(mel).all():
            raise AssertionError("non-finite mel")
        if not np.all(np.abs(mel_lens - want) <= np.maximum(0.05 * want, 3)):
            raise AssertionError(f"mel lengths {mel_lens} vs {want}")
        for got, exp in zip(means, man["expect_mel_mean"]):
            if abs(got - exp) >= 0.1:
                raise AssertionError(f"mel mean {got} vs {exp}")
        self.probe_out = (out["postnet_mel_predictions"], mel_lens,
                          float(np.median(repeats)), configs)

    @staticmethod
    def breakdown(forward, what="probe forward"):
        """Device time of one call of ``forward`` by kernel, and the
        device's idle share of the host-clock window. Returns (wall ms,
        busy ms, idle share, kernel count)."""
        got = profiled(forward, cpu=True)
        if got is None:
            print(f"{what} under the profiler: no whole profile, device busy "
                  f"not measured")
            return float("nan"), float("nan"), float("nan"), None
        events, wall, _ = got
        per = {}
        for e in events:
            n, us = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in per.values()) / 1e3
        print(f"{what} under the profiler: wall {wall:.2f} ms, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
              f"{sum(n for n, _ in per.values())} kernels")
        ranked = sorted(per.items(), key=lambda kv: -kv[1][1])
        for name, (n, us) in ranked[:12]:
            print(f"  {us / 1e3:8.3f} ms  {n:4d}x  {name[:100]}")
        # below the top 12, the kernels in anonymous namespaces (the port's
        # csrc/*.cu among them, with some of PyTorch's own) and the window
        # engine's
        for name, (n, us) in ranked[12:]:
            if "(anonymous namespace)::" in name or "ctts_window::" in name:
                print(f"  {us / 1e3:8.3f} ms  {n:4d}x  {name[:100]}")
        return wall, busy, 1 - busy / wall, sum(n for n, _ in per.values())

    # ---- phase 4 ----------------------------------------------------- #
    def vocoder(self):
        from ctts_torch.utils.model import get_vocoder, vocoder_infer
        mels, mel_lens, acoustic_s, configs = self.probe_out
        pre, mc, _ = configs
        with tempfile.TemporaryDirectory() as empty:
            name, gen = get_vocoder(mc, ckpt_dir=empty, device="cuda", seed=0)
        assert name == "HiFi-GAN"
        with torch.no_grad():
            wav = gen(mels)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                wav = gen(mels)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        hop = pre["preprocessing"]["stft"]["hop_length"]
        if wav.shape != (mels.shape[0], mels.shape[1] * hop) or \
                not bool(torch.isfinite(wav).all()):
            raise AssertionError(f"vocoder output {tuple(wav.shape)} "
                                 "or non-finite")
        wavs = vocoder_infer(mels, (name, gen), pre, lengths=mel_lens)
        lens = [len(w) for w in wavs]
        if lens != [int(n) * hop for n in mel_lens]:
            raise AssertionError(f"wav lengths {lens} vs mel_len·{hop}")
        voc_s = float(np.median(times))
        sr = pre["preprocessing"]["audio"]["sampling_rate"]
        audio_s = sum(lens) / sr
        print(f"HiFi-GAN V1 (bf16, seeded random weights) on [4, "
              f"{mels.shape[1]}, 80]: {voc_s * 1e3:.2f} ms (median of 5); "
              f"wav lengths {lens}")
        print(f"real-time factor, text→wav, batch of 4: (acoustic "
              f"{acoustic_s * 1e3:.2f} ms + vocoder {voc_s * 1e3:.2f} ms) / "
              f"{audio_s:.2f} s audio = {(acoustic_s + voc_s) / audio_s:.5f}")

    def cli(self):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "ctts_torch.synthesize",
                   "--mode", "single", "--text", "Printing, in the only sense",
                   "--dataset", "LJSpeech", "--packed_ckpt", NPZ,
                   "--vocoder_ckpt", os.path.join(tmp, "none"),
                   "--result_dir", tmp]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                 text=True, timeout=600)
            print(res.stdout.strip()[-800:])
            if res.returncode != 0:
                print(res.stderr[-3000:])
                raise AssertionError(f"synthesize exited {res.returncode}")
            files = sorted(os.listdir(tmp))
            if not any(f.endswith(".wav") for f in files):
                raise AssertionError(f"no wav written: {files}")
            print(f"synthesize CLI: {time.perf_counter() - t0:.1f} s "
                  f"(process start included), wrote {files}")

    # ---- phase 5: the training kernels ---------------------------------- #
    @staticmethod
    def train_lengths():
        """Ragged lengths of the train step's batch, from a seed: B=16,
        T_s=128, T_m=896; one utterance fills each axis."""
        rng = np.random.RandomState(1234)
        src = rng.randint(60, T_S + 1, B_TRAIN).astype(np.int32)
        mel = rng.randint(500, T_M + 1, B_TRAIN).astype(np.int32)
        src[0], mel[0] = T_S, T_M
        return src, mel

    def record(self, name, source, replaces, err, ms, plain_ms, nbytes,
               lib_ms, shape, **extra):
        b_ms, b_by = bound(0, nbytes, PEAK_BF16_FLOPS)
        self.kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "shape": shape, **extra}
        return b_ms

    def scatter(self):
        from ctts_torch.ops import sort_gather
        dev = torch.device("cuda")
        src_lens, mel_lens = self.train_lengths()
        rng = np.random.RandomState(2)
        G, M = B_TRAIN, T_M
        # sorted: a mel2ph map per utterance (1-based token per frame, 0 at
        # padded frames), as the length regulator's backward sees it
        sorted_idx = np.zeros((G, M), np.int32)
        for g in range(G):
            cuts = np.sort(rng.choice(np.arange(1, mel_lens[g]),
                                      src_lens[g] - 1, replace=False))
            sorted_idx[g, :mel_lens[g]] = np.searchsorted(
                cuts, np.arange(mel_lens[g]), side="right") + 1
        perm_idx = np.stack([rng.permutation(M) for _ in range(G)]).astype(
            np.int32)
        worst = 0.0
        for kind, idx_np, n_out in (("sorted", sorted_idx, T_S + 1),
                                    ("permutation", perm_idx, M)):
            idx = torch.from_numpy(idx_np).to(dev)
            for F in (256, 1):
                vals32 = torch.from_numpy(
                    rng.randn(G, M, F).astype(np.float32)).to(dev)
                for dtype in (torch.float32, torch.bfloat16):
                    vals = vals32.to(dtype)
                    got = sort_gather.scatter_rows(vals, idx, n_out)
                    again = sort_gather.scatter_rows(vals, idx, n_out)
                    ref = sort_gather.scatter_rows_plain(vals, idx, n_out)
                    torch.cuda.synchronize()
                    scale = ref.float().abs().max().item()
                    err = (got.float() - ref.float()).abs().max().item()
                    if kind == "permutation":
                        ok, tol = torch.equal(got, ref), "exact"
                    else:
                        rel = SCATTER_TOL[dtype]
                        ok, tol = err <= rel * scale, f"{rel:g} relative"
                    ok = ok and torch.equal(got, again)      # deterministic
                    print(f"scatter {kind} F={F} {str(dtype)[6:]}: max|kernel "
                          f"- plain| = {err:.3e} of {scale:.3f} ({tol}) "
                          f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        raise AssertionError(f"scatter {kind} F={F} {dtype}")
                    if dtype == torch.float32:
                        worst = max(worst, err)
        bad = torch.from_numpy(sorted_idx.copy()).to(dev)
        bad[:, :3] = torch.tensor([-1, T_S + 1, T_S + 9], dtype=torch.int32)
        vals = torch.ones(G, M, 8, device=dev)
        got = sort_gather.scatter_rows(vals, bad, T_S + 1)
        if not torch.equal(got, sort_gather.scatter_rows_plain(
                vals, bad, T_S + 1)):
            raise AssertionError("scatter: an out-of-range index added a row")
        print("scatter out-of-range indices: add nothing, bit-exact")

        # the reformer's shapes: the un-sort (a permutation of M rows,
        # F = d + 1) and the LSH chunk backward's sum (each of N rows 4
        # times, F = 2d), at the train step's G = 64, N = 896, M = 3584
        extra = {}
        G4, N4 = 4 * B_TRAIN, T_M
        for where, idx_np, n_out, F in (
                ("unsort", np.stack([rng.permutation(4 * N4)
                                     for _ in range(G4)]), 4 * N4, 129),
                ("chunk_sum", np.stack([rng.permutation(4 * N4) % N4
                                        for _ in range(G4)]), N4, 256)):
            t = self.scatter_timing(f"the {where} shape", idx_np, n_out, F,
                                    rng)
            extra.update({f"{where}_{key}": v for key, v in t.items()
                          if key != "nbytes"})
        t = self.scatter_timing("the train step's length regulator",
                                sorted_idx, T_S + 1, 256, rng)
        self.record(
            "scatter_rows", "ctts_torch/csrc/scatter_rows.cu",
            "ctts_tpu/ops/sort_gather.py:92", worst, t["ms"], t["plain_ms"],
            t["nbytes"], t["library_ms"],
            f"f32 G={G} M={M} n_out={T_S + 1} F=256, sorted idx", **extra)

    @staticmethod
    def scatter_timing(what, idx_np, n_out, F, rng):
        """The scatter kernel, its plain version and zeros + index_add_ on
        float32 values at one shape, timed; the byte bound beside them."""
        from ctts_torch.ops import sort_gather
        dev = torch.device("cuda")
        G, M = idx_np.shape
        idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
        vals = torch.from_numpy(rng.randn(G, M, F).astype(np.float32)).to(dev)
        flat = (idx.long() + n_out * torch.arange(G, device=dev)[:, None]
                ).reshape(-1)
        ms, ev_ms = timings(lambda: sort_gather.scatter_rows(vals, idx, n_out))
        plain_ms, ev_plain = timings(
            lambda: sort_gather.scatter_rows_plain(vals, idx, n_out))
        lib_ms, ev_lib = timings(lambda: torch.zeros(
            G * n_out, F, device=dev).index_add_(0, flat, vals.view(-1, F)))
        nbytes = G * M * F * 4 + G * M * 4 + G * n_out * F * 4
        b_ms, _ = bound(0, nbytes, PEAK_BF16_FLOPS)
        print(f"scatter timing, {what}, f32 G={G} M={M} n_out={n_out} F={F}: "
              f"device ms kernel {ms:.4f}, plain {plain_ms:.4f}, "
              f"zeros+index_add_ {lib_ms:.4f}; event ms (launch gaps "
              f"included) kernel {ev_ms:.4f}, plain {ev_plain:.4f}, "
              f"index_add_ {ev_lib:.4f}; bound {b_ms:.5f} ms (bytes)",
              flush=True)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "nbytes": nbytes}

    def mas(self):
        from ctts_torch.ops import kernels, mas
        dev = torch.device("cuda")
        src_lens, mel_lens = self.train_lengths()
        gen = torch.Generator().manual_seed(3)
        il = torch.from_numpy(src_lens).to(dev)
        ol = torch.from_numpy(mel_lens).to(dev)
        seeded = torch.softmax(randn(gen, B_TRAIN, T_M, T_S) * 3.0,
                               dim=-1).to(dev)
        ties = torch.full((B_TRAIN, T_M, T_S), 1.0 / T_S, device=dev)
        short = ol.clone()
        short[1], short[2] = 40, 1          # out_len < in_len: end unreachable
        for name, attn, olens in (("seeded", seeded, ol), ("all ties", ties, ol),
                                  ("out_len < in_len", seeded, short)):
            got = mas.b_mas(attn, il, olens)
            ref = mas.b_mas_plain(attn, il, olens)
            torch.cuda.synchronize()
            exact = torch.equal(got, ref)
            frames = int(got.sum().item())
            print(f"MAS {name}: {'bit-exact' if exact else 'MISMATCH'} "
                  f"({frames} path cells, {int(olens.sum())} frames)")
            if not exact:
                raise AssertionError(f"MAS {name} differs from plain")
        # the kernel's logarithm against the wrapper's torch expression
        p = seeded.reshape(-1)
        if not torch.equal(mas.kernel_log(p).view(torch.int32), torch.log(
                torch.clamp(p, min=1e-12)).view(torch.int32)):
            raise AssertionError("MAS: the kernel's log differs from torch's")
        print("MAS log: the kernel's logf(max(p, eps)) is "
              "torch.log(torch.clamp(p, eps)) bit for bit")
        frames = int(mel_lens.max())
        K = mas._lib().ctts_mas_cols_per_lane(T_S)
        ms, ev_ms = timings(lambda: mas.b_mas(seeded, il, ol),
                            only="mas_kernel")
        whole_ms, ev_whole = timings(lambda: mas.b_mas(seeded, il, ol))
        plain_ms, _ = timings(lambda: mas.b_mas_plain(seeded, il, ol), iters=2)
        out_b = torch.empty(B_TRAIN, T_S, device=dev)
        chain_ms, ev_chain = timings(lambda: kernels.barrier_chain(
            out_b, B_TRAIN, T_S, frames))
        out_w = torch.empty(B_TRAIN, 32, device=dev)
        warp_ms, ev_warp = timings(lambda: kernels.warp_chain(
            out_w, B_TRAIN, frames, K))
        # rows at or past out_len are never read; every output row is written
        nbytes = int(mel_lens.sum()) * T_S * 4 + B_TRAIN * T_M * T_S * 4 \
            + 2 * B_TRAIN * 4
        b_ms = self.record(
            "b_mas", "ctts_torch/csrc/mas.cu",
            "ctts_tpu/ops/mas.py:131,174", 0.0, ms, plain_ms, nbytes, None,
            f"f32 B={B_TRAIN} T_m={T_M} T_s={T_S}, ragged lengths",
            event_ms=ev_ms, wrapper_ms=whole_ms, barrier_floor_ms=chain_ms,
            warp_floor_ms=warp_ms)
        print(f"MAS timing B={B_TRAIN} T_m={T_M} T_s={T_S} (K={K}): device ms "
              f"kernel {ms:.4f}, the wrapper {whole_ms:.4f}, plain "
              f"{plain_ms:.3f}; event ms kernel {ev_ms:.4f}, the wrapper "
              f"{ev_whole:.4f}; bound {b_ms:.5f} ms (bytes); barrier-chain "
              f"floor {chain_ms:.4f} (events {ev_chain:.4f}; {frames} frames, "
              f"{T_S} threads); warp-chain floor {warp_ms:.4f} (events "
              f"{ev_warp:.4f}; {frames} frames, one warp, K={K}); the kernel "
              f"{'under' if ms < chain_ms else 'over'} the barrier floor; no "
              f"library call computes it")
        print(f"MAS: PERF.md row 4 records {recorded_ms(4)}")

    def ctc(self):
        import torch.nn.functional as F
        from ctts_torch.ops import forward_sum as fs
        from ctts_torch.ops import kernels
        dev = torch.device("cuda")
        src_lens, mel_lens = self.train_lengths()
        gen = torch.Generator().manual_seed(4)
        il = torch.from_numpy(src_lens).to(dev)
        ol = torch.from_numpy(mel_lens).to(dev)
        logprob = (randn(gen, B_TRAIN, T_M, T_S) * 2.0).to(dev)
        logits = torch.cat([logprob.new_full((B_TRAIN, T_M, 1),
                                             fs.BLANK_LOGPROB), logprob], -1)
        key = torch.arange(T_S + 1, device=dev)[None, None, :]
        logits = fs._log_softmax(torch.where(key <= il[:, None, None], logits,
                                             logits.new_full((), fs.NEG)))
        em = fs._interleave(logits).contiguous()
        S = em.shape[-1]

        def rel_err(got, ref):
            """max |got - ref| / max(1, |ref|) over reachable entries; the
            sentinel entries must be sentinels on both sides."""
            live = ref > -1e8
            if not torch.equal(live, got > -1e8):
                return float("inf")
            d = (got - ref).abs() / ref.abs().clamp(min=1.0)
            return d[live].max().item()

        before = kernels.launch_counts()
        alpha, beta = fs.ctc_lattice(em, il, ol)
        alpha_plain = fs.ctc_alpha_plain(em, ol)
        beta_plain = fs.ctc_beta_plain(em, il, ol)
        alpha64 = fs.ctc_alpha_plain(em.double(), ol)
        beta64 = fs.ctc_beta_plain(em.double(), il, ol)
        torch.cuda.synchronize()
        errs = []
        for what, got, ref, ref64 in (("alpha", alpha, alpha_plain, alpha64),
                                      ("beta", beta, beta_plain, beta64)):
            err = rel_err(got, ref)
            absolute = (got - ref)[ref > -1e8].abs().max().item()
            errs.append((err, absolute))
            print(f"CTC {what} [B={B_TRAIN}, T_m={T_M}, S={S}]: max|kernel - "
                  f"plain| / max(1, |plain|) = {err:.3e} (tol "
                  f"{CTC_ALPHA_TOL:g}; absolute {absolute:.3e} at |{what}| up "
                  f"to {ref[ref > -1e8].abs().max().item():.0f}; bit-exact "
                  f"{torch.equal(got, ref)}); against float64 plain: kernel "
                  f"{rel_err(got.double(), ref64):.3e}, float32 plain "
                  f"{rel_err(ref.double(), ref64):.3e}")
            if not err <= CTC_ALPHA_TOL:
                raise AssertionError(f"ctc_lattice {what}: {err}")

        i2 = 2 * il.long()
        idx = torch.stack([i2, (i2 - 1).clamp(min=0)], 1)
        log_l = torch.logsumexp(alpha_plain[:, -1].gather(1, idx), dim=-1)
        g = (1.0 / (il.float() * B_TRAIN)).contiguous()   # the loss's cotangent
        dem = fs.ctc_grad(alpha_plain, beta_plain, log_l, g, ol)
        dem_plain = fs.ctc_grad_plain(alpha_plain, beta_plain, log_l, g, ol)
        dem64 = fs.ctc_grad_plain(alpha64, beta64, torch.logsumexp(
            alpha64[:, -1].gather(1, idx), -1), g.double(), ol)
        # the whole chain: the kernels' lattices into the kernel's gradient
        log_l_k = torch.logsumexp(alpha[:, -1].gather(1, idx), dim=-1)
        dem_chain = fs.ctc_grad(alpha, beta, log_l_k, g, ol)
        torch.cuda.synchronize()
        scale = dem_plain.abs().max().item()
        g_err = (dem - dem_plain).abs().max().item() / scale
        c_err = (dem_chain - dem_plain).abs().max().item() / scale
        print(f"CTC gradient: max|kernel - plain| = {g_err:.3e} of the "
              f"largest entry {scale:.3e} (tol {CTC_GRAD_TOL:g}; bit-exact "
              f"{torch.equal(dem, dem_plain)}); from the kernels' lattices "
              f"{c_err:.3e}; against float64 plain: kernel chain "
              f"{(dem_chain.double() - dem64).abs().max().item() / scale:.3e}"
              f", float32 plain "
              f"{(dem_plain.double() - dem64).abs().max().item() / scale:.3e}")
        if not (max(g_err, c_err) <= CTC_GRAD_TOL
                and bool(torch.isfinite(dem).all())):
            raise AssertionError(f"ctc_grad: {g_err}, chain {c_err}")
        for b in range(B_TRAIN):
            if bool(dem[b, mel_lens[b]:].any()):
                raise AssertionError("ctc_grad: nonzero past out_len")
        after = kernels.launch_counts()
        if (after["ctc_lattice"] - before["ctc_lattice"],
                after["ctc_grad"] - before["ctc_grad"]) != (1, 2):
            raise AssertionError("ctc: one launch a call expected")

        # the whole loss through the autograd.Function, kernels both ways
        x = logprob.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = fs.forward_sum_loss(x, il, ol)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        lp = F.log_softmax(torch.where(key <= il[:, None, None], torch.cat(
            [logprob.new_full((B_TRAIN, T_M, 1), fs.BLANK_LOGPROB), logprob],
            -1), logprob.new_full((), -1e9)), dim=-1).transpose(0, 1)
        lp = lp.detach().contiguous().requires_grad_(True)
        targets = torch.arange(1, T_S + 1, device=dev).expand(B_TRAIN, T_S)

        def lib_loss():
            return F.ctc_loss(lp, targets, ol.long(), il.long(), blank=0,
                              reduction="mean", zero_infinity=False)

        lib = lib_loss()
        print(f"forward_sum_loss through the kernels {loss.item():.6f}; "
              f"F.ctc_loss on the same inputs {lib.item():.6f}; peak memory "
              f"of the loss's forward and backward {peak / 2**20:.1f} MiB "
              f"(alpha and beta saved: {2 * alpha.numel() * 4 / 2**20:.1f} "
              f"MiB)")
        if abs(loss.item() - lib.item()) > 1e-3 * abs(lib.item()) \
                or not bool(torch.isfinite(x.grad).all()):
            raise AssertionError("forward_sum_loss disagrees with F.ctc_loss")

        ms_l, ev_l = timings(lambda: fs.ctc_lattice(em, il, ol))
        # validation (no gradient) launches the alpha blocks alone
        ms_a, _ = timings(lambda: fs.ctc_lattice(em, il, ol, False))
        plain_l, _ = timings(lambda: (fs.ctc_alpha_plain(em, ol),
                                      fs.ctc_beta_plain(em, il, ol)), iters=2)
        ms_g, ev_g = timings(lambda: fs.ctc_grad(alpha, beta, log_l_k, g, ol))
        plain_g, _ = timings(lambda: fs.ctc_grad_plain(alpha, beta, log_l_k,
                                                       g, ol))
        lib_fwd, _ = timings(lib_loss, iters=10)

        def lib_both():
            lp.grad = None
            lib_loss().backward()

        lib_fb, _ = timings(lib_both, iters=10)
        live = int(mel_lens.sum())
        # the function the Pallas pair computes, not this design: its
        # forward reads em below out_len and writes every alpha row (beta
        # stays on chip in its backward, so writing it here is not counted);
        # the gradient reads two lattices below out_len and writes every row
        bytes_l = live * S * 4 + B_TRAIN * T_M * S * 4 + 2 * B_TRAIN * 4
        bytes_g = 2 * live * S * 4 + B_TRAIN * T_M * S * 4 + 3 * B_TRAIN * 4
        threads = (S + 31) // 32 * 32          # one a state
        chain_ms = kernels.barrier_chain_ms(2 * B_TRAIN, threads,
                                            int(mel_lens.max()))
        shape = f"f32 B={B_TRAIN} T_m={T_M} S={S}, ragged lengths"
        b_l = self.record("ctc_lattice", "ctts_torch/csrc/forward_sum.cu",
                          "ctts_tpu/ops/forward_sum.py:157",
                          max(a for _, a in errs), ms_l, plain_l, bytes_l,
                          lib_fwd, shape, chain_floor_ms=chain_ms)
        b_g = self.record("ctc_grad", "ctts_torch/csrc/forward_sum.cu",
                          "ctts_tpu/ops/forward_sum.py:196", g_err * scale,
                          ms_g, plain_g, bytes_g, lib_fb, shape)
        print(f"CTC timing {shape}: device ms lattice kernel (alpha and beta, "
              f"one launch) {ms_l:.4f}, plain alpha + beta {plain_l:.3f}, "
              f"F.ctc_loss forward {lib_fwd:.4f}, bound {b_l:.5f} (bytes), at "
              f"{b_l / ms_l:.3f} of it; gradient kernel (elementwise) "
              f"{ms_g:.4f}, plain {plain_g:.4f}, bound {b_g:.5f} (bytes), at "
              f"{b_g / ms_g:.3f} of it; lattice + gradient {ms_l + ms_g:.4f} "
              f"against F.ctc_loss forward+backward {lib_fb:.4f}; event ms "
              f"lattice {ev_l:.4f}, gradient {ev_g:.4f}; barrier-chain floor "
              f"of one barrier a frame {chain_ms:.4f} ms ({2 * B_TRAIN} blocks "
              f"of {threads} threads, {int(mel_lens.max())} frames); without "
              f"a gradient (validation) the lattice launches alpha alone: "
              f"{ms_a:.4f}; PERF.md row 5 records {recorded_ms(5)}")

    def attention_backward(self):
        """The attention Function at the decoder's training shape: kernel
        forward against plain, and its recomputing backward against plain
        autograd."""
        from ctts_torch.ops import attention
        dev = torch.device("cuda")
        _, mel_lens = self.train_lengths()
        gen = torch.Generator().manual_seed(5)
        N, d = 2 * B_TRAIN, 128
        lens = torch.from_numpy(np.repeat(mel_lens, 2)).to(dev)
        q, k, v, cot = (randn(gen, N, T_M, d).to(dev, torch.bfloat16)
                        for _ in range(4))
        scale = d ** -0.5
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention.fused_attention(*a, lens, scale)
        out.backward(cot)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        b = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = attention.attention_plain(*b, lens, scale)
        ref.backward(cot)
        torch.cuda.synchronize()
        f_err = (out.float() - ref.float()).abs().max().item()
        g_err = max((x.grad.float() - y.grad.float()).abs().max().item()
                    for x, y in zip(a, b))
        print(f"attention bf16 N={N} T={T_M} d={d}: forward max|kernel - "
              f"plain| = {f_err:.3e} (tol {ATTN_TOL[torch.bfloat16]:g}); "
              f"backward (recompute through plain) max|dq, dk, dv - plain "
              f"autograd| = {g_err:.3e} (tol 1e-2; the same computation); peak "
              f"memory of forward+backward {peak / 2**20:.1f} MiB")
        if f_err > ATTN_TOL[torch.bfloat16] or g_err > 1e-2:
            raise AssertionError(f"attention backward: {f_err}, {g_err}")

    # ---- phase 6: the train step ----------------------------------------- #
    def train(self):
        from ctts_torch.config import get_configs_of
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.checkpoint import load_params_npz
        from ctts_torch.utils.model import get_model
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        configs = get_configs_of("LJSpeech")
        pre, mc, tr = configs
        model = get_model(0, configs, packed_ckpt=NPZ, device="cuda")
        start = int(load_params_npz(NPZ)[1])
        opt, schedule = build_optimizer(model, mc, tr, count=start)
        state = create_train_state(model, opt, step=start,
                                   seed=tr["seed"])
        src_lens, mel_lens = self.train_lengths()
        batch = synth_batch(B=B_TRAIN, T_s=T_S, T_m=T_M, seed=0,
                            src_lens=src_lens, mel_lens=mel_lens, prior=False)
        batch["mels"] = batch["mels"].astype(np.float16)   # transfer_dtype
        batch = batch_to_device(batch, "cuda")
        step = make_train_step(pre, mc, tr, "train_unsup")
        gates = tr["duration"]["binarization_start_steps"], \
            tr["step"]["var_start_steps"]
        print(f"compute_dtype={mc['compute_dtype']}, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
              f"parameters, batch {B_TRAIN}x[{T_S} tokens, {T_M} frames], "
              f"src_lens {src_lens.tolist()}, mel_lens {mel_lens.tolist()}; "
              f"step counter {start}, rate {schedule(start):.3e}; gates: "
              f"binarization {gates[0]}, variance {gates[1]}")

        def one(what):
            return self.counted_step(step, state, batch, what)

        hard = {"fused_attention": 10, "gather_rows": 2, "scatter_rows": 2,
                "b_mas": 1, "ctc_lattice": 1, "ctc_grad": 1}
        totals = []
        for i in range(3):
            metrics, got = one(f"train step {i + 1}/3, hard upsample")
            totals.append(metrics["total"])
            if got != hard:
                raise AssertionError(f"expected launches {hard}, got {got}")
            if i == 0:
                first = got
            if metrics["bin"] != 0 or metrics["pdur"] != 0:
                raise AssertionError("a gate above step 13301 was open")
        if not totals[2] < totals[0]:
            raise AssertionError(f"total did not fall: {totals}")
        print(f"total over the three steps: {totals}")
        for name, n in first.items():
            self.kernels[name]["launches_train_step"] = n
            if self.kernels[name]["launches"] is None:
                self.kernels[name]["launches"] = n

        after = state.step
        state.step = 100                      # below binarization_start_steps
        _, got = one("train step, soft upsample")
        soft = dict(hard, gather_rows=1, scatter_rows=1)
        if got != soft:
            raise AssertionError(f"expected launches {soft}, got {got}")
        state.step = gates[1] + 10000         # above every gate, bin ramp at 1
        metrics, got = one("train step, variance and bin losses on")
        if got != hard:
            raise AssertionError(f"expected launches {hard}, got {got}")
        shut = [k for k in ("bin", "pdur", "sdur", "pitch_C", "pitch_uv",
                            "pitch_f0_mean", "pitch_f0_std", "energy")
                if not metrics[k] > 0]
        if shut:
            raise AssertionError(f"gates open but {shut} are zero")
        state.step = after
        self.unsup_step = self.step_timing(step, state, batch, "train step")

    @staticmethod
    def counted_step(step, state, batch, what):
        """One train step with the launch counters zeroed just before it
        and read just after; fails on a non-finite loss term. Returns
        (metrics, launches)."""
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in launch_counts().items() if v}
        metrics = {k: v.item() for k, v in metrics.items()}
        print(f"{what} (step {state.step}, {ms:.1f} ms): "
              + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        print(f"  launches {got}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{what}: non-finite {bad}")
        return metrics, got

    def step_timing(self, step, state, batch, what):
        """Host clock around 7 synchronised steps, then one step under the
        profiler; prints and returns the step's numbers."""
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()

        def traced():
            step(state, batch)
            torch.cuda.synchronize()

        wall, busy, idle, kernels = self.breakdown(traced, what)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{what}, host clock around a synchronised step: median of "
              f"7 {np.median(times):.2f} ms, min {min(times):.2f}, max "
              f"{max(times):.2f}; under the profiler wall {wall:.2f} ms, "
              f"device busy {busy:.2f} ms, idle share {idle:.3f}; peak "
              f"device memory {peak:.2f} GiB")
        return {"median_ms": float(np.median(times)), "busy_ms": busy,
                "idle": idle, "kernels": kernels, "peak_gib": peak}

    # ---- phase 6b: supervised training and the variance options --------- #
    # the variance configurations: "LJSpeech supervised" with these changes
    VARIANCE_OPTIONS = {
        "a": {"pitch_type": "frame", "energy": "frame_level",
              "dur_loss": "huber"},
        "b": {"pitch_type": "ph", "dur_loss": "mog"},
        "c": {"pitch_type": "frame", "pitch_ar": True, "dur_loss": "crf",
              "ffn_padding": "LEFT"},
        "d": {"cwt_loss": "ssim"}}

    @staticmethod
    def sup_configs(pitch_type="cwt", pitch_ar=False, energy="phoneme_level",
                    dur_loss="mse", ffn_padding="SAME", cwt_loss="l1"):
        """``configs/LJSpeech.yaml`` with ``learn_alignment: False`` ("LJSpeech
        supervised"), with the energy range of no store, and the variance
        options given."""
        from ctts_torch.config import get_configs_of, inject_derived
        from ctts_torch.models.comp_trans_tts import prepare_model_config
        pre, mc, tr = get_configs_of("LJSpeech")
        mc["duration_modeling"]["learn_alignment"] = False
        pitch = pre["preprocessing"]["pitch"]
        pitch.update(pitch_type=pitch_type, pitch_ar=pitch_ar)
        pre["preprocessing"]["energy"]["feature"] = energy
        mc["variance_predictor"]["ffn_padding"] = ffn_padding
        tr["loss"].update(dur_loss=dur_loss, cwt_loss=cwt_loss)
        inject_derived(pre, mc, tr)
        return pre, prepare_model_config(pre, mc), tr

    def sup_batch(self, phone_energy=True, B=None):
        """The train step's seeded batch (``Smoke.train_lengths``) with
        durations drawn to sum to each mel length and ``mel2ph``; the
        first ``B`` utterances (all by default)."""
        from ctts_torch.utils.testing import synth_batch
        src_lens, mel_lens = self.train_lengths()
        B = B or len(src_lens)
        batch = synth_batch(B=B, T_s=T_S, T_m=T_M, seed=0,
                            src_lens=src_lens[:B], mel_lens=mel_lens[:B],
                            prior=False, sup=True, phone_energy=phone_energy)
        assert (batch["durations"].sum(1) == mel_lens[:B]).all()
        return batch

    @staticmethod
    def sup_model(configs, device="cuda"):
        from ctts_torch.models.comp_trans_tts import CompTransTTS
        from ctts_torch.utils.model import init_weights
        pre, mc, tr = configs
        return init_weights(CompTransTTS(pre, mc, tr), tr["seed"]).to(device)

    def sup_train(self):
        """``train_sup`` at full width and depth in bf16 ("LJSpeech
        supervised", seeded weights) on the train step's batch with seeded
        durations: three steps at the schedule's peak rate with the
        counters zeroed before each and read after it, one with the
        variance losses on, then timed steps and one under the profiler,
        printed beside the ``train_unsup`` step of this run."""
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.optimizer import build_optimizer
        configs = pre, mc, tr = self.sup_configs()
        model = self.sup_model(configs)
        start = tr["optimizer"]["warm_up_step"]
        opt, schedule = build_optimizer(model, mc, tr, count=start)
        state = create_train_state(model, opt, step=start, seed=tr["seed"])
        host = self.sup_batch()
        host["mels"] = host["mels"].astype(np.float16)     # transfer_dtype
        batch = batch_to_device(host, "cuda")
        step = make_train_step(pre, mc, tr, "train_sup")
        print(f"LJSpeech supervised: compute_dtype={mc['compute_dtype']}, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
              f"parameters (seeded), batch {B_TRAIN}x[{T_S} tokens, {T_M} "
              f"frames], durations summing to the mel lengths; step counter "
              f"{start}, rate {schedule(start):.3e}")
        want = {"fused_attention": 10, "gather_rows": 2, "scatter_rows": 2}
        totals = []
        for i in range(3):
            metrics, got = self.counted_step(
                step, state, batch, f"supervised train step {i + 1}/3")
            totals.append(metrics["total"])
            if got != want:
                raise AssertionError(f"expected launches {want} (MAS 0, CTC "
                                     f"lattice 0, CTC gradient 0), got {got}")
            if metrics["ctc"] != 0 or metrics["bin"] != 0:
                raise AssertionError("ctc or bin nonzero without alignment")
            if i == 0:
                for name, n in got.items():
                    self.kernels.setdefault(name, {})[
                        "launches_sup_step"] = n
        print(f"supervised launches: attention {got['fused_attention']}, "
              f"gather {got['gather_rows']}, scatter {got['scatter_rows']}, "
              f"MAS 0, CTC lattice 0, CTC gradient 0")
        if not totals[2] < totals[0]:
            raise AssertionError(f"total did not fall: {totals}")
        print(f"supervised total over the three steps: {totals}")
        after = state.step
        state.step = tr["step"]["var_start_steps"] + 1
        metrics, got = self.counted_step(
            step, state, batch, "supervised train step, variance losses on")
        # no silence phoneme in the seeded texts, so no word and no wdur
        shut = [k for k in ("pdur", "sdur", "pitch_C", "pitch_uv",
                            "pitch_f0_mean", "pitch_f0_std", "energy")
                if not metrics[k] > 0]
        if shut or got != want:
            raise AssertionError(f"variance terms {shut} zero, or launches "
                                 f"{got}")
        state.step = after
        sup = self.step_timing(step, state, batch, "supervised train step")
        unsup = getattr(self, "unsup_step", None)
        if unsup:
            print("supervised against unsupervised step, this run: "
                  + "; ".join(f"{k} {sup[k]:.3f} vs {unsup[k]:.3f}"
                              if isinstance(sup[k], float) else
                              f"{k} {sup[k]} vs {unsup[k]}"
                              for k in sup))

    def sup_train_cli(self):
        """``python -m ctts_torch.train`` on a synthetic supervised store
        with "LJSpeech supervised" (bf16, batch 16, the device cache,
        dropout on, the warm-up cut to 50 steps and the variance losses on
        from the start): 8 straight steps, and a resume from their step-4
        checkpoint for steps 5-8, validating every 4 steps; then
        ``python -m ctts_torch.synthesize`` from the step-8 checkpoint on
        the probe texts."""
        from ctts_torch.config import load_yaml
        tmp = tempfile.mkdtemp(prefix="ctts_smoke_sup_")
        try:
            store = os.path.join(tmp, "store")
            self.write_store(store, sup=True)
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["model"]["duration_modeling"]["learn_alignment"] = False
            raw["preprocess"]["path"]["preprocessed_path"] = store
            raw["train"]["optimizer"]["warm_up_step"] = 50
            raw["train"]["step"].update(log_step=1, save_step=4, val_step=4,
                                        var_start_steps=0)
            straight = self.run_train_cli(raw, tmp, "straight", 8)
            self.copy_checkpoint(tmp, 4)
            resumed = self.run_train_cli(raw, tmp, "resumed", 8, restore=4)
            totals = [straight[s]["total"] for s in range(1, 9)]
            bad = [(s, k) for s, r in straight.items() for k, v in r.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite loss terms {bad}")
            print("supervised train CLI total over 8 steps: "
                  + ", ".join(f"{t:.3f}" for t in totals))
            if not np.mean(totals[-2:]) < np.mean(totals[:2]):
                raise AssertionError(f"total did not fall: {totals}")
            if any(straight[s]["ctc"] != 0 or not straight[s]["pdur"] > 0
                   for s in straight):
                raise AssertionError("ctc nonzero or pdur zero in the log")
            diff = max(abs(straight[s][k] - resumed[s][k]) /
                       max(1.0, abs(straight[s][k]))
                       for s in range(5, 9) for k in ("total", "mel", "pdur"))
            print(f"supervised resume from step 4: steps 5-8 total/mel/pdur "
                  f"max relative difference to the straight run {diff:.3e} "
                  f"(tol {RESUME_TOL:g}); launches per step in the log: "
                  f"{straight[3]['launches_per_step']}")
            if diff > RESUME_TOL:
                raise AssertionError(f"resumed losses differ by {diff}")
            want = {"fused_attention": 10, "gather_rows": 2,
                    "scatter_rows": 2}
            if straight[3]["launches_per_step"] != want:
                raise AssertionError(f"CLI launches per step "
                                     f"{straight[3]['launches_per_step']}")
            val = [json.loads(ln) for ln in open(os.path.join(
                tmp, "straight", "log_path", "val", "log.jsonl"))]
            print(f"supervised validation (make_eval_step): "
                  + "; ".join(f"step {r['step']} total {r['total']:.4f} "
                              f"pdur {r['pdur']:.4f}" for r in val))
            if [r["step"] for r in val] != [4, 8] or not all(
                    np.isfinite(r["total"]) for r in val):
                raise AssertionError(f"validation lines {val}")

            # the synthesize CLI on the step-8 checkpoint
            self.save_seed_vocoder(os.path.join(tmp, "ckpt"))
            meta = os.path.join(tmp, "meta.txt")
            self.write_probe_meta(meta)
            out = os.path.join(tmp, "out")
            t0 = time.perf_counter()
            stdout, _ = self.run_synthesize(
                ["--mode", "batch", "--source", meta, "--dataset",
                 "LJSpeech", "--config_dir", os.path.join(tmp, "straight"),
                 "--restore_step", "8",
                 "--vocoder_ckpt", os.path.join(tmp, "ckpt"),
                 "--result_dir", out])
            mels = [np.load(os.path.join(out, f"probe{i}.npy"))
                    for i in range(4)]
            lens = [m.shape[0] for m in mels]
            cap = 2 * raw["model"]["max_seq_len"]
            print(f"synthesize CLI from the supervised step-8 checkpoint: "
                  f"{time.perf_counter() - t0:.1f} s in this process; mel "
                  f"lengths {lens} (budget at most {cap})")
            if not all(np.isfinite(m).all() for m in mels) or not (
                    0 < sum(lens) and max(lens) <= cap):
                raise AssertionError(f"synthesized mels: lengths {lens}")
            if "griffin-lim" in stdout:
                raise AssertionError("the vocoder checkpoint was not loaded")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def variance_options(self):
        """The four variance configurations (``VARIANCE_OPTIONS``) at full
        width with seeded weights: one bf16 ``train_sup`` step (the
        variance losses on) at [16, 128, 896], counted, and one inference
        forward on the probe texts at budget 1152, timed (pitch_ar's
        free-running frame loop also under the profiler). Then each in
        float32 with dropout off, on the card and on the CPU from the same
        weights and batch (the first 4 utterances): the forward's mel
        within VARIANCE_MEL_TOL of its largest entry, and every loss term
        of one step within VARIANCE_LOSS_TOL relative."""
        import copy
        from ctts_torch.parallel.train_step import (_apply, batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.synthesize import infer_mels
        from ctts_torch.utils.optimizer import build_optimizer
        man = json.load(open(MANIFEST))["probe"]
        probe = {"speakers": np.zeros(len(man["src_lens"]), np.int64),
                 "texts": np.asarray(man["texts"], np.int64),
                 "src_lens": np.asarray(man["src_lens"], np.int64)}
        for key, opts in self.VARIANCE_OPTIONS.items():
            configs = pre, mc, tr = self.sup_configs(**opts)
            what = f"variance options ({key}) {opts}"
            phone = pre["preprocessing"]["energy"]["feature"] == \
                "phoneme_level"
            model = self.sup_model(configs)
            start = tr["step"]["var_start_steps"]
            opt, _ = build_optimizer(model, mc, tr, count=start)
            state = create_train_state(model, opt, step=start,
                                       seed=tr["seed"])
            host = self.sup_batch(phone_energy=phone)
            host["mels"] = host["mels"].astype(np.float16)
            step = make_train_step(pre, mc, tr, "train_sup")
            metrics, got = self.counted_step(
                step, state, batch_to_device(host, "cuda"),
                f"{what}: bf16 train step")
            gathers = {"a": 1, "b": 3, "c": 2, "d": 2}[key]
            want = {"fused_attention": 10, "gather_rows": gathers,
                    "scatter_rows": 2 if gathers > 1 else 1}
            if got != want:
                raise AssertionError(f"expected launches {want}, got {got}")

            def forward():
                out = infer_mels(model, probe, configs,
                                 max_mel_len=man["budget"])
                torch.cuda.synchronize()
                return out

            forward()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                out = forward()
                times.append((time.perf_counter() - t0) * 1e3)
            mel = out["postnet_mel_predictions"]
            lens = out["mel_lens"].tolist()
            print(f"{what}: probe forward at budget {man['budget']}: mel "
                  f"lens {lens}, host clock median of 5 "
                  f"{np.median(times):.2f} ms (min {min(times):.2f})")
            if not bool(torch.isfinite(mel).all()) or mel.shape != (
                    4, man["budget"], 80):
                raise AssertionError(f"{what}: mel {tuple(mel.shape)} or "
                                     "non-finite")
            if opts.get("pitch_ar"):
                _, busy, idle, kernels = self.breakdown(
                    forward, "pitch_ar probe forward")
                print(f"pitch_ar inference at budget {man['budget']}: host "
                      f"clock {np.median(times):.2f} ms, device busy "
                      f"{busy:.3f} ms, idle share {idle:.3f}, {kernels} "
                      f"kernels (a host loop of {man['budget']} GRU steps)")

            # float32, dropout off: the card against the port's CPU path
            mc32 = dict(mc, compute_dtype="float32")
            cpu = self.sup_model((pre, mc32, tr), "cpu")
            card = copy.deepcopy(cpu).cuda()
            small = self.sup_batch(phone_energy=phone, B=4)
            outs, comps = [], []
            for m, dev in ((cpu, "cpu"), (card, "cuda")):
                b = batch_to_device(small, dev)
                m.eval()
                with torch.no_grad():
                    outs.append(_apply(m, b, "train_sup", start + 1)[
                        "postnet_mel_predictions"].float().cpu())
                o, _ = build_optimizer(m, mc32, tr, count=start)
                st = create_train_state(m, o, step=start, seed=tr["seed"])
                comps.append({k: v.item() for k, v in make_train_step(
                    pre, mc32, tr, "train_sup", deterministic=True)(
                        st, b).items()})
            mel_err = ((outs[1] - outs[0]).abs().max()
                       / outs[0].abs().max()).item()
            loss_err = {k: abs(comps[1][k] - v) / max(abs(v), 1e-30)
                        for k, v in comps[0].items() if v != 0}
            worst = max(loss_err, key=loss_err.get)
            print(f"{what}: f32, dropout off, card vs CPU at 4x[{T_S}, "
                  f"{T_M}]: mel max err over its largest entry {mel_err:.3e} "
                  f"(tol {VARIANCE_MEL_TOL:g}); loss terms relative, worst "
                  f"{worst} {loss_err[worst]:.3e} (tol {VARIANCE_LOSS_TOL:g})"
                  f"; total {comps[1]['total']:.6f} vs "
                  f"{comps[0]['total']:.6f}")
            zeros = [k for k, v in comps[0].items()
                     if v == 0 and comps[1][k] != 0]
            if mel_err > VARIANCE_MEL_TOL or \
                    loss_err[worst] > VARIANCE_LOSS_TOL or zeros:
                raise AssertionError(f"{what}: card vs CPU {mel_err}, "
                                     f"{loss_err}, {zeros}")


    # ---- phase 7: the relpos kernels ------------------------------------- #
    def relpos(self):
        """Forward and backward kernels against the plain version at every
        shape the main path gives them: the decoder's and the encoder's
        training shapes (B=16, H=8, Dh=32, T=896 and T=128), the probe's
        budget (B=4, T=1152) and its padded text length (T=96), and the
        longest probe text's own length (T=87, as the synthesize CLI's single
        mode gives it; not a multiple of any tile): bf16 and f32, unmasked
        and masked, dropout off and on (one seed for both sides); the same
        at heads of 16 and 64 (B=4, T=87 and 200). Then two backward runs
        at the decoder's training shape, which must agree bit for bit, and
        the times there."""
        from ctts_torch.ops import relpos_attention as ra
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(7)
        H, Dh = 8, 32
        scale = 1.0 / 16.0                       # 1/sqrt(d_model = 256)
        seed = torch.tensor([1234, 5678], dtype=torch.int64, device=dev)
        man = json.load(open(MANIFEST))["probe"]
        B_P, T_P = np.asarray(man["texts"]).shape
        worst = {"fwd": 0.0, "bwd": 0.0, "rel": 0.0}
        # the main path's shapes (heads of 32), then the other head widths
        # the kernels take (d_model 256 in 16 heads of 16 or 4 of 64)
        shapes = [(B, T, H, Dh) for B, T in (
            (B_TRAIN, T_M), (B_TRAIN, T_S), (B_P, man["budget"]), (B_P, T_P),
            (B_P, max(man["src_lens"])))]
        shapes += [(B_P, T, 256 // d, d) for d in (16, 64) for T in (87, 200)]
        for B, T, H, Dh in shapes:
            q, k, v, cot = (randn(gen, B, T, H, Dh).to(dev) for _ in range(4))
            pos = randn(gen, H, T, Dh).to(dev)
            ub, vb = (randn(gen, H, Dh).to(dev) * 0.1 for _ in range(2))
            mask = torch.arange(T, device=dev)[None, :] >= torch.tensor(
                np.linspace(T, T // 2, B).astype(np.int64), device=dev)[:, None]
            for dtype in (torch.bfloat16, torch.float32):
                tol = RELPOS_TOL[dtype]
                for masked in (False, True):
                    for p in (0.0, 0.1):
                        km = mask if masked else None
                        xs = [t.to(dtype) for t in (q, k, v, pos)] + [ub, vb]
                        a = [t.detach().clone().requires_grad_(True)
                             for t in xs]
                        out = ra.relpos_attention(*a, scale, p, torch.Generator(
                            dev).manual_seed(T), km)
                        out.backward(cot.to(dtype))
                        b = [t.detach().float().requires_grad_(True)
                             for t in xs]
                        ref = ra.relpos_attention_plain(
                            *b, scale, p, ra.draw_seed(torch.Generator(
                                dev).manual_seed(T), dev), km)
                        ref.backward(cot.to(dtype).float())
                        torch.cuda.synchronize()
                        pairs = [(out, ref)] + [(s.grad, t.grad)
                                                for s, t in zip(a, b)]
                        absd = [(x.float() - y).abs().max().item()
                                for x, y in pairs]
                        errs = [d / max(y.abs().max().item(), 1e-30)
                                for d, (_, y) in zip(absd, pairs)]
                        ok = max(errs) <= tol and all(
                            bool(torch.isfinite(s.grad).all()) for s in a)
                        print(f"relpos B={B} T={T} Dh={Dh} {str(dtype)[6:]} "
                              f"{'masked' if masked else 'unmasked'} p={p}: "
                              f"max|kernel - plain f32| / max|plain| of o, dq, "
                              f"dk, dv, dpos, du, dv_bias = "
                              + ", ".join(f"{e:.2e}" for e in errs)
                              + f" (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
                        if not ok:
                            raise AssertionError(f"relpos B={B} T={T} Dh={Dh} "
                                                 f"{dtype} masked={masked} p={p}")
                        if dtype == torch.bfloat16 and T == T_M:
                            worst["fwd"] = max(worst["fwd"], absd[0])
                            worst["bwd"] = max(worst["bwd"], max(absd[1:]))
                            worst["rel"] = max(worst["rel"], max(errs))

        # times: bf16 at the decoder's training shape, dropout on (the path)
        H, Dh = 8, 32
        B, T, N = B_TRAIN, T_M, B_TRAIN * H
        shape = f"bf16 B={B} H={H} T={T} Dh={Dh}, dropout 0.1"
        q, k, v, cot = (randn(gen, B, T, H, Dh).to(dev, torch.bfloat16)
                        for _ in range(4))
        pos = randn(gen, H, T, Dh).to(dev, torch.bfloat16)
        ub, vb = (randn(gen, H, Dh).to(dev) * 0.1 for _ in range(2))
        fold = [t.permute(0, 2, 1, 3).reshape(N, T, Dh).contiguous()
                for t in (q, k, v, cot)]
        qf, kf, vf, gf = fold
        o, m, l = ra._launch_fwd(qf, kf, vf, pos, ub, vb, seed, None, scale,
                                 0.1)
        # the backward takes no float atomics: two runs, the same bits
        km = (torch.arange(T, device=dev)[None] < torch.tensor(
            np.linspace(T, T // 2, B).astype(np.int64), device=dev)[:, None]
              ).to(torch.int32).contiguous()
        runs = [ra._launch_bwd(qf, kf, vf, pos, ub, vb, seed, km, gf, o, m, l,
                               scale, 0.1) for _ in range(2)]
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError("relpos backward: two runs differ")
        print(f"relpos backward {shape}, masked: two runs bit-identical")
        del runs
        ms_f, ev_f = timings(lambda: ra._launch_fwd(
            qf, kf, vf, pos, ub, vb, seed, None, scale, 0.1),
            only="relpos_fwd")
        ms_b, ev_b = timings(lambda: ra._launch_bwd(
            qf, kf, vf, pos, ub, vb, seed, None, gf, o, m, l, scale, 0.1),
            only="relpos_bwd")
        whole_b, _ = timings(lambda: ra._launch_bwd(
            qf, kf, vf, pos, ub, vb, seed, None, gf, o, m, l, scale, 0.1))
        plain_f, _ = timings(lambda: ra.relpos_attention_plain(
            q, k, v, pos, ub, vb, scale, 0.1, seed), iters=10)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, pos, ub, vb)]

        def plain_both():
            for t in leaves:
                t.grad = None
            ra.relpos_attention_plain(*leaves, scale, 0.1, seed).backward(cot)

        plain_fb, _ = timings(plain_both, iters=10)
        # the nearest library route: SDPA with the shifted positional score
        # as a float mask (its construction timed apart); no dropout
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))       # [B,H,T,D]

        def rel_mask():
            return ra.relative_shift(torch.einsum(
                "bhqd,hkd->bhqk", qh + vb[None, :, None].to(qh.dtype),
                pos)) * scale

        mask_ms, _ = timings(rel_mask, iters=10)
        rm = rel_mask()
        qu = (qh + ub[None, :, None].to(qh.dtype)).contiguous()
        lib_f, _ = timings(lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, kh, vh, attn_mask=rm, scale=scale), iters=20)
        sd = [t.detach().clone().requires_grad_(True) for t in (qu, kh, vh, rm)]
        cth = cot.transpose(1, 2)

        def lib_both():
            for t in sd:
                t.grad = None
            torch.nn.functional.scaled_dot_product_attention(
                sd[0], sd[1], sd[2], attn_mask=sd[3], scale=scale).backward(cth)

        lib_fb, _ = timings(lib_both, iters=10)
        e2 = N * T * Dh * 2                      # one [N, T, Dh] bf16 tensor
        p2 = H * T * Dh * 2
        bytes_f = 3 * e2 + p2 + e2 + 2 * N * T * 4
        bytes_b = 4 * e2 + p2 + 2 * N * T * 4 + 3 * e2 + p2
        b_f, by_f = bound(6 * N * T * T * Dh, bytes_f, PEAK_BF16_FLOPS)
        b_b, by_b = bound(16 * N * T * T * Dh, bytes_b, PEAK_BF16_FLOPS)
        shape += ", unmasked"
        self.kernels["relpos_fwd"] = {
            "name": "relpos_fwd", "route": "cuda",
            "source": "ctts_torch/csrc/relpos_attention.cu",
            "replaces": "ctts_tpu/ops/relpos_attention.py:161",
            "launches": None, "max_abs_err": worst["fwd"], "ms": ms_f,
            "plain_ms": plain_f, "bound_ms": b_f, "bound_by": by_f,
            "library_ms": lib_f, "shape": shape,
            "library_mask_build_ms": mask_ms}
        self.kernels["relpos_bwd"] = {
            "name": "relpos_bwd", "route": "cuda",
            "source": "ctts_torch/csrc/relpos_attention.cu",
            "replaces": "ctts_tpu/ops/relpos_attention.py:217",
            "launches": None, "max_abs_err": worst["bwd"], "ms": ms_b,
            "plain_ms": plain_fb, "bound_ms": b_b, "bound_by": by_b,
            "library_ms": lib_fb, "shape": shape + "; plain and library "
            "times are forward+backward", "with_wrapper_sums_ms": whole_b}
        print(f"relpos timing {shape}: device ms forward kernel {ms_f:.4f}, "
              f"backward kernel {ms_b:.4f} (with the wrapper's sums "
              f"{whole_b:.4f}); plain forward {plain_f:.4f}, plain "
              f"forward+backward {plain_fb:.4f}; SDPA with the shifted score "
              f"as attn_mask forward {lib_f:.4f}, forward+backward "
              f"{lib_fb:.4f}, the mask's construction {mask_ms:.4f}; event ms "
              f"forward {ev_f:.4f}, backward {ev_b:.4f}; bound forward "
              f"{b_f:.5f} ({by_f}), backward {b_b:.5f} ({by_b}); at this "
              f"shape in bf16 the largest absolute errors: output "
              f"{worst['fwd']:.2e}, gradients {worst['bwd']:.2e}; relative "
              f"to the largest entry {worst['rel']:.2e}")
        print(f"relpos times recorded in PERF.md (§6 row 6; the times "
              f"before the redesign in brackets): {recorded_ms(6)}")

    # ---- phase 8: the conformer forward ------------------------------------ #
    @staticmethod
    def conformer_configs():
        from ctts_torch.config import get_configs_of
        configs = get_configs_of("LJSpeech")
        configs[1]["block_type"] = "conformer"
        return configs

    def conformer_forward(self):
        """``configs/LJSpeech.yaml`` with ``block_type: conformer`` at full
        width and depth (seeded weights; the repo has no trained conformer)
        on the probe texts at budget 1152, bf16: the counted forward, its
        latency, and the same model with the plain relpos on the card."""
        import ctts_torch.models.conformer as conformer
        from ctts_torch.ops import relpos_attention as ra
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.synthesize import infer_mels
        from ctts_torch.utils.model import get_model
        configs = self.conformer_configs()
        model = get_model(0, configs, device="cuda")
        man = json.load(open(MANIFEST))["probe"]
        batch = {"speakers": np.zeros(len(man["src_lens"]), np.int64),
                 "texts": np.asarray(man["texts"], np.int64),
                 "src_lens": np.asarray(man["src_lens"], np.int64)}

        def forward():
            out = infer_mels(model, batch, configs, max_mel_len=man["budget"])
            torch.cuda.synchronize()
            return out

        forward()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = forward()
        latency = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        repeats = []
        for _ in range(20):
            t0 = time.perf_counter()
            forward()
            repeats.append(time.perf_counter() - t0)
        print(f"conformer: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
              f" M parameters, compute_dtype {configs[1]['compute_dtype']}; "
              f"launches in the probe forward: {counts}")
        self.breakdown(forward, "conformer probe forward")
        print(f"conformer request latency (4 texts, budget {man['budget']}): "
              f"{latency * 1e3:.2f} ms; 20 more: median "
              f"{np.median(repeats) * 1e3:.2f} ms, min {min(repeats) * 1e3:.2f}"
              f", max {max(repeats) * 1e3:.2f}")
        want = {"relpos_fwd": 10, "gather_rows": 2}
        if counts != want:
            raise AssertionError(f"expected launches {want}, got {counts}")
        self.kernels["relpos_fwd"]["launches_forward"] = counts["relpos_fwd"]
        mel = out["postnet_mel_predictions"].float()
        lens = out["mel_lens"].cpu().numpy()
        if not bool(torch.isfinite(mel).all()) or mel.shape != (
                4, man["budget"], 80):
            raise AssertionError(f"conformer mel {tuple(mel.shape)} or "
                                 "non-finite")

        # the twin: the same model and inputs with the plain relpos
        texts = torch.as_tensor(batch["texts"], device="cuda")
        src_lens = torch.as_tensor(batch["src_lens"], device="cuda")
        smask = torch.arange(texts.shape[1], device="cuda")[None] >= \
            src_lens[:, None]
        # the decoder on seeded frames whose lengths fill most of the budget
        # (the seeded model's own mel lengths are a few frames, which would
        # leave nearly every compared row zero on both sides)
        budget = man["budget"]
        twin_lens = budget - np.random.RandomState(0).randint(0, budget // 8, 4)
        twin_lens[0] = budget
        with torch.no_grad():
            enc_k, _ = model.encoder(texts, smask)
            dec_in = torch.randn(4, budget, 256, device="cuda",
                                 generator=torch.Generator("cuda").manual_seed(0))
            mmask = torch.arange(budget, device="cuda")[None] >= \
                torch.as_tensor(twin_lens, device="cuda")[:, None]
            dec_k, _ = model.decoder(dec_in, mmask)
            kernel_fn = conformer.relpos_attention

            def plain(q, k, v, pos, ub, vb, scale, dropout_p=0.0,
                      generator=None, key_padding_mask=None,
                      head_range=None):
                return ra.relpos_attention_plain(q, k, v, pos, ub, vb, scale,
                                                 dropout_p, None,
                                                 key_padding_mask, head_range)

            conformer.relpos_attention = plain
            try:
                enc_p, _ = model.encoder(texts, smask)
                dec_p, _ = model.decoder(dec_in, mmask)
                out_p = infer_mels(model, batch, configs,
                                   max_mel_len=man["budget"])
            finally:
                conformer.relpos_attention = kernel_fn
        torch.cuda.synchronize()
        # the predicted log-durations on the valid tokens carry the encoder's
        # output through the duration predictor
        valid = ~smask
        rel = [((x - y).abs().max() / y.abs().max()).item()
               for x, y in ((enc_k, enc_p), (dec_k, dec_p),
                            (out["log_duration_predictions"][valid],
                             out_p["log_duration_predictions"][valid]))]
        lens_p = out_p["mel_lens"].cpu().numpy()
        print(f"conformer kernel path vs plain-relpos twin (bf16): encoder "
              f"output max rel err {rel[0]:.3e}, decoder output {rel[1]:.3e} "
              f"over lengths {twin_lens.tolist()} of {budget}, log-durations "
              f"{rel[2]:.3e} (tol {CONFORMER_TOL:g}); mel lens "
              f"{lens.tolist()} vs {lens_p.tolist()}")
        if max(rel) > CONFORMER_TOL or not np.all(
                np.abs(lens - lens_p) <= np.maximum(0.05 * lens_p, 3)):
            raise AssertionError(f"conformer twin: {rel}, {lens} vs {lens_p}")

    # ---- phase 9: the conformer train CLI ---------------------------------- #
    @staticmethod
    def write_store(root, n_train=64, n_val=8, seed=0, sup=False,
                    speakers=0):
        """A synthetic LJSpeech-shaped ``.npy`` store (75-128 phones,
        500-896 frames of 80 mel bins, CWT pitch, frame energy), in the
        layout ``ctts_torch.data.dataset.Dataset`` reads. ``sup=True``
        writes the ``sup`` store of a forced-aligned corpus instead: the
        same arrays under the ``sup`` names, durations of at least one
        frame summing to each mel length, ``mel2ph``, and phone-level
        energy (the frame energy averaged over each phone's frames).
        ``speakers=n`` writes a VCTK-shaped store: n speakers (p225, ...)
        in turn, 500-1298 frames, ``speakers.json`` and a seeded 512-d
        ``spker_embed/<speaker>-spker_embed.npy`` each."""
        rng = np.random.RandomState(seed)
        names = [f"p{225 + i}" for i in range(speakers)] or ["LJSpeech"]
        t_max = T_VCTK if speakers else T_M
        if speakers:
            os.makedirs(os.path.join(root, "spker_embed"), exist_ok=True)
            for name in names:
                np.save(os.path.join(root, "spker_embed",
                                     f"{name}-spker_embed.npy"),
                        rng.randn(1, 512).astype(np.float32))
        tag = "sup" if sup else "unsup"
        energy_dir = f"energy_{tag}_{'phone' if sup else 'frame'}"
        phones = ("AA1 AE1 AH0 B D EH1 F G HH IY1 K L M N OW1 P R S T UW1 V "
                  "W Z").split()
        for d in (f"mel_{tag}", f"pitch_{tag}", f"f0_{tag}", energy_dir,
                  f"cwt_spec_{tag}", f"f0cwt_mean_std_{tag}") + (
                      ("duration", "mel2ph") if sup else ()):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        lines = []
        for i in range(n_train + n_val):
            base, spk = f"LJ{i:04d}", names[i % len(names)]
            T_s = int(rng.randint(75, T_S + 1))
            T_m = int(rng.randint(500, t_max + 1))
            f0 = (np.abs(rng.randn(T_m)) * 40 + 150).astype(np.float32)
            f0[rng.rand(T_m) < 0.2] = 0.0
            arrays = {
                f"mel_{tag}/{{s}}-mel-{{b}}": (rng.randn(T_m, 80) * 0.5 - 4.0
                                               ).astype(np.float32),
                f"pitch_{tag}/{{s}}-pitch-{{b}}": np.clip(
                    f0 / 4, 1, 255).astype(np.int64),
                f"f0_{tag}/{{s}}-f0-{{b}}": f0,
                f"{energy_dir}/{{s}}-energy-{{b}}": (rng.rand(T_m) * 8 - 1
                                                     ).astype(np.float32),
                f"cwt_spec_{tag}/{{s}}-cwt_spec-{{b}}": rng.randn(
                    T_m, 10).astype(np.float32),
                f"f0cwt_mean_std_{tag}/{{s}}-f0cwt_mean_std-{{b}}": np.array(
                    [5.3, 0.2], np.float32)}
            text = "{" + " ".join(rng.choice(phones, T_s)) + "}"
            lines.append(f"{base}|{spk}|{text}|synthetic")
            if sup:
                dur = rng.multinomial(T_m - T_s, np.ones(T_s) / T_s) + 1
                mel2ph = np.repeat(np.arange(1, T_s + 1), dur)
                key = f"{energy_dir}/{{s}}-energy-{{b}}"
                arrays[key] = (np.bincount(mel2ph - 1, arrays[key], T_s)
                               / dur).astype(np.float32)
                arrays["duration/{s}-duration-{b}"] = dur.astype(np.int64)
                arrays["mel2ph/{s}-mel2ph-{b}"] = mel2ph.astype(np.int64)
            for name, a in arrays.items():
                np.save(os.path.join(root, name.format(s=spk, b=base) + ".npy"),
                        a)
        for split, part in (("train", lines[:n_train]), ("val", lines[n_train:])):
            with open(os.path.join(root, f"{split}_{tag}.txt"), "w") as f:
                f.write("\n".join(part) + "\n")
        with open(os.path.join(root, "speakers.json"), "w") as f:
            json.dump({name: i for i, name in enumerate(names)}, f)
        with open(os.path.join(root, "stats.json"), "w") as f:
            json.dump({"f0_unsup": [214.2, 63.4],
                       "energy_unsup_frame": [-1.17, 9.09, 37.2, 31.7],
                       "f0_sup": [214.3, 64.0],
                       "energy_sup_phone": [-1.43, 8.18, 37.3, 26.0]}, f)

    def conformer_train(self):
        """``python -m ctts_torch.train`` on a synthetic store with the
        conformer config at full width and depth (bf16, batch 16, the
        device cache, dropout on, the warm-up cut to 50 steps so a few
        steps move the loss): 8 straight steps, and a resume from their
        step-4 checkpoint for steps 5-8. Then the same model's steps in this
        process, with the launch counters zeroed just before a step and
        read just after, and one step under the profiler."""
        from ctts_torch.config import load_yaml
        from ctts_torch.data.dataset import Dataset
        from ctts_torch.data.device_cache import DeviceCache, gather_batch
        from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                      prepare_model_config)
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.parallel.train_step import (create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.model import init_weights
        from ctts_torch.utils.optimizer import build_optimizer
        tmp = tempfile.mkdtemp(prefix="ctts_smoke_")
        try:
            store = os.path.join(tmp, "store")
            self.write_store(store)
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["model"]["block_type"] = "conformer"
            raw["preprocess"]["path"]["preprocessed_path"] = store
            raw["train"]["optimizer"]["warm_up_step"] = 50
            raw["train"]["step"].update(log_step=1, save_step=4,
                                        val_step=100000)

            straight = self.run_train_cli(raw, tmp, "straight", 8)
            self.copy_checkpoint(tmp, 4)
            resumed = self.run_train_cli(raw, tmp, "resumed", 8, restore=4)
            totals = [straight[s]["total"] for s in range(1, 9)]
            bad = [(s, k) for s, r in straight.items() for k, v in r.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite loss terms {bad}")
            print(f"train CLI total over 8 steps: "
                  + ", ".join(f"{t:.3f}" for t in totals))
            if not np.mean(totals[-2:]) < np.mean(totals[:2]):
                raise AssertionError(f"total did not fall: {totals}")
            diff = max(abs(straight[s][k] - resumed[s][k]) /
                       max(1.0, abs(straight[s][k]))
                       for s in range(5, 9) for k in ("total", "mel"))
            print(f"resume from step 4: steps 5-8 total/mel max relative "
                  f"difference to the straight run {diff:.3e} (tol "
                  f"{RESUME_TOL:g}); launches per step in the log: "
                  f"{straight[8]['launches_per_step']}")
            if diff > RESUME_TOL:
                raise AssertionError(f"resumed losses differ by {diff}")

            # in process: the same loop pieces, counted and profiled
            pre, mc, tr = (raw["preprocess"], raw["model"], raw["train"])
            from ctts_torch.config import inject_derived
            inject_derived(pre, mc, tr)
            mc = prepare_model_config(pre, mc)
            ds = Dataset("train_unsup.txt", pre, mc, tr, sort=True,
                         drop_last=True)
            cache = DeviceCache(ds, tr["transfer_dtype"])
            cache.put("cuda")
            idx, t_s, t_m = next(cache.index_batches(seed=tr["seed"]))
            batch = gather_batch(cache.arrays, torch.from_numpy(idx).cuda(),
                                 t_s, t_m, False)
            model = init_weights(CompTransTTS(pre, mc, tr),
                                 tr["seed"]).cuda()
            opt, _ = build_optimizer(model, mc, tr, d_model=256)
            state = create_train_state(model, opt, seed=tr["seed"])
            step = make_train_step(pre, mc, tr, "train_unsup")
            step(state, batch)
            torch.cuda.synchronize()
            reset_launch_counts()
            step(state, batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            print(f"conformer train step [{len(idx)}, {t_s} tokens, {t_m} "
                  f"frames], counted in process: launches {counts}")
            want = {"relpos_fwd": 10, "relpos_bwd": 20, "gather_rows": 1,
                    "scatter_rows": 1, "b_mas": 1, "ctc_lattice": 1,
                    "ctc_grad": 1}
            if counts != want:
                raise AssertionError(f"expected launches {want}, got {counts}")
            for name, n in counts.items():
                self.kernels[name].setdefault("launches_conformer_step", n)
            self.kernels["relpos_fwd"]["launches"] = counts["relpos_fwd"]
            self.kernels["relpos_bwd"]["launches"] = counts["relpos_bwd"]
            self.step_timing(step, state, batch, "conformer train step")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ---- phase 10: the reformer's kernels -------------------------------- #
    @staticmethod
    def grad_case(fn, plain, xs, cot, args):
        """Kernel and plain results on the same (rounded) inputs: the kernel
        on ``xs`` in their dtype, the plain version on them upcast to
        float32; both backward from ``cot``. Returns [(kernel, plain)] for
        the output and each input's gradient."""
        a = [t.detach().clone().requires_grad_(True) for t in xs]
        out = fn(*a, *args)
        out.backward(cot.to(out.dtype))
        b = [t.detach().float().requires_grad_(True) for t in xs]
        ref = plain(*b, *args)
        ref.backward(cot.to(out.dtype).float())
        torch.cuda.synchronize()
        return [(out, ref)] + [(s.grad, t.grad) for s, t in zip(a, b)]

    @staticmethod
    def rel_errs(pairs):
        return [(x.float() - y.float()).abs().max().item()
                / max(y.float().abs().max().item(), 1e-30) for x, y in pairs]

    def window_timings(self, what, fwd, bwd, plain, leaves, cot, build, sdpa):
        """bf16 device ms of the forward and backward kernels (the backward
        alone and with its wrapper's torch work), the plain version's
        forward and forward+backward, and SDPA's forward and
        forward+backward on ``build()``'s tensors (whose build is timed
        apart)."""
        ms_f, _ = timings(fwd, only="window_fwd")
        ms_b, _ = timings(bwd, only="window_bwd")
        whole_b, _ = timings(bwd)
        plain_f, _ = timings(lambda: plain(*leaves), iters=10)
        lv = [t.detach().clone().requires_grad_(True) for t in leaves]

        def plain_both():
            for t in lv:
                t.grad = None
            plain(*lv).backward(cot)

        plain_fb, _ = timings(plain_both, iters=10)
        mask_ms, _ = timings(build, iters=10)
        q, k, v, mask = build()
        lib_f, _ = timings(lambda: sdpa(q, k, v, mask), iters=20)
        sv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        gq = torch.ones_like(q)

        def lib_both():
            for t in sv:
                t.grad = None
            sdpa(*sv, mask).backward(gq)

        lib_fb, _ = timings(lib_both, iters=10)
        print(f"  {what} timing bf16: device ms forward kernel {ms_f:.4f}, "
              f"backward kernel {ms_b:.4f} (with the wrapper's torch work "
              f"{whole_b:.4f}); plain forward {plain_f:.4f}, forward+backward "
              f"{plain_fb:.4f}; SDPA forward {lib_f:.4f}, forward+backward "
              f"{lib_fb:.4f}, building its inputs and float mask "
              f"{mask_ms:.4f}")
        return dict(ms_f=ms_f, ms_b=ms_b, whole_b=whole_b, plain_f=plain_f,
                    plain_fb=plain_fb, lib_f=lib_f, lib_fb=lib_fb,
                    mask_ms=mask_ms)

    @staticmethod
    def window_bounds(flops, nbytes, t):
        """(ms, bound_by) of the forward and the backward, printed with
        each kernel's fraction of its bound (bound / device time)."""
        bounds = [bound(f, n, PEAK_BF16_FLOPS) for f, n in zip(flops, nbytes)]
        print(f"  bound forward {bounds[0][0]:.5f} ms ({bounds[0][1]}), "
              f"backward {bounds[1][0]:.5f} ms ({bounds[1][1]}); fraction "
              f"of the bound: forward {bounds[0][0] / t['ms_f']:.4f}, "
              f"backward {bounds[1][0] / t['ms_b']:.4f}")
        return bounds

    @staticmethod
    def identical_runs(what, run):
        """Two backward runs must agree bit for bit (no float atomics)."""
        first, second = run(), run()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"{what}: two backward runs differ")
        print(f"{what}: two backward runs bit-identical")

    def record_window(self, name, source, replaces, err, t, bounds, shape,
                      **extra):
        """The kernels-line entries of one forward/backward kernel pair."""
        (b_f, by_f), (b_b, by_b) = bounds
        for kind, ms, plain_ms, lib_ms, b_ms, by, e in (
                ("fwd", t["ms_f"], t["plain_f"], t["lib_f"], b_f, by_f,
                 err["fwd"]),
                ("bwd", t["ms_b"], t["plain_fb"], t["lib_fb"], b_b, by_b,
                 err["bwd"])):
            self.kernels[f"{name}_{kind}"] = {
                "name": f"{name}_{kind}", "route": "cuda", "source": source,
                "replaces": replaces[kind], "launches": None,
                "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                "shape": shape + ("" if kind == "fwd" else "; plain and "
                                  "library times are forward+backward"),
                "library_mask_build_ms": t["mask_ms"], **extra}
        self.kernels[f"{name}_bwd"]["with_wrapper_ms"] = t["whole_b"]

    def local_window(self):
        """The local-window kernels against the plain version at the shapes
        the reformer's local heads give them (G = batch·4 heads, d=128,
        windows of 128): the probe (G=16, N=128 text and N=1152 frames),
        the train step (G=64, N=128 and 896), and N=1152 with a ragged tail
        of random lengths; bf16 and f32; prefix validity, which leaves whole
        windows padded (at N=128 one row is all padding). Times in bf16 at
        each shape; at the train shape two backward runs, which must agree
        bit for bit."""
        from ctts_torch.ops import local_window_attention as lw
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(11)
        d, win, scale = 128, 128, 128 ** -0.5
        cases = []
        for G, N in ((16, 128), (16, 1152), (64, 128), (64, 896)):
            lens = np.linspace(N, N // 2 + 3, G).astype(np.int64)
            if N == win:
                lens[-1] = 0
            cases.append((f"G={G} N={N}", G, N, lens))
        lens = 1152 - np.random.RandomState(3).randint(0, 127, 16)
        cases.append(("G=16 N=1152 ragged tail", 16, 1152, lens))
        worst = {"fwd": 0.0, "bwd": 0.0}
        for what, G, N, lens in cases:
            qk, v, cot = (randn(gen, G, N, d).to(dev) for _ in range(3))
            valid = torch.arange(N, device=dev)[None] < torch.as_tensor(
                lens, device=dev)[:, None]
            for dtype in (torch.bfloat16, torch.float32):
                before = (lw.launches, lw.bwd_launches)
                pairs = self.grad_case(
                    lw.local_window_attention, lw.local_window_attention_plain,
                    [qk.to(dtype), v.to(dtype)], cot, (valid, win, scale))
                errs = self.rel_errs(pairs)
                tol = WINDOW_TOL[dtype]
                ok = max(errs) <= tol and (lw.launches, lw.bwd_launches) == (
                    before[0] + 1, before[1] + 1)
                print(f"local window {what} {str(dtype)[6:]}: max|kernel - "
                      f"plain f32| / max|plain| of o, dqk, dv = "
                      + ", ".join(f"{e:.2e}" for e in errs)
                      + f" (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"local window {what} {dtype}")
                if dtype == torch.bfloat16:
                    absd = [(x.float() - y).abs().max().item()
                            for x, y in pairs]
                    worst["fwd"] = max(worst["fwd"], absd[0])
                    worst["bwd"] = max(worst["bwd"], max(absd[1:]))

            qkb, vb = qk.to(torch.bfloat16), v.to(torch.bfloat16)
            vi = valid.to(torch.int32)
            o, m, l = lw._launch_fwd(qkb, vb, vi, win, scale)
            g = cot.to(torch.bfloat16)
            W = N // win

            def build():
                q = qkb.reshape(G * W, win, d)
                k = qkb.float()
                k = (k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
                     ).to(torch.bfloat16)

                def windows(x):
                    return x.reshape(G, W, win, *x.shape[2:])

                kk = lw._look_back_padded(windows(k), 0.0).reshape(
                    G * W, 2 * win, d)
                vv = lw._look_back_padded(windows(vb), 0.0).reshape(
                    G * W, 2 * win, d)
                pos = torch.arange(N, device=dev).expand(G, N)
                kt = lw._look_back_padded(windows(pos), -1)[..., None, :]
                qt = windows(pos)[..., :, None]
                ok = windows(valid)[..., :, None] & (lw._look_back_padded(
                    windows(valid), False) & (kt[..., 0, :] >= 0))[..., None, :]
                mask = torch.where(qt == kt, lw.SELF_ATTN_VAL, 0.0)
                mask = torch.where((qt < kt) | ~ok, lw.NEG, mask)
                return q, kk, vv, mask.reshape(G * W, win, 2 * win).to(
                    torch.bfloat16)

            t = self.window_timings(
                f"local window {what}",
                lambda: lw._launch_fwd(qkb, vb, vi, win, scale),
                lambda: lw._launch_bwd(qkb, vb, vi, g, o, m, l, win, scale),
                lambda a, b: lw.local_window_attention_plain(a, b, valid, win,
                                                            scale),
                [qkb, vb], g, build,
                lambda q, k, v, mask: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale))
            # the work the function needs: per valid query the valid keys
            # at or before it in its window and all valid keys of the
            # window before (4d flops each forward, 10d backward); a padded
            # query averages all 2·win values
            vw = valid.reshape(G, W, win)
            prev = torch.cat([torch.zeros_like(vw[:, :1]), vw[:, :-1]], 1)
            live = ((vw.cumsum(-1) + prev.sum(-1, keepdim=True)) * vw).sum()
            n_pad = int((~valid).sum())
            flops = (4 * d * int(live) + 2 * d * 2 * win * n_pad,
                     10 * d * int(live) + 2 * d * 2 * win * n_pad)
            # the function's bytes: qk, v, valid in, o out (bf16); backward
            # qk, v, valid and the bf16 cotangent in, dqk and dv out in f32
            e2, f4, r4 = G * N * d * 2, G * N * d * 4, G * N * 4
            nbytes = (3 * e2 + r4, 3 * e2 + r4 + 2 * f4)
            bounds = self.window_bounds(flops, nbytes, t)
            if (G, N) == (B_TRAIN * 4, T_M):
                self.identical_runs(
                    f"local window bf16 G={G} N={N}",
                    lambda: lw._launch_bwd(qkb, vb, vi, g, o, m, l, win, scale))
                self.record_window(
                    "local_window", "ctts_torch/csrc/local_window_attention.cu",
                    {"fwd": "ctts_tpu/ops/local_window_attention.py:85",
                     "bwd": "ctts_tpu/ops/local_window_attention.py:97"},
                    worst, t, bounds,
                    f"bf16 G={G} N={N} d={d} window {win}, prefix validity "
                    f"{lens.min()}-{lens.max()}")
        self.kernels["local_window_fwd"]["max_abs_err"] = worst["fwd"]
        self.kernels["local_window_bwd"]["max_abs_err"] = worst["bwd"]
        nvcc = self.instances("local_window_attention.cu")
        for kind in ("fwd", "bwd"):
            self.kernels[f"local_window_{kind}"]["nvcc"] = {
                k: v for k, v in nvcc.items() if f"window_{kind}" in k}
        print(f"local window times recorded in PERF.md (§6 row 7; the times "
              f"before the redesign in brackets): {recorded_ms(7)}")

    def lsh_chunk(self):
        """The LSH chunk kernels against the plain version on one hash sort
        at the shapes the reformer's LSH heads give them (G = batch·4 heads,
        d=128, chunks of 64, 4 rounds): the probe's frames (G=16, N=1152,
        M=4608), the train step's frames (G=64, N=896, M=3584) and N=128
        (8 chunks: chunk 0 wraps to the last); bf16 and f32, causal, prefix
        validity; out ‖ lse, then dqk and dv from a random cotangent on both.
        Then times in bf16, and the un-sort and chunk-sum scatters' beside
        zeros + index_add_ on the same indices; at the train shape two
        backward runs, which must agree bit for bit."""
        from ctts_torch.models.reformer import lsh_sort
        from ctts_torch.ops import lsh_chunk_attention as lc
        from ctts_torch.ops import sort_gather
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(12)
        d, cs, nh, scale = 128, 64, 4, 128 ** -0.5
        worst = {"fwd": 0.0, "bwd": 0.0}
        for G, N in ((16, 1152), (64, 896), (16, 128)):
            M = nh * N
            lens = np.linspace(N, N // 2 + 3, G).astype(np.int64)
            qk, v = (randn(gen, G, N, d).to(dev) for _ in range(2))
            qk = qk.to(torch.bfloat16).float()        # one sort for both
            cot = randn(gen, G, M, d + 1).to(dev)
            valid = torch.arange(N, device=dev)[None] < torch.as_tensor(
                lens, device=dev)[:, None]
            rot = randn(gen, 1, d, nh, N // cs // 2).to(dev)
            sticker, st, svalid = lsh_sort(qk, valid, rot, cs, nh)
            for dtype in (torch.bfloat16, torch.float32):
                before = (lc.launches, lc.bwd_launches)
                pairs = self.grad_case(
                    lc.chunk_attention, lc.chunk_attention_plain,
                    [qk.to(dtype), v.to(dtype)], cot,
                    (st, svalid, cs, True, scale))
                (out, ref), grads = pairs[0], pairs[1:]
                errs = self.rel_errs([(out[..., :d], ref[..., :d])] + grads)
                lse_err = ((out[..., d] - ref[..., d]).abs()
                           / ref[..., d].abs().clamp(min=1)).max().item()
                tol = WINDOW_TOL[dtype]
                ok = max(errs) <= tol and lse_err <= 1e-5 and (
                    lc.launches, lc.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
                print(f"LSH chunk G={G} N={N} M={M} {str(dtype)[6:]}: "
                      f"max|kernel - plain f32| / max|plain| of o, dqk, dv = "
                      + ", ".join(f"{e:.2e}" for e in errs)
                      + f" (tol {tol:g}); lse relative to max(1, |lse|) "
                      f"{lse_err:.2e} (tol 1e-5) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"LSH chunk G={G} N={N} {dtype}")
                if dtype == torch.bfloat16:
                    worst["fwd"] = max(worst["fwd"], (
                        out - ref).abs().max().item())
                    worst["bwd"] = max(worst["bwd"], max(
                        (x.float() - y).abs().max().item() for x, y in grads))

            qkb, vb = qk.to(torch.bfloat16), v.to(torch.bfloat16)
            out = lc._launch_fwd(qkb, vb, st, svalid, cs, True, scale)
            C = M // cs

            def build():
                rows = sort_gather.gather_rows(torch.cat([qkb, vb], -1), st)
                q = rows[..., :d].reshape(G * C, cs, d)
                k = rows[..., :d].float()
                k = (k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
                     ).to(torch.bfloat16).reshape(G, C, cs, d)
                kk = lc.look_one_back(k).reshape(G * C, 2 * cs, d)
                vv = lc.look_one_back(rows[..., d:].reshape(G, C, cs, d)
                                      ).reshape(G * C, 2 * cs, d)
                qt = st.reshape(G, C, cs)[..., :, None]
                kt = lc.look_one_back(st.reshape(G, C, cs))[..., None, :]
                sv = svalid.reshape(G, C, cs) > 0
                ok = sv[..., :, None] & lc.look_one_back(sv)[..., None, :]
                mask = torch.where(ok & (qt >= kt), 0.0, lc.NEG)
                mask = torch.where(qt == kt, lc.SELF_ATTN_VAL, mask)
                return q.contiguous(), kk, vv, mask.reshape(
                    G * C, cs, 2 * cs).to(torch.bfloat16)

            t = self.window_timings(
                f"LSH chunk G={G} N={N}",
                lambda: lc._launch_fwd(qkb, vb, st, svalid, cs, True, scale),
                lambda: lc._launch_bwd(qkb, vb, st, svalid, cot, out, cs, True,
                                       scale),
                lambda a, b: lc.chunk_attention_plain(a, b, st, svalid, cs,
                                                      True, scale),
                [qkb, vb], cot, build,
                lambda q, k, v, mask: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale))
            sc_un, _ = timings(lambda: sort_gather.scatter_rows(
                out, sticker, M))
            grows = torch.cat([out[..., :d], out[..., :d]], -1)
            sc_bwd, _ = timings(lambda: sort_gather.scatter_rows(
                grows, st, N))
            # zeros + index_add_ on this sort's indices, the library call
            # for the same two scatters
            base = torch.arange(G, device=dev)[:, None]
            flat_un = (sticker.long() + M * base).reshape(-1)
            flat_bwd = (st.long() + N * base).reshape(-1)
            lib_un, _ = timings(lambda: torch.zeros(
                G * M, d + 1, device=dev).index_add_(
                    0, flat_un, out.reshape(-1, d + 1)))
            lib_bwd, _ = timings(lambda: torch.zeros(
                G * N, 2 * d, device=dev).index_add_(
                    0, flat_bwd, grows.reshape(-1, 2 * d)))
            print(f"  scatter_rows at this shape: the un-sort [G={G}, M={M}, "
                  f"F={d + 1}] f32 → {M} rows {sc_un:.4f} ms (zeros + "
                  f"index_add_ {lib_un:.4f}); the chunk backward's sum "
                  f"[G={G}, M={M}, F={2 * d}] f32 → {N} rows {sc_bwd:.4f} ms "
                  f"(zeros + index_add_ {lib_bwd:.4f})")
            # the work the function needs: per valid sorted query the valid
            # keys of its chunk and the one before at or before it (self and
            # duplicates included); a padded query keeps its own key
            sv = svalid.reshape(G, C, cs) > 0
            bt = st.reshape(G, C, cs)
            live = (sv[..., :, None] & lc.look_one_back(sv)[..., None, :]
                    & (lc.look_one_back(bt)[..., None, :] <= bt[..., :, None])
                    ).sum() + (~sv).sum()
            flops = (4 * d * int(live), 10 * d * int(live))
            # the function's bytes: qk, v (bf16), st, svalid in, out ‖ lse
            # [G, M, d+1] f32 out; backward qk, v, st, svalid, the f32
            # cotangent on out ‖ lse and lse in, [G, N, 2d] f32 out once
            e2, f4, m4 = G * N * d * 2, G * N * d * 4, G * M * 4
            nbytes = (2 * e2 + 2 * m4 + m4 * (d + 1),
                      2 * e2 + 2 * m4 + m4 * (d + 1) + m4 + 2 * f4)
            bounds = self.window_bounds(flops, nbytes, t)
            if (G, N) == (B_TRAIN * 4, T_M):
                self.identical_runs(
                    f"LSH chunk bf16 G={G} N={N} M={M}",
                    lambda: lc._launch_bwd(qkb, vb, st, svalid, cot, out, cs,
                                           True, scale))
                self.record_window(
                    "lsh_chunk", "ctts_torch/csrc/lsh_chunk_attention.cu",
                    {"fwd": "ctts_tpu/ops/lsh_chunk_attention.py:144",
                     "bwd": "ctts_tpu/ops/lsh_chunk_attention.py:158"},
                    worst, t, bounds,
                    f"bf16 G={G} N={N} M={M} d={d} chunks of {cs}, causal, "
                    f"prefix validity {lens.min()}-{lens.max()}",
                    scatter_unsort_ms=sc_un, scatter_bwd_sum_ms=sc_bwd,
                    scatter_unsort_library_ms=lib_un,
                    scatter_bwd_sum_library_ms=lib_bwd)
        self.kernels["lsh_chunk_fwd"]["max_abs_err"] = worst["fwd"]
        self.kernels["lsh_chunk_bwd"]["max_abs_err"] = worst["bwd"]
        nvcc = self.instances("lsh_chunk_attention.cu")
        for kind in ("fwd", "bwd"):
            self.kernels[f"lsh_chunk_{kind}"]["nvcc"] = {
                k: v for k, v in nvcc.items() if f"window_{kind}" in k}
        print(f"LSH chunk times recorded in PERF.md (§6 row 8; the times "
              f"before the redesign in brackets): {recorded_ms(8)}")

    # ---- phase 11: the reformer forward ----------------------------------- #
    @staticmethod
    def reformer_configs():
        from ctts_torch.config import get_configs_of
        configs = get_configs_of("LJSpeech")
        configs[1]["block_type"] = "reformer"
        return configs

    @staticmethod
    def lsh_route(fused):
        os.environ["CTTS_FUSED_LSH"] = "1" if fused else "0"
        return "fused (CTTS_FUSED_LSH=1)" if fused else "default"

    def reformer_forward(self):
        """``configs/LJSpeech.yaml`` with ``block_type: reformer`` at full
        width and depth (seeded weights; the repo has no trained reformer)
        on the probe texts at budget 1152, bf16, on both LSH routes: the
        counted forward, its latency and profile, and the same model with
        the plain versions of every kernel of the stacks on the card, fed
        the kernel run's hash sorts (so that only the attention differs)."""
        import ctts_torch.models.reformer as rf
        from ctts_torch.ops import lsh_chunk_attention as lc
        from ctts_torch.ops import local_window_attention as lw
        from ctts_torch.ops import sort_gather
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.synthesize import infer_mels
        from ctts_torch.utils.model import get_model
        configs = self.reformer_configs()
        model = get_model(0, configs, device="cuda")
        man = json.load(open(MANIFEST))["probe"]
        budget = man["budget"]
        batch = {"speakers": np.zeros(len(man["src_lens"]), np.int64),
                 "texts": np.asarray(man["texts"], np.int64),
                 "src_lens": np.asarray(man["src_lens"], np.int64)}
        texts = torch.as_tensor(batch["texts"], device="cuda")
        src_lens = torch.as_tensor(batch["src_lens"], device="cuda")
        smask = torch.arange(texts.shape[1], device="cuda")[None] >= \
            src_lens[:, None]
        twin_lens = budget - np.random.RandomState(0).randint(0, budget // 8, 4)
        twin_lens[0] = budget
        dec_in = torch.randn(4, budget, 256, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
        mmask = torch.arange(budget, device="cuda")[None] >= \
            torch.as_tensor(twin_lens, device="cuda")[:, None]
        print(f"reformer: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
              f" M parameters, compute_dtype {configs[1]['compute_dtype']}")

        def forward():
            out = infer_mels(model, batch, configs, max_mel_len=budget)
            torch.cuda.synchronize()
            return out

        def stacks_and_forward():
            with torch.no_grad():
                enc, _ = model.encoder(texts, smask)
                dec, _ = model.decoder(dec_in, mmask)
            return enc, dec, infer_mels(model, batch, configs,
                                        max_mel_len=budget)

        plain = {"local_window_attention": lw.local_window_attention_plain,
                 "chunk_attention": lc.chunk_attention_plain,
                 "gather_rows": sort_gather.gather_rows_plain,
                 "scatter_rows": sort_gather.scatter_rows_plain}
        try:
            for fused in (False, True):
                route = self.lsh_route(fused)
                forward()
                reset_launch_counts()
                t0 = time.perf_counter()
                out = forward()
                latency = time.perf_counter() - t0
                counts = {k: v for k, v in launch_counts().items() if v}
                repeats = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    forward()
                    repeats.append(time.perf_counter() - t0)
                print(f"reformer probe forward, {route} route: launches "
                      f"{counts}")
                self.breakdown(forward, f"reformer probe forward ({route})")
                print(f"reformer request latency, {route} route (4 texts, "
                      f"budget {budget}): {latency * 1e3:.2f} ms; 20 more: "
                      f"median {np.median(repeats) * 1e3:.2f} ms, min "
                      f"{min(repeats) * 1e3:.2f}, max {max(repeats) * 1e3:.2f}")
                # 6 encoder + 6 decoder layers; the length regulator gathers
                # twice (frames and the energy embedding)
                want = {"local_window_fwd": 12, "scatter_rows": 12,
                        **({"lsh_chunk_fwd": 12, "gather_rows": 2} if fused
                           else {"gather_rows": 14})}
                if counts != want:
                    raise AssertionError(f"expected launches {want}, got "
                                         f"{counts}")
                tag = "lsh_chunk_fwd" if fused else "local_window_fwd"
                self.kernels[tag]["launches"] = counts[tag]
                self.kernels["local_window_fwd"][
                    f"launches_forward_{'fused' if fused else 'default'}"] = \
                    counts["local_window_fwd"]
                mel = out["postnet_mel_predictions"].float()
                if not bool(torch.isfinite(mel).all()) or mel.shape != (
                        4, budget, 80):
                    raise AssertionError(f"reformer mel {tuple(mel.shape)} "
                                         "or non-finite")

                # the twin: record the kernel path's sorts, replay them
                sorts, orig_sort = [], rf.lsh_sort

                def record(*a):
                    sorts.append(orig_sort(*a))
                    return sorts[-1]

                rf.lsh_sort = record
                try:
                    enc_k, dec_k, out_k = stacks_and_forward()
                finally:
                    rf.lsh_sort = orig_sort
                replay = iter(sorts)
                kernel_fns = {n: getattr(rf, n) for n in plain}
                rf.lsh_sort = lambda *a: next(replay)
                for n, fn in plain.items():
                    setattr(rf, n, fn)
                try:
                    enc_p, dec_p, out_p = stacks_and_forward()
                finally:
                    rf.lsh_sort = orig_sort
                    for n, fn in kernel_fns.items():
                        setattr(rf, n, fn)
                torch.cuda.synchronize()
                valid = ~smask
                rel = [((x - y).abs().max() / y.abs().max()).item()
                       for x, y in ((enc_k, enc_p), (dec_k, dec_p),
                                    (out_k["log_duration_predictions"][valid],
                                     out_p["log_duration_predictions"][valid]))]
                lens_k = out_k["mel_lens"].cpu().numpy()
                lens_p = out_p["mel_lens"].cpu().numpy()
                print(f"reformer kernel path ({route}) vs the plain twin "
                      f"on the same sorts (bf16): encoder output max rel err "
                      f"{rel[0]:.3e}, decoder output {rel[1]:.3e} over "
                      f"lengths {twin_lens.tolist()} of {budget}, "
                      f"log-durations {rel[2]:.3e} (tol {REFORMER_TOL:g}); "
                      f"mel lens {lens_k.tolist()} vs {lens_p.tolist()}")
                if max(rel) > REFORMER_TOL or not np.all(
                        np.abs(lens_k - lens_p) <= np.maximum(0.05 * lens_p, 3)):
                    raise AssertionError(f"reformer twin ({route}): {rel}, "
                                         f"{lens_k} vs {lens_p}")
        finally:
            os.environ.pop("CTTS_FUSED_LSH", None)

    # ---- phase 12: reformer training ------------------------------------ #
    @staticmethod
    def run_synthesize(argv):
        """``python -m ctts_torch.synthesize`` with ``argv``, through its
        ``main`` in this process (no second process start, ~10 s on the
        card machine); returns its standard output and error."""
        from ctts_torch.synthesize import main
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
        return out.getvalue(), err.getvalue()

    @staticmethod
    def copy_checkpoint(tmp, step, src="straight", dst="resumed"):
        """Run ``src``'s checkpoint of ``step`` into run ``dst``'s checkpoint
        directory, where ``run_train_cli(..., dst, restore=step)`` resumes
        from it."""
        ckpt = os.path.join(tmp, dst, "ckpt_path")
        os.makedirs(ckpt, exist_ok=True)
        shutil.copy(os.path.join(tmp, src, "ckpt_path", f"{step}.pth.tar"),
                    ckpt)

    def run_train_cli(self, raw, tmp, name, max_steps, restore=0,
                      dataset="LJSpeech", extra=()):
        """``python -m ctts_torch.train`` with the merged config ``raw``
        under ``tmp/name`` and the arguments ``extra``; returns its log
        lines by step."""
        from ctts_torch.config import dump_yaml
        cfg_dir = os.path.join(tmp, name)
        os.makedirs(cfg_dir, exist_ok=True)
        raw["train"]["path"] = {k: os.path.join(cfg_dir, k)
                                for k in ("ckpt_path", "log_path",
                                          "result_path")}
        with open(os.path.join(cfg_dir, f"{dataset}.yaml"), "w") as f:
            f.write(dump_yaml(raw))
        cmd = [sys.executable, "-m", "ctts_torch.train", "--dataset",
               dataset, "--config_dir", cfg_dir, "--max_steps",
               str(max_steps), "--restore_step", str(restore), *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        self.cli_stdout = res.stdout
        print(f"$ python -m ctts_torch.train ... --max_steps {max_steps} "
              f"--restore_step {restore} ({time.perf_counter() - t0:.1f} s)")
        print("\n".join("  " + ln for ln in
                        res.stdout.strip().splitlines()[-12:]))
        if res.returncode != 0:
            print(res.stderr[-3000:])
            raise AssertionError(f"train CLI exited {res.returncode}")
        path = os.path.join(cfg_dir, "log_path", "train", "log.jsonl")
        return {r["step"]: r for r in map(json.loads, open(path))}

    def reformer_train(self):
        """``python -m ctts_torch.train`` on a synthetic store with the
        reformer config at full width and depth (bf16, batch 16, dropout
        on, the warm-up cut to 50 steps): 6 straight steps, and a resume
        from their step-3 checkpoint for steps 4-6. Then ``train_unsup``
        steps in this process at [16, 128 tokens, 896 frames] (the soft
        upsample regime) on both LSH routes, with the launch counters zeroed
        just before a step and read just after, the step's host time and
        one step under the profiler."""
        from ctts_torch.config import load_yaml
        from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                      prepare_model_config)
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.model import init_weights
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        tmp = tempfile.mkdtemp(prefix="ctts_smoke_")
        try:
            store = os.path.join(tmp, "store")
            self.write_store(store)
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["model"]["block_type"] = "reformer"
            raw["preprocess"]["path"]["preprocessed_path"] = store
            raw["train"]["optimizer"]["warm_up_step"] = 50
            raw["train"]["step"].update(log_step=1, save_step=3,
                                        val_step=100000)
            straight = self.run_train_cli(raw, tmp, "straight", 6)
            self.copy_checkpoint(tmp, 3)
            resumed = self.run_train_cli(raw, tmp, "resumed", 6, restore=3)
            totals = [straight[s]["total"] for s in range(1, 7)]
            bad = [(s, k) for s, r in straight.items() for k, v in r.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite loss terms {bad}")
            print("reformer train CLI total over 6 steps: "
                  + ", ".join(f"{t:.3f}" for t in totals))
            if not np.mean(totals[-2:]) < np.mean(totals[:2]):
                raise AssertionError(f"total did not fall: {totals}")
            diff = max(abs(straight[s][k] - resumed[s][k]) /
                       max(1.0, abs(straight[s][k]))
                       for s in range(4, 7) for k in ("total", "mel"))
            print(f"resume from step 3: steps 4-6 total/mel max relative "
                  f"difference to the straight run {diff:.3e} (tol "
                  f"{RESUME_TOL:g}); launches per step in the log: "
                  f"{straight[6]['launches_per_step']}")
            if diff > RESUME_TOL:
                raise AssertionError(f"resumed losses differ by {diff}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        pre, mc, tr = self.reformer_configs()
        mc = prepare_model_config(pre, mc)
        src_lens, mel_lens = self.train_lengths()
        batch = synth_batch(B=B_TRAIN, T_s=T_S, T_m=T_M, seed=0,
                            src_lens=src_lens, mel_lens=mel_lens, prior=False)
        batch["mels"] = batch["mels"].astype(np.float16)   # transfer_dtype
        batch = batch_to_device(batch, "cuda")
        try:
            for fused in (False, True):
                route = self.lsh_route(fused)
                model = init_weights(CompTransTTS(pre, mc, tr),
                                     tr["seed"]).cuda()
                opt, _ = build_optimizer(model, mc, tr, d_model=256)
                state = create_train_state(model, opt, seed=tr["seed"])
                step = make_train_step(pre, mc, tr, "train_unsup")
                step(state, batch)
                torch.cuda.synchronize()
                reset_launch_counts()
                metrics = step(state, batch)
                torch.cuda.synchronize()
                counts = {k: v for k, v in launch_counts().items() if v}
                print(f"reformer train step [{B_TRAIN}, {T_S} tokens, {T_M} "
                      f"frames], {route} route, counted in process: "
                      f"total={metrics['total'].item():.4f}; launches "
                      f"{counts}")
                # per layer the un-sort scatter and its gather backward;
                # default: the sorted-row gather and its scatter backward;
                # fused: the chunk kernels and the backward's row sum (a
                # scatter); the length regulator's gather and scatter once
                lsh = ({"lsh_chunk_fwd": 12, "lsh_chunk_bwd": 12,
                        "gather_rows": 13, "scatter_rows": 25} if fused
                       else {"gather_rows": 25, "scatter_rows": 25})
                want = {"local_window_fwd": 12, "local_window_bwd": 12,
                        "b_mas": 1, "ctc_lattice": 1, "ctc_grad": 1, **lsh}
                if counts != want:
                    raise AssertionError(f"expected launches {want}, got "
                                         f"{counts}")
                if not np.isfinite(metrics["total"].item()):
                    raise AssertionError("non-finite total")
                key = "fused" if fused else "default"
                for name, n in counts.items():
                    self.kernels[name].setdefault(
                        f"launches_reformer_step_{key}", n)
                self.kernels["local_window_bwd"]["launches"] = \
                    counts["local_window_bwd"]
                if fused:
                    self.kernels["lsh_chunk_bwd"]["launches"] = \
                        counts["lsh_chunk_bwd"]
                self.step_timing(step, state, batch,
                                 f"reformer train step ({route})")
                del model, opt, state
        finally:
            os.environ.pop("CTTS_FUSED_LSH", None)


    # ---- phase 12b: the rest of the block zoo and the VCTK recipe ------- #
    ZOO = ("transformer", "fastformer", "lstransformer")

    def block_zoo(self):
        """Each block of ``ZOO`` in ``configs/LJSpeech.yaml`` with only
        ``block_type`` changed (full width and depth, bf16, seeded weights;
        the repo has no trained weights for them): the probe forward at
        budget 1152 (counted, median of 20, profiled); one counted bf16
        ``train_unsup`` step at [16, 128, 896] with ``Smoke.train_lengths``
        in the hard-upsample regime, then timed and profiled; and one
        float32 step with dropout off on the card and on the CPU at [4, 128,
        896], every loss term and the mel held to the CPU's."""
        import copy
        from ctts_torch.config import get_configs_of
        from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                      prepare_model_config)
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.parallel.train_step import (_apply, batch_to_device,
                                                    create_train_state,
                                                    make_train_step,
                                                    prep_batch)
        from ctts_torch.synthesize import infer_mels
        from ctts_torch.utils.model import get_model, init_weights
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        man = json.load(open(MANIFEST))["probe"]
        probe = {"speakers": np.zeros(len(man["src_lens"]), np.int64),
                 "texts": np.asarray(man["texts"], np.int64),
                 "src_lens": np.asarray(man["src_lens"], np.int64)}
        src_lens, mel_lens = self.train_lengths()
        host = synth_batch(B=B_TRAIN, T_s=T_S, T_m=T_M, seed=0,
                           src_lens=src_lens, mel_lens=mel_lens, prior=False)
        host["mels"] = host["mels"].astype(np.float16)     # transfer_dtype
        batch = batch_to_device(host, "cuda")
        small = {mode: synth_batch(
            B=4, T_s=T_S, T_m=T_M, seed=0, src_lens=src_lens[:4],
            mel_lens=mel_lens[:4], prior=False, sup=mode == "train_sup",
            phone_energy=mode == "train_sup")
            for mode in ("train_unsup", "train_sup")}
        for block in self.ZOO:
            pre, mc, tr = get_configs_of("LJSpeech")
            mc["block_type"] = block
            configs = (pre, mc, tr)
            attn = {"fused_attention": 10} if block == "transformer" else {}
            model = get_model(0, configs, device="cuda")

            def forward():
                out = infer_mels(model, probe, configs,
                                 max_mel_len=man["budget"])
                torch.cuda.synchronize()
                return out

            forward()
            reset_launch_counts()
            out = forward()
            counts = {k: v for k, v in launch_counts().items() if v}
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                forward()
                times.append((time.perf_counter() - t0) * 1e3)
            _, busy, idle, kernels = self.breakdown(
                forward, f"{block} probe forward")
            mel = out["postnet_mel_predictions"]
            print(f"{block}: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
                  f" M parameters, bf16; probe forward at budget "
                  f"{man['budget']}: launches {counts}; median of 20 "
                  f"{np.median(times):.2f} ms (min {min(times):.2f}, max "
                  f"{max(times):.2f}); device busy {busy:.3f} ms, idle share "
                  f"{idle:.3f}, {kernels} kernels; mel lens "
                  f"{out['mel_lens'].tolist()}")
            want = {**attn, "gather_rows": 2}
            if counts != want:
                raise AssertionError(f"{block} forward: expected launches "
                                     f"{want}, got {counts}")
            if not bool(torch.isfinite(mel).all()) or mel.shape != (
                    4, man["budget"], 80):
                raise AssertionError(f"{block}: mel {tuple(mel.shape)} or "
                                     "non-finite")
            for name, n in counts.items():
                self.kernels[name].setdefault(f"launches_{block}_forward", n)

            # bf16 train step, hard upsample
            mc = prepare_model_config(pre, mc)
            start = tr["duration"]["binarization_start_steps"]
            opt, _ = build_optimizer(model, mc, tr, count=start)
            state = create_train_state(model, opt, step=start,
                                       seed=tr["seed"])
            step = make_train_step(pre, mc, tr, "train_unsup")
            step(state, batch)
            torch.cuda.synchronize()
            _, got = self.counted_step(step, state, batch,
                                       f"{block} train step")
            want = {**attn, "gather_rows": 2, "scatter_rows": 2, "b_mas": 1,
                    "ctc_lattice": 1, "ctc_grad": 1}
            if got != want:
                raise AssertionError(f"{block} step: expected launches "
                                     f"{want}, got {got}")
            for name, n in got.items():
                self.kernels[name].setdefault(f"launches_{block}_step", n)
            self.step_timing(step, state, batch, f"{block} train step")
            del model, opt, state, step
            torch.cuda.empty_cache()

            # float32, dropout off: the card against the port's CPU path
            mc32 = dict(mc, compute_dtype="float32")
            cpu = init_weights(CompTransTTS(pre, mc32, tr), tr["seed"])
            card = copy.deepcopy(cpu).cuda()
            outs, comps = {}, []
            for m, dev in ((cpu, "cpu"), (card, "cuda")):
                m.eval()
                for mode, host_b in small.items():
                    b = prep_batch(batch_to_device(host_b, dev), pre, mode)
                    with torch.no_grad():
                        o = _apply(m, b, mode, start + 1)
                    outs.setdefault(mode, []).append(
                        (o["postnet_mel_predictions"].float().cpu(),
                         o["mel2ph"].cpu()))
                o, _ = build_optimizer(m, mc32, tr, count=start)
                st = create_train_state(m, o, step=start, seed=tr["seed"])
                comps.append({k: v.item() for k, v in make_train_step(
                    pre, mc32, tr, "train_unsup", deterministic=True)(
                        st, batch_to_device(small["train_unsup"],
                                            dev)).items()})
            errs = {mode: ((c[0] - p[0]).abs().max() / p[0].abs().max())
                    .item() for mode, (p, c) in outs.items()}
            p, c = outs["train_unsup"]
            moved = int((p[1] != c[1]).sum())
            loss_err = {k: abs(comps[1][k] - v) / max(abs(v), 1e-30)
                        for k, v in comps[0].items() if v != 0}
            worst = max(loss_err, key=loss_err.get)
            zeros = [k for k, v in comps[0].items()
                     if v == 0 and comps[1][k] != 0]
            print(f"{block}: f32, dropout off, card vs CPU at 4x[{T_S}, "
                  f"{T_M}]: mel max err over its largest entry, the batch's "
                  f"durations (train_sup forward) {errs['train_sup']:.3e}, "
                  f"MAS durations (train_unsup forward) "
                  f"{errs['train_unsup']:.3e} with {moved} of "
                  f"{int(mel_lens[:4].sum())} frames on another token "
                  f"(tol {ZOO_MEL_TOL:g}, the second only where no frame "
                  f"moved); train_unsup step's loss terms relative: "
                  + ", ".join(f"{k} {e:.2e}" for k, e in loss_err.items())
                  + f" (tol {ZOO_LOSS_TOL:g}); total {comps[1]['total']:.6f}"
                  f" vs {comps[0]['total']:.6f}")
            if errs["train_sup"] > ZOO_MEL_TOL or (
                    not moved and errs["train_unsup"] > ZOO_MEL_TOL) \
                    or loss_err[worst] > ZOO_LOSS_TOL or zeros:
                raise AssertionError(f"{block}: card vs CPU {errs}, moved "
                                     f"{moved}, {loss_err}, {zeros}")
            del cpu, card
            torch.cuda.empty_cache()

    @staticmethod
    def vctk_configs():
        from ctts_torch.config import get_configs_of
        from ctts_torch.models.comp_trans_tts import prepare_model_config
        pre, mc, tr = get_configs_of("VCTK")
        return pre, prepare_model_config(pre, mc), tr

    @staticmethod
    def vctk_lengths():
        """Ragged lengths of the VCTK step's batch, from a seed: B=16,
        T_s=128, T_m=1298 (VCTK's longest utterance); one utterance fills
        each axis."""
        rng = np.random.RandomState(T_VCTK)
        src = rng.randint(75, T_S + 1, B_TRAIN).astype(np.int32)
        mel = rng.randint(500, T_VCTK + 1, B_TRAIN).astype(np.int32)
        src[0], mel[0] = T_S, T_VCTK
        return src, mel

    def vctk_train_cli(self):
        """``python -m ctts_torch.train --dataset VCTK`` with
        ``configs/VCTK.yaml``'s model as shipped (``transformer_fs2`` 4 + 6,
        hidden 256, bf16, external 512-d speaker embeddings; seeded weights)
        on a synthetic store of 8 speakers (``write_store(speakers=8)``:
        64 + 8 utterances, 500-1298 frames), batch 16, the device cache,
        the warm-up cut to 50, the variance losses on: 6 steps validating
        and saving at 3 and 6, then steps 4-6 again resumed from the step-3
        checkpoint. The store, a lexicon of the probe texts and the runs
        stay for the synthesize phase."""
        from ctts_torch.config import load_yaml
        tmp = self.vctk_tmp = tempfile.mkdtemp(prefix="ctts_smoke_vctk_")
        atexit.register(shutil.rmtree, tmp, True)
        store = os.path.join(tmp, "store")
        self.write_store(store, speakers=8)
        raw = load_yaml(open(os.path.join(REPO, "configs", "VCTK.yaml")))
        raw["preprocess"]["path"].update(
            preprocessed_path=store,
            lexicon_path=os.path.join(tmp, "lexicon.txt"))
        self.probe_lexicon(os.path.join(tmp, "lexicon.txt"))
        raw["train"]["optimizer"]["warm_up_step"] = 50
        # the variance losses on from the start, so that the duration head
        # the synthesize phase runs has trained
        raw["train"]["step"].update(log_step=1, save_step=3, val_step=3,
                                    var_start_steps=0)
        straight = self.run_train_cli(raw, tmp, "straight", 6,
                                      dataset="VCTK")
        cached = "device cache:" in self.cli_stdout
        self.copy_checkpoint(tmp, 3)
        resumed = self.run_train_cli(raw, tmp, "resumed", 6, restore=3,
                                     dataset="VCTK")
        totals = [straight[s]["total"] for s in range(1, 7)]
        bad = [(s, k) for s, r in straight.items() for k, v in r.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if bad or not cached:
            raise AssertionError(f"non-finite loss terms {bad}, device cache "
                                 f"used {cached}")
        diff = max(abs(straight[s][k] - resumed[s][k])
                   / max(1.0, abs(straight[s][k]))
                   for s in (4, 5, 6) for k in ("total", "mel", "ctc", "pdur"))
        val = [json.loads(ln) for ln in open(os.path.join(
            tmp, "straight", "log_path", "val", "log.jsonl"))]
        launches = [straight[s]["launches_per_step"] for s in range(1, 7)]
        print(f"VCTK train CLI (device cache used): total over 6 steps "
              + ", ".join(f"{t:.3f}" for t in totals)
              + f"; resumed from step 3: steps 4-6 total/mel/ctc/pdur max "
              f"relative difference {diff:.3e} (tol {RESUME_TOL:g}); "
              f"validation " + "; ".join(f"step {r['step']} total "
                                         f"{r['total']:.4f}" for r in val)
              + f"; launches per step in the log, steps 1-6: {launches}")
        if diff > RESUME_TOL:
            raise AssertionError(f"resumed losses differ by {diff}")
        if [r["step"] for r in val] != [3, 6] or not all(
                np.isfinite(r["total"]) for r in val):
            raise AssertionError(f"validation lines {val}")
        # soft upsample: the gather and the scatter once, for the energy
        # embedding; validation's launches are not the steps'
        want = {"fused_attention": 10, "gather_rows": 1, "scatter_rows": 1,
                "b_mas": 1, "ctc_lattice": 1, "ctc_grad": 1}
        if any(n != want for n in launches):
            raise AssertionError(f"CLI launches per step {launches}")

    def vctk_step(self):
        """The VCTK model (seeded weights, bf16) through one counted
        ``train_unsup`` step at exactly [16, 128, 1298] (``vctk_lengths``,
        float16 transfer of the mels and the 512-d embeddings), hard
        upsample, then timed and profiled; then each kernel of the step at
        that shape against its plain version (``vctk_kernels``)."""
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.model import get_model
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        configs = pre, mc, tr = self.vctk_configs()
        model = get_model(0, configs, device="cuda")
        src_lens, mel_lens = self.vctk_lengths()
        host = synth_batch(B=B_TRAIN, T_s=T_S, T_m=T_VCTK, seed=0,
                           src_lens=src_lens, mel_lens=mel_lens, prior=False)
        host["mels"] = host["mels"].astype(np.float16)
        host["spker_embeds"] = np.random.RandomState(5).randn(
            B_TRAIN, mc["external_speaker_dim"]).astype(np.float16)
        batch = batch_to_device(host, "cuda")
        start = tr["duration"]["binarization_start_steps"]
        opt, _ = build_optimizer(model, mc, tr, count=start)
        state = create_train_state(model, opt, step=start, seed=tr["seed"])
        step = make_train_step(pre, mc, tr, "train_unsup")
        print(f"VCTK: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} "
              f"M parameters, bf16, batch {B_TRAIN}x[{T_S} tokens, {T_VCTK} "
              f"frames], src_lens {src_lens.tolist()}, mel_lens "
              f"{mel_lens.tolist()}")
        step(state, batch)
        torch.cuda.synchronize()
        _, got = self.counted_step(step, state, batch, "VCTK train step")
        want = {"fused_attention": 10, "gather_rows": 2, "scatter_rows": 2,
                "b_mas": 1, "ctc_lattice": 1, "ctc_grad": 1}
        if got != want:
            raise AssertionError(f"VCTK step: expected launches {want}, got "
                                 f"{got}")
        for name, n in got.items():
            self.kernels[name]["launches_vctk_step"] = n
        self.step_timing(step, state, batch, "VCTK train step")
        del model, opt, state, step, batch
        torch.cuda.empty_cache()
        self.vctk_kernels(src_lens, mel_lens)

    def vctk_kernels(self, src_lens, mel_lens):
        """Each kernel of the VCTK step at its shape (B=16, T_s=128,
        T_m=1298, the step's lengths; seeded values) against its plain
        version, timed beside the plain version (but MAS's and the CTC
        lattice's, host loops of a few launches a frame, whose profiles of
        tens of thousands of kernels late in the process lose their ends),
        one library call and the bound, counted as in phases 2 and 5;
        recorded under each kernel's ``vctk`` entry."""
        from ctts_torch.ops import attention, mas, sort_gather
        from ctts_torch.ops import forward_sum as fs
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(12)
        rng = np.random.RandomState(12)
        B, T, S_tok = B_TRAIN, T_VCTK, T_S
        il = torch.from_numpy(src_lens).to(dev)
        ol = torch.from_numpy(mel_lens).to(dev)

        def put(name, shape, err, ms, plain_ms, lib_ms, flops, nbytes):
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            self.kernels[name]["vctk"] = {
                "shape": shape, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by}
            lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
            plain = ("not timed (a host loop of a few launches a frame; "
                     "phase 5 times it at the train shape)"
                     if plain_ms is None else f"{plain_ms:.4f}")
            print(f"{name} at the VCTK shape ({shape}): max err {err:.3e}; "
                  f"device ms kernel {ms:.4f}, plain {plain}, library "
                  f"{lib}; bound {b_ms:.5f} ms ({b_by}), the kernel at "
                  f"{b_ms / ms:.3f} of it", flush=True)

        # the decoder's attention: 2 heads of 128, bf16
        d, scale = 128, 128 ** -0.5
        lens = torch.from_numpy(np.repeat(mel_lens, 2)).to(dev)
        N = len(lens)
        q, k, v = (randn(gen, N, T, d).to(dev, torch.bfloat16)
                   for _ in range(3))
        got = attention.fused_attention(q, k, v, lens, scale)
        ref = attention.attention_plain(q.float(), k.float(), v.float(),
                                        lens, scale)
        err, by_row = (got.float() - ref).abs().max().item(), row_err(got,
                                                                      ref)
        if err > ATTN_TOL[torch.bfloat16] or by_row > ATTN_ROW_TOL_BF16:
            raise AssertionError(f"attention at the VCTK shape: {err}, by "
                                 f"row {by_row}")
        add_mask = torch.where(
            torch.arange(T, device=dev)[None, None, :] < lens[:, None, None],
            0.0, attention.NEG).to(torch.bfloat16)
        ms, _ = timings(lambda: attention.fused_attention(q, k, v, lens,
                                                          scale))
        plain_ms, _ = timings(lambda: attention.attention_plain(
            q, k, v, lens, scale), iters=10)
        lib_ms, _ = timings(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=add_mask, scale=scale), iters=10)
        kv = int(lens.sum())
        put("fused_attention", f"bf16 N={N} T={T} d={d}, row check "
            f"{by_row:.2e}", err, ms, plain_ms, lib_ms, 4 * d * T * kv,
            2 * N * T * d * 2 + 2 * d * 2 * kv + N * 4)
        del q, k, v, ref, add_mask

        # the length regulator: mel2ph of the step's lengths
        mel2ph = np.zeros((B, T), np.int32)
        for g in range(B):
            cuts = np.sort(rng.choice(np.arange(1, mel_lens[g]),
                                      src_lens[g] - 1, replace=False))
            mel2ph[g, :mel_lens[g]] = np.searchsorted(
                cuts, np.arange(mel_lens[g]), side="right") + 1
        idx = torch.from_numpy(mel2ph).to(dev)
        G, Nr, Fw = B, S_tok + 1, 256
        vals = randn(gen, G, Nr, Fw).to(dev, torch.bfloat16)
        if not torch.equal(sort_gather.gather_rows(vals, idx),
                           sort_gather.gather_rows_plain(vals, idx)):
            raise AssertionError("gather at the VCTK shape differs")
        full = idx.long()[..., None].expand(G, T, Fw).contiguous()
        ms, _ = timings(lambda: sort_gather.gather_rows(vals, idx))
        plain_ms, _ = timings(lambda: sort_gather.gather_rows_plain(vals,
                                                                    idx))
        lib_ms, _ = timings(lambda: torch.gather(vals, 1, full))
        put("gather_rows", f"bf16 G={G} N={Nr} M={T} F={Fw}, mel2ph; "
            f"bit-exact", 0.0, ms, plain_ms, lib_ms, 0,
            (G * Nr * Fw + G * T * Fw) * 2 + G * T * 4)
        vals = torch.from_numpy(rng.randn(G, T, Fw).astype(np.float32)).to(
            dev)
        got = sort_gather.scatter_rows(vals, idx, Nr)
        ref = sort_gather.scatter_rows_plain(vals, idx, Nr)
        err = (got - ref).abs().max().item()
        if err > SCATTER_TOL[torch.float32] * ref.abs().max().item():
            raise AssertionError(f"scatter at the VCTK shape: {err}")
        t = self.scatter_timing("the VCTK step's length regulator", mel2ph,
                                Nr, Fw, rng)
        put("scatter_rows", f"f32 G={G} M={T} n_out={Nr} F={Fw}, mel2ph",
            err, t["ms"], t["plain_ms"], t["library_ms"], 0, t["nbytes"])

        # MAS
        attn = torch.softmax(randn(gen, B, T, S_tok) * 3.0, dim=-1).to(dev)
        if not torch.equal(mas.b_mas(attn, il, ol),
                           mas.b_mas_plain(attn, il, ol)):
            raise AssertionError("MAS at the VCTK shape differs")
        ms, _ = timings(lambda: mas.b_mas(attn, il, ol), only="mas_kernel")
        put("b_mas", f"f32 B={B} T_m={T} T_s={S_tok}; bit-exact", 0.0, ms,
            None, None, 0,
            int(mel_lens.sum()) * S_tok * 4 + B * T * S_tok * 4 + 2 * B * 4)
        del attn

        # the CTC pair
        logprob = (randn(gen, B, T, S_tok) * 2.0).to(dev)
        key = torch.arange(S_tok + 1, device=dev)[None, None, :]
        logits = torch.cat([logprob.new_full((B, T, 1), fs.BLANK_LOGPROB),
                            logprob], -1)
        masked = torch.where(key <= il[:, None, None], logits,
                             logits.new_full((), fs.NEG))
        em = fs._interleave(fs._log_softmax(masked)).contiguous()
        S = em.shape[-1]
        alpha, beta = fs.ctc_lattice(em, il, ol)
        alpha_p, beta_p = fs.ctc_alpha_plain(em, ol), fs.ctc_beta_plain(
            em, il, ol)
        if not (torch.equal(alpha, alpha_p) and torch.equal(beta, beta_p)):
            raise AssertionError("CTC lattice at the VCTK shape differs")
        i2 = 2 * il.long()
        pick = torch.stack([i2, (i2 - 1).clamp(min=0)], 1)
        log_l = torch.logsumexp(alpha[:, -1].gather(1, pick), dim=-1)
        cot = (1.0 / (il.float() * B)).contiguous()
        dem = fs.ctc_grad(alpha, beta, log_l, cot, ol)
        dem_p = fs.ctc_grad_plain(alpha_p, beta_p, log_l, cot, ol)
        g_err = (dem - dem_p).abs().max().item()
        if g_err > CTC_GRAD_TOL * dem_p.abs().max().item():
            raise AssertionError(f"CTC gradient at the VCTK shape: {g_err}")
        lp = F.log_softmax(torch.where(key <= il[:, None, None], logits,
                                       logits.new_full((), -1e9)),
                           dim=-1).transpose(0, 1).contiguous()
        lp.requires_grad_(True)
        targets = torch.arange(1, S_tok + 1, device=dev).expand(B, S_tok)

        def lib_loss():
            return F.ctc_loss(lp, targets, ol.long(), il.long(), blank=0,
                              reduction="mean")

        def lib_both():
            lp.grad = None
            lib_loss().backward()

        ms_l, _ = timings(lambda: fs.ctc_lattice(em, il, ol))
        ms_g, _ = timings(lambda: fs.ctc_grad(alpha, beta, log_l, cot, ol))
        plain_g, _ = timings(lambda: fs.ctc_grad_plain(alpha, beta, log_l,
                                                       cot, ol))
        lib_f, _ = timings(lib_loss, iters=5)
        lib_fb, _ = timings(lib_both, iters=5)
        live = int(mel_lens.sum())
        shape = f"f32 B={B} T_m={T} S={S}"
        put("ctc_lattice", f"{shape}; bit-exact", 0.0, ms_l, None, lib_f,
            0, live * S * 4 + B * T * S * 4 + 2 * B * 4)
        put("ctc_grad", f"{shape}; bit-exact {torch.equal(dem, dem_p)}",
            g_err, ms_g, plain_g, lib_fb, 0,
            2 * live * S * 4 + B * T * S * 4 + 3 * B * 4)

    def vctk_synthesize(self):
        """``python -m ctts_torch.synthesize --mode single --speaker_id``
        (its ``main``) from the VCTK train CLI's step-6 checkpoint, with
        HiFi-GAN at seed 0 saved as the VCTK recipe's vocoder checkpoint:
        the four probe texts as one utterance (a lexicon spells each as one
        word), for speakers p225 and p229 and p225 again. The two speakers'
        mels must differ and p225's two runs must be equal bit for bit."""
        from ctts_torch.synthesize import main as synthesize
        tmp = self.vctk_tmp
        try:
            ckpt = os.path.join(tmp, "ckpt")
            self.save_seed_vocoder(ckpt, "VCTK")
            text = " ".join(f"probe{c}" for c in "abcd")
            mels = {}
            for run, speaker in (("a", "p225"), ("b", "p229"),
                                 ("a2", "p225")):
                out = os.path.join(tmp, f"out_{run}")
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    synthesize(["--mode", "single", "--text", text,
                                "--speaker_id", speaker, "--dataset", "VCTK",
                                "--config_dir", os.path.join(tmp, "straight"),
                                "--restore_step", "6", "--vocoder_ckpt", ckpt,
                                "--result_dir", out])
                if "griffin-lim" in buf.getvalue():
                    raise AssertionError("the vocoder checkpoint was not "
                                         "loaded")
                wav = [f for f in os.listdir(out) if f.endswith(".wav")]
                mels[run] = np.load(os.path.join(out, f"{text}.npy"))
                print(f"synthesize CLI --speaker_id {speaker}: "
                      f"{time.perf_counter() - t0:.2f} s in process; mel "
                      f"[{mels[run].shape[0]}, {mels[run].shape[1]}], "
                      f"{len(wav)} wav")
                if not np.isfinite(mels[run]).all() or not wav or \
                        not len(mels[run]):
                    raise AssertionError(f"speaker {speaker}: no wav, or an "
                                         f"empty or non-finite mel")
            same = mels["a"].shape == mels["a2"].shape and np.array_equal(
                mels["a"], mels["a2"])
            differ = mels["a"].shape != mels["b"].shape or not np.array_equal(
                mels["a"], mels["b"])
            print(f"VCTK synthesize CLI: mel lengths p225 "
                  f"{mels['a'].shape[0]}, p229 {mels['b'].shape[0]}; the two "
                  f"speakers differ: {differ}; p225 again bit for bit: {same}")
            if not (same and differ):
                raise AssertionError(f"speakers differ {differ}, repeat "
                                     f"equal {same}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ---- phase 12c: the prosody models ----------------------------------- #
    @staticmethod
    def prosody_configs(model_type, learn_alignment=False):
        """``configs/LJSpeech.yaml`` with ``learn_alignment`` (False unless
        asked) and ``prosody_modeling.model_type`` changed, with the energy
        range of no store."""
        from ctts_torch.config import get_configs_of
        from ctts_torch.models.comp_trans_tts import prepare_model_config
        pre, mc, tr = get_configs_of("LJSpeech")
        mc["duration_modeling"]["learn_alignment"] = learn_alignment
        mc["prosody_modeling"]["model_type"] = model_type
        return pre, prepare_model_config(pre, mc), tr

    def prosody_du2021(self):
        self.prosody("du2021")

    def prosody_liu2021(self):
        self.prosody("liu2021")

    def prosody(self, model_type):
        """``model_type`` (du2021 or liu2021) in "LJSpeech supervised" at
        full width with seeded weights (the repo has no prosody checkpoint):
        the probe forward at budget 1152 (counted, median of 10, profiled;
        du2021's draws from seed 0 at each forward, so two forwards give
        the same mel); one counted bf16 ``train_sup`` step at [16, 128, 896]
        with durations summing to the mel lengths and the prosody term on,
        then timed and profiled; liu2021 also one counted ``train_unsup``
        step (hard upsample, MAS and the CTC pair); the ``train_sup`` step
        in float32 with dropout off on the card and on the CPU at [4, 128,
        896], within PROSODY_MEL_TOL, PROSODY_LOSS_TOL and
        PROSODY_GRAD_NORM_TOL, and again on the card with TF32 on, which
        must fail that check; ``python -m ctts_torch.train`` on a synthetic
        supervised store (4 steps, and a resume from the step-2 checkpoint
        for steps 3-4; validation reads the prosody term 0) and the
        synthesize CLI (its ``main``, in this process) from its
        step-4 checkpoint."""
        import copy
        from ctts_torch.config import load_yaml
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.parallel.train_step import (_apply, batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.synthesize import infer_mels
        from ctts_torch.utils.model import get_model
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        man = json.load(open(MANIFEST))["probe"]
        probe = {"speakers": np.zeros(len(man["src_lens"]), np.int64),
                 "texts": np.asarray(man["texts"], np.int64),
                 "src_lens": np.asarray(man["src_lens"], np.int64)}
        configs = pre, mc, tr = self.prosody_configs(model_type)
        gate = tr["prosody"]["prosody_loss_enable_steps"]
        model = get_model(0, configs, device="cuda")
        n_par = sum(p.numel() for p in model.parameters()) / 1e6
        prosody_par = sum(p.numel() for n, p in model.named_parameters()
                          if "prosody" in n) / 1e6

        def forward():
            out = infer_mels(model, probe, configs, max_mel_len=man["budget"])
            torch.cuda.synchronize()
            return out

        first = forward()
        reset_launch_counts()
        out = forward()
        counts = {k: v for k, v in launch_counts().items() if v}
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            forward()
            times.append((time.perf_counter() - t0) * 1e3)
        _, busy, idle, kernels = self.breakdown(
            forward, f"{model_type} probe forward")
        mel = out["postnet_mel_predictions"]
        same = torch.equal(mel, first["postnet_mel_predictions"])
        print(f"{model_type}: {n_par:.2f} M parameters ({prosody_par:.2f} M "
              f"in the prosody modules), bf16 stacks; probe forward at "
              f"budget {man['budget']}: launches {counts}; median of 10 "
              f"{np.median(times):.2f} ms (min {min(times):.2f}, max "
              f"{max(times):.2f}); device busy {busy:.3f} ms, idle share "
              f"{idle:.3f}, {kernels} kernels; mel lens "
              f"{out['mel_lens'].tolist()}; two forwards bit for bit: {same}")
        if counts != {"fused_attention": 10, "gather_rows": 2}:
            raise AssertionError(f"{model_type} forward: launches {counts}")
        if not bool(torch.isfinite(mel).all()) or mel.shape != (
                4, man["budget"], 80) or not same:
            raise AssertionError(f"{model_type}: mel {tuple(mel.shape)}, "
                                 f"non-finite or not repeated")
        for name, n in counts.items():
            self.kernels.setdefault(name, {}).setdefault(
                f"launches_{model_type}_forward", n)

        # bf16 train_sup step, the prosody term on
        start = gate
        opt, _ = build_optimizer(model, mc, tr, count=start)
        state = create_train_state(model, opt, step=start, seed=tr["seed"])
        host = self.sup_batch()
        host["mels"] = host["mels"].astype(np.float16)     # transfer_dtype
        batch = batch_to_device(host, "cuda")
        step = make_train_step(pre, mc, tr, "train_sup")
        metrics, got = self.counted_step(step, state, batch,
                                         f"{model_type} train_sup step")
        want = {"fused_attention": 10, "gather_rows": 2, "scatter_rows": 2}
        if got != want or not metrics["prosody"] > 0:
            raise AssertionError(f"{model_type} step: launches {got}, "
                                 f"prosody {metrics['prosody']}")
        for name, n in got.items():
            self.kernels.setdefault(name, {}).setdefault(
                f"launches_{model_type}_step", n)
        self.step_timing(step, state, batch, f"{model_type} train_sup step")
        del model, opt, state, step, batch
        torch.cuda.empty_cache()

        if model_type == "liu2021":
            configs_u = pre_u, mc_u, tr_u = self.prosody_configs(
                model_type, learn_alignment=True)
            model = self.sup_model(configs_u)
            opt, _ = build_optimizer(model, mc_u, tr_u, count=start)
            state = create_train_state(model, opt, step=start,
                                       seed=tr_u["seed"])
            src_lens, mel_lens = self.train_lengths()
            host_u = synth_batch(B=B_TRAIN, T_s=T_S, T_m=T_M, seed=0,
                                 src_lens=src_lens, mel_lens=mel_lens,
                                 prior=False)
            host_u["mels"] = host_u["mels"].astype(np.float16)
            metrics, got = self.counted_step(
                make_train_step(pre_u, mc_u, tr_u, "train_unsup"), state,
                batch_to_device(host_u, "cuda"), "liu2021 train_unsup step")
            want_u = {"fused_attention": 10, "gather_rows": 2,
                      "scatter_rows": 2, "b_mas": 1, "ctc_lattice": 1,
                      "ctc_grad": 1}
            if got != want_u or not metrics["prosody"] > 0 or \
                    not metrics["bin"] > 0:
                raise AssertionError(f"liu2021 train_unsup step: launches "
                                     f"{got}, prosody {metrics['prosody']}")
            for name, n in got.items():
                self.kernels.setdefault(name, {}).setdefault(
                    "launches_liu2021_unsup_step", n)
            del model, opt, state
            torch.cuda.empty_cache()

        # float32, dropout off: the card against the port's CPU path, then
        # the same on the card with TF32 on, which must fail the check
        mc32 = dict(mc, compute_dtype="float32")
        cpu = self.sup_model((pre, mc32, tr), "cpu")
        weights = copy.deepcopy(cpu.state_dict())
        small = self.sup_batch(B=4)

        def f32_step(dev):
            m = cpu if dev == "cpu" else copy.deepcopy(cpu).cuda()
            m.load_state_dict(weights)
            b = batch_to_device(small, dev)
            m.eval()
            with torch.no_grad():
                mel = _apply(m, b, "train_sup", start + 1)[
                    "postnet_mel_predictions"].float().cpu()
            o, _ = build_optimizer(m, mc32, tr, count=start)
            st = create_train_state(m, o, step=start, seed=tr["seed"])
            return mel, {k: v.item() for k, v in make_train_step(
                pre, mc32, tr, "train_sup", deterministic=True)(
                    st, b).items()}

        def against_cpu(card):
            mel_err = ((card[0] - ref[0]).abs().max()
                       / ref[0].abs().max()).item()
            errs = {k: abs(card[1][k] - v) / max(abs(v), 1e-30)
                    for k, v in ref[1].items() if v != 0}
            loss_err = max(e for k, e in errs.items() if k != "grad_norm")
            zeros = [k for k, v in ref[1].items()
                     if v == 0 and card[1][k] != 0]
            bad = (mel_err > PROSODY_MEL_TOL or loss_err > PROSODY_LOSS_TOL
                   or errs["grad_norm"] > PROSODY_GRAD_NORM_TOL or zeros)
            return mel_err, errs, zeros, bad

        ref = f32_step("cpu")
        mel_err, errs, zeros, bad = against_cpu(f32_step("cuda"))
        print(f"{model_type}: f32, dropout off, card vs CPU at 4x[{T_S}, "
              f"{T_M}]: mel max err over its largest entry {mel_err:.3e} "
              f"(tol {PROSODY_MEL_TOL:g}); loss terms relative: "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f" (tol {PROSODY_LOSS_TOL:g}, grad_norm "
              f"{PROSODY_GRAD_NORM_TOL:g}); prosody "
              f"{ref[1]['prosody']:.6f}")
        if bad:
            raise AssertionError(f"{model_type}: card vs CPU {mel_err}, "
                                 f"{errs}, {zeros}")
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            mel_err, errs, _, bad = against_cpu(f32_step("cuda"))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        print(f"{model_type}: control, the same with TF32 on the card: mel "
              f"{mel_err:.3e}, loss terms relative: "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f"; fails the check: {bad}")
        if not bad:
            raise AssertionError(f"{model_type}: the TF32 control passed "
                                 "the card-vs-CPU check")
        del cpu, weights
        torch.cuda.empty_cache()

        # the train CLI with a resume, then the synthesize CLI
        tmp = tempfile.mkdtemp(prefix=f"ctts_smoke_{model_type}_")
        try:
            store = os.path.join(tmp, "store")
            self.write_store(store, sup=True)
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["model"]["duration_modeling"]["learn_alignment"] = False
            raw["model"]["prosody_modeling"]["model_type"] = model_type
            raw["preprocess"]["path"]["preprocessed_path"] = store
            raw["train"]["optimizer"]["warm_up_step"] = 50
            raw["train"]["step"].update(log_step=1, save_step=2, val_step=2,
                                        var_start_steps=0)
            raw["train"]["prosody"]["prosody_loss_enable_steps"] = 0
            straight = self.run_train_cli(raw, tmp, "straight", 4)
            self.copy_checkpoint(tmp, 2)
            resumed = self.run_train_cli(raw, tmp, "resumed", 4, restore=2)
            bad = [(s, k) for s, r in straight.items() for k, v in r.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            val = [json.loads(ln) for ln in open(os.path.join(
                tmp, "straight", "log_path", "val", "log.jsonl"))]
            if bad or not all(straight[s]["prosody"] > 0 for s in straight):
                raise AssertionError(f"non-finite {bad} or a zero prosody "
                                     f"term in the log")
            if not val or any(r["prosody"] != 0 for r in val):
                raise AssertionError(f"validation's prosody term is not 0: "
                                     f"{val}")
            diff = max(abs(straight[s][k] - resumed[s][k]) /
                       max(1.0, abs(straight[s][k]))
                       for s in (3, 4) for k in ("total", "mel", "prosody"))
            print(f"{model_type} train CLI: total "
                  + ", ".join(f"{straight[s]['total']:.3f}"
                              for s in sorted(straight))
                  + ", prosody " + ", ".join(
                      f"{straight[s]['prosody']:.4f}" for s in
                      sorted(straight))
                  + f"; validation's prosody {[r['prosody'] for r in val]}; "
                  f"resume from step 2: steps 3-4 max relative difference "
                  f"{diff:.3e} (tol {RESUME_TOL:g}); launches per step "
                  f"{straight[3]['launches_per_step']}")
            if diff > RESUME_TOL or straight[3]["launches_per_step"] != want:
                raise AssertionError(f"resume {diff}, launches "
                                     f"{straight[3]['launches_per_step']}")
            self.save_seed_vocoder(os.path.join(tmp, "ckpt"))
            meta = os.path.join(tmp, "meta.txt")
            self.write_probe_meta(meta)
            out = os.path.join(tmp, "out")
            t0 = time.perf_counter()
            stdout, _ = self.run_synthesize(
                ["--mode", "batch", "--source", meta, "--dataset",
                 "LJSpeech", "--config_dir", os.path.join(tmp, "straight"),
                 "--restore_step", "4",
                 "--vocoder_ckpt", os.path.join(tmp, "ckpt"),
                 "--result_dir", out])
            mels = [np.load(os.path.join(out, f"probe{i}.npy"))
                    for i in range(4)]
            wavs = [f for f in os.listdir(out) if f.endswith(".wav")]
            lens = [m.shape[0] for m in mels]
            print(f"{model_type} synthesize CLI from the step-4 checkpoint: "
                  f"{time.perf_counter() - t0:.1f} s in this process; mel "
                  f"lengths {lens}, {len(wavs)} wavs")
            if not all(np.isfinite(m).all() for m in mels) or \
                    len(wavs) != 4 or "griffin-lim" in stdout:
                raise AssertionError(f"synthesized: lengths {lens}, "
                                     f"{len(wavs)} wavs")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ---- phase 12d: from a raw corpus to a validated checkpoint ------- #
    @staticmethod
    def corpus_config(root, dataset, out, val_size):
        """``configs/<dataset>.yaml`` reading the corpus under ``root`` and
        writing its store to ``out`` (with the corpus's TextGrids), as a
        merged config in ``out``'s config directory; returns that
        directory."""
        from ctts_torch.config import dump_yaml, load_yaml
        raw = load_yaml(open(os.path.join(REPO, "configs",
                                          f"{dataset}.yaml")))
        raw["preprocess"]["path"].update(
            raw_path=os.path.join(root, "raw"), preprocessed_path=out,
            lexicon_path=os.path.join(root, "lexicon.txt"))
        raw["preprocess"]["preprocessing"]["val_size"] = val_size
        shutil.copytree(os.path.join(root, "TextGrid"),
                        os.path.join(out, "TextGrid"))
        cfg = out + "_cfg"
        os.makedirs(cfg)
        with open(os.path.join(cfg, f"{dataset}.yaml"), "w") as f:
            f.write(dump_yaml(raw))
        return cfg

    @staticmethod
    def run_preprocess(cfg, dataset):
        """``python -m ctts_torch.preprocess`` on the card, one worker;
        returns its wall seconds, the process start included."""
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "ctts_torch.preprocess", "--dataset",
             dataset, "--config_dir", cfg], cwd=REPO, capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, CTTS_PREPROCESS_WORKERS="1"))
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            print(res.stderr[-3000:])
            raise AssertionError(f"preprocess exited {res.returncode}")
        return wall

    def preprocess_lj(self):
        """``python -m ctts_torch.preprocess`` on the card for an
        LJSpeech-layout corpus of 40 utterances of 1.5-9.5 s
        (``ctts_torch.utils.testing.write_corpus``; LJSpeech's own run
        1.1-10.1 s) under
        ``configs/LJSpeech.yaml`` with ``val_size: 8``; the port's
        Preprocessor on the CPU on the same corpus, the card's store held to
        it (``ctts_torch.utils.testing.compare_stores``, the comparison of
        ``tests/test_torch_preprocess.py``); the card again with
        CTTS_PREPROCESS_WORKERS=2 (a pool this process spawns), bit for
        bit; the wall seconds of each
        run; CUDA-event times of the batched mel of all 40 utterances and of
        the f0 tracker on the longest. The corpus and the card's store stay
        for ``train_from_store``."""
        import filecmp

        from ctts_torch.audio.stft import TacotronSTFT
        from ctts_torch.config import get_configs_of
        from ctts_torch.preprocessing.audio_io import load_wav
        from ctts_torch.preprocessing.pitch import extract_f0_autocorr
        from ctts_torch.preprocessing.preprocessor import Preprocessor
        from ctts_torch.utils.testing import (CORPUS_SR, compare_stores,
                                              store_files, write_corpus)
        tmp = self.corpus_tmp = tempfile.mkdtemp(prefix="ctts_smoke_corpus_")
        atexit.register(shutil.rmtree, tmp, True)
        rng = np.random.RandomState(14)
        seconds = np.round(rng.uniform(1.5, 9.5, 40), 2)
        seconds[:2] = (1.5, 9.5)
        audio = write_corpus(tmp, ["LJSpeech"], seconds, seed=14)
        stores = {k: os.path.join(tmp, k) for k in ("card", "cpu", "card2")}
        cfgs = {k: self.corpus_config(tmp, "LJSpeech", v, 8)
                for k, v in stores.items()}
        walls = {"card": self.run_preprocess(cfgs["card"], "LJSpeech")}
        t0 = time.perf_counter()
        cpu = Preprocessor(*get_configs_of("LJSpeech", cfgs["cpu"]),
                           device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            cpu.build_from_path()
        walls["cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.environ["CTTS_PREPROCESS_WORKERS"] = "2"
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                Preprocessor(*get_configs_of("LJSpeech", cfgs["card2"]),
                             device="cuda").build_from_path()
        finally:
            os.environ.pop("CTTS_PREPROCESS_WORKERS")
        walls["card2"] = time.perf_counter() - t0
        for k, what in (("card", "card, 1 worker (python -m, process start "
                                 "included)"),
                        ("cpu", "CPU, in this process"),
                        ("card2", "card, 2 workers spawned by this process "
                                  "(their starts included)")):
            print(f"preprocess {len(seconds)} utterances, {audio:.1f} s of "
                  f"audio, {what}: {walls[k]:.2f} s wall, "
                  f"{audio / walls[k]:.1f} audio s per wall s")
        worst = compare_stores(stores["card"], stores["cpu"],
                               cpu.constant_window_frames, cpu.get_f0cwt)
        print("card store against the CPU store, largest differences: "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        files = store_files(stores["card"])
        differ = [f for f in files if not filecmp.cmp(
            os.path.join(stores["card"], f), os.path.join(stores["card2"], f),
            shallow=False)]
        print(f"card, 1 worker against 2 workers: {len(files)} files, "
              f"{len(differ)} differ")
        if differ:
            raise AssertionError(f"the worker pool changed {differ[:5]}")
        n_val = len(open(os.path.join(stores["card"],
                                      "val_unsup.txt")).readlines())
        if n_val != 8:
            raise AssertionError(f"val_unsup holds {n_val} utterances")
        # the device parts alone, CUDA events
        raw_dir = os.path.join(tmp, "raw", "LJSpeech")
        wavs = [load_wav(os.path.join(raw_dir, f), CORPUS_SR)[0]
                for f in sorted(os.listdir(raw_dir)) if f.endswith(".wav")]
        y = torch.zeros(len(wavs), max(map(len, wavs)))
        for i, w in enumerate(wavs):
            y[i, :len(w)] = torch.from_numpy(w)
        y = y.cuda()
        st = TacotronSTFT(1024, 256, 1024, 80, CORPUS_SR, 0, 8000).cuda()
        ms = cuda_ms(lambda: st.mel_spectrogram(y), warmup=3, iters=10)
        print(f"batched mel [{y.shape[0]}, {y.shape[1]}] ({audio:.1f} s of "
              f"audio, float64 transforms): {ms:.3f} ms a call (CUDA "
              f"events, 10 calls)")
        longest = torch.from_numpy(max(wavs, key=len)).cuda()

        def track():
            extract_f0_autocorr(longest, CORPUS_SR, 256)
        dev_ms, ev_ms = timings(track, iters=5)
        sec = len(longest) / CORPUS_SR
        print(f"f0 tracker on the longest utterance ({sec:.2f} s, "
              f"{len(longest) // 256} frames, float64): {ev_ms:.3f} "
              f"ms a call (CUDA events, the copy of f0 to the host "
              f"included), device busy {dev_ms:.3f} ms")
        self.lj_store = stores["card"]

    def preprocess_vctk(self):
        """The port's Preprocessor in this process on the card and on the
        CPU for ``configs/VCTK.yaml``: 2 speakers × 4 utterances with
        CTTS_ALLOW_RANDOM_SPEAKER=1 (the ResCNN at seed 0 on both
        devices): the card's store, ``spker_embed`` within 1e-5 included,
        held to the CPU's; the ResCNN forward on the 8 utterances' fbank
        crops at once on the card (CUDA events)."""
        from ctts_torch.config import get_configs_of
        from ctts_torch.models.speaker import PreDefinedEmbedder
        from ctts_torch.preprocessing.audio_io import load_wav
        from ctts_torch.preprocessing.preprocessor import Preprocessor
        from ctts_torch.utils.testing import (CORPUS_SR, compare_stores,
                                              write_corpus)
        tmp = tempfile.mkdtemp(prefix="ctts_smoke_vctk_corpus_")
        env = {"CTTS_ALLOW_RANDOM_SPEAKER": "1"}
        try:
            audio = write_corpus(tmp, ["p225", "p226"],
                                      [1.5, 2.2, 3.1, 4.0], seed=15)
            stores = {k: os.path.join(tmp, k) for k in ("card", "cpu")}
            cfgs = {k: self.corpus_config(tmp, "VCTK", v, 2)
                    for k, v in stores.items()}
            os.environ.update(env)
            walls = {}
            for k, dev in (("card", "cuda"), ("cpu", "cpu")):
                t0 = time.perf_counter()
                pre = Preprocessor(*get_configs_of("VCTK", cfgs[k]),
                                   device=dev)
                with contextlib.redirect_stdout(io.StringIO()):
                    pre.build_from_path()
                walls[k] = time.perf_counter() - t0
            print(f"VCTK preprocess, 8 utterances, {audio:.1f} s of audio, "
                  f"in this process: {walls['card']:.2f} s wall on the card, "
                  f"{walls['cpu']:.2f} s on the CPU")
            cpu = pre
            worst = compare_stores(stores["card"], stores["cpu"],
                               cpu.constant_window_frames, cpu.get_f0cwt)
            print("VCTK card store against the CPU store, largest "
                  "differences: " + ", ".join(f"{k} {v:.3g}"
                                              for k, v in worst.items()))
            embeds = sorted(os.listdir(os.path.join(stores["card"],
                                                    "spker_embed")))
            if embeds != ["p225-spker_embed.npy", "p226-spker_embed.npy"]:
                raise AssertionError(f"speaker embeddings {embeds}")
            emb = PreDefinedEmbedder(cpu.config, device="cuda")
            crops = torch.stack([emb.crop(load_wav(os.path.join(
                tmp, "raw", s, f), CORPUS_SR)[0]) for s in ("p225", "p226")
                for f in sorted(os.listdir(os.path.join(tmp, "raw", s)))
                if f.endswith(".wav")])
            with torch.no_grad():
                ms = cuda_ms(lambda: emb.model(crops), warmup=3, iters=20)
            print(f"ResCNN forward [{crops.shape[0]}, 160, 64] → "
                  f"[{crops.shape[0]}, 512], float32: {ms:.3f} ms (CUDA "
                  f"events, 20 calls)")
        finally:
            for k in env:
                os.environ.pop(k, None)
            shutil.rmtree(tmp, ignore_errors=True)

    def train_from_store(self):
        """``python -m ctts_torch.train`` of the LJSpeech default (full
        width and depth, seeded weights, bf16, the device cache) on the
        card's store of ``preprocess_lj`` for 6 steps: a preview at steps 3
        and 6 with HiFi-GAN at seed 0 (``--vocoder_ckpt``), validation at 3
        and 6, a checkpoint at 6, steps 4-5 traced (``--profile_steps``);
        each log line's launches per step; the previews' device part
        (``train.preview_arrays``) again in this process on the step-6
        checkpoint, counted; ``python -m ctts_torch.evaluate --restore_step
        6`` against the step-6 validation line; the synthesize CLI from
        that checkpoint."""
        from ctts_torch.config import get_configs_of, load_yaml
        from ctts_torch.data.dataset import Dataset
        from ctts_torch.evaluate import restore_state
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    make_eval_step)
        from ctts_torch.train import _device_batch, preview_arrays
        from ctts_torch.utils.model import get_vocoder
        tmp = self.corpus_tmp
        raw = load_yaml(open(os.path.join(REPO, "configs", "LJSpeech.yaml")))
        raw["preprocess"]["path"].update(
            preprocessed_path=self.lj_store,
            lexicon_path=os.path.join(tmp, "lexicon.txt"))
        raw["preprocess"]["preprocessing"]["val_size"] = 8
        raw["train"]["optimizer"]["warm_up_step"] = 50
        raw["train"]["step"].update(log_step=1, synth_step=3, val_step=3,
                                    save_step=6, var_start_steps=0)
        vocoder_dir = os.path.join(tmp, "ckpt")
        self.save_seed_vocoder(vocoder_dir)
        log = self.run_train_cli(raw, tmp, "run", 6, extra=[
            "--vocoder_ckpt", vocoder_dir, "--profile_steps", "4:5"])
        run = os.path.join(tmp, "run")
        bad = [(s, k) for s, r in log.items() for k, v in r.items()
               if isinstance(v, float) and not np.isfinite(v)]
        launches = [log[s]["launches_per_step"] for s in range(1, 7)]
        print("train CLI on the preprocessed store (device cache used: "
              f"{'device cache:' in self.cli_stdout}): total over 6 steps "
              + ", ".join(f"{log[s]['total']:.3f}" for s in range(1, 7))
              + f"; launches per step in the log, steps 1-6: {launches}")
        # soft upsample (step < binarization_start_steps): the gather and
        # the scatter once, for the energy embedding
        want = {"fused_attention": 10, "gather_rows": 1, "scatter_rows": 1,
                "b_mas": 1, "ctc_lattice": 1, "ctc_grad": 1}
        if bad or any(n != want for n in launches):
            raise AssertionError(f"non-finite {bad}, launches {launches}")
        hop = raw["preprocess"]["preprocessing"]["stft"]["hop_length"]
        previews = [json.loads(ln) for ln in open(os.path.join(
            run, "log_path", "train", "preview.jsonl"))]
        for r in previews:
            print(f"preview @ {r['step']}: {r}")
            if r["preview"] != "ran" or not r["wav_finite"] or \
                    r["wav_samples"] != r["mel_len"] * hop:
                raise AssertionError(f"preview {r}")
            if r["figures"] is None:
                print(f"  figures not drawn: {r['figures_skipped']}")
            elif not r["tensorboard"]:
                print(f"  figures {r['figures']} drawn; TensorBoard is not "
                      f"installed, so they were not logged")
        if [r["step"] for r in previews] != [3, 6]:
            raise AssertionError(f"previews at {[r['step'] for r in previews]}")
        val = {r["step"]: r for r in map(json.loads, open(os.path.join(
            run, "log_path", "val", "log.jsonl")))}
        print("validation: " + "; ".join(
            f"step {s} total {r['total']:.6f}" for s, r in val.items()))
        if sorted(val) != [3, 6] or not all(np.isfinite(r["total"])
                                            for r in val.values()):
            raise AssertionError(f"validation lines {sorted(val)}")
        trace = json.load(open(os.path.join(run, "log_path", "profile",
                                            "steps_4_5.json")))
        kernels = [e["name"] for e in trace["traceEvents"]
                   if e.get("cat") == "kernel"]
        attn = sorted({k[k.index("attn_fwd"):].split("(")[0]
                       for k in kernels if "attn_fwd" in k})
        print(f"trace of steps 4-5 (torch.profiler): {len(kernels)} kernel "
              f"launches; the attention kernel's: {attn}")
        if not attn:
            raise AssertionError("the trace names no attention kernel")

        # the previews' device part in this process, counted
        configs, state = restore_state(get_configs_of("LJSpeech", run), 6,
                                       "cuda")
        pre, mc, tr = configs
        batch = next(Dataset("train_unsup.txt", pre, mc, tr, sort=False,
                             drop_last=False).batches(shuffle=False))
        vocoder = get_vocoder(mc, vocoder_dir, device="cuda")
        eval_step = make_eval_step(pre, mc, tr, "train_unsup")
        reset_launch_counts()
        _, out, wav = preview_arrays(eval_step, state, batch_to_device(
            _device_batch(batch), "cuda"), vocoder, pre, "train_unsup")
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        mel_len = int(out["mel_lens"][0])
        print(f"preview device part on the step-6 checkpoint "
              f"({batch['ids'][0]}): mel_len {mel_len}, wav {len(wav)} "
              f"samples (mel_len·hop {mel_len * hop}), finite "
              f"{bool(np.isfinite(wav).all())}, peak {np.abs(wav).max():.3f};"
              f" launches {got}")
        if len(wav) != mel_len * hop or not np.isfinite(wav).all() or any(
                not got.get(k) for k in ("fused_attention", "gather_rows",
                                         "b_mas", "ctc_lattice")):
            raise AssertionError("the preview's device part")
        del state

        # python -m ctts_torch.evaluate against the step-6 validation line
        res = subprocess.run(
            [sys.executable, "-m", "ctts_torch.evaluate", "--dataset",
             "LJSpeech", "--config_dir", run, "--restore_step", "6"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-3000:])
            raise AssertionError(f"evaluate exited {res.returncode}")
        means = json.loads(res.stdout.strip().splitlines()[-1])["means"]
        errs = {k: abs(v - val[6][k]) / max(abs(val[6][k]), 1e-30)
                for k, v in means.items() if val[6][k] != 0 or v != 0}
        message = res.stdout.strip().splitlines()[-2]
        print(f"evaluate CLI --restore_step 6: {message}")
        print(f"  against the step-6 validation line: largest relative "
              f"difference {max(errs.values()):.3g} "
              f"({max(errs, key=errs.get)}; limit 1e-5)")
        if set(means) != set(val[6]) - {"step", "t"} or \
                max(errs.values()) > 1e-5:
            raise AssertionError(f"evaluate means {errs}")

        # the synthesize CLI from the step-6 checkpoint
        meta = os.path.join(tmp, "meta.txt")
        self.write_probe_meta(meta)
        out_dir = os.path.join(tmp, "synth")
        stdout, stderr = self.run_synthesize(
            ["--mode", "batch", "--source", meta, "--dataset", "LJSpeech",
             "--config_dir", run, "--restore_step", "6", "--vocoder_ckpt",
             vocoder_dir, "--result_dir", out_dir])
        made = sorted(os.listdir(out_dir))
        mels = [np.load(os.path.join(out_dir, f)) for f in made
                if f.endswith(".npy")]
        pngs = [f for f in made if f.endswith(".png")]
        print(f"synthesize CLI from the step-6 checkpoint: "
              f"{len(mels)} mels of {[m.shape[0] for m in mels]} frames, "
              f"{len(pngs)} PNGs"
              + ("" if pngs else f" ({stderr.strip()})"))
        if len(mels) != 4 or not all(np.isfinite(m).all() for m in mels) \
                or "griffin-lim" in stdout:
            raise AssertionError(f"synthesized {made}")

    # ---- phase 13: the vocoder's fused ResBlock1 and serving ---------- #
    def resblock_inputs(self):
        """HiFi-GAN V1 at full width with seed-0 weights (bf16, as served)
        and the input of each of its ResBlock1s on the probe mels, captured
        by forward pre-hooks: {resblock index: input [4, C, T]}."""
        from ctts_torch.utils.model import get_vocoder
        mels, _, _, configs = self.probe_out
        with tempfile.TemporaryDirectory() as empty:
            name, gen = get_vocoder(configs[1], ckpt_dir=empty,
                                    device="cuda", seed=0)
        assert name == "HiFi-GAN"
        seen = {}
        hooks = [blk.register_forward_pre_hook(
            lambda m, a, i=i: seen.__setitem__(i, a[0].detach().clone()))
            for i, blk in enumerate(gen.resblocks)]
        os.environ.pop("CTTS_FUSE_RESBLOCK", None)
        try:
            with torch.no_grad():
                gen(mels)
        finally:
            for h in hooks:
                h.remove()
        self.hifigan = gen
        return gen, seen

    def fused_resblock(self):
        """The fused ResBlock1 kernel against its plain version at levels
        1-3 of the probe (C = 128, 64, 32 at T = 73728, 147456, 294912,
        N=4; k = 3, 7, 11; the generator's own weights and inputs), bf16
        and f32, plus two tiles (T=256) and a ragged tile (T=250) at C=32;
        the bf16 times (CUDA events) beside the plain version's, the port's
        unfused ResBlock1 (six cuDNN convs and the leaky ReLUs) and the
        bound."""
        from ctts_torch.ops import fused_resblock as fr
        gen, inputs = self.resblock_inputs()
        rows, worst_abs, worst_rel, sweep = [], 0.0, 0.0, {}

        def check(what, x, blk, dtype, block_t=1024):
            nonlocal worst_abs, worst_rel
            convs = blk.stacked(dtype)
            x = x.to(dtype).contiguous()
            got = fr.fused_resblock1(x, *convs, blk.kernel_size,
                                     blk.dilations, block_t=block_t)
            ref = fr.reference_resblock1(x, *convs, blk.kernel_size,
                                         blk.dilations)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ok = rel <= FUSED_RESBLOCK_TOL[dtype] and \
                bool(torch.isfinite(got).all())
            print(f"fused resblock {what} k={blk.kernel_size} "
                  f"{str(dtype)[6:]}: max|kernel - plain| = {err:.3e}, "
                  f"{rel:.3e} of the largest entry (tol "
                  f"{FUSED_RESBLOCK_TOL[dtype]:g}) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise AssertionError(f"fused resblock {what} {dtype}: {rel}")
            if dtype == torch.bfloat16:
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            return x, convs

        os.environ.pop("CTTS_FUSE_RESBLOCK", None)
        for i, blk in enumerate(gen.resblocks):
            x16 = inputs[i]
            N, C, T = x16.shape
            if C > 128:
                continue                      # level 0 stays on cuDNN
            k = blk.kernel_size
            check(f"C={C} T={T}", x16, blk, torch.float32)
            x, convs = check(f"C={C} T={T}", x16, blk, torch.bfloat16)
            # CUDA event times: every call here is milliseconds long, so
            # launch gaps do not count, and late in this process the
            # profiler has read the cuDNN block at half its time (PERF.md
            # §7)
            packed = blk.packed(torch.bfloat16)
            ms = cuda_ms(lambda: fr.fused_resblock1(
                x, *convs, k, blk.dilations, packed=packed), warmup=2,
                iters=10)
            plain_ms = cuda_ms(lambda: fr.reference_resblock1(
                x, *convs, k, blk.dilations), warmup=1, iters=3)
            if C == 128 and k == 11:
                # the tile length against the ones the wrapper passed over
                for cap in (128, 192, 1024):
                    bt = fr.block_t_for(C, x.dtype, k, blk.dilations, cap)
                    sweep[bt] = cuda_ms(lambda: fr.fused_resblock1(
                        x, *convs, k, blk.dilations, block_t=cap,
                        packed=packed), warmup=2, iters=10)
                print(f"  block_t at C={C} k={k} bf16: " + ", ".join(
                    f"{bt} → {t:.4f} ms" for bt, t in sorted(sweep.items()))
                    + f" (the wrapper's choice: "
                    f"{fr.block_t_for(C, x.dtype, k, blk.dilations)})",
                    flush=True)

            def library():
                with torch.no_grad(), torch.autocast("cuda",
                                                     dtype=torch.bfloat16):
                    blk(x)

            lib_ms = cuda_ms(library, warmup=2, iters=10)
            lib_prof = device_ms(library, iters=5)
            flops = 12 * k * C * C * T * N
            nbytes = 2 * N * C * T * 2 + 6 * k * C * C * 2 + 6 * C * 4
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            rows.append((C, T, k, ms, plain_ms, lib_ms, b_ms, b_by))
            print(f"  timing bf16 N={N} C={C} T={T} k={k} (block_t "
                  f"{fr.block_t_for(C, x.dtype, k, blk.dilations)}): ms "
                  f"kernel {ms:.4f}, plain {plain_ms:.4f}, unfused "
                  f"ResBlock1 (cuDNN) {lib_ms:.4f} (CUDA events; the "
                  f"profiler reads the cuDNN block at "
                  f"{'-' if lib_prof is None else f'{lib_prof:.4f}'} ms); "
                  f"bound {b_ms:.5f} ms ({b_by})", flush=True)
            if C == 32:
                gen_ = torch.Generator().manual_seed(i)
                for T_small in (256, 250):
                    xs = (randn(gen_, 2, C, T_small) * 0.5).to("cuda")
                    for dtype in (torch.float32, torch.bfloat16):
                        check(f"C={C} T={T_small} block_t=128", xs, blk,
                              dtype, block_t=128)
        head = max(rows, key=lambda r: r[3])
        tot = [sum(r[j] for r in rows) for j in (3, 4, 5, 6)]
        print(f"fused resblock per generator forward ({len(rows)} calls, "
              f"bf16): kernel {tot[0]:.3f} ms, plain {tot[1]:.3f} ms, "
              f"unfused cuDNN {tot[2]:.3f} ms, bound {tot[3]:.5f} ms")
        C, T, k, ms, plain_ms, lib_ms, b_ms, b_by = head
        self.kernels["fused_resblock"] = {
            "name": "fused_resblock", "route": "cuda",
            "source": "ctts_torch/csrc/fused_resblock.cu",
            "replaces": "ctts_tpu/ops/fused_resblock.py:59", "launches": None,
            "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"bf16 N=4 C={C} T={T} k={k}, dilations 1/3/5; library "
                     f"= the port's unfused ResBlock1 (cuDNN convs)",
            "max_rel_err": worst_rel, "per_forward_ms": tot[0],
            "per_forward_plain_ms": tot[1],
            "per_forward_library_ms": tot[2],
            "per_forward_bound_ms": tot[3],
            "block_t_ms": {str(bt): t for bt, t in sorted(sweep.items())}}

    def vocoder_fused(self):
        """HiFi-GAN V1 on the probe mels with CTTS_FUSE_RESBLOCK=1 against
        the same generator unfused: bf16 as served (launches counted, times
        beside each other) and float32 (the exact check)."""
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        gen = self.hifigan
        mels = self.probe_out[0]

        def run(fuse):
            if fuse:
                os.environ["CTTS_FUSE_RESBLOCK"] = "1"
            else:
                os.environ.pop("CTTS_FUSE_RESBLOCK", None)
            with torch.no_grad():
                out = gen(mels)
            torch.cuda.synchronize()
            return out

        try:
            for dtype in (torch.bfloat16, torch.float32):
                gen.compute_dtype = dtype
                want = run(False)
                run(True)                                  # warm-up
                reset_launch_counts()
                got = run(True)
                counts = {k: v for k, v in launch_counts().items() if v}
                times = {}
                for fuse in (False, True, True, False):
                    t0 = time.perf_counter()
                    run(fuse)
                    times.setdefault(fuse, []).append(
                        (time.perf_counter() - t0) * 1e3)
                diff = (got - want).float()
                rms = (diff.pow(2).mean().sqrt()
                       / want.float().pow(2).mean().sqrt()).item()
                err = diff.abs().max().item()
                print(f"HiFi-GAN V1 {str(dtype)[6:]} on "
                      f"{tuple(mels.shape)}: fused {min(times[True]):.2f} "
                      f"ms, unfused {min(times[False]):.2f} ms (host clock "
                      f"around a synchronised forward, best of 2); launches "
                      f"{counts}; max|fused - unfused| = {err:.3e}, RMS "
                      f"ratio {rms:.3e}", flush=True)
                if counts != {"fused_resblock": 9}:
                    raise AssertionError(f"expected 9 fused resblock "
                                         f"launches, got {counts}")
                ok = (err <= VOCODER_F32_TOL if dtype == torch.float32
                      else rms <= VOCODER_BF16_RMS_TOL)
                if not ok or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"fused vocoder {dtype}: max "
                                         f"{err}, RMS ratio {rms}")
        finally:
            gen.compute_dtype = torch.bfloat16
            os.environ.pop("CTTS_FUSE_RESBLOCK", None)

    @staticmethod
    def probe_lexicon(path):
        """A lexicon that spells each probe text of the manifest as one
        word (``probea`` ... ``probed``), so that a request's text reaches
        the manifest's phone IDs through the port's own text frontend.
        Returns the words."""
        from ctts_torch.text.symbols import symbols
        man = json.load(open(MANIFEST))["probe"]
        words = [f"probe{c}" for c in "abcd"]
        with open(path, "w") as f:
            for w, ids, n in zip(words, man["texts"], man["src_lens"]):
                f.write(w + " " + " ".join(symbols[i][1:] for i in ids[:n])
                        + "\n")
        return words

    def serve(self):
        """``ctts_torch.serve`` in a thread on 127.0.0.1:0 with the trained
        acoustic weights and HiFi-GAN at seed 0 (bf16): /healthz, the
        manifest's 4 texts as 4 concurrent requests (batched), one text
        alone and streamed, and streamed again with CTTS_FUSE_RESBLOCK=1
        with the launch counters zeroed just before that request and read
        just after it."""
        import http.client
        import threading
        import urllib.request
        import wave
        from ctts_torch.config import get_configs_of
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.serve import TTSService, make_server
        from ctts_torch.utils.model import get_model
        from ctts_torch.vocoder.streaming import RF_MEL
        man = json.load(open(MANIFEST))["probe"]
        os.environ.pop("CTTS_FUSE_RESBLOCK", None)
        tmp = tempfile.mkdtemp()
        configs = get_configs_of("LJSpeech")
        configs[0]["path"]["lexicon_path"] = os.path.join(tmp, "lexicon.txt")
        words = self.probe_lexicon(configs[0]["path"]["lexicon_path"])
        model = get_model(0, configs, packed_ckpt=NPZ, device="cuda")
        svc = TTSService(model, configs, ("HiFi-GAN", self.hifigan))
        t0 = time.perf_counter()
        svc.warmup()
        print(f"server warm-up: {time.perf_counter() - t0:.2f} s")
        srv = make_server(svc)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        host, port = srv.server_address[:2]
        url = f"http://{host}:{port}"

        def healthz():
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                return json.loads(r.read())

        def post(body):
            """-> (seconds to the first PCM bytes, seconds in all, PCM)."""
            conn = http.client.HTTPConnection(host, port, timeout=600)
            t0 = time.perf_counter()
            conn.request("POST", "/tts", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise AssertionError(f"/tts {resp.status}: {resp.read()}")
            head = resp.read(44)
            first = resp.read(2)
            t_first = time.perf_counter() - t0
            rest = resp.read()
            t_all = time.perf_counter() - t0
            conn.close()
            data = head + first + rest
            if body.get("stream"):
                pcm = np.frombuffer(data[44:], "<i2")
            else:
                with wave.open(io.BytesIO(data)) as w:
                    pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            return t_first, t_all, pcm

        try:
            h = healthz()
            print(f"/healthz: {h}")
            if not h["ok"]:
                raise AssertionError(f"/healthz {h}")
            results = [None] * len(words)

            def one(i):
                results[i] = post({"text": words[i]})

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(words))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            batches = healthz()["batches"] - h["batches"]
            hop = svc.hop
            lens = []
            for r in results:
                if r is None or len(r[2]) % hop:
                    raise AssertionError(f"bad response {r}")
                lens.append(len(r[2]) // hop)
            want = np.asarray(man["expect_mel_lens"])
            print(f"4 concurrent requests: latencies "
                  f"{[round(r[1] * 1e3, 2) for r in results]} ms, all done "
                  f"in {wall * 1e3:.2f} ms, {batches} batch(es); mel lengths "
                  f"from the WAVs {lens} (manifest {want.tolist()})",
                  flush=True)
            if not np.all(np.abs(np.asarray(lens) - want)
                          <= np.maximum(0.05 * want, 3)):
                raise AssertionError(f"served lengths {lens} vs {want}")
            if not 1 <= batches < len(words):
                raise AssertionError(f"{len(words)} concurrent requests ran "
                                     f"as {batches} batches")
            text = {"text": words[0]}
            _, full_s, full = post(text)
            ttfa, stream_s, streamed = post(dict(text, stream=True))
            n = len(full) // hop
            keep = min(-(-n // 128) * 128, -(-(n + RF_MEL) // 64) * 64)
            windows = -(-keep // 64) if keep >= 64 + 2 * RF_MEL else 1
            print(f"'{words[0]}' alone: full {full_s * 1e3:.2f} ms; streamed "
                  f"time-to-first-audio {ttfa * 1e3:.2f} ms, all "
                  f"{stream_s * 1e3:.2f} ms, {windows} windows of 64 frames",
                  flush=True)
            os.environ["CTTS_FUSE_RESBLOCK"] = "1"
            reset_launch_counts()
            f_ttfa, f_s, fused = post(dict(text, stream=True))
            counts = {k: v for k, v in launch_counts().items() if v}
            os.environ.pop("CTTS_FUSE_RESBLOCK", None)
            print(f"streamed with CTTS_FUSE_RESBLOCK=1: time-to-first-audio "
                  f"{f_ttfa * 1e3:.2f} ms, all {f_s * 1e3:.2f} ms; launches "
                  f"{counts}", flush=True)
            for name, got in (("streamed", streamed), ("fused streamed",
                                                        fused)):
                if got.shape != full.shape:
                    raise AssertionError(f"{name} {got.shape} vs full "
                                         f"{full.shape}")
                d = np.abs(got.astype(np.int32) - full.astype(np.int32))
                rms_d = np.sqrt(np.mean(d.astype(np.float64) ** 2))
                tol = SERVE_PCM_RMS_TOL * np.sqrt(
                    np.mean(full.astype(np.float64) ** 2))
                print(f"{name} vs full PCM: max {d.max()} LSB, mean "
                      f"{d.mean():.2f} LSB, RMS {rms_d:.2f} LSB (tol "
                      f"{tol:.2f} LSB: {SERVE_PCM_RMS_TOL:g} of the full "
                      f"PCM's RMS)")
                if rms_d > tol:
                    raise AssertionError(f"{name} PCM differs: RMS {rms_d}")
            if counts.get("fused_resblock") != 9 * windows:
                raise AssertionError(f"expected {9 * windows} fused resblock "
                                     f"launches, got {counts}")
            self.kernels["fused_resblock"]["launches"] = counts[
                "fused_resblock"]
        finally:
            os.environ.pop("CTTS_FUSE_RESBLOCK", None)
            srv.shutdown()
            srv.server_close()
            shutil.rmtree(tmp, ignore_errors=True)

    @staticmethod
    def save_seed_vocoder(ckpt_dir, dataset="LJSpeech"):
        """HiFi-GAN V1 with seed-0 weights as an upstream checkpoint under
        ``ckpt_dir`` (the synthesize CLI's ``--vocoder_ckpt``), named for
        ``dataset``'s vocoder speaker."""
        from ctts_torch.config import get_configs_of
        from ctts_torch.utils.model import get_vocoder
        mc = get_configs_of(dataset)[1]
        _, gen = get_vocoder(mc, ckpt_dir=os.path.join(ckpt_dir, "none"),
                             device="cpu", seed=0)
        os.makedirs(os.path.join(ckpt_dir, "hifigan"))
        torch.save({"generator": gen.state_dict()}, os.path.join(
            ckpt_dir, "hifigan",
            f"generator_{mc['vocoder']['speaker']}.pth.tar"))

    @staticmethod
    def write_probe_meta(path):
        """The manifest's 4 texts as a batch-mode metadata file of their
        phones, ids probe0..probe3."""
        from ctts_torch.text.symbols import symbols
        man = json.load(open(MANIFEST))["probe"]
        with open(path, "w") as f:
            for i, (ids, n) in enumerate(zip(man["texts"], man["src_lens"])):
                phones = " ".join(symbols[j][1:] for j in ids[:n])
                f.write(f"probe{i}|LJSpeech|{{{phones}}}|probe {i}\n")

    def cli_batch(self):
        """``python -m ctts_torch.synthesize --mode batch --stream_chunk 64``
        on the manifest's 4 texts (a metadata file of their phones) with
        the trained weights and HiFi-GAN at seed 0, saved as an upstream
        checkpoint under ``--vocoder_ckpt``."""
        from ctts_torch.config import dump_yaml, load_yaml
        man = json.load(open(MANIFEST))["probe"]
        with tempfile.TemporaryDirectory() as tmp:
            self.save_seed_vocoder(os.path.join(tmp, "ckpt"))
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["preprocess"]["path"]["preprocessed_path"] = tmp
            os.makedirs(os.path.join(tmp, "cfg"))
            with open(os.path.join(tmp, "cfg", "LJSpeech.yaml"), "w") as f:
                f.write(dump_yaml(raw))
            with open(os.path.join(tmp, "speakers.json"), "w") as f:
                json.dump({"LJSpeech": 0}, f)
            self.write_probe_meta(os.path.join(tmp, "meta.txt"))
            out = os.path.join(tmp, "out")
            cmd = [sys.executable, "-m", "ctts_torch.synthesize", "--mode",
                   "batch", "--source", os.path.join(tmp, "meta.txt"),
                   "--dataset", "LJSpeech", "--config_dir",
                   os.path.join(tmp, "cfg"), "--packed_ckpt", NPZ,
                   "--vocoder_ckpt", os.path.join(tmp, "ckpt"),
                   "--stream_chunk", "64",
                   "--result_dir", out]
            env = {k: v for k, v in os.environ.items()
                   if k != "CTTS_FUSE_RESBLOCK"}
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                 text=True, timeout=600, env=env)
            print("\n".join(ln for ln in res.stdout.splitlines()
                            if "Sequence" not in ln)[-800:])
            if res.returncode != 0:
                print(res.stderr[-3000:])
                raise AssertionError(f"synthesize exited {res.returncode}")
            from scipy.io import wavfile
            lens = [len(wavfile.read(os.path.join(out, f"probe{i}.wav"))[1])
                    / 256 for i in range(4)]
            want = np.asarray(man["expect_mel_lens"])
            print(f"synthesize CLI, batch and stream: "
                  f"{time.perf_counter() - t0:.1f} s (process start "
                  f"included); mel lengths from the WAVs {lens}")
            if "griffin-lim" in res.stdout:
                raise AssertionError("batch CLI: the vocoder checkpoint "
                                     "was not loaded")
            if "time-to-first-audio" not in res.stdout or not np.all(
                    np.abs(np.asarray(lens) - want)
                    <= np.maximum(0.05 * want, 3)):
                raise AssertionError(f"batch CLI: lengths {lens} vs {want}")

    def flip(self):
        """``python -m ctts_torch.tools.bench_flip``'s entry point with the
        launch counters zeroed just before it and read just after it; then
        every variant against its plain version (bit-exact) at the tool's
        shape, with times and the bound."""
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
        from ctts_torch.ops import flip as fl
        from ctts_torch.tools import bench_flip as bf
        reset_launch_counts()
        record = bf.main(["--iters", "20"])
        launches = launch_counts()["bench_flip"]
        print(f"bench_flip tool: launches {launches}")
        if launches != len(fl.VARIANTS) * 23:
            raise AssertionError(f"bench_flip launched {launches} times")
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(bf.B * bf.H, bf.T, bf.T, generator=gen).to(
            "cuda", torch.bfloat16)
        N, T = x.shape[:2]
        b_ms, b_by = bound(0, 2 * 2 * N * T * T, PEAK_BF16_FLOPS)
        ms, plain = {}, {}
        for variant in fl.VARIANTS:
            got = fl.flip(x, variant)
            exact = torch.equal(got, fl.flip_plain(x, variant))
            ms[variant], ev_ms = timings(lambda: fl.flip(x, variant))
            plain[variant], _ = timings(lambda: fl.flip_plain(x, variant),
                                        iters=3)
            print(f"flip {variant} [{N}, {T}, {T}] bf16: "
                  f"{'bit-exact' if exact else 'MISMATCH'}; ms kernel "
                  f"{ms[variant]:.4f}, plain {plain[variant]:.4f}; bound "
                  f"{b_ms:.5f} ms ({b_by}); event ms kernel {ev_ms:.4f}",
                  flush=True)
            if not exact:
                raise AssertionError(f"flip {variant} differs from plain")
        self.kernels["bench_flip"] = {
            "name": "bench_flip", "route": "cuda",
            "source": "ctts_torch/csrc/bench_flip.cu",
            "replaces": "tools/bench_flip.py:67", "launches": launches,
            "max_abs_err": 0.0, "ms": ms["baseline"],
            "plain_ms": plain["baseline"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"bf16 [{N}, {T}, {T}] BQ={fl.BQ}, the baseline "
                     f"variant; every variant in variants_ms",
            "variants_ms": ms, "variants_plain_ms": plain,
            "tool_event_ms": record["variants_ms"]}

    # ---- phase 14: the (data, model) process grid ---------------------- #
    def grid(self, cards=1):
        """Two ranks of ``ctts_torch.parallel.mesh`` on this one card over
        gloo (NCCL refuses two ranks on one device), the LJSpeech default
        (``transformer_fs2`` 4 + 6 layers, hidden 256, 2 heads of 128, seeded
        weights) at full width and depth on the train step's global batch of
        16 × [128 tokens, 896 frames]: at (data 2, model 1) and (data 1,
        model 2) the f32 ``train_sup`` step with dropout off (2 steps, held to
        this process's one-process steps: the losses, the first update's
        gradients leaf by leaf and the parameters), the f32 ``train_unsup``
        step (1 step, its moved MAS frames printed) and one bf16
        ``train_unsup`` step with dropout on (finite; at (1, 2) each peer's
        own gradients of the replicated parameters held to the other's
        before the optimizer's collectives, and against a control step in
        which the peers draw different masks; the replicated parameters
        bit-identical across the grid's ranks after it), timed on each rank
        (median of 3, one step profiled) beside the one-process step, whose
        gradients are also compared between two runs from the same state
        (``grid_determinism``); then the conformer and the reformer
        (``CTTS_FUSED_LSH=1``) at (1, 2), one bf16 step each and one f32
        step held to one process. Every rank counts its kernel launches
        from zero over each job's first step and holds each kernel's first
        call of each shape to its plain version on the card
        (``GridKernels``). Then the train CLI at world size 1 over NCCL with
        ``--coordinator``, through its ``main`` in this process: 4 steps
        and a resume from step 2.

        With ``cards`` = n > 1 (``python3 chip_smoke.py --grid-cards``): one
        rank a card over NCCL, the grids (n, 1) and (2, n/2) and the blocks
        at (1, n), and the CLI on n processes at ``train.mesh`` (2, n/2)."""
        self.card = self.card or card_line()
        grids, tp = GRID_SHAPES[cards > 1](cards)
        jobs = grid_jobs(grids, tp)
        out = tempfile.mkdtemp(prefix="ctts_smoke_grid_")
        try:
            ref = {name: grid_job(job, None) for name, job in jobs.items()
                   if "grid" not in job}
            one = ref.pop("fs2_bf16_time")["timing"]
            print(f"one process, the bf16 train_unsup step (dropout on): "
                  f"host median {one['median_ms']:.2f} ms, device busy "
                  f"{one['busy_ms']:.2f} ms, idle share {one['idle']:.3f} "
                  f"({self.card})", flush=True)
            det = grid_determinism()
            for mode, what in (("default", "as it runs"),
                               ("cudnn", "with cudnn.deterministic"),
                               ("deterministic", "under deterministic "
                                "algorithms (warn_only)")):
                d = det[mode]
                print(f"one process, the bf16 train_unsup step twice from the "
                      f"same weights and seed, {what}: {d['differ']} of "
                      f"{d['leaves']} gradient leaves not bit-identical, "
                      f"worst {d['worst']:.3e} of its scale; largest "
                      + ", ".join(f"{n} {x:.2e}" for n, x in d["top"]))
            print("ops without a deterministic implementation in the step: "
                  + ("; ".join(det["warned"]) or "none"), flush=True)
            res = self.run_grid_ranks(
                out, {n: j for n, j in jobs.items() if "grid" in j},
                2 if cards == 1 else cards, "gloo" if cards == 1 else "nccl")
            self.check_grid(ref, res, one, grids, tp)
            self.grid_train_cli(cards)
        finally:
            shutil.rmtree(out, ignore_errors=True)

    def run_grid_ranks(self, out, jobs, world, backend):
        """Start the ranks (``python3 chip_smoke.py --grid-rank``; two on
        this card over gloo, or one a card over NCCL), wait for them within
        ``GRID_TIMEOUT_S`` (a rank past it is killed) and return each job's
        results by name, a list of the ranks'."""
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        spec = os.path.join(out, "spec.json")
        with open(spec, "w") as f:
            json.dump({"port": port, "out": out, "world": world,
                       "backend": backend, "jobs": jobs}, f)
        t0 = time.perf_counter()
        logs = [open(os.path.join(out, f"rank{r}.log"), "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--grid-rank", spec, str(r)], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
        codes = []
        try:
            for p in procs:
                left = GRID_TIMEOUT_S - (time.perf_counter() - t0)
                try:
                    codes.append(p.wait(timeout=max(left, 1)))
                except subprocess.TimeoutExpired:
                    codes.append("killed at the timeout")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        for r in range(world):
            text = open(os.path.join(out, f"rank{r}.log")).read()
            print(f"--- rank {r} (exit {codes[r]}), "
                  f"{time.perf_counter() - t0:.1f} s:")
            print("\n".join("  " + ln for ln in text.strip().splitlines()))
        if codes != [0] * world:
            raise AssertionError(f"grid ranks exited {codes}")
        return {name: [torch.load(os.path.join(out, f"{name}.r{r}.pt"),
                                  weights_only=False) for r in range(world)]
                for name in jobs}

    def check_grid(self, ref, res, one, grids, tp):
        """Hold the ranks' results to the one-process references."""
        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        for grid in grids:
            got, want = res[f"fs2_sup_f32_{grid}"], ref["fs2_sup_f32"]
            errs = {k: max(rel(s[k], w[k]) for s, w in zip(
                got[0]["losses"], want["losses"])) for k in want["losses"][0]}
            worst = max(errs, key=errs.get)
            pdiff = max((got[0]["params"][k].float() - v.float()).abs().max()
                        .item() for k, v in want["params"].items()
                        if v.is_floating_point())
            print(f"f32 train_sup at {grid}, 2 steps against one process: "
                  f"largest relative difference of a loss term "
                  f"{errs[worst]:.3e} ({worst}; tol {GRID_LOSS_RTOL:g}), "
                  f"parameters after both updates max |difference| "
                  f"{pdiff:.3e} (tol {GRID_PARAM_ATOL:g})")
            names = list(want["mu"])
            if set(got[0]["mu"]) != set(names):
                raise AssertionError(f"train_sup at {grid}: moments of "
                                     f"other parameters")
            g = summarize(*leaf_ratios([got[0]["mu"][k] for k in names],
                                       [want["mu"][k] for k in names], names))
            print(f"f32 train_sup at {grid}, the first update's gradients "
                  f"leaf by leaf (the optimizer's first moments) against one "
                  f"process: worst of {g['leaves']} leaves {g['worst']:.3e} "
                  f"of its scale (tol {GRID_GRAD_RTOL:g}); largest "
                  + ", ".join(f"{n} {r:.2e}" for n, r in g["top"]))
            if errs[worst] > GRID_LOSS_RTOL or pdiff > GRID_PARAM_ATOL \
                    or g["worst"] > GRID_GRAD_RTOL:
                raise AssertionError(f"train_sup at {grid}: {errs}, {pdiff}, "
                                     f"{g}")
            got, want = res[f"fs2_unsup_f32_{grid}"], ref["fs2_unsup_f32"]
            rows = want["mas"].shape[0] // int(grid[0])
            moved = 0
            for r, g in enumerate(got):
                d = r // int(grid[2])
                moved += int((g["mas"].argmax(-1) != want["mas"][
                    d * rows:(d + 1) * rows].argmax(-1)).sum()) \
                    if r % int(grid[2]) == 0 else 0
            errs = {k: max(rel(s[k], w[k]) for s, w in zip(
                got[0]["losses"], want["losses"])) for k in want["losses"][0]}
            worst = max(errs, key=errs.get)
            print(f"f32 train_unsup at {grid}, 1 step against one process: "
                  f"{moved} of {int(want['mas'][..., 0].numel())} frames "
                  f"moved by MAS at the first step; largest relative "
                  f"difference of a loss term {errs[worst]:.3e} ({worst})")
            if not moved and errs[worst] > GRID_LOSS_RTOL:
                raise AssertionError(f"train_unsup at {grid}: {errs}")
            for r, g in enumerate(res[f"fs2_bf16_{grid}"]):
                t = g["timing"]
                print(f"bf16 train_unsup at {grid}, dropout on, rank {r}: "
                      f"total {g['losses'][0]['total']:.4f}; replicated "
                      f"parameters bit-identical on every rank: "
                      f"{g['identical']}; host median {t['median_ms']:.2f} "
                      f"ms, device busy {t['busy_ms']:.2f} ms outside the "
                      f"collectives and {t['collective_ms']:.2f} ms in them, "
                      f"idle share {t['idle']:.3f} (one process: "
                      f"{one['median_ms']:.2f}, {one['busy_ms']:.2f} ms; "
                      f"{self.card})")
                if not g["identical"]:
                    raise AssertionError(f"bf16 at {grid}: replicated "
                                         f"parameters differ")
                if "peers" not in g or r % int(grid[2]) == 0:
                    continue
                p, c = g["peers"], g["peers_control"]
                print(f"bf16 train_unsup at {grid}, dropout on, rank {r}: its "
                      f"own gradients of the {p['leaves']} replicated leaves "
                      f"before the optimizer's collectives against model rank "
                      f"0's: {p['differ']} not bit-identical, worst leaf "
                      f"{p['worst']:.3e} of its scale (tol "
                      f"{GRID_PEER_RTOL:g}; "
                      + ", ".join(f"{n} {x:.2e}" for n, x in p["top"])
                      + f"); the control step, each peer drawing its own "
                      f"masks: {c['differ']} not bit-identical, worst "
                      f"{c['worst']:.3e}")
                if p["worst"] > GRID_PEER_RTOL or c["worst"] <= GRID_PEER_RTOL:
                    raise AssertionError(f"bf16 at {grid}: peers' gradients "
                                         f"{p}, control {c}")
        for block in ("conformer", "reformer"):
            got, want = res[f"{block}_f32_{tp}"], ref[f"{block}_f32"]
            errs = {k: rel(got[0]["losses"][0][k], want["losses"][0][k])
                    for k in want["losses"][0]}
            worst = max(errs, key=errs.get)
            print(f"{block} f32 step at {tp} against one process: largest "
                  f"relative difference {errs[worst]:.3e} ({worst}; tol "
                  f"{GRID_LOSS_RTOL:g})")
            if errs[worst] > GRID_LOSS_RTOL:
                raise AssertionError(f"{block} at {tp}: {errs}")
        # the reformer's 8 heads, the first 4 local: a rank runs the kinds
        # its contiguous share holds
        m = int(tp.split("x")[1])
        per = 8 // m
        kinds = [(min(max(4 - r * per, 0), per) > 0, 4 < (r + 1) * per)
                 for r in range(m)]
        split = [(c.get("local_window_fwd", 0), c.get("lsh_chunk_fwd", 0))
                 for c in (g["launches"] for g in res[f"reformer_bf16_{tp}"])]
        for r, g in enumerate(res[f"reformer_bf16_{tp}"]):
            t = g["timing"]
            print(f"reformer bf16 step at {tp}, rank {r} (heads "
                  f"{r * per}-{(r + 1) * per - 1}; local, LSH: {kinds[r]}): "
                  f"host median {t['median_ms']:.2f} ms, device busy "
                  f"{t['busy_ms']:.2f} ms outside the collectives and "
                  f"{t['collective_ms']:.2f} ms in them, idle share "
                  f"{t['idle']:.3f} ({self.card})")
        relpos = [g["launches"].get("relpos_fwd", 0)
                  for g in res[f"conformer_bf16_{tp}"]]
        print(f"reformer at {tp} (heads 0-3 local, 4-7 LSH): (local-window, "
              f"LSH-chunk) forward launches per rank {split}; conformer at "
              f"{tp}: relpos forward launches per rank {relpos} ({per} of 8 "
              f"heads a rank)")
        if [(a > 0, b > 0) for a, b in split] != kinds or not all(relpos):
            raise AssertionError(f"the heads' kernels per rank: {split}, "
                                 f"{relpos}")
        # the launches of each kernel per rank, as PERF.md's table reads them
        for name, jobs in grid_launches(grids, tp).items():
            per = {job: [g["launches"].get(name, 0) for g in res[job]]
                   for job in jobs}
            if name in self.kernels:
                self.kernels[name]["grid_launches"] = per
            print(f"{name} launches per rank: " + "; ".join(
                f"{job} {counts}" for job, counts in per.items()))

    def grid_train_cli(self, cards=1):
        """``python -m ctts_torch.train --coordinator 127.0.0.1:PORT
        --num_processes N --process_id i`` over NCCL on a synthetic store,
        one process a card (N = 1 on one card, through its ``main`` in this
        process; ``train.mesh`` data 2 × model N/2 on N cards, dropout on):
        4 steps, and a resume from their step-2 checkpoint for steps 3-4,
        rank 0's log within ``RESUME_TOL``. On N cards also the same 4 steps
        with the device cache off (each rank streams its shard and pads it
        to the step's largest on the prefetch thread), every step's total
        within ``RESUME_TOL`` of the cached run's."""
        from ctts_torch.config import dump_yaml, load_yaml
        tmp = tempfile.mkdtemp(prefix="ctts_smoke_grid_cli_")
        try:
            store = os.path.join(tmp, "store")
            self.write_store(store, n_train=32, n_val=4)
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["preprocess"]["path"]["preprocessed_path"] = store
            raw["train"]["step"].update(log_step=1, save_step=2,
                                        val_step=1000, synth_step=1000)
            if cards > 1:
                raw["train"]["mesh"] = {"data": 2, "model": cards // 2}
            runs = {}
            cached = raw["train"]["device_cache_mb"]
            for name, restore, cache_mb in (
                    ("straight", 0, cached), ("resumed", 2, cached),
                    *([("streamed", 0, 0)] if cards > 1 else [])):
                raw["train"]["device_cache_mb"] = cache_mb
                if restore:
                    self.copy_checkpoint(tmp, restore)
                cfg_dir = os.path.join(tmp, name)
                os.makedirs(cfg_dir, exist_ok=True)
                raw["train"]["path"] = {
                    k: os.path.join(cfg_dir, k)
                    for k in ("ckpt_path", "log_path", "result_path")}
                with open(os.path.join(cfg_dir, "LJSpeech.yaml"), "w") as f:
                    f.write(dump_yaml(raw))
                s = socket.socket()
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
                s.close()
                t0 = time.perf_counter()
                argv = ["--dataset", "LJSpeech", "--config_dir", cfg_dir,
                        "--max_steps", "4", "--restore_step", str(restore),
                        "--coordinator", f"127.0.0.1:{port}",
                        "--num_processes", str(cards)]
                if cards == 1:
                    # through its main in this process (no process start)
                    from ctts_torch.train import main as train_main
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        train_main(argv + ["--process_id", "0"])
                    outs, codes = [buf.getvalue()], [0]
                else:
                    outs, codes = self.spawn_train_cli(argv, cards)
                print(f"$ python -m ctts_torch.train ... --coordinator ... "
                      f"--num_processes {cards} --restore_step {restore} "
                      f"({time.perf_counter() - t0:.1f} s"
                      + (", in process)" if cards == 1 else ")"))
                print("\n".join("  " + ln for ln in
                                outs[0].strip().splitlines()[-12:]))
                if codes != [0] * cards:
                    print("\n".join(o[-2000:] for o in outs))
                    raise AssertionError(f"train CLI ranks exited {codes}")
                if f"process group nccl, world {cards}" not in outs[0]:
                    raise AssertionError("the CLI did not join an NCCL group")
                if ("streaming loader read" in outs[0]) != (cache_mb == 0):
                    raise AssertionError(f"{name}: the loader is not the "
                                         f"one its config names")
                path = os.path.join(cfg_dir, "log_path", "train",
                                    "log.jsonl")
                runs[name] = {r["step"]: r for r in map(json.loads,
                                                        open(path))}
            diff = max(abs(runs["straight"][s]["total"]
                           - runs["resumed"][s]["total"])
                       / max(1.0, abs(runs["straight"][s]["total"]))
                       for s in (3, 4))
            print(f"train CLI over NCCL on {cards} process(es): totals "
                  + ", ".join(f"{runs['straight'][s]['total']:.4f}"
                              for s in range(1, 5))
                  + f"; resumed steps 3-4 max relative difference "
                  f"{diff:.3e} (tol {RESUME_TOL:g})")
            if sorted(runs["straight"]) != [1, 2, 3, 4] or diff > RESUME_TOL:
                raise AssertionError(f"log steps {sorted(runs['straight'])}, "
                                     f"resumed losses differ by {diff}")
            if "streamed" in runs:
                diff = max(abs(runs["straight"][s]["total"]
                               - runs["streamed"][s]["total"])
                           / max(1.0, abs(runs["straight"][s]["total"]))
                           for s in range(1, 5))
                print(f"train CLI over NCCL on {cards} processes, the device "
                      f"cache off: totals "
                      + ", ".join(f"{runs['streamed'][s]['total']:.4f}"
                                  for s in range(1, 5))
                      + f"; against the cached run, max relative difference "
                      f"{diff:.3e} (tol {RESUME_TOL:g})")
                if sorted(runs["streamed"]) != [1, 2, 3, 4] \
                        or diff > RESUME_TOL:
                    raise AssertionError(f"the streamed run differs by "
                                         f"{diff}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    @staticmethod
    def spawn_train_cli(argv, n):
        """``python -m ctts_torch.train argv --process_id i`` for i < n, one
        process each; returns their outputs and exit codes."""
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ctts_torch.train", *argv,
             "--process_id", str(i)], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return outs, [p.returncode for p in procs]


    # ---- phase 15: long utterances ------------------------------------- #
    def long_kernels(self):
        """The CTC lattice and MAS against their plain versions at shapes
        that straddle every limit they had, each with its instance or route
        and its device time."""
        from ctts_torch.ops import forward_sum as fs
        from ctts_torch.ops import mas
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(16)
        for T_s in LONG_CTC_TEXT:
            T_m = T_s + 100
            il = torch.tensor([T_s, T_s * 3 // 5, T_s // 3, T_s],
                              dtype=torch.int32, device=dev)
            # ragged; the last two end below their text (out_len < in_len)
            ol = torch.tensor([T_m, T_m - 37, T_s // 3 - 5, T_s // 2],
                              dtype=torch.int32, device=dev)
            em = self.ctc_states(gen, il, T_m, T_s)
            S = em.shape[-1]
            before = fs.lattice_launches, fs.wide_lattice_launches
            alpha, beta = fs.ctc_lattice(em, il, ol)
            launched = (fs.lattice_launches - before[0],
                        fs.wide_lattice_launches - before[1])
            name = "lattice_wide" if launched == (0, 1) else \
                "lattice" if launched == (1, 0) else f"launches {launched}"
            where = ("global" if fs._lib().ctts_ctc_scratch_bytes(4, S)
                     else "shared")
            ref_a = fs.ctc_alpha_plain(em, ol)
            ref_b = fs.ctc_beta_plain(em, il, ol)
            e = em.clone().requires_grad_(True)
            nll = fs.ctc_state_nll(e, il, ol)
            cot = (torch.arange(4, device=dev) + 1.0) / 4
            (nll * cot).sum().backward()
            i2 = 2 * il.long()
            idx = torch.stack([i2, (i2 - 1).clamp(min=0)], 1)
            log_l = torch.logsumexp(ref_a[:, -1].gather(1, idx), -1)
            want = fs.ctc_grad_plain(ref_a, ref_b, log_l, cot, ol)
            torch.cuda.synchronize()
            reach = ol >= il
            g_err = ((e.grad - want)[reach].abs().max()
                     / want[reach].abs().max()).item()
            exact = (torch.equal(alpha, ref_a), torch.equal(beta, ref_b),
                     torch.equal(nll.detach(), -log_l))
            ms, _ = timings(lambda: fs.ctc_lattice(em, il, ol), iters=5)
            print(f"CTC S={S} [B=4, T_m={T_m}], in_lens {il.tolist()}, "
                  f"out_lens {ol.tolist()}: launched {name} (counted: "
                  f"one-state-a-thread, wide {launched}; rows in {where} "
                  f"memory): alpha, beta, "
                  f"loss bit-exact {exact}; gradient {g_err:.3e} of its "
                  f"largest entry where the end is reachable (tol "
                  f"{CTC_GRAD_TOL:g}); lattice device ms {ms:.4f}")
            if not all(exact) or not g_err <= CTC_GRAD_TOL \
                    or not bool(torch.isfinite(e.grad).all()) \
                    or launched != ((0, 1) if S > 1024 else (1, 0)):
                raise AssertionError(f"CTC at S={S}: {exact}, {g_err}, "
                                     f"launches {launched}")
        for B, T_m, T_s in LONG_MAS_SHAPES:
            attn = torch.softmax(randn(gen, B, T_m, T_s) * 3.0,
                                 dim=-1).to(dev)
            il = torch.tensor([T_s, T_s * 2 // 3][:B], dtype=torch.int32,
                              device=dev)
            ol = torch.tensor([T_m, T_s // 2][:B], dtype=torch.int32,
                              device=dev)
            before = mas.launches, mas.rows_launches
            got = mas.b_mas(attn, il, ol)
            launched = (mas.launches - before[0],
                        mas.rows_launches - before[1])
            ref = mas.b_mas_plain(attn, il, ol)
            torch.cuda.synchronize()
            exact = torch.equal(got, ref)
            ms, _ = timings(lambda: mas.b_mas(attn, il, ol), iters=5,
                            only="mas_")
            print(f"MAS [B={B}, T_m={T_m}, T_s={T_s}], in_lens "
                  f"{il.tolist()}, out_lens {ol.tolist()}: route "
                  f"{mas.route(T_m, T_s)} (counted: warp, rows "
                  f"{launched}), "
                  f"{'bit-exact' if exact else 'MISMATCH'}, "
                  f"{int(got.sum().item())} path cells; device ms {ms:.4f}")
            if not exact or launched != (0, 1):
                raise AssertionError(f"MAS at {(B, T_m, T_s)}")

    @staticmethod
    def ctc_states(gen, il, T_m, T_s):
        """State log-emissions [B, T_m, 2·T_s + 1] as forward_sum_loss
        builds them from seeded log-attention."""
        from ctts_torch.ops import forward_sum as fs
        B = il.shape[0]
        logprob = (randn(gen, B, T_m, T_s) * 2.0).to(il.device)
        logits = torch.cat([logprob.new_full((B, T_m, 1), fs.BLANK_LOGPROB),
                            logprob], -1)
        key = torch.arange(T_s + 1, device=il.device)[None, None, :]
        logits = fs._log_softmax(torch.where(key <= il[:, None, None], logits,
                                             logits.new_full((), fs.NEG)))
        return fs._interleave(logits).contiguous()

    def long_step(self):
        """One bf16 ``train_unsup`` step of the LJSpeech default at full
        width and depth with ``max_seq_len`` 3000, on 4 utterances of up to
        640 phones and 2560 frames: counted (MAS and the CTC lattice on
        their long routes), the hard alignment against ``b_mas_plain`` of
        the step's soft attention, timed and profiled; then MAS and the
        lattice at the step's own inputs against their plain versions,
        timed, with their bounds."""
        import copy
        from ctts_torch.config import get_configs_of
        from ctts_torch.models import variance_adaptor
        from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                      prepare_model_config)
        from ctts_torch.ops import forward_sum as fs
        from ctts_torch.ops import mas
        from ctts_torch.parallel.train_step import (batch_to_device,
                                                    create_train_state,
                                                    make_train_step)
        from ctts_torch.utils.model import init_weights
        from ctts_torch.utils.optimizer import build_optimizer
        from ctts_torch.utils.testing import synth_batch
        B, T_s, T_m = LONG_B, LONG_T_S, LONG_T_M
        pre, mc, tr = copy.deepcopy(get_configs_of("LJSpeech"))
        shipped = mc["max_seq_len"]
        mc["max_seq_len"] = 3000
        mc = prepare_model_config(pre, mc)
        model = init_weights(CompTransTTS(pre, mc, tr), tr["seed"]).cuda()
        opt, _ = build_optimizer(model, mc, tr)
        state = create_train_state(                    # every loss on
            model, opt, step=tr["step"]["var_start_steps"] + 10000,
            seed=tr["seed"])
        batch = synth_batch(B=B, T_s=T_s, T_m=T_m, seed=0,
                            src_lens=np.array(LONG_SRC),
                            mel_lens=np.array(LONG_MEL), prior=False)
        batch["mels"] = batch["mels"].astype(np.float16)   # transfer_dtype
        batch = batch_to_device(batch, "cuda")
        step = make_train_step(pre, mc, tr, "train_unsup")
        enc = model.encoder.embed_positions.table.shape[0]
        dec = model.decoder.embed_positions.table.shape[0]
        print(f"compute_dtype={mc['compute_dtype']}, batch {B}x[{T_s} "
              f"tokens, {T_m} frames], src_lens {list(LONG_SRC)}, mel_lens "
              f"{list(LONG_MEL)}; max_seq_len {shipped} -> 3000: the "
              f"position tables hold {enc} (encoder) and {dec} (decoder) "
              f"rows, so no position is clamped (at {shipped} the "
              f"decoder's {2 * shipped + 1} rows would clamp the frames past "
              f"{2 * shipped} to the last, as the JAX package does; "
              f"tests/test_torch_train_step.py holds the port to it there) "
              f"and nothing truncates the sequences")
        seen = {}
        real_mas, real_lattice = variance_adaptor.b_mas, fs.ctc_lattice

        def spy_mas(attn, il, ol, *args, **kwargs):
            out = real_mas(attn, il, ol, *args, **kwargs)
            seen["mas"] = (attn.detach().float().clone(), il.clone(),
                           ol.clone(), out.clone())
            return out

        def spy_lattice(em, il, ol, with_beta=True):
            seen["ctc"] = (em.detach().clone(), il.clone(), ol.clone())
            return real_lattice(em, il, ol, with_beta)

        variance_adaptor.b_mas, fs.ctc_lattice = spy_mas, spy_lattice
        try:
            metrics, got = self.counted_step(step, state, batch,
                                             "long train step")
        finally:
            variance_adaptor.b_mas, fs.ctc_lattice = real_mas, real_lattice
        want = {"fused_attention": 10, "gather_rows": 2, "scatter_rows": 2,
                "b_mas_rows": 1, "ctc_lattice_wide": 1, "ctc_grad": 1}
        if got != want:
            raise AssertionError(f"expected launches {want}, got {got}")
        attn, il, ol, hard = seen["mas"]
        exact = torch.equal(hard, mas.b_mas_plain(attn, il, ol))
        print(f"the step's hard alignment against b_mas_plain of its soft "
              f"attention [{B}, {T_m}, {T_s}]: "
              f"{'bit-exact' if exact else 'MISMATCH'} "
              f"({int(hard.sum().item())} path cells)")
        if not exact:
            raise AssertionError("the long step's MAS differs from plain")
        self.long = self.step_timing(step, state, batch, "long train step")

        # MAS and the lattice at the step's own inputs; the plain versions
        # (thousands of launches a call) by events
        ms, ev = timings(lambda: mas.b_mas(attn, il, ol), iters=5,
                         only="mas_")
        plain_ms = cuda_ms(lambda: mas.b_mas_plain(attn, il, ol), warmup=1,
                           iters=1)
        # rows at or past out_len are never read; every output row is
        # written
        nbytes = int(ol.sum()) * T_s * 4 + B * T_m * T_s * 4 + 2 * B * 4
        b_ms = self.record(
            "b_mas_rows", "ctts_torch/csrc/mas.cu",
            "ctts_tpu/ops/mas.py:236,249", 0.0, ms, plain_ms, nbytes, None,
            f"f32 B={B} T_m={T_m} T_s={T_s}, the long step's lengths",
            event_ms=ev)
        print(f"MAS long route at the step's inputs: device ms {ms:.4f} "
              f"(events {ev:.4f}), plain {plain_ms:.3f} (events), bound {b_ms:.5f} ms "
              f"(bytes), at {b_ms / ms:.4f} of it; no library call computes "
              f"it")
        em, il, ol = seen["ctc"]
        S = em.shape[-1]
        wide = fs.wide_lattice_launches
        alpha, beta = fs.ctc_lattice(em, il, ol)
        wide = fs.wide_lattice_launches - wide
        ref_a = fs.ctc_alpha_plain(em, ol)
        ref_b = fs.ctc_beta_plain(em, il, ol)
        torch.cuda.synchronize()
        err = max((alpha - ref_a)[ref_a > -1e8].abs().max().item(),
                  (beta - ref_b)[ref_b > -1e8].abs().max().item())
        if not (torch.equal(alpha, ref_a) and torch.equal(beta, ref_b)):
            raise AssertionError(f"the long step's lattice differs: {err}")
        ms_l, ev_l = timings(lambda: fs.ctc_lattice(em, il, ol), iters=5)
        plain_l = cuda_ms(lambda: (fs.ctc_alpha_plain(em, ol),
                                   fs.ctc_beta_plain(em, il, ol)),
                          warmup=1, iters=1)
        # the library's CTC on the same log-probabilities (blank, labels)
        lp = torch.cat([em[..., :1], em[..., 1::2]], -1).transpose(0, 1)
        targets = torch.arange(1, T_s + 1, device=em.device).expand(B, T_s)
        lib_ms, _ = timings(lambda: F.ctc_loss(
            lp, targets, ol.long(), il.long(), blank=0, reduction="none"),
            iters=5)
        # the Pallas pair's function: em below out_len read, alpha written
        nbytes = int(ol.sum()) * S * 4 + B * T_m * S * 4 + 2 * B * 4
        b_l = self.record(
            "ctc_lattice_wide", "ctts_torch/csrc/forward_sum.cu",
            "ctts_tpu/ops/forward_sum.py:272,310", err, ms_l, plain_l,
            nbytes, lib_ms, f"f32 B={B} T_m={T_m} S={S}, the long step's "
            f"lengths", event_ms=ev_l)
        if wide != 1:
            raise AssertionError(f"the long step's lattice launched the wide "
                                 f"instance {wide} times")
        print(f"CTC lattice, the wide instance (counted {wide}) at the "
              f"step's inputs "
              f"[B={B}, T_m={T_m}, S={S}]: alpha and beta bit-exact; device "
              f"ms {ms_l:.4f} (events {ev_l:.4f}), plain alpha + beta "
              f"{plain_l:.3f} (events), F.ctc_loss forward {lib_ms:.4f}, bound "
              f"{b_l:.5f} ms (bytes), at {b_l / ms_l:.4f} of it")
        for name, n in got.items():
            if name in ("b_mas_rows", "ctc_lattice_wide"):
                self.kernels[name]["launches"] = n
            elif name in self.kernels:
                self.kernels[name]["launches_long_step"] = n

    def long_stream_cli(self):
        """``python -m ctts_torch.train`` of the LJSpeech default with the
        device cache off, so batches stream from the prefetch thread
        through the native ``.npy`` prefetcher: 2 steps on a synthetic
        store."""
        from ctts_torch.config import load_yaml
        tmp = tempfile.mkdtemp(prefix="ctts_smoke_")
        try:
            store = os.path.join(tmp, "store")
            self.write_store(store, n_train=32, n_val=4)
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["preprocess"]["path"]["preprocessed_path"] = store
            raw["train"]["device_cache_mb"] = 0
            raw["train"]["step"].update(log_step=1, save_step=100000,
                                        val_step=100000, synth_step=100000)
            logs = self.run_train_cli(raw, tmp, "stream", 2)
            out = self.cli_stdout
            native = ("streaming loader: .npy files read by the native "
                      "prefetcher")
            counts = [ln for ln in out.splitlines()
                      if ln.startswith("streaming loader read ")]
            totals = [logs[s]["total"] for s in (1, 2)]
            print(f"streaming loader through the native prefetcher: "
                  f"{native in out}; {counts}; total over 2 steps {totals}; "
                  f"launches per step in the log "
                  f"{logs[2]['launches_per_step']}")
            if native not in out or not counts \
                    or not counts[0].endswith(" 0 through numpy") \
                    or not all(np.isfinite(totals)):
                raise AssertionError("the streaming loader did not read "
                                     "through the native prefetcher")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 14's ranks: the (data, model) process grid ------------------- #

def grid_jobs(grids, tp):
    """The jobs of phase 14 by name: the one-process references (no
    ``grid``), and on each grid of ``grids`` the fs2 jobs, on ``tp`` the
    conformer's and the reformer's."""
    jobs = {
        "fs2_sup_f32": dict(case="fs2_sup", dtype="float32", steps=2,
                            params=True),
        "fs2_unsup_f32": dict(case="fs2_unsup", dtype="float32", steps=1),
        "fs2_bf16_time": dict(case="fs2_unsup", dtype="bfloat16", steps=1,
                              dropout=True, timing=True),
        "conformer_f32": dict(case="conformer", dtype="float32", steps=1),
        "reformer_f32": dict(case="reformer", dtype="float32", steps=1)}
    for grid in grids:
        jobs[f"fs2_sup_f32_{grid}"] = dict(jobs["fs2_sup_f32"], grid=grid)
        jobs[f"fs2_unsup_f32_{grid}"] = dict(jobs["fs2_unsup_f32"], grid=grid)
        jobs[f"fs2_bf16_{grid}"] = dict(jobs["fs2_bf16_time"], grid=grid,
                                        identical=True, peers=True)
    for block in ("conformer", "reformer"):
        jobs[f"{block}_bf16_{tp}"] = dict(case=block, dtype="bfloat16",
                                          steps=1, dropout=True, grid=tp,
                                          timing=block == "reformer")
        jobs[f"{block}_f32_{tp}"] = dict(case=block, dtype="float32",
                                         steps=1, grid=tp)
    return jobs


# (the fs2 grids, the blocks' grid) for one card (two gloo ranks on it) and
# for n cards (one NCCL rank each)
GRID_SHAPES = (lambda n: (("2x1", "1x2"), "1x2"),
               lambda n: ((f"{n}x1", f"2x{n // 2}"), f"1x{n}"))


def grid_launches(grids, tp):
    """The jobs whose per-rank launches of each kernel phase 14 records
    (the bf16 jobs)."""
    fs2 = [f"fs2_bf16_{g}" for g in grids]
    reformer, conformer = [f"reformer_bf16_{tp}"], [f"conformer_bf16_{tp}"]
    return {
        "fused_attention": fs2, "gather_rows": fs2 + reformer,
        "scatter_rows": fs2 + reformer, "b_mas": fs2, "ctc_lattice": fs2,
        "ctc_grad": fs2, "relpos_fwd": conformer, "relpos_bwd": conformer,
        "local_window_fwd": reformer, "local_window_bwd": reformer,
        "lsh_chunk_fwd": reformer, "lsh_chunk_bwd": reformer}


# what each rank's first step of a job must launch (the kernels of the path)
GRID_MUST_LAUNCH = {
    "fs2_unsup": ("fused_attention", "gather_rows", "scatter_rows", "b_mas",
                  "ctc_lattice", "ctc_grad"),
    "fs2_sup": ("fused_attention", "gather_rows", "scatter_rows"),
    "conformer": ("relpos_fwd", "relpos_bwd", "gather_rows", "b_mas"),
    "reformer": ("gather_rows", "scatter_rows", "b_mas")}


def grid_case(case, dtype):
    """(configs, global batch, mode) of a phase-14 case at ``dtype``."""
    from ctts_torch.config import get_configs_of
    from ctts_torch.models.comp_trans_tts import prepare_model_config
    from ctts_torch.utils.testing import synth_batch
    if case == "fs2_sup":
        pre, mc, tr = Smoke.sup_configs()
        batch, mode = Smoke().sup_batch(), "train_sup"
    else:
        pre, mc, tr = get_configs_of("LJSpeech")
        mc["block_type"] = {"fs2_unsup": "transformer_fs2"}.get(case, case)
        mc = prepare_model_config(pre, mc)
        src, mel = Smoke.train_lengths()
        batch = synth_batch(B=B_TRAIN, T_s=T_S, T_m=T_M, seed=0,
                            src_lens=src, mel_lens=mel, prior=False)
        mode = "train_unsup"
    mc["compute_dtype"] = dtype
    return (pre, mc, tr), batch, mode


def param_names(model, opt):
    """The state_dict name of each of the optimizer's parameters."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for p in opt.params]


def keep_raw_grads(opt):
    """A list that receives, at each update of ``opt``, the gradients it was
    given, before any collective (``del opt._reduce`` stops it)."""
    raw, reduce = [], opt._reduce

    def spy(grads):
        raw.append([g.detach().clone() for g in grads])
        return reduce(grads)
    opt._reduce = spy
    return raw


def leaf_ratios(got, want, names):
    """{leaf: its largest |got - want| over its largest |want|, or over
    ``GRID_GRAD_FLOOR`` times the largest |want| of any leaf where that is
    more} and the number of leaves not bit-identical."""
    floor = GRID_GRAD_FLOOR * max(w.abs().max().item() for w in want)
    ratios = {n: (g.float() - w.float()).abs().max().item()
              / max(w.abs().max().item(), floor, 1e-30)
              for n, g, w in zip(names, got, want)}
    return ratios, sum(not torch.equal(g, w) for g, w in zip(got, want))


def summarize(ratios, differ):
    worst = sorted(ratios, key=ratios.get, reverse=True)
    return {"worst": ratios[worst[0]], "leaves": len(ratios),
            "differ": differ,
            "top": [(n, ratios[n]) for n in worst[:4] if ratios[n] > 0]}


def peer_grads(model, opt, grads, grid):
    """This rank's gradients of the replicated parameters (the partial
    ones aside) against model rank 0's, leaf by leaf (``leaf_ratios``; one
    broadcast over the model group)."""
    import torch.distributed as dist
    names = param_names(model, opt)
    idx = [i for i, p in enumerate(opt.params)
           if not getattr(p, "tp_sharded", False)
           and not getattr(p, "tp_partial", False)]
    mine = torch.cat([grads[i].float().reshape(-1) for i in idx])
    ref = mine.clone()
    dist.broadcast(ref, src=grid.data_rank * grid.model,
                   group=grid.model_group)
    sizes = [grads[i].numel() for i in idx]
    return summarize(*leaf_ratios(mine.split(sizes), ref.split(sizes),
                                  [names[i] for i in idx]))


def first_moments(model, opt, grid):
    """The optimizer's first moments by parameter name, whole, on the host
    (every rank of the model group takes part): after a fresh optimizer's
    first update, (1 - b1) times the clipped gradients."""
    from ctts_torch.parallel.mesh import gather_params
    sd = {n: m.clone() for n, m in zip(param_names(model, opt), opt.mu)}
    if grid is not None:
        sd = gather_params(sd, model.tp_specs, grid)
    return {k: v.cpu() for k, v in sd.items()}


def grid_determinism(device="cuda"):
    """Whether one process's bf16 ``train_unsup`` step (the LJSpeech
    default, dropout on) gives the same gradients twice from the same
    weights, optimizer and seed: twice as it runs, twice with
    ``torch.backends.cudnn.deterministic`` alone (cuDNN's deterministic
    convolution algorithms), then twice under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    also takes the deterministic implementations of the other ops that
    have one (``index_add_``, ``scatter_add_``, ``index_put_``) and warns at
    each op that has none (it runs as before). Returns each pair's
    ``summarize`` and the ops that warned."""
    import warnings
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.models.registry import block_hidden
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer
    (pre, mc, tr), batch, mode = grid_case("fs2_unsup", "bfloat16")
    model = init_weights(CompTransTTS(pre, mc, tr), tr["seed"]).to(device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = batch_to_device(batch, device)
    step = make_train_step(pre, mc, tr, mode)

    def once():
        model.load_state_dict(init)
        opt, _ = build_optimizer(model, mc, tr, d_model=block_hidden(mc)[0])
        state = create_train_state(model, opt, seed=tr["seed"],
                                   step=tr["step"]["var_start_steps"] + 10000)
        raw = keep_raw_grads(opt)
        step(state, batch)
        return raw[0], param_names(model, opt)

    a, names = once()
    b, _ = once()
    res = {"default": summarize(*leaf_ratios(a, b, names))}
    torch.backends.cudnn.deterministic = True
    try:
        a, _ = once()
        b, _ = once()
    finally:
        torch.backends.cudnn.deterministic = False
    res["cudnn"] = summarize(*leaf_ratios(a, b, names))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a, _ = once()
            b, _ = once()
        finally:
            torch.use_deterministic_algorithms(False)
    res["deterministic"] = summarize(*leaf_ratios(a, b, names))
    res["warned"] = sorted({str(w.message).split(" does not have")[0][:120]
                            for w in caught
                            if "determinis" in str(w.message)})
    return res


def grid_job(job, grid, device="cuda"):
    """One phase-14 job on this process (``grid`` None: one process):
    seeded weights, every gate open, a fresh optimizer; the first step's
    launches counted from zero and, on a grid, each kernel's first call held
    to its plain version (``GridKernels``). With ``params`` it keeps the
    whole first moments after the first update and the whole parameters
    after the last; with ``peers`` on a model axis, this rank's own
    gradients of the replicated parameters at the first update against
    model rank 0's, and again after a control step in which each peer
    draws its own dropout masks. Returns the results."""
    from ctts_torch.models.blocks import Dropout
    from ctts_torch.models.comp_trans_tts import CompTransTTS
    from ctts_torch.models.registry import block_hidden
    from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
    from ctts_torch.parallel.mesh import (gather_params, shard_batch,
                                          shard_model_)
    from ctts_torch.parallel.train_step import (batch_to_device,
                                                create_train_state,
                                                make_train_step)
    from ctts_torch.utils.model import init_weights
    from ctts_torch.utils.optimizer import build_optimizer
    (pre, mc, tr), batch, mode = grid_case(job["case"], job["dtype"])
    os.environ["CTTS_FUSED_LSH"] = "1" if job["case"] == "reformer" else "0"
    model = init_weights(CompTransTTS(pre, mc, tr), tr["seed"]).to(device)
    if not job.get("dropout"):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    if grid is not None:
        shard_model_(model, grid)
        batch = shard_batch(batch, grid)
    opt, _ = build_optimizer(model, mc, tr, d_model=block_hidden(mc)[0],
                             grid=grid)
    state = create_train_state(model, opt, seed=tr["seed"], grid=grid,
                               step=tr["step"]["var_start_steps"] + 10000)
    batch = batch_to_device(batch, device)
    step = make_train_step(pre, mc, tr, mode)
    peers = job.get("peers") and grid is not None and grid.model > 1
    raw = keep_raw_grads(opt) if peers else None
    kernels = GridKernels()
    with kernels:
        reset_launch_counts()
        losses = [step(state, batch)]
        if device != "cpu":
            torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
    mu = first_moments(model, opt, grid) if job.get("params") else None
    losses += [step(state, batch) for _ in range(job["steps"] - 1)]
    losses = [{k: v.item() for k, v in m.items()} for m in losses]
    res = {"losses": losses, "launches": launches}
    bad = [k for m in losses for k, v in m.items() if not np.isfinite(v)]
    missing = [k for k in GRID_MUST_LAUNCH[job["case"]] if k not in launches]
    if bad or missing:
        raise AssertionError(f"non-finite {bad}; not launched {missing}")
    if "mas" in kernels.outputs:
        res["mas"] = kernels.outputs["mas"].cpu()
    if grid is not None:
        res["checks"] = kernels.check()
    if job.get("params"):
        whole = gather_params(model.state_dict(), model.tp_specs, grid) \
            if grid is not None else model.state_dict()
        res["params"] = {k: v.cpu() for k, v in whole.items()}
        res["mu"] = mu
    if job.get("identical"):
        res["identical"] = replicated_identical(model, grid)
    if peers:
        res["peers"] = peer_grads(model, opt, raw[0], grid)
        # the control: each peer draws its own masks for one step
        state.generator.manual_seed(tr["seed"] + 1 + grid.model_rank)
        raw.clear()
        step(state, batch)
        res["peers_control"] = peer_grads(model, opt, raw[0], grid)
        del opt._reduce
    if job.get("timing"):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

        def traced():
            step(state, batch)
            torch.cuda.synchronize()

        res["timing"] = dict(grid_breakdown(traced, grid is not None),
                             median_ms=float(np.median(times)))
    return res


def grid_breakdown(traced, collective):
    """One profiled call of ``traced`` (one try where it takes part in
    ``collective`` steps, ``profiled``): the device time outside the
    collectives (``busy_ms``; gloo's host copies count there), the time of
    NCCL kernels (``collective_ms``: an NCCL kernel spins while it waits
    for the other ranks), and the idle share of the host-clock window
    outside both."""
    got = profiled(traced, cpu=True, leads=LEADS[:1] if collective else None)
    if got is None:
        print("the step under the profiler: no whole profile, device busy "
              "not measured")
        nan = float("nan")
        return {"busy_ms": nan, "collective_ms": nan, "idle": nan}
    events, wall, _ = got
    per = {}
    for e in events:
        # "nccl:all_reduce" / "gloo:all_reduce" are annotations that span
        # the collective, not device work (NCCL's own kernel is recorded
        # beside its span; gloo's work is the host copies)
        if e.name.startswith(("nccl:", "gloo:")):
            continue
        n, us = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, us + e.time_range.elapsed_us())
    coll = sum(us for name, (_, us) in per.items()
               if name.startswith("nccl")) / 1e3
    busy = sum(us for _, us in per.values()) / 1e3 - coll
    print(f"the step under the profiler: wall {wall:.2f} ms, device busy "
          f"{busy:.3f} ms outside the collectives, {coll:.3f} ms in NCCL "
          f"kernels, {sum(n for n, _ in per.values())} kernels and copies; "
          f"top device time:")
    for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3:8.3f} ms  {n:4d}x  {name[:100]}")
    return {"busy_ms": busy, "collective_ms": coll,
            "idle": 1 - busy / wall}


def replicated_identical(model, grid):
    """Whether every parameter outside the tensor-parallel specs is bit for
    bit rank 0's on every rank, and every sharded one the same on every
    rank of its data group (one broadcast each); the same answer on every
    rank."""
    import torch.distributed as dist
    sd = model.state_dict()
    ok = torch.ones((), device=next(model.parameters()).device)
    for names, group, src in (
            ([k for k in sd if k not in model.tp_specs], None, 0),
            ([k for k in sd if k in model.tp_specs], grid.data_group,
             grid.model_rank)):
        if not names or (group is None and names[0] in model.tp_specs):
            continue
        mine = torch.cat([sd[k].detach().float().reshape(-1) for k in names])
        theirs = mine.clone()
        dist.broadcast(theirs, src=src, group=group)
        ok *= float(torch.equal(mine, theirs))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


class GridKernels:
    """While entered, keeps each kernel wrapper's first call of each dtype
    and input shape (its inputs and output); ``check`` then holds each kept
    output to the kernel's plain version on the same inputs on the card,
    with the tolerance of its own phase, once a process for each kernel,
    dtype and shape (``checked``)."""

    checked = set()

    def __init__(self):
        self.calls, self.outputs, self.undo = {}, {}, []

    def __enter__(self):
        import ctts_torch.models.conformer as conformer
        import ctts_torch.models.reformer as reformer
        import ctts_torch.models.transformer as transformer
        import ctts_torch.models.variance_adaptor as variance_adaptor
        from ctts_torch.ops import (attention, forward_sum, mas,
                                    sort_gather)
        from ctts_torch.ops import local_window_attention as lw
        from ctts_torch.ops import lsh_chunk_attention as lc
        from ctts_torch.ops import relpos_attention as ra
        for key, mod, name in (
                ("attention", attention, "fused_attention"),
                ("attention", transformer, "fused_attention"),
                ("gather", sort_gather, "_gather"),
                ("scatter", sort_gather, "_scatter"),
                ("mas", mas, "b_mas"), ("mas", variance_adaptor, "b_mas"),
                ("ctc_lattice", forward_sum, "ctc_lattice"),
                ("ctc_grad", forward_sum, "ctc_grad"),
                ("relpos", ra, "relpos_attention"),
                ("relpos", conformer, "relpos_attention"),
                ("local_window", lw, "local_window_attention"),
                ("local_window", reformer, "local_window_attention"),
                ("lsh_chunk", lc, "chunk_attention"),
                ("lsh_chunk", reformer, "chunk_attention")):
            self.hook(key, mod, name)
        return self

    def hook(self, key, mod, name):
        orig = getattr(mod, name)

        def kept(*args, **kwargs):
            gen = kwargs.get("generator")
            gstate = gen.get_state() if gen is not None else None
            out = orig(*args, **kwargs)
            k = (key, args[0].dtype, tuple(args[0].shape))
            if k not in self.calls:
                self.calls[k] = (args, kwargs, out, gstate)
                if key == "mas":
                    self.outputs["mas"] = out
            return out
        setattr(mod, name, kept)
        self.undo.append((mod, name, orig))

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self.undo):
            setattr(mod, name, orig)
        self.undo = []

    @torch.no_grad()
    def check(self):
        from ctts_torch.ops import attention, forward_sum, mas, sort_gather
        from ctts_torch.ops import local_window_attention as lw
        from ctts_torch.ops import lsh_chunk_attention as lc
        from ctts_torch.ops import relpos_attention as ra

        def rel(got, ref):
            return ((got.float() - ref.float()).abs().max().item()
                    / max(ref.float().abs().max().item(), 1e-30))

        lines = []
        for (key, dt, shape), (a, kw, out, gstate) in sorted(
                self.calls.items(), key=lambda kv: str(kv[0])):
            if (key, dt, shape) in GridKernels.checked:
                continue
            GridKernels.checked.add((key, dt, shape))
            out = out.detach() if torch.is_tensor(out) else out
            if key == "attention":
                q, k, v, lens = a[:4]
                scale = kw.get("scale", a[4] if len(a) > 4 else None)
                ref = attention.attention_plain(q.float(), k.float(),
                                                v.float(), lens, scale)
                err = (out.float() - ref).abs().max().item()
                row = row_err(out, ref) if dt == torch.bfloat16 else 0.0
                ok = err <= ATTN_TOL[dt] and row <= ATTN_ROW_TOL_BF16
                what = f"max err {err:.3e}, row check {row:.2e}"
            elif key == "gather":
                ok = torch.equal(out, sort_gather.gather_rows_plain(*a))
                what = "bit-exact" if ok else "differs"
            elif key == "scatter":
                ref = sort_gather.scatter_rows_plain(*a)
                err = rel(out, ref)
                ok, what = err <= SCATTER_TOL[dt], f"rel err {err:.3e}"
            elif key == "mas":
                ok = torch.equal(out, mas.b_mas_plain(*a[:3]))
                what = "bit-exact" if ok else "differs"
            elif key == "ctc_lattice":
                em, il, ol = a[:3]
                alpha, beta = out
                ok = torch.equal(alpha, forward_sum.ctc_alpha_plain(em, ol))
                if beta is not None:
                    ok = ok and torch.equal(
                        beta, forward_sum.ctc_beta_plain(em, il, ol))
                what = "bit-exact" if ok else "differs"
            elif key == "ctc_grad":
                err = rel(out, forward_sum.ctc_grad_plain(*a))
                ok, what = err <= CTC_GRAD_TOL, f"rel err {err:.3e}"
            elif key == "relpos":
                q, k, v, pos, ub, vb, scale = a[:7]
                p = kw.get("dropout_p", 0.0)
                seed = None
                if p > 0.0:
                    seed = ra.draw_seed(torch.Generator(q.device).set_state(
                        gstate), q.device)
                ref = ra.relpos_attention_plain(
                    q.float(), k.float(), v.float(), pos.float(), ub, vb,
                    scale, p, seed, kw.get("key_padding_mask"),
                    kw.get("head_range"))
                err = rel(out, ref)
                ok, what = err <= RELPOS_TOL[dt], f"rel err {err:.3e}"
            elif key == "local_window":
                qk, v, valid, window, scale = a
                err = rel(out, lw.local_window_attention_plain(
                    qk.float(), v.float(), valid, window, scale))
                ok, what = err <= WINDOW_TOL[dt], f"rel err {err:.3e}"
            else:                                        # lsh_chunk
                qk, v = a[:2]
                d = qk.shape[-1]
                ref = lc.chunk_attention_plain(qk.float(), v.float(), *a[2:])
                err = rel(out[..., :d], ref[..., :d])
                ok, what = err <= WINDOW_TOL[dt], f"rel err {err:.3e}"
            lines.append(f"{key} {str(dt)[6:]} {shape}: {what} "
                         f"{'ok' if ok else 'MISMATCH'}")
            print(f"  kernel vs plain at this rank's shape: {lines[-1]}",
                  flush=True)
            if not ok:
                raise AssertionError(f"{key} at {shape}: {what}")
        return lines


def grid_rank(spec_path, rank):
    """One rank of phase 14 (``python3 chip_smoke.py --grid-rank SPEC
    RANK``): joins the spec's group (two ranks: gloo on this card; more:
    NCCL, one card a rank) and runs the spec's jobs in order, each result
    to ``<out>/<job>.r<rank>.pt``."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    from ctts_torch.parallel.mesh import init_distributed, make_mesh
    with open(spec_path) as f:
        spec = json.load(f)
    gloo = spec["backend"] == "gloo"             # every rank on this card
    init_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                     device="cuda" if gloo else f"cuda:{rank}",
                     backend=spec["backend"])
    try:
        for name, job in spec["jobs"].items():
            d, m = (int(x) for x in job["grid"].split("x"))
            grid = make_mesh(d, m)
            t0 = time.perf_counter()
            res = grid_job(job, grid)
            print(f"{name} rank {rank} (data rank {grid.data_rank}, model "
                  f"rank {grid.model_rank}): {time.perf_counter() - t0:.1f} "
                  f"s; total {res['losses'][0]['total']:.4f}; launches "
                  f"{res['launches']}", flush=True)
            torch.save(res, os.path.join(spec["out"], f"{name}.r{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, REPO)
    smoke = Smoke()
    smoke.card = card
    smoke.phase("build", smoke.build)
    # each group runs only when every phase before it passed
    groups = [
        [("attention kernel vs plain", smoke.attention),
         ("gather kernel vs plain", smoke.gather),
         ("trained-weights probe", smoke.probe)],
        [("vocoder", smoke.vocoder), ("synthesize CLI", smoke.cli),
         ("scatter kernel vs plain", smoke.scatter),
         ("MAS kernel vs plain", smoke.mas),
         ("CTC kernels vs plain", smoke.ctc),
         ("attention backward vs plain", smoke.attention_backward)],
        [("train step", smoke.train)],
        [("supervised train step", smoke.sup_train),
         ("supervised train CLI", smoke.sup_train_cli),
         ("variance options", smoke.variance_options)],
        [("relpos kernels vs plain", smoke.relpos)],
        [("conformer forward", smoke.conformer_forward),
         ("conformer train CLI", smoke.conformer_train)],
        [("local-window kernels vs plain", smoke.local_window),
         ("LSH chunk kernels vs plain", smoke.lsh_chunk)],
        [("reformer forward", smoke.reformer_forward),
         ("reformer train", smoke.reformer_train)],
        [("transformer, fastformer, lstransformer: forward and train",
          smoke.block_zoo),
         ("VCTK train CLI", smoke.vctk_train_cli),
         ("VCTK train step at [16, 128, 1298]", smoke.vctk_step),
         ("VCTK synthesize CLI", smoke.vctk_synthesize)],
        [("prosody du2021", smoke.prosody_du2021),
         ("prosody liu2021", smoke.prosody_liu2021)],
        [("preprocess on the card", smoke.preprocess_lj),
         ("VCTK preprocess on the card", smoke.preprocess_vctk),
         ("train from the preprocessed store", smoke.train_from_store)],
        [("fused resblock kernel vs plain", smoke.fused_resblock),
         ("vocoder, fused resblocks", smoke.vocoder_fused),
         ("serve", smoke.serve),
         ("synthesize CLI, batch and stream", smoke.cli_batch),
         ("flip kernel vs plain", smoke.flip)],
        [("the (data, model) grid: two ranks on the card, and the train "
          "CLI over NCCL", smoke.grid)],
        [("long utterances: the kernels across their old limits",
          smoke.long_kernels),
         ("long utterances: a train_unsup step at 640 phones, 2560 frames",
          smoke.long_step),
         ("long utterances: the train CLI on the streaming loader",
          smoke.long_stream_cli)]]
    for group in groups:
        for name, fn in group:
            if not smoke.failures:
                smoke.phase(name, fn)
    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(f"profiles: {PROFILES['whole']} kept, {PROFILES['lost_lead']} of "
          f"them without their first 1-{PROFILES['most_lost']} leading "
          f"markers; {PROFILES['rejected']} rejected")
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def grid_cards(cli_only=False):
    """``python3 chip_smoke.py --grid-cards [--cli]``: phase 14 with one
    rank a card over NCCL on every card of the host (at least 4; not part
    of the run with no arguments, which needs one card); with ``--cli``
    only its train CLI and resume."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 4 or n % 2:
        print(f"chip_smoke --grid-cards: needs an even count of at least 4 "
              f"CUDA devices, found {n}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    smoke = Smoke()
    smoke.card = card_line()
    print(f"cards: {smoke.card}", flush=True)
    smoke.phase("build", smoke.build)
    if not smoke.failures:
        smoke.phase(f"the (data, model) grid on {n} cards over NCCL",
                    lambda: smoke.grid_train_cli(n) if cli_only
                    else smoke.grid(n))
    return 1 if smoke.failures else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-rank"]:
        sys.exit(grid_rank(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--grid-cards"]:
        sys.exit(grid_cards(sys.argv[2:3] == ["--cli"]))
    sys.exit(main())
