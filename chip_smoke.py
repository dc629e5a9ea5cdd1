#!/usr/bin/env python3
"""Drive the PyTorch port (ctts_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure makes the exit code 1 and
suppresses the final line:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``ctts_torch/csrc/`` (into the gitignored ``build/``);
2. each kernel against its plain PyTorch version at the served shapes,
   with the tolerance stated, and its time beside the plain version's, one
   library call's and the bound computed from the shapes;
3. the trained-weights probe: ``assets/ljdemo_ckpt.npz`` with the
   ``configs/LJSpeech.yaml`` defaults (bf16 stacks) on the 4 texts of
   ``assets/ljdemo_ckpt_manifest.json`` at the 1152-frame budget, held to
   the manifest; the launch counters are zeroed just before this forward
   and read just after it;
4. HiFi-GAN V1 at full width with seeded random weights on the probe mels,
   then the synthesize CLI once on one text;
5. the training kernels against their plain versions at the train step's
   shapes (B=16, T_s=128, T_m=896, ragged lengths from a seed): the row
   scatter, MAS (bit-exact), the CTC alpha lattice and the CTC gradient,
   and the attention backward; each with its time, its bound, the
   barrier-chain floor where the work is a chain of frames, and one library
   call as a yardstick; the scatter also at the reformer's un-sort and LSH
   chunk-backward shapes;
6. the ``train_unsup`` step of ``ctts_torch.parallel.train_step`` at full
   width and depth in bf16, from ``assets/ljdemo_ckpt.npz`` (step 13301, the
   hard-upsample regime): three steps on one seeded batch with the launch
   counters zeroed before each and read after it, one step below
   ``binarization_start_steps`` (soft upsample), one above
   ``var_start_steps``, then timed steps and one under ``torch.profiler``;
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
   the conformer config: 8 steps, and 4 + a resume for 4 more, the loss
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
   3 + a resume for 3 more; then counted, timed and profiled steps at
   [16, 128 tokens, 896 frames] on both routes;
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
14. the ``kernels`` JSON line, the card line, and the result line.

Exits non-zero without a result when no CUDA device is present.
"""

import io
import json
import os
import shutil
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
# the train step's shapes
B_TRAIN, T_S, T_M = 16, 128, 896
# scatter: float32 sums of up to ~20 rows in another order than the plain
# version's atomics; bfloat16 adds one rounding of the float32 sum on each
# side, which may land on neighbouring values
SCATTER_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# alpha: relative to max(1, |alpha|); ~900 dependent float32 log-sum-exps
# whose expf/logf differ from PyTorch's by ulps
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


def profiled(body, cpu=False, inner=0):
    """Run ``body()`` under torch.profiler between marker kernels, a run of
    leading ones before it and one after. In a process that has taken many
    profiles, each profile loses its first records (PERF.md §7); the
    leading markers are those records, so a profile is kept while at least
    one of them, the ``inner`` markers that ``body`` launches itself and
    the closing one came back. Returns (the device events other than the
    markers, host ms of ``body``, those events cut at the inner markers),
    or None when every try lost more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    for n_lead in LEADS:
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


class Smoke:
    def __init__(self):
        self.failures = []
        self.kernels = {}

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        try:
            return fn()
        except Exception:                                # report, go on
            traceback.print_exc()
            print(f"FAILED: {name}", flush=True)
            self.failures.append(name)
            return None

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
        N, d = 8, 128
        worst = 0.0
        for T in (96, 1152):
            lens = torch.tensor([T, T, T - 9, T - 9, T // 2, T // 2 + 1, 1, 0],
                                dtype=torch.int32, device=dev)
            q, k, v = (randn(gen, N, T, d).to(dev) for _ in range(3))
            for dtype in (torch.bfloat16, torch.float32):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                got = attention.fused_attention(qd, kd, vd, lens, d ** -0.5)
                ref = attention.attention_plain(qd.float(), kd.float(),
                                                vd.float(), lens, d ** -0.5)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item()
                ok = err <= ATTN_TOL[dtype] and bool(torch.isfinite(got).all())
                print(f"attention T={T} {str(dtype)[6:]}: max|kernel - plain "
                      f"f32| = {err:.3e} (tol {ATTN_TOL[dtype]:g}) "
                      f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"attention T={T} {dtype}: {err}")
                worst = max(worst, err)

        man = json.load(open(MANIFEST))["probe"]
        per_shape = {}
        for T, per_utt in ((1152, man["expect_mel_lens"]),
                           (96, man["src_lens"])):
            lens = torch.tensor(np.repeat(per_utt, 2), dtype=torch.int32,
                                device=dev)
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
            per_shape[T] = (ms, plain_ms, lib_ms, b_ms, b_by)
            print(f"attention timing bf16 N={N} T={T} d={d} lengths="
                  f"{lens.tolist()}: device ms kernel {ms:.4f}, plain "
                  f"{plain_ms:.4f}, sdpa {lib_ms:.4f}; event ms (launch gaps included) kernel "
                  f"{ev_ms:.4f}, plain {ev_plain:.4f}, sdpa {ev_lib:.4f}; "
                  f"bound {b_ms:.5f} ms ({b_by})")
        ms, plain_ms, lib_ms, b_ms, b_by = per_shape[1152]
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
        vals = randn(gen, G, N, F).to(dev)
        idx_full = idx.long()[..., None].expand(G, M, F).contiguous()
        ms, ev_ms = timings(lambda: sort_gather.gather_rows(vals, idx))
        plain_ms, ev_plain = timings(
            lambda: sort_gather.gather_rows_plain(vals, idx))
        lib_ms, ev_lib = timings(lambda: torch.gather(vals, 1, idx_full))
        nbytes = G * N * F * 4 + G * M * 4 + G * M * F * 4
        b_ms, b_by = bound(0, nbytes, PEAK_BF16_FLOPS)
        print(f"gather timing f32 G={G} N={N} M={M} F={F}: device ms kernel "
              f"{ms:.4f}, plain {plain_ms:.4f}, torch.gather {lib_ms:.4f}; event ms "
              f"(launch gaps included) kernel {ev_ms:.4f}, plain "
              f"{ev_plain:.4f}, torch.gather {ev_lib:.4f}; bound {b_ms:.5f} "
              f"ms ({b_by})")
        self.kernels["gather_rows"] = {
            "name": "gather_rows", "route": "cuda",
            "source": "ctts_torch/csrc/gather_rows.cu",
            "replaces": "ctts_tpu/ops/sort_gather.py:84", "launches": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": "f32 G=4 N=97 M=1152 F=256"}

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
        busy ms, idle share)."""
        got = profiled(forward, cpu=True)
        if got is None:
            print(f"{what} under the profiler: no whole profile, device busy "
                  f"not measured")
            return float("nan"), float("nan"), float("nan")
        events, wall, _ = got
        per = {}
        for e in events:
            n, us = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in per.values()) / 1e3
        print(f"{what} under the profiler: wall {wall:.2f} ms, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
              f"{sum(n for n, _ in per.values())} kernels")
        for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {us / 1e3:8.3f} ms  {n:4d}x  {name[:100]}")
        return wall, busy, 1 - busy / wall

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
        ms, ev_ms = timings(lambda: mas.b_mas(seeded, il, ol), only="mas_kernel")
        whole_ms, _ = timings(lambda: mas.b_mas(seeded, il, ol))
        plain_ms, _ = timings(lambda: mas.b_mas_plain(seeded, il, ol), iters=2)
        # rows at or past out_len are never read; every output row is written
        nbytes = int(mel_lens.sum()) * T_S * 4 + B_TRAIN * T_M * T_S * 4 \
            + 2 * B_TRAIN * 4
        chain_ms = kernels.barrier_chain_ms(B_TRAIN, T_S, int(mel_lens.max()))
        b_ms = self.record(
            "b_mas", "ctts_torch/csrc/mas.cu",
            "ctts_tpu/ops/mas.py:131,174", 0.0, ms, plain_ms, nbytes, None,
            f"f32 B={B_TRAIN} T_m={T_M} T_s={T_S}, ragged lengths",
            chain_floor_ms=chain_ms)
        print(f"MAS timing B={B_TRAIN} T_m={T_M} T_s={T_S}: device ms kernel "
              f"{ms:.4f} (with the wrapper's log and clamp {whole_ms:.4f}), "
              f"plain {plain_ms:.3f}; event ms of the wrapper {ev_ms:.4f}; "
              f"bound {b_ms:.5f} ms (bytes); barrier-chain floor "
              f"{chain_ms:.4f} ms ({int(mel_lens.max())} frames, {T_S} "
              f"threads); no library call computes it")

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

        alpha = fs.ctc_alpha(em, ol)
        alpha_plain = fs.ctc_alpha_plain(em, ol)
        alpha64 = fs.ctc_alpha_plain(em.double(), ol)
        torch.cuda.synchronize()
        a_err = rel_err(alpha, alpha_plain)
        a_abs = (alpha - alpha_plain)[alpha_plain > -1e8].abs().max().item()
        print(f"CTC alpha [B={B_TRAIN}, T_m={T_M}, S={S}]: max|kernel - "
              f"plain| / max(1, |plain|) = {a_err:.3e} (tol {CTC_ALPHA_TOL:g}; "
              f"absolute {a_abs:.3e} at |alpha| up to "
              f"{alpha_plain[alpha_plain > -1e8].abs().max().item():.0f}); "
              f"against float64 plain: kernel "
              f"{rel_err(alpha.double(), alpha64):.3e}, float32 plain "
              f"{rel_err(alpha_plain.double(), alpha64):.3e}")
        if not a_err <= CTC_ALPHA_TOL:
            raise AssertionError(f"ctc_alpha: {a_err}")

        i2 = 2 * il.long()
        finals = alpha_plain[:, -1].gather(1, torch.stack([i2, i2 - 1], 1))
        log_l = torch.logsumexp(finals, dim=-1)
        g = (1.0 / (il.float() * B_TRAIN)).contiguous()   # the loss's cotangent
        dem = fs.ctc_grad(em, alpha_plain, log_l, g, il, ol)
        dem_plain = fs.ctc_grad_plain(em, alpha_plain, log_l, g, il, ol)
        dem64 = fs.ctc_grad_plain(em.double(), alpha64, torch.logsumexp(
            alpha64[:, -1].gather(1, torch.stack([i2, i2 - 1], 1)), -1),
            g.double(), il, ol)
        torch.cuda.synchronize()
        scale = dem_plain.abs().max().item()
        g_err = (dem - dem_plain).abs().max().item() / scale
        print(f"CTC gradient: max|kernel - plain| = {g_err:.3e} of the "
              f"largest entry {scale:.3e} (tol {CTC_GRAD_TOL:g}); against "
              f"float64 plain: kernel "
              f"{(dem.double() - dem64).abs().max().item() / scale:.3e}, "
              f"float32 plain "
              f"{(dem_plain.double() - dem64).abs().max().item() / scale:.3e}")
        if not (g_err <= CTC_GRAD_TOL and bool(torch.isfinite(dem).all())):
            raise AssertionError(f"ctc_grad: {g_err}")
        for b in range(B_TRAIN):
            if bool(dem[b, mel_lens[b]:].any()):
                raise AssertionError("ctc_grad: nonzero past out_len")

        # the whole loss through the autograd.Function, kernels both ways
        x = logprob.clone().requires_grad_(True)
        loss = fs.forward_sum_loss(x, il, ol)
        loss.backward()
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
              f"F.ctc_loss on the same inputs {lib.item():.6f}")
        if abs(loss.item() - lib.item()) > 1e-3 * abs(lib.item()) \
                or not bool(torch.isfinite(x.grad).all()):
            raise AssertionError("forward_sum_loss disagrees with F.ctc_loss")

        ms_a, ev_a = timings(lambda: fs.ctc_alpha(em, ol))
        plain_a, _ = timings(lambda: fs.ctc_alpha_plain(em, ol), iters=2)
        ms_g, ev_g = timings(lambda: fs.ctc_grad(em, alpha, log_l, g, il, ol))
        plain_g, _ = timings(lambda: fs.ctc_grad_plain(em, alpha, log_l, g,
                                                       il, ol), iters=2)
        lib_fwd, _ = timings(lib_loss, iters=10)

        def lib_both():
            lp.grad = None
            lib_loss().backward()

        lib_fb, _ = timings(lib_both, iters=10)
        live = int(mel_lens.sum())
        # the forward reads em below out_len and writes every alpha row; the
        # backward reads em and alpha below out_len and writes every row
        bytes_a = live * S * 4 + B_TRAIN * T_M * S * 4 + B_TRAIN * 4
        bytes_g = 2 * live * S * 4 + B_TRAIN * T_M * S * 4 + 4 * B_TRAIN * 4
        chain_ms = kernels.barrier_chain_ms(B_TRAIN, (S + 31) // 32 * 32,
                                            int(mel_lens.max()))
        shape = f"f32 B={B_TRAIN} T_m={T_M} S={S}, ragged lengths"
        b_a = self.record("ctc_alpha", "ctts_torch/csrc/forward_sum.cu",
                          "ctts_tpu/ops/forward_sum.py:157", a_abs, ms_a,
                          plain_a, bytes_a, lib_fwd, shape,
                          chain_floor_ms=chain_ms)
        b_g = self.record("ctc_grad", "ctts_torch/csrc/forward_sum.cu",
                          "ctts_tpu/ops/forward_sum.py:196", g_err * scale,
                          ms_g, plain_g, bytes_g, lib_fb, shape,
                          chain_floor_ms=chain_ms)
        print(f"CTC timing {shape}: device ms alpha kernel {ms_a:.4f}, plain "
              f"{plain_a:.3f}, F.ctc_loss forward {lib_fwd:.4f}, bound "
              f"{b_a:.5f} (bytes); gradient kernel {ms_g:.4f}, plain "
              f"{plain_g:.3f}, F.ctc_loss forward+backward {lib_fb:.4f}, "
              f"bound {b_g:.5f} (bytes); event ms alpha {ev_a:.4f}, gradient "
              f"{ev_g:.4f}; barrier-chain floor {chain_ms:.4f} ms "
              f"({int(mel_lens.max())} frames, {(S + 31) // 32 * 32} threads)")

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
        from ctts_torch.ops.kernels import launch_counts, reset_launch_counts
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

        hard = {"fused_attention": 10, "gather_rows": 2, "scatter_rows": 2,
                "b_mas": 1, "ctc_alpha": 1, "ctc_grad": 1}
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

        wall, busy, idle = self.breakdown(traced, "train step")
        print(f"train step, host clock around a synchronised step: median of "
              f"7 {np.median(times):.2f} ms, min {min(times):.2f}, max "
              f"{max(times):.2f}; under the profiler wall {wall:.2f} ms, "
              f"device busy {busy:.2f} ms, idle share {idle:.3f}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")


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
                      generator=None, key_padding_mask=None):
                return ra.relpos_attention_plain(q, k, v, pos, ub, vb, scale,
                                                 dropout_p, None,
                                                 key_padding_mask)

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
    def write_store(root, n_train=64, n_val=8, seed=0):
        """A synthetic LJSpeech-shaped ``.npy`` store (75-128 phones,
        500-896 frames of 80 mel bins, CWT pitch, frame energy), in the
        layout ``ctts_torch.data.dataset.Dataset`` reads."""
        rng = np.random.RandomState(seed)
        phones = ("AA1 AE1 AH0 B D EH1 F G HH IY1 K L M N OW1 P R S T UW1 V "
                  "W Z").split()
        for d in ("mel_unsup", "pitch_unsup", "f0_unsup", "energy_unsup_frame",
                  "cwt_spec_unsup", "f0cwt_mean_std_unsup"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        lines = []
        for i in range(n_train + n_val):
            base, spk = f"LJ{i:04d}", "LJSpeech"
            T_s = int(rng.randint(75, T_S + 1))
            T_m = int(rng.randint(500, T_M + 1))
            f0 = (np.abs(rng.randn(T_m)) * 40 + 150).astype(np.float32)
            f0[rng.rand(T_m) < 0.2] = 0.0
            arrays = {
                "mel_unsup/{s}-mel-{b}": (rng.randn(T_m, 80) * 0.5 - 4.0
                                          ).astype(np.float32),
                "pitch_unsup/{s}-pitch-{b}": np.clip(f0 / 4, 1, 255).astype(
                    np.int64),
                "f0_unsup/{s}-f0-{b}": f0,
                "energy_unsup_frame/{s}-energy-{b}": (rng.rand(T_m) * 8 - 1
                                                      ).astype(np.float32),
                "cwt_spec_unsup/{s}-cwt_spec-{b}": rng.randn(T_m, 10).astype(
                    np.float32),
                "f0cwt_mean_std_unsup/{s}-f0cwt_mean_std-{b}": np.array(
                    [5.3, 0.2], np.float32)}
            for name, a in arrays.items():
                np.save(os.path.join(root, name.format(s=spk, b=base) + ".npy"),
                        a)
            text = "{" + " ".join(rng.choice(phones, T_s)) + "}"
            lines.append(f"{base}|{spk}|{text}|synthetic")
        for split, part in (("train", lines[:n_train]), ("val", lines[n_train:])):
            with open(os.path.join(root, f"{split}_unsup.txt"), "w") as f:
                f.write("\n".join(part) + "\n")
        with open(os.path.join(root, "speakers.json"), "w") as f:
            json.dump({"LJSpeech": 0}, f)
        with open(os.path.join(root, "stats.json"), "w") as f:
            json.dump({"f0_unsup": [214.2, 63.4],
                       "energy_unsup_frame": [-1.17, 9.09, 37.2, 31.7]}, f)

    def conformer_train(self):
        """``python -m ctts_torch.train`` on a synthetic store with the
        conformer config at full width and depth (bf16, batch 16, the
        device cache, dropout on, the warm-up cut to 50 steps so a few
        steps move the loss): 8 straight steps, and 4 + a resume from the
        step-4 checkpoint for 4 more. Then the same model's steps in this
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
            self.run_train_cli(raw, tmp, "resumed", 4)
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
                    "scatter_rows": 1, "b_mas": 1, "ctc_alpha": 1,
                    "ctc_grad": 1}
            if counts != want:
                raise AssertionError(f"expected launches {want}, got {counts}")
            for name, n in counts.items():
                self.kernels[name].setdefault("launches_conformer_step", n)
            self.kernels["relpos_fwd"]["launches"] = counts["relpos_fwd"]
            self.kernels["relpos_bwd"]["launches"] = counts["relpos_bwd"]
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.reset_peak_memory_stats()

            def traced():
                step(state, batch)
                torch.cuda.synchronize()

            wall, busy, idle = self.breakdown(traced, "conformer train step")
            print(f"conformer train step, host clock around a synchronised "
                  f"step: median of 5 {np.median(times):.2f} ms, min "
                  f"{min(times):.2f}, max {max(times):.2f}; under the profiler "
                  f"wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
                  f"{idle:.3f}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    def run_train_cli(self, raw, tmp, name, max_steps, restore=0):
        """``python -m ctts_torch.train`` with the merged config ``raw``
        under ``tmp/name``; returns its log lines by step."""
        from ctts_torch.config import dump_yaml
        cfg_dir = os.path.join(tmp, name)
        os.makedirs(cfg_dir, exist_ok=True)
        raw["train"]["path"] = {k: os.path.join(cfg_dir, k)
                                for k in ("ckpt_path", "log_path",
                                          "result_path")}
        with open(os.path.join(cfg_dir, "LJSpeech.yaml"), "w") as f:
            f.write(dump_yaml(raw))
        cmd = [sys.executable, "-m", "ctts_torch.train", "--dataset",
               "LJSpeech", "--config_dir", cfg_dir, "--max_steps",
               str(max_steps), "--restore_step", str(restore)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600)
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
        on, the warm-up cut to 50 steps): 6 straight steps, and 3 + a
        resume from the step-3 checkpoint for 3 more. Then ``train_unsup``
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
            self.run_train_cli(raw, tmp, "resumed", 3)
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
                        "b_mas": 1, "ctc_alpha": 1, "ctc_grad": 1, **lsh}
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
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    step(state, batch)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.reset_peak_memory_stats()

                def traced():
                    step(state, batch)
                    torch.cuda.synchronize()

                wall, busy, idle = self.breakdown(
                    traced, f"reformer train step ({route})")
                print(f"reformer train step ({route}), host clock around a "
                      f"synchronised step: median of 5 {np.median(times):.2f}"
                      f" ms, min {min(times):.2f}, max {max(times):.2f}; "
                      f"under the profiler wall {wall:.2f} ms, device busy "
                      f"{busy:.2f} ms, idle share {idle:.3f}; peak device "
                      f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                      f" GiB")
                del model, opt, state
        finally:
            os.environ.pop("CTTS_FUSED_LSH", None)


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

    def cli_batch(self):
        """``python -m ctts_torch.synthesize --mode batch --stream_chunk 64``
        on the manifest's 4 texts (a metadata file of their phones) with
        the trained weights and HiFi-GAN at seed 0, saved as an upstream
        checkpoint under ``--vocoder_ckpt``."""
        from ctts_torch.config import dump_yaml, get_configs_of, load_yaml
        from ctts_torch.text.symbols import symbols
        from ctts_torch.utils.model import get_vocoder
        man = json.load(open(MANIFEST))["probe"]
        with tempfile.TemporaryDirectory() as tmp:
            mc = get_configs_of("LJSpeech")[1]
            _, gen = get_vocoder(mc, ckpt_dir=os.path.join(tmp, "none"),
                                 device="cpu", seed=0)
            os.makedirs(os.path.join(tmp, "ckpt", "hifigan"))
            torch.save({"generator": gen.state_dict()}, os.path.join(
                tmp, "ckpt", "hifigan",
                f"generator_{mc['vocoder']['speaker']}.pth.tar"))
            raw = load_yaml(open(os.path.join(REPO, "configs",
                                              "LJSpeech.yaml")))
            raw["preprocess"]["path"]["preprocessed_path"] = tmp
            os.makedirs(os.path.join(tmp, "cfg"))
            with open(os.path.join(tmp, "cfg", "LJSpeech.yaml"), "w") as f:
                f.write(dump_yaml(raw))
            with open(os.path.join(tmp, "speakers.json"), "w") as f:
                json.dump({"LJSpeech": 0}, f)
            with open(os.path.join(tmp, "meta.txt"), "w") as f:
                for i, (ids, n) in enumerate(zip(man["texts"],
                                                 man["src_lens"])):
                    phones = " ".join(symbols[j][1:] for j in ids[:n])
                    f.write(f"probe{i}|LJSpeech|{{{phones}}}|probe {i}\n")
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
        [("relpos kernels vs plain", smoke.relpos)],
        [("conformer forward", smoke.conformer_forward),
         ("conformer train CLI", smoke.conformer_train)],
        [("local-window kernels vs plain", smoke.local_window),
         ("LSH chunk kernels vs plain", smoke.lsh_chunk)],
        [("reformer forward", smoke.reformer_forward),
         ("reformer train", smoke.reformer_train)],
        [("fused resblock kernel vs plain", smoke.fused_resblock),
         ("vocoder, fused resblocks", smoke.vocoder_fused),
         ("serve", smoke.serve),
         ("synthesize CLI, batch and stream", smoke.cli_batch),
         ("flip kernel vs plain", smoke.flip)]]
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


if __name__ == "__main__":
    sys.exit(main())
