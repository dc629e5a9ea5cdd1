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
   call as a yardstick;
6. the ``train_unsup`` step of ``ctts_torch.parallel.train_step`` at full
   width and depth in bf16, from ``assets/ljdemo_ckpt.npz`` (step 13301, the
   hard-upsample regime): three steps on one seeded batch with the launch
   counters zeroed before each and read after it, one step below
   ``binarization_start_steps`` (soft upsample), one above
   ``var_start_steps``, then timed steps and one under ``torch.profiler``;
7. the ``kernels`` JSON line, the card line, and the result line.

Exits non-zero without a result when no CUDA device is present.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def device_ms(fn, iters=50, only=None):
    """Device time of one call: the summed duration of every kernel the
    profiler (CUPTI) records over ``iters`` calls (of those whose name
    contains ``only``, when given), divided by ``iters``. Unlike CUDA events
    around a stream of calls, it leaves out the gaps in which the device
    waits for the host to launch. None if the profiler recorded no
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (only is None or only in e.name))
    return us / 1e3 / iters if us > 0 else None


def timings(fn, iters=50, only=None):
    """(ms, event ms): ms is the device time when the profiler sees device
    activity, else the event time; the event time includes launch gaps."""
    ev = cuda_ms(fn, warmup=min(10, iters), iters=2 * iters)
    dev = device_ms(fn, iters=iters, only=only)
    if dev is None:
        print("  (the profiler recorded no kernel: event time used)")
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
        for ln in LIBRARY.ptxas_log.splitlines():
            if ln.startswith("---") or "Used" in ln:
                print(f"  {ln.split('info    : ')[-1]}")

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
        from ctts_torch.ops import attention, sort_gather
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
        attention.launches = 0
        sort_gather.launches = 0
        t0 = time.perf_counter()
        out = forward()
        latency = time.perf_counter() - t0
        counts = {"fused_attention": attention.launches,
                  "gather_rows": sort_gather.launches}
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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward()
            wall_us = (time.perf_counter() - t0) * 1e6
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = per.get(e.name, (0, 0.0))
                per[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in per.values())
        print(f"{what} under the profiler: wall {wall_us / 1e3:.2f} "
              f"ms, device busy {busy / 1e3:.3f} ms, idle share "
              f"{1 - busy / wall_us:.3f}, {sum(n for n, _ in per.values())} "
              f"kernels")
        for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {us / 1e3:8.3f} ms  {n:4d}x  {name[:100]}")
        return wall_us / 1e3, busy / 1e3, 1 - busy / wall_us

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

        idx = torch.from_numpy(sorted_idx).to(dev)
        n_out, F = T_S + 1, 256
        vals = torch.from_numpy(rng.randn(G, M, F).astype(np.float32)).to(dev)
        flat = (idx.long() + n_out * torch.arange(G, device=dev)[:, None]
                ).reshape(-1)
        ms, ev_ms = timings(lambda: sort_gather.scatter_rows(vals, idx, n_out))
        plain_ms, ev_plain = timings(
            lambda: sort_gather.scatter_rows_plain(vals, idx, n_out))
        lib_ms, ev_lib = timings(lambda: torch.zeros(
            G * n_out, F, device=dev).index_add_(0, flat, vals.view(-1, F)))
        nbytes = G * M * F * 4 + G * M * 4 + G * n_out * F * 4
        b_ms = self.record(
            "scatter_rows", "ctts_torch/csrc/scatter_rows.cu",
            "ctts_tpu/ops/sort_gather.py:92", worst, ms, plain_ms, nbytes,
            lib_ms, f"f32 G={G} M={M} n_out={n_out} F={F}, sorted idx")
        print(f"scatter timing f32 G={G} M={M} n_out={n_out} F={F}: device ms "
              f"kernel {ms:.4f}, plain {plain_ms:.4f}, zeros+index_add_ "
              f"{lib_ms:.4f}; event ms (launch gaps included) kernel "
              f"{ev_ms:.4f}, plain {ev_plain:.4f}, index_add_ {ev_lib:.4f}; "
              f"bound {b_ms:.5f} ms (bytes)")

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
        whole_ms = device_ms(lambda: mas.b_mas(seeded, il, ol))
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
        from ctts_torch.ops import attention, forward_sum, mas, sort_gather
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

        def reset():
            attention.launches = sort_gather.launches = 0
            sort_gather.scatter_launches = mas.launches = 0
            forward_sum.alpha_launches = forward_sum.grad_launches = 0

        def counts():
            return {"fused_attention": attention.launches,
                    "gather_rows": sort_gather.launches,
                    "scatter_rows": sort_gather.scatter_launches,
                    "b_mas": mas.launches,
                    "ctc_alpha": forward_sum.alpha_launches,
                    "ctc_grad": forward_sum.grad_launches}

        def one(what):
            reset()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = counts()
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
    if not smoke.failures:
        smoke.phase("attention kernel vs plain", smoke.attention)
        smoke.phase("gather kernel vs plain", smoke.gather)
        smoke.phase("trained-weights probe", smoke.probe)
    if not smoke.failures:
        smoke.phase("vocoder", smoke.vocoder)
        smoke.phase("synthesize CLI", smoke.cli)
        smoke.phase("scatter kernel vs plain", smoke.scatter)
        smoke.phase("MAS kernel vs plain", smoke.mas)
        smoke.phase("CTC kernels vs plain", smoke.ctc)
        smoke.phase("attention backward vs plain", smoke.attention_backward)
    if not smoke.failures:
        smoke.phase("train step", smoke.train)
    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
