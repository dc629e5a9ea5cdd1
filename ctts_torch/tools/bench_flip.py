"""The relpos backward's absolute-to-relative scatter in the four forms of
tools/bench_flip.py, timed on the card.

    python -m ctts_torch.tools.bench_flip [--iters 20]

Times :func:`ctts_torch.ops.flip.flip` (``csrc/bench_flip.cu``) in each
variant at the tool's shapes: dS ``[B·H, T, T]`` bf16 at B=16, H=8, T=896,
tiles of BQ=128 rows, on seed-0 inputs. Prints one JSON line like the TPU
tool's, with device milliseconds from the card; it writes no file
(``FLIP_BENCH.json`` stays the TPU's record).
"""

import argparse
import json

import torch

from ctts_torch.ops.flip import BQ, VARIANTS, flip

B, H, T = 16, 8, 896


def main(argv=None):
    """Time every variant on the card; print and return the JSON record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flip times the CUDA kernel and needs a "
                           "CUDA device")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B * H, T, T, generator=gen).to("cuda", torch.bfloat16)
    results = {}
    for variant in VARIANTS:
        for _ in range(3):
            flip(x, variant)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            flip(x, variant)
        end.record()
        torch.cuda.synchronize()
        results[variant] = start.elapsed_time(end) / args.iters
        print(f"{variant}: {results[variant]:.4f} ms", flush=True)
    out = {
        "metric": "relpos_bwd_scatter_ms",
        "shapes": f"B{B} H{H} T{T} BQ{BQ} bf16",
        "device": torch.cuda.get_device_name(0),
        "variants_ms": results,
        "scatter_tax_ms": {k: v - results["baseline"]
                           for k, v in results.items() if k != "baseline"},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
