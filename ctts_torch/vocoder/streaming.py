"""Chunked (streaming) vocoding with an exact overlap-crop
(ctts_tpu/vocoder/streaming.py).

HiFi-GAN and MelGAN are convnets with a finite receptive field: output
sample n depends only on mel frames within RF frames of n // hop. Vocoding a
window of ``chunk + 2·halo`` frames and keeping its centre ``chunk·hop``
samples therefore equals the full pass wherever ``halo`` ≥ the receptive
field; at the true utterance edges the window is clamped inside the
utterance, so the conv padding there is the full pass's too. The result
differs from the full pass only by the order of float sums (cuDNN may pick
other algorithms for the window's shape than for the full one).

Every window is enqueued on the device before the first is fetched, so the
card vocodes chunks i+1..n while the caller plays or sends chunk i. On the
card each chunk is copied without blocking into one pinned host buffer per
stream, with one event per chunk: the first chunk is returned as soon as
its window and copy are done. Unlike the JAX package no
per-(model, chunk) memo is kept: a torch generator has nothing to trace or
compile, so building the stream per call costs nothing.
"""

import torch

# conservative per-side receptive fields in mel frames (measured by input
# perturbation in tests/test_streaming.py: HiFi-GAN V1 13, MelGAN 6)
RF_MEL = 16
RF_MEL_MELGAN = 8


def make_chunked_vocoder(generator, chunk=64, halo=RF_MEL, hop=256):
    """A streaming vocoder over ``generator`` (mel [B, W, n_mel] → wav
    [B, W·hop], float32, e.g. :class:`HiFiGANGenerator`).

    Returns ``stream(mel)`` → an iterator of float32 numpy chunks
    [B, chunk·hop] (the last one [B, (T % chunk)·hop] when T is not a chunk
    multiple), equal to ``generator(mel)`` up to the order of float sums as
    long as ``halo`` ≥ the generator's receptive field in mel frames. An
    utterance shorter than one window is vocoded in one full pass."""
    if chunk <= 0 or halo < 0:
        raise ValueError(f"bad chunk={chunk} / halo={halo}")
    window = chunk + 2 * halo

    def stream(mel):
        device = next(generator.parameters()).device
        mel = torch.as_tensor(mel)
        B, T = mel.shape[:2]
        if T < window:
            # a short utterance: one full pass is already "streamed"
            jobs = [(0, T, 0, T * hop)]
        else:
            n_full, tail = divmod(T, chunk)
            jobs = []
            for i in range(n_full):
                # interior windows clamped inside the utterance, so a window
                # touching an edge has the full pass's conv padding
                off = min(max(i * chunk - halo, 0), T - window)
                jobs.append((off, window, (i * chunk - off) * hop,
                             chunk * hop))
            if tail:
                # the last partial chunk: the same window, end-aligned
                jobs.append((T - window, window, (window - tail) * hop,
                             tail * hop))
        on_card = device.type == "cuda"
        host = torch.empty(B * sum(keep for *_, keep in jobs),
                           pin_memory=on_card)
        outs, at = [], 0
        # grad mode is thread-local: the caller may be any thread
        with torch.inference_mode():
            mel = mel.to(device)
            # enqueue every window before the first fetch
            for off, width, start, keep in jobs:
                wav = generator(mel[:, off:off + width])
                dst = host[at:at + B * keep].view(B, keep)
                dst.copy_(wav[:, start:start + keep].contiguous(),
                          non_blocking=on_card)
                event = None
                if on_card:
                    event = torch.cuda.Event()
                    event.record()
                outs.append((dst, event))
                at += B * keep
        for dst, event in outs:
            if event is not None:
                event.synchronize()
            yield dst.numpy()

    return stream
