"""TTS HTTP server of the port on one card (reference surface: serve.py).

    python -m ctts_torch.serve --dataset LJSpeech \\
        --packed_ckpt assets/ljdemo_ckpt.npz [--device cuda] [--port 8000]

- **Shape buckets**: T_s rounds up to a multiple of 16; each request runs a
  probe at the 128-frame mel bucket, then the predicted length rounded up
  to a whole bucket, capped at 2·``max_seq_len``.
- **Micro-batching**: concurrent non-streaming requests with the same
  control knobs are coalesced by one worker thread into a padded batch
  (power-of-two batch buckets up to ``--max_batch``, a
  ``--batch_window_ms`` collection window after the first request).
- **Streaming** (``"stream": true``): the chunked vocoder
  (:mod:`ctts_torch.vocoder.streaming`) sends PCM as each chunk leaves the
  card, by HTTP chunked transfer encoding, behind a WAV header of unknown
  length. Streaming requests run solo (their target is time to first
  audio).
- **One device user at a time**: a lock serializes every use of the card;
  the HTTP layer is threaded, so health checks and request parsing never
  wait on it. Grad mode is thread-local in PyTorch, so the batching worker
  and the stream enter inference mode themselves.

Endpoints:
  GET  /healthz  -> {"ok": true, "requests": n, "batches": n}
  POST /tts      -> audio/wav
       body: {"text": "...", "pitch_control": 1.0, "energy_control": 1.0,
              "duration_control": 1.0, "stream": false}

Without vocoder weights under ``--vocoder_ckpt`` it serves griffin-lim.
"""

import argparse
import io
import json
import struct
import threading
import time
import wave
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ctts_torch.synthesize import preprocess_english
from ctts_torch.utils.model import vocoder_infer, vocoder_stream


def _wav_header_unknown_len(sr, max_riff=0xFFFFFFFF):
    """WAV header with unknown data size (the streaming convention:
    players treat 0xFFFFFFFF as 'read until EOF')."""
    return (b"RIFF" + struct.pack("<I", max_riff) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", max_riff))


def _round_up(x, m):
    return -(-max(x, 1) // m) * m


class _Request:
    """One queued synthesis request awaiting the batching worker."""

    __slots__ = ("seq", "controls", "done", "wav", "error")

    def __init__(self, seq, controls):
        self.seq, self.controls = seq, controls
        self.done = threading.Event()
        self.wav, self.error = None, None


class TTSService:
    """Acoustic model + vocoder behind one lock, with the shape buckets and
    the micro-batching worker."""

    def __init__(self, model, configs, vocoder, bucket=128, stream_chunk=64,
                 max_batch=8, batch_window_ms=10.0):
        self.model = model
        self.pre, self.mod, self.tr = configs
        self.vocoder = vocoder
        self.device = next(model.parameters()).device
        self.bucket = bucket
        self.stream_chunk = stream_chunk
        self.max_batch = max(1, int(max_batch))
        self.batch_window_ms = batch_window_ms
        self.sr = self.pre["preprocessing"]["audio"]["sampling_rate"]
        self.hop = self.pre["preprocessing"]["stft"]["hop_length"]
        self.lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self._queue = deque()
        self._cv = threading.Condition()
        self._worker = None

    def _infer_arrays(self, texts_np, lens_np, controls, mel_budget):
        """One forward at the static (B, T_s, mel_budget) shape. Rows are
        independent (masked attention, per-row norms), so padding rows never
        change real rows' outputs."""
        p, e, d = controls
        texts = torch.from_numpy(np.asarray(texts_np, np.int64))
        lens = torch.from_numpy(np.asarray(lens_np, np.int64))
        with torch.inference_mode():
            return self.model(
                torch.zeros(texts.shape[0], dtype=torch.long,
                            device=self.device),
                texts.to(self.device), lens.to(self.device), mode="infer",
                max_mel_len=int(mel_budget), p_control=float(p),
                e_control=float(e), d_control=float(d))

    def _budget(self, probe, n):
        """The right-sized mel budget from a probe's predicted durations of
        the first n rows."""
        total = int(probe["duration_rounded"][:n].sum(dim=1).max().item())
        return min(2 * self.mod["max_seq_len"], _round_up(total, self.bucket))

    def _infer_batch(self, seqs, controls, n):
        """Pad ``seqs`` into one batch, probe, and run at the right-sized
        budget. Returns (mel [B, T, n_mel] float32 numpy, mel_lens [B])."""
        t_s = _round_up(max(len(s) for s in seqs), 16)
        texts_np = np.zeros((len(seqs), t_s), np.int64)
        lens_np = np.zeros((len(seqs),), np.int64)
        for i, s in enumerate(seqs):
            texts_np[i, :len(s)] = s
            lens_np[i] = len(s)
        probe = self._infer_arrays(texts_np, lens_np, controls, self.bucket)
        t_m = self._budget(probe, n)
        out = (probe if t_m == self.bucket
               else self._infer_arrays(texts_np, lens_np, controls, t_m))
        return (out["postnet_mel_predictions"].float().cpu().numpy(),
                out["mel_lens"].cpu().numpy())

    def warmup(self, buckets=(128, 256)):
        """Run the probe bucket, the common serving buckets and every
        power-of-two batch bucket once, and the vocoder once on a full
        bucket and once streamed, so the first requests do not pay the
        card's first-use costs (kernel loading, cuDNN's choice of
        algorithm per shape, the stream's pinned host buffer)."""
        seq = [1] * 8
        with self.lock:
            for t_m in sorted(set((self.bucket,) + tuple(buckets))):
                self._infer_arrays(np.ones((1, 16), np.int64), [len(seq)],
                                   (1.0, 1.0, 1.0), t_m)
            b = 2
            while b <= self.max_batch:
                self._infer_arrays(np.ones((b, 16), np.int64),
                                   np.full((b,), len(seq)), (1.0, 1.0, 1.0),
                                   self.bucket)
                b *= 2
            if self.vocoder[0] != "griffin_lim":
                n_mel = self.pre["preprocessing"]["mel"]["n_mel_channels"]
                mel = np.full((1, self.bucket, n_mel), -5.0, np.float32)
                vocoder_infer(mel, self.vocoder, self.pre)
                for _ in vocoder_stream(mel, self.vocoder, self.pre,
                                        chunk=self.stream_chunk):
                    pass
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def synthesize(self, text, controls=(1.0, 1.0, 1.0), stream=False):
        """-> (sr, iterator of int16 PCM numpy chunks)."""
        seq = preprocess_english(text, self.pre)
        self.n_requests += 1
        if stream or self.max_batch <= 1:
            # streaming optimizes time-to-first-audio; run solo
            return self._synth_solo(seq, controls, stream)
        req = _Request(seq, tuple(controls))
        with self._cv:
            if self._worker is None:
                self._worker = threading.Thread(target=self._worker_loop,
                                                daemon=True)
                self._worker.start()
            self._queue.append(req)
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return self.sr, iter([req.wav])

    def _worker_loop(self):
        """The batching worker: pops one request, collects requests with the
        same control knobs for up to batch_window_ms, and synthesizes them
        as one padded batch."""
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                first = self._queue.popleft()
            batch = [first]
            deadline = time.monotonic() + self.batch_window_ms / 1e3
            while len(batch) < self.max_batch:
                with self._cv:
                    while (not self._queue
                           and (rem := deadline - time.monotonic()) > 0):
                        self._cv.wait(timeout=rem)
                    take = [r for r in self._queue
                            if r.controls == first.controls]
                    take = take[:self.max_batch - len(batch)]
                    for r in take:
                        self._queue.remove(r)
                batch.extend(take)
                if not take or deadline - time.monotonic() <= 0:
                    # the window expired, or the queue holds only requests
                    # with other control knobs (they form the next batch)
                    break
            try:
                self._run_batch(batch)
            except Exception as exc:                    # noqa: BLE001
                for r in batch:
                    r.error = exc
                    r.done.set()

    def _run_batch(self, batch):
        seqs = [r.seq for r in batch]
        n = len(seqs)
        B = 1
        while B < n:                    # power-of-two batch buckets bound
            B *= 2                      # the set of batch shapes
        seqs = seqs + [seqs[0]] * (B - n)
        with self.lock, torch.inference_mode():
            self.n_batches += 1
            mel, mel_lens = self._infer_batch(seqs, batch[0].controls, n)
            wavs = vocoder_infer(mel[:n], self.vocoder, self.pre,
                                 lengths=mel_lens[:n])
        for r, w in zip(batch, wavs):
            r.wav = w
            r.done.set()

    def _synth_solo(self, seq, controls, stream):
        """The unbatched path (streaming requests, or max_batch=1). Holds
        the device lock throughout."""
        with self.lock:
            mel, mel_lens = self._infer_batch([seq], controls, 1)
            n = int(mel_lens[0])
            if stream and self.vocoder[0] != "griffin_lim":
                from ctts_torch.vocoder.streaming import (RF_MEL,
                                                          RF_MEL_MELGAN)
                halo = (RF_MEL if self.vocoder[0] == "HiFi-GAN"
                        else RF_MEL_MELGAN)
                # cut the padded mel at the first chunk multiple at least
                # `halo` frames past the true length: every kept sample
                # (< n·hop) sees the mel context the full pass sees, and
                # padding frames beyond it are never vocoded
                keep = min(mel.shape[1],
                           _round_up(n + halo, self.stream_chunk))

                def chunks():
                    sent = 0
                    with self.lock:
                        for c in vocoder_stream(mel[:, :keep], self.vocoder,
                                                self.pre,
                                                chunk=self.stream_chunk):
                            take = min(c.shape[1], n * self.hop - sent)
                            if take > 0:
                                yield c[0, :take]
                            sent += c.shape[1]
                            if sent >= n * self.hop:
                                break
                return self.sr, chunks()
            wav = vocoder_infer(mel, self.vocoder, self.pre, lengths=[n])[0]
        return self.sr, iter([wav])


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):          # quiet by default
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps({"ok": True,
                               "requests": service.n_requests,
                               "batches": service.n_batches}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/tts":
                self.send_error(404)
                return
            try:
                req = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0)) or 0))
                text = req["text"]
            except Exception as exc:                 # noqa: BLE001
                self.send_error(400, f"bad request: {exc}")
                return
            controls = (float(req.get("pitch_control", 1.0)),
                        float(req.get("energy_control", 1.0)),
                        float(req.get("duration_control", 1.0)))
            stream = bool(req.get("stream", False))
            try:
                sr, chunks = service.synthesize(text, controls, stream)
            except Exception as exc:                 # noqa: BLE001
                self.send_error(500, f"synthesis failed: {exc}")
                return
            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send(chunk_bytes):
                    self.wfile.write(
                        f"{len(chunk_bytes):x}\r\n".encode()
                        + chunk_bytes + b"\r\n")
                    self.wfile.flush()

                send(_wav_header_unknown_len(sr))
                for c in chunks:
                    send(c.astype("<i2").tobytes())
                self.wfile.write(b"0\r\n\r\n")
            else:
                buf = io.BytesIO()
                with wave.open(buf, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sr)
                    for c in chunks:
                        w.writeframes(np.asarray(c).astype("<i2").tobytes())
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    return Handler


def make_server(service, host="127.0.0.1", port=0):
    """-> ThreadingHTTPServer bound to (host, port); port 0 = ephemeral."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    from ctts_torch import resolve_device
    from ctts_torch.config import get_configs_of
    from ctts_torch.utils.model import get_model, get_vocoder
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--restore_step", type=int, default=0)
    ap.add_argument("--packed_ckpt", default=None,
                    help="bf16 npz weights packed by the JAX package "
                         "(e.g. assets/ljdemo_ckpt.npz)")
    ap.add_argument("--config_dir", default=None)
    ap.add_argument("--vocoder_ckpt", default="ckpt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--stream_chunk", type=int, default=64)
    ap.add_argument("--max_batch", type=int, default=8,
                    help="dynamic micro-batching cap (1 disables)")
    ap.add_argument("--batch_window_ms", type=float, default=10.0,
                    help="collection window after the first queued request")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    configs = get_configs_of(args.dataset, args.config_dir)
    model = get_model(args.restore_step, configs,
                      packed_ckpt=args.packed_ckpt, device=device)
    vocoder = get_vocoder(configs[1], args.vocoder_ckpt, device=device)
    if vocoder[0] == "griffin_lim":
        print("NOTE: no vocoder weights; serving griffin-lim fallback")
    service = TTSService(model, configs, vocoder,
                         stream_chunk=args.stream_chunk,
                         max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms)
    print("warming up ...")
    service.warmup()
    srv = make_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{srv.server_address[1]}",
          flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
