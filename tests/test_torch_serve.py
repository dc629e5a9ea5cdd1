"""The port's serving path on the CPU: ``ctts_torch.serve`` over a real
socket with a tiny acoustic model and a narrow HiFi-GAN (mirroring
tests/test_serve.py), and ``python -m ctts_torch.synthesize`` in batch mode
with ``--stream_chunk`` as a subprocess. The served audio is held to the
port's direct path (``infer_mels`` + ``vocoder_infer``), which the other
``tests/test_torch_*.py`` files hold to the JAX package."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET, CHUNK = 64, 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs several workers on a few cores: keep torch's intra-op
    # pool small so these tests do not starve the others
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def service():
    from ctts_torch.serve import TTSService, make_server
    from ctts_torch.utils.model import get_model, init_weights
    from ctts_torch.utils.testing import tiny_configs
    from ctts_torch.vocoder.hifigan import HiFiGANGenerator, V1_CONFIG
    configs = tiny_configs()
    configs[0]["path"]["lexicon_path"] = "/nonexistent"
    model = get_model(0, configs, device="cpu")
    gen = init_weights(HiFiGANGenerator(
        dict(V1_CONFIG, upsample_initial_channel=32)), 1).eval()
    svc = TTSService(model, configs, ("HiFi-GAN", gen), bucket=BUCKET,
                     stream_chunk=CHUNK)
    svc.warmup()
    srv = make_server(svc)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    svc.url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield svc
    srv.shutdown()
    srv.server_close()


def _post(url, body):
    req = urllib.request.Request(
        url + "/tts", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers, r.read()


def _pcm(body):
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == \
            (22050, 1, 2)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_healthz(service):
    body = _healthz(service.url)
    assert body["ok"] is True and {"requests", "batches"} <= set(body)


def test_tts_full_wav_equals_the_direct_path(service):
    """A non-streaming request (through the batching worker) carries the
    audio of infer_mels + vocoder_infer on the same text."""
    from ctts_torch.synthesize import infer_mels, preprocess_english
    from ctts_torch.utils.model import vocoder_infer
    status, headers, body = _post(service.url, {"text": "Hello world."})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    got = _pcm(body)
    seq = preprocess_english("Hello world.", service.pre)
    t_s = -(-len(seq) // 16) * 16
    texts = np.zeros((1, t_s), np.int64)
    texts[0, :len(seq)] = seq
    batch = {"speakers": np.zeros(1, np.int64), "texts": texts,
             "src_lens": np.array([len(seq)])}
    configs = (service.pre, service.mod, service.tr)
    out = infer_mels(service.model, batch, configs, bucket=BUCKET)
    want = vocoder_infer(out["postnet_mel_predictions"], service.vocoder,
                         service.pre, lengths=out["mel_lens"].numpy())[0]
    assert got.size == int(out["mel_lens"][0]) * 256 > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_tts_streaming_matches_full(service):
    """The chunked-streaming response carries the same PCM as the full
    response, behind a streaming WAV header."""
    body = {"text": "Streaming the same words.", "duration_control": 1.2}
    _, _, full = _post(service.url, body)
    want = _pcm(full)
    status, headers, raw = _post(service.url, dict(body, stream=True))
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    # urllib de-chunks the transfer encoding; strip the 44-byte header
    assert raw[:4] == b"RIFF" and raw[36:40] == b"data"
    assert raw[4:8] == b"\xff\xff\xff\xff"
    got = np.frombuffer(raw[44:], "<i2")
    assert got.shape == want.shape and want.size > CHUNK * 256
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_dynamic_batching_coalesces(service):
    """Concurrent requests with the same controls are coalesced by the
    worker into fewer batches, and every response carries the same audio
    (rows of a padded batch are independent)."""
    before = _healthz(service.url)["batches"]
    results = [None] * 6

    def post(i):
        results[i] = _post(service.url, {"text": "Dynamic batching test."})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pcms = [_pcm(body) for status, _, body in results if status == 200]
    assert len(pcms) == 6 and all(p.shape == pcms[0].shape for p in pcms)
    for p in pcms[1:]:
        assert np.abs(p.astype(np.int32)
                      - pcms[0].astype(np.int32)).max() <= 1
    # the first may run alone (its window can expire before the rest
    # arrive), but everything queued behind it coalesces
    assert _healthz(service.url)["batches"] - before <= 4


def test_worker_and_stream_build_no_autograd_graph(service):
    """Grad mode is thread-local: the batching worker and the streaming
    response run the model and the vocoder with grad mode off."""
    seen = []

    def hook(module, args, out):
        seen.append((type(module).__name__, torch.is_grad_enabled(),
                     out.requires_grad if torch.is_tensor(out) else False))

    handles = [m.register_forward_hook(hook)
               for m in (service.model, service.vocoder[1])]
    try:
        assert torch.is_grad_enabled()
        _post(service.url, {"text": "Grad mode off."})
        _post(service.url, {"text": "Grad mode off.", "stream": True})
    finally:
        for h in handles:
            h.remove()
    names = {name for name, _, _ in seen}
    assert names == {"CompTransTTS", "HiFiGANGenerator"}, seen
    assert not any(grad or req for _, grad, req in seen), seen


def test_tts_bad_request(service):
    req = urllib.request.Request(
        service.url + "/tts", data=b"{}",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(service.url + "/nothing", timeout=60)
    assert e.value.code == 404


def test_synthesize_cli_batch_and_stream(tmp_path):
    """``python -m ctts_torch.synthesize --mode batch --stream_chunk 16`` on
    a tiny config with HiFi-GAN V1 at seed 0 saved as an upstream checkpoint
    under ``--vocoder_ckpt``: one wav and one mel per metadata line, the
    time-to-first-audio line, and wavs of mel_len·256 samples."""
    from scipy.io import wavfile
    from ctts_torch.config import dump_yaml, load_yaml
    from ctts_torch.utils.model import get_vocoder
    from ctts_torch.utils.testing import tiny_configs
    pre, mc, tr = tiny_configs()
    _, gen = get_vocoder(mc, ckpt_dir=str(tmp_path / "none"), device="cpu",
                         seed=0)
    (tmp_path / "ckpt" / "hifigan").mkdir(parents=True)
    torch.save({"generator": gen.state_dict()},
               tmp_path / "ckpt" / "hifigan" /
               f"generator_{mc['vocoder']['speaker']}.pth.tar")
    store = tmp_path / "store"
    store.mkdir()
    (store / "speakers.json").write_text(json.dumps({"LJSpeech": 0}))
    pre["path"]["preprocessed_path"] = str(store)
    pre["path"]["lexicon_path"] = "/nonexistent"
    pre["preprocessing"]["pitch"].pop("cwt_scales", None)
    pre.pop("dataset", None)
    mc.pop("_energy_stats", None)
    raw = load_yaml(open(os.path.join(REPO, "configs", "LJSpeech.yaml")))
    raw.update(preprocess=pre, model=mc, train=tr)
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "LJSpeech.yaml").write_text(dump_yaml(raw))
    meta = tmp_path / "meta.txt"
    meta.write_text("one|LJSpeech|{HH AH0 L OW1 W ER1 L D}|hello world\n"
                    "two|LJSpeech|{T UW1}|two\n")
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "ctts_torch.synthesize", "--mode", "batch",
         "--source", str(meta), "--dataset", "LJSpeech", "--config_dir",
         str(cfg), "--device", "cpu", "--vocoder_ckpt",
         str(tmp_path / "ckpt"), "--stream_chunk", "16", "--result_dir",
         str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "griffin-lim" not in res.stdout
    assert "time-to-first-audio" in res.stdout
    assert sorted(os.listdir(out)) == ["one.npy", "one.wav", "two.npy",
                                       "two.wav"]
    for name in ("one", "two"):
        mel = np.load(out / f"{name}.npy")
        sr, wav = wavfile.read(out / f"{name}.wav")
        assert sr == 22050 and mel.shape[1] == 80
        assert wav.dtype == np.int16 and len(wav) == mel.shape[0] * 256
