"""Speaker embedding: the DeepSpeaker ResCNN that the preprocessor runs for
multi-speaker recipes (ctts_tpu/models/speaker.py).

The reference's TF/Keras embedder (deepspeaker/conv_models.py ResCNN and
embedding.py:8-27): 64-bin log-fbank features at 16 kHz, a 160-frame crop,
4 stages of [conv5×5 stride 2 → BN → clipped ReLU → 3 identity blocks] at
64/128/256/512 channels (identity block: conv3 → BN → crelu → conv3 → BN →
crelu → + input → crelu, conv_models.py:85-112), the frame mean of the
flattened 4·512 features, a 512-d affine and an L2 norm
(conv_models.py:50-66).

The module keeps the JAX package's parameter names (``conv_0``, ``bn_0``,
``res_0_0.conv_a``, ..., ``affine``), there being no upstream PyTorch
ResCNN; ``utils.weights.rescnn_state_dict_from_jax`` maps the flax tree
onto it. Three places where flax and torch differ:

* flax ``padding="SAME"`` at stride 2 pads an even size (1, 2), not (2, 2),
  so every conv pads explicitly, per axis, as XLA's SAME does;
* Keras BatchNorm's epsilon is 1e-3 and the embedder runs it with its
  running statistics always (a frozen network);
* flax is NHWC: the flatten before the frame mean takes [B, T, F·C] with
  the channel fastest, so the features are permuted to that order first.

The pretrained weights are an external Keras ``.h5`` like the reference's
(model/speaker_embedder.py:25-27); :func:`load_keras_weights` reads one.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch import resolve_device

NUM_FBANKS = 64
NUM_FRAMES = 160
SAMPLE_RATE = 16000
_FILTERS = (64, 128, 256, 512)
_BN_EPS = 1e-3          # Keras BatchNormalization default epsilon


def _same_pad(size, k, s):
    """XLA's SAME padding (lo, hi) of one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _Conv(nn.Conv2d):
    """A conv with flax's SAME padding at any stride."""

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        th, tw = _same_pad(x.shape[2], kh, sh), _same_pad(x.shape[3], kw, sw)
        return super().forward(F.pad(x, (*tw, *th)))


class _BN(nn.BatchNorm2d):
    """BatchNorm with its running statistics always (flax
    ``use_running_average=True``)."""

    def __init__(self, channels):
        super().__init__(channels, eps=_BN_EPS)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _crelu(x):
    return torch.clamp(x, 0.0, 20.0)


class _IdentityBlock(nn.Module):
    def __init__(self, filters):
        super().__init__()
        self.conv_a = _Conv(filters, filters, 3)
        self.bn_a = _BN(filters)
        self.conv_b = _Conv(filters, filters, 3)
        self.bn_b = _BN(filters)

    def forward(self, x):
        h = _crelu(self.bn_a(self.conv_a(x)))
        h = _crelu(self.bn_b(self.conv_b(h)))
        return _crelu(h + x)


class ResCNN(nn.Module):
    """fbank [B, T, 64] → [B, 512] L2-normalized embedding."""

    def __init__(self, embedding_dim=512):
        super().__init__()
        c_in = 1
        for i, f in enumerate(_FILTERS):
            setattr(self, f"conv_{i}", _Conv(c_in, f, 5, stride=2))
            setattr(self, f"bn_{i}", _BN(f))
            for j in range(3):
                setattr(self, f"res_{i}_{j}", _IdentityBlock(f))
            c_in = f
        self.affine = nn.Linear(_FILTERS[-1] * NUM_FBANKS // 16,
                                embedding_dim)

    def forward(self, fbank):
        x = fbank[:, None]                                # [B, 1, T, 64]
        for i in range(len(_FILTERS)):
            x = _crelu(getattr(self, f"bn_{i}")(
                getattr(self, f"conv_{i}")(x)))
            for j in range(3):
                x = getattr(self, f"res_{i}_{j}")(x)
        B, C, T, Fq = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T, Fq * C).mean(dim=1)
        x = self.affine(x)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True),
                               min=1e-8)


def compute_fbank(wav, sampling_rate, device=None):
    """64-bin log mel filterbank at 16 kHz, 25 ms windows a 10 ms hop,
    standardized over the utterance (deepspeaker/audio_ds.py read_mfcc
    semantics): the resampling on the host (``resample_poly``), the
    512-point STFT, the filterbank and the log on ``device`` (cuda unless
    the caller asks for another) in float64, as numpy computes them.
    Returns float32 [T, 64] on the device."""
    from math import gcd

    from scipy.signal import resample_poly

    from ctts_torch.audio.stft import (hann_window, mel_filterbank,
                                       stft_magnitudes)
    dev = resolve_device(device)
    if sampling_rate != SAMPLE_RATE:
        g = gcd(SAMPLE_RATE, sampling_rate)
        wav = resample_poly(wav, SAMPLE_RATE // g, sampling_rate // g)
    y = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
    window = torch.from_numpy(hann_window(400, 512)).to(dev)
    mag = stft_magnitudes(y[None], window, 160, torch.float64)[0]
    fb = torch.from_numpy(mel_filterbank(SAMPLE_RATE, 512, NUM_FBANKS, 0,
                                         SAMPLE_RATE // 2)).to(dev)
    feats = torch.log(torch.clamp((mag ** 2) @ fb.T.double(), min=1e-10))
    mean, std = feats.mean(), feats.std(unbiased=False)
    return ((feats - mean) / torch.clamp(std, min=1e-8)).float()


class PreDefinedEmbedder:
    """Callable wav → (1, 512) numpy embedding
    (model/speaker_embedder.py:11-42), the ResCNN on ``device``.

    Weight resolution order: the ``weights_path`` argument, the
    ``path.deepspeaker_weights`` config key, the CTTS_DEEPSPEAKER_H5
    environment variable. Without weights this fails loudly (random-net
    embeddings are not the reference speaker space) unless
    CTTS_ALLOW_RANDOM_SPEAKER=1 opts in; the weights are then drawn from
    seed 0 (``utils.model.init_weights``)."""

    def __init__(self, preprocess_config, weights_path=None, device=None):
        self.sampling_rate = \
            preprocess_config["preprocessing"]["audio"]["sampling_rate"]
        self.device = resolve_device(device)
        self.weights_path = (
            weights_path
            or preprocess_config.get("path", {}).get("deepspeaker_weights")
            or os.environ.get("CTTS_DEEPSPEAKER_H5"))
        if not self.weights_path or not os.path.exists(self.weights_path):
            if os.environ.get("CTTS_ALLOW_RANDOM_SPEAKER") != "1":
                raise RuntimeError(
                    "DeepSpeaker pretrained weights not found "
                    f"(looked at {self.weights_path!r}). Download the "
                    "ResCNN .h5 checkpoint and point path.deepspeaker_weights"
                    " or CTTS_DEEPSPEAKER_H5 at it, supply precomputed "
                    "*-spker_embed.npy files, or set "
                    "CTTS_ALLOW_RANDOM_SPEAKER=1 to accept random-net "
                    "(non-reference) speaker features.")
            self.weights_path = None
        self.model = ResCNN()
        if self.weights_path:
            from ctts_torch.utils.weights import rescnn_state_dict_from_jax
            self.model.load_state_dict(rescnn_state_dict_from_jax(
                load_keras_weights(self.weights_path)))
        else:
            from ctts_torch.utils.model import init_weights
            init_weights(self.model, 0)
        self.model.to(self.device).eval()

    def crop(self, wav):
        """The centred 160-frame fbank crop of a wav (wrapped where the
        utterance is shorter), [160, 64] on the device."""
        feats = compute_fbank(wav, self.sampling_rate, self.device)
        if len(feats) < NUM_FRAMES:
            reps = -(-NUM_FRAMES // len(feats))
            feats = feats.repeat(reps, 1)[:NUM_FRAMES]
        start = max(0, (len(feats) - NUM_FRAMES) // 2)
        return feats[start: start + NUM_FRAMES]

    def __call__(self, wav):
        """The embedding, float32 throughout: cuDNN's convs without TF32
        (its default), so the stored features do not depend on the card."""
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False):
            emb = self.model(self.crop(wav)[None])
        return emb.cpu().numpy()                         # (1, 512)


def load_keras_weights(h5_path):
    """The reference ResCNN Keras checkpoint as the flax variable tree of
    ``ctts_tpu.models.speaker.ResCNN`` ({"params", "batch_stats"} of numpy
    arrays), for ``utils.weights.rescnn_state_dict_from_jax``.

    Reads the legacy full-model .h5 (a root ``model_weights`` group, as the
    published ResCNN_triplet_training_checkpoint_265.h5 is) and the bare
    save_weights layout; weight names with and without the TF1 ``:0``
    suffix. ``h5py`` is imported here: nothing else needs it."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        flat = {}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                key = name[:-2] if name.endswith(":0") else name
                flat[key] = np.asarray(obj)

        root.visititems(visit)

    def get(layer, wname):
        for key in (f"{layer}/{layer}/{wname}", f"{layer}/{wname}"):
            if key in flat:
                return flat[key]
        raise KeyError(f"{layer}/{wname} not in checkpoint "
                       f"(have e.g. {sorted(flat)[:4]})")

    def conv(layer):
        return {"kernel": get(layer, "kernel"),       # TF [kh,kw,in,out] ==
                "bias": get(layer, "bias")}           # flax layout

    def bn(layer):
        return ({"scale": get(layer, "gamma"), "bias": get(layer, "beta")},
                {"mean": get(layer, "moving_mean"),
                 "var": get(layer, "moving_variance")})

    params, stats = {}, {}
    for i, fch in enumerate(_FILTERS):
        stage = i + 1
        params[f"conv_{i}"] = conv(f"conv{fch}-s")
        params[f"bn_{i}"], stats[f"bn_{i}"] = bn(f"conv{fch}-s_bn")
        for j in range(3):
            base = f"res{stage}_{j}_branch"
            blk_p, blk_s = {}, {}
            blk_p["conv_a"] = conv(f"{base}_2a")
            blk_p["bn_a"], blk_s["bn_a"] = bn(f"{base}_2a_bn")
            blk_p["conv_b"] = conv(f"{base}_2b")
            blk_p["bn_b"], blk_s["bn_b"] = bn(f"{base}_2b_bn")
            params[f"res_{i}_{j}"] = blk_p
            stats[f"res_{i}_{j}"] = blk_s
    params["affine"] = {"kernel": get("affine", "kernel"),
                        "bias": get("affine", "bias")}
    return {"params": params, "batch_stats": stats}
