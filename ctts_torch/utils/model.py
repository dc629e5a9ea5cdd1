"""Model and vocoder factories (ctts_tpu/utils/model.py)."""

import os

import numpy as np
import torch

from ctts_torch import resolve_device


# the reformer attention's projections, Xavier-uniform in the JAX package
_XAVIER = ("toqk", "tov", "to_out")


def init_weights(module, seed):
    """Redraw every parameter of ``module`` from a seeded torch.Generator:
    N(0, fan_in^-1) for matrices and kernels (Xavier-uniform for the
    reformer attention's ``toqk``, ``tov`` and ``to_out``, as flax inits
    them), 1 for norm scales, the positional alphas and the duration CRF's
    start and end scores, 0 for biases (the GRU's ``bias_*`` too);
    embedding padding rows stay zero. A module shared by several parents
    (the reformer's tied layers) is drawn once."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2 and name.split(".")[-2] in _XAVIER:
                fan_out, fan_in = p.shape
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
            elif p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
            elif name.split(".")[-1].startswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for m in module.modules():
            if isinstance(m, torch.nn.Embedding) and m.padding_idx is not None:
                m.weight[m.padding_idx].zero_()
    return module


def get_model(restore_step, configs, packed_ckpt=None, device=None):
    """Build CompTransTTS for inference and load its weights.

    ``restore_step`` reads the port's checkpoint of that step from
    ``train.path.ckpt_path`` (``ctts_torch.train`` writes them; raises
    FileNotFoundError when there is none). packed_ckpt: the bf16 npz the
    JAX package packs (e.g. the committed assets/ljdemo_ckpt.npz), mapped
    through the weight bridge. With neither, the weights are drawn from
    seed 0. Returns the model in eval mode on ``device`` (cuda unless the
    caller asks for another)."""
    from ctts_torch.models.comp_trans_tts import (CompTransTTS,
                                                  prepare_model_config)
    from ctts_torch.utils.checkpoint import load_checkpoint, load_params_npz
    from ctts_torch.utils.weights import state_dict_from_jax

    dev = resolve_device(device)
    preprocess_config, model_config, train_config = configs
    model_config = prepare_model_config(preprocess_config, model_config)
    model = CompTransTTS(preprocess_config, model_config, train_config)
    if restore_step:
        saved = load_checkpoint(train_config["path"]["ckpt_path"],
                                restore_step)
        model.load_state_dict(saved["model"], strict=True)
    elif packed_ckpt:
        tree, step = load_params_npz(packed_ckpt)
        model.load_state_dict(state_dict_from_jax(tree), strict=True)
        print(f"loaded packed weights (step {step}) from {packed_ckpt}")
    else:
        init_weights(model, 0)
    return model.to(dev).eval()


def get_vocoder(model_config, ckpt_dir="ckpt", device=None,
                dtype=torch.bfloat16, seed=None):
    """The configured vocoder (HiFi-GAN V1 or MelGAN) as ``(name, module)``.

    The weights are an external download, as upstream:
    ``<ckpt_dir>/hifigan/generator_<speaker>.pth.tar`` or
    ``<ckpt_dir>/melgan/melgan_<speaker>.pt``. Without the file this
    returns the griffin-lim fallback ``("griffin_lim", None)``, unless
    ``seed`` is given, which draws the generator's weights from that seed
    instead (for smoke runs and timing; the audio is noise)."""
    name = model_config["vocoder"]["model"]
    speaker = model_config["vocoder"]["speaker"]
    if name == "HiFi-GAN":
        from ctts_torch.vocoder.hifigan import (HiFiGANGenerator, V1_CONFIG,
                                                load_generator)
        path = os.path.join(ckpt_dir, "hifigan",
                            f"generator_{speaker}.pth.tar")
        model = HiFiGANGenerator(dict(V1_CONFIG), dtype=dtype)
        load = load_generator
    elif name == "MelGAN":
        from ctts_torch.vocoder.melgan import MelGANGenerator, load_melgan
        path = os.path.join(ckpt_dir, "melgan", f"melgan_{speaker}.pt")
        model = MelGANGenerator(dtype=dtype)
        load = load_melgan
    else:
        raise ValueError(f"unknown vocoder {name}")
    dev = resolve_device(device)
    if os.path.exists(path):
        model.load_state_dict(load(path))
    elif seed is not None:
        init_weights(model, seed)
    else:
        return ("griffin_lim", None)
    return (name, model.to(dev).eval())


def _int16(wavs, preprocess_config):
    max_wav_value = preprocess_config["preprocessing"]["audio"]["max_wav_value"]
    return (wavs * max_wav_value).clip(-max_wav_value,
                                       max_wav_value - 1).astype(np.int16)


def vocoder_infer(mels, vocoder, preprocess_config, lengths=None):
    """mels [B, T, n_mel] (log, tensor or array) → list of int16 numpy
    wavs, each cut to ``lengths[i]·hop`` samples."""
    name, model = vocoder
    hop = preprocess_config["preprocessing"]["stft"]["hop_length"]
    if name in ("HiFi-GAN", "MelGAN"):
        device = next(model.parameters()).device
        mels = torch.as_tensor(mels).to(device)
        if name == "MelGAN":                   # MelGAN takes log10 mels
            mels = mels / np.log(10)
        with torch.no_grad():
            wavs = model(mels).cpu().numpy()
    else:
        from ctts_torch.audio.tools import inv_mel_spec_batch
        mels = mels.cpu().numpy() if torch.is_tensor(mels) else mels
        wavs = inv_mel_spec_batch(np.asarray(mels, np.float32),
                                  preprocess_config)
    wavs = _int16(wavs, preprocess_config)
    out = []
    for i in range(len(wavs)):
        n = int(lengths[i]) * hop if lengths is not None else wavs.shape[1]
        out.append(wavs[i, :n])
    return out


def vocoder_stream(mels, vocoder, preprocess_config, chunk=64):
    """The streaming form of :func:`vocoder_infer`: yields int16 numpy
    chunks [B, chunk·hop] as they come off the card
    (:mod:`ctts_torch.vocoder.streaming`; the last chunk is shorter when T
    is not a chunk multiple). Concatenated and cut to ``lengths[i]·hop``
    per row they equal :func:`vocoder_infer`'s output up to the order of
    float sums."""
    from ctts_torch.vocoder.streaming import (RF_MEL, RF_MEL_MELGAN,
                                              make_chunked_vocoder)
    name, model = vocoder
    hop = preprocess_config["preprocessing"]["stft"]["hop_length"]
    mels = torch.as_tensor(mels)
    if name == "HiFi-GAN":
        halo = RF_MEL
    elif name == "MelGAN":
        halo = RF_MEL_MELGAN
        mels = mels / np.log(10)
    else:
        raise ValueError(f"vocoder {name!r} has no streaming path "
                         "(griffin-lim runs on the host over the whole mel)")
    stream = make_chunked_vocoder(model, chunk=chunk, halo=halo, hop=hop)
    for wav in stream(mels):
        yield _int16(wav, preprocess_config)
