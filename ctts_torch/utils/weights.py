"""The weight bridge: JAX parameter trees ↔ the port's state_dicts.

The JAX package keeps ``{"params": ..., "batch_stats": ...}`` trees in flax
layouts; the port's modules carry the upstream PyTorch parameter names, so
``ctts_tpu/utils/torch_import.py:import_reference_checkpoint`` maps a port
state_dict straight back. Layout changes:

- conv kernels: flax ``[k, in, out]`` → torch ``[out, in, k]``;
- dense kernels: ``[in, out]`` → ``[out, in]``;
- attention: ``DenseGeneral`` q/k/v ``[C, H, Dh]`` → one
  ``in_proj_weight [3C, C]``, out ``[H, Dh, C]`` → ``out_proj [C, C]``;
- LayerNorm / BatchNorm ``scale`` → ``weight``; BatchNorm ``mean`` /
  ``var`` → ``running_mean`` / ``running_var``;
- transposed convs (HiFi-GAN): ``[k, out, in]`` → torch ``[in, out, k]``.

:func:`jax_tree_from_state_dict` is the inverse for the acoustic model, so a
test can compare the port's parameters with the JAX tree after a step.
"""

import numpy as np
import torch

_ALIGNER_CONVS = (("key_proj", (0, 2)), ("query_proj", (0, 2, 4)))


def _conv(kernel):
    return np.transpose(kernel, (2, 1, 0))


def _ln(sd, prefix, node):
    sd[f"{prefix}.weight"] = node["scale"]
    sd[f"{prefix}.bias"] = node["bias"]


def _dense(sd, prefix, node):
    sd[f"{prefix}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        sd[f"{prefix}.bias"] = node["bias"]


def _conv_params(sd, prefix, node):
    sd[f"{prefix}.weight"] = _conv(node["kernel"])
    if "bias" in node:
        sd[f"{prefix}.bias"] = node["bias"]


def _fft_stack(sd, prefix, fft):
    i = 0
    while f"layers_{i}" in fft:
        layer = fft[f"layers_{i}"]
        p = f"{prefix}.layers.{i}.op"
        _ln(sd, f"{p}.layer_norm1", layer["layer_norm1"]["LayerNorm_0"])
        _ln(sd, f"{p}.layer_norm2", layer["layer_norm2"]["LayerNorm_0"])
        att = layer["self_attn"]
        C = att["q"]["kernel"].shape[0]
        sd[f"{p}.self_attn.in_proj_weight"] = np.concatenate(
            [att[n]["kernel"].reshape(C, -1).T for n in ("q", "k", "v")])
        sd[f"{p}.self_attn.out_proj.weight"] = \
            att["out"]["kernel"].reshape(-1, C).T
        _conv_params(sd, f"{p}.ffn.ffn_1", layer["ffn"]["ffn_1"]["Conv_0"])
        _dense(sd, f"{p}.ffn.ffn_2", layer["ffn"]["ffn_2"])
        i += 1
    _ln(sd, f"{prefix}.layer_norm", fft["layer_norm"]["LayerNorm_0"])
    if "pos_embed_alpha" in fft:
        sd[f"{prefix}.pos_embed_alpha"] = fft["pos_embed_alpha"]


def _predictor(sd, prefix, node):
    conv = node["conv"]
    i = 0
    while f"conv_{i}" in conv:
        _conv_params(sd, f"{prefix}.conv.{i}.1", conv[f"conv_{i}"]["Conv_0"])
        _ln(sd, f"{prefix}.conv.{i}.3", conv[f"LayerNorm_{i}"]["LayerNorm_0"])
        i += 1
    _dense(sd, f"{prefix}.linear", node["linear"])
    if "pos_embed_alpha" in node:
        sd[f"{prefix}.pos_embed_alpha"] = node["pos_embed_alpha"]


def _to_tensors(sd):
    """numpy leaves → tensors: floats as float32, integers kept."""
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def state_dict_from_jax(tree):
    """JAX CompTransTTS variables (nested dicts of numpy arrays, e.g. from
    :func:`ctts_torch.utils.checkpoint.load_params_npz`) → the port's
    ``state_dict`` (float32 tensors). Raises on a subtree the port does not
    hold yet."""
    params = tree["params"]
    stats = tree.get("batch_stats") or {}
    known = {"encoder", "decoder", "mel_linear", "postnet",
             "variance_adaptor"}
    extra = set(params) - known
    if extra:
        raise NotImplementedError(
            f"parameters for {sorted(extra)} have no module in ctts_torch yet")
    sd = {}
    enc = params["encoder"]
    sd["encoder.embed_tokens.weight"] = enc["embed_tokens"]["embedding"]
    _fft_stack(sd, "encoder", enc["fft"])
    _fft_stack(sd, "decoder", params["decoder"]["fft"])
    _dense(sd, "mel_linear", params["mel_linear"])

    pn, pn_stats = params["postnet"], stats["postnet"]
    i = 0
    while f"conv_{i}" in pn:
        p = f"postnet.convolutions.{i}"
        _conv_params(sd, f"{p}.0.conv", pn[f"conv_{i}"]["Conv_0"])
        _ln(sd, f"{p}.1", pn[f"bn_{i}"])
        sd[f"{p}.1.running_mean"] = pn_stats[f"bn_{i}"]["mean"]
        sd[f"{p}.1.running_var"] = pn_stats[f"bn_{i}"]["var"]
        sd[f"{p}.1.num_batches_tracked"] = np.zeros((), np.int64)
        i += 1

    va = params["variance_adaptor"]
    va_known = {"duration_predictor", "pitch_embed", "cwt_in_proj",
                "cwt_predictor", "cwt_stats_layers", "energy_predictor",
                "energy_embedding", "aligner"}
    extra = set(va) - va_known
    if extra:
        raise NotImplementedError(
            f"variance-adaptor parameters {sorted(extra)} have no module in "
            "ctts_torch yet")
    p = "variance_adaptor"
    _predictor(sd, f"{p}.duration_predictor", va["duration_predictor"])
    if "pitch_embed" in va:
        sd[f"{p}.pitch_embed.weight"] = va["pitch_embed"]["embedding"]
    if "cwt_in_proj" in va:
        _dense(sd, f"{p}.cwt_predictor.0", va["cwt_in_proj"])
        _predictor(sd, f"{p}.cwt_predictor.1", va["cwt_predictor"])
        for j, idx in enumerate((0, 2, 4)):
            _dense(sd, f"{p}.cwt_stats_layers.{idx}",
                   va["cwt_stats_layers"][f"Dense_{j}"])
    if "energy_predictor" in va:
        _predictor(sd, f"{p}.energy_predictor", va["energy_predictor"])
        sd[f"{p}.energy_embedding.weight"] = \
            va["energy_embedding"]["embedding"]
    if "aligner" in va:
        for name, slots in _ALIGNER_CONVS:
            for j, slot in enumerate(slots):
                _conv_params(sd, f"{p}.aligner.{name}.{slot}.conv",
                             va["aligner"][f"{name}_{j}"]["Conv_0"])
    return _to_tensors(sd)


# ---- the inverse: state_dict → JAX tree layout ---------------------------- #

def _inv_ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _inv_dense(sd, prefix):
    node = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        node["bias"] = sd[f"{prefix}.bias"]
    return node


def _inv_conv(sd, prefix):
    node = {"kernel": _conv(sd[f"{prefix}.weight"])}   # its own inverse
    if f"{prefix}.bias" in sd:
        node["bias"] = sd[f"{prefix}.bias"]
    return node


def _inv_fft_stack(sd, prefix, num_heads):
    fft = {}
    i = 0
    while f"{prefix}.layers.{i}.op.layer_norm1.weight" in sd:
        p = f"{prefix}.layers.{i}.op"
        w = sd[f"{p}.self_attn.in_proj_weight"]                # [3C, C]
        C = w.shape[1]
        att = {n: {"kernel": w[j * C:(j + 1) * C].T.reshape(C, num_heads, -1)}
               for j, n in enumerate(("q", "k", "v"))}
        att["out"] = {"kernel": sd[f"{p}.self_attn.out_proj.weight"].T
                      .reshape(num_heads, -1, C)}
        fft[f"layers_{i}"] = {
            "layer_norm1": {"LayerNorm_0": _inv_ln(sd, f"{p}.layer_norm1")},
            "layer_norm2": {"LayerNorm_0": _inv_ln(sd, f"{p}.layer_norm2")},
            "self_attn": att,
            "ffn": {"ffn_1": {"Conv_0": _inv_conv(sd, f"{p}.ffn.ffn_1")},
                    "ffn_2": _inv_dense(sd, f"{p}.ffn.ffn_2")}}
        i += 1
    fft["layer_norm"] = {"LayerNorm_0": _inv_ln(sd, f"{prefix}.layer_norm")}
    if f"{prefix}.pos_embed_alpha" in sd:
        fft["pos_embed_alpha"] = sd[f"{prefix}.pos_embed_alpha"]
    return fft


def _inv_predictor(sd, prefix):
    conv = {}
    i = 0
    while f"{prefix}.conv.{i}.1.weight" in sd:
        conv[f"conv_{i}"] = {"Conv_0": _inv_conv(sd, f"{prefix}.conv.{i}.1")}
        conv[f"LayerNorm_{i}"] = {
            "LayerNorm_0": _inv_ln(sd, f"{prefix}.conv.{i}.3")}
        i += 1
    node = {"conv": conv, "linear": _inv_dense(sd, f"{prefix}.linear")}
    if f"{prefix}.pos_embed_alpha" in sd:
        node["pos_embed_alpha"] = sd[f"{prefix}.pos_embed_alpha"]
    return node


def jax_tree_from_state_dict(state_dict, model_config):
    """The port's CompTransTTS ``state_dict`` → ``{"params": ...,
    "batch_stats": ...}`` of numpy arrays in the JAX package's layout (the
    inverse of :func:`state_dict_from_jax`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    cfg = model_config[model_config["block_type"]]
    params = {
        "encoder": {
            "embed_tokens": {"embedding": sd["encoder.embed_tokens.weight"]},
            "fft": _inv_fft_stack(sd, "encoder", cfg["encoder_head"])},
        "decoder": {"fft": _inv_fft_stack(sd, "decoder",
                                          cfg["decoder_head"])},
        "mel_linear": _inv_dense(sd, "mel_linear"),
    }
    pn, pn_stats = {}, {}
    i = 0
    while f"postnet.convolutions.{i}.0.conv.weight" in sd:
        p = f"postnet.convolutions.{i}"
        pn[f"conv_{i}"] = {"Conv_0": _inv_conv(sd, f"{p}.0.conv")}
        pn[f"bn_{i}"] = _inv_ln(sd, f"{p}.1")
        pn_stats[f"bn_{i}"] = {"mean": sd[f"{p}.1.running_mean"],
                               "var": sd[f"{p}.1.running_var"]}
        i += 1
    params["postnet"] = pn

    p = "variance_adaptor"
    va = {"duration_predictor": _inv_predictor(sd, f"{p}.duration_predictor")}
    if f"{p}.pitch_embed.weight" in sd:
        va["pitch_embed"] = {"embedding": sd[f"{p}.pitch_embed.weight"]}
    if f"{p}.cwt_predictor.0.weight" in sd:
        va["cwt_in_proj"] = _inv_dense(sd, f"{p}.cwt_predictor.0")
        va["cwt_predictor"] = _inv_predictor(sd, f"{p}.cwt_predictor.1")
        va["cwt_stats_layers"] = {
            f"Dense_{j}": _inv_dense(sd, f"{p}.cwt_stats_layers.{idx}")
            for j, idx in enumerate((0, 2, 4))}
    if f"{p}.energy_embedding.weight" in sd:
        va["energy_predictor"] = _inv_predictor(sd, f"{p}.energy_predictor")
        va["energy_embedding"] = {
            "embedding": sd[f"{p}.energy_embedding.weight"]}
    if f"{p}.aligner.key_proj.0.conv.weight" in sd:
        va["aligner"] = {
            f"{name}_{j}": {"Conv_0": _inv_conv(
                sd, f"{p}.aligner.{name}.{slot}.conv")}
            for name, slots in _ALIGNER_CONVS
            for j, slot in enumerate(slots)}
    params["variance_adaptor"] = va
    return {"params": params, "batch_stats": {"postnet": pn_stats}}


def hifigan_state_dict_from_jax(params):
    """JAX HiFiGANGenerator params (``{"params": ...}`` or the inner dict)
    → the port's generator state_dict (upstream names)."""
    params = params.get("params", params)
    sd = {}
    _conv_params(sd, "conv_pre", params["conv_pre"]["Conv_0"])
    _conv_params(sd, "conv_post", params["conv_post"]["Conv_0"])
    i = 0
    while f"ups_{i}" in params:
        sd[f"ups.{i}.weight"] = np.transpose(params[f"ups_{i}"]["kernel"],
                                             (2, 1, 0))
        sd[f"ups.{i}.bias"] = params[f"ups_{i}"]["bias"]
        i += 1
    r = 0
    while f"resblocks_{r}" in params:
        rb = params[f"resblocks_{r}"]
        for j in range(rb["w1"].shape[0]):
            for n in (1, 2):
                sd[f"resblocks.{r}.convs{n}.{j}.weight"] = _conv(rb[f"w{n}"][j])
                sd[f"resblocks.{r}.convs{n}.{j}.bias"] = rb[f"b{n}"][j]
        r += 1
    return _to_tensors(sd)
