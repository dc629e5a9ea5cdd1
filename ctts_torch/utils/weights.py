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
- transposed convs (HiFi-GAN): ``[k, out, in]`` → torch ``[in, out, k]``;
- conformer stacks: ``DenseGeneral`` q/k/v/pos ``[C, H, Dh]`` and out
  ``[H, Dh, C]`` → the upstream ``LinearNorm`` weights ``[C, C]``, the
  pointwise Dense ``[in, out]`` → conv ``[out, in, 1]``, the depthwise conv
  ``[k, 1, C]`` → ``[C, 1, k]``, and each conv module's BatchNorm statistics
  from ``batch_stats``;
- reformer stacks: the tied ``attn`` (``toqk``, ``tov``, ``to_out``) and
  ``ff`` (``w1``, ``w2``) Dense kernels and each layer's ``norm_f_i`` /
  ``norm_g_i`` → ``layer_stack.net.layers.irrev_blocks.{i}.{f,g}.*``, the
  tied weights under every ``i`` as an upstream state_dict holds them;
- classic transformer stacks: each ``layer_stack_{i}``'s ``DenseGeneral``
  q/k/v ``[C, H, Dh]`` and fc ``[H, Dh, C]`` → the upstream ``LinearNorm``
  weights ``slf_attn.{w_qs,w_ks,w_vs,fc}.linear.weight [C, C]``, its two
  LayerNorms → ``slf_attn.layer_norm`` and ``pos_ffn.layer_norm``;
- fastformer and lstransformer stacks: the one ``layer_stack`` node's
  ``norm_attn_i`` / ``attn_i`` / ``norm_ff_i`` / ``ff_i`` →
  ``layer_stack.layers.{i}.{0,1}.{norm,fn}``; the fastformer's tied
  ``to_q_attn_logits`` / ``to_k_attn_logits`` under every ``i``, read back
  from layer 0;
- the speaker table (``speaker_emb.embedding``) → ``speaker_emb.weight``,
  or the external embedding's projection (a Dense) → ``speaker_emb``'s
  Linear; the aligner's ``key_spk_proj`` / ``query_spk_proj`` →
  ``variance_adaptor.aligner.{key,query}_spk_proj.linear.weight``;
- the duration CRF (``variance_adaptor/dur_crf``) →
  ``variance_adaptor.duration_predictor.crf.{start_transitions,
  end_transitions, transitions}`` (torchcrf's names, under the predictor as
  upstream's ``dur_predictor.crf`` call has it);
- the autoregressive pitch head's flax GRU cell (``ar/gru``: ``ir``,
  ``iz``, ``in`` with biases, ``hr``, ``hz`` without, ``hn`` with) → one
  ``nn.GRU`` layer, ``pitch_predictor.gru.weight_ih_l0`` = [ir | iz | in]ᵀ,
  ``weight_hh_l0`` = [hr | hz | hn]ᵀ, ``bias_ih_l0`` = [b_ir | b_iz | b_in],
  ``bias_hh_l0`` = [0 | 0 | b_hn], and ``ar/head`` → ``pitch_predictor.head``
  (upstream has no such module; the port chose these names). The port's
  cell runs with [0 | 0 | b_hn] whatever ``bias_hh_l0[:2H]`` holds, so the
  inverse reads only its n part;
- prosody (upstream's names, as ``torch_import.py:import_du_extractor``,
  ``import_du_predictor`` and ``import_liu_prosody`` read them): 2-D conv
  kernels ``[kh, kw, in, out]`` → ``[out, in, kh, kw]``; the JAX GRU cells
  (``wi``, ``wh``, ``bi``, ``bh``: torch's layout transposed) →
  ``weight_ih`` / ``weight_hh`` / ``bias_ih`` / ``bias_hh`` with ``_l0``
  (``_l0_reverse`` for a backward scan) or, for the autoregressive cells,
  no suffix; each BatchNorm's statistics from ``batch_stats``; the liu2021
  modules straight under ``variance_adaptor.``, as upstream hangs them.

:func:`jax_tree_from_state_dict` is the inverse for the acoustic model, so a
test can compare the port's parameters with the JAX tree after a step.
"""

import re

import numpy as np
import torch

_ALIGNER_CONVS = (("key_proj", (0, 2)), ("query_proj", (0, 2, 4)))
_ALIGNER_SPK = ("key_spk_proj", "query_spk_proj")


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


_HEADED = ("query_proj", "key_proj", "value_proj", "pos_proj")


def _pointwise(sd, prefix, node):
    sd[f"{prefix}.conv.weight"] = np.asarray(node["kernel"]).T[:, :, None]
    sd[f"{prefix}.conv.bias"] = node["bias"]


def _conformer_ff(sd, prefix, node):
    _ln(sd, f"{prefix}.0", node["LayerNorm_0"])
    _dense(sd, f"{prefix}.1.linear", node["Dense_0"])
    _dense(sd, f"{prefix}.4.linear", node["Dense_1"])


def _conformer_stack(sd, prefix, stack, stack_stats):
    """``{prefix}.layer_stack.{i}.sequential.*`` from the JAX ``stack``
    (the upstream layout ``torch_import.py:_conformer_layer`` reads)."""
    i = 0
    while f"layer_stack_{i}" in stack:
        layer = stack[f"layer_stack_{i}"]
        p = f"{prefix}.layer_stack.{i}.sequential"
        _conformer_ff(sd, f"{p}.0.module.sequential", layer["ff1"])
        a = f"{p}.1.module"
        _ln(sd, f"{a}.layer_norm", layer["attn_norm"])
        att = layer["attn"]
        C = att["query_proj"]["kernel"].shape[0]
        for name in _HEADED:
            sd[f"{a}.attention.{name}.linear.weight"] = \
                att[name]["kernel"].reshape(C, -1).T
        sd[f"{a}.attention.out_proj.linear.weight"] = \
            att["out_proj"]["kernel"].reshape(-1, C).T
        sd[f"{a}.attention.u_bias"] = att["u_bias"]
        sd[f"{a}.attention.v_bias"] = att["v_bias"]
        c, conv = f"{p}.2.module.sequential", layer["conv"]
        _ln(sd, f"{c}.0", conv["LayerNorm_0"])
        _pointwise(sd, f"{c}.2", conv["pw1"])
        sd[f"{c}.4.conv.weight"] = _conv(conv["dw"]["kernel"])
        _ln(sd, f"{c}.5", conv["bn"])
        bn = stack_stats[f"layer_stack_{i}"]["conv"]["bn"]
        sd[f"{c}.5.running_mean"] = bn["mean"]
        sd[f"{c}.5.running_var"] = bn["var"]
        sd[f"{c}.5.num_batches_tracked"] = np.zeros((), np.int64)
        _pointwise(sd, f"{c}.7", conv["pw2"])
        _conformer_ff(sd, f"{p}.3.module.sequential", layer["ff2"])
        _ln(sd, f"{p}.4", layer["final_norm"])
        i += 1


_REFORMER_ATTN = ("toqk", "tov", "to_out")
_REFORMER_FF = ("w1", "w2")


def _reformer_stack(sd, prefix, node):
    """``{prefix}.layer_stack.net.layers.irrev_blocks.{i}.*`` from the JAX
    ``stack/reformer`` (the upstream layout ``torch_import.py:_reformer_stack``
    reads)."""
    i = 0
    while f"norm_f_{i}" in node:
        p = f"{prefix}.layer_stack.net.layers.irrev_blocks.{i}"
        _ln(sd, f"{p}.f.norm", node[f"norm_f_{i}"])
        _ln(sd, f"{p}.g.norm", node[f"norm_g_{i}"])
        for name in _REFORMER_ATTN:
            _dense(sd, f"{p}.f.fn.{name}", node["attn"][name])
        for name in _REFORMER_FF:
            _dense(sd, f"{p}.g.fn.fn.{name}", node["ff"][name])
        i += 1


_CLASSIC_QKV = ("w_qs", "w_ks", "w_vs")


def _classic_stack(sd, prefix, node):
    """``{prefix}.layer_stack.{i}`` from the JAX ``layer_stack_{i}`` nodes
    (the upstream layout ``torch_import.py:_classic_layer`` reads)."""
    i = 0
    while f"layer_stack_{i}" in node:
        layer = node[f"layer_stack_{i}"]
        p = f"{prefix}.layer_stack.{i}"
        att = layer["slf_attn"]
        C = att["w_qs"]["kernel"].shape[0]
        for name in _CLASSIC_QKV:
            sd[f"{p}.slf_attn.{name}.linear.weight"] = \
                att[name]["kernel"].reshape(C, -1).T
        sd[f"{p}.slf_attn.fc.linear.weight"] = \
            att["fc"]["kernel"].reshape(-1, C).T
        _ln(sd, f"{p}.slf_attn.layer_norm", att["LayerNorm_0"])
        ffn = layer["pos_ffn"]
        for name in ("w_1", "w_2"):
            _conv_params(sd, f"{p}.pos_ffn.{name}", ffn[name]["Conv_0"])
        _ln(sd, f"{p}.pos_ffn.layer_norm", ffn["LayerNorm_0"])
        i += 1


_FAST_ATTN = ("query", "key", "transform")
_FAST_TIED = ("to_q_attn_logits", "to_k_attn_logits")
_LS_DENSE = ("to_q", "to_kv", "to_dynamic_proj", "to_out")
_LS_NORMS = ("local_norm", "global_norm")


def _prenorm_stack(sd, prefix, node):
    """``{prefix}.layer_stack.layers.{i}.{0,1}`` from a fastformer or
    lstransformer ``layer_stack`` node (the upstream layouts
    ``torch_import.py:_fastformer_stack`` / ``_lstransformer_stack`` read);
    the fastformer's tied logit projections under every ``i``."""
    i = 0
    while f"norm_attn_{i}" in node:
        p = f"{prefix}.layer_stack.layers.{i}"
        _ln(sd, f"{p}.0.norm", node[f"norm_attn_{i}"])
        att = node[f"attn_{i}"]
        if "to_q_attn_logits" in node:                       # fastformer
            for name in _FAST_ATTN:
                _dense(sd, f"{p}.0.fn.{name}", att[name])
            for name in _FAST_TIED:
                _dense(sd, f"{p}.0.fn.{name}", node[name])
        else:
            for name in _LS_DENSE:
                _dense(sd, f"{p}.0.fn.{name}", att[name])
            for name in _LS_NORMS:
                _ln(sd, f"{p}.0.fn.{name}", att[name])
        _ln(sd, f"{p}.1.norm", node[f"norm_ff_{i}"])
        for name in ("w_1", "w_2"):
            _conv_params(sd, f"{p}.1.fn.{name}",
                         node[f"ff_{i}"][name]["Conv_0"])
        i += 1


_GATES = ("r", "z", "n")


def _predictor(sd, prefix, node):
    conv = node["conv"]
    i = 0
    while f"conv_{i}" in conv:
        _conv_params(sd, f"{prefix}.conv.{i}.1", conv[f"conv_{i}"]["Conv_0"])
        _ln(sd, f"{prefix}.conv.{i}.3", conv[f"LayerNorm_{i}"]["LayerNorm_0"])
        i += 1
    if "linear" in node:
        _dense(sd, f"{prefix}.linear", node["linear"])
    if "pos_embed_alpha" in node:
        sd[f"{prefix}.pos_embed_alpha"] = node["pos_embed_alpha"]
    if "ar" in node:                           # PitchPredictorAR
        gru = node["ar"]["gru"]
        sd[f"{prefix}.gru.weight_ih_l0"] = np.concatenate(
            [np.asarray(gru[f"i{g}"]["kernel"]).T for g in _GATES])
        sd[f"{prefix}.gru.weight_hh_l0"] = np.concatenate(
            [np.asarray(gru[f"h{g}"]["kernel"]).T for g in _GATES])
        sd[f"{prefix}.gru.bias_ih_l0"] = np.concatenate(
            [gru[f"i{g}"]["bias"] for g in _GATES])
        b_hn = np.asarray(gru["hn"]["bias"])
        sd[f"{prefix}.gru.bias_hh_l0"] = np.concatenate(
            [np.zeros(2 * b_hn.shape[0], b_hn.dtype), b_hn])
        _dense(sd, f"{prefix}.head", node["ar"]["head"])


_MDN = (("w", "w.0"), ("sigma", "sigma"), ("mu", "mu"))
_STL = ("W_query", "W_key", "W_value")
_LIU_ENCODERS = ("utterance_prosody_encoder", "phoneme_prosody_encoder")
_LIU_PREDICTORS = ("utterance_prosody_predictor", "phoneme_prosody_predictor")
_LIU_PRJ = ("utterance_prosody_prj", "phoneme_prosody_prj")


def _conv2d(kernel):          # flax [kh, kw, in, out] → [out, in, kh, kw]
    return np.transpose(kernel, (3, 2, 0, 1))


def _bn(sd, prefix, node, stats):
    _ln(sd, prefix, node)
    sd[f"{prefix}.running_mean"] = stats["mean"]
    sd[f"{prefix}.running_var"] = stats["var"]
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _gru(sd, prefix, node, suffix="_l0"):
    cell = node["gru"]
    for jax_name, name in (("wi", "weight_ih"), ("wh", "weight_hh")):
        sd[f"{prefix}.{name}{suffix}"] = np.asarray(cell[jax_name]).T
    sd[f"{prefix}.bias_ih{suffix}"] = cell["bi"]
    sd[f"{prefix}.bias_hh{suffix}"] = cell["bh"]


def gru_sd(sd, p, node):
    """A JAX ``GRU`` (``fwd``, and ``bwd`` when bidirectional) → one
    ``nn.GRU``."""
    _gru(sd, p, node["fwd"]["cell"])
    if "bwd" in node:
        _gru(sd, p, node["bwd"]["cell"], "_l0_reverse")


def conv_block_2d_sd(sd, p, node, stats):
    """A ``ConvBlock2D`` (the JAX ``_ConvBlock2DMel``)."""
    sd[f"{p}.conv_layer.0.conv.weight"] = _conv2d(node["Conv_0"]["kernel"])
    _bn(sd, f"{p}.conv_layer.1", node["BatchNorm_0"], stats["BatchNorm_0"])


def du_extractor_sd(sd, p, node, stats):
    """``{p}.*`` of a ``DuProsodyExtractor`` from its JAX params and
    batch_stats."""
    for i in (0, 1):
        conv_block_2d_sd(sd, f"{p}.conv_stack.{i}", node[f"conv_{i}"],
                         stats[f"conv_{i}"])
    gru_sd(sd, f"{p}.gru", {"fwd": node["gru_fwd"], "bwd": node["gru_bwd"]})


def masked_conv_block_sd(sd, p, node):
    """``{p}.*`` of a ``ConvBlock`` (the JAX ``_MaskedConvBlock``)."""
    _conv_params(sd, f"{p}.conv_layer.0.conv", node["ConvNorm_0"]["Conv_0"])
    _ln(sd, f"{p}.conv_layer.1", node["LayerNorm_0"])


def mdn_sd(sd, p, node):
    for name, slot in _MDN:
        _dense(sd, f"{p}.{slot}", node[name])


def du_predictor_sd(sd, p, node):
    for i in (0, 1):
        masked_conv_block_sd(sd, f"{p}.conv_stack.{i}", node[f"conv_{i}"])
    _gru(sd, f"{p}.gru_cell", node["gru_cell"], "")
    mdn_sd(sd, f"{p}.gmm_mdn", node["gmm_mdn"])


def coord_conv_sd(sd, p, node):
    sd[f"{p}.conv.weight"] = _conv2d(node["Conv_0"]["kernel"])
    sd[f"{p}.conv.bias"] = node["Conv_0"]["bias"]


def reference_encoder_sd(sd, p, node, stats):
    coord_conv_sd(sd, f"{p}.convs.0", node["conv_0"])
    i = 0
    while f"bn_{i}" in node:
        if i:
            sd[f"{p}.convs.{i}.weight"] = _conv2d(node[f"conv_{i}"]["kernel"])
            sd[f"{p}.convs.{i}.bias"] = node[f"conv_{i}"]["bias"]
        _bn(sd, f"{p}.bns.{i}", node[f"bn_{i}"], stats[f"bn_{i}"])
        i += 1
    gru_sd(sd, f"{p}.gru", node["gru"])


def stl_sd(sd, p, node):
    sd[f"{p}.embed"] = node["embed"]
    for name in _STL:
        _dense(sd, f"{p}.attention.{name}", node["attention"][name])


def prosody_encoder_sd(sd, p, node, stats):
    """An utterance- or phone-level prosody encoder."""
    reference_encoder_sd(sd, f"{p}.encoder", node["encoder"],
                         stats["encoder"])
    for name in ("encoder_prj", "encoder_bottleneck"):
        _dense(sd, f"{p}.{name}", node[name])
    if "stl" in node:
        stl_sd(sd, f"{p}.stl", node["stl"])
    for j, name in enumerate(("q_lin", "k_lin")):
        if name in node:
            _dense(sd, f"{p}.linears.{j}.linear", node[name])


def parallel_predictor_sd(sd, p, node):
    for i in (1, 2):
        c = f"{p}.conv_layer"
        _conv_params(sd, f"{c}.conv1d_{i}.conv", node[f"conv1d_{i}"]["Conv_0"])
        _ln(sd, f"{c}.layer_norm_{i}", node[f"LayerNorm_{i - 1}"])
    gru_sd(sd, f"{p}.gru", node["gru"])
    _dense(sd, f"{p}.predictor_bottleneck", node["predictor_bottleneck"])


def nonparallel_predictor_sd(sd, p, node):
    for i in (0, 1):
        masked_conv_block_sd(sd, f"{p}.conv_stack.{i}", node[f"conv_{i}"])
    _gru(sd, f"{p}.gru_cell", node["gru_cell"], "")
    _dense(sd, f"{p}.predictor_bottleneck", node["predictor_bottleneck"])


def liu_prosody_sd(sd, p, node, stats):
    """The JAX ``liu_prosody`` subtree → its modules under ``{p}.``."""
    for enc in _LIU_ENCODERS:
        prosody_encoder_sd(sd, f"{p}.{enc}", node[enc], stats[enc])
    for pred in _LIU_PREDICTORS:
        parallel_predictor_sd(sd, f"{p}.{pred}", node[pred])
    for name in _LIU_PRJ:
        _dense(sd, f"{p}.{name}", node[name])


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
             "variance_adaptor", "speaker_emb"}
    extra = set(params) - known
    if extra:
        raise NotImplementedError(
            f"parameters for {sorted(extra)} have no module in ctts_torch yet")
    sd = {}
    enc = params["encoder"]
    if "reformer" in enc.get("stack", {}):
        sd["encoder.src_word_emb.weight"] = enc["src_word_emb"]["embedding"]
        for side in ("encoder", "decoder"):
            _reformer_stack(sd, side, params[side]["stack"]["reformer"])
    elif "stack" in enc:                                    # conformer
        sd["encoder.src_word_emb.weight"] = enc["src_word_emb"]["embedding"]
        for side in ("encoder", "decoder"):
            _conformer_stack(sd, side, params[side]["stack"],
                             stats[side]["stack"])
    elif "layer_stack_0" in enc:                     # classic transformer
        sd["encoder.src_word_emb.weight"] = enc["src_word_emb"]["embedding"]
        for side in ("encoder", "decoder"):
            _classic_stack(sd, side, params[side])
    elif "layer_stack" in enc:                      # fastformer, lstransformer
        sd["encoder.src_word_emb.weight"] = enc["src_word_emb"]["embedding"]
        for side in ("encoder", "decoder"):
            _prenorm_stack(sd, side, params[side]["layer_stack"])
    else:
        sd["encoder.embed_tokens.weight"] = enc["embed_tokens"]["embedding"]
        _fft_stack(sd, "encoder", enc["fft"])
        _fft_stack(sd, "decoder", params["decoder"]["fft"])
    _dense(sd, "mel_linear", params["mel_linear"])
    spk = params.get("speaker_emb")
    if spk is not None and "embedding" in spk:
        sd["speaker_emb.weight"] = spk["embedding"]
    elif spk is not None:
        _dense(sd, "speaker_emb", spk)

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
    va_known = {"duration_predictor", "dur_crf", "pitch_embed",
                "cwt_in_proj", "cwt_predictor", "cwt_stats_layers",
                "pitch_predictor", "energy_predictor", "energy_embedding",
                "aligner", "prosody_extractor", "prosody_predictor",
                "prosody_linear", "liu_prosody"}
    extra = set(va) - va_known
    if extra:
        raise NotImplementedError(
            f"variance-adaptor parameters {sorted(extra)} have no module in "
            "ctts_torch yet")
    p = "variance_adaptor"
    _predictor(sd, f"{p}.duration_predictor", va["duration_predictor"])
    for name, leaf in va.get("dur_crf", {}).items():
        sd[f"{p}.duration_predictor.crf.{name}"] = leaf
    if "pitch_predictor" in va:
        _predictor(sd, f"{p}.pitch_predictor", va["pitch_predictor"])
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
        for name in _ALIGNER_SPK:
            if name in va["aligner"]:
                _dense(sd, f"{p}.aligner.{name}.linear", va["aligner"][name])
    va_stats = stats.get("variance_adaptor", {})
    if "prosody_extractor" in va:
        du_extractor_sd(sd, f"{p}.prosody_extractor", va["prosody_extractor"],
                        va_stats["prosody_extractor"])
        du_predictor_sd(sd, f"{p}.prosody_predictor", va["prosody_predictor"])
        _dense(sd, f"{p}.prosody_linear.linear", va["prosody_linear"])
    if "liu_prosody" in va:
        liu_prosody_sd(sd, p, va["liu_prosody"], va_stats["liu_prosody"])
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


def _inv_conformer_ff(sd, prefix):
    return {"LayerNorm_0": _inv_ln(sd, f"{prefix}.0"),
            "Dense_0": _inv_dense(sd, f"{prefix}.1.linear"),
            "Dense_1": _inv_dense(sd, f"{prefix}.4.linear")}


def _inv_pointwise(sd, prefix):
    return {"kernel": sd[f"{prefix}.conv.weight"][:, :, 0].T,
            "bias": sd[f"{prefix}.conv.bias"]}


def _inv_conformer_stack(sd, prefix, num_heads):
    """(params, batch_stats) of a JAX conformer ``stack``."""
    params, stats = {}, {}
    i = 0
    while f"{prefix}.layer_stack.{i}.sequential.4.weight" in sd:
        p = f"{prefix}.layer_stack.{i}.sequential"
        a, c = f"{p}.1.module", f"{p}.2.module.sequential"
        C = sd[f"{a}.attention.out_proj.linear.weight"].shape[0]
        att = {name: {"kernel": sd[f"{a}.attention.{name}.linear.weight"].T
                      .reshape(C, num_heads, -1)} for name in _HEADED}
        att["out_proj"] = {"kernel": sd[f"{a}.attention.out_proj.linear."
                                        "weight"].T.reshape(num_heads, -1, C)}
        att["u_bias"] = sd[f"{a}.attention.u_bias"]
        att["v_bias"] = sd[f"{a}.attention.v_bias"]
        params[f"layer_stack_{i}"] = {
            "ff1": _inv_conformer_ff(sd, f"{p}.0.module.sequential"),
            "attn_norm": _inv_ln(sd, f"{a}.layer_norm"),
            "attn": att,
            "conv": {"LayerNorm_0": _inv_ln(sd, f"{c}.0"),
                     "pw1": _inv_pointwise(sd, f"{c}.2"),
                     "dw": {"kernel": _conv(sd[f"{c}.4.conv.weight"])},
                     "bn": _inv_ln(sd, f"{c}.5"),
                     "pw2": _inv_pointwise(sd, f"{c}.7")},
            "ff2": _inv_conformer_ff(sd, f"{p}.3.module.sequential"),
            "final_norm": _inv_ln(sd, f"{p}.4")}
        stats[f"layer_stack_{i}"] = {"conv": {"bn": {
            "mean": sd[f"{c}.5.running_mean"],
            "var": sd[f"{c}.5.running_var"]}}}
        i += 1
    return params, stats


def _inv_reformer_stack(sd, prefix):
    """The JAX ``stack/reformer`` params; the tied modules are read from
    layer 0."""
    blocks = f"{prefix}.layer_stack.net.layers.irrev_blocks"
    node = {}
    i = 0
    while f"{blocks}.{i}.f.norm.weight" in sd:
        node[f"norm_f_{i}"] = _inv_ln(sd, f"{blocks}.{i}.f.norm")
        node[f"norm_g_{i}"] = _inv_ln(sd, f"{blocks}.{i}.g.norm")
        i += 1
    node["attn"] = {n: _inv_dense(sd, f"{blocks}.0.f.fn.{n}")
                    for n in _REFORMER_ATTN}
    node["ff"] = {n: _inv_dense(sd, f"{blocks}.0.g.fn.fn.{n}")
                  for n in _REFORMER_FF}
    return {"stack": {"reformer": node}}


def _inv_classic_stack(sd, prefix, num_heads):
    """The JAX ``layer_stack_{i}`` nodes of a classic transformer stack."""
    node = {}
    i = 0
    while f"{prefix}.layer_stack.{i}.slf_attn.fc.linear.weight" in sd:
        p = f"{prefix}.layer_stack.{i}"
        fc = sd[f"{p}.slf_attn.fc.linear.weight"]
        C = fc.shape[0]
        att = {name: {"kernel": sd[f"{p}.slf_attn.{name}.linear.weight"].T
                      .reshape(C, num_heads, -1)} for name in _CLASSIC_QKV}
        att["fc"] = {"kernel": fc.T.reshape(num_heads, -1, C)}
        att["LayerNorm_0"] = _inv_ln(sd, f"{p}.slf_attn.layer_norm")
        ffn = {name: {"Conv_0": _inv_conv(sd, f"{p}.pos_ffn.{name}")}
               for name in ("w_1", "w_2")}
        ffn["LayerNorm_0"] = _inv_ln(sd, f"{p}.pos_ffn.layer_norm")
        node[f"layer_stack_{i}"] = {"slf_attn": att, "pos_ffn": ffn}
        i += 1
    return node


def _inv_prenorm_stack(sd, prefix):
    """The JAX ``layer_stack`` node of a fastformer or lstransformer stack;
    the fastformer's tied projections are read from layer 0."""
    layers = f"{prefix}.layer_stack.layers"
    fast = f"{layers}.0.0.fn.to_q_attn_logits.weight" in sd
    node = {}
    i = 0
    while f"{layers}.{i}.0.norm.weight" in sd:
        p = f"{layers}.{i}"
        node[f"norm_attn_{i}"] = _inv_ln(sd, f"{p}.0.norm")
        if fast:
            att = {n: _inv_dense(sd, f"{p}.0.fn.{n}") for n in _FAST_ATTN}
        else:
            att = {n: _inv_dense(sd, f"{p}.0.fn.{n}") for n in _LS_DENSE}
            att.update({n: _inv_ln(sd, f"{p}.0.fn.{n}") for n in _LS_NORMS})
        node[f"attn_{i}"] = att
        node[f"norm_ff_{i}"] = _inv_ln(sd, f"{p}.1.norm")
        node[f"ff_{i}"] = {n: {"Conv_0": _inv_conv(sd, f"{p}.1.fn.{n}")}
                           for n in ("w_1", "w_2")}
        i += 1
    if fast:
        node.update({n: _inv_dense(sd, f"{layers}.0.0.fn.{n}")
                     for n in _FAST_TIED})
    return node


def _inv_predictor(sd, prefix):
    conv = {}
    i = 0
    while f"{prefix}.conv.{i}.1.weight" in sd:
        conv[f"conv_{i}"] = {"Conv_0": _inv_conv(sd, f"{prefix}.conv.{i}.1")}
        conv[f"LayerNorm_{i}"] = {
            "LayerNorm_0": _inv_ln(sd, f"{prefix}.conv.{i}.3")}
        i += 1
    node = {"conv": conv}
    if f"{prefix}.linear.weight" in sd:
        node["linear"] = _inv_dense(sd, f"{prefix}.linear")
    if f"{prefix}.pos_embed_alpha" in sd:
        node["pos_embed_alpha"] = sd[f"{prefix}.pos_embed_alpha"]
    if f"{prefix}.gru.weight_ih_l0" in sd:     # PitchPredictorAR
        g = f"{prefix}.gru"
        w_ih, w_hh = (np.split(sd[f"{g}.weight_{n}_l0"], 3)
                      for n in ("ih", "hh"))
        b_ih, b_hh = (np.split(sd[f"{g}.bias_{n}_l0"], 3)
                      for n in ("ih", "hh"))
        gru = {}
        for j, gate in enumerate(_GATES):
            gru[f"i{gate}"] = {"kernel": w_ih[j].T, "bias": b_ih[j]}
            gru[f"h{gate}"] = {"kernel": w_hh[j].T}
        gru["hn"]["bias"] = b_hh[2]
        node["ar"] = {"gru": gru, "head": _inv_dense(sd, f"{prefix}.head")}
    return node


def _inv_bn(sd, prefix):
    return _inv_ln(sd, prefix), {"mean": sd[f"{prefix}.running_mean"],
                                 "var": sd[f"{prefix}.running_var"]}


def _inv_gru(sd, prefix, suffix="_l0"):
    return {"gru": {"wi": sd[f"{prefix}.weight_ih{suffix}"].T,
                    "wh": sd[f"{prefix}.weight_hh{suffix}"].T,
                    "bi": sd[f"{prefix}.bias_ih{suffix}"],
                    "bh": sd[f"{prefix}.bias_hh{suffix}"]}}


def _inv_conv2d(sd, prefix):
    # [out, in, kh, kw] → [kh, kw, in, out]
    return np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))


def _inv_du_prosody(sd, p):
    """(params, batch_stats) of the du2021 subtrees of the adaptor."""
    ext, ext_stats, pred = {}, {}, {}
    for i in (0, 1):
        c = f"{p}.prosody_extractor.conv_stack.{i}.conv_layer"
        bn, bn_stats = _inv_bn(sd, f"{c}.1")
        ext[f"conv_{i}"] = {
            "Conv_0": {"kernel": _inv_conv2d(sd, f"{c}.0.conv")},
            "BatchNorm_0": bn}
        ext_stats[f"conv_{i}"] = {"BatchNorm_0": bn_stats}
        c = f"{p}.prosody_predictor.conv_stack.{i}.conv_layer"
        pred[f"conv_{i}"] = {
            "ConvNorm_0": {"Conv_0": _inv_conv(sd, f"{c}.0.conv")},
            "LayerNorm_0": _inv_ln(sd, f"{c}.1")}
    ext["gru_fwd"] = {"cell": _inv_gru(sd, f"{p}.prosody_extractor.gru")}
    ext["gru_bwd"] = {"cell": _inv_gru(sd, f"{p}.prosody_extractor.gru",
                                       "_l0_reverse")}
    pred["gru_cell"] = _inv_gru(sd, f"{p}.prosody_predictor.gru_cell", "")
    pred["gmm_mdn"] = {name: _inv_dense(sd, f"{p}.prosody_predictor.gmm_mdn."
                                            f"{slot}") for name, slot in _MDN}
    params = {"prosody_extractor": ext, "prosody_predictor": pred,
              "prosody_linear": _inv_dense(sd, f"{p}.prosody_linear.linear")}
    return params, {"prosody_extractor": ext_stats}


def _inv_ref_encoder(sd, p):
    conv0 = {"kernel": _inv_conv2d(sd, f"{p}.convs.0.conv"),
             "bias": sd[f"{p}.convs.0.conv.bias"]}
    node = {"conv_0": {"Conv_0": conv0}}
    stats = {}
    i = 0
    while f"{p}.bns.{i}.weight" in sd:
        if i:
            node[f"conv_{i}"] = {"kernel": _inv_conv2d(sd, f"{p}.convs.{i}"),
                                 "bias": sd[f"{p}.convs.{i}.bias"]}
        node[f"bn_{i}"], stats[f"bn_{i}"] = _inv_bn(sd, f"{p}.bns.{i}")
        i += 1
    node["gru"] = {"fwd": {"cell": _inv_gru(sd, f"{p}.gru")}}
    return node, stats


def _inv_liu_prosody(sd, p):
    """(params, batch_stats) of the JAX ``liu_prosody`` subtree."""
    node, stats = {}, {}
    for enc in _LIU_ENCODERS:
        e, s = _inv_ref_encoder(sd, f"{p}.{enc}.encoder")
        node[enc] = {"encoder": e}
        stats[enc] = {"encoder": s}
        for name in ("encoder_prj", "encoder_bottleneck"):
            node[enc][name] = _inv_dense(sd, f"{p}.{enc}.{name}")
    u = f"{p}.utterance_prosody_encoder.stl"
    node["utterance_prosody_encoder"]["stl"] = {
        "embed": sd[f"{u}.embed"],
        "attention": {n: _inv_dense(sd, f"{u}.attention.{n}") for n in _STL}}
    for j, name in enumerate(("q_lin", "k_lin")):
        node["phoneme_prosody_encoder"][name] = _inv_dense(
            sd, f"{p}.phoneme_prosody_encoder.linears.{j}.linear")
    for pred in _LIU_PREDICTORS:
        c = f"{p}.{pred}.conv_layer"
        q = {}
        for i in (1, 2):
            q[f"conv1d_{i}"] = {
                "Conv_0": _inv_conv(sd, f"{c}.conv1d_{i}.conv")}
            q[f"LayerNorm_{i - 1}"] = _inv_ln(sd, f"{c}.layer_norm_{i}")
        q["gru"] = {"fwd": {"cell": _inv_gru(sd, f"{p}.{pred}.gru")},
                    "bwd": {"cell": _inv_gru(sd, f"{p}.{pred}.gru",
                                             "_l0_reverse")}}
        q["predictor_bottleneck"] = _inv_dense(
            sd, f"{p}.{pred}.predictor_bottleneck")
        node[pred] = q
    for name in _LIU_PRJ:
        node[name] = _inv_dense(sd, f"{p}.{name}")
    return node, stats


def jax_tree_from_state_dict(state_dict, model_config):
    """The port's CompTransTTS ``state_dict`` → ``{"params": ...,
    "batch_stats": ...}`` of numpy arrays in the JAX package's layout (the
    inverse of :func:`state_dict_from_jax`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    block = model_config["block_type"]
    # fastformer and lstransformer have no section of their own
    cfg = model_config.get(block) or model_config["transformer"]
    batch_stats = {}
    if block in ("fastformer", "lstransformer"):
        params = {side: {"layer_stack": _inv_prenorm_stack(sd, side)}
                  for side in ("encoder", "decoder")}
        params["encoder"]["src_word_emb"] = {
            "embedding": sd["encoder.src_word_emb.weight"]}
    elif block == "transformer":
        params = {side: _inv_classic_stack(sd, side, cfg[f"{side}_head"])
                  for side in ("encoder", "decoder")}
        params["encoder"]["src_word_emb"] = {
            "embedding": sd["encoder.src_word_emb.weight"]}
    elif block == "reformer":
        params = {side: _inv_reformer_stack(sd, side)
                  for side in ("encoder", "decoder")}
        params["encoder"]["src_word_emb"] = {
            "embedding": sd["encoder.src_word_emb.weight"]}
    elif block == "conformer":
        params = {}
        for side in ("encoder", "decoder"):
            sp, ss = _inv_conformer_stack(sd, side, cfg[f"{side}_head"])
            params[side] = {"stack": sp}
            batch_stats[side] = {"stack": ss}
        params["encoder"]["src_word_emb"] = {
            "embedding": sd["encoder.src_word_emb.weight"]}
    else:
        params = {
            "encoder": {
                "embed_tokens": {"embedding":
                                 sd["encoder.embed_tokens.weight"]},
                "fft": _inv_fft_stack(sd, "encoder", cfg["encoder_head"])},
            "decoder": {"fft": _inv_fft_stack(sd, "decoder",
                                              cfg["decoder_head"])}}
    params["mel_linear"] = _inv_dense(sd, "mel_linear")
    if "speaker_emb.bias" in sd:                 # external embedding's Dense
        params["speaker_emb"] = _inv_dense(sd, "speaker_emb")
    elif "speaker_emb.weight" in sd:
        params["speaker_emb"] = {"embedding": sd["speaker_emb.weight"]}
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
    if f"{p}.duration_predictor.crf.transitions" in sd:
        va["dur_crf"] = {
            name: sd[f"{p}.duration_predictor.crf.{name}"]
            for name in ("start_transitions", "end_transitions",
                         "transitions")}
    if f"{p}.pitch_predictor.pos_embed_alpha" in sd:
        va["pitch_predictor"] = _inv_predictor(sd, f"{p}.pitch_predictor")
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
        for name in _ALIGNER_SPK:
            if f"{p}.aligner.{name}.linear.weight" in sd:
                va["aligner"][name] = _inv_dense(sd,
                                                 f"{p}.aligner.{name}.linear")
    if f"{p}.prosody_linear.linear.weight" in sd:
        du, du_stats = _inv_du_prosody(sd, p)
        va.update(du)
        batch_stats["variance_adaptor"] = du_stats
    if f"{p}.utterance_prosody_prj.weight" in sd:
        liu, liu_stats = _inv_liu_prosody(sd, p)
        va["liu_prosody"] = liu
        batch_stats["variance_adaptor"] = {"liu_prosody": liu_stats}
    params["variance_adaptor"] = va
    batch_stats["postnet"] = pn_stats
    return {"params": params, "batch_stats": batch_stats}


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


def melgan_state_dict_from_jax(params):
    """JAX MelGANGenerator params (``{"params": ...}`` or the inner dict) →
    the port's generator state_dict (upstream Sequential names)."""
    from ctts_torch.vocoder.melgan import MelGANGenerator, _layout
    params = params.get("params", params)
    n_up = sum(1 for k in params if re.fullmatch(r"up_\d+", k))
    n_res = sum(1 for k in params if re.fullmatch(r"res_0_\d+", k))
    conv_in, ups, groups, conv_out = _layout(
        MelGANGenerator((2,) * n_up, 1, n_res, 1).model)
    sd = {}
    _conv_params(sd, f"model.{conv_in}", params["conv_in"]["Conv_0"])
    _conv_params(sd, f"model.{conv_out}", params["conv_out"]["Conv_0"])
    for u, (up, group) in enumerate(zip(ups, groups)):
        # flax [k, out, in] → torch ConvTranspose1d [in, out, k]
        _conv_params(sd, f"model.{up}", params[f"up_{u}"])
        for j, r in enumerate(group):
            node = params[f"res_{u}_{j}"]
            _conv_params(sd, f"model.{r}.block.2", node["block_conv"]["Conv_0"])
            _conv_params(sd, f"model.{r}.block.4", node["block_out"])
            _conv_params(sd, f"model.{r}.shortcut", node["shortcut"])
    return _to_tensors(sd)


def rescnn_state_dict_from_jax(variables):
    """The JAX DeepSpeaker ResCNN's variables (``params`` and
    ``batch_stats``, numpy leaves; ``models.speaker.load_keras_weights``
    gives the same tree from a Keras ``.h5``) → the port's
    ``models.speaker.ResCNN`` state_dict: 2-D conv kernels ``[kh, kw, in,
    out]`` → ``[out, in, kh, kw]``, each BatchNorm's scale, bias and
    statistics, the affine's ``[in, out]`` kernel transposed."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def conv(prefix, node):
        sd[f"{prefix}.weight"] = _conv2d(node["kernel"])
        sd[f"{prefix}.bias"] = node["bias"]

    for name, node in params.items():
        if name == "affine":
            _dense(sd, name, node)
        elif name.startswith("conv_"):
            conv(name, node)
        elif name.startswith("bn_"):
            _bn(sd, name, node, stats[name])
        else:                                    # res_{i}_{j}
            for part in ("a", "b"):
                conv(f"{name}.conv_{part}", node[f"conv_{part}"])
                _bn(sd, f"{name}.bn_{part}", node[f"bn_{part}"],
                    stats[name][f"bn_{part}"])
    return _to_tensors(sd)
