"""Prosody models (ctts_tpu/models/prosody.py): Du et al. 2021, a phone-level
GMM-MDN, and Liu et al. 2021 (DelightfulTTS), utterance- and phone-level
prosody encoders with their predictors.

Parameter names are upstream's (model/modules.py), so its state_dicts load
as they are; every module computes in float32. GRUs are ``nn.GRU`` /
``nn.GRUCell``, whose cell is the JAX package's ``_GRUCellT`` (the hidden
bias of n inside the reset product). BatchNorm follows flax: batch
statistics over every position of the padded batch with the biased
variance, running statistics moved by ``0.99·old + 0.01·batch``.

* ``DuProsodyExtractor`` runs its (1, k) conv stack over the whole mel and
  then one bidirectional GRU over every phone's frames at once: each row is
  cut where ``mel2ph`` changes (the ``mel2ph == 0`` tail is a segment of
  its own) and the segments go through one packed ``nn.GRU``
  (:func:`segment_gru`). That equals the JAX package's scans whose state
  resets at each change; a phone's embedding is the forward output at its
  last frame and the backward output at its first, indexed as JAX indexes
  them, so a phone of duration 0 takes its neighbours' states.
* ``DuProsodyPredictor`` is autoregressive over phones (its GRU cell reads
  ``[x_t, h]``), one ``torch.gru_cell`` a phone; ``sample`` draws a mixture
  component and gaussian noise from a ``torch.Generator`` (seed 0 at each
  call when none is given) or takes given draws.
* :func:`liu_prosody` adds the utterance and phone prosody of
  reference-encoder targets in training and of its predictors at
  inference.
"""

import collections
import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import PackedSequence

from ctts_torch.models.blocks import ConvNorm, Dropout, LayerNorm
from ctts_torch.models.conformer import LinearNorm
from ctts_torch.models.registry import block_hidden
from ctts_torch.ops.length_regulator import dur_to_mel2ph


# ---- GRUs ----------------------------------------------------------------- #

@contextlib.contextmanager
def _backward_ready(rnn):
    """Run ``rnn`` (no dropout, so either mode computes the same) in train
    mode while autograd records: cuDNN refuses the backward of an RNN
    called in eval mode, which a step with dropout off asks for."""
    was = rnn.training
    rnn.training = was or torch.is_grad_enabled()
    try:
        yield
    finally:
        rnn.training = was


class GRU(nn.GRU):
    """One-layer batch-first GRU returning (memory, final state), as the
    JAX package's ``GRU``: unidirectional, the final state is the output at
    ``lengths - 1`` (the memory runs over the whole padded input);
    bidirectional (without lengths), the backward pass starts at the padded
    end and the final state is [forward last, backward first]."""

    def __init__(self, input_size, hidden_size, bidirectional=False):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=bidirectional)

    def forward(self, x, lengths=None):
        with _backward_ready(self):
            memory, _ = super().forward(x.float())
        H = self.hidden_size
        if lengths is None:
            last = memory[:, -1, :H]
        else:
            idx = torch.clamp(lengths.long() - 1, min=0)
            last = memory[torch.arange(x.shape[0], device=x.device), idx, :H]
        if not self.bidirectional:
            return memory, last
        if lengths is not None:
            raise ValueError("a bidirectional GRU with lengths is used by no "
                             "model")
        return memory, torch.cat([last, memory[:, 0, H:]], dim=-1)


def segment_gru(gru, x, mel2ph):
    """A bidirectional ``nn.GRU`` (batch first) over each run of equal
    ``mel2ph`` in each row of x [B, T, C], its state starting from zero at
    both ends of every run. The runs go through one call as a
    ``PackedSequence`` whose rows are x's frames in packed order (runs by
    length, longest first, then time), so packing and unpacking are one
    row gather each. Returns [B, T, 2H]. Two host syncs (the run starts and
    the lengths)."""
    B, T, C = x.shape
    dev = x.device
    start = torch.ones_like(mel2ph, dtype=torch.bool)
    start[:, 1:] = mel2ph[:, 1:] != mel2ph[:, :-1]
    start = start.reshape(-1)
    seg = torch.cumsum(start.long(), 0) - 1                    # [B·T]
    first = torch.nonzero(start).squeeze(1)                    # run starts
    offset = torch.arange(B * T, device=dev) - first[seg]
    lengths = torch.diff(first, append=first.new_full((1,), B * T))
    order = torch.argsort(lengths, descending=True, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev)
    lengths_cpu = lengths.cpu()
    batch_sizes = (lengths_cpu[None, :] > torch.arange(
        int(lengths_cpu.max()))[:, None]).sum(dim=1)           # [L] on host
    step_start = (torch.cumsum(batch_sizes, 0) - batch_sizes).to(dev)
    row = step_start[offset] + rank[seg]        # frame → packed row
    frame = torch.empty_like(row)
    frame[row] = torch.arange(B * T, device=dev)  # packed row → frame
    packed = PackedSequence(x.reshape(B * T, C).index_select(0, frame),
                            batch_sizes)
    with _backward_ready(gru):
        out = gru(packed)[0].data
    return out.index_select(0, row).reshape(B, T, -1)


def segment_gru_loop(gru, x, mel2ph):
    """The same function as :func:`segment_gru`, one ``gru_cell`` a frame in
    each direction with the state zeroed where ``mel2ph`` changes (the JAX
    package's formulation); a test oracle."""
    B, T, _ = x.shape
    prev = F.pad(mel2ph[:, :-1], (1, 0))
    nxt = F.pad(mel2ph[:, 1:], (0, 1))
    outs = []
    for sfx, reset, order in (("", mel2ph != prev, range(T)),
                              ("_reverse", mel2ph != nxt,
                               range(T - 1, -1, -1))):
        w = [getattr(gru, f"{n}_l0{sfx}") for n in
             ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h = x.new_zeros(B, gru.hidden_size)
        seq = [None] * T
        for t in order:
            h = torch.where(reset[:, t, None], torch.zeros_like(h), h)
            h = seq[t] = torch.gru_cell(x[:, t], h, *w)
        outs.append(torch.stack(seq, dim=1))
    return torch.cat(outs, dim=-1)


# ---- BatchNorm and convs over (time, mel) --------------------------------- #

class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over the channels of [B, C, H, W] with flax's arithmetic
    (ctts_torch/models/postnet.py:BatchNorm for [B, T, C])."""

    def __init__(self, features, momentum=0.99, eps=1e-5):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


class _Conv2dNorm(nn.Module):
    """Bias-free (1, k) conv over [B, C, T, n_mel], SAME along the mel axis
    (upstream ``.conv`` path)."""

    def __init__(self, cin, cout, kernel_size):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, (1, kernel_size), bias=False)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)

    def forward(self, x):
        return self.conv(F.pad(x, self.pad))


class ConvBlock2D(nn.Module):
    """(1, k) conv + BatchNorm + ReLU over (time, mel): no mixing across
    time, so the whole mel at once equals the reference's per-phone slices
    except the batch statistics in training, which pool the padded batch
    (as in the JAX package)."""

    def __init__(self, cin, cout, kernel_size):
        super().__init__()
        self.conv_layer = nn.Sequential(_Conv2dNorm(cin, cout, kernel_size),
                                        BatchNorm2d(cout))

    def forward(self, x):
        return torch.relu(self.conv_layer(x))


# ---- Du et al. 2021 ------------------------------------------------------- #

class DuProsodyExtractor(nn.Module):
    """Target prosody embeddings [B, T_s, 2·d_model] from the mel and the
    phone durations."""

    def __init__(self, n_mel_channels, d_model, kernel_size):
        super().__init__()
        self.conv_stack = nn.ModuleList([
            ConvBlock2D(1, d_model, kernel_size),
            ConvBlock2D(d_model, 1, kernel_size)])
        self.gru = nn.GRU(n_mel_channels, d_model, batch_first=True,
                          bidirectional=True)

    def forward(self, mel, duration, src_mask):
        """mel [B, T_m, n_mel]; duration [B, T_s]; src_mask True at
        padding."""
        T_m = mel.shape[1]
        x = mel.float()[:, None]                          # [B, 1, T, mel]
        for block in self.conv_stack:
            x = block(x)
        x = x[:, 0]                                       # [B, T, mel]
        mel2ph = dur_to_mel2ph(duration, src_mask, max_len=T_m)
        out = segment_gru(self.gru, x, mel2ph)
        H = self.gru.hidden_size
        dur = torch.round(duration.float()).long()
        cum = torch.cumsum(dur * (~src_mask).long(), dim=1)
        last_idx = torch.clamp(cum - 1, 0, T_m - 1)
        first_idx = torch.clamp(cum - dur, 0, T_m - 1)
        h_fwd = torch.gather(out[..., :H], 1,
                             last_idx[..., None].expand(-1, -1, H))
        h_bwd = torch.gather(out[..., H:], 1,
                             first_idx[..., None].expand(-1, -1, H))
        e = torch.cat([h_fwd, h_bwd], dim=-1)
        return e.masked_fill(src_mask[..., None], 0.0)


class ConvBlock(nn.Module):
    """ConvNorm, LayerNorm (eps 1e-6), ReLU, dropout, the mask (upstream
    ``conv_layer.{0,1}``)."""

    def __init__(self, cin, cout, kernel_size, dropout):
        super().__init__()
        self.conv_layer = nn.Sequential(ConvNorm(cin, cout, kernel_size),
                                        LayerNorm(cout, eps=1e-6))
        self.dropout = Dropout(dropout)

    def forward(self, x, mask):
        x = self.dropout(torch.relu(self.conv_layer(x.float())))
        return x.masked_fill(mask[..., None], 0.0)


class MDN(nn.Module):
    """Mixture density head: weights [B, T, G], sigma and mu [B, T, G, D];
    sigma = exp(clip(·, ±12))."""

    def __init__(self, in_features, out_features, num_gaussians):
        super().__init__()
        self.out_features = out_features
        self.num_gaussians = num_gaussians
        self.w = nn.Sequential(nn.Linear(in_features, num_gaussians),
                               nn.Softmax(dim=-1))
        self.sigma = nn.Linear(in_features, out_features * num_gaussians)
        self.mu = nn.Linear(in_features, out_features * num_gaussians)

    def forward(self, x):
        B, T, _ = x.shape
        shape = (B, T, self.num_gaussians, self.out_features)
        sigma = torch.exp(torch.clamp(self.sigma(x), -12.0, 12.0))
        return self.w(x), sigma.reshape(shape), self.mu(x).reshape(shape)


def ar_gru(cell, x):
    """``cell`` (an ``nn.GRUCell`` of width H on [x_t, h]) run over x
    [B, T, C] from a zero state, one ``torch.gru_cell`` a step; returns
    [B, T, H]."""
    w = (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)
    h = x.new_zeros(x.shape[0], cell.hidden_size)
    outs = []
    for x_t in x.unbind(1):          # one stack in the backward, not T slices
        h = torch.gru_cell(torch.cat([x_t, h], dim=-1), h, *w)
        outs.append(h)
    return torch.stack(outs, dim=1)


class DuProsodyPredictor(nn.Module):
    """Conv stack → autoregressive GRU over phones → GMM-MDN."""

    def __init__(self, d_model, kernel_sizes=(9, 5), num_gaussians=20,
                 dropout=0.2):
        super().__init__()
        self.conv_stack = nn.ModuleList(
            ConvBlock(d_model, d_model, k, dropout) for k in kernel_sizes)
        self.gru_cell = nn.GRUCell(3 * d_model, 2 * d_model)
        self.gmm_mdn = MDN(2 * d_model, 2 * d_model, num_gaussians)

    def forward(self, h_text, src_mask, training=True):
        """``training`` (the mode, not dropout) fills padded weights with 0,
        at inference with 1e-9."""
        x = h_text.float()
        for block in self.conv_stack:
            x = block(x, src_mask)
        w, sigma, mu = self.gmm_mdn(ar_gru(self.gru_cell, x))
        w = w.masked_fill(src_mask[..., None], 0.0 if training else 1e-9)
        pad = src_mask[..., None, None]
        return w, sigma.masked_fill(pad, 0.0), mu.masked_fill(pad, 0.0)

    @staticmethod
    def sample(w, sigma, mu, generator=None, src_mask=None, component=None,
               noise=None):
        """A mixture component a phone, drawn from ``w`` (a Gumbel argmax
        over log w clipped at 1e-9), then mu + sigma·N(0, 1) of it.
        ``generator``: the source of both draws (seed 0 on w's device when
        None); ``component`` [B, T] and ``noise`` [B, T, D] replace the
        draws. Padded phones give 0."""
        if generator is None and (component is None or noise is None):
            generator = torch.Generator(device=w.device).manual_seed(0)
        if component is None:
            u = torch.rand(w.shape, generator=generator, device=w.device,
                           dtype=w.dtype)
            tiny = torch.finfo(w.dtype).tiny
            gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
            component = torch.argmax(torch.log(w.clamp(min=1e-9)) + gumbel,
                                     dim=-1)
        D = mu.shape[-1]
        idx = component.long()[:, :, None, None].expand(-1, -1, 1, D)
        sig = torch.gather(sigma, 2, idx)[:, :, 0]
        m = torch.gather(mu, 2, idx)[:, :, 0]
        if noise is None:
            noise = torch.randn(m.shape, generator=generator,
                                device=m.device, dtype=m.dtype)
        out = noise * sig + m
        if src_mask is not None:
            out = out.masked_fill(src_mask[..., None], 0.0)
        return out


# ---- Liu et al. 2021 ------------------------------------------------------ #

def _linspace_f32(n, device):
    return torch.linspace(-1.0, 1.0, n, device=device, dtype=torch.float32)


class CoordConv2d(nn.Module):
    """Conv2d over [B, C, H, W] with three coordinate channels appended, in
    the reference's order and values: the H coordinate and the W coordinate,
    each in [-1, 1], and rr = sqrt((h - 0.5)² + (w - 0.5)²) taken after that
    normalisation."""

    def __init__(self, cin, cout, kernel_size, stride, padding):
        super().__init__()
        self.conv = nn.Conv2d(cin + 3, cout, kernel_size, stride=stride,
                              padding=padding)

    def forward(self, x):
        B, _, H, W = x.shape
        hh = _linspace_f32(H, x.device)[:, None].expand(H, W)
        ww = _linspace_f32(W, x.device)[None, :].expand(H, W)
        rr = torch.sqrt((hh - 0.5) ** 2 + (ww - 0.5) ** 2)
        coords = torch.stack([hh, ww, rr])[None].expand(B, 3, H, W)
        return self.conv(torch.cat([x, coords], dim=1))


def _conv_out(n, kernel, stride, pad):
    return (n - kernel + 2 * pad) // stride + 1


class ReferenceEncoder(nn.Module):
    """Strided conv stack (CoordConv first) with BatchNorm and ReLU over the
    reference mel, then a GRU; returns (memory [B, T, H], final [B, H])."""

    def __init__(self, preprocess_config, model_config):
        super().__init__()
        liu = model_config["prosody_modeling"]["liu2021"]
        filters = liu["ref_enc_filters"]
        size = tuple(liu["ref_enc_size"])
        strides = tuple(liu["ref_enc_strides"])
        pad = tuple(liu["ref_enc_pad"])
        chans = [1] + list(filters)
        convs = [CoordConv2d(1, filters[0], size, strides, pad)]
        convs += [nn.Conv2d(chans[i], chans[i + 1], size, stride=strides,
                            padding=pad) for i in range(1, len(filters))]
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(BatchNorm2d(f) for f in filters)
        width = preprocess_config["preprocessing"]["mel"]["n_mel_channels"]
        for _ in filters:
            width = _conv_out(width, size[1], strides[1], pad[1])
        self.gru = GRU(filters[-1] * width, liu["ref_enc_gru_size"])

    def forward(self, mels, mel_mask):
        out = mels.float()[:, None]                        # [B, 1, T, mel]
        for conv, bn in zip(self.convs, self.bns):
            out = torch.relu(bn(conv(out)))
        B, C, T, W = out.shape
        # (C, W) order, as the reference's transpose(1, 2).view(N, T, C·W)
        out = out.transpose(1, 2).reshape(B, T, C * W)
        lengths = None
        if mel_mask is not None:
            out = out.masked_fill(mel_mask[..., None], 0.0)
            lengths = (~mel_mask).sum(dim=1)
        return self.gru(out, lengths)


class StyleEmbedAttention(nn.Module):
    """One-head attention of a query over the style tokens."""

    def __init__(self, query_dim, key_dim, num_units):
        super().__init__()
        self.key_dim = key_dim
        self.W_query = nn.Linear(query_dim, num_units, bias=False)
        self.W_key = nn.Linear(key_dim, num_units, bias=False)
        self.W_value = nn.Linear(key_dim, num_units, bias=False)

    def forward(self, query, key_soft):
        q = self.W_query(query)                            # [B, 1, U]
        k = self.W_key(key_soft)                           # [B, Tk, U]
        v = self.W_value(key_soft)
        scores = torch.softmax(q @ k.transpose(1, 2) / self.key_dim ** 0.5,
                               dim=-1)
        return scores @ v                                  # [B, 1, U]


class STL(nn.Module):
    """Style-token layer: ``token_num`` tanh-squashed embeddings."""

    def __init__(self, model_config):
        super().__init__()
        E = block_hidden(model_config)[0]
        n = model_config["prosody_modeling"]["liu2021"]["token_num"]
        self.embed = nn.Parameter(torch.randn(n, E) * 0.5)
        self.attention = StyleEmbedAttention(E // 2, E, E)

    def forward(self, inputs):
        keys = torch.tanh(self.embed)[None].expand(inputs.shape[0], -1, -1)
        return self.attention(inputs[:, None, :], keys)    # [B, 1, E]


class UtteranceLevelProsodyEncoder(nn.Module):
    def __init__(self, preprocess_config, model_config):
        super().__init__()
        liu = model_config["prosody_modeling"]["liu2021"]
        E = block_hidden(model_config)[0]
        self.encoder = ReferenceEncoder(preprocess_config, model_config)
        self.encoder_prj = nn.Linear(liu["ref_enc_gru_size"], E // 2)
        self.stl = STL(model_config)
        self.encoder_bottleneck = nn.Linear(E, liu["bottleneck_size_u"])
        self.dropout = Dropout(liu["ref_attention_dropout"])

    def forward(self, mels, mel_mask):
        _, final = self.encoder(mels, mel_mask)
        x = self.stl(self.encoder_prj(final))
        return self.dropout(self.encoder_bottleneck(x))    # [B, 1, u]


class PhonemeLevelProsodyEncoder(nn.Module):
    def __init__(self, preprocess_config, model_config):
        super().__init__()
        liu = model_config["prosody_modeling"]["liu2021"]
        E = block_hidden(model_config)[0]
        self.E = E
        self.encoder = ReferenceEncoder(preprocess_config, model_config)
        self.encoder_prj = nn.Linear(liu["ref_enc_gru_size"], 2 * E)
        self.linears = nn.ModuleList(
            LinearNorm(E, E, bias=False) for _ in range(2))
        self.encoder_bottleneck = nn.Linear(E, liu["bottleneck_size_p"])
        self.dropout = Dropout(liu["ref_attention_dropout"])

    def forward(self, x, src_mask, mels, mel_mask):
        """Returns (embeddings [B, T_s, p], attention [B, T_s, T_m]): −inf
        at mel padding before the softmax, 0 at text padding after it."""
        memory, _ = self.encoder(mels, mel_mask)
        k, v = self.encoder_prj(memory).split(self.E, dim=-1)
        q = self.linears[0](x.float())
        k = self.linears[1](k)
        attn = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(self.E)
        attn = attn.masked_fill(mel_mask[:, None, :], float("-inf"))
        attn = self.dropout(torch.softmax(attn, dim=-1))
        attn = attn.masked_fill(src_mask[:, :, None], 0.0)
        out = self.encoder_bottleneck(torch.matmul(attn, v))
        return out.masked_fill(src_mask[..., None], 0.0), attn


class ParallelProsodyPredictor(nn.Module):
    """Two (conv, ReLU, LayerNorm, dropout) → BiGRU → bottleneck; one vector
    a phone, or one an utterance ([forward last, backward first])."""

    def __init__(self, model_config, phoneme_level=True):
        super().__init__()
        liu = model_config["prosody_modeling"]["liu2021"]
        E = block_hidden(model_config)[0]
        k, drop = liu["predictor_kernel_size"], liu["predictor_dropout"]
        self.phoneme_level = phoneme_level
        layers = []
        for i in (1, 2):
            layers += [(f"conv1d_{i}", ConvNorm(E, E, k)),
                       (f"relu_{i}", nn.ReLU()),
                       (f"layer_norm_{i}", LayerNorm(E, eps=1e-6)),
                       (f"dropout_{i}", Dropout(drop))]
        self.conv_layer = nn.Sequential(collections.OrderedDict(layers))
        self.gru = GRU(E, E // 2, bidirectional=True)
        self.predictor_bottleneck = nn.Linear(
            E, liu["bottleneck_size_p"] if phoneme_level
            else liu["bottleneck_size_u"])

    def forward(self, x):
        memory, final = self.gru(self.conv_layer(x.float()))
        vec = memory if self.phoneme_level else final[:, None, :]
        return self.predictor_bottleneck(vec)


class NonParallelProsodyPredictor(nn.Module):
    """The reference's autoregressive alternative to the parallel predictor
    (no model instantiates it): two masked conv blocks, the GRU cell on
    [x_t, h], the bottleneck over each phone or the time mean."""

    def __init__(self, model_config, phoneme_level=True):
        super().__init__()
        liu = model_config["prosody_modeling"]["liu2021"]
        E = block_hidden(model_config)[0]
        ks = liu["predictor_kernel_size"]
        ks = ks if isinstance(ks, (list, tuple)) else (ks, ks)
        self.phoneme_level = phoneme_level
        self.conv_stack = nn.ModuleList(
            ConvBlock(E, E, k, liu["predictor_dropout"]) for k in ks[:2])
        self.gru_cell = nn.GRUCell(3 * E, 2 * E)
        self.predictor_bottleneck = nn.Linear(
            2 * E, liu["bottleneck_size_p"] if phoneme_level
            else liu["bottleneck_size_u"])

    def forward(self, x, src_mask=None):
        mask = (src_mask if src_mask is not None
                else torch.zeros(x.shape[:2], dtype=torch.bool,
                                 device=x.device))
        x = x.float()
        for block in self.conv_stack:
            x = block(x, mask)
        out = ar_gru(self.gru_cell, x)
        if src_mask is not None:
            out = out.masked_fill(src_mask[..., None], 0.0)
        vec = out if self.phoneme_level else out.mean(dim=1, keepdim=True)
        return self.predictor_bottleneck(vec)


def liu_prosody_modules(preprocess_config, model_config):
    """The liu2021 modules by their upstream names (upstream hangs them on
    the variance adaptor itself)."""
    E = block_hidden(model_config)[0]
    liu = model_config["prosody_modeling"]["liu2021"]
    pc, mc = preprocess_config, model_config
    return {
        "utterance_prosody_encoder": UtteranceLevelProsodyEncoder(pc, mc),
        "phoneme_prosody_encoder": PhonemeLevelProsodyEncoder(pc, mc),
        "utterance_prosody_predictor": ParallelProsodyPredictor(
            mc, phoneme_level=False),
        "phoneme_prosody_predictor": ParallelProsodyPredictor(
            mc, phoneme_level=True),
        "utterance_prosody_prj": nn.Linear(liu["bottleneck_size_u"], E),
        "phoneme_prosody_prj": nn.Linear(liu["bottleneck_size_p"], E),
    }


def liu_prosody(mods, x, src_mask, mel, mel_mask, training):
    """x [B, T_s, E] plus the utterance prosody, then plus the phone
    prosody: the encoders' targets when ``training`` (the mode), else the
    predictors' vectors. ``mods`` holds the modules of
    :func:`liu_prosody_modules` as attributes (the variance adaptor, or an
    ``nn.ModuleDict`` of them). Returns (x, (up_tgt,
    pp_tgt, up_vec, pp_vec, pp_attn)); the targets are None at inference."""
    up_tgt = pp_tgt = pp_attn = None
    x = x.float()
    if training:
        up_tgt = mods.utterance_prosody_encoder(mel, mel_mask)
        pp_tgt, pp_attn = mods.phoneme_prosody_encoder(x, src_mask, mel,
                                                       mel_mask)
    up_vec = mods.utterance_prosody_predictor(x)
    x = x + mods.utterance_prosody_prj(up_tgt if training else up_vec)
    pp_vec = mods.phoneme_prosody_predictor(x)
    x = x + mods.phoneme_prosody_prj(pp_tgt if training else pp_vec)
    return x, (up_tgt, pp_tgt, up_vec, pp_vec, pp_attn)
