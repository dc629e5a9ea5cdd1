"""Unsupervised alignment encoder (ctts_tpu/models/aligner.py; "One TTS
Alignment To Rule Them All").

Text embeddings and mel frames are projected by small conv stacks into one
space; the attention logit is -T·‖q−k‖², expanded to
-T·(|q|² + |k|² − 2 q·k) so the cross term is one batched matmul. A
multi-speaker aligner first adds bias-free projections of the speaker
vector to the text embeddings (``key_spk_proj``) and to every mel frame
(``query_spk_proj``). Parameter paths are upstream's:
``key_proj.{0,2}.conv``, ``query_proj.{0,2,4}.conv`` and
``{key,query}_spk_proj.linear``.
"""

import torch
from torch import nn

from ctts_torch.models.blocks import ConvNorm
from ctts_torch.models.conformer import LinearNorm


class AlignmentEncoder(nn.Module):
    def __init__(self, n_mel_channels, n_att_channels, n_text_channels,
                 temperature, multi_speaker=False):
        super().__init__()
        self.temperature = temperature
        if multi_speaker:
            self.key_spk_proj = LinearNorm(n_text_channels, n_text_channels,
                                           bias=False)
            self.query_spk_proj = LinearNorm(n_text_channels, n_mel_channels,
                                             bias=False)
        self.key_proj = nn.Sequential(
            ConvNorm(n_text_channels, n_text_channels * 2, 3), nn.ReLU(),
            ConvNorm(n_text_channels * 2, n_att_channels, 1))
        self.query_proj = nn.Sequential(
            ConvNorm(n_mel_channels, n_mel_channels * 2, 3), nn.ReLU(),
            ConvNorm(n_mel_channels * 2, n_mel_channels, 1), nn.ReLU(),
            ConvNorm(n_mel_channels, n_att_channels, 1))

    def forward(self, mels, text_emb, src_padding_mask, attn_prior=None,
                speaker_embed=None):
        """mels [B, T_m, n_mel]; text_emb [B, T_s, C_text]; src_padding_mask
        [B, T_s] True at padding; attn_prior [B, T_m, T_s] or None;
        speaker_embed [B, C_text] or None. Returns (attn_soft,
        attn_logprob), both [B, T_m, T_s] float32."""
        if speaker_embed is not None:
            text_emb = text_emb + self.key_spk_proj(speaker_embed)[:, None]
            mels = mels + self.query_spk_proj(speaker_embed)[:, None]
        keys = self.key_proj(text_emb).float()             # [B, T_s, C_att]
        q = self.query_proj(mels).float()                  # [B, T_m, C_att]
        q_sq = torch.sum(q * q, dim=-1)
        k_sq = torch.sum(keys * keys, dim=-1)
        cross = torch.einsum("bmc,bsc->bms", q, keys)
        dist = q_sq[:, :, None] + k_sq[:, None, :] - 2.0 * cross
        attn = -self.temperature * dist
        if attn_prior is not None:
            # the log-softmax runs over all T_s columns, padded ones too, and
            # the prior is zero-padded: both as in the reference
            attn = (torch.log_softmax(attn, dim=-1)
                    + torch.log(attn_prior + 1e-8))
        attn_logprob = attn
        attn = attn.masked_fill(src_padding_mask[:, None, :], float("-inf"))
        return torch.softmax(attn, dim=-1), attn_logprob
