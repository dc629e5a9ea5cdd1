"""`reformer` block (ctts_tpu/models/reformer.py).

Each of ``depth`` layers runs shared-QK attention (4 local heads on windows
of 2·bucket, ``ops.local_window_attention.local_window_attention``; the
rest LSH heads, :func:`lsh_attention`) and an exact-GELU FF ×4 on a
two-stream residual, x1 += attn(LN_f(x2)), x2 += ff(LN_g(x1)), and returns
(x1 + x2) / 2. The attention and the FF are one module each, tied across
depth, so their gradients sum over the layers; every layer keeps its own two
LayerNorms (flax's eps 1e-6). Sequences are padded to a multiple of
2·bucket and sliced back. Attention is causal on both sides, as upstream.

LSH attention hashes each head's qk by argmax([r, -r]) of random rotations
r, stable-sorts the positions by (bucket, position) per round, attends
within chunks of ``bucket`` sorted rows and the chunk before, un-sorts and
combines the rounds by their logsumexp. By default the sorted rows are
gathered with ``sort_gather.gather_rows`` (the CUDA gather on the card) and
attended by the plain ``chunk_core``; under ``CTTS_FUSED_LSH=1`` the fused
chunk kernels (``ops/lsh_chunk_attention.py``) take both steps. The un-sort
is ``sort_gather.scatter_rows`` on both routes. The core computes in
float32 on both routes (the JAX package's jnp path keeps the compute dtype).

Rotations: one draw per stack forward for all layers, [depth, 1, dim_head,
n_hashes, n_buckets/2], from the module's ``generator`` in training (the
train state's, which dropout uses too and checkpoints keep) and from a
generator seeded 0 on the host at inference, so an inference forward is
deterministic and hashes alike on every device. The draws cannot equal the
JAX package's; ``lsh_rot`` gives every layer the same rotations, as the JAX
argument does.

Parameter paths are the upstream ones that
``ctts_tpu/utils/torch_import.py:_reformer_stack`` reads:
``layer_stack.net.layers.irrev_blocks.{i}.{f.fn,f.norm,g.fn.fn,g.norm}``;
the tied modules appear under every ``i``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ctts_torch.models.blocks import (Dropout, LayerNorm, Linear, dtype_of,
                                      interleaved_sinusoid_table)
from ctts_torch.ops.local_window_attention import local_window_attention
from ctts_torch.ops.lsh_chunk_attention import (chunk_attention, chunk_core,
                                                supported)
from ctts_torch.ops.sort_gather import gather_rows, scatter_rows
from ctts_torch.text.symbols import symbols

EPS = 1e-6


def lsh_sort(qk, valid, rot, bucket_size, n_hashes):
    """Hash and sort: qk [G, N, d], valid [G, N] bool, rot [1, d, n_hashes,
    n_buckets/2]. Returns int32 [G, n_hashes·N] tensors: the sorted order
    ``sticker`` (round·N + position), the positions ``st`` and their
    validity ``svalid``. The keys N·bucket + position are distinct, so the
    stable sort is the JAX package's 3-operand sort."""
    G, N, _ = qk.shape
    n_buckets = N // bucket_size
    rotated = torch.einsum("btf,fhi->bhti", qk, rot[0].to(qk.dtype))
    buckets = torch.cat([rotated, -rotated], dim=-1).argmax(dim=-1)
    buckets = buckets + (torch.arange(n_hashes, device=qk.device)
                         * n_buckets)[None, :, None]
    ticker = torch.arange(n_hashes * N, device=qk.device)
    keys = N * buckets.reshape(G, n_hashes * N) + ticker % N
    sticker = torch.sort(keys, dim=-1, stable=True).indices
    svalid = valid.to(torch.int32).repeat(1, n_hashes).gather(1, sticker)
    return (sticker.to(torch.int32), (sticker % N).to(torch.int32),
            svalid.contiguous())


def lsh_attention(qk, v, valid, rot, bucket_size=64, n_hashes=4,
                  causal=True):
    """Shared-QK LSH attention: qk, v [G, N, d] with N a multiple of
    2·bucket_size, valid [G, N] bool. Returns [G, N, d] in qk's dtype."""
    G, N, d = qk.shape
    sticker, st, svalid = lsh_sort(qk, valid, rot, bucket_size, n_hashes)
    scale = d ** -0.5
    if supported():
        out = chunk_attention(qk, v, st, svalid, bucket_size, causal, scale)
    else:
        rows = gather_rows(torch.cat([qk, v], dim=-1), st)
        out = chunk_core(rows[..., :d], rows[..., d:], st, svalid,
                         bucket_size, causal, scale)
    unsorted = scatter_rows(out, sticker, n_hashes * N)
    o = unsorted[..., :d].reshape(G, n_hashes, N, d)
    logits = unsorted[..., d:].reshape(G, n_hashes, N, 1)
    w = torch.exp(logits - torch.logsumexp(logits, dim=1, keepdim=True))
    return (o * w).sum(1).to(qk.dtype)


class LSHSelfAttention(nn.Module):
    """Shared QK and one value projection for ``heads`` heads: the first
    ``n_local_attn_heads`` local, the rest LSH; ``to_out`` has a bias.

    Tensor parallel (the mesh's rules): a rank keeps a contiguous range of the
    heads in ``toqk`` and ``tov`` (output rows) and ``to_out`` (input
    columns), and runs each of its heads as the kind its global index
    gives: with 4 local heads of 8 over two ranks, rank 0 runs the window
    kernels alone and rank 1 the LSH route alone."""

    tp = None

    def __init__(self, dim, heads, dim_head, bucket_size, n_hashes,
                 n_local_attn_heads, dropout, dtype):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.bucket_size, self.n_hashes = bucket_size, n_hashes
        self.n_local = n_local_attn_heads
        self.toqk = Linear(dim, inner, bias=False, dtype=dtype)
        self.tov = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_out = Linear(inner, dim, dtype=dtype)
        self.dropout = Dropout(dropout)

    def tp_units(self):
        return self.heads

    def forward(self, x, valid, rot):
        B, N, _ = x.shape
        h, lh, dh = self.heads, self.n_local, self.dim_head
        if self.tp is not None:
            lo, hi = self.tp.bounds(h)
            h, lh = hi - lo, min(max(lh - lo, 0), hi - lo)

        def heads_of(t, lo, hi):            # [B, N, h·dh] → [B·n, N, dh]
            t = t.reshape(B, N, h, dh)[:, :, lo:hi].transpose(1, 2)
            return t.reshape(B * (hi - lo), N, dh).contiguous()

        qk, v = self.toqk(x), self.tov(x)
        outs = []
        if lh > 0:
            loc = local_window_attention(
                heads_of(qk, 0, lh), heads_of(v, 0, lh),
                valid.repeat_interleave(lh, dim=0), 2 * self.bucket_size,
                dh ** -0.5)
            outs.append(loc.reshape(B, lh, N, dh))
        if h > lh:
            lsh = lsh_attention(heads_of(qk, lh, h), heads_of(v, lh, h),
                                valid.repeat_interleave(h - lh, dim=0), rot,
                                self.bucket_size, self.n_hashes)
            outs.append(lsh.reshape(B, h - lh, N, dh))
        out = torch.cat(outs, dim=1).transpose(1, 2).reshape(B, N, h * dh)
        return self.dropout(self.to_out(out))


class FeedForward(nn.Module):
    """w1 (×4) → exact GELU → dropout → w2. Tensor parallel (the mesh's
    rules): ``w1``'s output and ``w2``'s input channels."""

    def __init__(self, dim, dropout, dtype, mult=4):
        super().__init__()
        self.w1 = Linear(dim, dim * mult, dtype=dtype)
        self.w2 = Linear(dim * mult, dim, dtype=dtype)
        self.dropout = Dropout(dropout)

    def tp_units(self):
        return self.w1.out_features

    def shard_(self, tp):
        self.dropout.shard = (-1, tp)

    def forward(self, x):
        return self.w2(self.dropout(F.gelu(self.w1(x))))


class Chunk(nn.Module):
    """Upstream's time-chunking wrapper of the FF (at ``.fn``); the FF runs
    whole here, as in the JAX package."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class PreNorm(nn.Module):
    def __init__(self, dim, fn, dtype):
        super().__init__()
        self.norm = LayerNorm(dim, eps=EPS, dtype=dtype)
        self.fn = fn


class IrreversibleBlock(nn.Module):
    def __init__(self, f, g):
        super().__init__()
        self.f, self.g = f, g


class _Blocks(nn.Module):
    """Upstream's ReversibleSequence: the layers at ``irrev_blocks``."""

    def __init__(self, blocks):
        super().__init__()
        self.irrev_blocks = nn.ModuleList(blocks)


class Reformer(nn.Module):
    """The two-stream stack with the attention and the FF tied across
    depth. ``generator`` is the source of the rotations in training (set
    with the dropout generators by ``set_dropout_generator``: the shared
    one, as every rank of a grid draws the same rotations)."""

    shared_draws = True

    def __init__(self, dim, depth, heads, dim_head, bucket_size, n_hashes,
                 n_local_attn_heads, dropout, dtype):
        super().__init__()
        self.depth, self.dim_head = depth, dim_head
        self.bucket_size, self.n_hashes = bucket_size, n_hashes
        attn = LSHSelfAttention(dim, heads, dim_head, bucket_size, n_hashes,
                                n_local_attn_heads, dropout, dtype)
        ff = Chunk(FeedForward(dim, dropout, dtype))
        self.layers = _Blocks([
            IrreversibleBlock(PreNorm(dim, attn, dtype),
                              PreNorm(dim, ff, dtype)) for _ in range(depth)])
        self.generator = None

    def rotations(self, n, device):
        """Every layer's hash rotations for sequences of n (padded)
        positions: [depth, 1, dim_head, n_hashes, n_buckets/2] float32. In
        training from ``generator`` on the device; at inference from seed 0
        on the host, so every device hashes alike."""
        shape = (self.depth, 1, self.dim_head, self.n_hashes,
                 n // self.bucket_size // 2)
        if self.training:
            return _normal(shape, self.generator, device)
        return _normal(shape, torch.Generator().manual_seed(0),
                       "cpu").to(device)

    def forward(self, x, valid, lsh_rot=None):
        if lsh_rot is None:
            rots = self.rotations(x.shape[1], x.device)
        else:
            rots = [lsh_rot] * self.depth
        x1 = x2 = x
        for blk, rot in zip(self.layers.irrev_blocks, rots):
            y1 = x1 + blk.f.fn(blk.f.norm(x2), valid, rot)
            y2 = x2 + blk.g.fn(blk.g.norm(y1))
            x1, x2 = y1, y2
        return (x1 + x2) * 0.5


def _normal(shape, generator, device):
    """The rotations' draw (a function of its own so that a test can stand
    another draw in for it)."""
    return torch.randn(shape, generator=generator, device=device)


class _Stack(nn.Module):
    """Upstream's Autopadder: pads the sequence (and its validity) to a
    multiple of 2·bucket, runs the stack at ``.net`` in the config's dtype
    and returns the unpadded float32 result."""

    def __init__(self, model_config, side):
        super().__init__()
        tcfg, rcfg = model_config["transformer"], model_config["reformer"]
        self.dtype = dtype_of(model_config)
        self.bucket = rcfg.get("bucket_size", 64)
        heads = rcfg[f"{side}_head"]
        self.net = Reformer(
            tcfg[f"{side}_hidden"], rcfg["depth"], heads,
            tcfg[f"{side}_hidden"] // tcfg[f"{side}_head"], self.bucket,
            rcfg.get("n_hashes", 4),
            min(rcfg.get("n_local_attn_heads", 4), max(heads - 1, 0)),
            tcfg[f"{side}_dropout"], self.dtype)

    def forward(self, x, padding_mask, lsh_rot=None):
        n = x.shape[1]
        pad = (-n) % (2 * self.bucket)
        valid = F.pad(~padding_mask, (0, pad))
        x = F.pad(x, (0, 0, 0, pad)).to(self.dtype)
        return self.net(x, valid, lsh_rot)[:, :n].float()


class TextEncoder(nn.Module):
    """Token embedding (the padding row trained, as in JAX) plus the
    interleaved sinusoid table → reformer stack. Returns (hidden, token
    embeddings), both float32."""

    def __init__(self, model_config):
        super().__init__()
        self.d_model = model_config["transformer"]["encoder_hidden"]
        self.max_seq_len = model_config["max_seq_len"]
        self.src_word_emb = nn.Embedding(len(symbols) + 1, self.d_model)
        self.layer_stack = _Stack(model_config, "encoder")

    def forward(self, txt_tokens, padding_mask, lsh_rot=None):
        T = txt_tokens.shape[1]
        emb = F.embedding(txt_tokens, self.src_word_emb.weight)
        table = interleaved_sinusoid_table(max(self.max_seq_len + 1, T),
                                           self.d_model)[None, :T]
        x = emb + table.to(emb.device)
        return self.layer_stack(x, padding_mask, lsh_rot), emb


class Decoder(nn.Module):
    def __init__(self, model_config):
        super().__init__()
        self.d_model = model_config["transformer"]["decoder_hidden"]
        self.max_seq_len = model_config["max_seq_len"]
        self.layer_stack = _Stack(model_config, "decoder")

    def forward(self, x, padding_mask, lsh_rot=None):
        T = x.shape[1]
        table = interleaved_sinusoid_table(max(self.max_seq_len + 1, T),
                                           self.d_model)[None, :T]
        return (self.layer_stack(x + table.to(x.device), padding_mask,
                                 lsh_rot), padding_mask)
