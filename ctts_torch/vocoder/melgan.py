"""MelGAN generator (descript melgan-neurips; ctts_tpu/vocoder/melgan.py),
under the upstream parameter names.

One ``nn.Sequential`` ``model`` as upstream: reflection pad + conv7 →
4 × [leaky_relu(0.2), transposed conv (k = 2r, stride r), 3 residual blocks
with dilations 1, 3, 9] → leaky_relu(0.2), reflection pad + conv7 → tanh,
ratios (8, 8, 2, 2) for 256× upsampling. Weight norm is folded, so the
state_dict keys are upstream's without ``weight_g``/``weight_v``
(``model.1.weight``, ``model.4.block.2.weight``, ``model.4.shortcut.bias``,
...). MelGAN takes log10 mels: the caller divides natural-log mels by ln 10
(:func:`ctts_torch.utils.model.vocoder_infer`). The JAX package's
``CTTS_SUBPIX`` (a subpixel form of the transposed conv, an XLA lowering
choice) computes the same function as ``conv_transpose1d`` and has no
counterpart here.
"""

import re

import torch
from torch import nn

LRELU = 0.2


class ResnetBlock(nn.Module):
    def __init__(self, dim, dilation):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(LRELU), nn.ReflectionPad1d(dilation),
            nn.Conv1d(dim, dim, 3, dilation=dilation), nn.LeakyReLU(LRELU),
            nn.Conv1d(dim, dim, 1))
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class MelGANGenerator(nn.Module):
    def __init__(self, ratios=(8, 8, 2, 2), ngf=32, n_residual_layers=3,
                 n_mel=80, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        mult = 2 ** len(ratios)
        layers = [nn.ReflectionPad1d(3), nn.Conv1d(n_mel, mult * ngf, 7)]
        for r in ratios:
            layers += [nn.LeakyReLU(LRELU),
                       nn.ConvTranspose1d(mult * ngf, mult * ngf // 2, 2 * r,
                                          stride=r, padding=r // 2 + r % 2,
                                          output_padding=r % 2)]
            layers += [ResnetBlock(mult * ngf // 2, 3 ** j)
                       for j in range(n_residual_layers)]
            mult //= 2
        layers += [nn.LeakyReLU(LRELU), nn.ReflectionPad1d(3),
                   nn.Conv1d(ngf, 1, 7)]
        self.model = nn.Sequential(*layers)

    def forward(self, mel):
        """mel: [B, T, n_mel] (log10) → wav [B, T·256] float32."""
        with torch.autocast(mel.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            x = self.model(mel.transpose(1, 2))
        return torch.tanh(x.float())[:, 0, :]


def _layout(model):
    """The Sequential indices of the port's generator: (conv_in, [ups],
    [[resblocks] per up], conv_out)."""
    convs = [i for i, m in enumerate(model)
             if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))]
    res = [i for i, m in enumerate(model) if isinstance(m, ResnetBlock)]
    ups = convs[1:-1]
    groups = [[r for r in res if up < r < nxt]
              for up, nxt in zip(ups, ups[1:] + [convs[-1]])]
    return convs[0], ups, groups, convs[-1]


def load_melgan(path, ratios=(8, 8, 2, 2), n_residual_layers=3,
                map_location="cpu"):
    """A descript melgan-neurips generator checkpoint → a state_dict for
    :class:`MelGANGenerator` (ctts_tpu/vocoder/melgan.py:load_torch_melgan).

    The upstream Sequential's indices are recovered from the keys (residual
    blocks are the indices with ``.block.`` children; the other
    weight-bearing indices are conv_in, the upsamplers and conv_out, in
    order), so a revision that shifts padding or activation slots still
    loads; weight norm is folded. A layout that does not fit raises with
    the keys found."""
    sd = torch.load(path, map_location=map_location, weights_only=True)
    if isinstance(sd, dict) and not any(torch.is_tensor(v)
                                        for v in sd.values()):
        sd = sd.get("model", sd.get("state_dict", sd))
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}

    def fail(msg):
        sample = "\n  ".join(sorted(sd)[:14])
        raise ValueError(
            f"melgan import: {msg}\nThis importer expects the descript "
            f"melgan-neurips generator layout. First checkpoint keys:\n  "
            f"{sample}\n({len(sd)} keys total)")

    def get(key):
        if key not in sd:
            fail(f"missing key {key!r}")
        return sd[key]

    def fold(prefix):
        if f"{prefix}.weight" in sd:
            return sd[f"{prefix}.weight"]
        g, v = get(f"{prefix}.weight_g"), get(f"{prefix}.weight_v")
        return g * v / v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()

    weighted = sorted({int(m.group(1)) for k in sd
                       if (m := re.match(r"^(\d+)\.(weight|weight_g)$", k))})
    res_idx = sorted({int(m.group(1)) for k in sd
                      if (m := re.match(r"^(\d+)\.block\.", k))})
    if len(weighted) < 3:
        fail(f"found only {len(weighted)} plain conv indices {weighted}")
    up_is = weighted[1:-1]
    if len(up_is) != len(ratios):
        fail(f"found {len(up_is)} upsample convs at indices {up_is} but "
             f"{len(ratios)} ratios {tuple(ratios)} were requested")
    groups = [[r for r in res_idx if up < r < nxt]
              for up, nxt in zip(up_is, up_is[1:] + [weighted[-1]])]
    if any(len(g) != n_residual_layers for g in groups):
        fail(f"residual blocks per stage {[len(g) for g in groups]} != "
             f"n_residual_layers={n_residual_layers}")

    conv_in, ups, mine, conv_out = _layout(
        MelGANGenerator(ratios, 1, n_residual_layers, 1).model)
    out = {}

    def put(dst, src):
        out[f"model.{dst}.weight"] = fold(src)
        out[f"model.{dst}.bias"] = get(f"{src}.bias")

    put(conv_in, str(weighted[0]))
    put(conv_out, str(weighted[-1]))
    for up, src_up, group, src_group in zip(ups, up_is, mine, groups):
        put(up, str(src_up))
        for dst, src in zip(group, src_group):
            for name in ("block.2", "block.4", "shortcut"):
                put(f"{dst}.{name}", f"{src}.{name}")
    return out
