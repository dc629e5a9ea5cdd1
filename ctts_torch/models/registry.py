"""block_type → (TextEncoder, Decoder) (ctts_tpu/models/registry.py).

All six block types are ported; each module's TextEncoder returns
(hidden, token embeddings) and its Decoder (hidden, mask).
"""

import importlib

_BLOCKS = {"transformer_fs2": "ctts_torch.models.transformer_fs2",
           "transformer": "ctts_torch.models.transformer",
           "fastformer": "ctts_torch.models.fastformer",
           "lstransformer": "ctts_torch.models.lstransformer",
           "conformer": "ctts_torch.models.conformer",
           "reformer": "ctts_torch.models.reformer"}


def get_block(block_type):
    if block_type not in _BLOCKS:
        raise NotImplementedError(
            f"unknown block_type {block_type!r}; choose from {sorted(_BLOCKS)}")
    mod = importlib.import_module(_BLOCKS[block_type])
    return mod.TextEncoder, mod.Decoder


def block_hidden(model_config):
    """encoder/decoder hidden size for the selected block; a section
    without them (the reformer's), or no section (fastformer,
    lstransformer), takes the ``transformer`` section's."""
    bt = model_config["block_type"]
    cfg = model_config[bt if bt in model_config else "transformer"]
    if "encoder_hidden" in cfg:
        return cfg["encoder_hidden"], cfg["decoder_hidden"]
    t = model_config["transformer"]
    return t["encoder_hidden"], t["decoder_hidden"]
