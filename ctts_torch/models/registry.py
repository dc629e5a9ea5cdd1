"""block_type → (TextEncoder, Decoder) (ctts_tpu/models/registry.py).

``transformer_fs2`` (the shipped default), ``conformer`` and ``reformer``
are ported; the other block types raise and name the ROADMAP item that
ports them.
"""

import importlib

_BLOCKS = {"transformer_fs2": "ctts_torch.models.transformer_fs2",
           "conformer": "ctts_torch.models.conformer",
           "reformer": "ctts_torch.models.reformer"}
_NOT_YET = ("transformer", "fastformer", "lstransformer")


def get_block(block_type):
    if block_type in _NOT_YET:
        raise NotImplementedError(
            f"block_type {block_type!r} is not ported to ctts_torch yet "
            "(ROADMAP.md §1 item 5, 'The rest of the block zoo')")
    if block_type not in _BLOCKS:
        raise NotImplementedError(
            f"unknown block_type {block_type!r}; choose from "
            f"{sorted(_BLOCKS) + list(_NOT_YET)}")
    mod = importlib.import_module(_BLOCKS[block_type])
    return mod.TextEncoder, mod.Decoder


def block_hidden(model_config):
    """encoder/decoder hidden size for the selected block; a section
    without them (the reformer's) takes the ``transformer`` section's."""
    bt = model_config["block_type"]
    cfg = model_config[bt if bt in model_config else "transformer"]
    if "encoder_hidden" in cfg:
        return cfg["encoder_hidden"], cfg["decoder_hidden"]
    t = model_config["transformer"]
    return t["encoder_hidden"], t["decoder_hidden"]
