"""The head widths the attention kernels take, and the zero-padding to them.

Each attention kernel of ``csrc/`` is built for a few head widths d (its
instances). A wrapper runs any other d up to the largest instance at the
next instance's width: it pads q, k and v (and, for relpos, the position
projection and the u/v biases) with zero columns, takes the softmax scale
from the true d, and trims the output back to d; autograd trims the
gradients. This is exact: a zero column adds an exact zero to every dot
product and gives an output column of zeros, which the trim drops. A width
that has an instance is never padded, and the kernel runs either way (its
launch counter says so). Past the largest instance a wrapper raises, naming
the remainder of fault F1 in ROADMAP.md §3.
"""

import torch.nn.functional as F


def instance_width(d, widths, what):
    """The narrowest of ``widths`` (ascending) that holds d; raises past the
    widest."""
    for w in widths:
        if d <= w:
            return w
    raise ValueError(f"{what} kernels take head widths up to {widths[-1]}, "
                     f"got {d} (see ROADMAP.md §3 F1)")


def pad_heads(t, width):
    """``t`` with zero columns appended on its last axis up to ``width``."""
    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))
