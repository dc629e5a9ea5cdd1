"""Training logs (ctts_tpu/utils/logging.py): per-split ``log.txt`` and a
JSON-lines ``log.jsonl`` of scalars, ``preview.jsonl`` of what each
synth preview did, and TensorBoard scalars, figures and audio where
``torch.utils.tensorboard`` imports; the mel and alignment plots of the
previews (matplotlib, imported when a plot is drawn)."""

import json
import os
import time


class Logger:
    def __init__(self, log_path, split):
        self.dir = os.path.join(log_path, split)
        os.makedirs(self.dir, exist_ok=True)
        self.txt = open(os.path.join(self.dir, "log.txt"), "a")
        self.jsonl = open(os.path.join(self.dir, "log.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:               # tensorboard is not installed
            self.tb = None
        else:
            self.tb = SummaryWriter(self.dir)

    def scalars(self, step, losses, lr=None, **extra):
        """One record: the loss components (floats), the rate, and any
        further JSON-serializable fields (written to the JSON line only)."""
        if self.tb:
            for k, v in losses.items():
                self.tb.add_scalar(f"Loss/{k}_loss", float(v), step)
            if lr is not None:
                self.tb.add_scalar("Training/learning_rate", float(lr), step)
        rec = {"step": int(step), "t": time.time(),
               **{k: float(v) for k, v in losses.items()}}
        if lr is not None:
            rec["lr"] = float(lr)
        rec.update(extra)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        msg = ", ".join(f"{k}: {float(v):.4f}" for k, v in losses.items())
        self.txt.write(f"Step {step}, {msg}\n")
        self.txt.flush()

    def preview(self, step, **fields):
        """One preview's record: whether it ran, or why it was skipped,
        and what it produced (JSON line in ``preview.jsonl``, a text line
        in ``log.txt``)."""
        rec = {"step": int(step), "t": time.time(), **fields}
        with open(os.path.join(self.dir, "preview.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.txt.write(f"Step {step}, preview: " + ", ".join(
            f"{k}: {v}" for k, v in fields.items()) + "\n")
        self.txt.flush()

    def figure(self, tag, fig, step):
        if self.tb:
            self.tb.add_figure(tag, fig, step)

    def audio(self, tag, wav, step, sampling_rate=22050):
        if self.tb:
            peak = max(abs(wav.max()), abs(wav.min()), 1e-5)
            self.tb.add_audio(tag, wav / peak, step,
                              sample_rate=sampling_rate)

    def close(self):
        self.txt.close()
        self.jsonl.close()
        if self.tb:
            self.tb.close()


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported when a plot is
    drawn."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def plot_mel(data, titles=None):
    """Stacked mel/feature panels (reference utils/tools.py:364-...)."""
    plt = pyplot()
    fig, axes = plt.subplots(len(data), 1, squeeze=False,
                             figsize=(8, 2.2 * len(data)))
    titles = titles or [None] * len(data)
    for i, mel in enumerate(data):
        axes[i][0].imshow(mel, origin="lower", aspect="auto")
        axes[i][0].set_ylim(0, mel.shape[0])
        if titles[i] is not None:
            axes[i][0].set_title(titles[i], fontsize="medium")
        axes[i][0].tick_params(labelsize="x-small")
    plt.tight_layout()
    return fig


def plot_alignment(attn_maps, titles=None):
    """Alignment maps side by side."""
    plt = pyplot()
    fig, axes = plt.subplots(1, len(attn_maps), squeeze=False,
                             figsize=(4 * len(attn_maps), 4))
    titles = titles or [None] * len(attn_maps)
    for i, a in enumerate(attn_maps):
        axes[0][i].imshow(a, origin="lower", aspect="auto")
        if titles[i] is not None:
            axes[0][i].set_title(titles[i], fontsize="medium")
    plt.tight_layout()
    return fig
