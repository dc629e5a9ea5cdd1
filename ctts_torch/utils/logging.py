"""Training logs (ctts_tpu/utils/logging.py): per-split ``log.txt`` and a
JSON-lines ``log.jsonl`` of scalars, and TensorBoard scalars where
``torch.utils.tensorboard`` imports. The figure and audio previews of the
JAX logger wait with the synth previews."""

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

    def close(self):
        self.txt.close()
        self.jsonl.close()
        if self.tb:
            self.tb.close()
