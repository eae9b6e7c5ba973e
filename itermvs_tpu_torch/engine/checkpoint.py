"""Training checkpoints (counterpart of itermvs_tpu/engine/checkpoint.py).

One torch file per save, in the reference's form
`{"epoch", "step", "model": state_dict, "optimizer": state_dict}`, whose
model keys are the reference's names, so the JAX package's
`engine/torch_import.py::import_torch_checkpoint` reads it. Names:
`model_{epoch:06d}.ckpt` at the end of an epoch (step None) and
`model_{epoch:06d}_step{step:08d}.ckpt` after `step` completed batches of
that epoch (`--save_step_freq`). The loader's order is a pure function
of (seed, epoch) (data/loader.py), so a run resumed from a step save
skips exactly those batches and goes on with the same sequence.
"""
from __future__ import annotations

import os
import re

import torch

_CKPT_RE = re.compile(r"model_(\d+)(?:_step(\d+))?\.ckpt$")

# Sort key of an epoch-end checkpoint: above every step checkpoint of
# the same epoch (an epoch-end save supersedes its partial saves).
_EPOCH_END = 1 << 62


def save_checkpoint(logdir: str, epoch: int, model, optimizer,
                    step: int | None = None) -> str:
    """Save model and optimizer. `step` = completed batches within
    `epoch`; None means the epoch finished. Written to a temporary name
    and renamed, so a cut run leaves no partial file under the name."""
    name = (f"model_{epoch:0>6}.ckpt" if step is None
            else f"model_{epoch:0>6}_step{step:0>8}.ckpt")
    path = os.path.abspath(os.path.join(logdir, name))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"epoch": int(epoch), "step": None if step is None else int(step),
                "model": model.state_dict(), "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(logdir: str) -> str | None:
    """Most recent checkpoint by (epoch, progress within the epoch)."""
    if not os.path.isdir(logdir):
        return None
    found = []
    for name in os.listdir(logdir):
        m = _CKPT_RE.search(name)
        if m:
            step = _EPOCH_END if m.group(2) is None else int(m.group(2))
            found.append((int(m.group(1)), step, name))
    if not found:
        return None
    return os.path.abspath(os.path.join(logdir, max(found)[2]))


def restore_checkpoint(path: str, model, optimizer):
    """Load model and optimizer state from `path` onto their devices.
    Returns (epoch, step): step is the number of completed batches within
    `epoch`, or None if the epoch finished (resume at epoch + 1)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(raw["model"])
    optimizer.load_state_dict(raw["optimizer"])
    return int(raw["epoch"]), raw["step"]
