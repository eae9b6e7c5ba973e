"""Data parallelism across processes (counterpart of
itermvs_tpu/parallel/mesh.py).

The JAX package shards the batch axis over a 1-D device mesh and writes
its step over the global batch; GSPMD inserts the reductions. The torch
form is not a mesh: it is one process per device (torchrun's launch),
each holding `batch_size / world_size` consecutive samples of every
global batch (data/loader.py), joined by one `torch.distributed` process
group. The step stays the global-batch step because the three places
that couple the samples of a batch reduce across the group: BatchNorm's
training statistics (models/blocks.py), the loss's masked means
(models/losses.py) and the metrics' batch means (engine/metrics.py). The
gradients are then summed once (`all_reduce_grads_`, the JAX psum), so
every rank clips and steps Adam on the same numbers.

Only `all_reduce` (SUM) and `broadcast` are used, the two collectives
gloo supports on CUDA tensors as well as NCCL does.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

# Environment markers of a multi-process launch, checked by VALUE, not
# mere presence: torchrun exports WORLD_SIZE=1 for a one-process run and
# SLURM sets SLURM_NTASKS=1 for plain single-process jobs, and a
# presence-only check would send those into a rendezvous that is not
# there. When a marker DOES indicate >1 process, joining must succeed —
# a silent fallback would train N independent copies with the wrong
# global batch.
_PROCESS_COUNT_ENV_VARS = (
    "WORLD_SIZE",
    "SLURM_NTASKS",
    "OMPI_COMM_WORLD_SIZE",
)


def _multihost_markers() -> list[str]:
    """Env vars whose VALUES indicate a multi-process launch."""
    markers = []
    for v in _PROCESS_COUNT_ENV_VARS:
        val = os.environ.get(v, "").strip()
        if val.isdigit() and int(val) > 1:
            markers.append(v)
    return markers


def initialize_distributed(mode: str = "auto", backend: str | None = None,
                           device="cuda") -> bool:
    """Join the process group; returns True if one was joined.

    mode:
      "auto" — join iff the environment indicates MORE THAN ONE process
        (`_multihost_markers`: a process count > 1); plain single-process
        runs skip, including under torchrun with WORLD_SIZE=1. A
        launcher that sets none of those variables needs --distributed on.
      "on"   — always join, through torch.distributed's `env://`
        rendezvous (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as
        torchrun exports them); with no rendezvous configured this fails
        loudly rather than silently training N independent copies.
      "off"  — never join (explicit single-process override).

    `backend` defaults to NCCL for a CUDA `device` and gloo for the CPU.
    Any failure in an actual multi-process environment propagates.
    """
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"--distributed must be auto/on/off, got {mode!r}")
    if mode == "off":
        return False
    if mode == "auto":
        present = _multihost_markers()
        if not present:
            return False
        print(f"multi-process launch detected ({', '.join(present)}); "
              "initializing torch.distributed")
    else:
        print("--distributed on: initializing torch.distributed")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://")
    print(f"torch.distributed up ({backend}): process {dist.get_rank()}/"
          f"{dist.get_world_size()}")
    return True


def is_initialized() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_device(kind: str = "cuda") -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (torchrun's per-host index)
    for a CUDA run, the CPU otherwise."""
    if torch.device(kind).type != "cuda":
        return torch.device(kind)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the process group, as a new tensor. Not
    differentiated: its callers sum statistics, counts and scalars that
    take no gradient (BatchNorm's backward sums its own terms over the
    group, ops/bn_act.py `BnTrain`)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


def all_reduce_grads_(params) -> None:
    """Sum every parameter's `.grad` over the group in place, as one flat
    buffer (one collective a step, like the JAX step's psum)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_state_(module: torch.nn.Module) -> None:
    """Give every rank rank 0's parameters and buffers."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def barrier(device) -> None:
    """Wait until every rank gets here: a one-element all-reduce read
    back on the host (works for gloo and NCCL alike)."""
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag)
    flag.item()
