"""Entry points of the port (counterpart of __graft_entry__.py): a
test-mode forward of the flagship model with its example inputs, and a
data-parallel training dry run with a checkpoint round trip.

    from itermvs_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry()              # on the card; entry(device="cpu") on the CPU
    depth, confidence = fn(*args)   # [1, 128, 160, 1] each
    dryrun_multichip(2)             # 2 processes; device="cpu": gloo ranks on the CPU

Both default to the card (`cuda`) and raise without one; neither falls
back to the CPU. The dry run's ranks are processes, not virtual devices
(parallel/mesh.py): with a card for every rank, rank r runs on `cuda:r`
over NCCL; with more ranks than cards they share the cards round robin
over gloo (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.data.loader import slice_batch
from itermvs_tpu_torch.engine.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from itermvs_tpu_torch.engine.train_loop import (
    init_weights, make_optimizer, to_device_batch, train_step)
from itermvs_tpu_torch.eval import resolve_device
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.ops.counts import launch_counts, reset_launch_counts
from itermvs_tpu_torch.parallel import launch, mesh

# The dry run: one sample per rank, 3 views at 64x96, 2 GRU iterations,
# stage 2 (regress), Adam at 1e-3; the resume bound is the JAX dry run's.
DRYRUN_VIEWS, DRYRUN_HEIGHT, DRYRUN_WIDTH = 3, 64, 96
DRYRUN_ITERATION = 2
DRYRUN_LR = 1e-3
RESUME_REL = 1e-6


def example_arrays(batch=1, views=5, height=128, width=160, seed=0):
    """The JAX `_example_inputs` as numpy arrays: images in [-1, 1] at 4
    levels ([B, V, H >> l, W >> l, 3]), pinhole projections per level
    ([B, V, 4, 4]: the reference at the origin, the sources slightly
    moved), depth range [2, 10]. The same draws of `RandomState(seed)` in
    the same order, so the values are the JAX function's bit for bit."""
    rng = np.random.RandomState(seed)
    imgs = {
        f"level_{i}": rng.rand(batch, views, height >> i, width >> i, 3).astype(np.float32)
        * 2 - 1
        for i in range(4)
    }
    K = np.array([[width * 1.2, 0, width / 2],
                  [0, width * 1.2, height / 2], [0, 0, 1]], np.float32)
    cams = []
    for v in range(views):
        E = np.eye(4, dtype=np.float32)
        if v > 0:
            E[:3, 3] = [0.3 * (-1) ** v, 0.05 * v, 0.02]
        cams.append((K, E))
    projs = {}
    for lvl in range(4):
        mats = []
        for K_, E in cams:
            Kl = K_.copy()
            Kl[:2] *= 0.5 ** lvl
            P = E.copy()
            P[:3, :4] = Kl @ E[:3, :4]
            mats.append(P)
        projs[f"level_{lvl}"] = np.tile(np.stack(mats)[None], (batch, 1, 1, 1))
    dmin = np.full((batch,), 2.0, np.float32)
    dmax = np.full((batch,), 10.0, np.float32)
    return imgs, projs, dmin, dmax


def _example_inputs(batch=1, views=5, height=128, width=160, seed=0, device=None):
    """`example_arrays` as tensors in `Pipeline.forward`'s layout
    `(imgs, projs, depth_min, depth_max)`, on `device` (None: the CPU)."""
    imgs, projs, dmin, dmax = example_arrays(batch, views, height, width, seed)
    as_tensor = lambda x: torch.from_numpy(x).to(device)
    return ({k: as_tensor(v) for k, v in imgs.items()},
            {k: as_tensor(v) for k, v in projs.items()}, as_tensor(dmin), as_tensor(dmax))


def entry(device=None):
    """(fn, example_args): the test-mode forward of the flagship model
    (`Pipeline(iteration=4, test=True)`, float32) and `_example_inputs()`
    on `device` (None: `cuda`; no card raises). `fn(imgs, projs, dmin,
    dmax)` returns the upsampled (depth, confidence), [B, H, W, 1] each.
    The weights are a fresh init from seed 0 with the JAX package's
    initializers (`init_weights`)."""
    device = resolve_device("cuda" if device is None else device)
    model = init_weights(Pipeline(iteration=4, test=True), 0).to(device)

    def fn(imgs, projs, dmin, dmax):
        with torch.inference_mode():
            out = model(imgs, projs, dmin, dmax)
        return out["depths_upsampled"], out["confidence_upsampled"]

    return fn, _example_inputs(device=device)


def dryrun_batch(batch):
    """The dry run's global batch in the training loader's layout (numpy):
    `example_arrays(batch, 3, 64, 96)` with depth U(3, 8) and a mask that
    keeps 80% of the pixels at every level, drawn from a second
    `RandomState(0)` as the JAX dry run draws them."""
    imgs, projs, dmin, dmax = example_arrays(batch, DRYRUN_VIEWS, DRYRUN_HEIGHT,
                                             DRYRUN_WIDTH)
    rng = np.random.RandomState(0)
    depth, mask = {}, {}
    for lvl in range(4):
        h, w = DRYRUN_HEIGHT >> lvl, DRYRUN_WIDTH >> lvl
        depth[f"level_{lvl}"] = rng.uniform(3, 8, (batch, h, w, 1)).astype(np.float32)
        mask[f"level_{lvl}"] = (rng.rand(batch, h, w, 1) > 0.2).astype(np.float32)
    return {"imgs": imgs, "proj_matrices": projs, "depth": depth, "mask": mask,
            "depth_min": dmin, "depth_max": dmax}


def _dryrun_rank(rank, world, port, backend, kind, logdir):
    """One rank of `dryrun_multichip`, in a process of its own (started by
    `launch.run_ranks`): joins the group and saves `_dryrun_steps`'
    record as `logdir/rank<r>.pt`."""
    rank, world = int(rank), int(world)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    device = torch.device(kind)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # The resume check holds two forwards of one state to 1e-6; cuDNN's
        # default float32 algorithms do not repeat bit for bit on the card.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    mesh.initialize_distributed("on", backend=backend, device=device)
    try:
        out = _dryrun_steps(rank, world, device, logdir)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(logdir, f"rank{rank}.pt"))


def _dryrun_steps(rank, world, device, logdir):
    """The JAX dry run on this rank's row of the global batch: step 1 (its
    loss finite), step 2, a checkpoint (rank 0 writes it, all meet at a
    barrier), a restore into a fresh model and optimizer, and one more
    step from the live and from the restored state. Records the losses,
    each step's kernel launches, what of the training state the restore
    did not bring back bit for bit (`restore_mismatch`), and both
    models' states after that step."""
    model = init_weights(Pipeline(iteration=DRYRUN_ITERATION, test=False), 0).to(device)
    mesh.broadcast_state_(model)
    optimizer = make_optimizer(model)
    batch = to_device_batch(slice_batch(dryrun_batch(world), rank, 1), device)
    launches = []

    def step(m, opt):
        reset_launch_counts()
        loss = train_step(m, opt, batch, DRYRUN_LR, regress=True,
                          num_iters=DRYRUN_ITERATION)["loss"].item()
        launches.append(launch_counts())
        return loss

    loss = step(model, optimizer)
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    step(model, optimizer)
    if rank == 0:
        save_checkpoint(logdir, 0, model, optimizer, step=2)
    mesh.barrier(device)
    restored = Pipeline(iteration=DRYRUN_ITERATION, test=False).to(device)
    restored_opt = make_optimizer(restored)
    epoch, done = restore_checkpoint(latest_checkpoint(logdir), restored, restored_opt)
    if (epoch, done) != (0, 2):
        raise RuntimeError(f"restored (epoch, step) {(epoch, done)} != (0, 2)")
    mismatch = restore_mismatch(model, optimizer, restored, restored_opt)
    live = step(model, optimizer)
    rest = step(restored, restored_opt)
    state = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}
    return {"loss": loss, "live": live, "restored": rest, "launches": launches,
            "device": str(device), "restore_mismatch": mismatch,
            "live_state": state(model), "state": state(restored)}


def restore_mismatch(model, optimizer, restored, restored_opt) -> list[str]:
    """What of the live training state `restored` and `restored_opt` lack
    bit for bit: model tensors, Adam's moments and step counts (by
    parameter index), and the optimizer's settings."""
    want, got = model.state_dict(), restored.state_dict()
    bad = [f"model.{k}" for k, v in want.items() if not torch.equal(v, got[k])]
    want, got = optimizer.state_dict(), restored_opt.state_dict()
    for i, entry in want["state"].items():
        bad += [f"optimizer.state.{i}.{k}" for k, v in entry.items()
                if not torch.equal(v, got["state"].get(i, {}).get(k, torch.empty(0)))]
    if want["param_groups"] != got["param_groups"]:
        bad.append("optimizer.param_groups")
    return bad


def check_resume(rec) -> dict:
    """One rank's resume check: the restored training state bit-equal to
    the live one before the next step (`restore_mismatch` empty; the
    losses are taken before each step's Adam update, so only this sees a
    restore that lost the optimizer's moments or step count), and the
    restored step's loss within RESUME_REL of the live one's (relative
    to max(1, |live|)). Returns the loss's relative difference and the
    largest of the parameters' and buffers' after the step (per tensor,
    relative to max(1, max |live|)): not held, since the card's backward
    does not add in a fixed order (K5 adds with atomics), which Adam
    magnifies where a gradient is near 0. Raises on a miss."""
    if rec["restore_mismatch"]:
        names = rec["restore_mismatch"]
        raise RuntimeError(f"the restored state differs from the live one's before the "
                           f"step in {len(names)} tensors or settings: {names[:5]}")
    live, rest = rec["live"], rec["restored"]
    if not np.isfinite(rest):
        raise FloatingPointError(f"non-finite restored-step loss {rest}")
    loss_rel = abs(live - rest) / max(1.0, abs(live))
    if not loss_rel <= RESUME_REL:
        raise RuntimeError(f"restored-step loss {rest} != live {live}")
    state_rel = max(float((rec["state"][k].double() - v.double()).abs().max())
                    / max(1.0, float(v.double().abs().max()))
                    for k, v in rec["live_state"].items())
    return {"loss_rel": loss_rel, "state_rel_after_step": state_rel}


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900) -> dict:
    """One data-parallel training step of `Pipeline(iteration=2, test=False)`
    over `n_devices` processes, one sample each, then the JAX dry run's
    checkpoint round trip: a second step, a save, a restore into a fresh
    model and optimizer, and one more step from both, whose losses must
    agree within 1e-6 (relative, for losses above 1), after a restore
    that brought back the model and the optimizer bit for bit
    (`check_resume`); every rank's parameters and BN buffers after the
    step must be bit-equal to every other's. `device` None means
    `cuda` (no card raises; see the module docstring for the backend);
    `cpu` runs gloo ranks on the CPU. A rank that fails or passes
    `timeout` seconds stops all and raises. Prints the JAX dry run's line
    and returns its numbers, the backend, the ranks' devices, each rank's
    launches per step (live steps 1-3, then the restored step) and the
    wall seconds."""
    kind = resolve_device("cuda" if device is None else device).type
    n = int(n_devices)
    if kind == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if n <= cards else "gloo"
        kernels.build_all()         # once, before the ranks start
    else:
        backend = "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="itermvs_dryrun_ckpt_") as logdir:
        launch.run_ranks("itermvs_tpu_torch.entry", "_dryrun_rank",
                         (backend, kind, logdir), n, timeout)
        ranks = [torch.load(os.path.join(logdir, f"rank{r}.pt"), weights_only=True)
                 for r in range(n)]
    seconds = time.perf_counter() - t0
    resume = [check_resume(r) for r in ranks]
    loss, live, rest = ranks[0]["loss"], ranks[0]["live"], ranks[0]["restored"]
    state = ranks[0]["state"]
    unequal = sorted({k for r in ranks[1:] for k in state
                      if not torch.equal(r["state"][k], state[k])})
    if unequal:
        raise RuntimeError(f"the ranks' states differ after the restored step: {unequal}")
    devices = [r["device"] for r in ranks]
    print(f"dryrun_multichip({n}) ok: loss={loss:.4f}, restored-step loss={rest:.4f} "
          f"(matches live {live:.4f}); {backend} over {', '.join(devices)}")
    return {"n_devices": n, "backend": backend, "devices": devices, "loss": loss,
            "live": live, "restored": rest,
            "restored_bit_equal": True,
            "state_rel_after_step": max(r["state_rel_after_step"] for r in resume),
            "ranks_bit_equal": not unequal,
            "seconds": seconds, "launches": [r["launches"] for r in ranks]}
