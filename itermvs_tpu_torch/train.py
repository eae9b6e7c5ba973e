"""Train IterMVS with the PyTorch port (the port of train.py).

    python -m itermvs_tpu_torch.train --dataset dtu_yao --trainpath DTU \\
        --trainlist lists/dtu/train.txt --vallist lists/dtu/val.txt \\
        --logdir OUT [--regress] [--device cpu]

Flags keep the names and defaults of the JAX train.py, and so does the
loop: a fresh seeded init (or `--loadckpt` weights, or `--resume` from
the latest checkpoint in `--logdir`, mid-epoch step saves included),
per-epoch MultiStep LR, TensorBoard scalars every `--summary_freq`
steps and images every 50·`--summary_freq`, a checkpoint every
`--save_freq` epochs (and every `--save_step_freq` steps), and a
validation pass per epoch; `--mode val` only validates.
`--precision bfloat16` trains in the JAX package's bfloat16 mode: the
parameters, the optimizer state and the checkpoints stay float32, and
the loss is computed in float32. `--device` (default `cuda`) is the
port's own: a missing card is an error, not a run on the CPU.
`--debug_nans` stops at the first NaN of the forward or the backward
(engine/profiling.py).

Data-parallel training runs one process per device under torchrun:

    torchrun --nproc_per_node N -m itermvs_tpu_torch.train ... \
        --batch_size 4

`--distributed` (auto, on, off: parallel/mesh.py) joins the process
group (NCCL for CUDA, gloo for the CPU); each rank trains on
`cuda:LOCAL_RANK` with its slice of every global batch (`--batch_size`
is the global batch and must divide over the ranks), and the step is
the JAX package's global-batch step. Every rank starts from rank 0's
parameters and reads `--resume` / `--loadckpt` itself; rank 0 alone
writes TensorBoard and the checkpoints, and the others wait at each save.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from itermvs_tpu_torch.data import find_dataset_def
from itermvs_tpu_torch.data.loader import DataLoader
from itermvs_tpu_torch.engine.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from itermvs_tpu_torch.engine.metrics import DictAverageMeter
from itermvs_tpu_torch.engine.profiling import maybe_enable_nan_debugging
from itermvs_tpu_torch.engine.tb_writer import SummaryWriter
from itermvs_tpu_torch.engine.train_loop import (
    init_weights, lr_for_epoch, make_optimizer, to_device_batch, train_step,
    val_step)
from itermvs_tpu_torch.eval import resolve_device
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.parallel import mesh
from itermvs_tpu_torch.weights import load_weights

parser = argparse.ArgumentParser(
    description="IterMVS for high-resolution multi-view stereo (PyTorch port)")
parser.add_argument("--mode", default="train", help="train or val",
                    choices=["train", "val"])
parser.add_argument("--model", default="IterMVS", help="select model")
parser.add_argument("--dataset", default="dtu_yao", help="select dataset")
parser.add_argument("--trainpath", help="train datapath")
parser.add_argument("--valpath", help="validation datapath")
parser.add_argument("--trainlist", help="train list")
parser.add_argument("--vallist", help="validation list")
parser.add_argument("--epochs", type=int, default=16, help="number of epochs to train")
parser.add_argument("--lr", type=float, default=0.001, help="learning rate")
parser.add_argument("--lrepochs", type=str, default="4,8,12:2",
                    help="epoch ids to downscale lr and the downscale rate")
parser.add_argument("--wd", type=float, default=0.0, help="weight decay")
parser.add_argument("--batch_size", type=int, default=4, help="train batch size")
parser.add_argument("--loadckpt", default=None,
                    help="load weights only: a checkpoint of this trainer "
                         "(.ckpt) or vendored .npz weights")
parser.add_argument("--logdir", default="./checkpoints",
                    help="the directory to save checkpoints/logs")
parser.add_argument("--resume", action="store_true", help="continue to train the model")
parser.add_argument("--regress", action="store_true",
                    help="train the regression and confidence")
parser.add_argument("--small_image", action="store_true",
                    help="train with small input as 640x512, otherwise train with 1280x1024")
parser.add_argument("--summary_freq", type=int, default=20,
                    help="print and summary frequency")
parser.add_argument("--save_freq", type=int, default=1, help="save checkpoint frequency")
parser.add_argument("--save_step_freq", type=int, default=0,
                    help="additionally checkpoint every N train steps "
                         "(0 = off); resume continues mid-epoch on the "
                         "exact next batch")
parser.add_argument("--seed", type=int, default=1, metavar="S", help="random seed")
parser.add_argument("--iteration", type=int, default=4, help="num of iteration of GRU")
parser.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                    help="training compute precision: float32 = reference parity; "
                         "bfloat16 = fast path (heads, loss, BN statistics and "
                         "parameters stay float32)")
parser.add_argument("--debug_nans", action="store_true",
                    help="abort with a traceback at the first NaN a module "
                         "outputs or the backward produces")
parser.add_argument("--distributed", default="auto", choices=["auto", "on", "off"],
                    help="join a torch.distributed process group: auto = when "
                         "the launch has more than one process (torchrun's "
                         "WORLD_SIZE, SLURM, Open MPI); on = join or fail "
                         "loudly; off = never join")
parser.add_argument("--loader_processes", type=int, default=-1,
                    help="decode worker processes for the input pipeline; "
                         "-1 = auto: min(4, cpu_count-1) when the host has "
                         ">1 core, else 0 (decode in this process)")
parser.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")


def pad_batch(sample, target: int):
    """Pad a short batch to `target` samples by repeating the last sample
    with its validity masks zeroed (the JAX train.py's `pad_batch`).

    Zero-mask padding is metric-exact: full_loss normalizes every term by
    the total mask count (models/losses.py: _masked_mean) and
    depth_metrics averages per-image values only over images with any
    valid pixels (ops/depth_metrics.py: batch_sums), so padded samples
    contribute exactly nothing. Returns (sample, real count)."""
    n = int(np.asarray(sample["depth_min"]).shape[0])
    if n >= target:
        return sample, n

    def pad(x, zero=False):
        x = np.asarray(x)
        tail = np.repeat(x[-1:], target - n, axis=0)
        if zero:
            tail = np.zeros_like(tail)
        return np.concatenate([x, tail], axis=0)

    out = dict(sample)
    for key in ("imgs", "proj_matrices", "depth"):
        out[key] = {k: pad(v) for k, v in sample[key].items()}
    out["mask"] = {k: pad(v, zero=True) for k, v in sample["mask"].items()}
    out["depth_min"] = pad(sample["depth_min"])
    out["depth_max"] = pad(sample["depth_max"])
    return out, n


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    distributed = mesh.initialize_distributed(args.distributed, device=device)
    try:
        run(args, argv, device, distributed)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def run(args, argv, device, distributed: bool):
    if distributed and device.type == "cuda":
        device = mesh.local_device("cuda")
        torch.cuda.set_device(device)
    rank, world = mesh.rank(), mesh.world_size()
    if args.resume:
        assert args.mode == "train"
        assert args.loadckpt is None
    if args.valpath is None:
        args.valpath = args.trainpath

    np.random.seed(args.seed)
    print("argv:", sys.argv[1:] if argv is None else argv)
    for k, v in sorted(vars(args).items()):
        print(f"{k}: {v}")

    logger = None
    if args.mode == "train" and rank == 0:
        os.makedirs(args.logdir, exist_ok=True)
        print("creating new summary file")
        logger = SummaryWriter(args.logdir)

    MVSDataset = find_dataset_def(args.dataset)
    train_dataset = MVSDataset(args.trainpath, args.trainlist, "train", 5,
                               robust_train=True, seed=args.seed)
    val_dataset = MVSDataset(args.valpath, args.vallist, "val", 5,
                             robust_train=False, seed=args.seed)
    workers = args.loader_processes
    if workers < 0:
        ncpu = os.cpu_count() or 1
        workers = min(4, ncpu - 1) if ncpu > 1 else 0
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed, workers=workers,
                              process_index=rank, process_count=world)
    val_loader = DataLoader(val_dataset, args.batch_size, shuffle=False,
                            drop_last=False, workers=workers,
                            process_index=rank, process_count=world)
    local_batch = args.batch_size // world

    model = init_weights(Pipeline(iteration=args.iteration, test=False,
                                  dtype=getattr(torch, args.precision)),
                         args.seed).to(device)
    optimizer = make_optimizer(model, args.wd)
    print(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")

    start_epoch = 0
    skip_batches = 0
    if (args.mode == "train" and args.resume) or (args.mode == "val" and not args.loadckpt):
        ckpt = latest_checkpoint(args.logdir)
        assert ckpt is not None, f"no checkpoint to resume in {args.logdir}"
        print("resuming", ckpt)
        epoch, step = restore_checkpoint(ckpt, model, optimizer)
        if step is None:
            start_epoch = epoch + 1
        else:  # mid-epoch: re-enter `epoch` and skip its finished batches
            start_epoch = epoch
            skip_batches = step
    elif args.loadckpt:
        print(f"loading model {args.loadckpt}")
        load_weights(model, args.loadckpt)
    if distributed:
        mesh.broadcast_state_(model)
    print(f"start at epoch {start_epoch}"
          + (f" (skipping {skip_batches} batches)" if skip_batches else ""))

    def log_images(sample, step_no):
        """TB images of the first sample, forward with BN in eval mode."""
        def first(x):
            return {k: first(v) for k, v in x.items()} if isinstance(x, dict) else x[:1]

        batch = to_device_batch(first(sample), device)
        model.eval()
        with torch.no_grad():
            out = model(batch["imgs"], batch["proj_matrices"], batch["depth_min"],
                        batch["depth_max"])
        model.train()
        depth_est = out["depths_upsampled"][0][..., 0].cpu().numpy()
        depth_gt = np.asarray(sample["depth"]["level_0"])[:1, ..., 0]
        mask = np.asarray(sample["mask"]["level_0"])[:1, ..., 0]
        logger.save_images("train", {
            "depth_est": depth_est * mask,
            "depth_gt": depth_gt,
            "ref_img": np.asarray(sample["imgs"]["level_0"])[:1, 0],
            "mask": mask,
            "errormap": np.abs(depth_est - depth_gt) * mask,
            "confidence": out["confidence_upsampled"][..., 0].cpu().numpy(),
        }, step_no)

    def save(epoch_idx, step=None):
        if rank == 0:
            print("saved", save_checkpoint(args.logdir, epoch_idx, model, optimizer,
                                           step=step))
        if distributed:
            mesh.barrier(device)

    def run_validation(epoch_idx, global_step):
        meter = DictAverageMeter()
        for batch_idx, sample in enumerate(val_loader):
            # A short last batch (one process only) is padded with
            # mask-zeroed samples, as the JAX loop pads it.
            sample, _ = pad_batch(sample, local_batch)
            scalars = val_step(model, to_device_batch(sample, device),
                               args.regress, args.iteration)
            scalars = {k: float(v) for k, v in scalars.items()}
            meter.update(scalars)
            if batch_idx % 100 == 0:
                print(f"Epoch {epoch_idx}/{args.epochs}, "
                      f"Iter {batch_idx}/{len(val_loader)}, "
                      f"test loss = {scalars['loss']:.3f}")
        means = meter.mean()
        if logger is not None:
            logger.save_scalars("fulltest", means, global_step)
        print("avg_test_scalars:", means)
        return means

    with maybe_enable_nan_debugging(model, args.debug_nans):
        if args.mode == "val":
            run_validation(start_epoch, 0)
            return

        for epoch_idx in range(start_epoch, args.epochs):
            print(f"Epoch {epoch_idx}:")
            lr = lr_for_epoch(args.lr, epoch_idx, args.lrepochs)
            global_step = len(train_loader) * epoch_idx

            # Pin the order to the true epoch (a resumed run regenerates the
            # same sequence) and skip the batches a step checkpoint covered.
            train_loader.set_epoch(epoch_idx, skip_batches)
            first_batch = skip_batches
            skip_batches = 0

            for batch_idx, sample in enumerate(train_loader, start=first_batch):
                start = time.time()
                step_no = len(train_loader) * epoch_idx + batch_idx
                scalars = train_step(model, optimizer, to_device_batch(sample, device),
                                     lr, args.regress, args.iteration)
                if logger is not None and step_no % (50 * args.summary_freq) == 0:
                    log_images(sample, step_no)
                if step_no % args.summary_freq == 0:
                    scalars = {k: float(v) for k, v in scalars.items()}
                    if logger is not None:
                        logger.save_scalars("train", scalars, step_no)
                    print(f"Epoch {epoch_idx}/{args.epochs}, "
                          f"Iter {batch_idx}/{len(train_loader)}, "
                          f"lr {lr:.6f}, train loss = {scalars['loss']:.3f}, "
                          f"time = {time.time() - start:.3f}")
                if (args.save_step_freq > 0
                        and (batch_idx + 1) % args.save_step_freq == 0
                        and batch_idx + 1 < len(train_loader)):
                    save(epoch_idx, step=batch_idx + 1)

            if (epoch_idx + 1) % args.save_freq == 0:
                save(epoch_idx)

            run_validation(epoch_idx, global_step)


if __name__ == "__main__":
    main()
