"""Predict depth, filter and fuse with the PyTorch port (the port of eval.py).

    python -m itermvs_tpu_torch.eval --dataset=custom --testpath=SCENE \\
        --n_views 5 --img_wh 640 480 --outdir=OUT [--device cpu]

Writes `OUT/{depth_est,confidence}/<view:08d>.pfm` per reference view
(`save_depth`), then fuses each scan (`run_fusion`, fusion.py) into
`OUT/mask/*.png` and a PLY named per dataset as eval.py names it. Flags
keep the names and defaults of the JAX eval.py; `--precision bfloat16`
runs the model in the JAX package's bfloat16 mode (the maps it writes are
float32 either way), and `--debug_nans` stops at the first NaN a module of
the model outputs (engine/profiling.py).
`--device` (default `cuda`) is the port's own, both steps run on it, and
a missing card is an error, not a silent run on the CPU.

Under torchrun (`python -m torch.distributed.run --nproc_per_node N -m
itermvs_tpu_torch.eval ...`) the processes join one group, each on
`cuda:LOCAL_RANK` (or the CPU over gloo with `--device cpu`). When N
divides `--batch_size`, eval is data-parallel as the JAX eval.py's is
over its devices: every global batch is split over the processes
(`data.loader.eval_batches`, the short last one padded), each writes the
maps of its own real rows, and rank 0 alone fuses once all are written.
Otherwise rank 0 evaluates everything alone and the others stay idle.

The core loop, `run_depth`, takes any iterable of samples in the
loader's batched layout, so callers without image files (e.g.
`chip_smoke.py`) can feed in-memory samples.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from itermvs_tpu_torch.data import find_dataset_def
from itermvs_tpu_torch.data.base import split_decode_cache_cap
from itermvs_tpu_torch.data.loader import eval_batches
from itermvs_tpu_torch.engine.profiling import maybe_enable_nan_debugging
from itermvs_tpu_torch.fusion import filter_depth
from itermvs_tpu_torch.io import save_pfm
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.ops.consistency import quantize_depth
from itermvs_tpu_torch.parallel import mesh
from itermvs_tpu_torch.weights import load_weights, pretrained_path

parser = argparse.ArgumentParser(description="Predict depth, filter, and fuse "
                                             "(PyTorch port)")
parser.add_argument("--model", default="IterMVS", help="select model")
parser.add_argument("--dataset", default="dtu_yao_eval",
                    choices=["dtu_yao_eval", "custom", "tanks", "eth3d"],
                    help="select dataset")
parser.add_argument("--testpath", help="testing data path")
parser.add_argument("--testlist", help="testing scan list")
parser.add_argument("--split", default="intermediate",
                    help="tanks: intermediate or advanced; eth3d: test or train")
parser.add_argument("--batch_size", type=int, default=1, help="testing batch size")
parser.add_argument("--n_views", type=int, default=5, help="num of view")
parser.add_argument("--img_wh", nargs="+", type=int, default=None,
                    help="width and height of the image")
parser.add_argument("--loadckpt", default=None,
                    help="weights: vendored .npz (default: checkpoints/dtu) "
                         "or a checkpoint of the port's trainer (.ckpt)")
parser.add_argument("--outdir", default="./outputs", help="output dir")
parser.add_argument("--display", action="store_true",
                    help="write the depth and mask images under OUT/display")
parser.add_argument("--iteration", type=int, default=4, help="num of iteration of GRU")
parser.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                    help="compute precision: float32 = reference parity; "
                         "bfloat16 = fast path (heads stay float32)")
parser.add_argument("--debug_nans", action="store_true",
                    help="abort with a traceback at the first NaN a module "
                         "of the model outputs")
parser.add_argument("--feature_cache", default="auto", choices=["auto", "on", "off"],
                    help="cache FeatureNet outputs per (scan, view) across "
                         "reference views; auto = on for batch-1 eval")
parser.add_argument("--feature_cache_views", type=int, default=16,
                    help="LRU capacity (views) of the feature cache")
parser.add_argument("--input_uint8", action="store_true",
                    help="load level_0 images as raw uint8 and normalize "
                         "to [-1,1] on the device")
parser.add_argument("--result_wire", default="uint16", choices=["uint16", "float32"],
                    help="device->host transport for depth/confidence maps: "
                         "uint16 quantizes each map against its own range "
                         "on the device, float32 copies raw outputs")
parser.add_argument("--scan_shard", default=None, metavar="I/N",
                    help="process only every N-th scan starting at I "
                         "(0-based), e.g. 0/4 .. 3/4, one process per card")
parser.add_argument("--geo_pixel_thres", type=float, default=1,
                    help="pixel threshold for geometric consistency filtering")
parser.add_argument("--geo_depth_thres", type=float, default=0.01,
                    help="depth threshold for geometric consistency filtering")
parser.add_argument("--photo_thres", type=float, default=0.3,
                    help="threshold for photometric consistency filtering")
parser.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")

# geo_mask_thres per scan (the reference's tables).
TANKS_INTERMEDIATE_THRES = {"Family": 5, "Francis": 6, "Horse": 5, "Lighthouse": 6,
                            "M60": 5, "Panther": 5, "Playground": 5, "Train": 5}
TANKS_ADVANCED_THRES = {"Auditorium": 3, "Ballroom": 4, "Courtroom": 4,
                        "Museum": 4, "Palace": 5, "Temple": 4}
ETH3D_TEST_THRES = {"botanical_garden": 1, "boulders": 1, "bridge": 2, "door": 2,
                    "exhibition_hall": 2, "lecture_room": 2, "living_room": 2,
                    "lounge": 1, "observatory": 2, "old_computer": 2, "statue": 2,
                    "terrace_2": 2}
ETH3D_TRAIN_THRES = {"courtyard": 1, "delivery_area": 2, "electro": 1, "facade": 2,
                     "kicker": 1, "meadow": 1, "office": 1, "pipes": 1,
                     "playground": 1, "relief": 1, "relief_2": 1, "terrace": 1,
                     "terrains": 2}


def resolve_img_wh(args):
    """Named datasets pin their published eval sizes; custom honours
    --img_wh (default 640 480). ITERMVS_IMG_WH ('W H' or 'WxH') replaces
    the pinned sizes and loses to an explicit --img_wh on custom."""
    override = os.environ.get("ITERMVS_IMG_WH")
    explicit_wh = args.img_wh is not None and args.dataset == "custom"
    if args.img_wh is None:
        args.img_wh = [640, 480]
    if override and not explicit_wh:
        try:
            w, h = (int(x) for x in override.lower().replace("x", " ").split())
        except (ValueError, TypeError):
            raise SystemExit(f"ITERMVS_IMG_WH must be 'W H' or 'WxH', got {override!r}")
        print(f"img_wh overridden via ITERMVS_IMG_WH: {w}x{h}")
        return (w, h)
    if args.dataset == "dtu_yao_eval":
        return (1600, 1152)
    if args.dataset == "tanks":
        return (1920, 1024)
    if args.dataset == "eth3d":
        return (1920, 1280)
    return (args.img_wh[0], args.img_wh[1])


def parse_scan_shard(spec):
    """'I/N' -> (I, N), validated; None -> None."""
    if spec is None:
        return None
    try:
        idx, count = (int(p) for p in spec.split("/"))
    except ValueError:
        raise SystemExit(f"--scan_shard must be I/N, got {spec!r}")
    if count < 1 or not 0 <= idx < count:
        raise SystemExit(f"--scan_shard needs 0 <= I < N, got {spec!r}")
    return idx, count


def shard_scans(scans, shard):
    """Round-robin slice `[I::N]` of an ordered scan list."""
    if shard is None:
        return list(scans)
    idx, count = shard
    return list(scans)[idx::count]


def apply_scan_shard(dataset, shard):
    """Keep only this shard's scans in `dataset.metas`, in place.

    Scan-keyed datasets (dtu_yao_eval, tanks, eth3d) carry the scan as
    metas[i][0] and are sharded round-robin over the scans in order of
    first appearance; a single-scan dataset (custom) runs wholly on
    shard 0."""
    if shard is None:
        return dataset
    metas = dataset.metas
    if not (metas and isinstance(metas[0][0], str)):
        if shard[0] != 0:
            dataset.metas = []
        return dataset
    keep = set(shard_scans(dict.fromkeys(m[0] for m in metas), shard))
    dataset.metas = [m for m in metas if m[0] in keep]
    return dataset


def resolve_device(name: str) -> torch.device:
    """`name` as a device; CUDA without a card raises (no CPU fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def build_dataset(args, img_wh):
    dataset_cls = find_dataset_def(args.dataset)
    if args.dataset == "dtu_yao_eval":
        return dataset_cls(args.testpath, args.testlist, args.n_views, img_wh,
                           uint8_level0=args.input_uint8)
    if args.dataset == "tanks":
        return dataset_cls(args.testpath, args.n_views, img_wh, args.split,
                           uint8_level0=args.input_uint8)
    if args.dataset == "eth3d":
        return dataset_cls(args.testpath, args.split, args.n_views, img_wh,
                           uint8_level0=args.input_uint8)
    return dataset_cls(args.testpath, args.n_views, img_wh,
                       uint8_level0=args.input_uint8)


def quantize_results(depths: torch.Tensor, confs: torch.Tensor):
    """uint16 result wire, device side: [B,H,W,1] f32 depth + confidence →
    (depth_q uint16, lo [B], hi [B], conf_q uint16).

    Each depth map is quantized against its own [min, max]
    (`quantize_depth`); confidence (a sigmoid in [0, 1]) uses the fixed
    1/65535 grid. Round-to-nearest error is at most span/131070 in depth
    and 7.7e-6 in confidence."""
    depth_q, lo, hi = quantize_depth(depths[..., 0])
    conf_q = torch.clamp(torch.round(confs[..., 0] * 65535.0), 0, 65535).to(torch.uint16)
    return depth_q, lo, hi, conf_q


def dequantize_results(depth_q, lo, hi, conf_q):
    """Host-side inverse of `quantize_results` (NumPy, float32)."""
    step = ((hi - lo).astype(np.float32) / np.float32(65535.0))[:, None, None]
    depths = lo.astype(np.float32)[:, None, None] + depth_q.astype(np.float32) * step
    confs = conf_q.astype(np.float32) / np.float32(65535.0)
    return depths, confs


def _write_outputs(outdir, filename, depth_est, confidence):
    for kind, image in (("depth_est", depth_est), ("confidence", confidence)):
        path = os.path.join(outdir, filename.format(kind, ".pfm"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_pfm(path, image)


def run_depth(model: Pipeline, samples, outdir: str, device, *,
              feature_cache: bool = True, feature_cache_views: int = 16,
              result_wire: str = "uint16", log=print,
              host_secs: list | None = None,
              n_real: list[int] | None = None) -> list[float]:
    """Depth + confidence PFMs for every batch of `samples`.

    `samples` yields dicts in the loader's batched layout (arrays or
    tensors with a leading batch axis; `filename` a list of templates).
    With `feature_cache`, batch-1 samples carrying `scan` and `view_ids`
    run FeatureNet once per (scan, view), LRU-bounded to
    `feature_cache_views` views; outputs equal the uncached forward.
    `n_real`, when given, holds per batch the number of its leading rows
    that are real; the rows after them pad the batch (data-parallel eval,
    `data.loader.eval_batches`) and are computed but neither fetched nor
    written, so a batch of padding alone writes nothing.

    A one-batch software pipeline, as the JAX eval.py's: `dispatch`
    uploads batch i+1, launches its forward and its device→host copies
    before `finalize` waits for batch i's copies and hands its PFMs to
    the writer threads, so the card computes through the fetch, the
    dequantization and the handoff. On CUDA the copies land in
    page-locked memory without blocking, and `finalize` waits on the
    batch's own event; on the CPU they are plain synchronous copies. If
    a batch fails, the batch before it is still finalized and written
    before the error propagates; every write is awaited before return.

    Returns the wall seconds of each batch, from the end of the previous
    batch's `finalize` (the first from the loop's start, warm-up
    included) to the end of its own: they sum to the loop's wall time.
    `host_secs`, when given, receives one (dispatch, finalize) pair of
    host seconds per batch.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    cache: OrderedDict = OrderedDict()
    batch_secs = []
    total = len(samples) if hasattr(samples, "__len__") else "?"

    def dev(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    def features(sample):
        scan = sample.get("scan", ["?"])[0]
        level0 = sample["imgs"]["level_0"]                        # [1,V,H,W,3]
        feats = []
        for i, vid in enumerate(np.asarray(sample["view_ids"]).reshape(-1)):
            key = (scan, int(vid))
            if key not in cache:
                cache[key] = model.extract(dev(level0[:, i]))
                while len(cache) > feature_cache_views:
                    cache.popitem(last=False)
            else:
                cache.move_to_end(key)
            feats.append(cache[key])
        return feats

    def to_host(x):
        # A fresh page-locked buffer per batch: the f32 wire hands views
        # of it to the writer threads, which may still read the last one.
        if not cuda:
            return x
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
            x, non_blocking=True)

    def dispatch(sample, real):
        t0 = time.perf_counter()
        projs = {k: dev(v) for k, v in sample["proj_matrices"].items()
                 if k != "level_0"}
        dmin, dmax = dev(sample["depth_min"]), dev(sample["depth_max"])
        if (feature_cache and "view_ids" in sample
                and len(sample["filename"]) == 1):
            out = model.match(features(sample), projs, dmin, dmax)
        else:
            out = model({"level_0": dev(sample["imgs"]["level_0"])},
                        projs, dmin, dmax)
        depths, confs = out["depths_upsampled"], out["confidence_upsampled"]
        wire = (quantize_results(depths, confs) if result_wire == "uint16"
                else (depths[..., 0], confs[..., 0]))
        host = [to_host(x[:real]) for x in wire]
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        return sample, host, done, time.perf_counter() - t0

    futures, last = [], time.perf_counter()

    def finalize(batch_idx, sample, host, done, dispatch_s):
        nonlocal last
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        arrays = [x.numpy() for x in host]
        depths, confs = (dequantize_results(*arrays) if result_wire == "uint16"
                         else arrays)
        for filename, depth_est, confidence in zip(sample["filename"], depths, confs):
            futures.append(writer.submit(_write_outputs, outdir, filename,
                                         depth_est, confidence))
        now = time.perf_counter()
        batch_secs.append(now - last)
        last = now
        log(f"Iter {batch_idx}/{total}, time = {batch_secs[-1]:.3f}")
        if host_secs is not None:
            host_secs.append((dispatch_s, now - t0))

    with ThreadPoolExecutor(max_workers=2) as writer, torch.inference_mode():
        pending = None
        try:
            for batch_idx, sample in enumerate(samples):
                real = len(sample["filename"]) if n_real is None else n_real[batch_idx]
                launched = (batch_idx, *dispatch(sample, real))
                previous, pending = pending, launched
                if previous is not None:
                    finalize(*previous)
        finally:
            if pending is not None:
                finalize(*pending)
        for fut in futures:
            fut.result()
    return batch_secs


def _init_loader_worker(worker_id, workers):
    split_decode_cache_cap(workers)


def save_depth(args, img_wh) -> bool:
    """Load the dataset and weights and run `run_depth` on `args.device`.

    Joins torchrun's process group unless this process already belongs
    to one; each rank of a CUDA run takes `cuda:LOCAL_RANK`. The eval is
    data-parallel when the group's processes divide `--batch_size` (the
    JAX eval.py's rule, with processes for devices): each rank loads,
    evaluates and writes only its rows of every global batch
    (`eval_batches`), with the feature cache off. Otherwise rank 0
    evaluates every map and the other ranks return at once. Returns
    whether the ranks shared the batches."""
    device = resolve_device(args.device)
    if args.feature_cache == "on" and args.batch_size != 1:
        raise SystemExit("--feature_cache on requires --batch_size 1 on a single device")
    if not mesh.is_initialized():
        mesh.initialize_distributed("auto", device=device)
    rank, world = mesh.rank(), mesh.world_size()
    if world > 1 and device.type == "cuda":
        device = mesh.local_device("cuda")
        torch.cuda.set_device(device)
    parallel = world > 1 and args.batch_size % world == 0
    if world > 1 and not parallel and rank != 0:
        print(f"rank {rank}: --batch_size {args.batch_size} does not divide over "
              f"{world} processes; rank 0 evaluates alone and this rank is idle")
        return False
    if parallel and rank == 0:
        print(f"data-parallel eval over {world} processes")
    path = args.loadckpt or pretrained_path("dtu")
    print(f"loading model {path}")
    model = load_weights(Pipeline(iteration=args.iteration,
                                  dtype=getattr(torch, args.precision)), path).to(device)
    dataset = apply_scan_shard(build_dataset(args, img_wh),
                               parse_scan_shard(args.scan_shard))
    if parallel:
        order = eval_batches(len(dataset), args.batch_size, rank, world)
        batching = dict(batch_sampler=[rows for rows, _ in order])
        n_real = [n for _, n in order]
    else:
        batching = dict(batch_size=args.batch_size, shuffle=False)
        n_real = None
    ncpu = os.cpu_count() or 1
    workers = min(4, ncpu - 1) if ncpu > 1 else 0
    loader = torch.utils.data.DataLoader(
        dataset, **batching, num_workers=workers,
        pin_memory=device.type == "cuda",
        multiprocessing_context="spawn" if workers else None,
        worker_init_fn=(functools.partial(_init_loader_worker, workers=workers)
                        if workers else None))

    use_cache = args.feature_cache == "on" or (
        args.feature_cache == "auto" and args.batch_size == 1)
    with maybe_enable_nan_debugging(model, args.debug_nans):
        run_depth(model, loader, args.outdir, device,
                  feature_cache=use_cache,
                  feature_cache_views=args.feature_cache_views,
                  result_wire=args.result_wire, n_real=n_real)
    if parallel:
        print(f"rank {rank}: wrote {sum(n_real)} of {len(dataset)} maps")
    return parallel


def fuse_once(fuse, device, parallel: bool):
    """Fusion after an eval that every rank of the group ran: rank 0
    alone calls `fuse` and returns its result. In a data-parallel eval
    the ranks first meet at one barrier, which each reaches once its
    maps are written, so that rank 0 reads them all; the other ranks
    then return None without waiting for the fusion."""
    if parallel:
        mesh.barrier(device)
    return fuse() if mesh.rank() == 0 else None


def run_fusion(args, img_wh) -> list[tuple[str, float]]:
    """`filter_depth` on every scan of this shard, on `args.device`, with
    eval.py's paths and per-scan geo_mask_thres. Returns (scan, seconds)."""
    device = resolve_device(args.device)
    shard = parse_scan_shard(args.scan_shard)

    def fuse(scan_folder, out_folder, ply, geo_mask_thres):
        _, secs = filter_depth(scan_folder, out_folder, ply, args.geo_pixel_thres,
                               args.geo_depth_thres, args.photo_thres, img_wh,
                               geo_mask_thres, display=args.display, device=device)
        return secs

    timings = []
    if args.dataset == "dtu_yao_eval":
        with open(args.testlist) as f:
            scans = [line.rstrip() for line in f if line.strip()]
        for scan in shard_scans(scans, shard):
            secs = fuse(os.path.join(args.testpath, scan),
                        os.path.join(args.outdir, scan),
                        os.path.join(args.outdir, f"itermvs{int(scan[4:]):0>3}_l3.ply"), 4)
            timings.append((scan, secs))
    elif args.dataset == "tanks":
        table = (TANKS_INTERMEDIATE_THRES if args.split == "intermediate"
                 else TANKS_ADVANCED_THRES)
        for scan, gm in shard_scans(table.items(), shard):
            secs = fuse(os.path.join(args.testpath, args.split, scan),
                        os.path.join(args.outdir, scan),
                        os.path.join(args.outdir, scan + ".ply"), gm)
            timings.append((scan, secs))
    elif args.dataset == "eth3d":
        table = ETH3D_TEST_THRES if args.split == "test" else ETH3D_TRAIN_THRES
        for scan, gm in shard_scans(table.items(), shard):
            secs = fuse(os.path.join(args.testpath, scan),
                        os.path.join(args.outdir, scan),
                        os.path.join(args.outdir, scan + ".ply"), gm)
            print(f"scan: {scan} time = {secs:3f}")
            timings.append((scan, secs))
    elif shard is None or shard[0] == 0:
        # The single-scan custom dataset belongs to shard 0.
        secs = fuse(args.testpath, args.outdir,
                    os.path.join(args.outdir, "custom.ply"), 3)
        timings.append(("custom", secs))
    if timings:
        mean = sum(s for _, s in timings) / len(timings)
        print(f"fusion: {len(timings)} scan(s), mean {mean:.2f} sec/scene")
    return timings


def main(argv=None):
    args = parser.parse_args(argv)
    print("argv:", sys.argv[1:] if argv is None else argv)
    for k, v in sorted(vars(args).items()):
        print(f"{k}: {v}")
    img_wh = resolve_img_wh(args)
    owned = not mesh.is_initialized()
    try:
        parallel = save_depth(args, img_wh)
        fuse_once(lambda: run_fusion(args, img_wh), resolve_device(args.device), parallel)
    finally:
        if owned and mesh.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
