"""Predict depth maps with the PyTorch port (the port of eval.py::save_depth).

    python -m itermvs_tpu_torch.eval --dataset=custom --testpath=SCENE \\
        --n_views 5 --img_wh 640 480 --outdir=OUT [--device cpu]

Writes `OUT/{depth_est,confidence}/<view:08d>.pfm` per reference view.
Flags keep the names and defaults of the JAX eval.py for everything
`save_depth` reads; `--device` (default `cuda`) is the port's own, and a
missing card is an error, not a silent run on the CPU. Fusion
(`run_fusion`) is not ported yet.

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
from itermvs_tpu_torch.io import save_pfm
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

parser = argparse.ArgumentParser(description="Predict depth (PyTorch port)")
parser.add_argument("--dataset", default="dtu_yao_eval",
                    choices=["dtu_yao_eval", "custom"], help="select dataset")
parser.add_argument("--testpath", help="testing data path")
parser.add_argument("--testlist", help="testing scan list")
parser.add_argument("--batch_size", type=int, default=1, help="testing batch size")
parser.add_argument("--n_views", type=int, default=5, help="num of view")
parser.add_argument("--img_wh", nargs="+", type=int, default=None,
                    help="width and height of the image")
parser.add_argument("--loadckpt", default=None,
                    help="vendored .npz weights (default: checkpoints/dtu)")
parser.add_argument("--outdir", default="./outputs", help="output dir")
parser.add_argument("--iteration", type=int, default=4, help="num of iteration of GRU")
parser.add_argument("--precision", default="float32", choices=["float32"],
                    help="compute precision (bfloat16 is not ported yet)")
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
parser.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")


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
    return (args.img_wh[0], args.img_wh[1])


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
    return dataset_cls(args.testpath, args.n_views, img_wh,
                       uint8_level0=args.input_uint8)


def quantize_results(depths: torch.Tensor, confs: torch.Tensor):
    """uint16 result wire, device side: [B,H,W,1] f32 depth + confidence →
    (depth_q uint16, lo [B], hi [B], conf_q uint16).

    Each depth map is quantized against its own [min, max]; confidence
    (a sigmoid in [0, 1]) uses the fixed 1/65535 grid. Round-to-nearest
    error is at most span/131070 in depth and 7.7e-6 in confidence."""
    d = depths[..., 0]
    c = confs[..., 0]
    lo = d.amin(dim=(1, 2))
    hi = d.amax(dim=(1, 2))
    span = torch.clamp(hi - lo, min=1e-6)[:, None, None]
    depth_q = torch.clamp(torch.round((d - lo[:, None, None]) * (65535.0 / span)),
                          0, 65535).to(torch.uint16)
    conf_q = torch.clamp(torch.round(c * 65535.0), 0, 65535).to(torch.uint16)
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
        save_pfm(path, image.astype(np.float32))


def run_depth(model: Pipeline, samples, outdir: str, device, *,
              feature_cache: bool = True, feature_cache_views: int = 16,
              result_wire: str = "uint16", log=print) -> list[float]:
    """Depth + confidence PFMs for every batch of `samples`.

    `samples` yields dicts in the loader's batched layout (arrays or
    tensors with a leading batch axis; `filename` a list of templates).
    With `feature_cache`, batch-1 samples carrying `scan` and `view_ids`
    run FeatureNet once per (scan, view), LRU-bounded to
    `feature_cache_views` views; outputs equal the uncached forward.
    Returns the wall seconds of each batch (the first includes warm-up).
    """
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

    with ThreadPoolExecutor(max_workers=2) as writer, torch.inference_mode():
        futures = []
        for batch_idx, sample in enumerate(samples):
            start = time.perf_counter()
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
            if result_wire == "uint16":
                wire = [x.cpu().numpy() for x in quantize_results(depths, confs)]
                depths, confs = dequantize_results(*wire)
            else:
                depths = depths[..., 0].cpu().numpy()
                confs = confs[..., 0].cpu().numpy()
            batch_secs.append(time.perf_counter() - start)
            log(f"Iter {batch_idx}/{total}, time = {batch_secs[-1]:.3f}")
            for filename, depth_est, confidence in zip(sample["filename"], depths, confs):
                futures.append(writer.submit(_write_outputs, outdir, filename,
                                             depth_est, confidence))
        for fut in futures:
            fut.result()
    return batch_secs


def _init_loader_worker(worker_id, workers):
    split_decode_cache_cap(workers)


def save_depth(args, img_wh) -> list[float]:
    """Load the dataset and weights and run `run_depth` on `args.device`."""
    device = resolve_device(args.device)
    if args.feature_cache == "on" and args.batch_size != 1:
        raise SystemExit("--feature_cache on requires --batch_size 1")
    path = args.loadckpt or pretrained_path("dtu")
    if not path.endswith(".npz"):
        raise SystemExit(f"--loadckpt {path}: the port reads the vendored "
                         ".npz weights (checkpoints/*/model_000015.npz)")
    dataset = build_dataset(args, img_wh)
    ncpu = os.cpu_count() or 1
    workers = min(4, ncpu - 1) if ncpu > 1 else 0
    loader = torch.utils.data.DataLoader(
        dataset, batch_size=args.batch_size, shuffle=False, num_workers=workers,
        multiprocessing_context="spawn" if workers else None,
        worker_init_fn=(functools.partial(_init_loader_worker, workers=workers)
                        if workers else None))

    print(f"loading model {path}")
    model = load_npz_weights(Pipeline(iteration=args.iteration), path).to(device)
    use_cache = args.feature_cache == "on" or (
        args.feature_cache == "auto" and args.batch_size == 1)
    return run_depth(model, loader, args.outdir, device,
                     feature_cache=use_cache,
                     feature_cache_views=args.feature_cache_views,
                     result_wire=args.result_wire)


def main(argv=None):
    args = parser.parse_args(argv)
    print("argv:", sys.argv[1:] if argv is None else argv)
    for k, v in sorted(vars(args).items()):
        print(f"{k}: {v}")
    return save_depth(args, resolve_img_wh(args))


if __name__ == "__main__":
    main()
