"""Depth-map fusion: photometric + geometric filtering -> coloured point
cloud (port of itermvs_tpu/fusion.py).

Per reference view, kernel K3 `fusion_consistency` (ops/consistency.py)
projects every reference pixel into each source view, samples the source
depth bilinearly (zeros outside), reprojects, tests the pixel distance and
the relative depth difference, and averages the consistent depths; the
map is then rounded to uint16 against its own range on the device. The
host keeps the tail: mask PNGs, the colour decode, the back-projection
and the PLY appends.

`fuse_views` is the core loop. It takes any object with the methods of
`SceneFiles` (camera + depth, confidence, image per view id) and a pair
list; `filter_depth` is the thin reader around it that fusion of an eval
output directory uses. Source depth maps stay on the device in an LRU
sized to the scan's source count, so each is uploaded once per scan.
Outputs are those of the JAX fusion: `<out>/mask/<v>_{photo,geo,final}.png`,
`<out>/display/*.png` with `display`, and the PLY.

The JAX package pads the source axis to a few bucket sizes to bound XLA
recompiles; the port passes the real source count (the padded slots are
masked out there, so the results are the same).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from itermvs_tpu_torch.io import (
    PlyWriter, read_camera_parameters, read_pair_file, read_pfm, write_png)
from itermvs_tpu_torch.ops.consistency import consistency, quantize_depth


class SceneFiles:
    """A scan's fusion inputs on disk: `<scan>/cams_1/<v>_cam.txt`,
    `<scan>/images/<v>.jpg` (PIL reads the size, cv2 decodes) and
    `<out>/{depth_est,confidence}/<v>.pfm`."""

    def __init__(self, scan_folder, out_folder, img_wh):
        self.scan_folder = scan_folder
        self.out_folder = out_folder
        self.img_wh = img_wh

    def _image_path(self, vid):
        return os.path.join(self.scan_folder, f"images/{vid:0>8}.jpg")

    def view(self, vid):
        """dict(K [3,3] rescaled to img_wh, E [4,4], depth [H,W]).

        Intrinsics are rescaled by this view's own original image size;
        only the JPEG header is read for it."""
        from PIL import Image

        intr, extr = read_camera_parameters(
            os.path.join(self.scan_folder, f"cams_1/{vid:0>8}_cam.txt"))
        ow, oh = Image.open(self._image_path(vid)).size
        intr = intr.copy()
        intr[0] *= self.img_wh[0] / ow
        intr[1] *= self.img_wh[1] / oh
        depth = read_pfm(
            os.path.join(self.out_folder, f"depth_est/{vid:0>8}.pfm"))[0][..., 0]
        return dict(K=intr, E=extr, depth=depth)

    def confidence(self, vid):
        return read_pfm(
            os.path.join(self.out_folder, f"confidence/{vid:0>8}.pfm"))[0][..., 0]

    def image(self, vid):
        """RGB [H,W,3] float32 in [0,1] at img_wh."""
        import cv2

        img = cv2.cvtColor(cv2.imread(self._image_path(vid)), cv2.COLOR_BGR2RGB)
        return cv2.resize(img.astype(np.float32) / 255.0, self.img_wh,
                          interpolation=cv2.INTER_LINEAR)


class MemoryViews:
    """In-memory fusion inputs: `views[vid]` = dict(K [3,3] at the maps'
    size, E [4,4], depth [H,W], confidence [H,W], image [H,W,3] RGB in
    [0,1]), all numpy."""

    def __init__(self, views):
        self.views = views

    def view(self, vid):
        v = self.views[vid]
        return dict(K=v["K"], E=v["E"], depth=v["depth"])

    def confidence(self, vid):
        return self.views[vid]["confidence"]

    def image(self, vid):
        return self.views[vid]["image"]


class _ViewCache:
    """LRU of decoded views (camera + depth), the depth also as a device
    tensor: a view serves as a source for ~10 reference views (DTU pair
    topology), so each depth map is uploaded once, and peak memory stays
    O(source count), not O(scan)."""

    def __init__(self, views, maxsize, device):
        self.views = views
        self.maxsize = maxsize
        self.device = device
        self._cache = collections.OrderedDict()

    def view(self, vid):
        if vid in self._cache:
            self._cache.move_to_end(vid)
            return self._cache[vid]
        entry = dict(self.views.view(vid))
        entry["depth_dev"] = torch.from_numpy(
            np.ascontiguousarray(entry["depth"], np.float32)).to(self.device)
        self._cache[vid] = entry
        while len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
        return entry


def _save_mask(path, mask):
    write_png(path, mask.astype(np.uint8) * 255)


def _save_display(out_folder, ref_view, ref_img, ref_depth, photo_mask,
                  geo_mask, final_mask):
    """The reference's cv2.imshow panel as five PNGs under
    <out_folder>/display/."""
    disp = os.path.join(out_folder, "display")
    os.makedirs(disp, exist_ok=True)
    scale = max(float(ref_depth.max()), 1e-6)

    def gray(name, x):
        write_png(os.path.join(disp, f"{ref_view:0>8}_{name}.png"),
                  np.clip(x / scale * 255.0, 0, 255).astype(np.uint8))

    write_png(os.path.join(disp, f"{ref_view:0>8}_ref_img.png"),
              (np.clip(ref_img, 0, 1) * 255).astype(np.uint8))
    gray("ref_depth", ref_depth)
    gray("depth_photo_mask", ref_depth * photo_mask)
    gray("depth_geo_mask", ref_depth * geo_mask)
    gray("depth_final_mask", ref_depth * final_mask)


def consistency_matrices(k_ref, e_ref, k_srcs, e_srcs):
    """The camera arguments of `ops.consistency.consistency` for one
    reference view and its sources: (E_src E_ref^-1 [S,4,4], E_ref
    E_src^-1 [S,4,4], K_ref, K_ref^-1, K_src [S,3,3], K_src^-1 [S,3,3]),
    inverses and products in f64, cast to f32, on the CPU."""
    def f32(mats, shape):
        return torch.from_numpy(np.array(mats, np.float64).reshape(-1, *shape)
                                .astype(np.float32))

    e_ref = np.asarray(e_ref, np.float64)
    e_ref_inv = np.linalg.inv(e_ref)
    e_srcs = [np.asarray(e, np.float64) for e in e_srcs]
    k_ref = np.asarray(k_ref, np.float64)
    return (f32([e @ e_ref_inv for e in e_srcs], (4, 4)),
            f32([e_ref @ np.linalg.inv(e) for e in e_srcs], (4, 4)),
            f32(k_ref, (3, 3))[0], f32(np.linalg.inv(k_ref), (3, 3))[0],
            f32(list(k_srcs), (3, 3)),
            f32([np.linalg.inv(np.asarray(k, np.float64)) for k in k_srcs], (3, 3)))


def fuse_views(views, pair_data, out_folder, plyfilename, geo_pixel_thres=1.0,
               geo_depth_thres=0.01, photo_thres=0.3, geo_mask_thres=3,
               verbose=True, display=False, finalize_workers=None,
               device="cuda", label=None):
    """Fuse the depth maps of `views` (see `SceneFiles`) into a coloured
    PLY, reference views and their sources as in `pair_data`
    ([(ref, [src, ...]), ...]).

    The main thread does the host prep, the K3 launch and the start of the
    device->host copies of view i+1 before it waits for view i's results;
    each view's host tail (mask PNGs, colour decode, back-projection, PLY
    append) runs on a `finalize_workers` pool (default min(4, cpu
    count)). PLY appends are serialised by a lock, so the vertex order of
    the cloud depends on thread timing; no consumer depends on it.

    Set ITERMVS_FUSION_TIMING=1 to print the per-phase summary.

    Returns (n_points, elapsed_seconds, {phase: thread-seconds}).
    """
    if finalize_workers is None:
        finalize_workers = max(1, min(4, os.cpu_count() or 1))
    device = torch.device(device)
    label = out_folder if label is None else label
    start = time.time()
    max_srcs = max((len(srcs) for _, srcs in pair_data), default=0)
    cache = _ViewCache(views, max(max_srcs + 2, 12), device)

    os.makedirs(os.path.join(out_folder, "mask"), exist_ok=True)
    ply = PlyWriter(plyfilename)
    ply_lock = threading.Lock()
    grids = {}
    phases = collections.defaultdict(float)
    phases_lock = threading.Lock()

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        with phases_lock:
            phases[phase] += dt
        return out

    def dispatch(ref_view, src_views):
        """Host prep, K3 launch and async result copies for one reference
        view (main thread only: the LRU is not thread-safe)."""
        ref = cache.view(ref_view)
        conf = torch.from_numpy(np.ascontiguousarray(
            views.confidence(ref_view), np.float32)).to(device)
        srcs = [cache.view(v) for v in src_views]
        h, w = ref["depth_dev"].shape
        if (h, w) not in grids:     # flat pixel grids, shared by the tails
            grids[(h, w)] = (np.tile(np.arange(w, dtype=np.float32), h),
                             np.repeat(np.arange(h, dtype=np.float32), w))
        src_depths = (torch.stack([v["depth_dev"] for v in srcs]) if srcs else
                      torch.empty((0, h, w), dtype=torch.float32, device=device))
        depth_avg, bits = consistency(
            ref["depth_dev"], conf, src_depths,
            *consistency_matrices(ref["K"], ref["E"], [v["K"] for v in srcs],
                                  [v["E"] for v in srcs]),
            geo_pixel_thres=float(geo_pixel_thres),
            geo_depth_thres=float(geo_depth_thres),
            photo_thres=float(photo_thres), geo_mask_thres=int(geo_mask_thres))
        depth_q, lo, hi = quantize_depth(depth_avg)
        out = (depth_q, torch.stack([lo, hi]), bits)
        done = None
        if device.type == "cuda":
            # Copies into pinned memory start now and overlap the next
            # view's host prep; `fetch` waits on the event.
            out = tuple(t.to("cpu", non_blocking=True) for t in out)
            done = torch.cuda.Event()
            done.record()
        return ref_view, ref, out, done

    def fetch(out, done):
        """Wait for one view's results (main thread)."""
        if done is not None:
            timed("fetch", done.synchronize)
        depth_q, lohi, bits = (t.numpy() for t in out)
        return depth_q, float(lohi[0]), float(lohi[1]), bits

    def finalize(ref_view, ref, depth_q, lo, hi, bits):
        """One view's host tail; touches only thread-safe state."""
        photo_mask = (bits & 1) > 0
        geo_mask = (bits & 2) > 0
        final_mask = (bits & 4) > 0
        ref_img = timed("image_decode", views.image, ref_view)
        for name, mask in (("photo", photo_mask), ("geo", geo_mask),
                           ("final", final_mask)):
            timed("mask_png", _save_mask,
                  os.path.join(out_folder, f"mask/{ref_view:0>8}_{name}.png"), mask)
        if verbose:
            print(
                f"processing {label}, ref-view{ref_view:0>2}, "
                f"geo_mask:{geo_mask.mean():3f} photo_mask:{photo_mask.mean():3f} "
                f"final_mask: {final_mask.mean():3f}")
        if display:
            _save_display(out_folder, ref_view, ref_img, ref["depth"],
                          photo_mask, geo_mask, final_mask)

        def backproject():
            # Matrix inverses in f64, bulk math in f32 (as the JAX tail):
            # the linear maps keep relative error, ~1e-7 of the depth.
            grid_x, grid_y = grids[depth_q.shape]
            idx = np.flatnonzero(final_mask.ravel())
            step = np.float32((hi - lo) / 65535.0)
            depth = (np.float32(lo)
                     + depth_q.ravel().take(idx).astype(np.float32) * step)
            pix = np.empty((idx.size, 3), np.float32)
            np.multiply(grid_x.take(idx), depth, out=pix[:, 0])
            np.multiply(grid_y.take(idx), depth, out=pix[:, 1])
            pix[:, 2] = depth
            k_inv = np.linalg.inv(ref["K"].astype(np.float64))
            e_inv = np.linalg.inv(ref["E"].astype(np.float64))
            m = (e_inv[:3, :3] @ k_inv).astype(np.float32)         # pixel->world
            xyz_world = pix @ m.T + e_inv[:3, 3].astype(np.float32)
            colors = (ref_img.reshape(-1, 3).take(idx, axis=0)
                      * np.float32(255)).astype(np.uint8)
            return xyz_world, colors

        xyz, colors = timed("backproject", backproject)
        with ply_lock:
            timed("ply_write", ply.add, xyz, colors)

    max_outstanding = max(2 * finalize_workers, 2)
    try:
        with ThreadPoolExecutor(max_workers=finalize_workers) as pool:
            futures = collections.deque()
            pending = None
            for ref_view, src_views in pair_data:
                launched = timed("dispatch", dispatch, ref_view, src_views)
                if pending is not None:
                    rv, ref, out, done = pending
                    futures.append(pool.submit(finalize, rv, ref, *fetch(out, done)))
                pending = launched
                while len(futures) >= max_outstanding:
                    futures.popleft().result()
            if pending is not None:
                rv, ref, out, done = pending
                futures.append(pool.submit(finalize, rv, ref, *fetch(out, done)))
            while futures:
                futures.popleft().result()
    except BaseException:
        ply.close()   # patch the header so the partial PLY stays readable
        raise

    n_points = ply.close()
    elapsed = time.time() - start
    if os.environ.get("ITERMVS_FUSION_TIMING"):
        total = sum(phases.values())
        detail = " ".join(f"{k}={v:.2f}s" for k, v in
                          sorted(phases.items(), key=lambda kv: -kv[1]))
        print(f"fusion timing (thread-seconds, wall {elapsed:.2f}s, "
              f"sum {total:.2f}s): {detail}")
    print(f"saving the final model to {plyfilename} "
          f"({n_points} points, {elapsed:.2f}s)")
    return n_points, elapsed, dict(phases)


def filter_depth(scan_folder, out_folder, plyfilename, geo_pixel_thres=1.0,
                 geo_depth_thres=0.01, photo_thres=0.3, img_wh=(1600, 1152),
                 geo_mask_thres=3, verbose=True, display=False,
                 finalize_workers=None, device="cuda"):
    """Fuse one scan's depth maps into a coloured PLY (the JAX
    `filter_depth`, with `device`): reads `<scan>/pair.txt`, the cameras,
    images and the PFMs under `out_folder`, and runs `fuse_views`.

    Returns (n_points, elapsed_seconds)."""
    start = time.time()
    pair_data = read_pair_file(os.path.join(scan_folder, "pair.txt"))
    n_points, _, _ = fuse_views(
        SceneFiles(scan_folder, out_folder, img_wh), pair_data, out_folder,
        plyfilename, geo_pixel_thres, geo_depth_thres, photo_thres,
        geo_mask_thres, verbose=verbose, display=display,
        finalize_workers=finalize_workers, device=device, label=scan_folder)
    return n_points, time.time() - start
