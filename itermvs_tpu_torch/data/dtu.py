"""DTU training/validation loader (copy of itermvs_tpu/data/dtu.py).

Layout on disk:
    Cameras_1/pair.txt                            shared pair list
    Cameras_1/{scan}_train/{v:08d}_cam.txt        per-view cams (K at 1/4 res)
    Rectified/{scan}_train/rect_{v+1:03d}_{light}_r5000.png
    Depths_raw/{scan}/depth_map_{v:04d}.pfm + depth_visual_{v:04d}.png

Metas = scans × 49 viewpoints × 7 light conditions. Training applies
ColorJitter(0.5, 0.5) and the robust-train strategy: random source-view
subset + random geometric scale ∈ [0.8, 1.25] applied to the extrinsic
translation, depth range and GT depth (dtu_yao.py:126-134).

GT depth preparation: half-scale INTER_NEAREST then 640×512 center crop
(dtu_yao.py:80-91); masks threshold the depth_visual PNG > 10.
"""
from __future__ import annotations

import os

import numpy as np

from itermvs_tpu_torch.data.base import (
    MVSDatasetBase, image_pyramid, nearest_pyramid, proj_matrix_pyramid,
    stack_views, color_jitter,
)
from itermvs_tpu_torch.io import read_pfm


class MVSDataset(MVSDatasetBase):
    def __init__(self, datapath, listfile, mode, nviews, robust_train=False,
                 seed=None):
        assert mode in ("train", "val", "test")
        self.datapath = datapath
        self.listfile = listfile
        self.mode = mode
        self.nviews = nviews
        self.img_wh = (640, 512)
        self.robust_train = robust_train
        self.seed = 0 if seed is None else int(seed)
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        with open(self.listfile) as f:
            scans = [line.rstrip() for line in f if line.strip()]
        pair_path = os.path.join(self.datapath, "Cameras_1/pair.txt")
        pairs = self.read_pair_list(pair_path)
        for scan in scans:
            for ref_view, src_views in pairs:
                for light_idx in range(7):
                    metas.append((scan, light_idx, ref_view, src_views))
        print("dataset", self.mode, "metas:", len(metas))
        return metas

    def _read_img(self, path, rng):
        img = self.read_image(path)
        if self.mode == "train":
            img = color_jitter(img, rng)
        return image_pyramid(img, None)

    def _prepare_map(self, arr):
        """Half-scale INTER_NEAREST + center crop to 640×512."""
        import cv2

        h, w = arr.shape
        arr = cv2.resize(arr, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST)
        h, w = arr.shape
        th, tw = self.img_wh[1], self.img_wh[0]
        sh, sw = (h - th) // 2, (w - tw) // 2
        return arr[sh:sh + th, sw:sw + tw]

    def _read_depth_mask(self, depth_path, mask_path, scale):
        import cv2

        depth_hr = read_pfm(depth_path)[0][..., 0] * scale
        depth_lr = self._prepare_map(depth_hr)
        # Grayscale cv2 decode of the (grayscale) depth_visual PNG: same
        # pixel values as PIL on these files, ~3x faster on the 1600x1200
        # masks (measured 48 -> 15 ms; the loader is the e2e training
        # bottleneck on few-core hosts). Reference thresholds the same
        # way (dtu_yao.py:84).
        raw = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        if raw is None:
            # cv2.imread signals a missing/corrupt file by returning
            # None; surface a clear error instead of an AttributeError.
            raise FileNotFoundError(f"unreadable mask PNG: {mask_path}")
        mask = (raw.astype(np.float32) > 10).astype(np.float32)
        mask = self._prepare_map(mask)
        return nearest_pyramid(depth_lr), nearest_pyramid(mask)

    def __getitem__(self, idx):
        scan, light_idx, ref_view, src_views = self.metas[idx]
        rng = self.item_rng(idx)
        if self.robust_train:
            index = rng.choice(len(src_views), self.nviews - 1, replace=False)
            view_ids = [ref_view] + [src_views[i] for i in index]
            scale = float(rng.uniform(0.8, 1.25))
        else:
            view_ids = [ref_view] + src_views[:self.nviews - 1]
            scale = 1.0

        imgs = []
        projs = []
        depth = mask = None
        depth_min = depth_max = None

        for i, vid in enumerate(view_ids):
            img_path = os.path.join(
                self.datapath,
                f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light_idx}_r5000.png")
            cam_path = os.path.join(
                self.datapath, f"Cameras_1/{scan}_train/{vid:0>8}_cam.txt")

            imgs.append(self._read_img(img_path, rng))

            intrinsics, extrinsics, dmin, dmax = self.read_cam(cam_path)
            extrinsics = extrinsics.copy()
            extrinsics[:3, 3] *= scale
            # DTU cam files store K at 1/4 resolution (dtu_yao.py:167-168).
            intrinsics = intrinsics.copy()
            intrinsics[0] *= 4
            intrinsics[1] *= 4
            projs.append(proj_matrix_pyramid(intrinsics, extrinsics))

            if i == 0:
                depth_min = dmin * scale
                depth_max = dmax * scale
                depth_path = os.path.join(
                    self.datapath, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm")
                mask_path = os.path.join(
                    self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")
                depth, mask = self._read_depth_mask(depth_path, mask_path, scale)

        return {
            "imgs": stack_views(imgs),
            "proj_matrices": stack_views(projs),
            "depth": self.expand_map(depth),
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_max),
            "mask": self.expand_map(mask),
        }
