"""BlendedMVS train/val loader (copy of itermvs_tpu/data/blendedmvs.py).

Layout: <scan>/blended_images/{v:08d}.jpg, <scan>/rendered_depth_maps/
{v:08d}.pfm, <scan>/cams/{v:08d}_cam.txt + cams/pair.txt. Per-scan
depth rescaling `scale_factor = 100/depth_min` is applied to extrinsic
translation, depth range and GT (blendedmvs.py:55-60); GT mask = depth
within [dmin, dmax]; metas require ≥ nviews−1 sources.
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
    def __init__(self, datapath, listfile, split, nviews, img_wh=(768, 576),
                 robust_train=True, seed=None):
        assert split in ("train", "val", "all")
        assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0, \
            "img_wh must both be multiples of 32!"
        self.datapath = datapath
        self.listfile = listfile
        self.split = split
        self.nviews = nviews
        self.img_wh = img_wh
        self.robust_train = robust_train
        self.seed = 0 if seed is None else int(seed)
        self.scale_factors: dict[str, float] = {}
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        self._first_ref: dict[str, int] = {}
        with open(self.listfile) as f:
            scans = [line.rstrip() for line in f if line.strip()]
        for scan in scans:
            pairs = self.read_pair_list(
                os.path.join(self.datapath, scan, "cams/pair.txt"))
            for ref_view, src_views in pairs:
                if len(src_views) >= self.nviews - 1:
                    metas.append((scan, ref_view, src_views))
                    self._first_ref.setdefault(scan, ref_view)
        return metas

    def _scale_factor(self, scan):
        """Per-scan depth normalization `100/depth_min` (blendedmvs.py:55-60).

        The reference derives it from whichever view of the scan is read
        first, which is loader-order dependent; here it is pinned to the
        scan's first pair-list ref view so concurrent worker threads see
        one deterministic value (dict writes of the same value are benign).
        """
        factor = self.scale_factors.get(scan)
        if factor is None:
            cam_path = os.path.join(
                self.datapath, scan, f"cams/{self._first_ref[scan]:0>8}_cam.txt")
            _, _, dmin, _ = self.read_cam(cam_path)
            factor = 100.0 / dmin
            self.scale_factors[scan] = factor
        return factor

    def _read_cam(self, scan, path):
        intrinsics, extrinsics, dmin, dmax = self.read_cam(path)
        factor = self._scale_factor(scan)
        extrinsics = extrinsics.copy()
        extrinsics[:3, 3] *= factor
        return intrinsics.copy(), extrinsics, dmin * factor, dmax * factor

    def _read_depth_mask(self, scan, path, depth_min, depth_max, scale):
        import cv2

        depth = read_pfm(path)[0][..., 0] * self.scale_factors[scan] * scale
        mask = ((depth >= depth_min) & (depth <= depth_max)).astype(np.float32)
        depth = cv2.resize(depth, self.img_wh, interpolation=cv2.INTER_NEAREST)
        # Reference computes the mask at native res and pyramids it
        # alongside the resized depth (blendedmvs.py:67-78).
        mask = cv2.resize(mask, self.img_wh, interpolation=cv2.INTER_NEAREST)
        return nearest_pyramid(depth), nearest_pyramid(mask)

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        rng = self.item_rng(idx)
        if self.robust_train:
            index = rng.choice(len(src_views), self.nviews - 1, replace=False)
            view_ids = [ref_view] + [src_views[i] for i in index]
            scale = float(rng.uniform(0.8, 1.25))
        else:
            view_ids = [ref_view] + src_views[:self.nviews - 1]
            scale = 1.0

        imgs, projs = [], []
        depth = mask = None
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, scan,
                                    f"blended_images/{vid:0>8}.jpg")
            cam_path = os.path.join(self.datapath, scan, f"cams/{vid:0>8}_cam.txt")

            img = self.read_image(img_path)
            if self.split == "train":
                img = color_jitter(img, rng)
            imgs.append(image_pyramid(img, self.img_wh))

            intrinsics, extrinsics, dmin, dmax = self._read_cam(scan, cam_path)
            extrinsics[:3, 3] *= scale
            projs.append(proj_matrix_pyramid(intrinsics, extrinsics))

            if i == 0:
                depth_min = dmin * scale
                depth_max = dmax * scale
                depth_path = os.path.join(
                    self.datapath, scan, f"rendered_depth_maps/{vid:0>8}.pfm")
                depth, mask = self._read_depth_mask(
                    scan, depth_path, depth_min, depth_max, scale)

        return {
            "imgs": stack_views(imgs),
            "proj_matrices": stack_views(projs),
            "depth": self.expand_map(depth),
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_max),
            "mask": self.expand_map(mask),
        }
