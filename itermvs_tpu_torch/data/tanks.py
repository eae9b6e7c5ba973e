"""Tanks & Temples evaluation loader (copy of itermvs_tpu/data/tanks.py;
reference: datasets/tanks.py).

Hardcoded intermediate/advanced scan lists; images resized to img_wh
(1920×1024) with intrinsics rescaled by the resize ratio.
"""
from __future__ import annotations

import os

import numpy as np

from itermvs_tpu_torch.data.base import (
    MVSDatasetBase, cached_image_pyramid, proj_matrix_pyramid, stack_views,
)

INTERMEDIATE_SCANS = ["Family", "Francis", "Horse", "Lighthouse",
                      "M60", "Panther", "Playground", "Train"]
ADVANCED_SCANS = ["Auditorium", "Ballroom", "Courtroom",
                  "Museum", "Palace", "Temple"]


class MVSDataset(MVSDatasetBase):
    def __init__(self, datapath, n_views=7, img_wh=(1920, 1024),
                 split="intermediate", uint8_level0=False):
        self.uint8_level0 = uint8_level0
        self.datapath = datapath
        self.img_wh = img_wh
        self.split = split
        self.n_views = n_views
        self.scans = INTERMEDIATE_SCANS if split == "intermediate" else ADVANCED_SCANS
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        for scan in self.scans:
            pairs = self.read_pair_list(
                os.path.join(self.datapath, self.split, scan, "pair.txt"))
            for ref_view, src_views in pairs:
                metas.append((scan, ref_view, src_views))
        return metas

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[:self.n_views - 1]

        imgs, projs = [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, self.split, scan,
                                    f"images/{vid:08d}.jpg")
            cam_path = os.path.join(self.datapath, self.split, scan,
                                    f"cams_1/{vid:08d}_cam.txt")
            pyr, (ow, oh) = cached_image_pyramid(
                img_path, self.img_wh, uint8_level0=self.uint8_level0)
            imgs.append(pyr)

            intrinsics, extrinsics, dmin, dmax = self.read_cam(cam_path)
            intrinsics = intrinsics.copy()
            intrinsics[0] *= self.img_wh[0] / ow
            intrinsics[1] *= self.img_wh[1] / oh
            projs.append(proj_matrix_pyramid(intrinsics, extrinsics))
            if i == 0:
                depth_min, depth_max = dmin, dmax

        return {
            "imgs": stack_views(imgs),
            "proj_matrices": stack_views(projs),
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_max),
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
            "scan": scan,
            "view_ids": np.asarray(view_ids, dtype=np.int32),
        }
