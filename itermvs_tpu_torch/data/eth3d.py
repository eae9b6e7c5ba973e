"""ETH3D high-res evaluation loader (copy of itermvs_tpu/data/eth3d.py;
reference: datasets/eth3d.py).

Hardcoded test/train scan lists; negative depth_min values clamp to 1
(eth3d.py:50-52); images resized to img_wh (1920×1280).
"""
from __future__ import annotations

import os

import numpy as np

from itermvs_tpu_torch.data.base import (
    MVSDatasetBase, cached_image_pyramid, proj_matrix_pyramid, stack_views,
)

TEST_SCANS = ["botanical_garden", "boulders", "bridge", "door",
              "exhibition_hall", "lecture_room", "living_room", "lounge",
              "observatory", "old_computer", "statue", "terrace_2"]
TRAIN_SCANS = ["courtyard", "delivery_area", "electro", "facade",
               "kicker", "meadow", "office", "pipes", "playground",
               "relief", "relief_2", "terrace", "terrains"]


class MVSDataset(MVSDatasetBase):
    def __init__(self, datapath, split="test", n_views=7, img_wh=(1920, 1280),
                 uint8_level0=False):
        self.uint8_level0 = uint8_level0
        self.datapath = datapath
        self.img_wh = img_wh
        self.split = split
        self.n_views = n_views
        self.scans = TEST_SCANS if split == "test" else TRAIN_SCANS
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        for scan in self.scans:
            pairs = self.read_pair_list(os.path.join(self.datapath, scan, "pair.txt"))
            for ref_view, src_views in pairs:
                metas.append((scan, ref_view, src_views))
        return metas

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[:self.n_views - 1]

        imgs, projs = [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, scan, f"images/{vid:08d}.jpg")
            cam_path = os.path.join(self.datapath, scan, f"cams_1/{vid:08d}_cam.txt")
            pyr, (ow, oh) = cached_image_pyramid(
                img_path, self.img_wh, uint8_level0=self.uint8_level0)
            imgs.append(pyr)

            intrinsics, extrinsics, dmin, dmax = self.read_cam(cam_path)
            if dmin < 0:
                dmin = 1.0
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
