"""Custom-scene loader (copy of itermvs_tpu/data/custom.py).

Flat directory: pair.txt, images/{v:08d}.jpg, cams_1/{v:08d}_cam.txt.
Images are resized to img_wh with the intrinsics rescaled accordingly.
"""
from __future__ import annotations

import os

import numpy as np

from itermvs_tpu_torch.data.base import (
    MVSDatasetBase, cached_image_pyramid, proj_matrix_pyramid, stack_views,
)


class MVSDataset(MVSDatasetBase):
    def __init__(self, datapath, n_views=5, img_wh=(640, 480),
                 uint8_level0=False):
        self.datapath = datapath
        self.img_wh = img_wh
        self.n_views = n_views
        self.uint8_level0 = uint8_level0
        self.metas = list(self.read_pair_list(os.path.join(datapath, "pair.txt")))

    def __getitem__(self, idx):
        ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[:self.n_views - 1]

        imgs, projs = [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, f"images/{vid:08d}.jpg")
            cam_path = os.path.join(self.datapath, f"cams_1/{vid:08d}_cam.txt")
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
            "filename": "{}/" + f"{view_ids[0]:0>8}" + "{}",
            "scan": "custom",
            "view_ids": np.asarray(view_ids, dtype=np.int32),
        }
