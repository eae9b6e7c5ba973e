"""DTU evaluation loader (copy of itermvs_tpu/data/dtu_eval.py).

Layout: <scan>/pair.txt, <scan>/images/{v:08d}.jpg,
<scan>/cams_1/{v:08d}_cam.txt. Images are resized to img_wh
(1600×1152); intrinsics in the files are at the 1600×1200 capture
resolution and scale by img_wh/(1600, 1200).
"""
from __future__ import annotations

import os

import numpy as np

from itermvs_tpu_torch.data.base import (
    MVSDatasetBase, cached_image_pyramid, proj_matrix_pyramid, stack_views,
)


class MVSDataset(MVSDatasetBase):
    def __init__(self, datapath, listfile, nviews=5, img_wh=(1600, 1152),
                 uint8_level0=False):
        self.uint8_level0 = uint8_level0
        self.datapath = datapath
        self.listfile = listfile
        self.nviews = nviews
        self.img_wh = img_wh
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        with open(self.listfile) as f:
            scans = [line.rstrip() for line in f if line.strip()]
        for scan in scans:
            pairs = self.read_pair_list(os.path.join(self.datapath, scan, "pair.txt"))
            for ref_view, src_views in pairs:
                metas.append((scan, ref_view, src_views))
        print("dataset", "metas:", len(metas))
        return metas

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[:self.nviews - 1]
        full_w, full_h = 1600, 1200      # DTU capture resolution

        imgs, projs = [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, scan, f"images/{vid:0>8}.jpg")
            cam_path = os.path.join(self.datapath, scan, f"cams_1/{vid:0>8}_cam.txt")
            pyr, _ = cached_image_pyramid(img_path, self.img_wh,
                                          uint8_level0=self.uint8_level0)
            imgs.append(pyr)

            intrinsics, extrinsics, dmin, dmax = self.read_cam(cam_path)
            intrinsics = intrinsics.copy()
            intrinsics[0] *= self.img_wh[0] / full_w
            intrinsics[1] *= self.img_wh[1] / full_h
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
