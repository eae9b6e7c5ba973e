from itermvs_tpu_torch.io.cams import read_cam_file
from itermvs_tpu_torch.io.pair import read_pair_file
from itermvs_tpu_torch.io.pfm import read_pfm, save_pfm

__all__ = ["read_pfm", "save_pfm", "read_cam_file", "read_pair_file"]
