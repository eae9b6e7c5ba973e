from itermvs_tpu_torch.io.cams import read_cam_file, read_camera_parameters
from itermvs_tpu_torch.io.pair import read_pair_file
from itermvs_tpu_torch.io.pfm import read_pfm, save_pfm
from itermvs_tpu_torch.io.ply import PlyWriter, read_ply, write_ply
from itermvs_tpu_torch.io.png import write_png

__all__ = ["read_pfm", "save_pfm", "read_cam_file", "read_camera_parameters",
           "read_pair_file", "PlyWriter", "read_ply", "write_ply", "write_png"]
