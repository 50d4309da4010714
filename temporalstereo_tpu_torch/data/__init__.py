"""File formats and transforms of the port's inference CLI (numpy)."""
from .formats import (load_disparity, load_image, load_pfm, load_pose_file,
                      load_tartanair_pose_file, sniff_pose_format,
                      tartanair_pose_to_matrix, write_kitti_disp)
from .png import read_png, write_png
from .transforms import normalize, resize_disparity, resize_image

__all__ = ["load_disparity", "load_image", "load_pfm", "load_pose_file",
           "load_tartanair_pose_file", "normalize", "read_png",
           "resize_disparity", "resize_image", "sniff_pose_format",
           "tartanair_pose_to_matrix", "write_kitti_disp", "write_png"]
