"""The port's data path (numpy on the host): file formats, transforms,
datasets, the loader and the evaluation metrics."""
from .datasets.builder import build_dataloader, build_stereo_dataset
from .formats import (load_disparity, load_image, load_pfm, load_pose_file,
                      load_tartanair_pose_file, sniff_pose_format,
                      tartanair_pose_to_matrix, write_kitti_disp)
from .loader import DataLoader, batch_to_device, collate
from .png import read_png, write_png
from .transforms import normalize, resize_disparity, resize_image

__all__ = ["DataLoader", "batch_to_device", "build_dataloader",
           "build_stereo_dataset", "collate", "load_disparity", "load_image",
           "load_pfm", "load_pose_file", "load_tartanair_pose_file",
           "normalize", "read_png", "resize_disparity", "resize_image",
           "sniff_pose_format", "tartanair_pose_to_matrix",
           "write_kitti_disp", "write_png"]
