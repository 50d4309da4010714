"""KITTI 2015 submission writer.

    python -m temporalstereo_tpu_torch.cli.kitti_submission \\
        --config-file configs/kitti2015-multi.yaml [--checkpoint W.ckpt] \\
        [--output-dir OUT] [--device cuda] [KEY VALUE ...]

Counterpart of the JAX package's ``cli/kitti_submission.py``: every sample
of the ``DATA.TEST`` split runs its whole temporal window through
``multi_frame_forward(train=False)``, and its full-resolution disparity is
written as a uint16 PNG (disparity * 256) named after the sample's frame-0
left image.  Where the sample has a ground truth, the 3-pixel error at the
ground truth's resolution is printed (the estimate resized with the
align-corners ``transforms.resize_disparity``), then the average.  Each
line also gives the sample's time around a synchronised forward.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--checkpoint", default="",
                   help=".ckpt/.pth/.pt state_dict in the reference layout")
    p.add_argument("--output-dir", default="./kitti_submission/disp_0")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from ..config import get_cfg
    from ..data import batch_to_device, build_stereo_dataset, collate
    from ..data.evaluation import calc_error
    from ..data.formats import write_kitti_disp
    from ..data.transforms import resize_disparity
    from ..models import build_model, multi_frame_forward, resolve_device
    from ..utils.checkpoint import load_weights

    device = resolve_device(args.device)
    cfg = get_cfg(args.config_file, args.opts)
    model = build_model(cfg, device=device)
    dataset = build_stereo_dataset(cfg.DATA.TEST, "test")
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"error: checkpoint not found: {args.checkpoint}")
        n = load_weights(model, args.checkpoint)
        print(f"loaded {n} tensors from {args.checkpoint}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    os.makedirs(args.output_dir, exist_ok=True)
    stats3 = []
    for idx in range(len(dataset)):
        batch = collate([dataset[idx]])
        inputs = batch_to_device(batch, device)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            outputs, _ = multi_frame_forward(model, inputs, train=False)
        disp_t = outputs["disps"][0]
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        disp = disp_t[0, :, :, 0].float().cpu().numpy()
        name = os.path.basename(dataset.data_list[idx]["0"]["left_image_path"])
        write_kitti_disp(os.path.join(args.output_dir, name), disp)

        msg = f"[{idx + 1}/{len(dataset)}] {name}: {ms:.1f} ms"
        gt = batch["disp_gt"][-1][0, :, :, 0]
        if np.abs(gt).max() > 0:
            est = disp if disp.shape == gt.shape else resize_disparity(
                disp, gt.shape)
            p3 = float(calc_error(torch.from_numpy(est), torch.from_numpy(gt),
                                  lb=0, ub=192)["3px"])
            stats3.append(p3)
            msg += f"  3PE={p3:.3f}%"
        print(msg, flush=True)
    if stats3:
        print(f"average 3PE: {np.mean(stats3):.4f}%")


if __name__ == "__main__":
    main()
