"""Qualitative demo over a configured dataset with the port.

    python -m temporalstereo_tpu_torch.cli.demo --config-file CFG.yaml \\
        [--checkpoint W.msgpack|W.pth|CKPT_DIR] [--output-dir ./demo_out] \\
        [--max-samples 10] [--device cuda] [KEY VALUE ...]

Counterpart of the JAX package's ``cli/demo.py``: iterates ``DATA.VAL``,
runs the temporal window (``multi_frame_forward``), saves a panel per
sample (input / disparity / error map, stacked, as ``demo_NNNN.png``) and
prints ``epe``/``3px`` at the ground truth's resolution where there is one.
The JAX CLI writes and resizes with Pillow; the port writes with its own
codec (``data/png.py``), and brings the 8-bit error map to the input's
size with ``data/transforms.py:resize_pil_bilinear`` (Pillow's bilinear
resample in numpy, rounded back to 8 bits), where Pillow's ``resize``
defaults to bicubic: the panel's error rows may differ from the JAX
CLI's by the filter, nothing else does.  The last line is ``demo summary:
{json}`` (samples, EPE and 3PE of each sample with a ground truth, ms per
sample around a synchronised forward, the kernels' launches).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--checkpoint", default="",
                   help="weights: .msgpack (JAX), .ckpt/.pth/.pt or a "
                        "checkpoint directory of the train CLI")
    p.add_argument("--output-dir", default="./demo_out")
    p.add_argument("--max-samples", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p


def fit_panel(errmap: np.ndarray, shape) -> np.ndarray:
    """The error map in [0, 1], quantised to 8 bits and resized to
    ``shape`` (h, w) as an 8-bit image is."""
    from ..data.transforms import resize_pil_bilinear

    q = (np.clip(errmap, 0, 1) * 255).astype(np.uint8).astype(np.float32)
    out = np.clip(np.round(resize_pil_bilinear(q, shape)), 0, 255)
    return out.astype(np.uint8) / 255.0


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)

    from ..config import get_cfg
    from ..data import batch_to_device, build_stereo_dataset, collate
    from ..data.evaluation import calc_error
    from ..data.png import write_png
    from ..data.transforms import denormalize, resize_disparity
    from ..kernels import LAUNCHES, reset_launches
    from ..models import build_model, multi_frame_forward, resolve_device
    from ..training import master_copies
    from ..training.checkpoint import load_any_weights
    from ..visualization import disp_err_to_colorbar, disp_to_color

    device = resolve_device(args.device)
    cfg = get_cfg(args.config_file, args.opts)
    model = build_model(cfg, device=device)
    dataset = build_stereo_dataset(cfg.DATA.VAL, "val")
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"error: checkpoint not found: {args.checkpoint}")
        params, stats, n = load_any_weights(*master_copies(model),
                                            args.checkpoint)
        model.load_state_dict({**params, **stats}, strict=False)
        print(f"loaded {n} tensors from {args.checkpoint}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    os.makedirs(args.output_dir, exist_ok=True)
    reset_launches()
    epes, p3s, secs = [], [], []
    for idx in range(min(args.max_samples, len(dataset))):
        batch = collate([dataset[idx]])
        inputs = batch_to_device(batch, device)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            outputs, _ = multi_frame_forward(model, inputs, train=False)
        disp = outputs["disps"][0][0, :, :, 0].float().cpu().numpy()
        secs.append(time.perf_counter() - t0)

        left = denormalize(batch["left"][-1][0])
        panels = [left, disp_to_color(disp)]
        gt = batch["disp_gt"][-1][0, :, :, 0]
        msg = f"sample {idx}"
        if np.abs(gt).max() > 0:
            est = disp if disp.shape == gt.shape else resize_disparity(
                disp, gt.shape)
            err = calc_error(torch.from_numpy(est), torch.from_numpy(gt),
                             lb=0, ub=192)
            epes.append(float(err["epe"]))
            p3s.append(float(err["3px"]))
            msg += f" epe={epes[-1]:.3f} 3px={p3s[-1]:.2f}%"
            errmap = disp_err_to_colorbar(est, gt)[: gt.shape[0]]
            if errmap.shape[1] != left.shape[1]:
                errmap = fit_panel(errmap, left.shape[:2])
            panels.append(errmap)
        panel = np.concatenate(panels, axis=0)
        write_png(os.path.join(args.output_dir, f"demo_{idx:04d}.png"),
                  (np.clip(panel, 0, 1) * 255).astype(np.uint8))
        print(msg, flush=True)

    summary = {"samples": len(secs), "epe": epes, "3px": p3s,
               "ms_per_sample": [round(1e3 * s, 3) for s in secs],
               "launches": dict(LAUNCHES)}
    print(f"demo summary: {json.dumps(summary)}", flush=True)
    return summary


if __name__ == "__main__":
    main()
