"""Streaming stereo-video inference with the port.

    python -m temporalstereo_tpu_torch.cli.video_inference \\
        --config-file configs/kitti2015-multi.yaml --data-root SEQ \\
        --log-dir OUT [--checkpoint W.ckpt] [--fold-bn] [--bf16-params] \\
        [--export-bundle B.json | --load-bundle B.json] [--device cuda]
        [--target-fps 30 --streams 4 --latency-model TABLE.json]

Counterpart of the JAX package's ``cli/video_inference.py``: frame by frame
over ``SEQ/left/*.png`` and ``SEQ/right/*.png``, carrying the temporal state,
with poses from ``SEQ/pose_left.txt`` (ORB-SLAM3/KITTI matrix rows or
TartanAir quaternions) and, where ``SEQ/disp_gt/<stem>.{png,pfm,npy}``
exists, the EPE and 3-pixel error at the ground truth's resolution.  Writes
``{stem}.png`` (uint16, disparity * 256), ``{stem}_color.png`` and
``error.txt``; prints each frame's time around a synchronised step.

Without a bundle flag each frame runs ``streaming_step`` eagerly (with
``--no-exact-growth`` from a duplicate-filled full local map).
``--export-bundle`` writes the serving bundle (``serving.py``) and runs
from it; ``--load-bundle`` runs from one written before: on a card every
stage is a CUDA-graph replay.  The estimate is brought to the ground
truth's resolution as the JAX CLI does: scaled by the width ratio, then
resized by Pillow's bilinear filter (``transforms.resize_pil_bilinear``,
numpy); the input frames take the align-corners resize.

``--target-fps`` plans the serving chunk (frames stepped between two host
synchronisations) for ``--streams`` concurrent streams on one card from a
measured latency table (``serving.select_operating_point``): the card's
own default (``serving.H100_SXM_700W``) or a JSON file of measurements,
``{"name": ..., "measurements": [[streams, chunk, wall_ms], ...]}``, as
``serving.measure_latency_table`` gives them.  It prints the operating
point, or a warning naming how many streams one card can serve at that
rate, and ``--export-bundle`` records it in the bundle's meta.
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
    p.add_argument("--data-root", required=True)
    p.add_argument("--log-dir", default="./video_out")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    p.add_argument("--baseline", type=float, default=0.54)
    p.add_argument("--focal", type=float, default=721.5377)
    p.add_argument("--pose-format", default="auto",
                   choices=("auto", "matrix", "tartanair"),
                   help="pose_left.txt rows: ORB-SLAM3/KITTI matrices or "
                        "TartanAir quaternions; auto sniffs the row width")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold the eval-mode BatchNorms into the convolutions "
                        "(utils/fold_bn.py)")
    p.add_argument("--bf16-params", action="store_true",
                   help="store every weight as bf16 "
                        "(serving.cast_params_bf16)")
    p.add_argument("--export-bundle", default="",
                   help="write a serving bundle (JSON) and run from it")
    p.add_argument("--load-bundle", default="",
                   help="run from a serving bundle written by "
                        "--export-bundle for the same model and size")
    p.add_argument("--target-fps", type=float, default=0.0,
                   help="plan the serving chunk for this fps per stream "
                        "from the latency table; warns when --streams "
                        "cannot reach it on one card; recorded in the "
                        "bundle's meta with --export-bundle")
    p.add_argument("--streams", type=int, default=1,
                   help="concurrent streams for --target-fps")
    p.add_argument("--latency-model", default="H100_SXM_700W",
                   help="the latency table for --target-fps: a name in "
                        "serving.LATENCY_MODELS or a JSON file of "
                        "measurements")
    p.add_argument("--no-exact-growth", action="store_true",
                   help="eager path only: start from a duplicate-filled "
                        "full local map instead of growing it a channel a "
                        "frame")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p


def _find_gt(gt_dir: str, stem: str) -> str:
    for ext in (".png", ".pfm", ".npy"):
        path = os.path.join(gt_dir, stem + ext)
        if os.path.exists(path):
            return path
    return ""


def latency_model(spec: str):
    """A table of ``serving.LATENCY_MODELS`` by name, or one fit to the
    measurements of a JSON file."""
    import json

    from ..serving import LATENCY_MODELS, LatencyModel

    if spec in LATENCY_MODELS:
        return LATENCY_MODELS[spec]
    if not os.path.exists(spec):
        raise SystemExit(f"error: --latency-model {spec!r} is neither one "
                         f"of {sorted(LATENCY_MODELS)} nor a file")
    with open(spec) as fp:
        table = json.load(fp)
    return LatencyModel.fit(table["measurements"],
                            name=table.get("name", spec))


def plan(args):
    """The operating point of ``--target-fps``/``--streams``, printed."""
    from ..serving import select_operating_point

    op = select_operating_point(args.streams, args.target_fps,
                                latency_model(args.latency_model))
    op.update(target_fps=args.target_fps, streams=args.streams)
    if op["feasible"]:
        print(f"operating point: chunk={op['chunk']} -> "
              f"{op['fps_per_stream']} fps/stream predicted "
              f"({op['latency_ms']} ms chunk latency, model {op['model']})")
    else:
        print(f"WARNING: {op['note']}")
    return op


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from ..config import get_cfg
    from ..data.formats import (load_disparity, load_image, load_pose_file,
                                load_tartanair_pose_file, sniff_pose_format,
                                write_kitti_disp)
    from ..data.png import write_png
    from ..data.transforms import (normalize, resize_image,
                                   resize_pil_bilinear)
    from ..models import (backbone_memory_shapes, build_model, init_prev_info,
                          resolve_device, streaming_step)
    from ..serving import (cast_params_bf16, export_streaming_bundle,
                           load_streaming_bundle)
    from ..utils.checkpoint import load_weights
    from ..utils.fold_bn import fold_batch_norms
    from ..visualization import disp_to_color

    device = resolve_device(args.device)
    cfg = get_cfg(args.config_file, args.opts)
    model = build_model(cfg, device=device)

    left_dir = os.path.join(args.data_root, "left")
    right_dir = os.path.join(args.data_root, "right")
    names = sorted(os.listdir(left_dir))
    poses_path = os.path.join(args.data_root, "pose_left.txt")
    poses = None
    if os.path.exists(poses_path):
        fmt = args.pose_format
        if fmt == "auto":
            fmt = sniff_pose_format(poses_path)
        poses = (load_tartanair_pose_file(poses_path) if fmt == "tartanair"
                 else load_pose_file(poses_path, invert=True))
        print(f"poses: {len(poses)} frames ({fmt} format)")

    h, w = args.height, args.width
    K = np.array([[args.focal, 0, w / 2], [0, args.focal, h / 2], [0, 0, 1]],
                 np.float32)[None]
    left0 = load_image(os.path.join(left_dir, names[0]))
    K[:, 0] *= w / left0.shape[1]
    K[:, 1] *= h / left0.shape[0]
    K_t = torch.from_numpy(K).to(device)
    baseline = torch.tensor([args.baseline], dtype=torch.float32,
                            device=device)

    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"error: checkpoint not found: {args.checkpoint}")
        n = load_weights(model, args.checkpoint)
        print(f"loaded {n} tensors from {args.checkpoint}")
    if args.fold_bn:
        _, folded = fold_batch_norms(model)
        print(f"folded {len(folded)} BNs into conv weights")
    if args.bf16_params:
        cast_params_bf16(model)
        print("params cast to bf16 storage")

    op_point = plan(args) if args.target_fps > 0 else None
    bundle = None
    if args.export_bundle:
        export_streaming_bundle(model, args.export_bundle, b=1, h=h, w=w,
                                fold_bn=args.fold_bn,
                                operating_point=op_point)
    path = args.load_bundle or args.export_bundle
    if path:
        bundle = load_streaming_bundle(path, model)
        if (bundle.meta["h"], bundle.meta["w"]) != (h, w):
            raise SystemExit(f"error: bundle for {bundle.meta['h']}x"
                             f"{bundle.meta['w']}, requested {h}x{w}")
        print(f"bundle: {len(bundle.meta['stages'])} stages captured on "
              f"{bundle.meta['device_kind']} ({path})")
        bop = bundle.meta.get("operating_point")
        if bop:
            print(f"bundle operating point: chunk={bop['chunk']} "
                  f"({bop['fps_per_stream']} fps/stream predicted for "
                  f"{bop['streams']} stream(s))")

    prev = None
    if model.with_previous and bundle is None:
        exact = model.local_map_size > 0 and not args.no_exact_growth
        prev = init_prev_info(
            model, 1, (h, w), backbone_memory_shapes(model.backbone_cfg,
                                                     (h, w)),
            model.precise_cfg.get("topk", 2),
            local_map_channels=0 if exact else None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    os.makedirs(args.log_dir, exist_ok=True)
    gt_dir = os.path.join(args.data_root, "disp_gt")
    errors = []                    # (frame index, EPE, 3PE %) with GT
    t_prev = None
    for i, name in enumerate(names):
        left = resize_image(load_image(os.path.join(left_dir, name)), (h, w))
        right = resize_image(load_image(os.path.join(right_dir, name)),
                             (h, w))
        l = torch.from_numpy(normalize(left))[None].to(device)
        r = torch.from_numpy(normalize(right))[None].to(device)
        T = np.eye(4, dtype=np.float32)[None]
        if poses is not None:
            pose = poses[min(i, len(poses) - 1)]
            if i > 0:
                T = (pose @ np.linalg.inv(t_prev))[None].astype(np.float32)
            t_prev = pose
        T_t = torch.from_numpy(T).to(device)

        sync()
        t0 = time.perf_counter()
        if bundle is not None:
            disp_t = bundle.step(l, r, K_t, baseline, T_t)
        else:
            outputs, prev = streaming_step(
                model, l, r, prev, K_t, baseline, T_t,
                warp=i > 0 and model.with_previous)
            disp_t = outputs["disps"][0]
        sync()
        dt = time.perf_counter() - t0
        disp = disp_t[0, :, :, 0].float().cpu().numpy()

        stem = os.path.splitext(name)[0]
        write_kitti_disp(os.path.join(args.log_dir, f"{stem}.png"), disp)
        write_png(os.path.join(args.log_dir, f"{stem}_color.png"),
                  (disp_to_color(disp) * 255).astype(np.uint8))

        # EPE / 3PE (valid: 0 < gt < 192, 3PE in percent) at the ground
        # truth's resolution
        msg = f"[{i + 1}/{len(names)}] {name}: {dt * 1000:.1f} ms"
        gt_path = _find_gt(gt_dir, stem)
        if gt_path:
            gt = load_disparity(gt_path)
            est = disp
            if gt.shape != est.shape:
                est = resize_pil_bilinear(est * (gt.shape[1] / est.shape[1]),
                                          gt.shape)
            valid = ((gt > 0) & (gt < 192)).astype(np.float64)
            n = max(valid.sum(), 1.0)
            abs_err = np.abs(gt - est) * valid
            epe = float(abs_err.sum() / n)
            perct = float((abs_err > 3).astype(np.float64).sum() / n * 100)
            errors.append((i, epe, perct))
            msg += f"  EPE {epe:.3f}  3PE {perct:.2f}%"
        print(msg, flush=True)

    if errors:
        err_path = os.path.join(args.log_dir, "error.txt")
        avg_epe = sum(e for _, e, _ in errors) / len(errors)
        avg_3pe = sum(p for _, _, p in errors) / len(errors)
        with open(err_path, "w") as fp:
            for idx, epe, perct in errors:
                fp.write(f"{idx:04d}: {epe:.4f} {perct:.4f}\n")
            fp.write(f"Sequence average EPE: {avg_epe:.4f}, "
                     f"3PE: {avg_3pe:.4f}\n")
        print(f"Sequence average EPE: {avg_epe:.4f}, 3PE: {avg_3pe:.4f}")
        print(f"wrote {len(errors)} errors to {err_path}")
    print(f"done -> {args.log_dir}")


if __name__ == "__main__":
    main()
