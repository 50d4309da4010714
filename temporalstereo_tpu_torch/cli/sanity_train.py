"""Synthetic end-to-end training sanity: the EPE must drop.

    python -m temporalstereo_tpu_torch.cli.sanity_train [--steps 1000] \\
        [--temporal] [--device cuda]

Counterpart of the JAX package's ``cli/sanity_train.py``.  A synthetic
stereo problem with known geometry: textured left images (smoothed noise
at three scales), smooth random disparity fields, right views warped from
the left along the scanlines by the disparity.  The full model (v2s, bf16)
trains on ``--num-batches`` such batches through ``make_train_step`` and
the EPE of the first batch and of a held-out one is printed before and
after.  ``--temporal`` trains the temporal model on synthetic video: a
rig translating sideways by ``--tx`` a frame, whose flow is the same
scanline warp.  The batches equal the JAX package's for the same seed
(``make_synthetic_batch`` uses scipy's ``gaussian_filter``, as it does).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _scanline_warp(img: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """Bilinear sample of ``img`` at ``x + shift`` along scanlines."""
    h, w = shift.shape
    xs = np.arange(w)[None, :] + shift
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    f = xs - np.floor(xs)
    if img.ndim == 3:
        f = f[..., None]
    rows = np.arange(h)[:, None]
    return img[rows, x0] * (1 - f) + img[rows, x1] * f


def make_synthetic_batch(rng: np.random.RandomState, b: int, h: int, w: int,
                         t: int = 1, tx: float = 0.0):
    """A static textured scene with a smooth disparity field, seen by a
    stereo rig (baseline 1) that translates sideways by ``tx`` a frame;
    frames run oldest to newest, the newest at the frame-0 camera.  The
    time-major numpy batch of ``models/temporal.py`` plus 'disp_gt'."""
    from scipy.ndimage import gaussian_filter

    lefts = [[] for _ in range(t)]
    rights = [[] for _ in range(t)]
    disps = [[] for _ in range(t)]
    for _ in range(b):
        img = sum(gaussian_filter(rng.rand(h, w, 3), (s, s, 0)) * g
                  for s, g in ((1, 0.5), (4, 0.3), (16, 0.2)))
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        disp = gaussian_filter(rng.rand(h, w), 24)
        disp = 5.0 + ((disp - disp.min())
                      / (disp.max() - disp.min() + 1e-9) * 40.0)
        for ti in range(t):
            back = (t - 1 - ti) * tx
            flow = disp * back
            lefts[ti].append(_scanline_warp(img, flow))
            disp_t = _scanline_warp(disp, flow)
            disps[ti].append(disp_t)
            rights[ti].append(_scanline_warp(img, flow + disp_t))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def norm(x):
        return ((x - mean) / std).astype(np.float32)
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]],
                 np.float32)
    # an older camera sits at world x = +back: world->cam x is -back
    T_cam = np.tile(np.eye(4, dtype=np.float32), (t, b, 1, 1))
    for ti in range(t):
        T_cam[ti, :, 0, 3] = -(t - 1 - ti) * tx
    return {
        "left": np.stack([np.stack([norm(x) for x in fr]) for fr in lefts]),
        "right": np.stack([np.stack([norm(x) for x in fr]) for fr in rights]),
        "disp_gt": np.stack([np.stack(fr) for fr in disps])[..., None].astype(
            np.float32),
        "T_cam": T_cam,
        "inv_T": np.linalg.inv(T_cam),
        "K": np.tile(K, (b, 1, 1)),
        "baseline": np.full((b,), 1.0, np.float32),
    }


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--num-batches", type=int, default=8)
    p.add_argument("--temporal", action="store_true",
                   help="train the temporal model on synthetic video "
                        "(memory splice + pose warp + splat + local map)")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--tx", type=float, default=0.05)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    import torch

    from ..config import get_cfg
    from ..data import batch_to_device
    from ..data.evaluation import calc_error
    from ..models import build_model, multi_frame_forward, resolve_device
    from ..training import (TrainState, build_optimizer, make_train_step,
                            master_copies)
    from ..training.step import load_working_copy

    device = resolve_device(args.device)
    opts = ["TRAINER.PRECISION", "bf16",
            "OPTIMIZER.RMSPROP.LR", str(args.lr),
            "SCHEDULER.TYPE", "None"]
    if args.temporal:
        opts += ["MODEL.WITH_PREVIOUS", "True",
                 "MODEL.USE_PAST_COST", "True",
                 "MODEL.LOCAL_MAP_SIZE", "3",
                 "MODEL.BACKBONE.MEMORY_PERCENT", "0.5"]
    cfg = get_cfg(opts=opts)
    model = build_model(cfg, device=device, seed=0)

    t = args.frames if args.temporal else 1
    tx = args.tx if args.temporal else 0.0
    rng = np.random.RandomState(7)
    batches = [batch_to_device(make_synthetic_batch(
        rng, args.batch, args.height, args.width, t=t, tx=tx), device)
        for _ in range(args.num_batches)]
    state = TrainState.create(*master_copies(model),
                              build_optimizer(cfg, steps_per_epoch=10 ** 6))
    step = make_train_step(model, cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def eval_epe(batch) -> float:
        load_working_copy(model, state)
        with torch.no_grad():
            out, _ = multi_frame_forward(model, batch, train=False)
        return float(calc_error(out["disps"][0].float(),
                                batch["disp_gt"][-1], 0, 192)["epe"])

    epe0 = eval_epe(batches[0])
    print(f"EPE before training: {epe0:.3f} px", flush=True)

    sync()
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, batches[i % len(batches)])
        if (i + 1) % 50 == 0:
            print(f"step {i + 1}: loss {float(m['loss']):.3f}", flush=True)
    sync()
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch / dt:.1f} ex/s)", flush=True)

    epe1 = eval_epe(batches[0])
    held = batch_to_device(make_synthetic_batch(
        rng, args.batch, args.height, args.width), device)
    epe_h = eval_epe(held)
    print(f"EPE after training: train-batch {epe1:.3f} px, "
          f"held-out {epe_h:.3f} px (was {epe0:.3f})", flush=True)
    if epe1 < epe0 * 0.5:
        print("SANITY PASS: model learns stereo geometry", flush=True)
    else:
        print("SANITY FAIL: EPE did not improve enough", flush=True)


if __name__ == "__main__":
    main()
