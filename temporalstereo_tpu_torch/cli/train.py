"""Training entry point.

    python -m temporalstereo_tpu_torch.cli.train \\
        --config-file configs/kitti2015-multi.yaml [--device cuda] \\
        [KEY VALUE ...]

Counterpart of the JAX package's ``cli/train.py``: ``Trainer.fit`` (with
validation, checkpoints, the SWA finish and ``weights_final.pth``), then a
pass over ``DATA.TEST``.  One process on one card (``--device cpu`` for
the CPU); a launch with ``WORLD_SIZE`` above 1 is refused, as data
parallelism is not ported.  The last line is ``train summary:`` and a
JSON object of timings, launch counts and peak memory.
"""
from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from ..config import get_cfg
    from ..training.trainer import Trainer

    cfg = get_cfg(args.config_file, args.opts)
    trainer = Trainer(cfg, device=args.device)
    try:
        trainer.fit()
        trainer.test()
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
