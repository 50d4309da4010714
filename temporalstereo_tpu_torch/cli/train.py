"""Training entry point.

    python -m temporalstereo_tpu_torch.cli.train \\
        --config-file configs/kitti2015-multi.yaml [--device cuda] \\
        [KEY VALUE ...]

Counterpart of the JAX package's ``cli/train.py``: ``Trainer.fit`` (with
validation, checkpoints, the SWA finish and ``weights_final.pth``), then a
pass over ``DATA.TEST``.  One process on one card (``--device cpu`` for
the CPU), or with ``--multihost`` one rank of a data-parallel run that
``torchrun`` launched, one card a rank (NCCL; gloo on the CPU):

    torchrun --nproc_per_node N -m temporalstereo_tpu_torch.cli.train \
        --multihost --config-file configs/kitti2015-multi.yaml [KEY VALUE ...]

Without ``--multihost`` a launch with ``WORLD_SIZE`` above 1 is refused.
The last line is ``train summary:`` and a JSON object of timings, launch
counts and peak memory (rank 0's).
"""
from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--multihost", action="store_true",
                        help="join torchrun's process group as one rank "
                             "of a data-parallel run")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from ..config import get_cfg
    from ..training.trainer import Trainer

    cfg = get_cfg(args.config_file, args.opts)
    try:
        trainer = Trainer(cfg, device=args.device, multihost=args.multihost)
        try:
            trainer.fit()
            trainer.test()
        finally:
            trainer.close()
    finally:
        if args.multihost:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    main()
