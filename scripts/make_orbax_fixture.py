"""The committed orbax checkpoint fixture, tests/data/orbax_fixture/.

    JAX_PLATFORMS=cpu python scripts/make_orbax_fixture.py [--out DIR]

Writes one step of a train state with the JAX package's
``training/checkpoint.py:CheckpointManager`` (orbax, OCDBT, zarr v2, zstd),
with ``hparams-<step>.json`` beside it: a few small leaves drawn from
``numpy.random.default_rng(SEED)`` (``fixture_tree``): f32, bf16 and int32
arrays, a 0-d step, a tuple ``opt_state`` holding a dict and an empty
tuple, ``extra`` values, and one array large enough (36 KiB) to leave
OCDBT's 1 KiB inline limit for a data file.  The port reads it without
JAX, orbax, tensorstore or a zstd module (``utils/orbax.py``):
tests/test_torch_orbax.py and chip_smoke.py hold every leaf bit-equal to
``fixture_tree()``, which needs numpy alone (bf16 is rounded to nearest
even in numpy, as JAX rounds it).  Regenerate after a change to
``fixture_tree``; DIR is replaced.
"""
import argparse
import pathlib
import shutil
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "orbax_fixture"
SEED = 2024
STEP = 12


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32 values."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def fixture_tree(seed: int = SEED) -> dict:
    """The fixture's leaves, as the port reads them back (bf16 widened to
    f32, sequences as tuples; ``extra`` holds 0-d arrays, as the JAX
    package's CheckpointManager hands its scalars to orbax)."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {
        "params": {"conv": {"kernel": f32(3, 3, 8, 16), "bias": f32(16)},
                   "stem": {"kernel": bf16_round(f32(4, 24))},
                   "head": {"kernel": f32(96, 96)},
                   "ids": rng.integers(-2 ** 31, 2 ** 31, 7,
                                       dtype=np.int64).astype(np.int32)},
        "batch_stats": {"bn": {"mean": f32(16),
                               "var": np.abs(f32(16)) + 0.5}},
        "opt_state": (np.asarray(STEP, np.int32),
                      {"mu": {"conv": f32(3, 3, 8, 16)}}, ()),
        "step": np.asarray(STEP, np.int32),
        "extra": {"epoch": np.asarray(3), "best_epe": np.asarray(1.25)},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=pathlib.Path, default=OUT)
    args = parser.parse_args(argv)

    import jax.numpy as jnp

    sys.path.insert(0, str(REPO))
    from temporalstereo_tpu.training.checkpoint import CheckpointManager
    from temporalstereo_tpu.training.state import TrainState

    tree = fixture_tree()
    params = dict(tree["params"])
    params["stem"] = {"kernel": jnp.asarray(params["stem"]["kernel"],
                                            jnp.bfloat16)}
    state = TrainState(step=tree["step"], params=params,
                       batch_stats=tree["batch_stats"],
                       opt_state=tree["opt_state"], tx=None)
    if args.out.exists():
        shutil.rmtree(args.out)
    CheckpointManager(str(args.out)).save(
        STEP, state, extra=tree["extra"], hparams={"seed": SEED,
                                                   "step": STEP})
    size = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"wrote {args.out} ({size} bytes)")


if __name__ == "__main__":
    main()
