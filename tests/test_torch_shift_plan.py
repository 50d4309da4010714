"""The shift forward kernel's launch plan (``kernels/launches.py:
shift_forward_plan``): pure Python, no card.  A plan must cover every
channel and hypothesis exactly once, fit one block's shared memory and
keep each staged slice in whole 16-byte chunks where C % 8 == 0."""
import pytest

from temporalstereo_tpu_torch.kernels.launches import (MAX_SHARED, SMS,
                                                       SHIFT_THREADS,
                                                       shift_forward_plan)

WIDTHS = range(1, 1249)
HYPOTHESES = (1, 5, 8)
ROWS = (1, 48, 160)


def _check_plan(width_t, width, channels, hypotheses, size, rows):
    slices, per, shared = shift_forward_plan(width_t, width, channels,
                                             hypotheses, size, rows)
    part = channels // slices
    assert [c for s in range(slices) for c in range(s * part,
                                                    (s + 1) * part)] \
        == list(range(channels))
    assert 1 <= per <= hypotheses
    assert [d for d0 in range(0, hypotheses, per)
            for d in range(d0, min(d0 + per, hypotheses))] \
        == list(range(hypotheses))
    vec = 16 // size if channels % 8 == 0 else 1
    assert part % vec == 0 and part // vec <= SHIFT_THREADS
    row = shared - 4 * per * width          # the staged img row slice
    assert 0 <= row - width_t * part * size < 16
    assert shared <= MAX_SHARED
    if channels % 8 == 0:
        # a slice starts and ends on a 16-byte chunk of every pixel, and
        # the shift rows after the staged row start 16-byte aligned
        assert part * size % 16 == 0 and channels * size % 16 == 0
        assert row % 16 == 0
    return slices, per, shared


@pytest.mark.parametrize("size", (2, 4))
@pytest.mark.parametrize("channels", (8, 12, 128, 256))
def test_plan_covers_the_shape_and_fits(channels, size):
    for width in WIDTHS:
        for hypotheses in HYPOTHESES:
            # the full-width call, and a shard of the frame's columns
            # against the whole row (rank 1 of 2, as the sharded forward)
            _check_plan(width, width, channels, hypotheses, size,
                        ROWS[width % 3])
            shard = width - width * 640 // 1248
            if shard:
                _check_plan(width, shard, channels, hypotheses, size, 48)


@pytest.mark.parametrize("size", (2, 4))
@pytest.mark.parametrize("shape", (
    (148, 148, 128, 8, 160),      # training, fine: [4, 1, 40, 148, 128]
    (296, 296, 128, 5, 320),      # training, precise: [4, 1, 80, 296, 128]
    (156, 76, 128, 8, 48),        # rank 1 of 2 of the stream's fine stage
    (312, 152, 128, 5, 96),       # and of its precise stage
    (148, 148, 128, 1, 1280)))    # img [4, 8, 40, 148, 128] (Di = D)
def test_plan_fills_the_card_at_the_path_shapes(shape, size):
    width_t, width, channels, hypotheses, rows = shape
    slices, per, shared = _check_plan(width_t, width, channels, hypotheses,
                                      size, rows)
    assert rows * slices * -(-hypotheses // per) >= 2 * SMS
    assert shared <= 48 * 1024
    assert channels // slices * size >= 64


def test_plan_slices_a_row_too_wide_for_one_block():
    for size in (2, 4):
        slices, _, shared = _check_plan(1248, 1248, 128, 5, size, 8)
        assert 1248 * 128 * size > MAX_SHARED and slices > 1


def test_plan_refuses_a_row_that_cannot_fit():
    # 8 channels are one 16-byte chunk (bf16): the row cannot be sliced
    with pytest.raises(ValueError, match="shared memory"):
        shift_forward_plan(20000, 20000, 8, 1, 2, 1)
