"""The port's training step in BPTT mode (MODEL.PREVIOUS_WITH_GRADIENT:
every frame in train mode, gradients through the backbone memories, a loss
per frame keyed ``{frame_idx}_...``) against the JAX package's
``make_train_step`` on the CPU, at T=2, with the model, batch and
tolerances of tests/test_torch_train_step.py (in a file of its own so that
the test runners spread the two).
"""
from tests.test_torch_train_step import check_train_step


def test_bptt_train_step_matches_jax():
    check_train_step(2, ["MODEL.PREVIOUS_WITH_GRADIENT", "True"])
