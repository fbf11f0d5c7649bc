"""One training step of GoogLeNet and Inception-v3 of the port on the
CPU against the JAX package, as ``test_torch_vision_train.py`` does for
AlexNet and VGG (a file of its own to keep each file short)."""
import pytest

from torch_vision_helpers import check_training_step


@pytest.mark.parametrize("model", ["googlenet", "inception_v3"])
def test_training_step_matches_jax(model):
    check_training_step(model)
