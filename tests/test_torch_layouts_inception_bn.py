"""Inception-BN-28-small (NCHW) of the port on the CPU against the JAX
package at batch 2, as ``test_torch_layouts.py`` checks ResNet-50 (a
file of its own to keep each file short)."""
from test_torch_layouts import check_layout


def test_inception_bn_28_small_forward_backward_and_step_match_jax():
    check_layout("inception_bn_28_small")
