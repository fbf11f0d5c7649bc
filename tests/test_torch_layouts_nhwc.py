"""ResNet-50 (32x32 input, NHWC) of the port on the CPU against the JAX
package at batch 2, as ``test_torch_layouts.py`` checks it in NCHW (a
file of its own to keep each file short)."""
from test_torch_layouts import check_layout


def test_resnet50_nhwc_forward_backward_and_step_match_jax():
    check_layout("NHWC")
