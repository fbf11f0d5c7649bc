"""One training step of AlexNet and VGG-11/13/16/19 of the port on the
CPU against the JAX package: ``Module.fit`` (SGD, momentum 0.9, wd
1e-4, lr 0.01, rescale 1/batch) over one batch of 2 from the same
params, with the same Dropout masks in both packages (injected: see
``torch_vision_helpers.injected_dropout``); the loss of the step's
forward, the update and the params after it within the bounds that
``torch_vision_helpers`` states. GoogLeNet and Inception-v3 are in
``test_torch_vision_train_inception.py``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from torch_vision_helpers import check_training_step, injected_dropout


@pytest.mark.parametrize("model", ["alexnet", "vgg11", "vgg13", "vgg16",
                                   "vgg19"])
def test_training_step_matches_jax(model):
    check_training_step(model)


def test_dropout_masks_are_injected_in_both_packages():
    """The injection the step test relies on: both packages' train-mode
    Dropout give the same output, a mask of the node's name."""
    outs = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            sym = pkg.sym.Dropout(pkg.sym.Variable("data"), p=0.5,
                                  name="drop")
        with injected_dropout(sym):
            ctx = pkg.cpu()
            x = pkg.nd.array(np.ones((4, 64), np.float32), ctx=ctx)
            ex = sym.bind(ctx, {"data": x},
                          args_grad={"data": pkg.nd.zeros((4, 64), ctx=ctx)})
            ex.forward(is_train=True)
            outs.append(ex.outputs[0].asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    assert set(np.unique(outs[1])) == {0.0, 2.0}
