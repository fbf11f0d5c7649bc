"""Classic ImageNet classifiers: AlexNet, VGG, GoogLeNet, Inception-v3.

Counterpart of ``mxnet_tpu/models/vision.py``: the same graphs with the
same node names, parameter names and order, so symbol JSON and params
cross between the packages. Each architecture is a table of stages
expanded by small helpers, so depth variants share one code path. All
four are NCHW.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_alexnet", "get_vgg", "get_googlenet", "get_inception_v3"]


def _conv_relu(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
               name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name=name)
    return sym.Activation(data=c, act_type="relu")


def _classifier_head(data, num_classes, hidden=4096, dropout=0.5):
    net = sym.Flatten(data=data)
    for i in range(2):
        net = sym.FullyConnected(data=net, num_hidden=hidden,
                                 name="fc%d" % (i + 6))
        net = sym.Activation(data=net, act_type="relu")
        net = sym.Dropout(data=net, p=dropout)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=net, name="softmax")


def get_alexnet(num_classes: int = 1000):
    """AlexNet (Krizhevsky et al. 2012): 5 conv stages with LRN after the
    first two, then the 4096-4096 dropout head."""
    data = sym.Variable("data")
    net = _conv_relu(data, 96, (11, 11), stride=(4, 4), name="conv1")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = sym.LRN(data=net, alpha=1e-4, beta=0.75, knorm=1, nsize=5)
    net = _conv_relu(net, 256, (5, 5), pad=(2, 2), name="conv2")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = sym.LRN(data=net, alpha=1e-4, beta=0.75, knorm=1, nsize=5)
    for i, nf in enumerate((384, 384, 256)):
        net = _conv_relu(net, nf, (3, 3), pad=(1, 1), name="conv%d" % (i + 3))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    return _classifier_head(net, num_classes)


_VGG_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_VGG_FILTERS = (64, 128, 256, 512, 512)


def get_vgg(num_classes: int = 1000, num_layers: int = 16):
    """VGG-{11,13,16,19} (Simonyan & Zisserman 2014). The reference built
    VGG-16 layer by layer; here the depth table generates all variants."""
    if num_layers not in _VGG_CFG:
        raise ValueError("vgg: num_layers must be one of %s"
                         % sorted(_VGG_CFG))
    net = sym.Variable("data")
    for stage, (reps, nf) in enumerate(zip(_VGG_CFG[num_layers],
                                           _VGG_FILTERS)):
        for i in range(reps):
            net = _conv_relu(net, nf, (3, 3), pad=(1, 1),
                             name="conv%d_%d" % (stage + 1, i + 1))
        net = sym.Pooling(data=net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
    return _classifier_head(net, num_classes)


def _inception_v1(data, n1, n3r, n3, n5r, n5, npool, name):
    """GoogLeNet inception block: 1x1 / 3x3 / 5x5 / pool-proj branches."""
    b1 = _conv_relu(data, n1, (1, 1), name=name + "_1x1")
    b3 = _conv_relu(data, n3r, (1, 1), name=name + "_3x3r")
    b3 = _conv_relu(b3, n3, (3, 3), pad=(1, 1), name=name + "_3x3")
    b5 = _conv_relu(data, n5r, (1, 1), name=name + "_5x5r")
    b5 = _conv_relu(b5, n5, (5, 5), pad=(2, 2), name=name + "_5x5")
    bp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max")
    bp = _conv_relu(bp, npool, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b3, b5, bp, name=name + "_concat")


_GOOGLENET_BLOCKS = [
    # (name, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj, pool_before)
    ("3a", 64, 96, 128, 16, 32, 32, False),
    ("3b", 128, 128, 192, 32, 96, 64, False),
    ("4a", 192, 96, 208, 16, 48, 64, True),
    ("4b", 160, 112, 224, 24, 64, 64, False),
    ("4c", 128, 128, 256, 24, 64, 64, False),
    ("4d", 112, 144, 288, 32, 64, 64, False),
    ("4e", 256, 160, 320, 32, 128, 128, False),
    ("5a", 256, 160, 320, 32, 128, 128, True),
    ("5b", 384, 192, 384, 48, 128, 128, False),
]


def get_googlenet(num_classes: int = 1000):
    """GoogLeNet / Inception-v1 (Szegedy et al. 2015), 9 inception
    blocks driven by the block table."""
    data = sym.Variable("data")
    net = _conv_relu(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                     name="conv1")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = _conv_relu(net, 64, (1, 1), name="conv2r")
    net = _conv_relu(net, 192, (3, 3), pad=(1, 1), name="conv2")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    for name, n1, n3r, n3, n5r, n5, npool, pool_before in _GOOGLENET_BLOCKS:
        if pool_before:
            net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                              pool_type="max")
        net = _inception_v1(net, n1, n3r, n3, n5r, n5, npool,
                            "inception_" + name)
    net = sym.Pooling(data=net, kernel=(7, 7), pool_type="avg",
                      global_pool=True)
    net = sym.Flatten(data=net)
    net = sym.Dropout(data=net, p=0.4)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(data=net, name="softmax")


def _conv_bn_relu(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True, name=name)
    # fix_gamma=True matches the reference's Inception-v3 conv factory
    bn = sym.BatchNorm(data=c, fix_gamma=True, eps=1e-3,
                       name=(name or "conv") + "_bn")
    return sym.Activation(data=bn, act_type="relu")


def _inc3_a(data, npool, name):
    """35x35 block: 1x1 / 5x5 / double-3x3 / avgpool-proj."""
    b1 = _conv_bn_relu(data, 64, (1, 1), name=name + "_1x1")
    b5 = _conv_bn_relu(data, 48, (1, 1), name=name + "_5x5r")
    b5 = _conv_bn_relu(b5, 64, (5, 5), pad=(2, 2), name=name + "_5x5")
    b3 = _conv_bn_relu(data, 64, (1, 1), name=name + "_d3r")
    b3 = _conv_bn_relu(b3, 96, (3, 3), pad=(1, 1), name=name + "_d3a")
    b3 = _conv_bn_relu(b3, 96, (3, 3), pad=(1, 1), name=name + "_d3b")
    bp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = _conv_bn_relu(bp, npool, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b5, b3, bp, name=name + "_concat")


def _inc3_b(data, name):
    """17x17 grid reduction."""
    b3 = _conv_bn_relu(data, 384, (3, 3), stride=(2, 2), name=name + "_3x3")
    bd = _conv_bn_relu(data, 64, (1, 1), name=name + "_d3r")
    bd = _conv_bn_relu(bd, 96, (3, 3), pad=(1, 1), name=name + "_d3a")
    bd = _conv_bn_relu(bd, 96, (3, 3), stride=(2, 2), name=name + "_d3b")
    bp = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                     pool_type="max")
    return sym.Concat(b3, bd, bp, name=name + "_concat")


def _inc3_c(data, n7, name):
    """17x17 block with factorized 7x7 (1x7 + 7x1) branches."""
    b1 = _conv_bn_relu(data, 192, (1, 1), name=name + "_1x1")
    b7 = _conv_bn_relu(data, n7, (1, 1), name=name + "_7r")
    b7 = _conv_bn_relu(b7, n7, (1, 7), pad=(0, 3), name=name + "_7a")
    b7 = _conv_bn_relu(b7, 192, (7, 1), pad=(3, 0), name=name + "_7b")
    bd = _conv_bn_relu(data, n7, (1, 1), name=name + "_d7r")
    bd = _conv_bn_relu(bd, n7, (7, 1), pad=(3, 0), name=name + "_d7a")
    bd = _conv_bn_relu(bd, n7, (1, 7), pad=(0, 3), name=name + "_d7b")
    bd = _conv_bn_relu(bd, n7, (7, 1), pad=(3, 0), name=name + "_d7c")
    bd = _conv_bn_relu(bd, 192, (1, 7), pad=(0, 3), name=name + "_d7d")
    bp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = _conv_bn_relu(bp, 192, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b7, bd, bp, name=name + "_concat")


def _inc3_d(data, name):
    """8x8 grid reduction."""
    b3 = _conv_bn_relu(data, 192, (1, 1), name=name + "_3r")
    b3 = _conv_bn_relu(b3, 320, (3, 3), stride=(2, 2), name=name + "_3x3")
    b7 = _conv_bn_relu(data, 192, (1, 1), name=name + "_7r")
    b7 = _conv_bn_relu(b7, 192, (1, 7), pad=(0, 3), name=name + "_7a")
    b7 = _conv_bn_relu(b7, 192, (7, 1), pad=(3, 0), name=name + "_7b")
    b7 = _conv_bn_relu(b7, 192, (3, 3), stride=(2, 2), name=name + "_7c")
    bp = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                     pool_type="max")
    return sym.Concat(b3, b7, bp, name=name + "_concat")


def _inc3_e(data, name, pool="avg"):
    """8x8 block with expanded 3x3 (1x3 | 3x1) fan-outs. The reference
    uses an avg-pool branch in the first E block and max in the second."""
    b1 = _conv_bn_relu(data, 320, (1, 1), name=name + "_1x1")
    b3 = _conv_bn_relu(data, 384, (1, 1), name=name + "_3r")
    b3a = _conv_bn_relu(b3, 384, (1, 3), pad=(0, 1), name=name + "_3a")
    b3b = _conv_bn_relu(b3, 384, (3, 1), pad=(1, 0), name=name + "_3b")
    bd = _conv_bn_relu(data, 448, (1, 1), name=name + "_d3r")
    bd = _conv_bn_relu(bd, 384, (3, 3), pad=(1, 1), name=name + "_d3")
    bda = _conv_bn_relu(bd, 384, (1, 3), pad=(0, 1), name=name + "_d3a")
    bdb = _conv_bn_relu(bd, 384, (3, 1), pad=(1, 0), name=name + "_d3b")
    bp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type=pool)
    bp = _conv_bn_relu(bp, 192, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b3a, b3b, bda, bdb, bp, name=name + "_concat")


def get_inception_v3(num_classes: int = 1000):
    """Inception-v3 (Szegedy et al. 2016) for 299x299 inputs."""
    data = sym.Variable("data")
    net = _conv_bn_relu(data, 32, (3, 3), stride=(2, 2), name="conv1")
    net = _conv_bn_relu(net, 32, (3, 3), name="conv2")
    net = _conv_bn_relu(net, 64, (3, 3), pad=(1, 1), name="conv3")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = _conv_bn_relu(net, 80, (1, 1), name="conv4")
    net = _conv_bn_relu(net, 192, (3, 3), name="conv5")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    for i, npool in enumerate((32, 64, 64)):
        net = _inc3_a(net, npool, "mixed_a%d" % (i + 1))
    net = _inc3_b(net, "mixed_b1")
    for i, n7 in enumerate((128, 160, 160, 192)):
        net = _inc3_c(net, n7, "mixed_c%d" % (i + 1))
    net = _inc3_d(net, "mixed_d1")
    for i, pool in enumerate(("avg", "max")):
        net = _inc3_e(net, "mixed_e%d" % (i + 1), pool=pool)
    net = sym.Pooling(data=net, kernel=(8, 8), pool_type="avg",
                      global_pool=True)
    net = sym.Dropout(data=net, p=0.5)
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(data=net, name="softmax")
