"""Inception-BN, counterpart of ``mxnet_tpu/models/inception_bn.py``:
the ImageNet network and the CIFAR 28-small variant, the same graphs and
layer names (NCHW)."""
from .. import symbol as sym

__all__ = ["get_inception_bn", "get_inception_bn_28_small"]


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=None):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name="conv_%s" % name,
                           no_bias=True)
    bn = sym.BatchNorm(data=conv, fix_gamma=False, name="bn_%s" % name)
    return sym.Activation(data=bn, act_type="relu", name="relu_%s" % name)


def _inception_a(data, num_1x1, num_3x3red, num_3x3, num_d3x3red, num_d3x3,
                 pool, proj, name):
    c1 = _conv_factory(data, num_1x1, (1, 1), name="%s_1x1" % name)
    c3r = _conv_factory(data, num_3x3red, (1, 1), name="%s_3x3r" % name)
    c3 = _conv_factory(c3r, num_3x3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    cd3r = _conv_factory(data, num_d3x3red, (1, 1), name="%s_d3x3r" % name)
    cd3a = _conv_factory(cd3r, num_d3x3, (3, 3), pad=(1, 1),
                         name="%s_d3x3a" % name)
    cd3b = _conv_factory(cd3a, num_d3x3, (3, 3), pad=(1, 1),
                         name="%s_d3x3b" % name)
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                          pad=(1, 1), pool_type=pool)
    cproj = _conv_factory(pooling, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1, c3, cd3b, cproj, num_args=4, name="ch_concat_%s" % name)


def _inception_b(data, num_3x3red, num_3x3, num_d3x3red, num_d3x3, name):
    c3r = _conv_factory(data, num_3x3red, (1, 1), name="%s_3x3r" % name)
    c3 = _conv_factory(c3r, num_3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_3x3" % name)
    cd3r = _conv_factory(data, num_d3x3red, (1, 1), name="%s_d3x3r" % name)
    cd3a = _conv_factory(cd3r, num_d3x3, (3, 3), pad=(1, 1),
                         name="%s_d3x3a" % name)
    cd3b = _conv_factory(cd3a, num_d3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                         name="%s_d3x3b" % name)
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                          pad=(1, 1), pool_type="max")
    return sym.Concat(c3, cd3b, pooling, num_args=3, name="ch_concat_%s" % name)


def get_inception_bn_28_small(num_classes: int = 10):
    """The CIFAR-10 28x28..32x32 small network of the published baseline."""
    data = sym.Variable("data")
    conv1 = _conv_factory(data, 96, (3, 3), pad=(1, 1), name="1")
    in3a = _inception_a(conv1, 64, 64, 64, 64, 96, "avg", 32, "3a")
    in3b = _inception_a(in3a, 64, 64, 96, 64, 96, "avg", 64, "3b")
    in3c = _inception_b(in3b, 128, 160, 64, 96, "3c")
    in4a = _inception_a(in3c, 224, 64, 96, 96, 128, "avg", 128, "4a")
    in4b = _inception_a(in4a, 192, 96, 128, 96, 128, "avg", 128, "4b")
    in4c = _inception_a(in4b, 160, 128, 160, 128, 160, "avg", 128, "4c")
    in4d = _inception_a(in4c, 96, 128, 192, 160, 192, "avg", 128, "4d")
    in4e = _inception_b(in4d, 128, 192, 192, 256, "4e")
    in5a = _inception_a(in4e, 352, 192, 320, 160, 224, "avg", 128, "5a")
    in5b = _inception_a(in5a, 352, 192, 320, 192, 224, "max", 128, "5b")
    pool = sym.Pooling(data=in5b, kernel=(7, 7), global_pool=True,
                       pool_type="avg", name="global_pool")
    flatten = sym.Flatten(data=pool)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_inception_bn(num_classes: int = 1000):
    """ImageNet Inception-BN (the epoch-time baseline model)."""
    data = sym.Variable("data")
    conv1 = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                          name="1")
    pool1 = sym.Pooling(data=conv1, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    conv2r = _conv_factory(pool1, 64, (1, 1), name="2r")
    conv2 = _conv_factory(conv2r, 192, (3, 3), pad=(1, 1), name="2")
    pool2 = sym.Pooling(data=conv2, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    in3a = _inception_a(pool2, 64, 64, 64, 64, 96, "avg", 32, "3a")
    in3b = _inception_a(in3a, 64, 64, 96, 64, 96, "avg", 64, "3b")
    in3c = _inception_b(in3b, 128, 160, 64, 96, "3c")
    in4a = _inception_a(in3c, 224, 64, 96, 96, 128, "avg", 128, "4a")
    in4b = _inception_a(in4a, 192, 96, 128, 96, 128, "avg", 128, "4b")
    in4c = _inception_a(in4b, 160, 128, 160, 128, 160, "avg", 128, "4c")
    in4d = _inception_a(in4c, 96, 128, 192, 160, 192, "avg", 128, "4d")
    in4e = _inception_b(in4d, 128, 192, 192, 256, "4e")
    in5a = _inception_a(in4e, 352, 192, 320, 160, 224, "avg", 128, "5a")
    in5b = _inception_a(in5a, 352, 192, 320, 192, 224, "max", 128, "5b")
    pool = sym.Pooling(data=in5b, kernel=(7, 7), global_pool=True,
                       pool_type="avg", name="global_pool")
    flatten = sym.Flatten(data=pool)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
