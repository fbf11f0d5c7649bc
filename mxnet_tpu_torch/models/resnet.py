"""ResNet, counterpart of ``mxnet_tpu/models/resnet.py``: the same
bottleneck-v1 graph with the same layer names, so params cross between
the packages by name."""
from .. import symbol as sym

__all__ = ["get_resnet", "get_resnet50"]


def _conv_bn_relu(data, num_filter, kernel, stride, pad, name, relu=True,
                  layout="NCHW"):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           layout=layout, name=name + "_conv")
    bn = sym.BatchNorm(data=conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                       axis=-1 if layout == "NHWC" else 1,
                       name=name + "_bn")
    if relu:
        return sym.Activation(data=bn, act_type="relu", name=name + "_relu")
    return bn


def _bottleneck(data, num_filter, stride, dim_match, name, layout="NCHW"):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut."""
    b1 = _conv_bn_relu(data, num_filter // 4, (1, 1), (1, 1), (0, 0),
                       name + "_b1", layout=layout)
    b2 = _conv_bn_relu(b1, num_filter // 4, (3, 3), stride, (1, 1),
                       name + "_b2", layout=layout)
    b3 = _conv_bn_relu(b2, num_filter, (1, 1), (1, 1), (0, 0),
                       name + "_b3", relu=False, layout=layout)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn_relu(data, num_filter, (1, 1), stride, (0, 0),
                                 name + "_sc", relu=False, layout=layout)
    fused = b3 + shortcut
    return sym.Activation(data=fused, act_type="relu", name=name + "_out")


def get_resnet(units, filter_list, num_classes=1000, small_input=False,
               layout="NCHW", stem_s2d=False):
    """Build a bottleneck ResNet. ``small_input`` swaps the 7x7/2 stem
    and max-pool for a 3x3/1 conv (32x32 inputs); ``layout="NHWC"``
    builds the tower channels-last (data (N, H, W, C), BatchNorm axis
    -1). Weights are OIHW either way. ``stem_s2d`` takes data already
    2x2 space-to-depth stacked, (N, 12, H/2, W/2), through a 5x5/1 conv
    and the max-pool in place of the 7x7/2 stem (the same output size;
    not weight-exact with the 7x7)."""
    data = sym.Variable("data")
    if stem_s2d:
        body = _conv_bn_relu(data, filter_list[0], (5, 5), (1, 1), (2, 2),
                             "stem", layout=layout)
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max", layout=layout)
    elif small_input:
        body = _conv_bn_relu(data, filter_list[0], (3, 3), (1, 1), (1, 1),
                             "stem", layout=layout)
    else:
        body = _conv_bn_relu(data, filter_list[0], (7, 7), (2, 2), (3, 3),
                             "stem", layout=layout)
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max", layout=layout)
    for stage, (n_units, num_filter) in enumerate(zip(units,
                                                      filter_list[1:])):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = _bottleneck(body, num_filter, stride, False,
                           "stage%d_unit0" % stage, layout=layout)
        for unit in range(1, n_units):
            body = _bottleneck(body, num_filter, (1, 1), True,
                               "stage%d_unit%d" % (stage, unit),
                               layout=layout)
    pool = sym.Pooling(data=body, kernel=(7, 7), global_pool=True,
                       pool_type="avg", layout=layout, name="global_pool")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def get_resnet50(num_classes=1000, small_input=False, layout="NCHW"):
    return get_resnet([3, 4, 6, 3], [64, 256, 512, 1024, 2048],
                      num_classes=num_classes, small_input=small_input,
                      layout=layout)
