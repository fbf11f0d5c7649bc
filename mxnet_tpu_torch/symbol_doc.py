"""Executable documentation for the symbolic API, counterpart of
``mxnet_tpu/symbol_doc.py``: operator examples kept as doctests so the
docs cannot rot. Every example below runs on the CPU
(``python -m doctest`` over this module, or the port's tests).

The examples use the composition style the reference documented: build
a ``Symbol`` graph, then ``infer_shape`` to see what it computes.
"""


class SymbolDoc:
    """Doctest collection for ``mxnet_tpu_torch.sym``.

    Basic composition — every op takes symbols plus declarative params
    and returns a new symbol:

    >>> import mxnet_tpu_torch as mx
    >>> data = mx.sym.Variable("data")
    >>> net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    >>> net = mx.sym.Activation(net, act_type="relu")
    >>> net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    >>> net = mx.sym.SoftmaxOutput(net, name="softmax")
    >>> net.list_arguments()
    ['data', 'fc1_weight', 'fc1_bias', 'fc2_weight', 'fc2_bias', 'softmax_label']

    Shape inference propagates both ways from whatever is known:

    >>> arg_shapes, out_shapes, aux_shapes = net.infer_shape(data=(32, 100))
    >>> dict(zip(net.list_arguments(), arg_shapes))["fc1_weight"]
    (128, 100)
    >>> out_shapes
    [(32, 10)]

    Convolution / Pooling follow NCHW by default (the reference's
    layout); weight shape is (num_filter, C, kh, kw):

    >>> conv = mx.sym.Convolution(mx.sym.Variable("img"), kernel=(3, 3),
    ...                           num_filter=8, pad=(1, 1), name="c1")
    >>> pool = mx.sym.Pooling(conv, kernel=(2, 2), stride=(2, 2),
    ...                       pool_type="max")
    >>> a, o, _ = pool.infer_shape(img=(4, 3, 28, 28))
    >>> dict(zip(pool.list_arguments(), a))["c1_weight"]
    (8, 3, 3, 3)
    >>> o
    [(4, 8, 14, 14)]

    Multi-output symbols index like lists and group with ``Group``:

    >>> s = mx.sym.SliceChannel(mx.sym.Variable("x"), num_outputs=2,
    ...                         name="split")
    >>> s.list_outputs()
    ['split_output0', 'split_output1']
    >>> both = mx.sym.Group([s[0], s[1]])
    >>> len(both.list_outputs())
    2

    The fused RNN op runs the whole recurrence in one call (cuDNN on a
    card) — data is time-major (seq, batch, input), the flat parameter
    vector holds every layer's weights:

    >>> r = mx.sym.RNN(mx.sym.Variable("seq"), state_size=16,
    ...                num_layers=1, mode="lstm", name="rnn")
    >>> a, o, _ = r.infer_shape(seq=(10, 4, 8))
    >>> o                                    # (seq, batch, hidden)
    [(10, 4, 16)]

    Elementwise arithmetic composes with operator overloading:

    >>> x = mx.sym.Variable("x")
    >>> y = mx.sym.Variable("y")
    >>> z = 2 * x + y
    >>> sorted(z.list_arguments())
    ['x', 'y']

    Serialization round-trips through JSON (the checkpoint format):

    >>> json_str = net.tojson()
    >>> net2 = mx.sym.load_json(json_str)
    >>> net2.list_arguments() == net.list_arguments()
    True

    Executors bind symbols to memory and run them; ``simple_bind``
    allocates everything from shapes:

    >>> import numpy as np
    >>> exe = net.simple_bind(mx.cpu(), data=(2, 100))
    >>> exe.arg_dict["data"][:] = np.ones((2, 100), np.float32)
    >>> out = exe.forward()[0]
    >>> out.shape                            # softmax over 10 classes
    (2, 10)
    >>> bool(abs(float(out.asnumpy().sum()) - 2.0) < 1e-4)
    True
    """
