"""Child process of the port's SIGTERM checkpoint test (not a test
module; imports neither jax nor the JAX package). Trains a small MLP on
the CPU through ``Module.fit(fused_step=True)`` with the checkpoint
manager armed by ``MXNET_TPU_CKPT_*``, appends each step's ``epoch
nbatch accuracy-as-hexfloat`` to ``$T_DIR/stream.txt`` and, when
``DIE_AT_STEP`` is set, sends itself SIGTERM after that global step's
batch-end callback. A run that reaches the end of fit() writes
``$T_DIR/completed``."""
import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402

TMP = os.environ["T_DIR"]
DIE_AT_STEP = int(os.environ.get("DIE_AT_STEP", "-1"))
BATCH, DIM, NBATCHES, NUM_EPOCH = 8, 6, 6, 2

net = mx.sym.Variable("data")
net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
net = mx.sym.Activation(net, act_type="relu")
net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
net = mx.sym.SoftmaxOutput(net, name="softmax")

rng = np.random.RandomState(0)
x = rng.randn(BATCH * NBATCHES, DIM).astype(np.float32)
y = x.dot(rng.randn(DIM, 3)).argmax(axis=1).astype(np.float32)
shapes, _, _ = net.infer_shape(data=(BATCH, DIM), softmax_label=(BATCH,))
prng = np.random.RandomState(3)
arg_params = {n: mx.nd.array((prng.randn(*s) * 0.1).astype(np.float32),
                             ctx=mx.cpu())
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
step = [0]


def cb(param):
    step[0] += 1
    acc = float(dict(param.eval_metric.get_name_value())["accuracy"])
    with open(os.path.join(TMP, "stream.txt"), "a") as f:
        f.write("%d %d %s\n" % (param.epoch, param.nbatch, acc.hex()))
    if step[0] == DIE_AT_STEP:
        os.kill(os.getpid(), signal.SIGTERM)


mod = mx.mod.Module(net, context=mx.cpu())
mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=NUM_EPOCH,
        arg_params=arg_params, initializer=None,
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
        batch_end_callback=cb, fused_step=True)
with open(os.path.join(TMP, "completed"), "w") as f:
    f.write("ok")
