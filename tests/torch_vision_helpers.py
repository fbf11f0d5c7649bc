"""Helpers of the vision-model parity tests (no tests here): the models
at their smallest inputs, Dropout masks injected into both packages,
one ``Module.fit`` step from numpy params, and the training-step check
with its stated bound."""
import contextlib
import logging
import zlib

import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu.ops.nn as jnn
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.ops.nn as tnn

from test_torch_common import fresh_names, random_params

# models function, kwargs, the smallest square input each takes (NCHW)
VISION = {
    "alexnet": ("get_alexnet", {}, 67),
    "vgg11": ("get_vgg", {"num_layers": 11}, 32),
    "vgg13": ("get_vgg", {"num_layers": 13}, 32),
    "vgg16": ("get_vgg", {"num_layers": 16}, 32),
    "vgg19": ("get_vgg", {"num_layers": 19}, 32),
    "googlenet": ("get_googlenet", {}, 64),
    "inception_v3": ("get_inception_v3", {}, 75),
}
BATCH = 2
CLASSES = 1000


def build(pkg, model):
    fn, kw, _ = VISION[model]
    with fresh_names(pkg):
        return getattr(pkg.models, fn)(**kw)


def data_shape(model):
    hw = VISION[model][2]
    return (BATCH, 3, hw, hw)


def dropout_mask(name, shape, p):
    """The keep-mask of the Dropout node ``name``: numpy draws seeded from
    the node's name, the same in both packages."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    return rng.rand(*shape) < 1.0 - p


@contextlib.contextmanager
def injected_dropout(*syms):
    """Both packages' Dropout draws, in train mode, the mask of
    :func:`dropout_mask` for its node (found by walking ``syms``)
    instead of its generator's: the JAX package draws from threefry
    keys and the port from torch generators, so a training step with
    Dropout is comparable only with one mask on both sides."""
    names = {id(n.op): n.name for s in syms for n in s._topo()
             if not n.is_variable and type(n.op).__name__ == "Dropout"}

    def jax_apply(self, ctx, inputs, aux):
        import jax.numpy as jnp
        x = inputs[0]
        if not ctx.is_train or self.p <= 0.0:
            return [x], []
        keep = 1.0 - self.p
        mask = jnp.asarray(dropout_mask(names[id(self)], x.shape, self.p))
        return [jnp.where(mask, x / keep, 0.0).astype(x.dtype)], []

    def torch_apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not ctx.is_train or self.p <= 0.0:
            return [x], []
        keep = 1.0 - self.p
        mask = torch.from_numpy(dropout_mask(names[id(self)],
                                             tuple(x.shape), self.p))
        return [torch.where(mask.to(x.device), x / keep,
                            torch.zeros_like(x))], []

    saved = (jnn.Dropout.apply, tnn.Dropout.apply)
    jnn.Dropout.apply, tnn.Dropout.apply = jax_apply, torch_apply
    try:
        yield names
    finally:
        jnn.Dropout.apply, tnn.Dropout.apply = saved


def jax_init(sym, shape, seed=0):
    """numpy (args, aux) of ``sym`` initialised by the JAX package
    (Xavier, fan-in, magnitude 2) from its seeded global PRNG."""
    jmx.random.seed(seed)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", shape)], for_training=False)
    mod.init_params(jmx.init.Xavier(factor_type="in", magnitude=2.0))
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def fit_step(pkg, sym, args, aux, x, y, opt, steps=1):
    """``steps`` SGD steps of ``Module.fit`` on the CPU from numpy params
    over batches of BATCH in order; (losses, params, aux) as numpy."""
    losses = []

    def record(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = y[param.nbatch * BATCH:(param.nbatch + 1) * BATCH]
        losses.append(-np.log(probs.astype(np.float64)[
            np.arange(BATCH), lab.astype(int)]).mean())

    ctx = pkg.cpu()
    if pkg is tmx:
        a, au = tmx.interop.params_from_numpy(
            sym, args, aux, ctx, input_shapes={"data": x.shape[:0]
                                               + (BATCH,) + x.shape[1:]})
    else:
        a = {k: jmx.nd.array(v) for k, v in args.items()}
        au = {k: jmx.nd.array(v) for k, v in aux.items()}
    mod = pkg.mod.Module(sym, context=ctx, logger=logging)
    mod.fit(pkg.io.NDArrayIter(x[:steps * BATCH], y[:steps * BATCH],
                               batch_size=BATCH),
            num_epoch=1, arg_params=a, aux_params=au, optimizer="sgd",
            optimizer_params=opt, batch_end_callback=record)
    p, q = mod.get_params()
    return (np.array(losses), {k: v.asnumpy() for k, v in p.items()},
            {k: v.asnumpy() for k, v in q.items()})


TRAIN_OPT = (("learning_rate", 0.01), ("momentum", 0.9), ("wd", 1e-4),
             ("rescale_grad", 1.0 / BATCH))

# The bound. A one-step comparison is only as good as the step's
# conditioning: the packages' forwards differ by rounding, so a ReLU or a
# max-pool whose inputs sit within rounding of a tie can decide the other
# way, and the gradient behind it moves. Measured at these seeds (the
# port against itself with its input moved by 1e-7 shows the same): the
# loss of the step within 4e-7 relative; the update of all params
# together within 1.5e-3 of its norm; single elements up to 5.2e-4 above
# rtol 1e-3 (VGG-13, whose largest update is 2e-2). So: loss rtol 1e-5,
# the whole update within 1e-2 of its norm, each param rtol 1e-3 / atol
# 2e-3. Moving statistics rtol 1e-3 / atol 1e-5: the batch variance is
# one-pass (E[x^2] - E[x]^2) in float32 in both packages, which loses
# digits where a channel's mean is large against its spread (2e-4
# relative measured in ResNet-50's stage 1).
#
# Inception-v3 trains at 139x139, not at its smallest input (75x75):
# there its last two blocks are 1x1, and a BatchNorm over the batch's 2
# rows outputs +-1 whatever its input, so its exact input gradient is 0
# and the computed one is rounding noise over a near-zero deviation (the
# port against itself, the input moved by 1e-7, moves a conv weight by
# 500 in one step). At 139x139 the last stage is 3x3 (18 rows a
# channel). Its BatchNorms fix gamma at 1, so it is conditioned by the
# betas, all set to 2, which keeps most ReLU inputs away from zero: with
# the betas at 0 the update differs by 3-6% of its norm in most tensors.
TRAIN_HW = {"inception_v3": 139}
BN_BETA = 2.0
TOL = {"loss": 1e-5, "update": 1e-2, "params": (1e-3, 2e-3),
       "aux": (1e-3, 1e-5)}


def update_error(got, want, start):
    """|update(got) - update(want)| / |update(want)| over every param."""
    diff = np.concatenate([(got[k] - want[k]).ravel() for k in start])
    upd = np.concatenate([(want[k] - start[k]).ravel() for k in start])
    return float(np.linalg.norm(diff) / np.linalg.norm(upd))


def check_training_step(model):
    """One ``Module.fit`` step of ``model`` in both packages, with the
    Dropout masks injected, held to the bound above."""
    jsym, tsym = build(jmx, model), build(tmx, model)
    shape = data_shape(model)
    if model in TRAIN_HW:
        shape = shape[:2] + (TRAIN_HW[model],) * 2
    args, aux = random_params(tsym, shape, seed=5)
    if aux:
        args = {k: np.full_like(v, BN_BETA) if k.endswith("_bn_beta") else v
                for k, v in args.items()}
    with injected_dropout(jsym, tsym) as masked:
        compare_training_step(jsym, tsym, shape, args, aux, CLASSES)
    assert len(set(masked.values())) == \
        {"googlenet": 1, "inception_v3": 1}.get(model, 2)


def compare_training_step(jsym, tsym, shape, args, aux, classes):
    """One ``Module.fit`` step in both packages from ``args``/``aux`` on
    seeded data of ``shape``, held to :data:`TOL`."""
    rng = np.random.RandomState(9)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, classes, BATCH).astype(np.float32)
    want = fit_step(jmx, jsym, args, aux, x, y, TRAIN_OPT)
    got = fit_step(tmx, tsym, args, aux, x, y, TRAIN_OPT)
    assert len(got[0]) == 1 and np.isfinite(got[0][0])
    np.testing.assert_allclose(got[0], want[0], rtol=TOL["loss"])
    assert got[1].keys() == want[1].keys() == args.keys()
    assert update_error(got[1], want[1], args) <= TOL["update"]
    rtol, atol = TOL["params"]
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=rtol,
                                   atol=atol, err_msg=k)
        assert not np.array_equal(got[1][k], args[k]), k
    assert got[2].keys() == want[2].keys() == aux.keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=TOL["aux"][0],
                                   atol=TOL["aux"][1], err_msg=k)
