"""Mixed precision in the port against the JAX package
(``tests/test_mixed_precision.py``'s cases that the port's modules
cover): bfloat16 or float16 compute with float32 params, gradients, aux
states and outputs, labels never cast.

Tolerances, port against JAX on the same seeded numpy inputs: the two
packages round to 16 bits at the same places (every argument on entry,
each op's output), but their CPU kernels sum in other orders, so one
operand can round to the neighbouring 16-bit value and carry that through
the graph. Outputs (softmax probabilities) are held within 2e-2 (bfloat16,
8 mantissa bits) or 4e-3 (float16, 11); gradients normwise within 0.1 of
the reference's norm in both types: a max-pool window or a ReLU within
rounding of a tie in 16 bits sends one gradient entry whole to another
place (3.7% of the convolution weight's gradient norm at this size, in
either type). The convolution's bias in front of a
BatchNorm has a true gradient of zero, so its rounding noise is held
against the weight gradient's norm instead."""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.executor import Executor as JExecutor
from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.executor import Executor as TExecutor
from mxnet_tpu_torch.ops import kernels as tk

from test_torch_common import fresh_names

OUT_TOL = {"bfloat16": 2e-2, "float16": 4e-3}
GRAD_TOL = {"bfloat16": 0.1, "float16": 0.1}
TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float16": torch.float16}
NP_BF16 = jnp.dtype("bfloat16").type
TORCH_NP = {"bfloat16": NP_BF16, "float16": np.float16}


def _net(pkg, layout=None):
    """The reference test's net; ``layout="NHWC"`` keeps channels last
    (the port's BatchNorm then runs K4/K5's plain versions)."""
    kw = {"layout": layout} if layout else {}
    with fresh_names(pkg):
        data = pkg.sym.Variable("data")
        net = pkg.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                                  pad=(1, 1), name="c1", **kw)
        net = pkg.sym.BatchNorm(data=net, name="bn1",
                                **({"axis": -1} if layout else {}))
        net = pkg.sym.Activation(data=net, act_type="relu")
        net = pkg.sym.Pooling(data=net, kernel=(2, 2), stride=(2, 2),
                              pool_type="max", **kw)
        net = pkg.sym.Flatten(data=net)
        net = pkg.sym.FullyConnected(data=net, num_hidden=2, name="fc")
        return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _inputs(net, data_shape, seed=1):
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name == "data":
            args[name] = rng.rand(*shape).astype(np.float32)
        elif name == "softmax_label":
            args[name] = rng.randint(0, 2, shape).astype(np.float32)
        elif name.endswith("gamma"):
            args[name] = np.ones(shape, np.float32)
        else:
            args[name] = (rng.randn(*shape) * 0.1).astype(np.float32)
    aux = [np.ones(s, np.float32) if "var" in n else np.zeros(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)]
    return args, aux


def _run(pkg, executor_cls, net, args, aux, compute_dtype, train=True):
    """One forward (train mode) and backward of ``net`` under
    ``compute_dtype``: (output, grads by name, aux, executor)."""
    ctx = pkg.cpu()
    arrays = {k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()}
    grads = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in args.items()
             if k not in ("data", "softmax_label")}
    aux_arrays = [pkg.nd.array(v, ctx=ctx) for v in aux]
    ex = executor_cls(net, ctx, arrays, args_grad=grads,
                      aux_states=aux_arrays, compute_dtype=compute_dtype)
    ex.forward(is_train=train)
    out = ex.outputs[0].asnumpy().copy()
    if train:
        ex.backward()
    return (out, {k: g.asnumpy().copy() for k, g in grads.items()},
            [a.asnumpy().copy() for a in aux_arrays], ex)


@pytest.mark.parametrize("layout", [None, "NHWC"], ids=["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_executor_matches_jax_and_stays_float32(dtype, layout):
    """Forward and backward in 16 bits, port against JAX; outputs,
    gradients and moving statistics float32, and the outputs genuinely
    unlike the float32 run's."""
    shape = (8, 8, 8, 1) if layout else (8, 1, 8, 8)
    tnet, jnet = _net(tmx, layout), _net(jmx, layout)
    args, aux = _inputs(tnet, shape)
    t_out, t_grad, t_aux, tex = _run(tmx, TExecutor, tnet, args, aux, dtype)
    j_out, j_grad, j_aux, _ = _run(jmx, JExecutor, jnet, args, aux, dtype)
    f_out = _run(tmx, TExecutor, tnet, args, aux, None)[0]
    assert tex.compute_dtype == TORCH_DTYPE[dtype]
    assert t_out.dtype == np.float32 and t_out.shape == j_out.shape
    assert all(g.dtype == np.float32 for g in t_grad.values())
    assert all(a.dtype == np.float32 for a in t_aux)
    np.testing.assert_allclose(t_out, j_out, atol=OUT_TOL[dtype])
    assert not np.array_equal(t_out, f_out)
    np.testing.assert_allclose(t_out, f_out, atol=0.05)
    for name, ref in j_grad.items():
        if name == "c1_bias":
            scale = np.linalg.norm(j_grad["c1_weight"])
        else:
            scale = np.linalg.norm(ref)
        err = np.linalg.norm(t_grad[name] - ref)
        assert err <= GRAD_TOL[dtype] * max(scale, 1e-12), (name, err, scale)
    for a, b in zip(t_aux, j_aux):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-3)


def test_labels_with_1000_classes_are_never_cast():
    """A label variable named ``target`` (not ``*label``) with ids >= 256,
    which bfloat16 cannot hold: SoftmaxOutput's gradient subtracts one at
    each true class, in both packages alike."""
    labels = np.array([257, 513, 999, 0], np.float32)
    rng = np.random.RandomState(0)
    args = {"data": rng.rand(4, 8).astype(np.float32),
            "fc_weight": (rng.randn(1000, 8) * 0.01).astype(np.float32),
            "fc_bias": np.zeros(1000, np.float32), "target": labels}
    grads = {}
    for pkg, cls in ((tmx, TExecutor), (jmx, JExecutor)):
        with fresh_names(pkg):
            net = pkg.sym.FullyConnected(data=pkg.sym.Variable("data"),
                                         num_hidden=1000, name="fc")
            net = pkg.sym.SoftmaxOutput(data=net,
                                        label=pkg.sym.Variable("target"),
                                        name="softmax")
        ctx = pkg.cpu()
        g = {"fc_bias": pkg.nd.zeros((1000,), ctx=ctx)}
        ex = cls(net, ctx, {k: pkg.nd.array(v, ctx=ctx)
                            for k, v in args.items()},
                 args_grad=g, grad_req={"fc_bias": "write"},
                 compute_dtype="bfloat16", label_names=["target"])
        ex.forward(is_train=True)
        assert ex.outputs[0].shape == (4, 1000)
        ex.backward()
        grads[pkg.__name__] = g["fc_bias"].asnumpy()
    got, want = grads["mxnet_tpu_torch"], grads["mxnet_tpu"]
    # each true class has its softmax minus one, about -1
    assert np.all(got[labels.astype(int)] < -0.9)
    np.testing.assert_allclose(got, want, atol=OUT_TOL["bfloat16"])
    # the default label names: arguments ending in "label" are not cast
    net = _net(tmx)
    ex = net.simple_bind(tmx.cpu(), data=(2, 1, 8, 8),
                         compute_dtype="bfloat16")
    assert ex._label_names == ["softmax_label"]


def test_env_var_none_off_switch_and_bad_name(monkeypatch):
    """``MXNET_COMPUTE_DTYPE`` turns it on, an explicit None forces
    float32, a bad name raises naming the variable: in both packages."""
    net = _net(tmx)
    args, aux = _inputs(net, (8, 1, 8, 8))
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    on = _run(tmx, TExecutor, net, args, aux, None, train=False)
    ex = TExecutor(net, tmx.cpu(), {k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in args.items()},
                   aux_states=[tmx.nd.array(v, ctx=tmx.cpu()) for v in aux],
                   grad_req="null")
    assert ex.compute_dtype == torch.bfloat16
    env_out = ex.forward()[0].asnumpy()
    assert on[3].compute_dtype is None
    assert not np.array_equal(env_out, on[0])
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bf16")
    for pkg, cls in ((tmx, TExecutor), (jmx, JExecutor)):
        with pytest.raises(pkg.base.MXNetError, match="MXNET_COMPUTE_DTYPE"):
            cls(_net(pkg), pkg.cpu(), {k: pkg.nd.array(v, ctx=pkg.cpu())
                                       for k, v in args.items()},
                aux_states=[pkg.nd.array(v, ctx=pkg.cpu()) for v in aux],
                grad_req="null")


def _separable(n=128, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n).astype(np.float32)
    x = (rng.randn(n, 1, 8, 8) * 0.5 + y[:, None, None, None]).astype(
        np.float32)
    return x, y


def test_module_fit_under_the_env_var(monkeypatch):
    """The reference's Module path under ``MXNET_COMPUTE_DTYPE``: fits to
    accuracy > 0.9 with float32 params."""
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    x, y = _separable()
    tmx.random.seed(0)
    mod = tmx.mod.Module(_net(tmx), context=tmx.cpu(), logger=logging)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label"),
            num_epoch=4, optimizer_params={"learning_rate": 0.1})
    assert mod._exec_group.executor.compute_dtype == torch.bfloat16
    score = dict(mod.score(tmx.io.NDArrayIter(
        x, y, batch_size=32, label_name="softmax_label"), "acc"))
    assert score["accuracy"] > 0.9, score
    args, aux = mod.get_params()
    assert all(a.asnumpy().dtype == np.float32 for a in args.values())
    assert all(a.asnumpy().dtype == np.float32 for a in aux.values())


def _fit(x, y, fused, params, compute_dtype="bfloat16", layout=None):
    net = _net(tmx, layout)
    mod = tmx.mod.Module(net, context=tmx.cpu(), logger=logging,
                         compute_dtype=compute_dtype)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=16,
                               label_name="softmax_label"),
            num_epoch=1, arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                     for k, v in params.items()},
            initializer=None, fused_step=fused,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fused_step_equals_classic_bit_for_bit(dtype):
    """The fused step shares the executor's graph function, so under a
    compute dtype it equals the classic loop bit for bit, params and
    moving statistics alike, all float32."""
    x, y = _separable(64)
    x = x.transpose(0, 2, 3, 1).copy()
    net = _net(tmx, "NHWC")
    args, _ = _inputs(net, (16, 8, 8, 1))
    params = {k: v for k, v in args.items()
              if k not in ("data", "softmax_label")}
    classic = _fit(x, y, False, params, dtype, "NHWC")
    fused = _fit(x, y, True, params, dtype, "NHWC")
    assert fused._fused_step.eager_steps == 4
    for (a, b) in zip(classic.get_params(), fused.get_params()):
        for k in a:
            assert a[k].asnumpy().dtype == np.float32
            assert np.array_equal(a[k].asnumpy(), b[k].asnumpy()), k


def test_one_sgd_step_matches_jax(monkeypatch):
    """One SGD step under ``MXNET_COMPUTE_DTYPE=bfloat16`` through each
    package's Module from the same params: each param's update within
    the gradients' bound of the reference's (normwise)."""
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    x, y = _separable(16)
    args, _ = _inputs(_net(tmx), (16, 1, 8, 8))
    params = {k: v for k, v in args.items()
              if k not in ("data", "softmax_label")}
    after = {}
    for pkg in (tmx, jmx):
        mod = pkg.mod.Module(_net(pkg), context=pkg.cpu(), logger=logging)
        mod.bind(data_shapes=[("data", (16, 1, 8, 8))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in params.items()},
                        initializer=None)
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(x, ctx=pkg.cpu())],
            [pkg.nd.array(y, ctx=pkg.cpu())]))
        mod.update()
        after[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    got, want = after[tmx], after[jmx]
    assert all(v.dtype == np.float32 for v in got.values())
    for k in want:
        ref = "c1_weight" if k == "c1_bias" else k
        scale = np.linalg.norm(want[ref] - params[ref])
        err = np.linalg.norm(got[k] - want[k])
        assert err <= GRAD_TOL["bfloat16"] * max(scale, 1e-12), (k, err)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_k3_plain_on_16bit_operands_matches_pallas_interpret(transpose_a,
                                                             dt):
    """K3's plain version on 16-bit operands against the Pallas
    ``_matmul`` in interpret mode on the same operands: 16-bit products
    are exact in float32, so the float32 tolerance of
    test_pallas_conv.py holds (rtol 1e-5, atol 1e-4)."""
    rng = np.random.RandomState(3)
    a = rng.randn(*((384, 256) if transpose_a else (256, 384)))
    b = rng.randn(384, 128)
    ja, jb = jnp.asarray(a, dt), jnp.asarray(b, dt)
    ref = pk._matmul(ja, jb, (128, 128, 128), transpose_a=transpose_a)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
        TORCH_DTYPE[dt])
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(
        TORCH_DTYPE[dt])
    got = tk.matmul_f32acc(ta, tb, transpose_a)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


# (x NHWC, w OIHW, stride, pad): the stem (a 7x7/2 window over 3 channels,
# M = 147) and a 3x3 window over 3 channels (Fast R-CNN's first
# convolution, M = 27): 16-bit patches whose row is not a multiple of 8
# elements, written at a padded pitch
ODD_ROWS = {"stem_7x7_s2_c3": ((2, 20, 20, 3), (8, 3, 7, 7), (2, 2), (3, 3)),
            "3x3_c3": ((2, 9, 9, 3), (8, 3, 3, 3), (1, 1), (1, 1))}


@pytest.mark.parametrize("name", sorted(ODD_ROWS))
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_conv_grads_through_padded_pitch_patches_match_jax_vjp(name, dt,
                                                               monkeypatch):
    """The port's 16-bit conv2d gradients, whose weight gradient reads
    the patches at a pitch of the next multiple of 8 (152 or 32), against
    jax.vjp of lax.conv_general_dilated at HIGHEST precision on the same
    16-bit values in float32 (16-bit products are exact in float32). Each
    element within one unit in the last place of the 16-bit result (dx
    and dw come back rounded to the dtype) plus 1e-5 of the sum of its
    terms' magnitudes (another float32 summation order)."""
    xshape, wshape, stride, pad = ODD_ROWS[name]
    tdt = TORCH_DTYPE[dt]
    rng = np.random.RandomState(8)
    rnd = lambda a: torch.from_numpy(a.astype(np.float32)).to(tdt)
    xt, wt = rnd(rng.randn(*xshape)), rnd(rng.randn(*wshape) * 0.2)
    pitches = []
    real = tk.matmul_f32acc
    monkeypatch.setattr(tk, "matmul_f32acc", lambda a, b, transpose_a=False:
                        pitches.append((transpose_a, a.stride(0)))
                        or real(a, b, transpose_a))
    x = xt.clone().requires_grad_()
    w = wt.clone().requires_grad_()
    y = tk.conv2d(x.movedim(-1, 1), w, stride, pad)
    gt = rnd(rng.randn(*y.shape))
    (y.float() * gt.float()).sum().backward()
    kh, kw, c = wshape[2], wshape[3], wshape[1]
    assert (True, -(-kh * kw * c // 8) * 8) in pitches
    assert x.grad.dtype == w.grad.dtype == tdt

    dn = ("NHWC", "OIHW", "NCHW")

    def conv(a, b):
        return jax.lax.conv_general_dilated(
            a, b, window_strides=stride, padding=[(p, p) for p in pad],
            dimension_numbers=dn, precision=jax.lax.Precision.HIGHEST)

    x32, w32, g32 = (jnp.asarray(t.float().numpy()) for t in (xt, wt, gt))
    _, vjp = jax.vjp(conv, x32, w32)
    _, vjp_abs = jax.vjp(conv, jnp.abs(x32), jnp.abs(w32))
    for got, want, mag in zip((x.grad, w.grad), vjp(g32),
                              vjp_abs(jnp.abs(g32))):
        want = np.asarray(want, np.float64)
        ulp = np.spacing(np.abs(want).astype(TORCH_NP[dt])).astype(
            np.float64)
        err = np.abs(got.double().numpy() - want)
        assert np.all(err <= ulp + 1e-5 * np.asarray(mag, np.float64)), \
            float((err - ulp).max())


@pytest.mark.parametrize("act", ["none", "relu"])
def test_k4_k5_plain_in_float16_match_float64(act):
    """K4/K5's plain versions with float16 x: y and dx within half a
    float16 ulp of the float64 formula, plus the float32 intermediate's
    own rounding (2^-23 relative: the float32 result may sit on the other
    side of a float16 tie), dscale and dshift within 1e-5 of
    sum|term|."""
    rng = np.random.RandomState(7)
    x = (rng.randn(96, 24) * 2 + 0.5).astype(np.float16)
    g = rng.randn(96, 24).astype(np.float16)
    scale = (rng.rand(24) + 0.5).astype(np.float32)
    shift = rng.randn(24).astype(np.float32)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(shift)
    y = tk.fused_norm_act(tx, ts, tb, act)
    dx, ds, db = tk.fused_norm_act_bwd(tx, ts, tb, tg, act)
    assert y.dtype == dx.dtype == torch.float16
    assert ds.dtype == db.dtype == torch.float32
    x64, g64 = x.astype(np.float64), g.astype(np.float64)
    pre = x64 * scale + shift
    y64 = np.maximum(pre, 0) if act == "relu" else pre
    gm = np.where(pre > 0, g64, 0.0) if act == "relu" else g64
    ulp = np.spacing(np.abs(y64).astype(np.float16)).astype(np.float64)
    assert np.all(np.abs(y.double().numpy() - y64)
                  <= 0.5 * ulp + 2.0 ** -23 * np.abs(y64))
    dx64 = gm * scale
    ulp = np.spacing(np.abs(dx64).astype(np.float16)).astype(np.float64)
    assert np.all(np.abs(dx.double().numpy() - dx64)
                  <= 0.5 * ulp + 2.0 ** -23 * np.abs(dx64))
    for got, term in ((ds, gm * x64), (db, gm)):
        err = np.abs(got.double().numpy() - term.sum(0))
        assert np.all(err <= 1e-5 * np.abs(term).sum(0))


def test_checkpoint_under_compute_dtype_crosses_packages(tmp_path,
                                                        monkeypatch):
    """Mixed precision never changes what is stored: a module trained a
    step under bfloat16 in either package saves float32 params, and the
    other package loads them bit for bit (``interop.params_from_numpy``
    carries them unchanged)."""
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    x, y = _separable(16)
    args, _ = _inputs(_net(tmx), (16, 1, 8, 8))
    params = {k: v for k, v in args.items()
              if k not in ("data", "softmax_label")}
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        mod = src.mod.Module(_net(src), context=src.cpu(), logger=logging)
        mod.fit(src.io.NDArrayIter(x, y, batch_size=16,
                                   label_name="softmax_label"),
                num_epoch=1, initializer=None,
                arg_params={k: src.nd.array(v, ctx=src.cpu())
                            for k, v in params.items()},
                optimizer_params={"learning_rate": 0.1})
        prefix = str(tmp_path / src.__name__)
        mod.save_checkpoint(prefix, 1)
        saved = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        _, arg_params, aux_params = dst.model.load_checkpoint(prefix, 1)
        loaded = {k: v.asnumpy() for k, v in arg_params.items()}
        assert sorted(loaded) == sorted(saved)
        for k in saved:
            assert saved[k].dtype == loaded[k].dtype == np.float32
            assert np.array_equal(saved[k], loaded[k]), k
        assert all(v.asnumpy().dtype == np.float32
                   for v in aux_params.values())
        carried, _ = tmx.interop.params_from_numpy(
            _net(tmx), loaded, {k: v.asnumpy() for k, v in
                                aux_params.items()},
            ctx=tmx.cpu(), input_shapes={"data": (16, 1, 8, 8)})
        assert all(np.array_equal(carried[k].asnumpy(), saved[k])
                   for k in saved)
