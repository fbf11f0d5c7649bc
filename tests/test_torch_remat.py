"""The mirrored backward (``MXNET_BACKWARD_DO_MIRROR``, the executor's
segmented remat) on the CPU: the port's ``make_graph_eval(remat=True)``
against the JAX package's on the reference's own remat net, against the
port's plain walk (outputs, moving statistics and gradients exactly),
the segment plan, Dropout drawing its mask once, and whole fits through
both packages and through the port's fused step."""
import logging
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as tmx
from mxnet_tpu.executor import make_graph_eval as jax_graph_eval
from mxnet_tpu_torch.executor import make_graph_eval, remat_plan

from test_torch_common import fresh_names, small_resnet

MIRROR = "MXNET_BACKWARD_DO_MIRROR"


def _remat_net(pkg, dropout=0.0):
    """tests/test_executor.py::test_segmented_remat_matches_plain's net:
    9 FC + tanh, a BatchNorm whose aux crosses segments, SoftmaxOutput
    (with ``dropout``, a Dropout after the BatchNorm)."""
    with fresh_names(pkg):
        net = pkg.sym.Variable("data")
        for i in range(9):
            net = pkg.sym.FullyConnected(net, num_hidden=16,
                                         name="rfc%d" % i)
            net = pkg.sym.Activation(net, act_type="tanh")
        net = pkg.sym.BatchNorm(net, name="rbn")
        if dropout:
            net = pkg.sym.Dropout(net, p=dropout, name="drop")
        net = pkg.sym.FullyConnected(net, num_hidden=2, name="rcls")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _inputs(net, batch=4, width=16, seed=0):
    arg_shapes, _, aux_shapes = net.infer_shape(data=(batch, width))
    rng = np.random.RandomState(seed)
    args = [rng.randn(*s).astype(np.float32) * 0.3 for s in arg_shapes]
    lbl = net.list_arguments().index("softmax_label")
    args[lbl] = rng.randint(0, 2, (batch,)).astype(np.float32)
    aux = [np.ones(s, np.float32) if "var" in n else np.zeros(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)]
    return args, aux


def _torch_run(fn, args, aux, seed=0):
    """Outputs, new aux and the gradients of every argument (head
    gradients ones) of one train-mode call of ``fn``, as numpy."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    rng = torch.Generator().manual_seed(seed)
    outs, new_aux = fn(leaves, [torch.from_numpy(a.copy()) for a in aux],
                       rng, True)
    grads = torch.autograd.grad(outs, leaves,
                                [torch.ones_like(o) for o in outs],
                                allow_unused=True)
    return ([o.detach().numpy() for o in outs],
            [a.detach().numpy() for a in new_aux],
            [None if g is None else g.numpy() for g in grads])


def _jax_run(net, args, aux, remat):
    """The JAX package's walk: outputs, new aux and the gradients of every
    argument (cotangents ones on the outputs, zeros on the aux)."""
    import jax
    import jax.numpy as jnp

    fn, _ = jax_graph_eval(net, remat=remat)
    key = jax.random.PRNGKey(0)
    (outs, new_aux), vjp = jax.vjp(lambda a: fn(a, aux, key, True),
                                   [jnp.asarray(a) for a in args])
    (grads,) = vjp(([jnp.ones_like(o) for o in outs],
                    [jnp.zeros_like(a) for a in new_aux]))
    return tuple([np.asarray(v) for v in part]
                 for part in (outs, new_aux, grads))


def test_remat_matches_the_jax_remat_on_the_reference_net():
    """Both packages' remat walks on the reference's net, float32.

    rtol 1e-6 between the packages is out of reach in float32: their
    PLAIN walks already differ by up to 7.0e-6 relative in the outputs
    and 3.3e-3 in gradients near zero (another BLAS summation order,
    one-pass against two-pass BatchNorm statistics; a float64 run is not
    possible, K4 takes no float64). So the test holds what remat owes:
    each package's remat equals its own plain walk exactly, hence the
    port's remat differs from the JAX remat by exactly what the plain
    walks differ by (asserted element for element), and that difference
    is within the training tests' bound (outputs and aux rtol 1e-5 /
    atol 1e-7; gradients 1e-4 of their norm; measured 1.4e-5)."""
    args, aux = _inputs(_remat_net(jmx))
    jplain = _jax_run(_remat_net(jmx), args, aux, False)
    jremat = _jax_run(_remat_net(jmx), args, aux, True)
    tplain, _ = make_graph_eval(_remat_net(tmx))
    tremat, n_aux = make_graph_eval(_remat_net(tmx), remat=True)
    assert n_aux == jax_graph_eval(_remat_net(jmx))[1]
    tplain, tremat = (_torch_run(f, args, aux) for f in (tplain, tremat))
    lbl = _remat_net(tmx).list_arguments().index("softmax_label")
    for run in (jplain, jremat, tplain, tremat):
        run[2][lbl] = None    # the label's gradient: zero in one, None
    _assert_equal(jremat, jplain)
    _assert_equal(tremat, tplain)
    for part in range(3):
        for tr, jr, tp, jp in zip(tremat[part], jremat[part],
                                  tplain[part], jplain[part]):
            if tr is None:
                continue
            np.testing.assert_array_equal(tr - jr, tp - jp)
            if part < 2:
                np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-7)
            else:
                assert np.linalg.norm(tr - jr) <= 1e-4 * np.linalg.norm(jr)


def _plain_and_remat(net, args, aux, seed=0):
    plain, _ = make_graph_eval(net)
    remat, _ = make_graph_eval(net, remat=True)
    return _torch_run(plain, args, aux, seed), _torch_run(remat, args, aux,
                                                          seed)


def _assert_equal(got, want):
    for part_g, part_w in zip(got, want):
        for g, w in zip(part_g, part_w):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


def test_remat_equals_the_plain_walk_exactly_on_the_reference_net():
    net = _remat_net(tmx)
    args, aux = _inputs(net)
    plain, remat = _plain_and_remat(net, args, aux)
    _assert_equal(remat, plain)


def test_remat_equals_the_plain_walk_exactly_on_a_resnet():
    """A small NHWC ResNet, some of whose residual branch points are
    boundary values that their own run consumes too: autograd adds the
    later run's gradient contribution and the recomputed one, and a sum
    of two terms is the same in either order, so the gradients are equal
    exactly (a value with three or more consumers across runs could
    differ by rounding: rtol 1e-6 would bound it)."""
    net = small_resnet(tmx)
    shapes, _, aux_shapes = net.infer_shape(data=(2, 16, 16, 3))
    rng = np.random.RandomState(1)
    args = [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]
    args[net.list_arguments().index("softmax_label")] = \
        rng.randint(0, 10, 2).astype(np.float32)
    aux = [np.ones(s, np.float32) if "var" in n else np.zeros(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)]
    plans = remat_plan(net)
    branch = [k for run, _, out, _ in plans for k in out
              if any(k in [(src.uid, i) for src, i in n.inputs]
                     for n in run)]
    assert branch, "no boundary value has a consumer inside its run"
    plain, remat = _plain_and_remat(net, args, aux)
    _assert_equal(remat, plain)


def test_the_plan_cuts_the_reference_way():
    """max(2, isqrt(N)) segments of ceil(N / segments) op nodes, every
    op node once, in topological order; boundary keys are what a later
    run or the outputs consume; a Dropout is a run of its own that is
    not recomputed."""
    for dropout in (0.0, 0.3):
        net = _remat_net(tmx, dropout)
        ops = [n for n in net._topo() if not n.is_variable]
        plans = remat_plan(net)
        assert [n for run, _, _, _ in plans for n in run] == ops
        n_seg = max(2, math.isqrt(len(ops)))
        size = -(-len(ops) // n_seg)
        pinned = [run[0].name for run, _, _, rec in plans if not rec]
        assert pinned == (["drop"] if dropout else [])
        assert all(len(run) <= size for run, _, _, _ in plans)
        produced = {}
        for ri, (run, ins, outs, _) in enumerate(plans):
            for k in ins:
                assert produced.get(k[0], -1) < ri
            for n in run:
                produced[n.uid] = ri
        last = plans[-1]
        assert last[2] == sorted((n.uid, i) for n, i in net._outputs)


def test_dropout_draws_its_mask_once_and_the_same_mask():
    """Mirrored and not, one train forward+backward of the Dropout net:
    the Dropout op draws once a call (never again while the backward
    recomputes), the same mask in both, and every output, moving
    statistic and gradient is equal exactly."""
    from mxnet_tpu_torch.ops import nn

    net = _remat_net(tmx, dropout=0.4)
    args, aux = _inputs(net)
    masks = []
    orig = nn.Dropout.apply

    def spy(self, ctx, inputs, aux_):
        outs, new = orig(self, ctx, inputs, aux_)
        masks.append((outs[0] != 0).numpy().copy())
        return outs, new

    nn.Dropout.apply = spy
    try:
        plain, remat = _plain_and_remat(net, args, aux, seed=3)
    finally:
        nn.Dropout.apply = orig
    assert len(masks) == 2
    np.testing.assert_array_equal(masks[0], masks[1])
    assert 0 < masks[0].mean() < 1
    _assert_equal(remat, plain)


def test_executor_reads_the_variable_at_bind(monkeypatch):
    """``MXNET_BACKWARD_DO_MIRROR`` at bind: ``Executor.mirror``; a
    mirrored executor's forward/backward equals the plain one's exactly,
    with ``compute_dtype`` (bfloat16), with ``group2ctx`` and with a
    monitor installed (the plain walk)."""
    net = _remat_net(tmx)
    args, aux = _inputs(net)
    names = net.list_arguments()

    def run(mirror, **kw):
        monkeypatch.setenv(MIRROR, "1" if mirror else "0")
        a = {n: tmx.nd.array(v, ctx=tmx.cpu()) for n, v in zip(names, args)}
        g = {n: tmx.nd.zeros(v.shape, ctx=tmx.cpu())
             for n, v in zip(names, args)}
        x = {n: tmx.nd.array(v, ctx=tmx.cpu())
             for n, v in zip(net.list_auxiliary_states(), aux)}
        ex = net.bind(tmx.cpu(), a, args_grad=g, aux_states=x, **kw)
        assert ex.mirror == mirror
        seen = []
        if kw.pop("monitor", False):
            ex.set_monitor_callback(lambda n, v: seen.append(n))
        ex.forward(is_train=True)
        ex.backward()
        return ([o.asnumpy() for o in ex.outputs],
                [v.asnumpy() for v in g.values()],
                [v.asnumpy() for v in ex.aux_arrays]), seen

    for kw in ({}, {"compute_dtype": "bfloat16"},
               {"group2ctx": {"dev1": tmx.cpu(1)}}):
        (plain, _), (mirrored, _) = run(False, **kw), run(True, **kw)
        _assert_equal(mirrored, plain)
    monkeypatch.setenv(MIRROR, "1")
    a = {n: tmx.nd.array(v, ctx=tmx.cpu()) for n, v in zip(names, args)}
    x = {n: tmx.nd.array(v, ctx=tmx.cpu())
         for n, v in zip(net.list_auxiliary_states(), aux)}
    ex = net.bind(tmx.cpu(), a, aux_states=x)
    seen = []
    ex.set_monitor_callback(lambda n, v: seen.append(n))
    ex.forward(is_train=True)
    assert "rbn_output" in seen


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------
BATCH = 4
STEPS = 3
OPT = (("learning_rate", 0.01), ("momentum", 0.9), ("wd", 1e-4))


def _fit(pkg, sym, args, aux, x, y, fused_step=False):
    losses = []

    def record(param):
        probs = param.locals["self"].get_outputs()[0].asnumpy()
        lab = y[param.nbatch * BATCH:(param.nbatch + 1) * BATCH]
        losses.append(-np.log(probs.astype(np.float64)[
            np.arange(BATCH), lab.astype(int)]).mean())

    mod = pkg.mod.Module(sym, context=pkg.cpu(), logger=logging)
    kw = {"fused_step": fused_step} if pkg is tmx else {}
    pkg.random.seed(0)
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            arg_params=args, aux_params=aux, optimizer="sgd",
            optimizer_params=OPT, batch_end_callback=record, **kw)
    a, x_ = mod.get_params()
    return (np.array(losses), {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x_.items()})


def test_mirrored_fit_matches_the_jax_mirrored_fit(monkeypatch):
    """3 SGD steps of the small NHWC ResNet with the variable set in both
    packages, from JAX-initialised params (the blocks' last BatchNorm
    gamma at 0.25): test_torch_train.py's bound (loss rtol 1e-4, params
    and aux rtol 1e-3 / atol 1e-5); the port's mirrored fit equals its
    unmirrored one exactly."""
    monkeypatch.setenv(MIRROR, "1")
    shape = (BATCH, 32, 32, 3)
    jmx.random.seed(1)
    jsym = small_resnet(jmx)
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", shape)], for_training=False)
    jmod.init_params(jmx.init.Xavier(magnitude=2.0))
    a0, x0 = ({k: v.asnumpy() for k, v in p.items()}
              for p in jmod.get_params())
    for k in a0:
        if k.endswith("_b3_bn_gamma"):
            a0[k] = np.full_like(a0[k], 0.25)
    rng = np.random.RandomState(9)
    x = rng.randn(STEPS * BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, STEPS * BATCH).astype(np.float32)
    ref = _fit(jmx, jsym, {k: jmx.nd.array(v) for k, v in a0.items()},
               {k: jmx.nd.array(v) for k, v in x0.items()}, x, y)
    tsym = small_resnet(tmx)
    targs, taux = tmx.interop.params_from_numpy(
        tsym, a0, x0, tmx.cpu(), input_shapes={"data": shape})
    got = _fit(tmx, tsym, targs, taux, x, y)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    for mine, theirs in ((got[1], ref[1]), (got[2], ref[2])):
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-3,
                                       atol=1e-5, err_msg=k)
    monkeypatch.setenv(MIRROR, "0")
    targs, taux = tmx.interop.params_from_numpy(
        tsym, a0, x0, tmx.cpu(), input_shapes={"data": shape})
    plain = _fit(tmx, tsym, targs, taux, x, y)
    np.testing.assert_array_equal(got[0], plain[0])
    for mine, theirs in ((got[1], plain[1]), (got[2], plain[2])):
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("fused_step", [False, True])
def test_mirrored_dropout_fit_equals_the_unmirrored_one(monkeypatch,
                                                        fused_step):
    """The Dropout net through fit (classic loop and the fused step),
    mirrored and not, from the same params and generator seed: losses,
    params and moving statistics equal exactly."""
    with fresh_names(tmx):
        net = _remat_net(tmx, dropout=0.3)
    shapes, _, aux_shapes = net.infer_shape(data=(BATCH, 16),
                                            softmax_label=(BATCH,))
    rng = np.random.RandomState(4)
    params = {n: (rng.randn(*s) * 0.3).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    x = rng.randn(STEPS * BATCH, 16).astype(np.float32)
    y = rng.randint(0, 2, STEPS * BATCH).astype(np.float32)
    runs = []
    for mirror in ("0", "1"):
        monkeypatch.setenv(MIRROR, mirror)
        runs.append(_fit(tmx, net,
                         {k: tmx.nd.array(v, ctx=tmx.cpu())
                          for k, v in params.items()}, None, x, y,
                         fused_step=fused_step))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for part in (1, 2):
        for k in runs[0][part]:
            np.testing.assert_array_equal(runs[1][part][k],
                                          runs[0][part][k], err_msg=k)


def test_mirrored_fused_step_equals_the_mirrored_classic_loop(monkeypatch):
    """The small NHWC ResNet mirrored: fit(fused_step=True) equals the
    classic loop bit for bit on the CPU (the step runs eagerly there)."""
    monkeypatch.setenv(MIRROR, "1")
    with fresh_names(tmx):
        net = tmx.models.get_resnet([1, 1, 1, 1], [8, 8, 16, 16, 32],
                                    num_classes=10, small_input=True,
                                    layout="NHWC")
    rng = np.random.RandomState(2)
    x = rng.randn(STEPS * BATCH, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 10, STEPS * BATCH).astype(np.float32)
    shapes, _, aux_shapes = net.infer_shape(data=(BATCH, 16, 16, 3))
    params = {n: (rng.randn(*s) * 0.2).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    runs = [_fit(tmx, net, {k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in params.items()}, None, x, y,
                 fused_step=fused) for fused in (False, True)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[1][1][k], runs[0][1][k],
                                      err_msg=k)
