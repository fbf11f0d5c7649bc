"""Every graph that trains on one context trains over several (ROADMAP.md
Queue A item 10a, its last parts): the port over 2 and 4 ``cpu(i)``
contexts against the JAX package on the suite's forced 8-device CPU
platform (whose executors see global arrays) and against the port on
one context.

* The numerics plane's skip guard over ``dp`` and under fsdp 2
  (mxnet_tpu_torch/fused_step.py, numwatch.py): a batch with NaN in one
  context's rows only makes every replica skip; its params, momenta and
  metric sums bit-identical to before; the pack (folded from each
  card's shards under fsdp) against the JAX package's fused step on the
  same params and batches: counts, stamps, steps and skips exact, sums
  and the loss rtol 1e-5 / atol 1e-7.
* fsdp with ``grad_req="add"`` and with an optimizer that has no
  fusable plan (``Test``; SGLD's noise by its moments): the reduced
  gradients and the params against the JAX package's over 2 devices
  under the same ``MXNET_TPU_MESH_FSDP=2`` (rtol 1e-5 / atol 1e-6).
* The ops that couple the batch (``sum``/``max``/``min`` over axis 0 and
  over every axis, and over time or over the batch of time-major (T, N,
  C) data, ``softmax_cross_entropy``, IdentityAttachKLSparseReg
  with its moving average, ROIPooling with rois naming other contexts'
  images): outputs, input and parameter gradients and aux states over 4
  contexts against the JAX package's (rtol 1e-5 / atol 1e-6; max/min
  with ties across contexts share the gradient as JAX does, exactly).
* ``lstm_unroll``'s time-major (T * N, V) output joined in the global
  order and a seeded head gradient cut by the same layout: outputs
  and parameter gradients against the JAX package's (rtol 1e-5 / atol
  1e-6); a layout the graph does not determine still raises.
* A small bucketed LM ``fit`` over 2 contexts (the buckets share the
  owner's per-context arrays): params against the JAX package's fit
  over 2 devices and the port's on one context (rtol 1e-4 / atol 1e-6),
  the NLL metric within rel 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.fused_step import make_fused_step as jmake
from mxnet_tpu_torch.fused_step import make_fused_step as tmake

from test_torch_common import (CKPT_BATCH, CKPT_DIM, ckpt_data, ckpt_mlp,
                               ckpt_params, fresh_names)
from test_torch_numwatch import assert_packs_match

RTOL, ATOL = 1e-5, 1e-6


def _ctxs(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _host(arrays):
    return {k: v.asnumpy().copy() for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# the numerics plane: skip guard and fold over dp and fsdp
# ---------------------------------------------------------------------------
def _plane_env(monkeypatch, fsdp):
    monkeypatch.setenv("MXNET_TPU_FUSED_STEP", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_EVERY_N", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "skip")
    if fsdp:
        monkeypatch.setenv("MXNET_TPU_MESH_FSDP", str(fsdp))


def _batch(pkg, x, y):
    return next(iter(pkg.io.NDArrayIter(x, y, batch_size=CKPT_BATCH)))


def _guarded_run(pkg, make, n, poisoned_rows):
    """b0, a batch with NaN in ``poisoned_rows`` only, b1 through a
    fused step over ``n`` contexts: the packs after each step, the
    skips, and (the port) the state before and after the NaN batch."""
    net = ckpt_mlp(pkg)
    x, y = ckpt_data(2)
    mod = pkg.mod.Module(net, context=_ctxs(pkg, n))
    mod.bind([("data", (CKPT_BATCH, CKPT_DIM))],
             [("softmax_label", (CKPT_BATCH,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in ckpt_params(net).items()},
                    initializer=None)
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05,
                                         "momentum": 0.9})
    metric = pkg.metric.create("acc")
    step = make(mod, metric)
    plane = step._numwatch
    bad = x[:CKPT_BATCH].copy()
    bad[poisoned_rows] = np.nan
    batches = [_batch(pkg, x[:CKPT_BATCH], y[:CKPT_BATCH]),
               _batch(pkg, bad, y[:CKPT_BATCH]),
               _batch(pkg, x[CKPT_BATCH:], y[CKPT_BATCH:])]
    packs, skips, state = [], [], {"step": step}
    for k, batch in enumerate(batches):
        if k == 1 and pkg is tmx:
            state["before"] = _port_state(mod, metric)
        step.step(batch, metric)
        extras = plane.after_step()
        packs.append(np.asarray(plane._pack).copy())
        skips.append(extras["numwatch_skips"])
        if k == 1 and pkg is tmx:
            state["after"] = _port_state(mod, metric)
            state["copies"] = [p.cpu().numpy().copy()
                               for p in plane._copies.values()]
    return packs, skips, state, mod


def _port_state(mod, metric):
    """Every replica's weights (its shards under fsdp) and optimizer
    states, and the metric's device sums, as numpy."""
    out = []
    for updater, items in zip(mod._updaters, mod._update_items()):
        for i, g, w in items:
            out.append(w.asnumpy().copy())
            st = updater.states.get(i)
            if st is not None:
                out.append(st.asnumpy().copy())
    out.append(metric._acc.numpy().copy())
    out.extend(a.numpy().copy() for a in metric._replica_accs.values())
    return out


@pytest.mark.parametrize("n,fsdp,rows", [(4, 0, [4, 5]), (2, 2, [6])])
def test_skip_guard_over_dp_and_fsdp_restores_every_card(n, fsdp, rows,
                                                         monkeypatch):
    """NaN in one context's rows: every replica skips (its state
    bit-identical), and the pack (each card's shards folded, combined
    across the fsdp line) follows the JAX package's through the three
    steps."""
    _plane_env(monkeypatch, fsdp)
    want, want_skips, _, _ = _guarded_run(jmx, jmake, n, rows)
    got, got_skips, state, mod = _guarded_run(tmx, tmake, n, rows)
    assert got_skips == want_skips == [0, 1, 1]
    for k, (mine, theirs) in enumerate(zip(got, want)):
        assert_packs_match(mine, theirs, "step %d" % (k + 1))
    for a, b in zip(state["before"], state["after"]):
        assert np.array_equal(a, b)
    for copy in state["copies"]:     # every card holds the same pack
        np.testing.assert_array_equal(copy, got[1])
    if fsdp:
        assert mod._exec_group.shards is not None
        assert state["step"]._numwatch._masks   # a replicated param
    assert state["step"].eager_steps == 3


def test_fsdp_pack_equals_the_dp_pack(monkeypatch):
    """The fold over fsdp 2 shards gives the whole-array fold's pack over
    dp 2: counts and stamps exact, sums rtol 1e-5."""
    _plane_env(monkeypatch, 0)
    dp, _, _, _ = _guarded_run(tmx, tmake, 2, [1])
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "2")
    fsdp, _, _, _ = _guarded_run(tmx, tmake, 2, [1])
    for mine, theirs in zip(fsdp, dp):
        assert_packs_match(mine, theirs)


# ---------------------------------------------------------------------------
# fsdp: grad_req "add" and an optimizer without a fusable plan
# ---------------------------------------------------------------------------
def _fsdp_module(pkg, grad_req="write", optimizer="sgd", opt_params=None):
    net = ckpt_mlp(pkg)
    mod = pkg.mod.Module(net, context=_ctxs(pkg, 2))
    mod.bind([("data", (CKPT_BATCH, CKPT_DIM))],
             [("softmax_label", (CKPT_BATCH,))], grad_req=grad_req)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in ckpt_params(net).items()},
                    initializer=None)
    mod.init_optimizer(kvstore="device", optimizer=optimizer,
                       optimizer_params=opt_params or
                       {"learning_rate": 0.05})
    return mod


def _grads(pkg, mod):
    """The parameters' gradients over the whole batch (under fsdp joined
    from the reduced shards)."""
    rex = getattr(mod._exec_group, "replicated", None)
    if pkg is tmx and rex is not None:
        return {n: g.asnumpy().copy() for n, g in
                zip(rex.arg_names, rex.grad_arrays) if g is not None
                and n in mod._param_names}
    ex = mod._exec_group.executor
    return {n: ex.grad_dict[n].asnumpy().copy() for n in mod._param_names}


@pytest.mark.parametrize("case", ["add", "test_optimizer"])
def test_fsdp_accumulates_and_runs_a_classic_optimizer_as_jax(case,
                                                              monkeypatch):
    """grad_req "add" accumulates each pass's reduced gradient in the
    shards; ``Test`` (no fusable plan) updates each card's shards: the
    gradients and params equal the JAX package's over 2 devices (rtol
    1e-5 / atol 1e-6)."""
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "2")
    x, y = ckpt_data(2)
    runs = []
    for pkg in (jmx, tmx):
        if case == "add":
            mod = _fsdp_module(pkg, grad_req="add")
        else:
            mod = _fsdp_module(pkg, optimizer="test",
                               opt_params={"rescale_grad": 0.1})
        for b in range(2):
            mod.forward_backward(_batch(pkg, x[b * CKPT_BATCH:
                                               (b + 1) * CKPT_BATCH],
                                        y[b * CKPT_BATCH:
                                          (b + 1) * CKPT_BATCH]))
            if case != "add":
                mod.update()
        runs.append((_grads(pkg, mod), _host(mod.get_params()[0])))
    if case == "add":
        assert mod._exec_group.shards.adds
    for mine, theirs in zip(runs[1], runs[0]):
        assert mine.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def test_sgld_under_fsdp_draws_its_noise_on_each_shard(monkeypatch):
    """SGLD under fsdp 2 over 4 contexts (dp 2 x fsdp 2): the update's
    noise, ``w_new - (w - lr / 2 * g)``, has mean 0 and variance lr
    (within 5 standard errors over every param's elements), and the two
    dp lines hold the same weights."""
    monkeypatch.setenv("MXNET_TPU_MESH_FSDP", "2")
    lr = 0.04
    net = ckpt_mlp(tmx)
    mod = tmx.mod.Module(net, context=_ctxs(tmx, 4))
    mod.bind([("data", (CKPT_BATCH, CKPT_DIM))],
             [("softmax_label", (CKPT_BATCH,))])
    params = ckpt_params(net)
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in params.items()},
                    initializer=None)
    mod.init_optimizer(kvstore="device", optimizer="sgld",
                       optimizer_params={"learning_rate": lr,
                                         "rescale_grad": 1.0})
    x, y = ckpt_data(1)
    mod.forward_backward(_batch(tmx, x, y))
    grads = _grads(tmx, mod)
    tmx.random.seed(5)
    mod.update()
    after = _host(mod.get_params()[0])
    noise = np.concatenate([(after[k] - (params[k] - lr / 2 * grads[k]))
                            .ravel() for k in params])
    se = np.sqrt(lr / noise.size)
    assert abs(noise.mean()) < 5 * se
    assert abs(noise.var() / lr - 1) < 5 * np.sqrt(2.0 / noise.size)
    group = mod._exec_group
    for k in (2, 3):
        for name, w, _ in group.update_arrays(k):
            np.testing.assert_array_equal(
                w.asnumpy(), group.update_arrays(k - 2)[
                    [n for n, _, _ in group.update_arrays(k - 2)]
                    .index(name)][1].asnumpy())


# ---------------------------------------------------------------------------
# the ops that couple the batch
# ---------------------------------------------------------------------------
N4 = 4
ROWS = 8


def _coupled(pkg, kind):
    """A graph over ``data`` (and ``rois``): a FullyConnected (its
    params' gradients go through the exchange) then the coupled op; a
    ``tnc_`` reduction over time-major (T, N, C) data goes through tanh."""
    with fresh_names(pkg):
        data = pkg.sym.Variable("data")
        if kind.startswith("tnc_"):
            _, op, axis = kind.split("_")
            act = pkg.sym.Activation(data, act_type="tanh")
            fn = getattr(pkg.sym, op)
            out = fn(act, name="red") if axis == "all" else fn(
                act, axis=int(axis), name="red")
            return pkg.sym.MakeLoss(out * 2.0, name="loss")
        if kind == "roi":
            rois = pkg.sym.Variable("rois")
            return pkg.sym.ROIPooling(data, rois, pooled_size=(2, 2),
                                      spatial_scale=0.5, name="pool")
        fc = pkg.sym.FullyConnected(data, num_hidden=6, name="fc")
        if kind == "xent":
            label = pkg.sym.Variable("softmax_label")
            return pkg.sym.softmax_cross_entropy(fc, label, name="ce")
        if kind == "klreg":
            act = pkg.sym.Activation(pkg.sym.Reshape(fc, shape=(-1, 3, 2)),
                                     act_type="sigmoid")
            return pkg.sym.IdentityAttachKLSparseReg(act, name="kl",
                                                     penalty=0.5)
        op, axis = kind.split("_")
        fn = getattr(pkg.sym, op)
        out = fn(fc, name="red") if axis == "all" else fn(fc, axis=0,
                                                          name="red")
        return pkg.sym.MakeLoss(out * 2.0, name="loss")


def _coupled_inputs(kind):
    rng = np.random.RandomState(3)
    if kind == "roi":
        data = rng.randn(N4, 2, 8, 8).astype(np.float32)
        # two rois a context, each naming another context's image
        idx = np.array([3, 1, 2, 0, 1, 3, 0, 2], np.float32)
        boxes = rng.randint(0, 14, (ROWS, 4)).astype(np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 2)
        return {"data": data, "rois": np.concatenate(
            [idx[:, None], boxes], axis=1)}
    data = rng.randn(*((3, ROWS, 4) if kind.startswith("tnc_")
                       else (ROWS, 4))).astype(np.float32)
    if "max" in kind or "min" in kind:
        data = np.round(data)       # ties across the contexts' rows
    out = {"data": data}
    if kind == "xent":
        out["softmax_label"] = rng.randint(0, 6, ROWS).astype(np.float32)
    return out


def _coupled_run(pkg, kind, n):
    """Outputs, gradients (params and data) and aux after one train
    forward and backward (ones as head gradients where the graph takes
    them) over ``n`` contexts."""
    net = _coupled(pkg, kind)
    inputs = _coupled_inputs(kind)
    labels = [k for k in inputs if k == "softmax_label"]
    names = [k for k in inputs if k not in labels]
    mod = pkg.mod.Module(net, data_names=names, label_names=labels,
                         context=_ctxs(pkg, n))
    layout = "TNC" if kind.startswith("tnc_") else "NCHW"
    mod.bind([pkg.io.DataDesc(k, inputs[k].shape, layout=layout)
              for k in names],
             [(k, inputs[k].shape) for k in labels] or None,
             inputs_need_grad=True)
    arg_shapes, _, aux_shapes = net.infer_shape(
        **{k: v.shape for k, v in inputs.items()})
    rng = np.random.RandomState(7)
    params = {name: (rng.randn(*shape) * 0.5).astype(np.float32)
              for name, shape in zip(net.list_arguments(), arg_shapes)
              if name not in inputs}
    aux = {name: np.full(shape, 0.3, np.float32) for name, shape in
           zip(net.list_auxiliary_states(), aux_shapes)}
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in params.items()},
                    aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in aux.items()},
                    initializer=None)
    mod.forward(pkg.io.DataBatch(
        [pkg.nd.array(inputs[k], ctx=pkg.cpu()) for k in names],
        [pkg.nd.array(inputs[k], ctx=pkg.cpu()) for k in labels]),
        is_train=True)
    outs = [o.asnumpy().copy() for o in mod.get_outputs()]
    mod.backward()
    grads = _grads(pkg, mod) if params else {}
    grads["data"] = mod.get_input_grads()[0].asnumpy().copy()
    mod._params_dirty = True
    _, aux_after = mod.get_params()
    return outs, grads, _host(aux_after)


COUPLED = ["sum_0", "sum_all", "max_0", "max_all", "min_0", "min_all",
           "xent", "klreg", "roi",
           # time-major data, its batch on axis 1: over time each replica's
           # own, over the batch (a negative axis too) across the replicas
           "tnc_sum_0", "tnc_sum_1", "tnc_sum_all", "tnc_max_-2",
           "tnc_max_0", "tnc_min_1", "tnc_min_-3"]


@pytest.mark.parametrize("kind", COUPLED)
def test_batch_coupled_ops_over_contexts_match_jax(kind):
    """Over 4 contexts each op gives the global batch's value on every
    replica, and its gradient: outputs, the params' and the data's
    gradients and the aux states against the JAX package's (rtol 1e-5
    / atol 1e-6) and the port's one context."""
    want = _coupled_run(jmx, kind, 1)
    got = _coupled_run(tmx, kind, N4)
    one = _coupled_run(tmx, kind, 1)
    for ref in (want, one):
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        for part in (1, 2):
            assert got[part].keys() == ref[part].keys()
            for k in ref[part]:
                np.testing.assert_allclose(got[part][k], ref[part][k],
                                           rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# time-major outputs, the bucketed LM
# ---------------------------------------------------------------------------
LM_L, LM_H, LM_V, LM_B = 1, 8, 20, 4
LM_INIT = ["l%d_init_%s" % (i, k) for i in range(LM_L) for k in "ch"]


def _lm_sym(pkg, seq_len, head=False):
    with fresh_names(pkg):
        net = pkg.models.lstm_unroll(LM_L, seq_len, LM_V, LM_H, LM_H, LM_V)
    if head:
        net = net.get_internals()["pred_output"]
    return net


def _lm_params(seq_len=4):
    net = _lm_sym(tmx, seq_len)
    shapes, _, _ = net.infer_shape(data=(LM_B, seq_len),
                                   softmax_label=(LM_B, seq_len),
                                   **{n: (LM_B, LM_H) for n in LM_INIT})
    rng = np.random.RandomState(11)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ["data", "softmax_label"] + LM_INIT}


def _lm_batch(pkg, seq_len, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, LM_V, (LM_B, seq_len)).astype(np.float32)
    lab = np.zeros_like(ids)
    lab[:, :-1] = ids[:, 1:]
    data = [pkg.nd.array(ids, ctx=pkg.cpu())] + [
        pkg.nd.zeros((LM_B, LM_H), ctx=pkg.cpu()) for _ in LM_INIT]
    return pkg.io.DataBatch(
        data, [pkg.nd.array(lab, ctx=pkg.cpu())], bucket_key=seq_len,
        provide_data=[pkg.io.DataDesc("data", (LM_B, seq_len))] + [
            pkg.io.DataDesc(n, (LM_B, LM_H)) for n in LM_INIT],
        provide_label=[pkg.io.DataDesc("softmax_label", (LM_B, seq_len))])


def _lm_head_run(pkg, n, seq_len=4):
    net = _lm_sym(pkg, seq_len, head=True)
    mod = pkg.mod.Module(net, data_names=["data"] + LM_INIT, label_names=[],
                         context=_ctxs(pkg, n))
    batch = _lm_batch(pkg, seq_len, 1)
    mod.bind(batch.provide_data)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _lm_params(seq_len).items()},
                    initializer=None)
    mod.forward(pkg.io.DataBatch(batch.data, []), is_train=True)
    out = mod.get_outputs()[0].asnumpy().copy()
    head = np.random.RandomState(2).randn(*out.shape).astype(np.float32)
    mod.backward([pkg.nd.array(head, ctx=pkg.cpu())])
    return out, _grads(pkg, mod)


def test_lstm_unroll_time_major_output_joins_and_slices_as_jax():
    """lstm_unroll's (T * N, V) prediction over 2 contexts: joined in the
    global time-major order and its head gradient cut the same way, as
    the JAX package's global arrays (rtol 1e-5 / atol 1e-6)."""
    got = _lm_head_run(tmx, 2)
    want = _lm_head_run(jmx, 1)
    assert got[0].shape == (4 * LM_B, LM_V)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _nll(label, pred):
    lab = label.T.reshape(-1).astype(int)
    return float(-np.log(pred[np.arange(len(lab)), lab]).sum()), len(lab)


def _lm_fit(pkg, n):
    def sym_gen(seq_len):
        return (_lm_sym(pkg, seq_len), tuple(["data"] + LM_INIT),
                ("softmax_label",))

    mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                  context=_ctxs(pkg, n))
    first = _lm_batch(pkg, 6, 0)
    mod.bind(first.provide_data, first.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _lm_params(6).items()},
                    initializer=None)
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    metric = pkg.metric.CustomMetric(_nll, name="nll")
    for seq_len, seed in [(6, 1), (3, 2), (6, 3), (3, 4)]:
        batch = _lm_batch(pkg, seq_len, seed)
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        mod.update_metric(metric, batch.label)
    return mod, _host(mod.get_params()[0]), metric.get()[1]


def test_bucketed_lm_fit_over_contexts_matches_jax_and_one_context():
    """The buckets' modules over 2 contexts share the owner's arrays (the
    same tensors a context) and the fit's params and NLL equal the JAX
    package's over 2 devices and the port's on one context (params rtol
    1e-4 / atol 1e-6, the metric rel 1e-5)."""
    mod, params, nll = _lm_fit(tmx, 2)
    owner = mod._buckets[6]._exec_group
    other = mod._buckets[3]._exec_group
    for k in range(2):
        for name in _lm_params(6):
            assert other.execs[k].arg_dict[name] is \
                owner.execs[k].arg_dict[name]
    assert other.replicated.flats is owner.replicated.flats
    for want_params, want_nll in (_lm_fit(jmx, 2)[1:], _lm_fit(tmx, 1)[1:]):
        assert nll == pytest.approx(want_nll, rel=1e-5)
        for k in want_params:
            np.testing.assert_allclose(params[k], want_params[k], rtol=1e-4,
                                       atol=ATOL, err_msg=k)


def test_a_shared_module_over_other_contexts_raises():
    owner = tmx.mod.Module(ckpt_mlp(tmx), context=_ctxs(tmx, 2))
    owner.bind([("data", (CKPT_BATCH, CKPT_DIM))],
               [("softmax_label", (CKPT_BATCH,))])
    mod = tmx.mod.Module(ckpt_mlp(tmx), context=[tmx.cpu(2), tmx.cpu(3)])
    with pytest.raises(tmx.MXNetError, match="same contexts"):
        mod.bind([("data", (CKPT_BATCH, CKPT_DIM))],
                 [("softmax_label", (CKPT_BATCH,))], shared_module=owner)


def test_a_reduction_over_an_underivable_layout_raises_naming_its_node():
    """A reshape that cuts the batch leaves the reduction after it no
    layout to decide from: the forward over 4 contexts raises, naming the
    reduction's node."""
    with fresh_names(tmx):
        x = tmx.sym.Reshape(tmx.sym.Variable("data"), shape=(-1, 8))
        net = tmx.sym.MakeLoss(tmx.sym.sum(x, axis=0, name="red"))
    mod = tmx.mod.Module(net, data_names=["data"], label_names=[],
                         context=_ctxs(tmx, N4))
    mod.bind([("data", (ROWS, 4))])
    mod.init_params()
    batch = tmx.io.DataBatch([tmx.nd.zeros((ROWS, 4), ctx=tmx.cpu())], [])
    with pytest.raises(tmx.MXNetError,
                       match="node red: sum over several contexts"):
        mod.forward(batch, is_train=False)


def test_a_batch_spanning_op_serves_at_dp_and_is_refused_on_a_tp_grid():
    """A sum over the batch served over 4 contexts: at dp 4 the served
    value is one context's (rtol 1e-5 / atol 1e-6); on a (dp 2, tp 2)
    grid the tp line's copies of a shard would count twice in the
    cross-card sum, so the server refuses it, naming the node."""
    def module(n):
        with fresh_names(tmx):
            fc = tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                        num_hidden=3, name="fc")
            net = tmx.sym.broadcast_plus(
                fc, tmx.sym.sum(fc, axis=0, keepdims=True, name="red"))
        mod = tmx.mod.Module(net, label_names=(), context=_ctxs(tmx, n))
        mod.bind([("data", (ROWS, 4))], for_training=False)
        rng = np.random.RandomState(5)
        mod.init_params(initializer=None, arg_params={
            "fc_weight": tmx.nd.array(rng.randn(3, 4).astype(np.float32),
                                      ctx=tmx.cpu()),
            "fc_bias": tmx.nd.array(rng.randn(3).astype(np.float32),
                                    ctx=tmx.cpu())})
        return mod

    x = np.random.RandomState(6).randn(ROWS, 4).astype(np.float32)
    got = []
    for n, tp in ((1, None), (N4, None)):
        with tmx.serving.InferenceServer(module(n), max_batch=ROWS,
                                         max_wait_ms=1.0, slo_ms=0.0,
                                         tp=tp) as srv:
            got.append(np.asarray(srv.infer([x])[0]))
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)
    with pytest.raises(tmx.MXNetError, match="red combine rows of the "
                                             "whole batch"):
        tmx.serving.InferenceServer(module(N4), tp=2)


def test_layouts_follow_reshape_concat_slice_and_transpose():
    """The derivation on its own: a (N, T, C) input split along time,
    concatenated time-major, transposed back and flattened."""
    from mxnet_tpu_torch.batch_layout import derive, join, part

    with fresh_names(tmx):
        x = tmx.sym.Variable("data")
        steps = tmx.sym.SliceChannel(x, num_outputs=3, axis=1,
                                     squeeze_axis=True)
        tm = tmx.sym.Concat(*[steps[i] for i in range(3)], num_args=3,
                            dim=0)
        back = tmx.sym.SwapAxis(tmx.sym.Reshape(tm, shape=(3, -1, 5)),
                                dim1=0, dim2=1)
        net = tmx.sym.Group([tm, tmx.sym.Flatten(back)])
    lays = derive(net, {"data": (2, 3, 5)}, {"data": (4, 3, 5)},
                  {"data": 0}, 2)
    outs = [lays[(node.uid, i)] for node, i in net._outputs]
    assert outs[0] == (((3, False), (4, True)), ((5, False),))
    assert outs[1] == (((4, True),), ((3, False), (5, False)))
    whole = torch.arange(12 * 5, dtype=torch.float32).reshape(12, 5)
    parts = [part(whole, outs[0], k, 2) for k in range(2)]
    assert torch.equal(parts[1][0], whole[2])      # t 0, n 2
    assert torch.equal(join(parts, outs[0]), whole)


def test_process_replicas_gather_rows_and_extreme_over_a_group():
    """The same two exchanges over the ranks of a process group (the
    sharded train step's replica set), on a one-rank gloo group: the
    gathered rows are the rank's own, with their gradient, and the
    extremes are its own."""
    import torch.distributed as dist

    from mxnet_tpu_torch.parallel import sharding as tsh
    from mxnet_tpu_torch.replicas import ProcessReplicas

    tsh.make_mesh({"dp": 1}, device_type="cpu")
    try:
        reps = ProcessReplicas("cpu", dist.group.WORLD, 1)
        x = torch.arange(6.0).reshape(3, 2).requires_grad_()
        (rows,) = reps.all_gather_rows([x])
        (rows * torch.arange(6.0).reshape(3, 2)).sum().backward()
        assert torch.equal(rows.detach(), x.detach())
        assert torch.equal(x.grad, torch.arange(6.0).reshape(3, 2))
        hi, lo = torch.tensor([1.0, 5.0]), torch.tensor([1.0, 5.0])
        reps.extreme_([hi])
        reps.extreme_([lo], largest=False)
        assert hi.tolist() == lo.tolist() == [1.0, 5.0]
    finally:
        dist.destroy_process_group()
        tsh._Last.mesh = None
