"""Parity of the port's sequence ops, its fused RNN and the LSTM
language models with the JAX package's (CPU, seeded inputs).

The RNN runs in all four modes, one and two directions, 2 layers, at
T=5, N=3, in=4, H=6: through the op (``torch._VF``, the native loop on
the CPU) against the JAX op (``lax.scan``) and against the port's plain
per-step loop (``ops.seq.rnn_plain``). The two sum the input and hidden
projections in another order than XLA: outputs and states within rtol
1e-5 / atol 1e-5, gradients within rtol 1e-4 / atol 1e-5."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (jmx.models)
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.seq import rnn_param_size, rnn_plain
from test_torch_common import assert_parity, both_fwd_bwd, fresh_names

T, N, IN, H, LAYERS = 5, 3, 4, 6, 2


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LENGTHS = np.array([3, 5, 1], np.float32)


@pytest.mark.parametrize("op,params,use_len", [
    ("SequenceLast", {}, False), ("SequenceLast", {}, True),
    ("SequenceMask", {}, False), ("SequenceMask", {"value": -2.0}, True),
    ("SequenceReverse", {}, False), ("SequenceReverse", {}, True)])
def test_sequence_ops_match_jax(op, params, use_len):
    args = {"data": _x(T, N, 2, 2)}
    if use_len:
        args["len"] = LENGTHS

    def build(pkg):
        ins = [pkg.sym.Variable("data")]
        if use_len:
            ins.append(pkg.sym.Variable("len"))
        return getattr(pkg.sym, op)(*ins, use_sequence_length=use_len,
                                    name="op", **params)

    want, got = both_fwd_bwd(build, args, grad_names=["data"])
    assert_parity(got, want)


def _rnn_args(mode, bidirectional, seed=0):
    dirs = 2 if bidirectional else 1
    size = rnn_param_size(LAYERS, IN, H, bidirectional, mode)
    rng = np.random.RandomState(seed)
    args = {"data": rng.randn(T, N, IN).astype(np.float32),
            "parameters": (rng.randn(size) * 0.3).astype(np.float32),
            "state": rng.randn(LAYERS * dirs, N, H).astype(np.float32)}
    if mode == "lstm":
        args["state_cell"] = rng.randn(LAYERS * dirs, N, H).astype(
            np.float32)
    return args


def _rnn(mode, bidirectional, names):
    def build(pkg):
        return pkg.sym.RNN(
            name="rnn", state_size=H, num_layers=LAYERS, mode=mode,
            bidirectional=bidirectional, state_outputs=True,
            **{k: pkg.sym.Variable(k) for k in names})
    return build


MODES = ["rnn_relu", "rnn_tanh", "lstm", "gru"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_matches_jax_and_the_plain_loop(mode, bidirectional):
    args = _rnn_args(mode, bidirectional)
    want, got = both_fwd_bwd(_rnn(mode, bidirectional, list(args)), args)
    assert_parity(got, want, atol=1e-5, grad_atol=1e-5)
    out, h_n, c_n = rnn_plain(
        *[torch.from_numpy(args[k]) for k in ("data", "parameters",
                                              "state")],
        torch.from_numpy(args["state_cell"]) if mode == "lstm" else None,
        mode, LAYERS, H, bidirectional)
    plain = [out, h_n] + ([c_n] if mode == "lstm" else [])
    for a, b in zip(got[0], plain):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-5)


def test_rnn_param_size_and_shapes_match_jax():
    for mode in MODES:
        for bi in (False, True):
            assert rnn_param_size(3, 7, 5, bi, mode) == \
                jmx.ops.seq.rnn_param_size(3, 7, 5, bi, mode)
            net = {pkg: pkg.sym.RNN(pkg.sym.Variable("data"), state_size=5,
                                    num_layers=3, mode=mode,
                                    bidirectional=bi, state_outputs=True)
                   for pkg in (jmx, tmx)}
            shapes = [net[pkg].infer_shape(data=(4, 2, 7))
                      for pkg in (jmx, tmx)]
            assert shapes[0] == shapes[1]
            assert net[tmx].list_arguments() == net[jmx].list_arguments()
            assert net[tmx].list_outputs() == net[jmx].list_outputs()


def test_rnn_dropout_draws_from_the_executor_generator():
    """p > 0 between layers in train mode: masks from the executor's
    generator (the same seed gives the same output, another seed another
    one), the layer outputs scaled by 1/(1-p); no dropout at inference,
    where the op equals the JAX op."""
    args = _rnn_args("lstm", False)
    net = tmx.sym.RNN(name="rnn", state_size=H, num_layers=LAYERS,
                      mode="lstm", p=0.5,
                      **{k: tmx.sym.Variable(k) for k in args})
    assert net._outputs[0][0].op.draws_random
    ctx = tmx.cpu()

    def run(seed, is_train):
        ex = tmx.executor.Executor(
            net, ctx, {k: tmx.nd.array(v, ctx=ctx) for k, v in args.items()},
            seed=seed)
        return ex.forward(is_train=is_train)[0].asnumpy()

    a, b, c = run(1, True), run(1, True), run(2, True)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    infer = run(1, False)
    assert not np.array_equal(a, infer)
    jnet = jmx.sym.RNN(name="rnn", state_size=H, num_layers=LAYERS,
                       mode="lstm", p=0.5,
                       **{k: jmx.sym.Variable(k) for k in args})
    want = jnet.bind(jmx.cpu(), {k: jmx.nd.array(v)
                                 for k, v in args.items()}).forward()
    np.testing.assert_allclose(infer, want[0].asnumpy(), rtol=1e-5,
                               atol=1e-5)


V, E, HID, L, B = 20, 6, 8, 2, 4


def _lm_params(sym, data_shapes, seed=0):
    shapes, _, _ = sym.infer_shape(**data_shapes)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in data_shapes}


@pytest.mark.parametrize("form", ["lstm_unroll", "lstm_fused"])
def test_lstm_models_match_jax(form):
    """Both LM forms: the same argument, output and auxiliary names in
    the same order, and the same forward from the same params."""
    seq = 5
    with fresh_names(tmx):
        tsym = getattr(tmx.models, form)(L, seq, V, HID, E, V)
    with fresh_names(jmx):
        jsym = getattr(jmx.models, form)(L, seq, V, HID, E, V)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert len(tsym.get_internals()) == len(jsym.get_internals())
    rng = np.random.RandomState(1)
    data = {"data": rng.randint(0, V, (B, seq)).astype(np.float32),
            "softmax_label": rng.randint(0, V, (B, seq)).astype(np.float32)}
    if form == "lstm_unroll":
        for i in range(L):
            for k in "hc":
                data["l%d_init_%s" % (i, k)] = rng.randn(B, HID).astype(
                    np.float32)
    else:
        data["lstm_state"] = np.zeros((L, B, HID), np.float32)
        data["lstm_state_cell"] = np.zeros((L, B, HID), np.float32)
    args = dict(data, **_lm_params(tsym, {k: v.shape
                                          for k, v in data.items()}))
    want, got = both_fwd_bwd(lambda pkg: getattr(pkg.models, form)(
        L, seq, V, HID, E, V), args,
        grad_names=[k for k in args if k not in data])
    assert got[0][0].shape == (B * seq, V)
    assert_parity(got, want, atol=1e-5, grad_atol=1e-5)


def test_unrolled_graph_at_sixty_steps_builds_and_infers():
    """lstm_unroll at the largest bucket of the card's run: the graph
    walks without recursion and infers every shape."""
    sym = tmx.models.lstm_unroll(2, 60, 100, 16, 8, 100)
    shapes = {"data": (4, 60), "softmax_label": (4, 60)}
    shapes.update({"l%d_init_%s" % (i, k): (4, 16) for i in range(2)
                   for k in "hc"})
    arg_shapes, out_shapes, _ = sym.infer_shape(**shapes)
    assert out_shapes == [(240, 100)]
    assert len(sym._topo()) > 1500
    assert dict(zip(sym.list_arguments(), arg_shapes))["cls_weight"] == \
        (100, 16)
