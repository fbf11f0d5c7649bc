"""Parity of the port's CTC ops with the JAX package's (CPU, seeded numpy
inputs): the negative log-likelihood, WarpCTC with flat and (B, L)
labels, CTCLoss, forward and VJP within rtol 1e-4 (the alpha recursion
sums in float32 over T steps in another op order); an independent check
against ``torch.nn.functional.ctc_loss``; shape and dtype inference;
symbol JSON; and two ``Module.fit`` steps of a narrow LSTM-OCR (one LSTM
layer of 16, T=12) into WarpCTC against the JAX package."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.ctc import ctc_neg_log_likelihood
from test_torch_common import (assert_parity, both_fwd_bwd, chip_smoke,
                               fresh_names)
from test_torch_vision_ops import check_fit_parity, fit_steps, seeded_params

T, B, A, L = 12, 3, 6, 4
TOL = dict(rtol=1e-4, atol=1e-5, grad_rtol=1e-4, grad_atol=1e-5)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# blank 0; padded rows, a blank inside a row (dropped), a repeat (the
# skip rule), an empty row
LABELS = np.array([[1, 2, 2, 5], [3, 0, 4, 0], [0, 0, 0, 0]], np.float32)


def test_nll_matches_jax_and_torch_ctc_loss():
    from mxnet_tpu.ops.ctc import ctc_neg_log_likelihood as jax_nll

    logits = _x(T, B, A, seed=1)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    got = ctc_neg_log_likelihood(lp, torch.from_numpy(LABELS)).numpy()
    import jax
    want = np.asarray(jax_nll(jax.nn.log_softmax(logits, -1), LABELS))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # independent: torch's own CTC on the left-justified labels
    lens = (LABELS != 0).sum(1)
    targets = np.concatenate([r[r != 0] for r in LABELS]).astype(np.int64)
    ref = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(targets), torch.full((B,), T),
        torch.from_numpy(lens), blank=0, reduction="none")
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4)


@pytest.mark.parametrize("flat", [False, True])
def test_warpctc_matches_jax(flat):
    label = LABELS.reshape(-1) if flat else LABELS
    args = {"data": _x(T * B, A, seed=2), "label": label}

    def build(pkg):
        return pkg.sym.WarpCTC(pkg.sym.Variable("data"),
                               pkg.sym.Variable("label"), label_length=L,
                               input_length=T, name="op")

    want, got = both_fwd_bwd(build, args, grad_names=["data"])
    assert_parity(got, want, **TOL)
    assert np.isfinite(got[1]["data"]).all() and got[1]["data"].any()
    np.testing.assert_allclose(got[0][0].sum(1), 1.0, atol=1e-6)


def test_warpctc_infers_the_reference_shapes_and_types():
    for pkg in (jmx, tmx):
        s = pkg.sym.WarpCTC(pkg.sym.Variable("data"),
                            pkg.sym.Variable("label"), label_length=L,
                            input_length=T)
        assert s.infer_shape(data=(T * B, A)) == (
            [(T * B, A), (B * L,)], [(T * B, A)], [])
        assert s.infer_shape(data=(T * B, A), label=(B, L))[0][1] == (B, L)
        assert s.infer_type(data="float32") == (
            [np.float32, np.float32], [np.float32], [])
    with pytest.raises(tmx.MXNetError, match="divisible"):
        tmx.sym.WarpCTC(tmx.sym.Variable("data"), label_length=L,
                        input_length=5).infer_shape(data=(T * B, A))


def test_ctcloss_matches_jax():
    args = {"data": _x(T, B, A, seed=3), "label": LABELS}

    def build(pkg):
        return pkg.sym.ctc_loss(pkg.sym.Variable("data"),
                                pkg.sym.Variable("label"), name="op")

    want, got = both_fwd_bwd(build, args, grad_names=["data"])
    assert_parity(got, want, **TOL)
    assert got[0][0].shape == (B,) and got[0][0].dtype == np.float32


@pytest.mark.parametrize("op,params", [
    ("WarpCTC", dict(label_length=4, input_length=80)),
    ("CTCLoss", {}), ("ctc_loss", {})])
def test_symbol_json_crosses_both_ways(op, params):
    js, ts = [], []
    for pkg, out in ((jmx, js), (tmx, ts)):
        with fresh_names(pkg):
            out.append(getattr(pkg.sym, op)(pkg.sym.Variable("data"),
                                            pkg.sym.Variable("label"),
                                            name="op", **params))
    assert ts[0].tojson() == js[0].tojson()
    assert tmx.sym.load_json(js[0].tojson()).tojson() == js[0].tojson()
    assert jmx.sym.load_json(ts[0].tojson()).tojson() == ts[0].tojson()


# -- a narrow LSTM-OCR through Module.fit ---------------------------------
OCR_T, OCR_FEAT, OCR_HIDDEN, OCR_LAYERS, OCR_BATCH = 12, 5, 16, 1, 4
OCR_LABEL, OCR_CLASSES = 4, 11


def test_narrow_lstm_ocr_fit_matches_jax():
    cs = chip_smoke
    batches = cs.ocr_batches(2, seq_len=OCR_T, feat=OCR_FEAT,
                             batch=OCR_BATCH, hidden=OCR_HIDDEN,
                             layers=OCR_LAYERS)
    data_names = ["data"] + ["l%d_init_%s" % (i, k)
                             for i in range(OCR_LAYERS) for k in "hc"]
    build = dict(seq_len=OCR_T, hidden=OCR_HIDDEN, layers=OCR_LAYERS,
                 num_label=OCR_LABEL, classes=OCR_CLASSES)
    tsym, jsym = cs.lstm_ocr(tmx, **build), cs.lstm_ocr(jmx, **build)
    shapes = {n: batches[0][n].shape for n in data_names + ["label"]}
    params = seeded_params(tsym, shapes, scale=0.2)
    opt = (("learning_rate", 0.01), ("momentum", 0.9),
           ("clip_gradient", 1.0), ("rescale_grad", 1.0 / OCR_BATCH))
    want = fit_steps(jmx, jsym, params, batches, data_names, ["label"], opt,
                     metric=cs.ocr_metric)
    got = fit_steps(tmx, tsym, params, batches, data_names, ["label"], opt,
                    metric=cs.ocr_metric)
    check_fit_parity(got, want, params)
