"""Parity of the port's vision ops with the JAX package's (CPU, seeded
numpy inputs): ROIPooling, SpatialTransformer, Correlation, the sample
ops and softmax_cross_entropy, forward and VJP (outputs rtol 1e-5 / atol
1e-6, gradients rtol 1e-5 / atol 1e-6: the same arithmetic, summed in
another order); their symbol JSON across the packages; and two steps of
``Module.fit`` of a narrow Fast R-CNN (two convs, 16 rois) against the
JAX package.

ROIPooling's rois are ragged on purpose: a roi past the map's edge (its
outer bins clip to empty: 0, no gradient), rois smaller than the bin
grid (bins overlap), a fractional and an out-of-range batch index, and
a zero plateau (ReLU-like zeros), where the gradient of a bin is split
equally over every tied position, as JAX's max VJP splits it."""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import kernels
from test_torch_common import (assert_parity, both_fwd_bwd, chip_smoke,
                               fresh_names, fwd_bwd)

TOL = dict(rtol=1e-5, atol=1e-6, grad_rtol=1e-5, grad_atol=1e-6)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# [batch_idx, x1, y1, x2, y2] in image pixels (spatial_scale 0.5 below)
ROIS = np.array([
    [0, 0, 0, 21, 17],      # the whole map
    [1, 4, 2, 13, 9],       # inside
    [0, 14, 10, 40, 30],    # past the bottom-right edge: empty outer bins
    [1, 6, 6, 7, 7],        # smaller than the 3x2 grid: bins overlap
    [1.7, 2, 3, 11, 15],    # batch index truncated to 1
    [5, 0, 0, 5, 5],        # batch index past the end: clamped to 1
    [0, 1, 1, 9, 9],        # over the zero plateau
], np.float32)


def _roi_data():
    x = _x(2, 3, 9, 11, seed=1)
    x[0, :, :5, :5] = 0.0           # a ReLU's zero plateau
    return x


def _roi_build(pkg):
    return pkg.sym.ROIPooling(pkg.sym.Variable("data"),
                              pkg.sym.Variable("rois"), pooled_size=(3, 2),
                              spatial_scale=0.5, name="op")


def test_roipooling_matches_jax():
    args = {"data": _roi_data(), "rois": ROIS}
    want, got = both_fwd_bwd(_roi_build, args, grad_names=["data"])
    assert_parity(got, want, **TOL)
    out = got[0][0]
    assert out.shape == (len(ROIS), 3, 3, 2)
    # the roi past the edge: its last row and column of bins are empty
    assert (out[2, :, 2, :] == 0).all() and (out[2, :, :, 1] == 0).all()


def test_roipooling_splits_a_tied_bins_gradient_equally():
    """One roi, one bin over a 4x4 zero plateau: every position gets
    g / 16 (torch.max(dim) or an argmax would send all of g to one)."""
    x = np.zeros((1, 1, 6, 6), np.float32)
    x[0, 0, 4:, 4:] = -1.0
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)

    def build(pkg):
        return pkg.sym.ROIPooling(pkg.sym.Variable("data"),
                                  pkg.sym.Variable("rois"),
                                  pooled_size=(1, 1), spatial_scale=1.0,
                                  name="op")

    want, got = both_fwd_bwd(build, {"data": x, "rois": rois},
                             grad_names=["data"])
    assert_parity(got, want, **TOL)
    rng = np.random.RandomState(17)
    g = rng.randn(1, 1, 1, 1).astype(np.float32)[0, 0, 0, 0]
    grad = got[1]["data"][0, 0]
    np.testing.assert_array_equal(grad[:4, :4], np.full((4, 4), g / 16,
                                                        np.float32))
    assert not grad[4:].any() and not grad[:, 4:].any()


def test_roipooling_nan_and_inf_bins_give_zero_and_no_gradient():
    """A bin that holds a NaN or whose max is +inf gives 0 and takes no
    gradient, in both packages; its other pixels take none either."""
    x = np.random.RandomState(0).rand(1, 2, 6, 6).astype(np.float32)
    x[0, 0, 1, 1] = np.nan
    x[0, 1, 4, 4] = np.inf
    rois = np.array([[0, 0, 0, 5, 5]], np.float32)

    def build(pkg):
        return pkg.sym.ROIPooling(pkg.sym.Variable("data"),
                                  pkg.sym.Variable("rois"),
                                  pooled_size=(2, 2), spatial_scale=1.0,
                                  name="op")

    want, got = both_fwd_bwd(build, {"data": x, "rois": rois},
                             grad_names=["data"])
    assert_parity(got, want, **TOL)
    out, grad = got[0][0][0], got[1]["data"][0]
    assert out[0, 0, 0] == 0 and out[1, 1, 1] == 0
    assert np.isfinite(grad).all()
    assert not grad[0, :3, :3].any() and not grad[1, 3:, 3:].any()


def test_roipooling_plain_chunks_and_bounded_gradient_agree():
    """The plain version's chunks of rois and its chunk-by-chunk
    gradient give what one chunk and autograd give."""
    data = torch.from_numpy(_roi_data())
    rois = torch.from_numpy(ROIS)
    g = torch.from_numpy(_x(len(ROIS), 3, 3, 2, seed=4))
    full = kernels.roi_pool_plain(data, rois, (3, 2), 0.5)
    d = data.clone().requires_grad_()
    ref = torch.autograd.grad(kernels.roi_pool_plain(d, rois, (3, 2), 0.5),
                              d, g)[0]
    old = kernels.ROI_PLAIN_CHUNK_ELEMS
    kernels.ROI_PLAIN_CHUNK_ELEMS = 2 * 3 * 6 * 9 * 11   # two rois a chunk
    try:
        assert torch.equal(kernels.roi_pool_plain(data, rois, (3, 2), 0.5),
                           full)
        got = kernels.roi_pool_plain_grad(data, rois, g, (3, 2), 0.5)
    finally:
        kernels.ROI_PLAIN_CHUNK_ELEMS = old
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)
    assert kernels.launch_counts()["roi_pool"] == 0


@pytest.mark.parametrize("theta", [
    [1, 0, 0, 0, 1, 0],
    [0.8, -0.3, 0.1, 0.25, 0.9, -0.2],
    [1.4, 0.2, 0.5, -0.1, 1.3, 0.6],        # taps past the edge
])
def test_spatial_transformer_matches_jax(theta):
    n = 2
    loc = np.tile(np.asarray(theta, np.float32), (n, 1))
    loc[1] += _x(6, seed=3) * 0.05
    args = {"data": _x(n, 3, 7, 9, seed=2), "loc": loc}

    def build(pkg):
        return pkg.sym.SpatialTransformer(pkg.sym.Variable("data"),
                                          pkg.sym.Variable("loc"),
                                          target_shape=(5, 6), name="op")

    want, got = both_fwd_bwd(build, args)
    assert_parity(got, want, **TOL)


@pytest.mark.parametrize("params", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1,
         pad_size=0, is_multiply=True),
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
         pad_size=2, is_multiply=True),
    dict(kernel_size=1, max_displacement=1, stride1=1, stride2=1,
         pad_size=1, is_multiply=False),
])
def test_correlation_matches_jax(params):
    args = {"data1": _x(2, 4, 7, 8, seed=5), "data2": _x(2, 4, 7, 8, seed=6)}

    def build(pkg):
        return pkg.sym.Correlation(pkg.sym.Variable("data1"),
                                   pkg.sym.Variable("data2"), name="op",
                                   **params)

    want, got = both_fwd_bwd(build, args)
    assert_parity(got, want, **TOL)


def test_correlation_wraps_around_the_padded_map():
    """Without padding a displacement reads the other side of the map
    (``roll``), not zeros: the output at the border equals the product
    with the wrapped column."""
    a, b = _x(1, 2, 5, 6, seed=7), _x(1, 2, 5, 6, seed=8)
    sym = tmx.sym.Correlation(tmx.sym.Variable("data1"),
                              tmx.sym.Variable("data2"), kernel_size=1,
                              max_displacement=1, stride1=1, stride2=1,
                              pad_size=0, name="op")
    (out,), _, _ = fwd_bwd(tmx, sym, {"data1": a, "data2": b}, (),
                           is_train=False)
    # output (1, 9, 3, 4) reads rows 1..3, cols 1..4; displacement
    # (dy, dx) = (1, 1) is channel 8
    want = (a * np.roll(b, (-1, -1), axis=(2, 3))).sum(1) / 2
    np.testing.assert_allclose(out[0, 8], want[0, 1:4, 1:5], rtol=1e-6)
    assert out[0, 8, :, -1].all()        # the wrapped column is not zero


def test_softmax_cross_entropy_matches_jax():
    args = {"data": _x(5, 7, seed=9),
            "label": np.array([0, 6, 3, 3.7, 1], np.float32)}

    def build(pkg):
        return pkg.sym.softmax_cross_entropy(pkg.sym.Variable("data"),
                                             pkg.sym.Variable("label"),
                                             name="op")

    want, got = both_fwd_bwd(build, args, grad_names=["data"])
    assert_parity(got, want, **TOL)
    assert got[0][0].shape == (1,)


SAMPLE_N = 1 << 16


@pytest.mark.parametrize("op,params,mean,var", [
    ("uniform", dict(low=-2.0, high=3.0), 0.5, 25.0 / 12),
    ("_sample_uniform", dict(), 0.5, 1.0 / 12),
    ("normal", dict(loc=1.5, scale=2.0), 1.5, 4.0),
    ("_sample_normal", dict(), 0.0, 1.0),
])
@pytest.mark.parametrize("is_train", [False, True])
def test_sample_ops_draw_by_distribution_in_both_modes(op, params, mean, var,
                                                       is_train):
    """Mean and variance within 4 sigma over 2^16 draws, in train and in
    inference, in both packages (their generators differ, so only the
    distributions are compared); two forwards draw anew."""
    draws = {}
    for pkg in (jmx, tmx):
        sym = getattr(pkg.sym, op)(shape=(SAMPLE_N,), name="op", **params)
        ex = sym.bind(pkg.cpu(), {}, grad_req="null")
        ex.forward(is_train=is_train)
        first = ex.outputs[0].asnumpy().copy()
        ex.forward(is_train=is_train)
        draws[pkg] = (first, ex.outputs[0].asnumpy())
    for first, second in draws.values():
        assert first.shape == (SAMPLE_N,) and first.dtype == np.float32
        assert not np.array_equal(first, second)
        x = first.astype(np.float64)
        # the variance of the sample mean and of the sample variance
        m4 = 9.0 / 5 * var ** 2 if "uniform" in op else 3 * var ** 2
        assert abs(x.mean() - mean) < 4 * np.sqrt(var / SAMPLE_N)
        assert abs(x.var() - var) < 4 * np.sqrt((m4 - var ** 2) / SAMPLE_N)


def test_sample_op_serves_through_fused_infer():
    """FusedInfer over a graph with a sample op draws from the
    executor's generator, a new draw a call."""
    with fresh_names(tmx):
        net = tmx.sym.Variable("data") + tmx.sym.normal(shape=(4, 3),
                                                        name="noise")
    ex = net.simple_bind(tmx.cpu(), grad_req="null", data=(4, 3))
    infer = tmx.fused_step.make_fused_infer(ex, ["data"])
    (a,), _ = infer([np.zeros((4, 3), np.float32)])
    (b,), _ = infer([np.zeros((4, 3), np.float32)])
    assert a.shape == (4, 3) and not torch.equal(a, b)
    assert ex.draws_random()


NEW_OPS = [
    ("ROIPooling", ["data", "rois"], dict(pooled_size=(7, 7),
                                          spatial_scale=0.0625)),
    ("SpatialTransformer", ["data", "loc"], dict(target_shape=(4, 5))),
    ("Correlation", ["data1", "data2"], dict(max_displacement=3, stride2=2,
                                             pad_size=3, kernel_size=1)),
    ("uniform", [], dict(low=-1.0, high=2.0, shape=(2, 3))),
    ("_sample_uniform", [], dict(shape=(5,))),
    ("normal", [], dict(scale=2.0, shape=(3, 1))),
    ("_sample_normal", [], dict(loc=0.5, shape=(4,))),
    ("softmax_cross_entropy", ["data", "label"], {}),
]


@pytest.mark.parametrize("op,inputs,params", NEW_OPS)
def test_symbol_json_crosses_both_ways(op, inputs, params):
    js, ts = [], []
    for pkg, out in ((jmx, js), (tmx, ts)):
        with fresh_names(pkg):
            out.append(getattr(pkg.sym, op)(
                *[pkg.sym.Variable(n) for n in inputs], name="op", **params))
    assert ts[0].tojson() == js[0].tojson()
    assert tmx.sym.load_json(js[0].tojson()).tojson() == js[0].tojson()
    assert jmx.sym.load_json(ts[0].tojson()).tojson() == ts[0].tojson()


# -- a narrow Fast R-CNN through Module.fit -------------------------------
RCNN_BATCH, RCNN_ROIS, RCNN_CLASSES = 2, 16, 4
RCNN_SHAPE = (RCNN_BATCH, 3, 16, 24)


def rcnn_symbol(pkg):
    """conv1 -> pool -> conv2 -> ROIPooling(2x2, 1/2) -> fc6 -> cls_score
    into SoftmaxOutput, bbox_pred into smooth_l1 of the weighted
    difference into MakeLoss; the two heads grouped."""
    s = pkg.sym
    with fresh_names(pkg):
        x = s.Activation(s.Convolution(s.Variable("data"), kernel=(3, 3),
                                       pad=(1, 1), num_filter=4,
                                       name="conv1"), act_type="relu")
        x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        x = s.Activation(s.Convolution(x, kernel=(3, 3), pad=(1, 1),
                                       num_filter=8, name="conv2"),
                         act_type="relu")
        x = s.ROIPooling(x, s.Variable("rois"), pooled_size=(2, 2),
                         spatial_scale=0.5, name="roi_pool5")
        x = s.Activation(s.FullyConnected(s.Flatten(x), num_hidden=16,
                                          name="fc6"), act_type="relu")
        cls = s.SoftmaxOutput(s.FullyConnected(x, num_hidden=RCNN_CLASSES,
                                               name="cls_score"),
                              s.Variable("label"), name="cls_prob")
        bbox = s.FullyConnected(x, num_hidden=4 * RCNN_CLASSES,
                                name="bbox_pred")
        diff = s.Variable("bbox_weight") * (bbox - s.Variable("bbox_target"))
        loss = s.MakeLoss(s.smooth_l1(diff, scalar=1.0),
                          grad_scale=1.0 / RCNN_ROIS, name="bbox_loss")
        return s.Group([cls, loss])


def rcnn_batches(steps, seed=0):
    """Seeded images and, for each, rois in pixels with labels and
    bbox regression targets: lists of numpy dicts, one a batch."""
    rng = np.random.RandomState(seed)
    out = []
    h, w = RCNN_SHAPE[2:]
    for _ in range(steps):
        x1 = rng.randint(0, w - 4, RCNN_ROIS)
        y1 = rng.randint(0, h - 4, RCNN_ROIS)
        rois = np.stack([np.arange(RCNN_ROIS) % RCNN_BATCH, x1, y1,
                         x1 + rng.randint(3, 12, RCNN_ROIS),
                         y1 + rng.randint(3, 10, RCNN_ROIS)], 1)
        label = rng.randint(0, RCNN_CLASSES, RCNN_ROIS)
        weight = np.zeros((RCNN_ROIS, 4 * RCNN_CLASSES), np.float32)
        for i, c in enumerate(label):
            if c:
                weight[i, 4 * c:4 * c + 4] = 1.0
        out.append({"data": rng.randn(*RCNN_SHAPE).astype(np.float32),
                    "rois": rois.astype(np.float32),
                    "label": label.astype(np.float32),
                    "bbox_target": (rng.randn(RCNN_ROIS, 4 * RCNN_CLASSES)
                                    * 0.5).astype(np.float32),
                    "bbox_weight": weight})
    return out


def first_head_accuracy(pkg):
    """The classification head's accuracy (the bbox head has no label
    of its own to score)."""

    class RCNNAccuracy(pkg.metric.EvalMetric):
        def __init__(self):
            super().__init__("rcnn_acc")

        def update(self, labels, preds):
            pred = preds[0].asnumpy().argmax(axis=1)
            lab = labels[0].asnumpy().astype(int)
            self.sum_metric += float((pred == lab).sum())
            self.num_inst += len(lab)

    return RCNNAccuracy()


def fit_steps(pkg, sym, params, batches, data_names, label_names, opt,
              fixed=(), metric=first_head_accuracy):
    """``Module.fit`` on the CPU over ``batches`` from numpy ``params``:
    (each batch's first output, final params, the metric) as numpy;
    ``metric(pkg)`` makes the metric."""
    outs = []

    def record(param):
        outs.append(param.locals["self"].get_outputs()[0].asnumpy().copy())

    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, data_names=data_names, label_names=label_names,
                         context=ctx, logger=logging,
                         fixed_param_names=list(fixed))
    metric = metric(pkg)
    mod.fit(chip_smoke.ListIter(pkg, batches, data_names, label_names),
            num_epoch=1,
            arg_params={k: pkg.nd.array(v, **({"ctx": ctx} if pkg is tmx
                                              else {}))
                        for k, v in params.items()},
            optimizer="sgd", optimizer_params=opt, eval_metric=metric,
            batch_end_callback=record)
    p, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in p.items()}, metric.get()[1]


def seeded_params(sym, shapes, seed=3, scale=0.3):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def check_fit_parity(got, want, start, fixed=()):
    """Outputs rtol 1e-5; params rtol 1e-4 / atol 1e-6 and the whole
    update within 1e-3 of its norm (two steps from the same weights;
    a max or ReLU within rounding of a tie would move one gradient);
    fixed params unchanged, every other param moved."""
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert got[1].keys() == want[1].keys() == start.keys()
    diff = np.concatenate([(got[1][k] - want[1][k]).ravel() for k in start])
    upd = np.concatenate([(want[1][k] - start[k]).ravel() for k in start])
    assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(upd)
    for k in start:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        assert np.array_equal(got[1][k], start[k]) == (k in fixed), k
    assert got[2] == want[2]


RCNN_OPT = (("learning_rate", 0.01), ("momentum", 0.9), ("wd", 5e-4),
            ("rescale_grad", 1.0 / RCNN_ROIS))
RCNN_DATA = ["data", "rois"]
RCNN_LABELS = ["label", "bbox_target", "bbox_weight"]


def test_narrow_fast_rcnn_fit_matches_jax():
    batches = rcnn_batches(2)
    tsym, jsym = rcnn_symbol(tmx), rcnn_symbol(jmx)
    shapes = {n: batches[0][n].shape for n in RCNN_DATA + RCNN_LABELS}
    params = seeded_params(tsym, shapes)
    fixed = ("conv1_weight", "conv1_bias")
    want = fit_steps(jmx, jsym, params, batches, RCNN_DATA, RCNN_LABELS,
                     RCNN_OPT, fixed)
    got = fit_steps(tmx, tsym, params, batches, RCNN_DATA, RCNN_LABELS,
                    RCNN_OPT, fixed)
    check_fit_parity(got, want, params, fixed)
