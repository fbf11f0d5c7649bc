"""The serving slice end to end on the CPU: a small NHWC ResNet
initialised in the JAX package, carried over by
``interop.params_from_numpy``, served through the port's Module,
InferenceServer and Predictor, and held against the JAX package's
Module.predict on the same rows. Probabilities within atol 1e-5 (float32
forwards of ~20 layers whose conv sums run in another order)."""
import io

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_common import small_resnet

BATCH = 4
SHAPE = (BATCH, 32, 32, 3)


@pytest.fixture(scope="module")
def reference():
    """JAX-initialised params (Xavier, then BatchNorm gamma/beta/moving
    stats drawn from a seed so the layers do real work), test rows, and
    the JAX Module.predict probabilities on them. The JAX package's
    global PRNG is seeded first: its draws otherwise depend on what ran
    before in the process."""
    jmx.random.seed(0)
    jsym = small_resnet(jmx)
    mod = jmx.mod.Module(jsym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", SHAPE)], for_training=False)
    mod.init_params(jmx.init.Xavier(magnitude=2.0))
    args, aux = mod.get_params()
    args = {k: v.asnumpy() for k, v in args.items()}
    aux = {k: v.asnumpy() for k, v in aux.items()}
    rng = np.random.RandomState(7)
    for k in args:
        if k.endswith("gamma"):
            args[k] = rng.uniform(0.5, 1.5, args[k].shape).astype(np.float32)
        elif k.endswith("beta"):
            args[k] = (rng.randn(*args[k].shape) * 0.1).astype(np.float32)
    for k in aux:
        aux[k] = (rng.uniform(0.5, 2.0, aux[k].shape) if k.endswith("var")
                  else rng.randn(*aux[k].shape) * 0.1).astype(np.float32)
    mod.set_params({k: jmx.nd.array(v) for k, v in args.items()},
                   {k: jmx.nd.array(v) for k, v in aux.items()})
    x = np.random.RandomState(11).randn(2 * BATCH, 32, 32, 3).astype(
        np.float32)
    probs = mod.predict(jmx.io.NDArrayIter(x, batch_size=BATCH)).asnumpy()
    return {"sym": jsym, "args": args, "aux": aux, "x": x, "probs": probs}


def _port_module(reference):
    tsym = small_resnet(tmx)
    args, aux = tmx.interop.params_from_numpy(
        tsym, reference["args"], reference["aux"], tmx.cpu(),
        input_shapes={"data": SHAPE})
    mod = tmx.mod.Module(tsym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", SHAPE)], for_training=False)
    mod.set_params(args, aux)
    return mod


def _decisive(probs, margin=1e-3):
    top2 = np.sort(probs, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > margin


def test_module_predict_matches_jax(reference):
    mod = _port_module(reference)
    probs = mod.predict(tmx.io.NDArrayIter(reference["x"], batch_size=BATCH))
    np.testing.assert_allclose(probs.asnumpy(), reference["probs"],
                               atol=1e-5, rtol=0)
    # a host array is batched at the bound batch size, padding sliced off
    part = mod.predict(reference["x"][:6]).asnumpy()
    np.testing.assert_allclose(part, reference["probs"][:6], atol=1e-5,
                               rtol=0)


def test_inference_server_argmax_matches_jax(reference):
    mod = _port_module(reference)
    x = reference["x"]
    want = reference["probs"].argmax(axis=1)
    ok = _decisive(reference["probs"])
    assert ok.sum() >= 6
    with tmx.serving.InferenceServer(mod, top_k=1, max_batch=BATCH) as srv:
        spans = [(0, 1), (1, 4), (4, 6), (6, 8)]
        reqs = [srv.submit([x[a:b]]) for a, b in spans]
        got = np.concatenate([r.get(60)[0] for r in reqs])
        stats = srv.stats()
    assert np.array_equal(got[ok], want[ok])
    assert stats["requests_served"] == 8 and stats["errors"] == 0
    assert stats["compiles"] <= len(stats["buckets"])
    assert stats["dispatches"] == stats["batches"]


def test_inference_server_probabilities_match_jax(reference):
    mod = _port_module(reference)
    with tmx.serving.InferenceServer(mod, top_k=0, max_batch=BATCH) as srv:
        (probs,) = srv.infer([reference["x"][:3]])
    np.testing.assert_allclose(probs, reference["probs"][:3], atol=1e-5,
                               rtol=0)


def test_predictor_loads_jax_json_and_params(reference):
    save = {"arg:%s" % k: jmx.nd.array(v)
            for k, v in reference["args"].items()}
    save.update({"aux:%s" % k: jmx.nd.array(v)
                 for k, v in reference["aux"].items()})
    buf = io.BytesIO()
    jmx.ndarray.save_to_stream(buf, save)
    pred = tmx.Predictor(reference["sym"].tojson(), buf.getvalue(),
                         {"data": SHAPE}, ctx=tmx.cpu())
    pred.forward(data=reference["x"][:BATCH])
    np.testing.assert_allclose(pred.get_output(0),
                               reference["probs"][:BATCH], atol=1e-5,
                               rtol=0)
    with pytest.raises(tmx.MXNetError, match="bound for"):
        pred.set_input("data", reference["x"][:2])


def test_executor_reshape_shares_params(reference):
    """Executor.reshape rebinds to a new batch, sharing every array whose
    shape is unchanged; copy_params_from fills a fresh executor."""
    mod = _port_module(reference)
    ex = mod._exec_group.executor
    small = ex.reshape(fresh_args=["data"], data=(2, 32, 32, 3))
    assert small.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    assert small.arg_dict["data"].shape == (2, 32, 32, 3)
    probs = small.forward(data=reference["x"][:2])[0].asnumpy()
    np.testing.assert_allclose(probs, reference["probs"][:2], atol=1e-5,
                               rtol=0)
    fresh = tmx.sym.load_json(reference["sym"].tojson()).simple_bind(
        tmx.cpu(), data=(2, 32, 32, 3))
    args, aux = mod.get_params()
    fresh.copy_params_from(args, aux)
    np.testing.assert_allclose(fresh.forward(data=reference["x"][:2])[0]
                               .asnumpy(), reference["probs"][:2],
                               atol=1e-5, rtol=0)


def test_params_from_numpy_checks_names_and_shapes(reference):
    tsym = small_resnet(tmx)
    args, aux = dict(reference["args"]), dict(reference["aux"])
    shapes = {"data": SHAPE}
    bad = dict(args, fc1_weight=args["fc1_weight"][:, :5])
    with pytest.raises(tmx.MXNetError, match="fc1_weight.*shape"):
        tmx.interop.params_from_numpy(tsym, bad, aux, tmx.cpu(), shapes)
    with pytest.raises(tmx.MXNetError, match="not in the symbol"):
        tmx.interop.params_from_numpy(tsym, dict(args, nope=args["fc1_bias"]),
                                      aux, tmx.cpu(), shapes)
    missing = {k: v for k, v in aux.items() if k != "stem_bn_moving_var"}
    with pytest.raises(tmx.MXNetError, match="stem_bn_moving_var"):
        tmx.interop.params_from_numpy(tsym, args, missing, tmx.cpu(), shapes)
