"""Graphs and weights crossing between the JAX package and the PyTorch
port as files: symbol JSON (JAX -> port -> JAX with equal infer_shape,
and the same text), auto-naming, and the "TPUARRA" container, bit-equal
in both directions."""
import io

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_common import fresh_names, small_resnet


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_json_round_trip(layout):
    jsym = small_resnet(jmx, layout)
    jjson = jsym.tojson()
    tsym = tmx.sym.load_json(jjson)
    assert tsym.tojson() == jjson
    back = jmx.sym.load_json(tsym.tojson())
    shape = (4, 3, 32, 32) if layout == "NCHW" else (4, 32, 32, 3)
    ref = jsym.infer_shape(data=shape)
    assert tsym.infer_shape(data=shape) == ref
    assert back.infer_shape(data=shape) == ref
    for f in ("list_arguments", "list_outputs", "list_auxiliary_states"):
        assert getattr(tsym, f)() == getattr(jsym, f)()


def test_native_build_gives_same_graph_and_names():
    """Built natively in each package (each with a fresh NameManager),
    the graphs serialize to the same JSON: auto-named nodes such as
    flatten0 and the op hints agree."""
    assert small_resnet(tmx).tojson() == small_resnet(jmx).tojson()
    for pkg in (jmx, tmx):
        with fresh_names(pkg):
            a = pkg.sym.Variable("a")
            s = pkg.sym.FullyConnected(pkg.sym.Flatten(a), num_hidden=3)
            s = pkg.sym.Activation(s + 1.0, act_type="relu")
        assert s.list_arguments() == ["a", "fullyconnected0_weight",
                                      "fullyconnected0_bias"]
        assert s.list_outputs() == ["activation0_output"]


def test_port_written_json_loads_in_jax():
    with fresh_names(tmx):
        a = tmx.sym.Variable("data")
        c = tmx.sym.Convolution(a, kernel=(3, 3), num_filter=4, pad=(1, 1),
                                layout="NHWC", no_bias=True)
        s = tmx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2),
                            pool_type="avg", layout="NHWC")
    j = jmx.sym.load_json(s.tojson())
    assert j.tojson() == s.tojson()
    assert j.infer_shape(data=(2, 8, 8, 3)) == s.infer_shape(data=(2, 8, 8, 3))


def _arrays():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "h": rng.randn(5).astype(np.float16),
            "i": rng.randint(-9, 9, (2, 3)).astype(np.int32),
            "u": rng.randint(0, 255, (7,)).astype(np.uint8),
            "s": np.float32(2.5).reshape(())}


def _jax_bytes(arrays):
    buf = io.BytesIO()
    jmx.ndarray.save_to_stream(buf, {k: jmx.nd.array(v, dtype=v.dtype)
                                     for k, v in arrays.items()})
    return buf.getvalue()


def _torch_bytes(arrays):
    buf = io.BytesIO()
    ctx = tmx.cpu()
    tmx.ndarray.save_to_stream(buf, {k: tmx.nd.array(v, ctx=ctx,
                                                     dtype=v.dtype)
                                     for k, v in arrays.items()})
    return buf.getvalue()


def test_container_bytes_equal_both_ways(tmp_path):
    arrays = _arrays()
    jb, tb = _jax_bytes(arrays), _torch_bytes(arrays)
    assert tb == jb
    # JAX-written file -> port
    p = tmp_path / "jax.params"
    p.write_bytes(jb)
    loaded = tmx.nd.load(str(p), ctx=tmx.cpu())
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        assert loaded[k].dtype == v.dtype
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
    # port-written file -> JAX
    q = tmp_path / "torch.params"
    tmx.nd.save(str(q), loaded)
    back = jmx.nd.load(str(q))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    assert q.read_bytes() == jb


def test_container_bfloat16_bit_equal_both_ways():
    import ml_dtypes

    raw = np.random.RandomState(1).randn(6, 5).astype(np.float32)
    jarr = jmx.nd.array(raw.astype(ml_dtypes.bfloat16),
                        dtype=ml_dtypes.bfloat16)
    buf = io.BytesIO()
    jmx.ndarray.save_to_stream(buf, [jarr])
    got = tmx.ndarray.load_from_stream(io.BytesIO(buf.getvalue()),
                                       ctx=tmx.cpu())[0]
    assert got.handle.dtype == torch.bfloat16
    want_bits = jarr.asnumpy().view(np.uint16)
    assert np.array_equal(got.handle.view(torch.int16).numpy()
                          .view(np.uint16), want_bits)
    out = io.BytesIO()
    tmx.ndarray.save_to_stream(out, [got])
    assert out.getvalue() == buf.getvalue()


def test_container_list_form_and_errors(tmp_path):
    ctx = tmx.cpu()
    p = tmp_path / "list.params"
    tmx.nd.save(str(p), [tmx.nd.ones((2, 2), ctx=ctx)])
    got = jmx.nd.load(str(p))
    assert isinstance(got, list) and got[0].asnumpy().sum() == 4
    bad = tmp_path / "bad.params"
    bad.write_bytes(b"\x00" * 24)
    with pytest.raises(tmx.MXNetError, match="invalid NDArray file"):
        tmx.nd.load(str(bad), ctx=ctx)
    torn = tmp_path / "torn.params"
    torn.write_bytes(p.read_bytes()[:-5])
    with pytest.raises(tmx.MXNetError, match="truncated"):
        tmx.nd.load(str(torn), ctx=ctx)


def test_infer_shape_errors_name_the_unknowns():
    s = tmx.sym.FullyConnected(tmx.sym.Variable("x"), num_hidden=3,
                               name="fc")
    with pytest.raises(tmx.MXNetError, match="unknown args"):
        s.infer_shape()
    with pytest.raises(tmx.MXNetError, match="unknown argument 'y'"):
        s.infer_shape(y=(1, 2))
