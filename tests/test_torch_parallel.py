"""The port's ring and Ulysses attention (mxnet_tpu_torch.parallel) at
world size 2 over gloo on the CPU, against the JAX package's
make_ring_attention on the forced 2-device CPU mesh, with
tests/test_ring_attention.py's inputs and tolerances. All port cases
run in one spawn of two ranks (tests/torch_sp_ranks.py, which imports no
jax); the parent compares their shards, concatenated along T."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.ring_attention import (
    make_ring_attention as jmake_ring_attention)
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel

import torch_sp_ranks

WORLD = 2
SPAWN_TIMEOUT_S = 120


def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda: rng.randn(b, t, h, d).astype(np.float32) * 0.5
    return mk(), mk(), mk()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every port case, from one spawn of WORLD gloo ranks."""
    d = tmp_path_factory.mktemp("sp")
    q, k, v = _qkv()
    gq, gk, gv = _qkv(t=16)
    np.savez(d / "in.npz", q=q, k=k, v=v, gq=gq, gk=gk, gv=gv)
    codes, results = torch_sp_ranks.spawn(WORLD, "gloo", str(d / "in.npz"),
                                          str(d), SPAWN_TIMEOUT_S)
    assert codes == [0] * WORLD
    return results


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(port_results, impl, causal):
    q, k, v = _qkv()
    attn = jmake_ring_attention(jmake_mesh({"sp": WORLD}), "sp",
                                causal=causal, impl=impl)
    want = np.asarray(attn(q, k, v))
    np.testing.assert_allclose(port_results["out_%s_%d" % (impl, causal)],
                               want, rtol=2e-4, atol=2e-5)
    # CPU tensors take the flash kernel's plain version: no launch
    assert port_results["launches_%s_%d" % (impl, causal)] == [0] * WORLD


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_gradients_match_jax(port_results, impl):
    """test_ring_attention.py:33-53: causal, T=16, rtol 1e-3 / atol
    1e-4; the port's ring sends the cotangents back around the ring."""
    q, k, v = _qkv(t=16)
    attn = jmake_ring_attention(jmake_mesh({"sp": WORLD}), "sp", causal=True,
                                impl=impl)
    grads = jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    for name, want in zip("qkv", grads):
        np.testing.assert_allclose(port_results["grad_%s_%s" % (impl, name)],
                                   np.asarray(want), rtol=1e-3, atol=1e-4)


def test_one_rank_mesh_needs_no_launcher():
    """A one-rank mesh initialises its own group from an in-process
    store; the shard is then the whole sequence, and both impls equal
    the reference."""
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh({"sp": 1}, device_type="cpu")
        assert parallel.mesh_axis_sizes(mesh) == {"sp": 1}
        q, k, v = (torch.from_numpy(a) for a in _qkv())
        want = parallel.reference_attention(q, k, v, causal=True)
        for impl in ("ring", "ulysses"):
            out = parallel.make_ring_attention(mesh, "sp", causal=True,
                                               impl=impl)(q, k, v)
            np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                                       atol=2e-5)
        with pytest.raises(tmx.MXNetError, match="impl must be one of"):
            parallel.make_ring_attention(mesh, "sp", impl="tree")
    finally:
        dist.destroy_process_group()


def test_make_mesh_refusals():
    with pytest.raises(tmx.DeviceUnavailableError, match="device_type='cpu'"):
        parallel.make_mesh({"sp": 1})
    with pytest.raises(tmx.MXNetError, match="needs torch.distributed"):
        parallel.make_mesh({"sp": 2}, device_type="cpu")
    with pytest.raises(tmx.MXNetError, match="device_type must be one of"):
        parallel.make_mesh({"sp": 1}, device_type="tpu")
