"""The port's pipeline and expert parallelism (mxnet_tpu_torch.parallel's
pipeline and moe) over four gloo ranks on the CPU, against the JAX
package's functions under ``shard_map`` on the forced CPU devices, at
tests/test_pipeline.py's and tests/test_moe.py's widths (HID 8; D 8,
DH 16) and tolerances (rtol/atol 1e-5; gradients rtol 1e-4, atol 1e-5).

Every multi-rank parity case runs in one spawn of four ranks
(tests/torch_pp_moe_ranks.py, which imports no jax); the parent compares
what each rank saved. A second spawn rehearses the four-card tool. The port's stage is K1 (``fused_linear``, tanh)
with the weight in K1's (N, K) layout: the JAX stage's ``w`` transposed.

The gradient contract under test (both packages): a rank's gradient is
that of the sum over the axis of every rank's loss. So every pp rank's
backward of the same loss gives its stage ``num_stages`` times the
sequential oracle's gradient, and the train step divides it back; a MoE
rank's router gradient covers its own tokens and sums over the axis to
the global loss's.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import moe as jmoe
from mxnet_tpu.parallel import pipeline as jpipe
from mxnet_tpu.parallel._compat import shard_map
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import moe as tmoe

import torch_pp_moe_ranks as ranks

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))
import torch_pp_moe_check  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 180
HID = 8                 # tests/test_pipeline.py
D, DH = 8, 16           # tests/test_moe.py
RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4


def jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def stage_params(rng, n_stages):
    """tests/test_pipeline.py's stages, stacked: (w (S, K, N), b)."""
    per = [{"w": rng.randn(HID, HID).astype(np.float32) * 0.5,
            "b": rng.randn(HID).astype(np.float32) * 0.1}
           for _ in range(n_stages)]
    return per, jpipe.stack_stage_params(per)


def k1_layout(w):
    """(S, K, N) -> (S, N, K), contiguous."""
    return np.ascontiguousarray(np.swapaxes(w, 1, 2))


# tag -> (mesh, microbatches, rows, seed, options); seeds and sizes of
# tests/test_pipeline.py's cases
PP = {"pp4_mb4": ({"pp": 4}, 4, 2, 0, {}),
      "pp4_mb8": ({"pp": 4}, 8, 2, 0, {}),
      "pp2dp2_mb3": ({"pp": 2, "dp": 2}, 3, 2, 0, {}),
      "pp4_grad": ({"pp": 4}, 4, 2, 1, {"grad": True}),
      "pp4_step": ({"pp": 4}, 4, 2, 3, {"step": True, "lr": 0.5}),
      "pp2dp2_step": ({"pp": 2, "dp": 2}, 4, 4, 2,
                      {"step": True, "lr": 0.05, "dtensor": True})}
# tag -> (mesh, experts, tokens, seed, options); tests/test_moe.py's
MOE = {"moe_top1": ({"ep": 4}, 8, 64, 0,
                    {"top_k": 1, "capacity_factor": 8.0}),
       "moe_top2": ({"ep": 4}, 8, 64, 0,
                    {"top_k": 2, "capacity_factor": 8.0}),
       "moe_drop": ({"dp": 2, "ep": 2}, 2, 32, 1,
                    {"top_k": 1, "capacity_factor": 0.25}),
       "moe_grad": ({"ep": 4}, 4, 32, 2,
                    {"top_k": 2, "capacity_factor": 4.0, "grad": True,
                     "aux_weight": 0.01, "train": 8, "lr": 0.1})}


def pp_inputs(tag):
    mesh, n_mb, rows, seed, _ = PP[tag]
    rng = np.random.RandomState(seed)
    per, stacked = stage_params(rng, mesh["pp"])
    mb = rng.randn(n_mb, rows, HID).astype(np.float32)
    lab = rng.randn(n_mb, rows, HID).astype(np.float32)
    return per, stacked, mb, lab


def moe_inputs(tag):
    _, experts, tokens, seed, _ = MOE[tag]
    rng = np.random.RandomState(seed)
    params = jmoe.init_moe_params(rng, experts, D, DH)
    if tag == "moe_drop":
        # tests/test_moe.py: a biased router sends every token to
        # expert 0, past its capacity
        params["router"][:, 0] = 5.0
        params["router"][:, 1] = -5.0
        x = (rng.rand(tokens, D) + 0.1).astype(np.float32)
    else:
        x = rng.randn(tokens, D).astype(np.float32)
    target = rng.randn(tokens, D).astype(np.float32)
    return params, x, target


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every multi-rank case, from one spawn of WORLD gloo ranks: a list
    of each rank's results."""
    d = tmp_path_factory.mktemp("pp_moe")
    cases, arrays = [], {}
    for tag, (mesh, _, _, _, opts) in PP.items():
        _, stacked, mb, lab = pp_inputs(tag)
        arrays.update({tag + ".w": k1_layout(stacked["w"]),
                       tag + ".b": stacked["b"], tag + ".mb": mb,
                       tag + ".lab": lab})
        cases.append(dict(opts, kind="pp", tag=tag, mesh=mesh))
    for tag, (mesh, _, _, _, opts) in MOE.items():
        params, x, target = moe_inputs(tag)
        arrays.update({"%s.%s" % (tag, k): v for k, v in params.items()})
        arrays.update({tag + ".x": x, tag + ".target": target})
        cases.append(dict(opts, kind="moe", tag=tag, mesh=mesh))
    ranks.save_plan(str(d), cases, arrays)
    codes, res = ranks.spawn(WORLD, "gloo", str(d), SPAWN_TIMEOUT_S)
    assert codes == [0] * WORLD
    return res


def _coords(mesh, rank):
    """Rank ``rank``'s index along each axis of a row-major mesh."""
    at = np.unravel_index(rank, tuple(mesh.values()))
    return dict(zip(mesh, (int(i) for i in at)))


def _jax_pipeline_out(tag):
    mesh, _, _, _, _ = PP[tag]
    _, stacked, mb, _ = pp_inputs(tag)
    jm = jmake_mesh(mesh)
    xspec = P(None, "dp") if "dp" in mesh else P(None)
    fwd = shard_map(lambda p, x: jpipe.pipeline_forward(jstage, p, x, "pp"),
                    mesh=jm, in_specs=({"w": P("pp"), "b": P("pp")}, xspec),
                    out_specs=xspec)
    return np.asarray(jax.jit(fwd)(stacked, mb))


@pytest.mark.parametrize("tag", ["pp4_mb4", "pp4_mb8", "pp2dp2_mb3"])
def test_pipeline_forward_matches_jax(port, tag):
    mesh = PP[tag][0]
    per, _, mb, _ = pp_inputs(tag)
    want = _jax_pipeline_out(tag)
    seq = np.stack([np.asarray(jpipe.sequential_reference(jstage, per, m))
                    for m in mb])
    np.testing.assert_allclose(want, seq, rtol=RTOL, atol=ATOL)
    dp_n = mesh.get("dp", 1)
    rows = mb.shape[1] // dp_n
    for r, res in enumerate(port):
        dp = _coords(mesh, r).get("dp", 0)
        cut = slice(dp * rows, (dp + 1) * rows)
        np.testing.assert_allclose(res[tag + ".out"], want[:, cut],
                                   rtol=RTOL, atol=ATOL)
        # every rank applies its stage on every tick; CPU tensors take
        # K1's plain version, so no launch is counted
        assert res[tag + ".launches"] == 0


@pytest.mark.parametrize("name", ["w", "b"])
def test_pipeline_gradients_are_num_stages_times_the_oracle(port, name):
    """tests/test_pipeline.py:55-88's loss, sum(out^2): each rank's
    backward gives its stage 4x the JAX package's gradient of the loss
    (the sequential oracle's), by the sum convention."""
    per, stacked, mb, _ = pp_inputs("pp4_grad")
    n = len(per)

    def seq_loss(stacked):
        outs = []
        for i in range(mb.shape[0]):
            x = mb[i]
            for s in range(n):
                x = jstage(jax.tree_util.tree_map(lambda l: l[s], stacked),
                           x)
            outs.append(x)
        return jnp.sum(jnp.stack(outs) ** 2)

    want = np.asarray(jax.jit(jax.grad(seq_loss))(stacked)[name])
    for r, res in enumerate(port):
        got = res["pp4_grad.g" + name][0]
        if name == "w":
            got = got.T
        np.testing.assert_allclose(got, n * want[r], rtol=GRAD_RTOL,
                                   atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_step(tag):
    mesh, n_mb, _, _, opts = PP[tag]
    _, stacked, mb, lab = pp_inputs(tag)

    def loss_fn(out, lab):
        return jnp.mean((out - lab) ** 2)

    step = jpipe.build_pipeline_train_step(
        jstage, loss_fn, jmake_mesh(mesh), num_microbatches=n_mb,
        pp_axis="pp", dp_axis="dp" if "dp" in mesh else None,
        lr=opts["lr"])
    loss, new = jax.jit(step)(stacked, mb, lab)

    def seq_loss(stacked):
        per_mb = []
        for i in range(n_mb):
            x = mb[i]
            for s in range(mesh["pp"]):
                x = jstage(jax.tree_util.tree_map(lambda l: l[s], stacked),
                           x)
            per_mb.append(loss_fn(x, lab[i]))
        return jnp.mean(jnp.stack(per_mb))

    seq_loss, g = jax.jit(jax.value_and_grad(seq_loss))(stacked)
    oracle = {k: np.asarray(stacked[k]) - opts["lr"] * np.asarray(g[k])
              for k in ("w", "b")}
    return (float(loss), {k: np.asarray(v) for k, v in new.items()},
            oracle, float(seq_loss))


@pytest.mark.parametrize("against", ["oracle", "jax_step"])
@pytest.mark.parametrize("tag", ["pp4_step", "pp2dp2_step"])
def test_pipeline_train_step_matches(port, tag, against):
    """One step of build_pipeline_train_step against the sequential
    oracle's SGD step by autograd, and against the JAX package's step
    (tests/test_pipeline.py:91-130; the pp 2 x dp 2 step on DTensors,
    which it returns)."""
    mesh = PP[tag][0]
    loss, jax_new, oracle, seq_loss = _jax_step(tag)
    want = oracle if against == "oracle" else jax_new
    for r, res in enumerate(port):
        pp = _coords(mesh, r)["pp"]
        np.testing.assert_allclose(res[tag + ".w_new"][0].T, want["w"][pp],
                                   rtol=GRAD_RTOL, atol=ATOL)
        np.testing.assert_allclose(res[tag + ".b_new"][0], want["b"][pp],
                                   rtol=GRAD_RTOL, atol=ATOL)
        np.testing.assert_allclose(res[tag + ".loss"],
                                   seq_loss if against == "oracle" else loss,
                                   rtol=RTOL)
        assert str(res[tag + ".kinds"]) == (
            "DTensor" if PP[tag][4].get("dtensor") else "Tensor")


def _jax_moe(mesh, params, x, top_k, capacity_factor):
    jm = jmake_mesh(mesh)
    pspec = {"router": P(), "w1": P("ep"), "b1": P("ep"), "w2": P("ep"),
             "b2": P("ep")}
    fn = shard_map(
        lambda p, t: jmoe.moe_ffn_local(p, t, "ep", top_k, capacity_factor),
        mesh=jm, in_specs=(pspec, P("ep")), out_specs=(P("ep"), P()))
    y, aux = jax.jit(fn)(params, x)
    return np.asarray(y), float(aux)


def _port_y(port, tag):
    """The ep ranks' y shards in ep order (the first dp line's)."""
    mesh = MOE[tag][0]
    by_ep = {}
    for r, res in enumerate(port):
        c = _coords(mesh, r)
        if c.get("dp", 0) == 0:
            by_ep[c["ep"]] = res[tag + ".y"]
    return np.concatenate([by_ep[i] for i in sorted(by_ep)])


@pytest.mark.parametrize("against", ["reference", "jax_shard_map"])
@pytest.mark.parametrize("tag", ["moe_top1", "moe_top2"])
def test_moe_matches(port, tag, against):
    """tests/test_moe.py:29-44: generous capacity, no drops: ep 4 equals
    the dense oracle and the JAX layer under shard_map; aux equals the
    JAX layer's on every rank."""
    mesh, _, _, _, opts = MOE[tag]
    params, x, _ = moe_inputs(tag)
    jy, jaux = _jax_moe(mesh, params, x, opts["top_k"],
                        opts["capacity_factor"])
    if against == "reference":
        want = np.asarray(jax.jit(jmoe.moe_reference, static_argnums=2)(
            params, jnp.asarray(x), opts["top_k"]))
        np.testing.assert_allclose(jy, want, rtol=RTOL, atol=ATOL)
    else:
        want = jy
        for res in port:
            np.testing.assert_allclose(res[tag + ".aux"], jaux, rtol=RTOL)
        assert jaux > 0
    np.testing.assert_allclose(_port_y(port, tag), want, rtol=RTOL,
                               atol=ATOL)


def test_moe_capacity_drops_tokens(port):
    """tests/test_moe.py:47-65: the biased router overflows expert 0;
    the port drops the same tokens (zero rows) as the JAX layer, and
    its kept rows equal the JAX layer's."""
    mesh, experts, tokens, _, opts = MOE["moe_drop"]
    params, x, _ = moe_inputs("moe_drop")
    jy, _ = _jax_moe({"ep": mesh["ep"]}, params, x, opts["top_k"],
                     opts["capacity_factor"])
    got = _port_y(port, "moe_drop")
    ep = mesh["ep"]
    cap = tmoe.expert_capacity(tokens // ep, experts, 1, 0.25)
    zero = np.abs(got).sum(axis=1) < 1e-12
    assert int(zero.sum()) == tokens - ep * cap
    np.testing.assert_array_equal(zero, np.abs(jy).sum(axis=1) < 1e-12)
    np.testing.assert_allclose(got, jy, rtol=RTOL, atol=ATOL)
    # the second ep line (dp 1) ran the same tokens
    for r, res in enumerate(port):
        c = _coords(mesh, r)
        np.testing.assert_array_equal(
            res["moe_drop.y"],
            got[c["ep"] * (tokens // ep):(c["ep"] + 1) * (tokens // ep)])


def _jax_moe_loss(params, x, target):
    """tests/test_moe.py:68-93's global loss."""
    mesh, _, _, _, opts = MOE["moe_grad"]
    jm = jmake_mesh(mesh)
    pspec = {"router": P(), "w1": P("ep"), "b1": P("ep"), "w2": P("ep"),
             "b2": P("ep")}
    fn = shard_map(
        lambda p, t: jmoe.moe_ffn_local(p, t, "ep", opts["top_k"],
                                        opts["capacity_factor"]),
        mesh=jm, in_specs=(pspec, P("ep")), out_specs=(P("ep"), P()))
    y, aux = fn(params, x)
    return jnp.mean((y - target) ** 2) + opts["aux_weight"] * aux


@functools.lru_cache(maxsize=None)
def _jax_moe_training():
    """The JAX test's eight SGD steps of lr 0.1: (the losses, the first
    step's gradients)."""
    params, x, target = moe_inputs("moe_grad")
    step = jax.jit(jax.value_and_grad(_jax_moe_loss))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    losses, first = [], None
    for _ in range(MOE["moe_grad"][4]["train"]):
        loss, grads = step(p, x, target)
        first = first or {k: np.asarray(v) for k, v in grads.items()}
        p = jax.tree_util.tree_map(lambda a, b: a - 0.1 * b, p, grads)
        losses.append(float(loss))
    return losses, first


@pytest.mark.parametrize("name", ["router", "w1", "b1", "w2", "b2"])
def test_moe_gradients_match_the_global_loss(port, name):
    """Each rank's share of the global loss (its token loss / ep +
    0.01 aux / ep): the router gradient summed over the axis, and each
    rank's experts' gradients, equal jax.grad of the global loss. Before
    the sum a rank's router gradient misses the other ranks' tokens."""
    want = _jax_moe_training()[1][name]
    ep = MOE["moe_grad"][0]["ep"]
    local_e = want.shape[0] // ep if name != "router" else None
    for r, res in enumerate(port):
        got = res["moe_grad.g_" + name]
        mine = want if name == "router" else \
            want[r * local_e:(r + 1) * local_e]
        np.testing.assert_allclose(got, mine, rtol=GRAD_RTOL, atol=ATOL)
    if name == "router":
        local = port[0]["moe_grad.g_router_local"]
        assert not np.allclose(local, want, rtol=GRAD_RTOL, atol=ATOL)
        np.testing.assert_allclose(
            sum(res["moe_grad.g_router_local"] for res in port), want,
            rtol=GRAD_RTOL, atol=ATOL)


def test_moe_training_follows_jax(port):
    """tests/test_moe.py:68-93: eight SGD steps of lr 0.1; the port's
    losses equal the JAX package's step by step, and fall."""
    want = _jax_moe_training()[0]
    for res in port:
        got = res["moe_grad.losses"]
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL)
        assert got[-1] < got[0]


@pytest.mark.parametrize("top_k,bias", [(1, False), (2, False), (1, True)])
def test_route_keeps_the_reference_slots(top_k, bias):
    """The port's kept (token, expert, slot, weight) entries, scattered
    into [S, E, C], equal the JAX package's combine tensor, and its
    auxiliary loss the JAX one, drops included."""
    rng = np.random.RandomState(5)
    experts, tokens = 4, 48
    router = rng.randn(D, experts).astype(np.float32)
    if bias:
        router[:, 0] = 5.0
    x = (rng.rand(tokens, D) + 0.1).astype(np.float32)
    cap = tmoe.expert_capacity(tokens, experts, top_k, 1.0)
    jcombine, jdispatch, jaux = jax.jit(jmoe._route, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(router), experts, top_k, cap)
    tok, exp, slot, w, aux = tmoe._route(torch.from_numpy(x),
                                         torch.from_numpy(router), experts,
                                         top_k, cap)
    combine = np.zeros((tokens, experts, cap), np.float32)
    combine[tok.numpy(), exp.numpy(), slot.numpy()] = w.numpy()
    np.testing.assert_array_equal(combine > 0, np.asarray(jdispatch) > 0)
    np.testing.assert_allclose(combine, np.asarray(jcombine), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    if bias:
        assert (np.asarray(jdispatch).sum() < tokens)


def test_numpy_helpers_equal_the_jax_package():
    for args in [(64, 8, 1, 1.25), (4096, 8, 1, 1.25), (4096, 8, 2, 8.0),
                 (16, 2, 1, 0.25), (3, 8, 2, 0.1)]:
        assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)
    got = tmoe.init_moe_params(np.random.RandomState(7), 8, D, DH)
    want = jmoe.init_moe_params(np.random.RandomState(7), 8, D, DH)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    per, _ = stage_params(np.random.RandomState(0), 3)
    trees = [{"w": p["w"], "sub": [p["b"], (p["b"] * 2,)]} for p in per]
    got = parallel.stack_stage_params(trees)
    want = jpipe.stack_stage_params(trees)
    assert got["w"].tobytes() == np.asarray(want["w"]).tobytes()
    assert got["sub"][0].tobytes() == np.asarray(want["sub"][0]).tobytes()
    assert isinstance(got["sub"][1], tuple)
    assert got["sub"][1][0].tobytes() == \
        np.asarray(want["sub"][1][0]).tobytes()
    with pytest.raises(tmx.MXNetError, match="at least one stage"):
        parallel.stack_stage_params([])


@pytest.fixture
def one_rank_group():
    assert not dist.is_initialized()
    yield
    # a group left behind fails tests/test_torch_parallel.py in the same
    # worker
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_axes_send_nothing(one_rank_group):
    """On one-rank axes the pipeline is the sequential oracle and the
    MoE layer, at capacity factor 8, the dense one; nothing is sent."""
    pmesh = parallel.make_mesh({"pp": 1}, device_type="cpu")
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(1, HID, HID).astype(np.float32) * 0.5)
    b = torch.from_numpy(rng.randn(1, HID).astype(np.float32) * 0.1)
    mb = torch.from_numpy(rng.randn(5, 2, HID).astype(np.float32))
    out = parallel.pipeline_forward(ranks.stage_fn, {"w": w, "b": b}, mb,
                                    mesh=pmesh)
    want = torch.stack([parallel.sequential_reference(
        ranks.stage_fn, [{"w": w[0], "b": b[0]}], m) for m in mb])
    assert torch.equal(out, want)
    emesh = parallel.make_mesh({"ep": 1}, device_type="cpu")
    params = {k: torch.from_numpy(v) for k, v in
              tmoe.init_moe_params(rng, 4, D, DH).items()}
    x = torch.from_numpy(rng.randn(16, D).astype(np.float32))
    y, aux = parallel.moe_ffn_local(params, x, "ep", 2, 8.0, mesh=emesh)
    np.testing.assert_allclose(y.numpy(),
                               parallel.moe_reference(params, x, 2).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert float(aux) > 0


def test_refusals(one_rank_group):
    mesh = parallel.make_mesh({"pp": 1}, device_type="cpu")
    w = torch.zeros(1, HID, HID)
    b = torch.zeros(1, HID)
    mb = torch.zeros(2, 2, HID)
    with pytest.raises(tmx.MXNetError, match="'ep' is not an axis"):
        parallel.pipeline_forward(ranks.stage_fn, {"w": w, "b": b}, mb,
                                  "ep", mesh=mesh)
    params = {k: torch.from_numpy(v) for k, v in tmoe.init_moe_params(
        np.random.RandomState(0), 2, D, DH).items()}
    with pytest.raises(tmx.MXNetError, match="'ep' is not an axis"):
        parallel.moe_ffn_local(params, torch.zeros(4, D), "ep", mesh=mesh)
    with pytest.raises(tmx.MXNetError, match="'dp' is not an axis"):
        parallel.build_pipeline_train_step(ranks.stage_fn, ranks.mse, mesh,
                                           2, dp_axis="dp")
    # a tensor on another device type than the mesh's, naming both
    with pytest.raises(tmx.MXNetError, match="meta.*mesh's devices are cpu"):
        parallel.pipeline_forward(ranks.stage_fn, {"w": w, "b": b},
                                  mb.to("meta"), mesh=mesh)
    emesh = parallel.make_mesh({"ep": 1}, device_type="cpu")
    with pytest.raises(tmx.MXNetError, match="meta.*mesh's devices are cpu"):
        parallel.moe_ffn_local(params, torch.zeros(4, D, device="meta"),
                               "ep", mesh=emesh)
    step = parallel.build_pipeline_train_step(ranks.stage_fn, ranks.mse,
                                              mesh, 2)
    with pytest.raises(tmx.MXNetError, match="meta.*mesh's devices are cpu"):
        step({"w": w.to("meta"), "b": b}, mb, mb)
    with pytest.raises(tmx.MXNetError, match="leading dim 1"):
        parallel.pipeline_forward(ranks.stage_fn, {"w": w[0], "b": b}, mb,
                                  mesh=mesh)


def test_the_four_card_check_rehearses_over_gloo(one_rank_group):
    """tools/torch_pp_moe_check.py's run over four gloo ranks at a tiny
    width (the second spawn): every check passes, and the planted
    control (rank 0's router gradient left unsummed) is caught. Its
    one-card references run on a one-rank mesh in this process, whose
    process group it destroys before returning."""
    rec = torch_pp_moe_check.run(torch, WORLD, cpu=True, hid=32, tokens=64,
                                 d_model=16, d_ff=32)
    assert not dist.is_initialized()
    assert rec["failed"] == []
    assert rec["pp"]["outputs_bit_equal_to_oracle_on_own_rows"]
    assert rec["pp"]["k1_launches_a_forward_by_rank"] == [0] * WORLD
    assert rec["pp_dp"]["kinds"] == ["DTensor"]
    assert rec["ep_train"]["control_router_unsummed_normwise"] > \
        rec["ep_train"]["bound"]
    assert rec["ep_train"]["losses"][-1] < rec["ep_train"]["losses"][0]
