#!/usr/bin/env python3
"""Pipeline and expert parallelism of the PyTorch port across cards: a
GPipe trunk of K1 stages and a Switch-Base-8 expert layer, one NCCL rank
a card, against one card.

    python3 tools/torch_pp_moe_check.py                   # every card
    python3 tools/torch_pp_moe_check.py --report pp_moe.json
    python3 tools/torch_pp_moe_check.py --cpu --world 4 --tokens 256 \\
        --d-model 64 --d-ff 128 --hid 256                 # rehearsal

Spawns ``--world`` ranks through tests/torch_pp_moe_ranks.py (the
harness of the gloo parity test), NCCL on one card each or gloo on the
CPU, float32 with TF32 off, all inputs from seed 0:

* pp = world: one stage a rank, ``tanh(x @ w.T + b)`` through K1
  (``fused_linear``) at ``--hid`` (4096: VGG-16's fc7) with w ~ N(0,
  1/hid) and b ~ N(0, 0.01), 8 microbatches of 32 rows.
  ``pipeline_forward``'s outputs must be bit-equal to
  ``sequential_reference`` on one card, and every rank must launch K1
  ``8 + world - 1`` times a forward (0 on the CPU). One
  ``build_pipeline_train_step`` step (mean squared error against seeded
  labels, lr 0.05) must leave the stages within 4 float32 floors of the
  oracle's SGD step by autograd (normwise, as a share of the oracle's
  update; the floor as tools/torch_dp_check.py defines it: the larger
  distance the oracle's step moves when its inputs are scaled by
  1 +- 2^-23).
* pp = world / 2 x dp = 2 (four or more ranks): the same step on
  DTensor stages, each dp rank on its 16 rows of each microbatch,
  against the oracle on the global batch; the outputs bit-equal to the
  oracle's on each rank's own rows (K1 at the rank's row count).
* ep = world: Switch-Base-8's expert layer (d_model 768, d_ff 3072, 8
  experts, ``--tokens`` 4096 a rank, with a common offset that skews
  the router's choices), each rank's ``y`` against one
  card's ``moe_ffn_local`` on a one-rank axis over that rank's tokens
  (the same capacity, so the same drops), top-1 at capacity factor 1.25
  and top-2 at 2.0, rtol/atol 1e-5; eight SGD steps (lr 0.1) of
  tests/test_moe.py's loss (top-2, capacity factor 4.0, ``mean((y -
  target)^2) + 0.01 aux``) whose loss must fall; the first step's
  gradients (each rank's experts, and the router summed over the axis)
  within 1e-5 normwise of autograd through the same global loss on one
  card (the layer over each rank's tokens on a one-rank axis).
* A planted control: rank 0's router gradient before the sum over the
  axis, which must lie outside that bound.

On cards it prints the host ms of a pp step against the sequential
oracle's step on one card, the schedule's bubble share (world - 1) /
(8 + world - 1) beside the share of a step outside the 8 useful stage
passes (1 - 8 x a stage's forward and backward / the step: bubble
ticks, exchanges, the update and host time), the ms of one exchange of
a tick's activations, and the MoE
layer's forward and forward+backward ms at ep = world against one card
over one rank's tokens, with one all-to-all of its buffers. Every time
is the mean of 10 calls after a warm one, the card synchronised, with
the card's name and power limit. One JSON object is the last line;
exits non-zero when a check fails or a rank dies. Imports neither jax
nor the JAX package.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_dp_check as dp  # noqa: E402
import torch_pp_moe_ranks as ranks  # noqa: E402

SEED = 0
MICROBATCHES, ROWS = 8, 32
PP_LR = 0.05
FLOOR_FACTOR = 4
SWITCH = {"experts": 8, "d_model": 768, "d_ff": 3072}
MOE_TOL = 1e-5                 # y: rtol and atol; gradients: normwise
MOE_CASES = {"ep_top1": (1, 1.25), "ep_top2": (2, 2.0)}
TRAIN = {"top_k": 2, "capacity_factor": 4.0, "aux_weight": 0.01,
         "train": 8, "lr": 0.1}
TIMEOUT_S = 900


def inputs(world, hid, tokens, d_model, d_ff, experts, timed=True):
    """The plan's cases and arrays, from seed 0; ``timed`` asks the ranks
    for their times."""
    from mxnet_tpu_torch.parallel import init_moe_params

    rng = np.random.RandomState(SEED)
    w = (rng.randn(world, hid, hid) / np.sqrt(hid)).astype(np.float32)
    b = (rng.randn(world, hid) * 0.1).astype(np.float32)
    mb = rng.randn(MICROBATCHES, ROWS, hid).astype(np.float32)
    lab = rng.randn(MICROBATCHES, ROWS, hid).astype(np.float32)
    cases = [{"kind": "pp", "tag": "pp", "mesh": {"pp": world},
              "step": True, "lr": PP_LR, "timed": timed}]
    arrays = {"pp.w": w, "pp.b": b, "pp.mb": mb, "pp.lab": lab}
    if world >= 4 and world % 2 == 0:
        half = world // 2
        cases.append({"kind": "pp", "tag": "pp_dp",
                      "mesh": {"pp": half, "dp": 2}, "step": True,
                      "lr": PP_LR, "dtensor": True})
        arrays.update({"pp_dp.w": w[:half], "pp_dp.b": b[:half],
                       "pp_dp.mb": mb, "pp_dp.lab": lab})
    params = init_moe_params(rng, experts, d_model, d_ff)
    # a common offset skews the random router's choices (as chip_smoke's
    # 22a), so that top-1 at capacity factor 1.25 drops tokens
    x = (rng.randn(world * tokens, d_model)
         + 0.5 * rng.randn(d_model)).astype(np.float32)
    target = rng.randn(world * tokens, d_model).astype(np.float32)
    for tag, (top_k, cf) in MOE_CASES.items():
        cases.append({"kind": "moe", "tag": tag, "mesh": {"ep": world},
                      "top_k": top_k, "capacity_factor": cf,
                      "aux_weight": TRAIN["aux_weight"],
                      "timed": timed and tag == "ep_top1"})
    cases.append(dict(TRAIN, kind="moe", tag="ep_train",
                      mesh={"ep": world}, grad=True))
    for tag in list(MOE_CASES) + ["ep_train"]:
        arrays.update({"%s.%s" % (tag, k): v for k, v in params.items()})
        arrays.update({tag + ".x": x, tag + ".target": target})
    return cases, arrays


def _ms(torch, fn):
    return ranks.host_ms(fn, torch.cuda.synchronize)


def _oracle_step(torch, parallel, w, b, mb, lab):
    """The sequential oracle's loss and SGD step (lr PP_LR) by autograd,
    on the device of the tensors given: (loss, [w_new (S, N, K), b_new
    (S, N)])."""
    w = w.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    per = [{"w": w[s], "b": b[s]} for s in range(w.shape[0])]
    loss = torch.stack([ranks.mse(parallel.sequential_reference(
        ranks.stage_fn, per, mb[i]), lab[i])
        for i in range(mb.shape[0])]).mean()
    gw, gb = torch.autograd.grad(loss, (w, b))
    with torch.no_grad():
        return loss.detach(), [w - PP_LR * gw, b - PP_LR * gb]


def _oracle_step_np(torch, parallel, arrays, dev):
    """:func:`_oracle_step` of numpy (w, b, mb, lab) on ``dev``: (loss,
    {"w": w_new, "b": b_new}) in numpy."""
    loss, new = _oracle_step(torch, parallel, *(
        torch.from_numpy(a).to(dev) for a in arrays))
    return loss.item(), {k: t.cpu().numpy() for k, t in zip("wb", new)}


def _oracle_floor(torch, parallel, arrays, dev):
    """:func:`_oracle_step_np` of numpy (w, b, mb, lab) and its float32
    floor: the largest normwise distance the step moves when the
    microbatches are scaled by 1 +- 2^-23. Returns (loss, step,
    floor)."""
    w, b, mb, lab = arrays
    loss, oracle = _oracle_step_np(torch, parallel, arrays, dev)
    floor = max(dp._normwise(_oracle_step_np(
        torch, parallel, (w, b, mb * np.float32(scale), lab), dev)[1],
        oracle, {"w": w, "b": b}) for scale in (1 + 2.0 ** -23,
                                                1 - 2.0 ** -23))
    return loss, oracle, floor


def _check_pp(torch, parallel, rec, case, res, arrays, dev, cuda, failed):
    tag, mesh = case["tag"], case["mesh"]
    w, b = arrays[tag + ".w"], arrays[tag + ".b"]
    mb, lab = arrays[tag + ".mb"], arrays[tag + ".lab"]
    stages, dp_n = mesh["pp"], mesh.get("dp", 1)
    rows = mb.shape[1] // dp_n
    out = {"mesh": mesh}
    with torch.no_grad():
        per = [{"w": torch.from_numpy(w[s]).to(dev),
                "b": torch.from_numpy(b[s]).to(dev)} for s in range(stages)]
        full = np.stack([parallel.sequential_reference(
            ranks.stage_fn, per, torch.from_numpy(m).to(dev)).cpu().numpy()
            for m in mb])
        # K1 at each rank's own row count: the bit-equality reference
        own = {d: np.stack([parallel.sequential_reference(
            ranks.stage_fn, per,
            torch.from_numpy(np.ascontiguousarray(
                m[d * rows:(d + 1) * rows])).to(dev)).cpu().numpy()
            for m in mb]) for d in range(dp_n)}
    bit_equal, err = True, 0.0
    for r, got in enumerate(res):
        d = r % dp_n
        bit_equal &= bool(np.array_equal(got[tag + ".out"], own[d]))
        err = max(err, float(np.abs(got[tag + ".out"]
                                    - full[:, d * rows:(d + 1) * rows]).max()))
    out["outputs_bit_equal_to_oracle_on_own_rows"] = bit_equal
    out["outputs_max_abs_err_vs_global_oracle"] = err
    if not bit_equal:
        failed.append("%s: outputs not bit-equal to the oracle's" % tag)
    launches = [got[tag + ".launches"] for got in res]
    want = MICROBATCHES + stages - 1 if cuda else 0
    out["k1_launches_a_forward_by_rank"] = launches
    if launches != [want] * len(res):
        failed.append("%s: K1 launches %s a forward, want %d on every rank"
                      % (tag, launches, want))
    loss, oracle, floor = _oracle_floor(torch, parallel, (w, b, mb, lab),
                                        dev)
    got = {k: np.concatenate([res[r * dp_n]["%s.%s_new" % (tag, k)]
                              for r in range(stages)]) for k in ("w", "b")}
    dist_ = dp._normwise(got, oracle, {"w": w, "b": b})
    out.update(loss=res[0][tag + ".loss"], oracle_loss=loss,
               params_vs_oracle_normwise=dist_, float32_floor_normwise=floor,
               bound=FLOOR_FACTOR * floor,
               kinds=sorted({str(g[tag + ".kinds"]) for g in res}))
    if not dist_ <= FLOOR_FACTOR * floor:
        failed.append("%s: params %.3g of the oracle's update away, bound "
                      "%.3g (%d float32 floors)" % (tag, dist_,
                                                    FLOOR_FACTOR * floor,
                                                    FLOOR_FACTOR))
    same = all(np.array_equal(g["%s.%s_new" % (tag, k)],
                              res[r - r % dp_n]["%s.%s_new" % (tag, k)])
               for r, g in enumerate(res) for k in ("w", "b"))
    out["dp_replicas_bit_equal"] = same
    if not same:
        failed.append("%s: the dp replicas of a stage differ" % tag)
    if not abs(out["loss"] - loss) <= 1e-5 * abs(loss):
        failed.append("%s: loss %r, the oracle's %r" % (tag, out["loss"],
                                                        loss))
    if out["kinds"] != ["DTensor" if case.get("dtensor") else "Tensor"]:
        failed.append("%s: the step returned %s" % (tag, out["kinds"]))
    rec[tag] = out


def run(torch, world, cpu=False, hid=4096, tokens=4096,
        d_model=SWITCH["d_model"], d_ff=SWITCH["d_ff"],
        experts=SWITCH["experts"]):
    """Spawn the ranks, check them in this process; return the record
    (``failed``: the checks that failed, empty when all passed)."""
    from mxnet_tpu_torch import parallel

    cuda = not cpu
    backend = "gloo" if cpu else "nccl"
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    rec = {"world": world, "backend": backend, "hid": hid,
           "tokens_a_rank": tokens, "moe": dict(experts=experts,
                                                d_model=d_model, d_ff=d_ff),
           "card": None, "failed": []}
    failed = rec["failed"]
    if cuda:
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.empty_cache()
    cases, arrays = inputs(world, hid, tokens, d_model, d_ff, experts,
                           timed=cuda)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks.save_plan(d, cases, arrays)
        codes, res = ranks.spawn(world, backend, d, TIMEOUT_S)
    rec["ranks_seconds"] = time.perf_counter() - t0
    rec["exitcodes"] = codes
    if codes != [0] * world:
        failed.append("ranks exited with %s" % codes)
        return rec
    # the one-card references' one-rank mesh; a process group made for it
    # is destroyed before returning
    made = not torch.distributed.is_initialized()
    mesh = parallel.make_mesh({"ep": 1}, device_type=dev.type)
    try:
        for case in cases:
            if case["kind"] == "pp":
                _check_pp(torch, parallel, rec, case, res, arrays, dev, cuda,
                          failed)
        _check_moe(torch, parallel, rec, cases, res, arrays, mesh, dev,
                   failed)
        if cuda:
            _timings(torch, parallel, rec, res, arrays, mesh, dev)
    finally:
        if made:
            torch.distributed.destroy_process_group()
    return rec


def _moe_params(torch, arrays, tag, dev, grad=False):
    return {k: torch.from_numpy(arrays["%s.%s" % (tag, k)]).to(dev)
            .requires_grad_(grad) for k in ranks.MOE_NAMES}


def _check_moe(torch, parallel, rec, cases, res, arrays, mesh, dev, failed):
    world = len(res)
    for case in cases:
        if case["kind"] != "moe":
            continue
        tag = case["tag"]
        x = arrays[tag + ".x"]
        s = x.shape[0] // world
        params = _moe_params(torch, arrays, tag, dev)
        worst, drops = 0.0, []
        with torch.no_grad():
            for r in range(world):
                xr = torch.from_numpy(x[r * s:(r + 1) * s]).to(dev)
                y, _ = parallel.moe_ffn_local(
                    params, xr, "ep", case["top_k"],
                    case["capacity_factor"], mesh=mesh)
                y = y.cpu().numpy()
                got = res[r][tag + ".y"]
                ok = np.abs(got - y) <= MOE_TOL + MOE_TOL * np.abs(y)
                worst = max(worst, float(np.abs(got - y).max()))
                drops.append(int((np.abs(got).sum(axis=1) == 0).sum()))
                if not ok.all():
                    failed.append("%s: rank %d's y off one card's by %.3g"
                                  % (tag, r, float(np.abs(got - y).max())))
        rec[tag] = {"top_k": case["top_k"],
                    "capacity_factor": case["capacity_factor"],
                    "y_max_abs_err_vs_one_card": worst,
                    "dropped_tokens_by_rank": drops,
                    "aux": res[0][tag + ".aux"]}
        if not case.get("grad"):
            continue
        # the same global loss on one card: the layer over each rank's
        # tokens on a one-rank axis, each rank's share summed
        leaves = _moe_params(torch, arrays, tag, dev, grad=True)
        target = arrays[tag + ".target"]
        total = 0
        for r in range(world):
            xr = torch.from_numpy(x[r * s:(r + 1) * s]).to(dev)
            tr = torch.from_numpy(target[r * s:(r + 1) * s]).to(dev)
            y, aux = parallel.moe_ffn_local(
                leaves, xr, "ep", case["top_k"], case["capacity_factor"],
                mesh=mesh)
            total = total + (ranks.mse(y, tr)
                             + case["aux_weight"] * aux) / world
        total.backward()
        want = {k: v.grad.cpu().numpy() for k, v in leaves.items()}
        local_e = want["w1"].shape[0] // world
        zero = {"g": 0}

        def off(got, want_):
            return dp._normwise({"g": got}, {"g": want_}, zero)

        # the router's (summed) gradient on every rank, each rank's
        # experts' against their rows of one card's
        errs = {k: max(off(res[r][tag + ".g_" + k], want[k] if k == "router"
                           else want[k][r * local_e:(r + 1) * local_e])
                       for r in range(world)) for k in ranks.MOE_NAMES}
        control = off(res[0][tag + ".g_router_local"], want["router"])
        losses = [float(v) for v in res[0][tag + ".losses"]]
        rec[tag].update(loss_one_card=total.item(), losses=losses,
                        grads_vs_one_card_normwise=errs,
                        control_router_unsummed_normwise=control,
                        bound=MOE_TOL)
        bad = {k: v for k, v in errs.items() if not v <= MOE_TOL}
        if bad:
            failed.append("%s: first-step gradients off one card's: %s"
                          % (tag, bad))
        if not control > MOE_TOL:
            failed.append("%s: the control (rank 0's router gradient "
                          "unsummed) is within the bound: %.3g"
                          % (tag, control))
        if not losses[-1] < losses[0]:
            failed.append("%s: the loss did not fall: %s" % (tag, losses))
        if not abs(losses[0] - total.item()) <= MOE_TOL * abs(losses[0]):
            failed.append("%s: first loss %r, one card's %r"
                          % (tag, losses[0], total.item()))


def _timings(torch, parallel, rec, res, arrays, mesh, dev):
    """Host ms of the one-card counterparts, beside the ranks'."""
    world = len(res)
    pp = [torch.from_numpy(arrays["pp." + k]).to(dev)
          for k in ("w", "b", "mb", "lab")]
    step_ms = [g["pp.ms_step"] for g in res]
    stage_ms = [g["pp.ms_stage_fwd_bwd"] for g in res]
    t = {"pp_step_ms_by_rank": step_ms,
         "pp_forward_ms_by_rank": [g["pp.ms_forward"] for g in res],
         "stage_forward_ms_by_rank": [g["pp.ms_stage"] for g in res],
         "stage_forward_backward_ms_by_rank": stage_ms,
         "exchange_ms_a_tick_by_rank": [g["pp.ms_exchange"] for g in res],
         "oracle_step_ms_one_card": _ms(torch, lambda: _oracle_step(
             torch, parallel, *pp)),
         "bubble_share_schedule": (world - 1) / (MICROBATCHES + world - 1),
         "non_stage_share_by_rank": [
             1 - MICROBATCHES * s / m for s, m in zip(stage_ms, step_ms)]}
    tag = "ep_top1"
    top_k, cf = MOE_CASES[tag]
    x = arrays[tag + ".x"]
    s = x.shape[0] // world
    xr = torch.from_numpy(x[:s]).to(dev)
    tr = torch.from_numpy(arrays[tag + ".target"][:s]).to(dev)
    params = _moe_params(torch, arrays, tag, dev)

    def fwd_bwd():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        y, aux = parallel.moe_ffn_local(leaves, xr, "ep", top_k, cf,
                                        mesh=mesh)
        (ranks.mse(y, tr) + TRAIN["aux_weight"] * aux).backward()

    with torch.no_grad():
        one_fwd = _ms(torch, lambda: parallel.moe_ffn_local(
            params, xr, "ep", top_k, cf, mesh=mesh))
    t.update(moe_forward_ms_by_rank=[g[tag + ".ms_forward"] for g in res],
             moe_forward_backward_ms_by_rank=[
                 g[tag + ".ms_forward_backward"] for g in res],
             moe_all_to_all_ms_by_rank=[g[tag + ".ms_all_to_all"]
                                        for g in res],
             moe_forward_ms_one_card=one_fwd,
             moe_forward_backward_ms_one_card=_ms(torch, fwd_bwd))
    rec["timings"] = t


def summary(rec):
    """The record's lines for a reader."""
    card = rec["card"] or "cpu"
    lines = []
    for tag in ("pp", "pp_dp"):
        if tag not in rec:
            continue
        p = rec[tag]
        lines.append(
            "%s %s: outputs bit-equal to the oracle on each rank's rows %s "
            "(max abs err vs the global batch's %.3g), K1 launches a "
            "forward %s, step params %.3g of the oracle's update away "
            "(bound %.3g = %d float32 floors), returned %s  [%s]"
            % (tag, p["mesh"], p["outputs_bit_equal_to_oracle_on_own_rows"],
               p["outputs_max_abs_err_vs_global_oracle"],
               p["k1_launches_a_forward_by_rank"],
               p["params_vs_oracle_normwise"], p["bound"], FLOOR_FACTOR,
               p["kinds"], card))
    for tag in list(MOE_CASES) + ["ep_train"]:
        if tag not in rec:
            continue
        m = rec[tag]
        line = ("%s top-%d cf %g: y max abs err vs one card %.3g, dropped "
                "tokens by rank %s" % (tag, m["top_k"], m["capacity_factor"],
                                       m["y_max_abs_err_vs_one_card"],
                                       m["dropped_tokens_by_rank"]))
        if "losses" in m:
            line += ("; 8 steps' loss %.6g -> %.6g; first-step gradients "
                     "vs one card %s (bound %g); control (router unsummed) "
                     "%.3g, caught" % (m["losses"][0], m["losses"][-1],
                                       {k: "%.3g" % v for k, v in
                                        m["grads_vs_one_card_normwise"]
                                        .items()}, m["bound"],
                                       m["control_router_unsummed_normwise"]))
        lines.append(line + "  [%s]" % card)
    t = rec.get("timings")
    if t:
        lines.append(
            "pp %d: step %.3f ms (slowest rank) vs the sequential oracle's "
            "%.3f ms on one card; bubble share %.3f by the schedule; "
            "outside the 8 useful stage passes %.3f-%.3f of a step by rank "
            "(bubble ticks, exchanges, update, host); exchange %.4f ms a "
            "tick; "
            "ep %d MoE forward %.3f ms, forward+backward %.3f ms (slowest "
            "rank) vs one card's %.3f / %.3f over one rank's tokens; "
            "all-to-all %.4f ms  [%s]"
            % (rec["world"], max(t["pp_step_ms_by_rank"]),
               t["oracle_step_ms_one_card"], t["bubble_share_schedule"],
               min(t["non_stage_share_by_rank"]),
               max(t["non_stage_share_by_rank"]),
               max(t["exchange_ms_a_tick_by_rank"]), rec["world"],
               max(t["moe_forward_ms_by_rank"]),
               max(t["moe_forward_backward_ms_by_rank"]),
               t["moe_forward_ms_one_card"],
               t["moe_forward_backward_ms_one_card"],
               max(t["moe_all_to_all_ms_by_rank"]), card))
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU (a rehearsal)")
    parser.add_argument("--world", type=int, default=None,
                        help="ranks (default: every visible card; 4 on the "
                        "CPU)")
    parser.add_argument("--hid", type=int, default=4096)
    parser.add_argument("--tokens", type=int, default=4096,
                        help="tokens a rank")
    parser.add_argument("--d-model", type=int, default=SWITCH["d_model"])
    parser.add_argument("--d-ff", type=int, default=SWITCH["d_ff"])
    parser.add_argument("--report", help="write the record here (JSON)")
    opts = parser.parse_args()
    import torch

    world = opts.world
    if not opts.cpu:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        world = world or cards
        if world < 2 or cards < world:
            print("torch_pp_moe_check: %s ranks need as many cards, %d "
                  "visible" % (world, cards), file=sys.stderr)
            return 2
    world = world or 4
    if SWITCH["experts"] % world:
        parser.error("the %d experts must divide over --world"
                     % SWITCH["experts"])
    rec = run(torch, world, cpu=opts.cpu, hid=opts.hid, tokens=opts.tokens,
              d_model=opts.d_model, d_ff=opts.d_ff)
    for line in summary(rec):
        print(line)
    for f in rec["failed"]:
        print("FAILED: " + f)
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({"ok": not rec["failed"], "world": world,
                      "failed": rec["failed"], "card": rec["card"]}))
    return 0 if not rec["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
