"""The port's deadline-aware batch scheduler against the JAX package's.

Each case of ``tests/test_adaptive_sched.py`` runs through both
packages' ``BatchScheduler`` (``autostart=False``, one fake clock
script, an infer fn on numpy) and records what the scheduler decided:
the dispatch reason of every step, which requests each step completed
(the batch's composition), the shed sets, the lane counts, the controller
state and trajectory, the latency decomposition. The two records must be
equal; the reference test's own assertions are repeated on the port's.
The two real-clock cases run each package's worker thread and hold both
to the reference's invariants. Nothing here needs a card."""
import numpy as np
import pytest

import mxnet_tpu.io_pipeline as jio
import mxnet_tpu.serving as jserving
import mxnet_tpu.telemetry as jtel
import mxnet_tpu_torch.io_pipeline as tio
import mxnet_tpu_torch.serving as tserving
import mxnet_tpu_torch.telemetry as ttel

DIM = 8
PACKAGES = {"jax": (jserving, jio, jtel), "port": (tserving, tio, ttel)}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float):
        self.t += s


def _fake_infer(placed):
    return [np.asarray(placed[0]) * 2.0], ()


def _row(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(-3, 4, (1, DIM)).astype(np.float32)


def _sched(serving, clk, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("slo_ms", 100.0)
    kw.setdefault("adaptive", True)
    return serving.BatchScheduler(_fake_infer, [(kw["max_batch"], DIM)],
                                  clock=clk, autostart=False, **kw)


def _done(reqs):
    return [r.done() for r in reqs]


# ---------------------------------------------------------------------------
# the cases: each takes one package's (serving, io_pipeline, telemetry)
# and returns the record of what its scheduler decided
# ---------------------------------------------------------------------------

def case_edf_packing(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk, max_batch=4)
    try:
        deadlines = [500.0, 50.0, 400.0, 60.0, 300.0, 70.0]
        reqs = [sched.submit([_row(i)], deadline_ms=d)
                for i, d in enumerate(deadlines)]
        rec = [sched.step(), _done(reqs)]
        rec += [sched.step(), _done(reqs)]
        clk.advance(0.006)
        rec += [sched.step(), _done(reqs), sched.controller_state()]
        rec.append([(t["reason"], t["rows"], t["bucket"])
                    for t in sched.wait_trajectory()])
        return rec
    finally:
        sched.close()


def check_edf_packing(rec):
    assert rec[0] == "full"
    assert rec[1] == [False, True, False, True, True, True]
    assert rec[2] == "wait"
    assert rec[4] == "rung_fill" and all(rec[5])


def case_slack_deadline(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        for i in range(3):
            sched.submit([_row(i)], deadline_ms=10.0)
            clk.advance(0.0002)
        rec = [sched.step(), sched.controller_state()]
        clk.advance(0.0035)
        rec += [sched.step(), sched.controller_state()]
        return rec
    finally:
        sched.close()


def check_slack_deadline(rec):
    assert rec[0] == "wait" and rec[2] == "deadline"


def case_idle(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        sched.submit([np.concatenate([_row(i) for i in range(3)])])
        return [sched.step(), sched.controller_state()]
    finally:
        sched.close()


def check_idle(rec):
    assert rec[0] == "idle"


def case_rung_fill(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk, max_batch=4)
    try:
        sched.submit([_row(0)], deadline_ms=1000.0)
        sched.submit([_row(1)], deadline_ms=1000.0)
        clk.advance(0.1)
        return [sched.step(), sched.controller_state()]
    finally:
        sched.close()


def check_rung_fill(rec):
    assert rec[0] == "rung_fill"


def case_lane_ride_along(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        reqs = [sched.submit([_row(i)], priority="interactive")
                for i in range(4)]
        reqs += [sched.submit([_row(4 + i)], priority="batch")
                 for i in range(4)]
        return [sched.step(), _done(reqs), sched.lane_stats()]
    finally:
        sched.close()


def check_lane_ride_along(rec):
    assert rec[0] == "full" and all(rec[1])
    assert rec[2]["interactive"]["served"] == 4
    assert rec[2]["batch"]["served"] == 4


def case_shed(serving, _io, tel):
    tel.reset()
    tel.enable()
    clk = FakeClock()
    sched = _sched(serving, clk, max_batch=4)
    try:
        live = [sched.submit([_row(i)], deadline_ms=500.0)
                for i in range(6)]
        doomed = [sched.submit([_row(10 + i)], deadline_ms=5.0,
                               priority="batch") for i in range(6)]
        clk.advance(0.05)
        rec = [sched.step(), _done(live), _done(doomed)]
        shed = [i for i, r in enumerate(live + doomed)
                if r.done() and isinstance(r.error, serving.RequestShed)]
        rec.append(shed)
        while not all(r.done() for r in live):
            clk.advance(0.01)
            rec.append(sched.step())
        rec.append([r.get(timeout=0)[0].tolist() for r in live])
        rec.append(sched.lane_stats())
        rec.append(tel.peek("serve.shed_requests"))
        rec.append(sched.controller_state())
        return rec
    finally:
        sched.close()
        tel.reset()
        tel.disable()


def check_shed(rec):
    assert rec[0] == "full"
    assert rec[3] == list(range(6, 12))      # every batch-lane request
    assert "shed" not in rec[4:-4]
    lanes = rec[-3]
    assert lanes["batch"]["shed"] == 6
    assert lanes["interactive"]["shed"] == 0
    assert lanes["interactive"]["served"] == 6
    assert rec[-2] == 6


def case_controller_widen_collapse(serving, _io, _tel):
    ctl = serving.AdaptiveWaitController(slo_ms=100.0, start_ms=2.0)
    rec = [ctl.update(p) for p in (None, 50.0, 70.0, 90.0)]
    for _ in range(40):
        ctl.update(10.0)
    rec += [ctl.wait_ms, ctl.ceil_ms]
    for _ in range(40):
        ctl.update(99.0)
    rec += [ctl.wait_ms, ctl.floor_ms, ctl.updates]
    return rec


def check_controller_widen_collapse(rec):
    assert rec[:4] == pytest.approx([3.0, 4.5, 4.5, 2.25])
    assert rec[4] == pytest.approx(rec[5]) == pytest.approx(50.0)
    assert rec[6] == pytest.approx(rec[7])


def case_controller_monotone(serving, _io, _tel):
    waits = []
    for p99 in (None, 10.0, 40.0, 70.0, 90.0, 130.0):
        ctl = serving.AdaptiveWaitController(slo_ms=100.0, start_ms=8.0)
        waits.append(ctl.update(p99))
    return waits


def check_controller_monotone(rec):
    assert rec == sorted(rec, reverse=True)


def case_arrival_rate(serving, _io, _tel):
    clk = FakeClock()
    est = serving.ArrivalRateEstimator(clock=clk)
    rec = [est.rate()]
    for _ in range(20):
        est.observe()
        clk.advance(0.01)
    rec.append(est.rate())
    clk.advance(1.0)
    rec.append(est.rate())
    return rec


def check_arrival_rate(rec):
    assert rec[0] == 0.0
    assert 50.0 < rec[1] <= 100.0 + 1e-6
    assert rec[2] <= 1.0


def case_service_time(serving, _io, _tel):
    svc = serving.ServiceTimeEstimator(default_ms=2.0)
    rec = [svc.estimate_ms(8)]
    svc.observe(8, 10.0)
    rec += [svc.estimate_ms(8), svc.estimate_ms(4)]
    svc.observe(8, 20.0)
    rec.append(svc.estimate_ms(8))
    return rec


def check_service_time(rec):
    assert rec == pytest.approx([2.0, 10.0, 10.0, 12.5])


def case_feedback_skips_first_dispatch(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        sched.submit([_row(0)])
        rec = [sched.step(), sched.recent_quantile(0.99)]
        clk.advance(0.01)
        sched.submit([_row(1)])
        rec += [sched.step(), sched.recent_quantile(0.99),
                sched.controller_state()]
        return rec
    finally:
        sched.close()


def check_feedback_skips_first_dispatch(rec):
    assert rec[0] == "rung_fill" and rec[1] is None
    assert rec[2] == "rung_fill" and rec[3] is not None


def case_decomposition_fake_clock(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        reqs = []
        for i in range(5):
            reqs.append(sched.submit([_row(i)], deadline_ms=50.0))
            clk.advance(0.003)
        reasons = []
        while not all(r.done() for r in reqs):
            clk.advance(0.003)
            reasons.append(sched.step())
        return [reasons, [r.components for r in reqs],
                [r.latency_ms for r in reqs], sched.controller_state()]
    finally:
        sched.close()


def check_decomposition_fake_clock(rec):
    for comps, lat in zip(rec[1], rec[2]):
        assert set(comps) == {"queue_ms", "sched_idle_ms", "h2d_ms",
                              "dispatch_ms", "d2h_ms"}
        assert sum(comps.values()) == pytest.approx(lat, abs=1e-9)


def case_stats_surface(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        sched.submit([_row(0)])
        reason = sched.step()
        st = sched.stats()
        keys = ("requests_served", "batches", "mean_occupancy", "lanes",
                "adaptive", "adaptive_wait_ms", "arrival_rate_rps",
                "queue_depth", "p50_ms", "p99_ms", "p999_ms",
                "queue_depth_p50", "queue_depth_max")
        return [reason, {k: st.get(k) for k in keys},
                sched.wait_trajectory(), sched.occupancy_snapshot(),
                {k: v for k, v in sched.metrics_payload().items()
                 if k != "serve.request_ms"},
                sched.metrics_payload()["serve.request_ms"]]
    finally:
        sched.close()


def check_stats_surface(rec):
    st = rec[1]
    assert st["adaptive"] is True
    for key in ("adaptive_wait_ms", "arrival_rate_rps", "queue_depth",
                "mean_occupancy", "lanes"):
        assert st[key] is not None
    assert rec[2] and {"t_s", "wait_ms", "queue_depth", "occupancy",
                       "reason"} <= set(rec[2][0])


def case_unknown_lane(serving, _io, _tel):
    clk = FakeClock()
    sched = _sched(serving, clk)
    try:
        with pytest.raises(serving.MXNetError, match="priority lane") as e:
            sched.submit([_row(0)], priority="bulk")
        return [str(e.value)]
    finally:
        sched.close()


def check_unknown_lane(rec):
    assert "bulk" in rec[0]


def case_stager_fast_path(_serving, io, tel):
    tel.reset()
    tel.enable()
    try:
        stager = io.RequestStager(place=None)
        full = np.arange(4 * DIM, dtype=np.float32).reshape(4, DIM)
        placed, pad = stager.stage([[full]], 4)
        rec = [pad, np.asarray(placed[0]).tolist(),
               tel.peek("serve.stage_fastpath"), stager.last_fastpath,
               stager.last_bytes]
        placed, pad = stager.stage([[_row(0)], [_row(1)]], 4)
        rec += [pad, np.asarray(placed[0]).tolist(),
                tel.peek("serve.stage_fastpath"), stager.last_fastpath,
                tel.peek("serve.h2d_bytes"), tel.peek("serve.pad_rows")]
        return rec
    finally:
        tel.reset()
        tel.disable()


def check_stager_fast_path(rec):
    assert rec[0] == 0 and rec[2] == 1 and rec[3] is True
    assert rec[5] == 2 and np.asarray(rec[6]).shape == (4, DIM)
    assert rec[7] == 1 and rec[8] is False


CASES = [(name[len("case_"):], fn, globals()["check_" + name[len("case_"):]])
         for name, fn in sorted(globals().items())
         if name.startswith("case_")]


@pytest.mark.parametrize("name,case,check", CASES,
                         ids=[c[0] for c in CASES])
def test_port_decides_as_the_reference(name, case, check):
    ref = case(*PACKAGES["jax"])
    port = case(*PACKAGES["port"])
    check(ref)
    check(port)
    assert port == ref


# ---------------------------------------------------------------------------
# the real-clock cases: each package's own worker thread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_decomposition_sums_to_latency_real_clock_threaded(pkg):
    serving = PACKAGES[pkg][0]
    sched = serving.BatchScheduler(_fake_infer, [(8, DIM)], max_batch=8,
                                   max_wait_ms=1.0, slo_ms=100.0,
                                   adaptive=True)
    try:
        reqs = [sched.submit([_row(i)]) for i in range(24)]
        for r in reqs:
            r.get(timeout=30)
        for r in reqs:
            assert sum(r.components.values()) == pytest.approx(
                r.latency_ms, rel=1e-6, abs=1e-6)
    finally:
        sched.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_adaptive_on_keeps_ladder_shapes_and_one_dispatch_per_batch(pkg):
    serving = PACKAGES[pkg][0]
    calls = []

    def counting_infer(placed):
        calls.append(int(placed[0].shape[0]))
        return [np.asarray(placed[0]) * 2.0], ()

    sched = serving.BatchScheduler(counting_infer, [(8, DIM)], max_batch=8,
                                   max_wait_ms=1.0, slo_ms=100.0,
                                   adaptive=True)
    try:
        reqs = [sched.submit([_row(i)]) for i in range(40)]
        for r in reqs:
            r.get(timeout=30)
    finally:
        sched.close()
    assert set(calls) <= set(sched.buckets)
    assert len(calls) == sched.stats()["batches"]
    assert sched.stats()["requests_served"] == 40
