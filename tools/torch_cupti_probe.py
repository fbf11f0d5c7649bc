#!/usr/bin/env python3
"""Does torch.profiler see the first kernel of a CUDA graph's first replay
in a session, session after session, in one process?

    python3 tools/torch_cupti_probe.py --sessions 80 --report probe.json

With CUPTI kept set up between sessions (``mx.profiler.keep_cupti()``,
as chip_smoke and the multi-card tools run), the process opens
``--sessions`` torch.profiler sessions one after another. In each it
replays a small CUDA graph twice, whose first node is a spin kernel
(``torch.cuda._sleep``) and whose other nodes are a few elementwise
kernels, and counts the spin kernel's events (2 when the profiler sees
both replays' first node). Between sessions it captures one more graph
of the same kind and keeps it alive, as a long run keeps its fused
steps' graphs. A second pass of as many sessions replays the graph once
before a marker kernel (a fill) and counts only the two replays after
it (the warm replay of chip_smoke's ``_profile_steps`` and of
tools/torch_dp_feed_check.py's ``profile_by_card``).

With ``--minutes M``, a third pass follows the process's age instead:
for M minutes, after a pause of ``--every`` seconds each time, it runs
one round of ``--age-kinds`` sessions (``lone,cold``): ``lone`` launches
a single spin kernel and records the kernel's start minus its launch
call's start (``cudaLaunchKernel``, host side), both as torch.profiler
reports them; ``cold`` and ``warm`` count the graph's first nodes as the
first two passes do. A kernel starts after its launch, so the difference
is positive; a difference that falls with the process's age is a drift
between the trace's host and device clocks, which would push a session's
first kernels before the session's start, where the trace drops them.

Prints, for each pass, the sessions whose count fell short and the
events of the first such session (and the age pass's differences); the
last line is one JSON object. Needs one card. Imports neither jax nor
the JAX package.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def graph_of(torch):
    """A CUDA graph whose first node is a spin kernel, then three
    elementwise kernels; its tensors are kept with it."""
    x = torch.zeros(1 << 16, device="cuda")
    y = torch.zeros_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)          # warm the elementwise kernels off the graph
        y.copy_(x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        torch.cuda._sleep(100)
        x.add_(1.0)
        y.copy_(x)
        y.mul_(2.0)
    return g, (x, y)


def session(torch, g, warm):
    """One profiler session: two replays counted (after one warm replay
    and a marker kernel with ``warm``). Returns the counted spin events
    and the names of every kernel event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm:
            g.replay()
            torch.cuda.synchronize()
            # the marker: a fill, a kernel the graph does not hold
            torch.empty(8, device="cuda").fill_(3.0)
        for _ in range(2):
            g.replay()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    spins = [e for e in events if "spin_kernel" in e.name]
    if warm:
        marks = [e.time_range.start for e in events
                 if "FillFunctor" in e.name]
        start = marks[0] if marks else float("inf")
        spins = [e for e in spins if e.time_range.start > start]
    return len(spins), names


def launch_lag(torch):
    """One session with one spin kernel: ``(kernel start - launch call
    start in us, or None, kernels seen)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
    events = prof.events()
    launches = [e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    spins = [e.time_range.start for e in events
             if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name]
    lag = spins[0] - launches[0] if spins and launches else None
    return lag, len(spins)


def by_age(torch, g, minutes, every_s, kinds=("lone", "cold")):
    """The age pass: after each pause of ``every_s``, one session of each
    of ``kinds`` in order: ``lone`` (:func:`launch_lag`: the lag in us and
    the kernels seen), ``cold`` or ``warm`` (:func:`session` over ``g``:
    the counted first nodes seen). ``[(seconds since it began, {kind:
    result})]``."""
    out = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < minutes * 60:
        got = {}
        for kind in kinds:
            got[kind] = (launch_lag(torch) if kind == "lone"
                         else session(torch, g, kind == "warm")[0])
        out.append((round(time.perf_counter() - t0, 1), got))
        time.sleep(every_s)
    return out


def run(torch, mx, sessions, minutes=0.0, every_s=30.0,
        kinds=("lone", "cold")):
    mx.profiler.keep_cupti()
    g, keep = graph_of(torch)
    alive = []
    out = {}
    for warm in (False, True):
        short, first = [], None
        for s in range(sessions):
            n, names = session(torch, g, warm)
            if n < 2:
                short.append(s)
                if first is None:
                    first = names
            alive.append(graph_of(torch))
        out["warm" if warm else "cold"] = {
            "sessions": sessions, "short_sessions": short,
            "first_short_events": first}
    out["graphs_alive"] = len(alive) + 1
    if minutes > 0:
        out["by_age"] = by_age(torch, g, minutes, every_s, kinds)
    del keep
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sessions", type=int, default=80)
    parser.add_argument("--minutes", type=float, default=0.0,
                        help="the age pass's length (0: no age pass)")
    parser.add_argument("--every", type=float, default=30.0,
                        help="seconds of pause before each of the age "
                        "pass's rounds")
    parser.add_argument("--age-kinds", default="lone,cold",
                        help="the sessions of an age round, in order: "
                        "lone, cold, warm")
    parser.add_argument("--report", help="write the record here (JSON)")
    opts = parser.parse_args()
    import torch

    import mxnet_tpu_torch as mx

    if not torch.cuda.is_available():
        print("torch_cupti_probe: needs a card", file=sys.stderr)
        return 2
    rec = run(torch, mx, opts.sessions, opts.minutes, opts.every,
              tuple(opts.age_kinds.split(",")))
    for kind in ("cold", "warm"):
        r = rec[kind]
        print("%s: %d of %d sessions saw fewer than 2 first nodes: %s; "
              "first such session's kernel events: %s"
              % (kind, len(r["short_sessions"]), r["sessions"],
                 r["short_sessions"], r["first_short_events"]))
    if "by_age" in rec:
        print("age: (seconds, {lone: (kernel start - launch start in us, "
              "kernels seen), cold/warm: first nodes seen in two counted "
              "replays}): %s" % rec["by_age"])
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
