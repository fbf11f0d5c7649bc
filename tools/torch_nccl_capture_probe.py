#!/usr/bin/env python3
"""Can a single-process NCCL all-reduce over several cards be captured in
CUDA graphs? Two ways, each in a child process of its own (a failed
capture can abort the process):

    python3 tools/torch_nccl_capture_probe.py            # every visible card

* ``per_card``: one graph a card, captures begun together, each on its
  card's side stream, then one ``torch.cuda.nccl.all_reduce`` over the
  cards' streams; the first error is printed before the graphs are torn
  down.
* ``one_graph``: one graph begun on card 0's side stream with the other
  cards' side streams forked into it (``replicas.CardGraph``, what the
  fused step over several cards uses); the all-reduce replayed three
  times with new inputs must give the sum on every card.

Prints one JSON line a way and exits non-zero when ``one_graph`` fails.
Imports neither jax nor the JAX package.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def per_card(torch, n):
    xs = [torch.ones(1 << 16, device=torch.device("cuda", k))
          for k in range(n)]
    torch.cuda.nccl.all_reduce(xs)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(x.device) for x in xs]
    graphs = [torch.cuda.CUDAGraph() for _ in xs]
    for k, (g, s) in enumerate(zip(graphs, streams)):
        s.wait_stream(torch.cuda.current_stream(k))
        torch.cuda.set_stream(s)
        with torch.cuda.device(k):
            g.capture_begin(capture_error_mode="thread_local")
    try:
        torch.cuda.nccl.all_reduce(xs, streams=streams)
        for k, g in enumerate(graphs):
            with torch.cuda.device(k):
                g.capture_end()
        return {"ok": True}
    except Exception as e:      # report whatever the capture raised
        return {"ok": False, "error": "%s: %s" % (
            type(e).__name__, str(e).splitlines()[0])}


def one_graph(torch, n):
    from mxnet_tpu_torch.replicas import CardGraph, Replicas

    reps = Replicas([torch.device("cuda", k) for k in range(n)])
    xs = [torch.ones(1 << 16, device=d) for d in reps.devices]
    torch.cuda.nccl.all_reduce(xs)
    graph = CardGraph(reps, [torch.cuda.Stream(d) for d in reps.devices])

    def body():
        reps.begin()
        reps.sum_(xs)
    graph.capture(body)
    sums = []
    for rep in range(3):
        for k, x in enumerate(xs):
            x.fill_(float(k + rep))
        graph.replay()
        torch.cuda.synchronize()
        want = float(sum(k + rep for k in range(n)))
        sums.append(all(bool((x == want).all()) for x in xs))
    return {"ok": all(sums), "replays_right": sums}


def main():
    import torch

    if len(sys.argv) == 3:      # a child: run one way, skip the teardown
        res = {"per_card": per_card, "one_graph": one_graph}[sys.argv[1]](
            torch, int(sys.argv[2]))
        print("RESULT " + json.dumps(res), flush=True)
        os._exit(0)
    n = torch.cuda.device_count()
    if n < 2:
        print("needs two cards (%d visible)" % n, file=sys.stderr)
        return 2
    failed = False
    for way in ("per_card", "one_graph"):
        p = subprocess.run([sys.executable, __file__, way, str(n)],
                           capture_output=True, text=True, timeout=120)
        lines = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        res = json.loads(lines[-1][7:]) if lines else {
            "ok": False, "rc": p.returncode,
            "stderr": [x for x in p.stderr.splitlines()
                       if x.strip() and "frame #" not in x][-8:]}
        res.update(way=way, cards=n)
        print(json.dumps(res))
        failed |= way == "one_graph" and not res["ok"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
