#!/usr/bin/env python3
"""How well conditioned is chip_smoke.py's training gate in float32?

    python3 tools/torch_gate_conditioning.py [--gammas 1.0,0.25]

Runs the gate's step (ResNet-50 NHWC, 224x224, batch 2, one SGD step
with chip_smoke's TRAIN_OPT) through the PyTorch port on the CPU, once
on the gate's images and once on each of two copies perturbed by 1e-7
relative, for each gamma of the residual blocks' last BatchNorm. Prints,
for each, the worst excess of |params(perturbed) - params| over the
gate's tolerance (rtol 1e-3, the excess must stay under atol 1e-5) and
the loss's relative change. A perturbation this size is float32
rounding; any implementation whose excess here is above 1e-5 cannot
pass the gate against another summation order. CPU only; about 3 s a
step on 4 threads, 2 GB.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def step(cs, mx, images, labels, gamma_b3):
    mod = cs.gate_module(mx, mx.cpu(), gamma_b3)
    mod.init_optimizer(optimizer="sgd", optimizer_params=cs.TRAIN_OPT)
    mod.forward_backward(mx.io.DataBatch([images], [labels]))
    mod.update()
    probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
    loss = float(-np.log(probs[np.arange(2), labels.astype(int)]).mean())
    return loss, cs._host(mod.get_params()[0])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gammas", default="1.0,0.25")
    opts = parser.parse_args()
    import chip_smoke as cs
    import mxnet_tpu_torch as mx

    # the gate's images and labels: the first two of the training path's
    rng = np.random.RandomState(0)
    images = rng.randn(cs.TRAIN_STEPS * cs.BATCH, *cs.IMAGE).astype(
        np.float32)[:2]
    labels = rng.randint(0, 1000, cs.TRAIN_STEPS * cs.BATCH).astype(
        np.float32)[:2]
    for gamma in (float(g) for g in opts.gammas.split(",")):
        loss, base = step(cs, mx, images, labels, gamma)
        for seed in (5, 6):
            noise = np.random.RandomState(seed).randn(*images.shape)
            pert = (images * (1 + 1e-7 * noise)).astype(np.float32)
            loss_p, params = step(cs, mx, pert, labels, gamma)
            worst = max((float(np.max(np.abs(params[k] - base[k])
                                      - 1e-3 * np.abs(base[k]))), k)
                        for k in base)
            print("gamma_b3 %.3g, perturbation seed %d: worst excess %.3g at "
                  "%s (gate: <= 1e-5), loss %.9g vs %.9g (rel %.3g)"
                  % (gamma, seed, worst[0], worst[1], loss_p, loss,
                     abs(loss_p - loss) / loss), flush=True)


if __name__ == "__main__":
    main()
