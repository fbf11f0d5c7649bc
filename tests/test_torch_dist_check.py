"""tools/torch_dist_check.py rehearsed on the CPU: four ``tools/launch.py``
workers over gloo train ResNet-50 NHWC under ``dist_sync`` at a tiny size
(4 images of 64 x 64 a worker, 2 steps; smaller makes the per-worker
BatchNorm over the last stage's few rows chaotic, and the float32 floor
then spans the whole update); the ranks end bit-identical, within the
bound of the one-process reference that runs the shards in turn, and the
planted control (a rank that keeps its own gradient) breaks the
bound."""
import os
import sys

import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import kernels

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))

import torch_dist_check  # noqa: E402


def test_the_four_process_check_rehearses_on_the_cpu():
    rec = torch_dist_check.run(torch, tmx, kernels, 4, per_card=4, steps=2,
                               image=64, cpu=True, log=lambda *_: None)
    assert rec["failed"] == []
    assert rec["launch_rc"] == 0 and len(rec["ranks"]) == 4
    assert rec["ranks_identical"]
    assert all(r["update_on_kvstore"] and not r["fused"]
               and r["rescale_grad"] == 1.0 / 16 for r in rec["ranks"])
    assert rec["params_vs_reference_normwise"] <= rec["bounds"]["params"]
    assert rec["control"]["caught"]
