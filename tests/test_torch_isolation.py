"""The PyTorch port imports neither jax nor the JAX package: a fresh
interpreter importing every module of ``mxnet_tpu_torch`` ends with
neither in ``sys.modules``, and no source line of the port (or of
chip_smoke.py, which drives it on the card) imports them."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import mxnet_tpu_torch
for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "mxnet_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("BAD=%s" % bad)
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD=[]" in res.stdout, res.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax\b|jaxlib\b|"
                     r"mxnet_tpu(?!_torch)\b)")


def test_no_source_line_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for no, line in enumerate(f, 1):
                if _IMPORT.match(line):
                    offenders.append("%s:%d: %s" % (path, no, line.strip()))
    assert len(files) > 20
    assert not offenders, offenders
