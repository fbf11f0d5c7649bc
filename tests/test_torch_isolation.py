"""The PyTorch port imports neither jax nor the JAX package: a fresh
interpreter importing every module of ``mxnet_tpu_torch`` ends with
neither in ``sys.modules``, and no source line of the port (or of
chip_smoke.py, which drives it on the card, and of the tools and rank
helpers chip_smoke.py loads at run time) imports them."""
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


def _loaded_by_chip_smoke():
    """tools/<name>.py for every ``_tools_module("<name>")`` of
    chip_smoke.py, and the ``torch_*`` modules of tools/ and tests/
    those import."""
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        names = set(re.findall(r'_tools_module\("(\w+)"\)', f.read()))
    files = []
    for name in sorted(names):
        path = os.path.join(REPO, "tools", name + ".py")
        files.append(path)
        with open(path, encoding="utf-8") as f:
            for dep in re.findall(r"^import (torch_\w+)", f.read(), re.M):
                files += [p for p in (os.path.join(REPO, d, dep + ".py")
                                      for d in ("tools", "tests"))
                          if os.path.exists(p)]
    return files


def test_no_source_line_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")] + _loaded_by_chip_smoke()
    assert os.path.join(REPO, "tests", "torch_pp_moe_ranks.py") in files
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
