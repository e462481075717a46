"""The PyTorch port imports no JAX: every module of hybrid_vit_cascade_tpu_torch
is imported in a fresh interpreter, which must then hold none of jax, flax,
optax or orbax. Importing also compiles nothing."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import hybrid_vit_cascade_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
_CHECK = """
import importlib, json, sys
mods = json.loads(sys.argv[1])
for m in mods:
    importlib.import_module(m)
banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
print(json.dumps({"banned": banned, "lib_loaded": _build.library.cache_info().currsize}))
"""


def _modules():
    pkg = hybrid_vit_cascade_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_modules_found():
    names = set(_modules())
    for m in ("ops.cuda._build", "ops.cuda.flash_attention", "ops.cuda.conv3d_k3",
              "ops.attention", "ops.chain", "ops.conv3d", "ops.pool", "ops.resize",
              "models.layers", "models.attention", "models.vit3d", "models.encoders",
              "models.cascade", "convert", "inference.infer"):
        assert f"hybrid_vit_cascade_tpu_torch.{m}" in names, m


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _CHECK, json.dumps(_modules())],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["banned"] == []
    assert out["lib_loaded"] == 0  # no kernel built or loaded at import
