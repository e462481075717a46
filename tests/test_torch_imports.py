"""The PyTorch port imports no JAX: every module of hybrid_vit_cascade_tpu_torch
and ``chip_smoke.py`` are imported in a fresh interpreter, which must then
hold none of jax, flax, optax, orbax or the JAX package. Importing also
compiles nothing. ``convert_orbax.py`` is left out of the scan by design: it
is the one file that imports both packages (it runs on a host with JAX and
reads the JAX package's checkpoints); the port-side half it calls
(``convert.variables``, ``convert.adamw_state``,
``training.checkpoint.write_entry``) lives in scanned modules."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import hybrid_vit_cascade_tpu_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
_CHECK = """
import importlib, json, sys
mods = json.loads(sys.argv[1])
for m in mods:
    importlib.import_module(m)
banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                                               "hybrid_vit_cascade_tpu", "convert_orbax"))
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
              "ops.cuda.conv_probe", "scripts.bench_conv_probe",
              "ops.attention", "ops.slab", "ops.conv3d", "ops.pool", "ops.resize",
              "models.layers", "models.attention", "models.vit3d", "models.encoders",
              "models.cascade", "convert", "inference.infer", "ops.ssim", "ops.fft",
              "ops.drr", "losses.metrics", "losses.multiscale", "training.schedules",
              "training.trainer", "config", "cli", "data.dataset", "data.nifti",
              "data.native_io", "data.pipeline", "data.synthetic", "training.checkpoint",
              "utils.logging", "models.depth_lifting", "models.diffusion",
              "ops.cuda.library", "inference.serving", "utils.summary", "utils.wandb_compat",
              "utils.viz", "parallel", "parallel.mesh"):
        assert f"hybrid_vit_cascade_tpu_torch.{m}" in names, m


def test_port_functions_in_scanned_modules():
    """The Orbax reader's port-side half sits in modules the scan imports."""
    from hybrid_vit_cascade_tpu_torch import convert
    from hybrid_vit_cascade_tpu_torch.training import checkpoint, trainer

    scanned = set(_modules())
    for fn in (convert.variables, convert.leaf_sources, convert.adamw_state,
               checkpoint.write_entry, checkpoint.load_optimizer_state, trainer.cascade_trainable):
        assert fn.__module__ in scanned, fn


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _CHECK, json.dumps(_modules() + ["chip_smoke"])],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["banned"] == []
    assert out["lib_loaded"] == 0  # no kernel built or loaded at import
