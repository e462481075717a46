"""The port's conv probe kernels (family N, ``ops/cuda/conv_probe.py``) against
the JAX probe scripts' Pallas kernels, and the probe entry point on the CPU.

Each JAX script (``scripts/bench_pallas_conv_probe.py``, ``..._probe2.py``) is
loaded by file path as a fresh module for this test module, its globals
shrunk to R = 2, N_TOTAL = 256, N_BLK = 128, and its ``pl`` replaced by a
namespace whose ``pallas_call`` runs in interpret mode. The same numpy-seeded
bf16 inputs go to the JAX function and to the port's wrapper on CPU tensors
(its plain version). Both sides sum the same bf16 products in fp32, in
another order: |got - want| <= 1e-4·max|want| + 1e-4·|want|.
"""

import functools
import importlib.util
import math
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hybrid_vit_cascade_tpu_torch.ops.cuda import conv_probe as cp
from hybrid_vit_cascade_tpu_torch.scripts import bench_conv_probe as bench

ROOT = Path(__file__).resolve().parents[1]
R, N_TOTAL, N_BLK = 2, 256, 128
ATOL_REL, RTOL = 1e-4, 1e-4


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.R, mod.N_TOTAL, mod.N_BLK = R, N_TOTAL, N_BLK
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, ds=pl.ds,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    p1 = _load_script("bench_pallas_conv_probe")
    p2 = _load_script("bench_pallas_conv_probe2")
    return {"V1": p1.make_v1(32), "V0": p1.make_v1(256), "V2": p1.v2, "V3": p1.v3,
            "V3'": p2.v3p, "V5": p2.v5, "V6": p2.v6, "V4": p2.v4, "V8": p2.v8}


def _operands(key: str, seed: int):
    """(torch bf16 tensors, jnp bf16 arrays) of the case's two operands, the
    same values on both sides."""
    case = bench.BY_KEY[key]
    shapes = [(N_TOTAL, cp.K), case.w_shape] if key == "V2" else \
        [case.w_shape, (case.x_rows, N_TOTAL)]
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
          for s in shapes]
    return ts, [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in ts]


@pytest.mark.parametrize("key", ["V1", "V0", "V2", "V3", "V3'", "V5", "V6", "V4", "V8"])
def test_probe_matches_pallas(jax_probes, key):
    ts, js = _operands(key, seed=len(key) + ord(key[1]))
    want = np.asarray(jax_probes[key](*js), dtype=np.float32)
    before = dict(cp.LAUNCHES)
    got = bench.BY_KEY[key].wrapper(*ts, R)
    assert cp.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    bound = ATOL_REL * np.abs(want).max() + RTOL * np.abs(want)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= bound).all(), float(np.abs(got - want).max())


def test_probe_wrappers_check_their_operands():
    w = torch.zeros((cp.TAPS * cp.COUT, cp.CIN), dtype=torch.bfloat16)
    x = torch.zeros((cp.CIN, 40), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        cp.probe_v3p(w.float(), x, 1)
    with pytest.raises(ValueError):
        cp.probe_v3p(w[:-1], x, 1)
    with pytest.raises(ValueError):
        cp.probe_v5(w, x, 1)  # v5 takes (448, 128) weights
    with pytest.raises(ValueError):
        cp.probe_v3p(w, x.t().contiguous().t(), 1)  # not contiguous
    with pytest.raises(ValueError):
        cp.probe_v1(torch.zeros((32, 100), dtype=torch.bfloat16),
                    torch.zeros((100, 8), dtype=torch.bfloat16), 1)  # K not a multiple of 64
    with pytest.raises(ValueError):
        cp.probe_v3p(w, x, 0)
    with pytest.raises(RuntimeError):
        cp.probe_v3p(w.to("meta"), x.to("meta"), 1)  # neither cuda nor cpu


def test_probe_bounds_at_full_size():
    """The bounds the entry point prints at N = 131,072, R = 64 (H100 SXM)."""
    ms = {c.key: bench.bound(c, bench.N_TOTAL, bench.R) for c in bench.CASES}
    assert all(by == "operations" for _, by in ms.values())
    for key, want in (("V1", 0.938), ("V0", 7.50), ("V2", 0.938), ("V3", 0.938),
                      ("V3'", 0.938), ("V5", 0.973), ("V6", 0.938), ("V4", 0.938),
                      ("V8", 0.938), ("VX", 1.876), ("VX2", 1.876)):
        assert math.isclose(ms[key][0], want, rel_tol=1e-3), (key, ms[key])
    floors = {c.key: bench.pass_floor(c, bench.N_TOTAL, bench.R) for c in bench.CASES}
    assert math.isclose(floors["V1"], 8.98, rel_tol=1e-3)
    assert math.isclose(floors["V0"], 11.24, rel_tol=1e-3)
    assert floors["V3'"] is None and floors["VX"] is None


def test_entry_point_runs_on_cpu(capsys):
    rows = bench.main(["--device", "cpu", "--n", "256", "--repeats", "1"])
    assert [r["case"] for r in rows] == [c.key for c in bench.CASES]
    assert all(r["ms"] > 0 for r in rows)
    assert all(r["library_ms"] > 0 and r["plain_ms"] > 0 for r in rows if r["kernel"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu") and out[-1].startswith('{"device": "cpu"')


def test_entry_point_filters_by_prefix():
    rows = bench.main(["V3", "VX2", "--device", "cpu", "--n", "77", "--repeats", "1"])
    assert [r["case"] for r in rows] == ["V3", "V3'", "VX2"]


def test_entry_point_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["V1"])
    assert exc.value.code not in (0, None)
