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


# ------------------------------------------------- the wgmma instance of V0 ---

PROBE_SRC = (ROOT / "hybrid_vit_cascade_tpu_torch" / "csrc" / "conv_probe.cu").read_text()
WGMMA_SRC = (ROOT / "hybrid_vit_cascade_tpu_torch" / "csrc" / "wgmma_sm90.cuh").read_text()


def _wg_const(name: str) -> int:
    """A constant of probe_gemm_wgmma, from conv_probe.cu (a product of
    constants, evaluated)."""
    import re

    expr = re.search(rf"^constexpr [^\n]*?\b{name} = ([^,;]+)[,;]", PROBE_SRC, re.M).group(1)
    names = {n: _wg_const(n) for n in re.findall(r"kWg\w+", expr)}
    return int(eval(expr, {}, names))


@pytest.mark.parametrize("m,n", [(256, 131072), (256, 8192), (256, 2120), (64, 8), (320, 16),
                                 (32, 131072), (256, 77), (63, 8), (65, 8), (128, 1001), (1, 1)])
def test_v1_wgmma_rule_is_the_source(m, n):
    """``probe_v1_uses_wgmma`` states the C rule ``v1_uses_wgmma``, which
    ``hvc_probe_v1`` dispatches by and ``hvc_probe_v1_wgmma`` reports: m in
    whole m64 tiles and N a multiple of 8 (16-byte rows for the tensor
    maps); V0 takes it, V1 (m = 32) does not."""
    assert "int v1_uses_wgmma(int m, int n) { return m % 64 == 0 && n % 8 == 0; }" in PROBE_SRC
    assert "  if (v1_uses_wgmma(m, n)) return gemm_wgmma(w, p, out, m, n, k, repeats, s);" \
        in PROBE_SRC
    assert "  return v1_uses_wgmma(m, n);" in PROBE_SRC
    assert cp.probe_v1_uses_wgmma(m, cp.K, n) == (m % 64 == 0 and n % 8 == 0)
    assert (cp.WGMMA_M, cp.WGMMA_N_ALIGN) == (64, 8)


def _walk(m: int, n: int, repeats: int, grid: int):
    """The work items of probe_gemm_wgmma as its blocks walk them: block b
    takes items b, b + grid, …; item it is pass it / (tiles_m·tiles_n) and
    tile it % (tiles_m·tiles_n), N-major (m tile = tile % tiles_m)."""
    bm, bn = _wg_const("kWgBM"), _wg_const("kWgBN")
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    per_pass = tiles_m * tiles_n
    assert ("        const int m0 = int(tile % tiles_m) * kWgBM, n0 = int(tile / tiles_m) * kWgBN;"
            in PROBE_SRC)
    return [(it // per_pass, (it % per_pass) % tiles_m * bm, (it % per_pass) // tiles_m * bn, b)
            for b in range(grid) for it in range(b, repeats * per_pass, grid)]


@pytest.mark.parametrize("m,n,repeats,grid", [(256, 131072, 64, 132), (256, 2120, 3, 132),
                                              (320, 4096, 2, 7), (64, 200, 1, 132)])
def test_wgmma_walk_covers_every_pass_and_tile_once(m, n, repeats, grid):
    """Every (pass, m tile, n tile) is one work item of one block, a work item
    holds all 256 rows of its N tile (one item per N tile at m ≤ 256), and
    each block's items go in pass order."""
    bm, bn = _wg_const("kWgBM"), _wg_const("kWgBN")
    assert (bm, bn, _wg_const("kWgBK")) == (256, 128, 64)
    items = _walk(m, n, repeats, grid)
    keys = [(r, m0, n0) for r, m0, n0, _ in items]
    want = [(r, m0, n0) for r in range(repeats) for n0 in range(0, n, bn) for m0 in range(0, m, bm)]
    assert sorted(keys) == sorted(want) and len(set(keys)) == len(keys)
    if m <= bm:
        assert all(m0 == 0 for _, m0, _, _ in items)
    for b in range(grid):
        passes = [r for r, _, _, blk in items if blk == b]
        assert passes == sorted(passes)


def _sw128(row: int, chunk: int) -> int:
    """sw128_offset (wgmma_sm90.cuh): byte offset of 16-byte chunk `chunk` of
    128-byte row `row` under the 128-byte swizzle."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def test_sw128_is_the_source_and_a_bijection():
    """The mirror states the C function, and on one ring stage (A: 256 rows
    of 128 bytes; each B box: 64 rows) and one epilogue box (64 rows of 32
    fp32) every (row, chunk) lands on its own 16-byte slot of its row, the 8
    rows of a chunk column in 8 different bank groups."""
    assert "  return row * 128u + ((chunk ^ (row & 7u)) << 4);" in WGMMA_SRC
    for rows in (_wg_const("kWgBM"), _wg_const("kWgBK"), 64):
        offs = [_sw128(r, c) for r in range(rows) for c in range(8)]
        assert sorted(offs) == list(range(0, rows * 128, 16))
        assert all(_sw128(r, c) // 128 == r for r in range(rows) for c in range(8))
        for r0 in range(0, rows, 8):
            for c in range(8):
                assert len({_sw128(r0 + i, c) % 128 for i in range(8)}) == 8
    assert _wg_const("kWgABytes") == 256 * 128 and _wg_const("kWgBBytes") == 2 * 64 * 128


def _desc(addr: int, lbo: int, sbo: int) -> int:
    """wgmma_desc (wgmma_sm90.cuh): the 128-byte-swizzle matrix descriptor."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | (((sbo >> 4) & 0x3FFF) << 32) | (1 << 62))


def test_wgmma_descriptors_are_the_source():
    """The descriptor's fields (start address / 16 in bits 0-13, leading
    byte offset / 16 in 16-29, stride byte offset / 16 in 32-45, layout 1 =
    128-byte swizzle in 62-63) as wgmma_desc packs them, and the operands'
    strides: A K-major (8-row groups 1,024 bytes apart, the leading offset
    unused, a k16 step 32 bytes along the swizzled row), B MN-major (its
    second 64-column box a whole 64 × 128-byte box after its first: the
    leading offset; 8 k rows 1,024 bytes apart: the stride offset; a k16
    step 16 rows)."""
    for line in ("  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |",
                 "         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |",
                 "         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | "
                 "(kDescLayoutSw128 << 62);",
                 "constexpr uint64_t kDescLayoutSw128 = 1;"):
        assert line in WGMMA_SRC
    sbo, lbo_b, lbo_a = _wg_const("kWgSbo"), _wg_const("kWgLboB"), _wg_const("kWgLboA")
    assert (sbo, lbo_b, lbo_a) == (8 * 128, 64 * 128, 16)
    assert lbo_b == _wg_const("kWgBBytes") // 2  # the second B box of a stage
    for line in ("        const uint64_t db = wgmma_desc(b0 + kk * 16 * 128, kWgLboB, kWgSbo);",
                 "          wgmma_m64n128k16<1>(acc[i], wgmma_desc(a0 + i * 64 * 128 + kk * 32, "
                 "kWgLboA, kWgSbo), db,"):
        assert line in PROBE_SRC
    d = _desc(0x1C400 + 2048, lbo_b, sbo)
    assert d & 0x3FFF == (0x1C400 + 2048) >> 4
    assert (d >> 16) & 0x3FFF == 512 and (d >> 32) & 0x3FFF == 64 and d >> 62 == 1
    assert (d >> 49) & 0x7 == 0  # base offset: every stage starts 1024-byte aligned
    stage = _wg_const("kWgStageBytes")
    assert stage % 1024 == 0 and _wg_const("kWgABytes") % 1024 == 0


def test_wgmma_epilogue_fills_each_store_box_once():
    """A consumer warpgroup's float2 writes of one epilogue round (rows 16·warp
    + lane / 4 + 8·(jj % 4 / 2), columns 8·(jj / 4) + 2·(lane % 4) of a 64 × 32
    fp32 box, at sw128_offset(row, column / 4) + 8·(lane % 2)) cover every
    8-byte slot of the box once, and each warp's store of one jj hits every
    bank the same number of times (no conflict beyond the two wavefronts of
    256 bytes)."""
    cols = _wg_const("kWgOutCols")
    assert cols == _wg_const("kWgOutBox") == 32
    slots = []
    for warp, lane, jj in ((w, ln, j) for w in range(4) for ln in range(32)
                           for j in range(0, cols // 2, 2)):
        row = 16 * warp + lane // 4 + 8 * ((jj % 4) // 2)
        c = 8 * (jj // 4) + 2 * (lane % 4)
        slots.append(_sw128(row, (c % 32) // 4) + (lane % 2) * 8)
    assert sorted(slots) == list(range(0, 64 * 32 * 4, 8))
    for warp, jj in ((w, j) for w in range(4) for j in range(0, cols // 2, 2)):
        banks = [((_sw128(16 * warp + ln // 4 + 8 * ((jj % 4) // 2), (8 * (jj // 4) + 2 * (ln % 4))
                          // 4) + (ln % 2) * 8) // 4 + k) % 32 for ln in range(32) for k in range(2)]
        assert sorted(banks) == sorted(list(range(32)) * 2)
