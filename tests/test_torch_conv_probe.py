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


# ------------------------------- the wgmma instances of V0, V1, V2 and V3 ---

PROBE_SRC = (ROOT / "hybrid_vit_cascade_tpu_torch" / "csrc" / "conv_probe.cu").read_text()
WGMMA_SRC = (ROOT / "hybrid_vit_cascade_tpu_torch" / "csrc" / "wgmma_sm90.cuh").read_text()
B_MODES = {"kBStreamMN": 0, "kBStreamK": 1, "kBResidentK": 2}


def _wg_const(name: str) -> int:
    """A constant of probe_gemm_wgmma, from conv_probe.cu (a product of
    constants, evaluated)."""
    import re

    expr = re.search(rf"^constexpr [^\n]*?\b{name} = ([^,;]+)[,;]", PROBE_SRC, re.M).group(1)
    names = {n: _wg_const(n) for n in re.findall(r"kWg\w+", expr)}
    return int(eval(expr, {}, names))


def _wg_cfg(name: str) -> dict:
    """The WgCfg of instance `name` (WgV0, WgV1, WgV3, WgV2, WgV2Streamed), its
    derived sizes computed as the struct computes them."""
    import re

    args = re.search(rf"^using {name} = WgCfg<(\d+), (\d+), (\d+), (\d+), (\d+), (\w+)"
                     r"(?:, (true|false))?>;", PROBE_SRC, re.M).groups()
    cons, mt, nt, wn, stages = map(int, args[:5])
    bmode = B_MODES[args[5]]
    cfg = {"CONS": cons, "MT": mt, "NT": nt, "WN": wn, "STAGES": stages, "BMODE": bmode,
           "TAP_A": args[6] == "true",
           "BM": cons * mt * 64, "BN": nt * wn, "ABytes": cons * mt * 64 * 128,
           "BBytes": 0 if bmode == 2 else nt * wn * 128, "TRANS_B": int(bmode == 0)}
    cfg["StageBytes"] = cfg["ABytes"] + cfg["BBytes"]
    cfg["smem"] = lambda k: (1024 + stages * cfg["StageBytes"] + (k * cfg["BN"] * 2 if bmode == 2
                                                                    else 0)
                             + cons * _wg_const("kWgOutBytes") + 2 * stages * 8)
    return cfg


WG = {key: _wg_cfg(name) for key, name in (("V0", "WgV0"), ("V1", "WgV1"), ("V3", "WgV3"),
                                           ("V2", "WgV2"), ("V2s", "WgV2Streamed"))}


def test_wgmma_configs_are_the_source():
    """The struct's derived sizes as the tests compute them, and the shapes
    each probe's orientation asks for: V0 256 × 128 items of two warpgroups
    of two m64 tiles, B MN-major; V1 one m64 tile (W's 32 rows in its top
    half) × 256 columns, B MN-major, and V3 the same with its A boxes
    tap-major (the only config with TAP_A); V2 256 spatial rows × 32 (Cout as N),
    B K-major and resident (or streamed); each ring within the card's
    232,448 bytes of shared memory at K = 1728, as the source's comments say,
    and kV2MaxK the deepest resident K."""
    for line in ("  static constexpr int BM = CONS * MT * 64;  // rows of a work item",
                 "  static constexpr int BN = NT * WN;         // columns of a work item",
                 "  static constexpr int BBytes = BMODE == kBResidentK ? 0 : BN * 128;",
                 "  static constexpr int StageBytes = ABytes + BBytes;",
                 "    return 1024 + STAGES * StageBytes + (BMODE == kBResidentK ? k * BN * 2 : 0) +",
                 "           CONS * kWgOutBytes + 2 * STAGES * 8;"):
        assert line in PROBE_SRC, line
    shapes = {k: (c["BM"], c["BN"], c["CONS"], c["MT"], c["NT"], c["WN"], c["BMODE"])
              for k, c in WG.items()}
    assert shapes == {"V0": (256, 128, 2, 2, 1, 128, 0), "V1": (64, 256, 1, 1, 2, 128, 0),
                      "V3": (64, 256, 1, 1, 2, 128, 0),
                      "V2": (256, 32, 2, 2, 1, 32, 2), "V2s": (256, 32, 2, 2, 1, 32, 1)}
    assert {k for k, c in WG.items() if c["TAP_A"]} == {"V3"}
    assert WG["V3"]["STAGES"] == WG["V1"]["STAGES"] == 5
    assert "  static constexpr bool TAP_A = TAP_A_;" in PROBE_SRC
    assert '  static_assert(!TAP_A || BM == 64, "a tap-major A box is one m64 tile");' in PROBE_SRC
    smem = {k: c["smem"](cp.K) for k, c in WG.items()}
    assert smem == {"V0": 214080, "V1": 214096, "V3": 214096, "V2": 226352, "V2s": 201808}
    assert max(smem.values()) <= _wg_const("kWgSmemMax") == 232448
    max_k = (232448 - WG["V2"]["smem"](0)) // (2 * 32) // 64 * 64
    assert max_k == cp.V2_MAX_K == 1792 and WG["V2"]["smem"](max_k) <= 232448
    assert WG["V2"]["smem"](max_k + 64) > 232448
    assert ("constexpr int kV2MaxK = (kWgSmemMax - WgV2::smem(0)) / (2 * WgV2::BN) / kWgBK * "
            "kWgBK;  // 1792") in PROBE_SRC


_V1_RULE = ("int v1_instance(int m, int n) {\n"
            "  if (n % 8 == 0 && m % 64 == 0) return kV1WgmmaV0;\n"
            "  if (n % 8 == 0 && m <= 32) return kV1WgmmaM32;\n"
            "  return m <= 32 ? kV1MmaNarrow : kV1MmaWide;\n"
            "}")
_V2_RULE = ("int v2_instance(int k, int n) {\n"
            "  (void)n;\n"
            "  return k >= kWgBK && k % kWgBK == 0 && k <= kV2MaxK ? kV2Wgmma : -1;\n"
            "}")


@pytest.mark.parametrize("m,n,want", [
    (256, 131072, "V0"), (256, 8192, "V0"), (256, 2120, "V0"), (64, 8, "V0"), (320, 16, "V0"),
    (32, 131072, "V1"), (32, 8192, "V1"), (32, 2120, "V1"), (32, 200, "V1"), (8, 16, "V1"),
    (1, 8, "V1"), (32, 77, "narrow"), (1, 1, "narrow"), (256, 77, "wide"), (63, 8, "wide"),
    (65, 8, "wide"), (33, 8, "wide"), (128, 1001, "wide")])
def test_v1_wgmma_rule_is_the_source(m, n, want):
    """``probe_v1_instance`` states the C rule ``v1_instance``, which
    ``hvc_probe_v1`` dispatches by and ``hvc_probe_v1_rule`` reports, with
    the source's instance codes: with N a multiple of 8 (16-byte rows for the
    tensor maps) whole m64 tiles take V0's wgmma instance and at most 32 rows
    V1's; a ragged N keeps the mma.sync instances (32 × 128 up to 32 rows,
    128 × 128 above)."""
    assert _V1_RULE in PROBE_SRC
    assert "  return run_v1(v1_instance(m, n), w, p, out, m, k, n, repeats, aligned," in PROBE_SRC
    assert "  return v1_instance(m, n);" in PROBE_SRC
    for name, code in (("kV1MmaNarrow", cp.V1_MMA_NARROW), ("kV1MmaWide", cp.V1_MMA_WIDE),
                       ("kV1WgmmaV0", cp.V1_WGMMA_V0), ("kV1WgmmaM32", cp.V1_WGMMA_M32)):
        assert f"  {name} = {code}," in PROBE_SRC
    for name, cfg in (("kV1WgmmaV0", "WgV0"), ("kV1WgmmaM32", "WgV1")):
        assert f"    case {name}: return gemm_wgmma<{cfg}>(w, p, out, m, n, k, repeats, s);" in PROBE_SRC
    codes = {"V0": cp.V1_WGMMA_V0, "V1": cp.V1_WGMMA_M32, "narrow": cp.V1_MMA_NARROW,
             "wide": cp.V1_MMA_WIDE}
    assert cp.probe_v1_instance(m, cp.K, n) == codes[want]
    assert (cp.WGMMA_M, cp.WGMMA_N_ALIGN, cp.WGMMA_M32) == (64, 8, 32)


@pytest.mark.parametrize("k,n", [(cp.K, 131072), (cp.K, 8192), (cp.K, 2120), (cp.K, 77), (cp.K, 1),
                                 (64, 200), (1792, 77), (1856, 8), (96, 8), (0, 8)])
def test_v2_wgmma_rule_is_the_source(k, n):
    """``probe_v2_instance`` states the C rule ``v2_instance``: every K (a
    multiple of 64) whose Wᵀ fits in shared memory beside the ring, at any N,
    takes the wgmma instance (WgV2, Wᵀ resident); a deeper or ragged K has
    none, and the wrapper refuses it before the card is reached."""
    assert _V2_RULE in PROBE_SRC
    assert "  return run_v2(v2_instance(k, n), pt, wt, out, k, n, repeats, " in PROBE_SRC
    assert "int hvc_probe_v2_rule(int k, int n) { return v2_instance(k, n); }" in PROBE_SRC
    assert "  kV2Wgmma = 1,          // WgV2: wt resident in shared memory" in PROBE_SRC
    assert "    case kV2Wgmma: return gemm_wgmma<WgV2>(pt, w, out, n, 32, k, repeats, s);" \
        in PROBE_SRC
    ok = k >= 64 and k % 64 == 0 and k <= 1792
    assert cp.probe_v2_instance(k, n) == (cp.V2_WGMMA if ok else -1)
    if k and not ok:
        p = torch.zeros((n, k), dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            cp.probe_v2(p, torch.zeros((k, cp.COUT), dtype=torch.bfloat16), 1)


def _walk(cfg: dict, m: int, n: int, repeats: int, grid: int):
    """The work items of probe_gemm_wgmma as its blocks walk them: block b
    takes items b, b + grid, …; item it is pass it / (tiles_m·tiles_n) and
    tile it % (tiles_m·tiles_n), N-major (m tile = tile % tiles_m)."""
    bm, bn = cfg["BM"], cfg["BN"]
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    per_pass = tiles_m * tiles_n
    line = "        const int m0 = int(tile % tiles_m) * BM, n0 = int(tile / tiles_m) * BN;"
    assert line in PROBE_SRC
    assert PROBE_SRC.count(line.strip()) == 2  # the producer and the consumers
    return [(it // per_pass, (it % per_pass) % tiles_m * bm, (it % per_pass) // tiles_m * bn, b)
            for b in range(grid) for it in range(b, repeats * per_pass, grid)]


@pytest.mark.parametrize("key,m,n,repeats,grid", [
    ("V0", 256, 131072, 64, 132), ("V0", 256, 2120, 3, 132), ("V0", 320, 4096, 2, 7),
    ("V0", 64, 200, 1, 132), ("V1", 32, 131072, 64, 132), ("V1", 32, 8192, 3, 132),
    ("V1", 32, 2120, 2, 5), ("V1", 8, 200, 1, 132), ("V2", 131072, 32, 64, 132),
    ("V2", 8192, 32, 3, 132), ("V2", 2120, 32, 2, 5), ("V2", 77, 32, 1, 132),
    ("V2s", 131072, 32, 2, 132), ("V3", 32, 131072, 64, 132), ("V3", 32, 8192, 3, 132),
    ("V3", 32, 2120, 2, 5), ("V3", 32, 8, 1, 132)])
def test_wgmma_walk_covers_every_pass_and_tile_once(key, m, n, repeats, grid):
    """Every (pass, m tile, n tile) is one work item of one block, a work item
    holds all the rows of its N tile where m ≤ BM (V0, V1, V3; V2's M is the
    spatial N, its N the 32 output channels: one N tile), and each block's
    items go in pass order, so every pass re-reads P and rewrites the whole
    output."""
    cfg = WG[key]
    bm, bn = cfg["BM"], cfg["BN"]
    assert _wg_const("kWgBK") == 64
    items = _walk(cfg, m, n, repeats, grid)
    keys = [(r, m0, n0) for r, m0, n0, _ in items]
    want = [(r, m0, n0) for r in range(repeats) for n0 in range(0, n, bn) for m0 in range(0, m, bm)]
    assert sorted(keys) == sorted(want) and len(set(keys)) == len(keys)
    if m <= bm:
        assert all(m0 == 0 for _, m0, _, _ in items)
    if n <= bn:
        assert all(n0 == 0 for _, _, n0, _ in items)
    for b in range(grid):
        passes = [r for r, _, _, blk in items if blk == b]
        assert passes == sorted(passes)


def _sw128(row: int, chunk: int) -> int:
    """sw128_offset (wgmma_sm90.cuh): byte offset of 16-byte chunk `chunk` of
    128-byte row `row` under the 128-byte swizzle."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


@pytest.mark.parametrize("key", ["V0", "V1", "V3", "V2", "V2s"])
def test_sw128_is_the_source_and_a_bijection(key):
    """The mirror states the C function, and on one ring stage (A: the item's
    rows of 128 bytes; B: 64-row MN-major boxes or the item's 32 K-major
    rows), one resident Wᵀ block and one epilogue box (64 rows of 32 fp32)
    every (row, chunk) lands on its own 16-byte slot of its row, the 8 rows of
    a chunk column in 8 different bank groups."""
    assert "  return row * 128u + ((chunk ^ (row & 7u)) << 4);" in WGMMA_SRC
    cfg = WG[key]
    b_rows = 64 if cfg["BMODE"] == 0 else cfg["BN"]
    for rows in (cfg["BM"], b_rows, 64):
        offs = [_sw128(r, c) for r in range(rows) for c in range(8)]
        assert sorted(offs) == list(range(0, rows * 128, 16))
        assert all(_sw128(r, c) // 128 == r for r in range(rows) for c in range(8))
        for r0 in range(0, rows, 8):
            for c in range(8):
                assert len({_sw128(r0 + i, c) % 128 for i in range(8)}) == 8
    assert cfg["ABytes"] == cfg["BM"] * 128 and cfg["StageBytes"] % 1024 == 0
    assert cfg["BBytes"] == {0: cfg["BN"] // 64 * 64 * 128, 1: cfg["BN"] * 128, 2: 0}[cfg["BMODE"]]


def _desc(addr: int, lbo: int, sbo: int) -> int:
    """wgmma_desc (wgmma_sm90.cuh): the 128-byte-swizzle matrix descriptor."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | (((sbo >> 4) & 0x3FFF) << 32) | (1 << 62))


def test_wgmma_descriptors_are_the_source():
    """The descriptor's fields (start address / 16 in bits 0-13, leading
    byte offset / 16 in 16-29, stride byte offset / 16 in 32-45, layout 1 =
    128-byte swizzle in 62-63) as wgmma_desc packs them, and the operands'
    strides: A, and a K-major B (V2), K-major (8-row groups 1,024 bytes
    apart, the leading offset unused, a k16 step 32 bytes along the swizzled
    row, n-block j WN rows on); an MN-major B (V0, V1) with its next
    64-column box a whole 64 × 128-byte box after the last (the leading
    offset), 8 k rows 1,024 bytes apart (the stride offset) and a k16 step of
    16 rows; V2's resident Wᵀ one block of BN K-major rows a chunk of K."""
    for line in ("  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |",
                 "         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |",
                 "         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | "
                 "(kDescLayoutSw128 << 62);",
                 "constexpr uint64_t kDescLayoutSw128 = 1;"):
        assert line in WGMMA_SRC
    sbo, lbo_b, lbo_a = _wg_const("kWgSbo"), _wg_const("kWgLboB"), _wg_const("kWgLboA")
    assert (sbo, lbo_b, lbo_a, _wg_const("kWgTile")) == (8 * 128, 64 * 128, 16, 64 * 128)
    for line in (
            "          const uint64_t da = wgmma_desc(a0 + i * kWgTile + kk * 32, kWgLboA, kWgSbo);",
            "              Cfg::TRANS_B ? wgmma_desc(b0 + j * (WN / kWgBox) * kWgTile + kk * 16 * "
            "128, kWgLboB, kWgSbo)",
            "                           : wgmma_desc(b0 + j * WN * 128 + kk * 32, kWgLboA, kWgSbo);",
            "      const uint32_t a0 = smem_u32(smem + s * Cfg::StageBytes) + wg * MT * kWgTile;",
            "                              ? smem_u32(bres + kc * (BN * 128))",
            "      *reinterpret_cast<uint4*>(bres + (k8 / 8) * (BN * 128) + sw128_offset(n, k8 % 8)) "
            "= v;",
            "  static constexpr int TRANS_B = BMODE == kBStreamMN;"):
        assert line in PROBE_SRC, line
    d = _desc(0x1C400 + 2048, lbo_b, sbo)
    assert d & 0x3FFF == (0x1C400 + 2048) >> 4
    assert (d >> 16) & 0x3FFF == 512 and (d >> 32) & 0x3FFF == 64 and d >> 62 == 1
    assert (d >> 49) & 0x7 == 0  # base offset: every stage starts 1024-byte aligned
    for cfg in WG.values():
        # every tile a descriptor starts at is 1024-byte aligned past the stage's base
        starts = [i * 64 * 128 for i in range(cfg["BM"] // 64)]
        if cfg["BMODE"] == 0:
            starts += [cfg["ABytes"] + j * (cfg["WN"] // 64) * 64 * 128 for j in range(cfg["NT"])]
        elif cfg["BMODE"] == 1:
            starts += [cfg["ABytes"] + j * cfg["WN"] * 128 for j in range(cfg["NT"])]
        else:
            starts += [kc * cfg["BN"] * 128 for kc in range(cp.K // 64)]  # the resident blocks
        assert all(a % 1024 == 0 for a in starts)


def _resident_wt(k: int, bn: int) -> dict:
    """Where the kernel's transposing copy puts Wᵀ[k][n] (a K × BN row-major
    array) in shared memory: thread item c is column n = c % BN of the 8 k
    rows 8·(c / BN) …, one 16-byte chunk of row n of K block k8 / 8."""
    where = {}
    for c in range(k // 8 * bn):
        n, k8 = c % bn, c // bn
        base = k8 // 8 * (bn * 128) + _sw128(n, k8 % 8)
        for e in range(8):
            where[(k8 * 8 + e, n)] = base + 2 * e
    return where


def test_v2_resident_wt_is_k_major_and_swizzled():
    """The copy of Wᵀ into shared memory at the block's start writes every
    element once, as K-major rows of 64 k (row n of K block kb holds Wᵀ[64kb
    … 64kb + 63][n]) in the 128-byte swizzle the descriptors read, in K /
    64·BN·128 = 110,592 bytes at K = 1728, its global reads a warp's 32
    neighbouring columns of one row."""
    for line in ("    for (int c = tid; c < (K / 8) * BN; c += Cfg::Threads) {",
                 "      const int n = c % BN, k8 = c / BN;",
                 "      const unsigned short* e = src + (long long)k8 * 8 * BN + n;",
                 "      v.x = e[0] | (uint32_t(e[BN]) << 16);",
                 "      v.w = e[6 * BN] | (uint32_t(e[7 * BN]) << 16);",
                 "    fence_proxy_async_shared();  // the products read it through the async proxy"):
        assert line in PROBE_SRC, line
    bn = WG["V2"]["BN"]
    where = _resident_wt(cp.K, bn)
    assert len(where) == cp.K * bn and sorted(where.values()) == list(range(0, cp.K * bn * 2, 2))
    for (k, n), off in where.items():
        kb, kin = divmod(k, 64)
        assert off == kb * bn * 128 + _sw128(n, kin // 8) + 2 * (kin % 8)
    for c0 in range(0, 64, 32):  # a warp's first loads: one row of Wᵀ, 32 columns
        assert [(c % bn, c // bn) for c in range(c0, c0 + 32)] == [(n, c0 // bn) for n in range(32)]


@pytest.mark.parametrize("key", ["V0", "V1", "V3", "V2"])
def test_wgmma_epilogue_fills_each_store_box_once(key):
    """A consumer warpgroup's float2 writes of one epilogue round (rows 16·warp
    + lane / 4 + 8·(jj % 4 / 2), columns 8·(jj / 4) + 2·(lane % 4) of a 64 × 32
    fp32 box, at sw128_offset(row, column / 4) + 8·(lane % 2)) cover every
    8-byte slot of the box once, each warp's store of one jj hits every bank
    the same number of times (no conflict beyond the two wavefronts of 256
    bytes), and the rounds of a consumer store each 64 × 32 box of its tiles
    once (V1's rows 32-63 fall outside the output and are clipped by the
    store)."""
    cols = _wg_const("kWgOutBox")
    assert cols == 32 and _wg_const("kWgOutBytes") == 64 * 32 * 4
    assert ("          *reinterpret_cast<float2*>(out + sw128_offset(row, c / 4) + (lane % 2) * 8) ="
            in PROBE_SRC)
    slots = []
    for warp, lane, jj in ((w, ln, j) for w in range(4) for ln in range(32)
                           for j in range(0, cols // 2, 2)):
        row = 16 * warp + lane // 4 + 8 * ((jj % 4) // 2)
        c = 8 * (jj // 4) + 2 * (lane % 4)
        slots.append(_sw128(row, c // 4) + (lane % 2) * 8)
    assert sorted(slots) == list(range(0, 64 * 32 * 4, 8))
    for warp, jj in ((w, j) for w in range(4) for j in range(0, cols // 2, 2)):
        banks = [((_sw128(16 * warp + ln // 4 + 8 * ((jj % 4) // 2), (8 * (jj // 4) + 2 * (ln % 4))
                          // 4) + (ln % 2) * 8) // 4 + k) % 32 for ln in range(32) for k in range(2)]
        assert sorted(banks) == sorted(list(range(32)) * 2)
    assert ("          tma_store_2d(&map_c, out, n0 + (t % NT) * WN + h * kWgOutBox,\n"
            "                       m0 + (wg * MT + t / NT) * 64);") in PROBE_SRC
    cfg = WG[key]
    boxes = [(n0, m0) for wg in range(cfg["CONS"]) for t in range(cfg["MT"] * cfg["NT"])
             for h in range(cfg["WN"] // cols)
             for n0, m0 in [((t % cfg["NT"]) * cfg["WN"] + h * cols, (wg * cfg["MT"] + t // cfg["NT"]) * 64)]]
    want = [(n0, m0) for m0 in range(0, cfg["BM"], 64) for n0 in range(0, cfg["BN"], cols)]
    assert sorted(boxes) == sorted(want) and len(set(boxes)) == len(boxes)
    # a thread's accumulators: MT·NT tiles of WN / 2, the round's q = 16h + jj
    assert "  float acc[MT * NT][WN / 2];" in PROBE_SRC
    qs = sorted(h * cols // 2 + jj + e for h in range(cfg["WN"] // cols)
                for jj in range(0, cols // 2, 2) for e in range(2))
    assert qs == list(range(cfg["WN"] // 2))


@pytest.mark.parametrize("key,n,want", [
    ("V1", 131072, "conv_probe_v1_wgmma_m32"), ("V1", 2120, "conv_probe_v1_wgmma_m32"),
    ("V1", 77, None), ("V0", 131072, "conv_probe_v1_wgmma"), ("V0", 2120, "conv_probe_v1_wgmma"),
    ("V0", 77, None), ("V2", 131072, "conv_probe_v2_wgmma"), ("V2", 77, "conv_probe_v2_wgmma"),
    ("V3", 131072, "conv_probe_v3_wgmma"), ("V3", 2120, "conv_probe_v3_wgmma"), ("V3", 77, None),
    ("V8", 131072, None)])
def test_chip_smoke_probe_instances(key, n, want):
    """chip_smoke.py [12] holds each V1 / V0 / V2 / V3 call to the wgmma
    counter of the instance the wrapper's rule names at that N (V1 and V3 at
    77 on mma.sync), and every counter it reads exists in ``LAUNCHES``."""
    import chip_smoke

    assert chip_smoke._probe_instance_counter(key, n) == want
    assert set(chip_smoke._PROBE_INSTANCE_COUNTERS) <= set(cp.LAUNCHES)
    assert chip_smoke.PROBE_RAGGED_N == (77, 2120)


_V3_RULE = "int v3_instance(int n) { return n % 8 == 0 ? kV3Wgmma : kV3Mma; }"


@pytest.mark.parametrize("n", [131072, 8192, 2120, 77, 8, 1])
def test_v3_wgmma_rule_is_the_source(n):
    """``probe_v3_instance`` states the C rule ``v3_instance``, which
    ``hvc_probe_v3`` dispatches by and ``hvc_probe_v3_rule`` reports, with the
    source's instance codes: N a multiple of 8 (16-byte rows of P and the
    output for the tensor maps) takes WgV3, a ragged N the 32 × 128 mma.sync
    tiles."""
    assert _V3_RULE in PROBE_SRC
    assert "  return run_v3(v3_instance(n), w27, p, out, n, repeats, aligned," in PROBE_SRC
    assert "int hvc_probe_v3_rule(int n) { return v3_instance(n); }" in PROBE_SRC
    for name, code in (("kV3Mma", cp.V3_MMA), ("kV3Wgmma", cp.V3_WGMMA)):
        assert f"  {name} = {code}," in PROBE_SRC
    assert ("    case kV3Wgmma: return gemm_wgmma<WgV3>(w27, p, out, kGroup, n, 27 * kWgBK, "
            "repeats, s);") in PROBE_SRC
    assert cp.probe_v3_instance(n) == (cp.V3_WGMMA if n % 8 == 0 else cp.V3_MMA)
    assert cp._INSTANCE_COUNTERS[("v3", cp.V3_WGMMA)] == "conv_probe_v3_wgmma"


def _v3_a_boxes(w27: torch.Tensor, bm: int) -> list:
    """The A box the producer loads for each K chunk of WgV3: the bm rows of
    the tensor map over W27 ((K / 64)·32 rows × 64) from row 32·kc (m0 = 0),
    rows past the map's last read as zeros (TMA's out-of-bounds fill)."""
    rows = w27.shape[0]
    boxes = []
    for kc in range(rows // cp.COUT):
        box = torch.zeros((bm, cp.CIN), dtype=w27.dtype)
        lo, hi = kc * cp.COUT, min(kc * cp.COUT + bm, rows)
        box[:hi - lo] = w27[lo:hi]
        boxes.append(box)
    return boxes


def test_v3_tap_major_a_boxes():
    """WgV3's producer loads K chunk t's A box at (column 0, row 32t) of a map
    over W27 (864 × 64): W27 rows 32t … 32t + 63, tap t + 1's rows in the
    box's lower half and zeros past row 863 (t = 26). The products of the
    lower half land in accumulator rows 32-63, which the output's tensor map
    (M = 32 rows) clips: replaying the per-chunk products, the kept rows
    0-31 equal V3's plain version (both fp32 sums of the same bf16
    products), and rows 32-63 hold the shifted taps' sums, not V3."""
    for line in ("          if constexpr (Cfg::TAP_A)",
                 "            tma_load_2d(st, &map_a, &full[s], 0, kc * kGroup + m0);  // tap kc's "
                 "rows, then kc + 1's",
                 "  const long long a_rows = Cfg::TAP_A ? (long long)(K / kWgBK) * kGroup : M;",
                 "  if (!tensor_map(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, a_rows, "
                 "Cfg::TAP_A ? kWgBK : K,",
                 "      !tensor_map(&mc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, c, M, Nc, 64, "
                 "kWgOutBox))",
                 "      (Cfg::TAP_A && M > kGroup) || reinterpret_cast<uintptr_t>(a) % 16 ||"):
        assert line in PROBE_SRC, line
    rng = np.random.default_rng(81)
    w27 = torch.from_numpy(rng.standard_normal((cp.TAPS * cp.COUT, cp.CIN), dtype=np.float32))
    p = torch.from_numpy(rng.standard_normal((cp.K, 40), dtype=np.float32))
    w27, p = w27.bfloat16(), p.bfloat16()
    boxes = _v3_a_boxes(w27, WG["V3"]["BM"])
    assert len(boxes) == cp.K // 64 == cp.TAPS
    for t, box in enumerate(boxes):
        assert torch.equal(box[:32], w27[32 * t:32 * t + 32])
        assert torch.equal(box[32:], w27[32 * t + 32:32 * t + 64]) if t < 26 else \
            not box[32:].any()
    acc = sum(box.float() @ p[64 * t:64 * t + 64].float() for t, box in enumerate(boxes))
    want = cp.probe_v3_plain(w27, p, 1)
    kept = acc[:cp.COUT]  # the store box's rows inside the output
    assert (kept - want).abs().max() <= 1e-4 * want.abs().max()
    assert (acc[cp.COUT:] - want).abs().max() > 1e-2 * want.abs().max()
