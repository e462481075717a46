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
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hybrid_vit_cascade_tpu_torch.ops.cuda import conv_probe as cp
from hybrid_vit_cascade_tpu_torch.scripts import bench_conv_probe as bench
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
    # V8 moves X3 and its output, 67.2 MB a pass, past the 50 MiB L2; V5's
    # 48.1 MiB stays in it
    assert math.isclose(floors["V8"], 1.284, rel_tol=1e-3)
    assert bench.L2_BYTES == 50 * 2**20
    assert math.isclose(bench.nbytes(bench.BY_KEY["V5"], bench.N_TOTAL) / 2**20, 48.1,
                        rel_tol=1e-3)
    assert {k for k, f in floors.items() if f is not None} == {"V1", "V0", "V2", "V3", "V8"}
    assert floors["V5"] is None and floors["V3'"] is None and floors["VX"] is None


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
    names = {n: _wg_const(n) for n in re.findall(r"\bk[A-Z]\w*", expr)}
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


def _tap_cfg(name: str) -> dict:
    """The WgTapCfg of instance `name` (WgV4, WgV5, WgV8) of
    probe_tapsum_wgmma, its derived sizes computed as the struct computes them
    (BM: the 32 output rows a work item stores; BN: one n128 block)."""
    taps, chunks, cons, spc, outb = map(int, re.search(
        rf"^using {name} = WgTapCfg<(\d+), (\d+), (\d+), (\d+), (\d+)>;", PROBE_SRC,
        re.M).groups())
    tiles = (taps + 1) // 2
    bn = 128
    stage = bn * 128
    wbytes = tiles * chunks * _wg_const("kWgTile")
    smem = (1024 + wbytes + cons * spc * stage + cons * outb * _wg_const("kTapOutBytes")
            + 2 * cons * spc * 8)
    return {"TAP": True, "name": name, "TAPS": taps, "CHUNKS": chunks, "TILES": tiles,
            "KD": 64 * chunks, "CONS": cons, "SPC": spc, "OUTB": outb, "STAGES": cons * spc,
            "BM": cp.COUT, "BN": bn, "WN": 128, "WBytes": wbytes, "StageBytes": stage,
            "smem": smem}


def _tap_instance(key: str) -> str:
    """The WgTapCfg that the wgmma instance of probe `key` (V4, V6, V5, V8)
    launches, from its dispatch line."""
    v = key[1:]
    return re.search(rf"^    case kV{v}Wgmma: return tapsum_wgmma<(\w+)>\(", PROBE_SRC,
                     re.M).group(1)


# each wgmma tap-sum probe's instance (V6 on V4's)
WG_TAP = {key: _tap_cfg(_tap_instance(key)) for key in ("V4", "V6", "V5", "V8")}


def _pertap_cfg() -> dict:
    """WgV3p, the configuration of probe_pertap_wgmma (V3'), its derived
    sizes computed as the struct computes them (BM: the 32 output rows; BN:
    MT m64 tiles of 64 columns a work item)."""
    mt, cons, spc = map(int, re.search(
        r"^struct WgV3p \{\n  static constexpr int MT = (\d+), CONS = (\d+), SPC = (\d+);",
        PROBE_SRC, re.M).groups())
    bn = 64 * mt
    wbytes = 27 * cp.COUT * 128
    smem = 1024 + wbytes + cons * spc * bn * 128 + 2 * cons * spc * 8
    return {"TAP": True, "PERTAP": True, "MT": mt, "CONS": cons, "SPC": spc,
            "OUTB": 0, "STAGES": cons * spc, "BM": cp.COUT, "BN": bn, "WBytes": wbytes,
            "StageBytes": bn * 128, "smem": smem}


WG_PERTAP = {"V3'": _pertap_cfg()}


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
    # the tap-sum instances of probe_tapsum_wgmma: W resident (TILES m64
    # tiles of two taps × CHUNKS k64 boxes), two consumers on rings of their
    # own, a ring stage one k64 chunk of a 128-column work item, one chain;
    # V6 on V4's instance
    for line in ("  static constexpr int BN = 128;                     // columns of a work item",
                 "  static constexpr int KD = CHUNKS * kWgBK;          // a tap's K: W's row, X's rows",
                 "  static constexpr int WBytes = TILES * CHUNKS * kWgTile;  // resident W: box (i, kc) "
                 "[64][64 k]",
                 "  static constexpr int StageBytes = BN * 128;        // a chunk of X: BN / 64 boxes "
                 "[64 k][64 n]",
                 "  static constexpr int Threads = (CONS + 1) * 128;",
                 "  static constexpr int Smem = 1024 + WBytes + CONS * SPC * StageBytes +",
                 "                              CONS * OUTB * kTapOutBytes + 2 * CONS * SPC * 8;",
                 "  static constexpr int TILES = (TAPS + 1) / 2;       // m64 tiles of two taps",
                 "  static_assert(OUTB >= 0 && OUTB <= 2 &&",
                 "                    (CONS * kTapConsumerRegs + kTapProducerRegs) * 128 <= 65536,",
                 '  static_assert(Smem <= kWgSmemMax, "the card\'s shared memory");'):
        assert line in PROBE_SRC, line
    tap = {k: (c["name"], c["TAPS"], c["CHUNKS"], c["TILES"], c["CONS"], c["SPC"], c["OUTB"])
           for k, c in WG_TAP.items()}
    assert tap == {"V4": ("WgV4", 27, 1, 14, 2, 3, 2), "V6": ("WgV4", 27, 1, 14, 2, 3, 2),
                   "V5": ("WgV5", 14, 2, 7, 2, 3, 0), "V8": ("WgV8", 9, 3, 5, 2, 3, 0)}
    for key, c in WG_TAP.items():  # each probe's W and X as the config reads them
        case = bench.BY_KEY[key[:2]]
        assert c["TILES"] == -(-c["TAPS"] // 2) and case.x_rows == c["KD"] == case.w_shape[1]
        assert case.w_shape[0] >= c["TAPS"] * cp.COUT
        assert case.kd == c["TAPS"] * c["KD"]
    assert {k: c["WBytes"] for k, c in WG_TAP.items()} == {
        "V4": 114688, "V6": 114688, "V5": 114688, "V8": 122880}
    tap_smem = {k: c["smem"] for k, c in WG_TAP.items()}
    assert tap_smem == {"V4": 230496, "V6": 230496, "V5": 214112, "V8": 222304}
    assert max(tap_smem.values()) <= 232448
    # V8 with V4's two store boxes and three stages a consumer would not fit
    v8 = WG_TAP["V8"]
    assert v8["smem"] + 2 * v8["CONS"] * _wg_const("kTapOutBytes") == 238688 > 232448
    assert _wg_const("kTapOutBytes") == 4096 and _wg_const("kWgTile") == 8192
    # the store boxes serve V4 and V6, the stores from registers V5 and V8
    assert {k: c["OUTB"] for k, c in WG_TAP.items()} == {"V4": 2, "V6": 2, "V5": 0, "V8": 0}
    # registers: two consumers at 232 and the producer at 40 share the SM's
    # 65,536; a consumer's one chain of 64 accumulators fits in its 232
    regs = (_wg_const("kTapProducerRegs"), _wg_const("kTapConsumerRegs"))
    assert regs == (40, 232) and (2 * regs[1] + regs[0]) * 128 <= 65536
    for line in ("    float acc[64];", "    setmaxnreg_dec<kTapProducerRegs>();",
                 "    setmaxnreg_inc<kTapConsumerRegs>();"):
        assert line in PROBE_SRC, line
    for old in ("ACCS", "WgV6", "kTapTiles", "kTaps"):  # V6 serves on V4's instance
        assert not re.search(rf"\b{old}\b", PROBE_SRC), old


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
    tile it % (tiles_m·tiles_n), N-major (m tile = tile % tiles_m).
    probe_tapsum_wgmma (one M tile: all 32 output rows) walks the same way."""
    bm, bn = cfg["BM"], cfg["BN"]
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    per_pass = tiles_m * tiles_n
    if cfg.get("TAP"):
        for line in ("        const int n0 = int(it % per_pass) * BN;",  # the producer
                     "      const int n0 = int(it % per_pass) * BN;"):  # the consumers
            assert line in PROBE_SRC
        return [(it // per_pass, 0, it % per_pass * bn, b)
                for b in range(grid) for it in range(b, repeats * per_pass, grid)]
    line = "        const int m0 = int(tile % tiles_m) * BM, n0 = int(tile / tiles_m) * BN;"
    assert line in PROBE_SRC
    assert PROBE_SRC.count(line.strip()) == 2  # the producer and the consumers
    return [(it // per_pass, (it % per_pass) % tiles_m * bm, (it % per_pass) // tiles_m * bn, b)
            for b in range(grid) for it in range(b, repeats * per_pass, grid)]


def _tap_ring(cfg: dict, uses: int) -> list:
    """(consumer, stage, phase) of the chunks of a block's items li = 0 …
    uses - 1 in probe_tapsum_wgmma, in the producer's order: item li goes to
    consumer li % CONS, its chunk kc is that consumer's chunk = li / CONS ·
    CHUNKS + kc, into stage consumer·SPC + chunk % SPC, at phase chunk / SPC
    % 2 (the producer's and the consumer's expressions)."""
    for line in ("          const long long chunk = li / CONS * CHUNKS + kc;  // the consumer's own "
                 "chunk count",
                 "          const int s = int(li % CONS) * SPC + int(chunk % SPC);",
                 "          mbar_wait(&empty[s], uint32_t(chunk / SPC & 1) ^ 1);  // its consumer "
                 "freed it (free at first)",
                 "            tma_load_2d(st + b * kWgTile, &map_x, &full[s], n0 + b * kWgBox, "
                 "kc * kWgBK);",
                 "    for (long long it = blockIdx.x + (long long)wg * gridDim.x; it < items;",
                 "         it += (long long)CONS * gridDim.x) {",
                 "      for (int kc = 0; kc < CHUNKS; ++kc, ++chunk) {",
                 "        const int s = wg * SPC + int(chunk % SPC);",
                 "        mbar_wait(&full[s], uint32_t(chunk / SPC & 1));"):
        assert line in PROBE_SRC, line
    cons, spc, chunks = cfg["CONS"], cfg["SPC"], cfg["CHUNKS"]
    return [(li % cons, li % cons * spc + ch % spc, ch // spc % 2)
            for li in range(uses) for ch in (li // cons * chunks + kc for kc in range(chunks))]


@pytest.mark.parametrize("key,m,n,repeats,grid", [
    ("V0", 256, 131072, 64, 132), ("V0", 256, 2120, 3, 132), ("V0", 320, 4096, 2, 7),
    ("V0", 64, 200, 1, 132), ("V1", 32, 131072, 64, 132), ("V1", 32, 8192, 3, 132),
    ("V1", 32, 2120, 2, 5), ("V1", 8, 200, 1, 132), ("V2", 131072, 32, 64, 132),
    ("V2", 8192, 32, 3, 132), ("V2", 2120, 32, 2, 5), ("V2", 77, 32, 1, 132),
    ("V2s", 131072, 32, 2, 132), ("V3", 32, 131072, 64, 132), ("V3", 32, 8192, 3, 132),
    ("V3", 32, 2120, 2, 5), ("V3", 32, 8, 1, 132), ("V4", 32, 131072, 64, 132),
    ("V4", 32, 2120, 2, 5), ("V4", 32, 8, 3, 132), ("V6", 32, 131072, 64, 132),
    ("V6", 32, 8192, 3, 7), ("V6", 32, 2120, 2, 5), ("V5", 32, 131072, 64, 132),
    ("V5", 32, 2120, 2, 5), ("V5", 32, 8, 3, 132), ("V8", 32, 131072, 64, 132),
    ("V8", 32, 8192, 3, 7), ("V8", 32, 2120, 2, 5), ("V3'", 32, 131072, 64, 132),
    ("V3'", 32, 8200, 3, 132), ("V3'", 32, 2120, 2, 5), ("V3'", 32, 8, 1, 132)])
def test_wgmma_walk_covers_every_pass_and_tile_once(key, m, n, repeats, grid):
    """Every (pass, m tile, n tile) is one work item of one block, a work item
    holds all the rows of its N tile where m ≤ BM (V0, V1, V3 and the tap
    sums; V2's M is the spatial N, its N the 32 output channels: one N tile),
    and each block's items go in pass order, so every pass re-reads P (X) and
    rewrites the whole output. The tap sums' (V4, V6, V5, V8) two consumers
    take alternate items of the block, each from ring stages of its own, a
    stage one k64 chunk of an item, so a stage's phases follow its one
    consumer's chunks in order; V3' likewise, a stage one whole item."""
    cfg = {**WG, **WG_TAP, **WG_PERTAP}[key]
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
    by_block = {}
    for r, _, _, blk in items:
        by_block.setdefault(blk, []).append(r)
    for passes in by_block.values():
        assert passes == sorted(passes)
    if cfg.get("TAP"):
        uses = max(len(passes) for passes in by_block.values())
        ring = _pertap_ring(cfg, uses) if cfg.get("PERTAP") else _tap_ring(cfg, uses)
        for stage in range(cfg["STAGES"]):
            seq = [(c, ph) for c, st, ph in ring if st == stage]
            assert {c for c, _ in seq} <= {stage // cfg["SPC"]}  # one consumer's stage
            assert [ph for _, ph in seq] == [k % 2 for k in range(len(seq))]
        for c in range(cfg["CONS"]):  # a consumer's stages in rotation
            stages = [st for cc, st, _ in ring if cc == c]
            assert stages == [c * cfg["SPC"] + k % cfg["SPC"] for k in range(len(stages))]
        assert (_pertap_pipeline_drains if cfg.get("PERTAP") else _tap_pipeline_drains)(cfg, ring)


def _tap_pipeline_drains(cfg: dict, ring: list) -> bool:
    """Plays the producer and the consumers of probe_tapsum_wgmma over the
    chunks of `ring` (producer order): the producer fills a stage once its
    consumer has freed the last fill; a consumer takes its chunks in order
    once filled, and on issuing chunk kc > 0 frees the stage of chunk kc - 1
    (wgmma_wait<1>), on the item's last chunk its own too (wgmma_wait<0>).
    True when every chunk is filled and taken: no wait is left hanging, also
    with fewer stages than an item has chunks."""
    for line in ("        if (kc > 0) {",
                 "          wgmma_wait<1>();  // the chunk before is done: free its stage for the "
                 "producer",
                 "          if (lt == 0) mbar_arrive(&empty[prev]);",
                 "      wgmma_wait<0>();  // the item's products are done: free its last stage"):
        assert line in PROBE_SRC, line
    chunks = cfg["CHUNKS"]
    fills, frees = {}, {}
    per_cons = {}
    for c, st, _ in ring:
        per_cons.setdefault(c, []).append(st)
    pos = {c: 0 for c in per_cons}
    taken = {c: {} for c in per_cons}  # the consumer's uses of each stage so far
    j = 0
    moved = True
    while moved:
        moved = False
        if j < len(ring) and fills.get(ring[j][1], 0) == frees.get(ring[j][1], 0):
            fills[ring[j][1]] = fills.get(ring[j][1], 0) + 1
            j, moved = j + 1, True
        for c, seq in per_cons.items():
            p = pos[c]
            if p < len(seq) and fills.get(seq[p], 0) > taken[c].get(seq[p], 0):
                taken[c][seq[p]] = taken[c].get(seq[p], 0) + 1
                kc = p % chunks
                if kc > 0:
                    frees[seq[p - 1]] = frees.get(seq[p - 1], 0) + 1
                if kc == chunks - 1:
                    frees[seq[p]] = frees.get(seq[p], 0) + 1
                pos[c], moved = p + 1, True
    return j == len(ring) and all(pos[c] == len(seq) for c, seq in per_cons.items())


def _sw128(row: int, chunk: int) -> int:
    """sw128_offset (wgmma_sm90.cuh): byte offset of 16-byte chunk `chunk` of
    128-byte row `row` under the 128-byte swizzle."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


@pytest.mark.parametrize("key", ["V0", "V1", "V3", "V2", "V2s", "V4", "V6", "V5", "V8", "V3'"])
def test_sw128_is_the_source_and_a_bijection(key):
    """The mirror states the C function, and on one ring stage (A: the item's
    rows of 128 bytes; B: 64-row MN-major boxes or the item's 32 K-major
    rows), one resident Wᵀ block and one epilogue box (64 rows of 32 fp32)
    every (row, chunk) lands on its own 16-byte slot of its row, the 8 rows of
    a chunk column in 8 different bank groups; for the tap sums (V4, V6, V5,
    V8) on one resident box of W (64 rows × 64 k), one 64-row box of X and
    (V4, V6) one 32-row store box; for V3' on a tap's resident B (32 rows ×
    64 k) and one 64-row box of X."""
    assert "  return row * 128u + ((chunk ^ (row & 7u)) << 4);" in WGMMA_SRC
    cfg = {**WG, **WG_TAP, **WG_PERTAP}[key]
    if cfg.get("TAP"):
        assert cfg["StageBytes"] == cfg["BN"] // 64 * 64 * 128 and cfg["StageBytes"] % 1024 == 0
        row_sets = (64, 64, cp.COUT) if cfg["OUTB"] else (64, 64)
        if cfg.get("PERTAP"):
            row_sets = (cp.COUT, 64)
    else:
        row_sets = (cfg["BM"], 64 if cfg["BMODE"] == 0 else cfg["BN"], 64)
    for rows in row_sets:
        offs = [_sw128(r, c) for r in range(rows) for c in range(8)]
        assert sorted(offs) == list(range(0, rows * 128, 16))
        assert all(_sw128(r, c) // 128 == r for r in range(rows) for c in range(8))
        for r0 in range(0, rows, 8):
            for c in range(8):
                assert len({_sw128(r0 + i, c) % 128 for i in range(8)}) == 8
    if cfg.get("TAP"):
        return
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
    # probe_tapsum_wgmma: A the resident box (tile i, chunk kc) of W (K-major,
    # k16 steps 32 bytes along its rows), B the chunk's stage (MN-major, two
    # 64-column boxes); its resident boxes, stages and store boxes all start
    # 1024-byte aligned after the aligned base
    for line in ("                wgmma_desc(w0 + (i * CHUNKS + kc) * kWgTile + kk * 32, kWgLboA, "
                 "kWgSbo);",
                 "            const uint64_t db = wgmma_desc(x0 + kk * 16 * 128, kWgLboB, kWgSbo);",
                 "            wgmma_m64n128k16<1>(acc, da, db, kc > 0 || i > 0 || kk > 0);",
                 "  unsigned char* ring = wres + Cfg::WBytes;                    // consumer c's "
                 "stages c·SPC …",
                 "  unsigned char* outs = ring + CONS * SPC * Cfg::StageBytes;   // OUTB store boxes "
                 "a consumer",
                 "    unsigned char* out = outs + wg * OUTB * kTapOutBytes;",
                 "        unsigned char* box = out + (stores % OUTB) * kTapOutBytes;"):
        assert line in PROBE_SRC, line
    for cfg in WG_TAP.values():
        tiles = [b * 64 * 128 for b in range(cfg["TILES"] * cfg["CHUNKS"])]
        ring0 = cfg["WBytes"]
        stages = [ring0 + s * cfg["StageBytes"] for s in range(cfg["STAGES"])]
        outs0 = ring0 + cfg["STAGES"] * cfg["StageBytes"]
        boxes = [outs0 + b * _wg_const("kTapOutBytes") for b in range(cfg["OUTB"] * cfg["CONS"])]
        assert all(a % 1024 == 0 for a in tiles + stages + boxes)
        # the chain's first product is (kc, i, kk) = (0, 0, 0): every later one adds
        firsts = [(kc, i, kk) for kc in range(cfg["CHUNKS"]) for i in range(cfg["TILES"])
                  for kk in range(4) if not (kc > 0 or i > 0 or kk > 0)]
        assert firsts == [(0, 0, 0)]


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


def _tap_epilogue(cfg: dict) -> None:
    """probe_tapsum_wgmma's epilogue: a round's float2 writes (output row
    8·warp + lane / 4, columns 8·cb + 2·(lane % 4) of a 32 × 32 fp32 box, at
    sw128_offset(row, column / 4) + 8·(lane % 2)) cover every 8-byte slot of
    the box once, each warp's store of one cb hits every bank the same number
    of times, the rounds of an item store each 32-column box of its BN once,
    the accumulators q … q + 3 they fold (q = 4·(4h + cb)) are each of a
    thread's 64 once, and a round's box (stores % OUTB) is the one the store
    OUTB rounds back used, no store since, so waiting until at most OUTB - 1
    stores still read leaves that one read."""
    if cfg["OUTB"] == 0:
        return _tap_direct_epilogue(cfg)
    for line in ("            const int q = 4 * (h * kWgOutBox / 8 + cb);",
                 "            const int c = 8 * cb + 2 * (lane % 4);",
                 "            *reinterpret_cast<float2*>(box + sw128_offset(8 * warp + lane / 4, c / 4) +",
                 "                                       (lane % 2) * 8) =",
                 "                make_float2(acc[q] + acc[q + 2], acc[q + 1] + acc[q + 3]);",
                 "            tma_store_2d(&map_c, box, n0 + h * kWgOutBox, 0);",
                 "        for (int h = 0; h < BN / kWgOutBox; ++h) {  // columns 32·h …",
                 "          if (lt == 0) tma_store_wait_read<OUTB - 1>();  // the store OUTB before has "
                 "read this box",
                 "      } else {"):
        assert line in PROBE_SRC, line
    cols = _wg_const("kWgOutBox")
    slots = [_sw128(8 * warp + lane // 4, (8 * cb + 2 * (lane % 4)) // 4) + (lane % 2) * 8
             for warp in range(4) for lane in range(32) for cb in range(cols // 8)]
    assert sorted(slots) == list(range(0, _wg_const("kTapOutBytes"), 8))
    for warp, cb in ((w, c) for w in range(4) for c in range(cols // 8)):
        banks = [((_sw128(8 * warp + ln // 4, (8 * cb + 2 * (ln % 4)) // 4) + (ln % 2) * 8) // 4 + k)
                 % 32 for ln in range(32) for k in range(2)]
        assert sorted(banks) == sorted(list(range(32)) * 2)
    boxes = [h * cols for h in range(cfg["BN"] // cols)]
    assert sorted(boxes) == list(range(0, cfg["BN"], cols))
    qs = sorted(4 * (h * cols // 8 + cb) + e for h in range(cfg["BN"] // cols)
                for cb in range(cols // 8) for e in range(4))
    assert qs == list(range(64))
    outb = cfg["OUTB"]
    used = [k % outb for k in range(3 * cfg["BN"] // cols)]  # three items' rounds
    for k in range(outb, len(used)):
        assert used[k] == used[k - outb] and used[k] not in used[k - outb + 1:k]


def _tap_direct_epilogue(cfg: dict) -> None:
    """probe_tapsum_wgmma's epilogue with no store box (OUTB = 0): thread
    (warp, lane) stores e0 + e2 and e1 + e3 of column block j as one float2
    at output row 8·warp + lane / 4, column n0 + 8j + 2·(lane % 4); over a
    work item every output element of its 32 rows × BN columns is written
    once, from accumulators 4j … 4j + 3 that are each of a thread's 64 once,
    and one warp's store of one j covers whole 32-byte sectors (4 lanes on 8
    neighbouring columns of each of 8 rows); stores past N are masked."""
    for line in ("      if constexpr (OUTB == 0) {",
                 "        const int col = n0 + 2 * (lane % 4);",
                 "        float* row = dst + (long long)(8 * warp + lane / 4) * N + col;",
                 "        for (int j = 0; j < BN / 8; ++j)",
                 "          if (col + 8 * j < N)",
                 "            *reinterpret_cast<float2*>(row + 8 * j) =",
                 "                make_float2(acc[4 * j] + acc[4 * j + 2], acc[4 * j + 1] + "
                 "acc[4 * j + 3]);"):
        assert line in PROBE_SRC, line
    bn = cfg["BN"]
    cells = [(8 * warp + lane // 4, 8 * j + 2 * (lane % 4) + e)
             for warp in range(4) for lane in range(32) for j in range(bn // 8) for e in (0, 1)]
    assert sorted(cells) == [(r, col) for r in range(cp.COUT) for col in range(bn)]
    assert sorted(4 * j + e for j in range(bn // 8) for e in range(4)) == list(range(64))
    for warp, j in ((w, jj) for w in range(4) for jj in range(bn // 8)):
        byte = [(8 * warp + ln // 4) * 4 * bn + 4 * (8 * j + 2 * (ln % 4)) for ln in range(32)]
        sectors = {}
        for b in byte:
            sectors.setdefault(b // 32, set()).update({b, b + 4})
        assert all(len(v) == 8 for v in sectors.values()) and len(sectors) == 8


@pytest.mark.parametrize("key", ["V0", "V1", "V3", "V2", "V4", "V6", "V5", "V8", "V3'"])
def test_wgmma_epilogue_fills_each_store_box_once(key):
    """A consumer warpgroup's float2 writes of one epilogue round (rows 16·warp
    + lane / 4 + 8·(jj % 4 / 2), columns 8·(jj / 4) + 2·(lane % 4) of a 64 × 32
    fp32 box, at sw128_offset(row, column / 4) + 8·(lane % 2)) cover every
    8-byte slot of the box once, each warp's store of one jj hits every bank
    the same number of times (no conflict beyond the two wavefronts of 256
    bytes), and the rounds of a consumer store each 64 × 32 box of its tiles
    once (V1's rows 32-63 fall outside the output and are clipped by the
    store). The tap sums' epilogue stores the folded 32 rows a round
    (``_tap_epilogue``; V5 and V8 from registers, no box); V3' stores its
    m64n32 accumulators from registers (``_pertap_epilogue``)."""
    if key in WG_PERTAP:
        return _pertap_epilogue(WG_PERTAP[key])
    if key in WG_TAP:
        return _tap_epilogue(WG_TAP[key])
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
    ("V4", 131072, "conv_probe_v4_wgmma"), ("V4", 2120, "conv_probe_v4_wgmma"), ("V4", 77, None),
    ("V6", 131072, "conv_probe_v6_wgmma"), ("V6", 2120, "conv_probe_v6_wgmma"), ("V6", 77, None),
    ("V5", 131072, "conv_probe_v5_wgmma"), ("V5", 2120, "conv_probe_v5_wgmma"), ("V5", 77, None),
    ("V8", 131072, "conv_probe_v8_wgmma"), ("V8", 2120, "conv_probe_v8_wgmma"), ("V8", 77, None),
    ("V3'", 131072, "conv_probe_v3p_wgmma"), ("V3'", 2120, "conv_probe_v3p_wgmma"),
    ("V3'", 77, None)])
def test_chip_smoke_probe_instances(key, n, want):
    """chip_smoke.py [12] holds each V1 / V0 / V2 / V3 / V3' / V4 / V6 / V5 /
    V8 call to the wgmma counter of the instance the wrapper's rule names at
    that N (all but V0 and V2 at 77 on mma.sync), and every counter it reads
    exists in ``LAUNCHES``."""
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


_TAP_RULES = ("int v4_instance(int n) { return n % 8 == 0 ? kV4Wgmma : kV4Mma; }\n"
              "int v6_instance(int n) { return n % 8 == 0 ? kV6Wgmma : kV6Mma; }\n"
              "int v5_instance(int n) { return n % 8 == 0 ? kV5Wgmma : kV5Mma; }\n"
              "int v8_instance(int n) { return n % 8 == 0 ? kV8Wgmma : kV8Mma; }")
# each tap-sum probe's weight argument in the source, its mma.sync instance
# (probe_tapsum<KD, NDOTS, GROUPS, TAPS, WARPS_M, WARPS_N, WN>) and its
# wgmma config
_TAP_DISPATCH = {"V4": ("w27", "x", "<64, 1, 27, 27, 9, 2, 16>", "WgV4"),
                 "V6": ("w27p", "x", "<64, 7, 4, 27, 4, 2, 32>", "WgV4"),
                 "V5": ("w14", "x2", "<128, 14, 1, 14, 1, 8, 32>", "WgV5"),
                 "V8": ("w9", "x3", "<192, 9, 1, 9, 1, 8, 32>", "WgV8")}


@pytest.mark.parametrize("n", [131072, 8192, 2120, 200, 77, 8, 1])
@pytest.mark.parametrize("key", ["V4", "V6", "V5", "V8"])
def test_v4_v6_wgmma_rules_are_the_source(key, n):
    """``probe_v{4,6,5,8}_instance`` state the C rules ``v{4,6,5,8}_instance``,
    which ``hvc_probe_v{4,6,5,8}`` dispatch by and ``hvc_probe_v{4,6,5,8}_rule``
    report, with the source's instance codes: N a multiple of 8 (16-byte rows
    of X and the output for the tensor maps) takes the wgmma instance (WgV4,
    which V6 shares, WgV5, WgV8), a ragged N probe_tapsum on mma.sync; each
    wgmma launch counts on its own counter."""
    assert _TAP_RULES in PROBE_SRC
    v = key[1:]
    w, x, mma, wg = _TAP_DISPATCH[key]
    assert (f"  return run_v{v}(v{v}_instance(n), {w}, {x}, out, n, repeats, aligned,"
            in PROBE_SRC)
    assert f"int hvc_probe_v{v}_rule(int n) {{ return v{v}_instance(n); }}" in PROBE_SRC
    assert (f"    case kV{v}Wgmma: return tapsum_wgmma<{wg}>({w}, {x}, out, n, repeats, s);"
            in PROBE_SRC)
    assert (f"    case kV{v}Mma: return tapsum{mma}({w}, {x}, out, n, repeats, aligned, s);"
            in PROBE_SRC)
    mma_code, wgmma_code = getattr(cp, f"{key}_MMA"), getattr(cp, f"{key}_WGMMA")
    for name, code in ((f"kV{v}Mma", mma_code), (f"kV{v}Wgmma", wgmma_code)):
        assert re.search(rf"^  {name} = {code},", PROBE_SRC, re.M), name
    mirror = getattr(cp, f"probe_v{v}_instance")
    assert mirror(n) == (wgmma_code if n % 8 == 0 else mma_code)
    assert cp._INSTANCE_COUNTERS[(f"v{v}", wgmma_code)] == f"conv_probe_v{v}_wgmma"
    assert f"conv_probe_v{v}_wgmma" in cp.LAUNCHES
    if key in ("V5", "V8"):  # the wrapper asks the C rule, as V4's and V6's do
        wrapper = (ROOT / "hybrid_vit_cascade_tpu_torch" / "ops" / "cuda" /
                   "conv_probe.py").read_text()
        assert f'rule="hvc_probe_v{v}_rule")' in wrapper


def _resident_boxes(cfg: dict, w: torch.Tensor, taps_read: int = 0) -> tuple:
    """The kernel's copy of W into its TILES × CHUNKS resident boxes: thread
    item c is 16-byte chunk k8 = c % 8 of row r = c / 8 % 64 of box b = c /
    512, tile i = b / CHUNKS and chunk kc = b % CHUNKS, which holds the k 64·kc
    + 8·k8 … of tap 2i + r % 16 / 8, output row 8·(r / 16) + r % 8 of W (row
    32·tap + output row, KD k a row), zeros for a tap ≥ taps_read (the
    kernel's TAPS). Returns (boxes [TILES·CHUNKS, 64, 64], {(box, row, k8):
    (tap, output row, chunk, k8)})."""
    taps_read = taps_read or cfg["TAPS"]
    tiles, chunks = cfg["TILES"], cfg["CHUNKS"]
    boxes = torch.zeros((tiles * chunks, 64, 64), dtype=w.dtype)
    where = {}
    for c in range(tiles * chunks * 64 * 8):
        b, r, k8 = c // 512, c // 8 % 64, c % 8
        i, kc = b // chunks, b % chunks
        tap, orow = 2 * i + r % 16 // 8, 8 * (r // 16) + r % 8
        where[(b, r, k8)] = (tap, orow, kc, k8)
        if tap < taps_read:
            k0 = 64 * kc + 8 * k8
            boxes[b, r, 8 * k8:8 * k8 + 8] = w[tap * cp.COUT + orow, k0:k0 + 8]
    return boxes, where


def _tap_replay(cfg: dict, boxes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out (32, N) as probe_tapsum_wgmma<cfg> forms it: per work item of BN
    columns (X past N zero-filled, as TMA loads it), one chain over the
    chunks kc (outer) and the tiles i (inner) of box (i, kc) times rows
    64·kc … of X; then each thread (warp, lane) of the m64n128 fragment map
    (wgmma_sm90.cuh: element q at row 16·warp + lane / 4 + 8·(q % 4 / 2),
    column 8·(q / 4) + 2·(lane % 4) + q % 2) adds e0 + e2 and e1 + e3 into
    output row 8·warp + lane / 4, every output element written once."""
    n, bn, chunks = x.shape[1], cfg["BN"], cfg["CHUNKS"]
    out = torch.full((cp.COUT, n), float("nan"))
    written = torch.zeros((cp.COUT, -(-n // bn) * bn), dtype=torch.int64)
    t = torch.arange(128)
    warp, lane = t // 32, t % 32
    q = torch.arange(64)
    rows = 16 * warp[:, None] + lane[:, None] // 4 + 8 * (q[None] % 4 // 2)   # [128, 64]
    cols = 8 * (q[None] // 4) + 2 * (lane[:, None] % 4) + q[None] % 2
    bf = boxes.float()
    for n0 in range(0, n, bn):
        xb = torch.zeros((cfg["KD"], bn))
        xb[:, :min(bn, n - n0)] = x[:, n0:n0 + bn].float()
        acc = torch.zeros((64, bn))
        for kc in range(chunks):
            for i in range(cfg["TILES"]):
                acc = acc + bf[i * chunks + kc] @ xb[64 * kc:64 * kc + 64]
        frag = acc[rows, cols]                                              # [128, 64]
        for e in (0, 1):
            v = frag[:, e::4] + frag[:, e + 2::4]                           # [128, 16]
            orow = (8 * warp[:, None] + lane[:, None] // 4).expand_as(v)
            ocol = n0 + cols[:, e::4]
            written.index_put_((orow.reshape(-1), ocol.reshape(-1)),
                               torch.ones(orow.numel(), dtype=torch.int64), accumulate=True)
            keep = ocol < n
            out[orow[keep], ocol[keep]] = v[keep]
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("key", ["V4", "V6", "V5", "V8"])
def test_v4_v6_resident_rows_replay(key):
    """A torch replay of probe_tapsum_wgmma: the permuted, chunked resident
    boxes (every (tap, output row, chunk, 16-byte k8) of the TAPS taps
    exactly once, the odd tap count's last half-tile zeros: V4's and V6's tap
    27, V8's tap 9), the chunk-outer chain and the fragment fold e0 + e2 at N
    = 200 (a ragged second item) equal the plain version (both fp32 sums of
    the same bf16 products, in another order). Past the TAPS row groups W
    carries 1e4 (V6's own w27p rows 864-895, the row group it drops; V4's w27
    and V8's w9 padded by one group): a copy that read them (taps_read = TAPS
    + 1) misses by far."""
    case = bench.BY_KEY[key]
    cfg = WG_TAP[key]
    for line in ("    const int b = c / 512, r = c / 8 % 64, k8 = c % 8;",
                 "    const int i = b / CHUNKS, kc = b % CHUNKS;",
                 "    const int tap = 2 * i + r % 16 / 8, orow = 8 * (r / 16) + r % 8;",
                 "    if (tap < Cfg::TAPS)",
                 "      v = *reinterpret_cast<const uint4*>(w + (long long)(tap * kGroup + orow) * "
                 "Cfg::KD +",
                 "                                          kc * kWgBK + k8 * 8);",
                 "    *reinterpret_cast<uint4*>(wres + b * kWgTile + sw128_offset(r, k8)) = v;",
                 "  for (int c = tid; c < TILES * CHUNKS * 64 * 8; c += Cfg::Threads) {",
                 "      for (int kc = 0; kc < CHUNKS; ++kc, ++chunk) {",
                 "        for (int i = 0; i < TILES; ++i)",
                 "  if (!tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, Cfg::KD, n, kWgBK, "
                 "kWgBox) ||"):
        assert line in PROBE_SRC, line
    taps, kd = cfg["TAPS"], cfg["KD"]
    rng = np.random.default_rng(160 + len(key) + int(key[1]))
    w = torch.from_numpy(rng.standard_normal(case.w_shape, dtype=np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((kd, 200), dtype=np.float32)).bfloat16()
    odd = 2 * cfg["TILES"] > taps  # a half-tile past the last tap
    planted = torch.cat([w[:taps * cp.COUT], torch.full((cp.COUT, kd), 1e4).bfloat16()])
    if key == "V6":
        w = planted
    boxes, where = _resident_boxes(cfg, planted)
    cover = sorted(where.values())
    assert cover == sorted((t, o, kc, k8) for t in range(2 * cfg["TILES"]) for o in range(cp.COUT)
                           for kc in range(cfg["CHUNKS"]) for k8 in range(8))  # each once
    for (b, r, k8), (tap, orow, kc, _) in where.items():
        chunk = boxes[b, r, 8 * k8:8 * k8 + 8]
        if tap >= taps:
            assert odd and tap == taps and not chunk.any()
        else:
            k0 = 64 * kc + 8 * k8
            assert torch.equal(chunk, w[tap * cp.COUT + orow, k0:k0 + 8])
    for (b, r, k8), (tap, orow, kc, _) in where.items():  # one thread's e0 / e2 rows: one output row
        if r % 16 < 8:
            assert where[(b, r + 8, k8)] == (tap + 1, orow, kc, k8)
    got = _tap_replay(cfg, boxes, x)
    want = case.plain(w, x, 1)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    if odd:
        leaked = _tap_replay(cfg, _resident_boxes(cfg, planted, taps_read=taps + 1)[0], x)
        assert (leaked - want).abs().max() > 1e2 * want.abs().max()


# ------------------------------------------ V3' on probe_pertap_wgmma ---

_V3P_RULE = "int v3p_instance(int n) { return n % 8 == 0 ? kV3pWgmma : kV3pMma; }"


@pytest.mark.parametrize("n", [131072, 8200, 8192, 8191, 2120, 77, 8, 1])
def test_v3p_wgmma_rule_is_the_source(n):
    """``probe_v3p_instance`` states the C rule ``v3p_instance``, which
    ``hvc_probe_v3p`` dispatches by and ``hvc_probe_v3p_rule`` reports, with
    the source's instance codes: N a multiple of 8 (16-byte rows of X for
    its tensor map) takes the per-tap wgmma instance, a ragged N
    probe_tapsum on mma.sync as before; the wrapper asks the C rule and a
    wgmma launch counts on ``conv_probe_v3p_wgmma``."""
    assert _V3P_RULE in PROBE_SRC
    assert "  return run_v3p(v3p_instance(n), w27, x, out, n, repeats, aligned," in PROBE_SRC
    assert "int hvc_probe_v3p_rule(int n) { return v3p_instance(n); }" in PROBE_SRC
    for name, code in (("kV3pMma", cp.V3P_MMA), ("kV3pWgmma", cp.V3P_WGMMA)):
        assert re.search(rf"^  {name} = {code},", PROBE_SRC, re.M), name
    assert ("    case kV3pMma: return tapsum<64, 27, 1, 27, 1, 8, 32>(w27, x, out, n, repeats, "
            "aligned, s);") in PROBE_SRC
    assert "    case kV3pWgmma: return pertap_wgmma(w27, x, out, n, repeats, s);" in PROBE_SRC
    assert cp.probe_v3p_instance(n) == (cp.V3P_WGMMA if n % 8 == 0 else cp.V3P_MMA)
    assert cp._INSTANCE_COUNTERS[("v3p", cp.V3P_WGMMA)] == "conv_probe_v3p_wgmma"
    assert "conv_probe_v3p_wgmma" in cp.LAUNCHES
    wrapper = (ROOT / "hybrid_vit_cascade_tpu_torch" / "ops" / "cuda" / "conv_probe.py").read_text()
    assert 'rule="hvc_probe_v3p_rule")' in wrapper


def test_v3p_config_is_the_source():
    """WgV3p as the struct computes it: 256 columns (four m64 tiles) a work
    item, two consumers of one ring stage each (free once in registers);
    W27's 27 taps resident as B, 110,592 bytes, all within the card's
    232,448 bytes of shared memory; one accumulator of 16 fp32 and 16 A
    registers a thread a tile, 128 of each kind at four tiles, within the
    consumers' register budget."""
    for line in ("  static constexpr int BN = MT * 64;                             // columns of a "
                 "work item",
                 "  static constexpr int WBytes = kPerTapTaps * kPerTapWBytes;     // resident W27: "
                 "110,592",
                 "  static constexpr int StageBytes = BN * 128;                    // an item of X: MT "
                 "boxes [64 k][64 n]",
                 "  static constexpr int Smem = 1024 + WBytes + CONS * SPC * StageBytes + 2 * CONS * "
                 "SPC * 8;",
                 "    float acc[MT][16];", "    uint32_t a[MT][4][4];  // tile i, k16 step kk",
                 "    setmaxnreg_inc<kTapConsumerRegs>();"):
        assert line in PROBE_SRC, line
    cfg = WG_PERTAP["V3'"]
    assert "  using Cfg = WgV3p;" in PROBE_SRC
    assert (cfg["MT"], cfg["BN"], cfg["CONS"], cfg["SPC"]) == (4, 256, 2, 1)
    assert _wg_const("kPerTapTaps") == cp.TAPS and _wg_const("kPerTapWBytes") == 4096
    assert cfg["WBytes"] == 110592 == cp.TAPS * cp.COUT * cp.CIN * 2
    assert cfg["smem"] == 177184 <= _wg_const("kWgSmemMax")
    # a second stage a consumer at 256 columns would not fit
    assert cfg["smem"] + cfg["CONS"] * cfg["StageBytes"] > 232448
    # a consumer's A fragments and accumulators within its setmaxnreg budget
    assert cfg["MT"] * (16 + 16) <= _wg_const("kTapConsumerRegs") - 64


def _pertap_ring(cfg: dict, uses: int) -> list:
    """(consumer, stage, phase) of a block's items li = 0 … uses - 1 in
    probe_pertap_wgmma, in the producer's order: item li goes to consumer li
    % CONS, its use = li / CONS, into stage consumer·SPC + use % SPC, at phase
    use / SPC % 2 (the producer's and the consumer's expressions)."""
    for line in ("        const long long use = li / CONS;  // the consumer's own item count",
                 "        const int s = int(li % CONS) * SPC + int(use % SPC);",
                 "        mbar_wait(&empty[s], uint32_t(use / SPC & 1) ^ 1);  // its consumer freed it "
                 "(free at first)",
                 "          tma_load_2d(st + b * kWgTile, &map_x, &full[s], n0 + b * kWgBox, 0);",
                 "         it += (long long)CONS * gridDim.x, ++use) {",
                 "      const int s = wg * SPC + int(use % SPC);",
                 "      mbar_wait(&full[s], uint32_t(use / SPC & 1));"):
        assert line in PROBE_SRC, line
    cons, spc = cfg["CONS"], cfg["SPC"]
    return [(li % cons, li % cons * spc + li // cons % spc, li // cons // spc % 2)
            for li in range(uses)]


def _pertap_pipeline_drains(cfg: dict, ring: list) -> bool:
    """Plays the producer and the consumers of probe_pertap_wgmma over the
    items of `ring` (producer order): the producer fills a stage once its
    consumer has freed the last fill (4 arrivals: each warp arrives once its
    ldmatrix loads are in and fenced from the async proxy, before the
    products); a consumer takes its items in order once filled and frees
    the item's stage. True when every item is filled and taken, also with
    one stage a consumer."""
    for line in ("      mbar_init(&empty[s], 4);  // one arrival a warp of the consumer",
                 # the ldmatrix reads fenced from TMA's refill before the arrival
                 "      fence_proxy_async_shared();\n"
                 "      __syncwarp();\n"
                 "      if (lane == 0) mbar_arrive(&empty[s]);  // the warp's part is in registers"):
        assert line in PROBE_SRC, line
    arrivals = 4
    fills, arrived = {}, {}
    per_cons = {}
    for c, st, _ in ring:
        per_cons.setdefault(c, []).append(st)
    pos = {c: 0 for c in per_cons}
    j, moved = 0, True
    while moved:
        moved = False
        if j < len(ring) and fills.get(ring[j][1], 0) * arrivals == arrived.get(ring[j][1], 0):
            fills[ring[j][1]] = fills.get(ring[j][1], 0) + 1
            j, moved = j + 1, True
        for c, seq in per_cons.items():
            p = pos[c]
            if p < len(seq) and fills.get(seq[p], 0) * arrivals > arrived.get(seq[p], 0):
                arrived[seq[p]] = arrived.get(seq[p], 0) + arrivals  # every warp of the consumer
                pos[c], moved = p + 1, True
    return j == len(ring) and all(pos[c] == len(seq) for c, seq in per_cons.items())


def _pertap_epilogue(cfg: dict) -> None:
    """probe_pertap_wgmma's epilogue from registers: thread (warp, lane)
    stores accumulator q of tile i at output row 8·(q / 4) + 2·(lane % 4) + q
    % 2, column n0 + 64·i + 16·warp + lane / 4 + 8·(q % 4 / 2) (the m64n32
    fragment map with the tile's rows as columns of out); over a work item
    every output element of its 32 rows × BN columns is written once, from
    each of a thread's 16 accumulators of a tile once; the 8 lanes of one
    lane % 4 write 8 neighbouring columns of one row (whole 32-byte sectors);
    columns past N are masked, so a ragged last item writes only its columns
    inside N."""
    for line in ("        const int col = n0 + 64 * i + 16 * warp + lane / 4;",
                 "        float* o = dst + (long long)(2 * (lane % 4)) * N + col;",
                 "          if (col + 8 * (q % 4 / 2) < N)",
                 "            o[(long long)(8 * (q / 4) + q % 2) * N + 8 * (q % 4 / 2)] = acc[i][q];"):
        assert line in PROBE_SRC, line
    bn = cfg["BN"]

    def cells(n0, n):
        return [(2 * (ln % 4) + 8 * (q // 4) + q % 2, col + 8 * (q % 4 // 2))
                for i in range(cfg["MT"]) for w in range(4) for ln in range(32)
                for col in [n0 + 64 * i + 16 * w + ln // 4] for q in range(16)
                if col + 8 * (q % 4 // 2) < n]

    full = cells(0, 10 ** 9)
    assert sorted(full) == [(r, c) for r in range(cp.COUT) for c in range(bn)]
    n = 2 * bn + 72  # a ragged last item of 72 columns
    got = sorted(cells(0, n) + cells(bn, n) + cells(2 * bn, n))
    assert got == [(r, c) for r in range(cp.COUT) for c in range(n)]
    for w, q in ((w, q) for w in range(4) for q in range(16)):  # one warp store: whole sectors
        byte = [((2 * (ln % 4) + 8 * (q // 4) + q % 2) * 131072 + 16 * w + ln // 4
                 + 8 * (q % 4 // 2)) * 4 for ln in range(32)]
        sectors = {}
        for b in byte:
            sectors.setdefault(b // 32, set()).add(b)
        assert len(sectors) == 4 and all(len(v) == 8 for v in sectors.values())


def _ldmatrix_trans(smem: np.ndarray, addrs: list) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 over a uint16 image of shared
    memory: lane l gives the byte address of row l % 8 of matrix l / 8 (8
    bf16); lane l receives in register j elements (2·(l % 4), l / 4) and (2·(l
    % 4) + 1, l / 4) of matrix j, the first in the low half. Returns [32 lanes,
    4 registers, 2 halves] of uint16."""
    rows = np.stack([smem[a // 2:a // 2 + 8] for a in addrs])      # [32, 8]: matrix l / 8, row l % 8
    mats = rows.reshape(4, 8, 8)
    lane = np.arange(32)
    out = np.empty((32, 4, 2), dtype=np.uint16)
    for j in range(4):
        for h in range(2):
            out[:, j, h] = mats[j, 2 * (lane % 4) + h, lane // 4]
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16).copy()).view(torch.bfloat16)


def test_v3p_pertap_replay():
    """A replay of probe_pertap_wgmma on one shared-memory image: W27 copied
    into the resident B (row r, 16-byte chunk k8 at sw128_offset(r, k8)); the
    B descriptor of tap t, k16 step kk (start 4096·t + 32·kk, stride 1,024
    bytes a group of 8 rows, read under the 128-byte swizzle of the address)
    rebuilds W27[32t:32t+32, 16kk:16kk+16] exactly, as the K-major [N][K] B;
    X's TMA boxes (64 k × 64 columns, swizzled, zeros past N) read back by
    each warp's ldmatrix.x4.trans addresses and laid out by the RS fragment
    map of wgmma_sm90.cuh rebuild each m64 tile's Xᵀ[64 n, 16 k] exactly,
    every element from one thread; the 27 × 4 products chained per tile
    then equal ``probe_v3p_plain`` at N = 200 (a ragged second item)."""
    for line in ("    *reinterpret_cast<uint4*>(wres + sw128_offset(r, k8)) =",
                 "        *reinterpret_cast<const uint4*>(w + (long long)r * kWgBK + k8 * 8);",
                 "          const uint64_t db = wgmma_desc(w0 + t * kPerTapWBytes + kk * 32, kWgLboA, "
                 "kWgSbo);",
                 "          for (int i = 0; i < MT; ++i) wgmma_m64n32k16_rs(acc[i], a[i][kk], db, t > 0 "
                 "|| kk > 0);",
                 "                                  st + i * kWgTile +",
                 "                                  sw128_offset(16 * kk + 8 * (lane / 16) + lane % 8,",
                 "                                               2 * warp + lane / 8 % 2)));",
                 "  if (!tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, kWgBK, n, kWgBK, "
                 "kWgBox))"):
        assert line in PROBE_SRC, line
    for line in ("      \"}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\\n\"",
                 "// 16·(t / 32) + (t % 32) / 4 + 8·(r % 2) and k 2·(t % 4) + 8·(r / 2) + {0, 1}"):
        assert line in WGMMA_SRC, line
    cfg = WG_PERTAP["V3'"]
    rng = np.random.default_rng(183)
    w27 = torch.from_numpy(rng.standard_normal((cp.TAPS * cp.COUT, cp.CIN), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((cp.CIN, 200), dtype=np.float32))
    w27, x = w27.bfloat16(), x.bfloat16()
    n = x.shape[1]
    # the resident B
    wb = _bits(w27)
    wres = np.zeros(cfg["WBytes"] // 2, dtype=np.uint16)
    for r in range(cp.TAPS * cp.COUT):
        for k8 in range(8):
            off = _sw128(r, k8) // 2
            wres[off:off + 8] = wb[r, 8 * k8:8 * k8 + 8]
    sbo, lbo = _wg_const("kWgSbo"), _wg_const("kWgLboA")
    for t in range(cp.TAPS):
        for kk in range(4):
            d = _desc(t * _wg_const("kPerTapWBytes") + kk * 32, lbo, sbo)
            start, stride = (d & 0x3FFF) << 4, ((d >> 32) & 0x3FFF) << 4
            nrow, k = np.meshgrid(np.arange(cp.COUT), np.arange(16), indexing="ij")
            addr = start + nrow // 8 * stride + nrow % 8 * 128 + 2 * k
            phys = addr ^ (((addr >> 7) & 7) << 4)
            b = wres[phys // 2]                                           # [32 n][16 k]
            assert np.array_equal(b, wb[32 * t:32 * t + 32, 16 * kk:16 * kk + 16])
    # X's items, A fragments, the chain and the epilogue
    xb = _bits(x)
    want = cp.probe_v3p_plain(w27, x, 1)
    out = torch.full((cp.COUT, n), float("nan"))
    wf = w27.float()
    for n0 in range(0, n, cfg["BN"]):
        stage = np.zeros(cfg["StageBytes"] // 2, dtype=np.uint16)
        for i in range(cfg["MT"]):
            for k in range(cp.CIN):
                for c8 in range(8):
                    cols = [n0 + 64 * i + 8 * c8 + e for e in range(8)]
                    vals = [xb[k, c] if c < n else 0 for c in cols]
                    off = (i * 8192 + _sw128(k, c8)) // 2
                    stage[off:off + 8] = vals
        for i in range(cfg["MT"]):
            acc = torch.zeros((64, cp.COUT))
            for kk in range(4):
                a = np.full((64, 16), -1, dtype=np.int64)
                for warp in range(4):
                    addrs = [i * 8192 + _sw128(16 * kk + 8 * (ln // 16) + ln % 8, 2 * warp + ln // 8 % 2)
                             for ln in range(32)]
                    regs = _ldmatrix_trans(stage, addrs)
                    for ln in range(32):
                        for r in range(4):
                            m = 16 * warp + ln // 4 + 8 * (r % 2)
                            for h in range(2):
                                k = 2 * (ln % 4) + 8 * (r // 2) + h
                                assert a[m, k] == -1  # one thread holds each element
                                a[m, k] = regs[ln, r, h]
                cols = np.arange(n0 + 64 * i, n0 + 64 * i + 64)
                xt = np.where(cols[:, None] < n, xb[16 * kk:16 * kk + 16, np.minimum(cols, n - 1)].T, 0)
                assert np.array_equal(a, xt)                              # Xᵀ of the tile, exactly
                af = _bf16(a).float()
                for t in range(cp.TAPS):
                    acc = acc + af @ wf[32 * t:32 * t + 32, 16 * kk:16 * kk + 16].t()
            for warp, ln, q in ((w, ln, q) for w in range(4) for ln in range(32) for q in range(16)):
                m = 16 * warp + ln // 4 + 8 * (q % 4 // 2)               # the m64n32 fragment map
                c = 8 * (q // 4) + 2 * (ln % 4) + q % 2
                col = n0 + 64 * i + 16 * warp + ln // 4 + 8 * (q % 4 // 2)
                if col < n:
                    out[8 * (q // 4) + q % 2 + 2 * (ln % 4), col] = acc[m, c]
    assert torch.isfinite(out).all()
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
