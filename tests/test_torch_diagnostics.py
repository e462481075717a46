"""The port's diagnostic path — the cross-attention capture
(``return_probs``, ``store_attention``, ``capture_attention``,
``collect_attention_maps``), ``losses/feature_metrics.py``,
``losses/diagnostics.py``, ``convert.diagnostic_nets`` and ``cli diagnose``
— against the JAX package.

The diagnostic nets are the JAX suite's own (``DiagnosticLosses()``), their
variables drawn from a seeded numpy generator (flax's inits are traced for
the shapes only, which saves their compiles) and converted. The JAX suite
runs jitted; the volumes are the scaled cascade's stage-1 output shape (8³,
one sample, random values) with its (1, 4, 512, 4) attention maps, so one
compiled suite serves the direct tests, the feature metrics and
``diagnose``. The cascade is tests/test_torch_serving.py's
``scaled_cascade`` (8³→16³→32³, 64² X-rays, E=32, 4 heads, two stage-1
blocks), fp32 on the CPU, built once a process for both files. Tolerances
are stated per test: 1e-5 relative where both sides run the same fp32
formula on the same inputs, the cascade's 2e-4
(tests/test_parity_cascade.py:345) where a model output feeds them."""

import functools
import json

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybrid_vit_cascade_tpu.inference as jax_inference
from hybrid_vit_cascade_tpu import cli as jax_cli
from hybrid_vit_cascade_tpu.losses import diagnostics as jdiag
from hybrid_vit_cascade_tpu.losses import feature_metrics as jfm
from hybrid_vit_cascade_tpu.models import collect_attention_maps as jax_collect
from hybrid_vit_cascade_tpu.ops.attention import _reference_attention
from hybrid_vit_cascade_tpu_torch import cli, convert
from hybrid_vit_cascade_tpu_torch.inference.infer import InferenceEngine
from hybrid_vit_cascade_tpu_torch.losses import diagnostics
from hybrid_vit_cascade_tpu_torch.losses import feature_metrics as fm
from hybrid_vit_cascade_tpu_torch.models.attention import (
    MultiHeadCrossAttention,
    capture_attention,
    collect_attention_maps,
)
from hybrid_vit_cascade_tpu_torch.ops.attention import dot_product_attention
from tests.test_torch_serving import DEPTHS, S1, S2, S3, XR, E, HEADS, scaled_cascade
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SAME = dict(rtol=1e-5, atol=1e-6)  # one fp32 formula, the same inputs
MODEL = dict(rtol=2e-4, atol=2e-4)  # through the cascade


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cl(x: np.ndarray) -> jnp.ndarray:
    """NCDHW → the JAX modules' channels-last."""
    return jnp.asarray(np.moveaxis(x, 1, -1))


class _JitSuite:
    """The JAX DiagnosticLosses, its call jitted (what its engine calls)."""

    def __init__(self, jd):
        self.jd = jd
        self._fn = jax.jit(lambda p, t, x0, g, xr, prior, prev, maps: jd(
            p, t, x0, g, xr, depth_prior=prior, prev_stage_volume=prev, attention_maps=maps))

    def __call__(self, predicted, target, pred_x0, gt_x0, xrays, depth_prior=None,
                 prev_stage_volume=None, attention_maps=None):
        return self._fn(predicted, target, pred_x0, gt_x0, xrays, depth_prior,
                        prev_stage_volume, attention_maps)


def _draw(rng, path, leaf) -> np.ndarray:
    """A flax variable of the diagnostic nets: conv kernels N(0, 1/fan_in),
    biases N(0, 0.1²), GroupNorm scales 1 + N(0, 0.1²)."""
    name = getattr(path[-1], "key", "")
    shape = leaf.shape
    if name == "kernel":
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    base = 1.0 if name == "scale" else 0.0
    return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def suite():
    """The JAX suite (jitted) with its nets' variables drawn from a seeded
    numpy generator, and those nets converted."""
    real_init = flax_nn.Module.init
    rng = np.random.default_rng(7)

    def seeded_init(self, rngs, *a, **kw):
        shapes = jax.eval_shape(functools.partial(real_init, self, **kw), rngs, *a)
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(_draw(rng, path, leaf)), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Module, "init", seeded_init)
        jd = jdiag.DiagnosticLosses()
    jf = jd._feature_metrics
    weights = convert.diagnostic_nets(jd._perc_vars, jf._vars, jf._lpips._vars)
    return _JitSuite(jd), weights


def _suite_kwargs(vols, extras: str, to):
    """The optional inputs of a suite call: the attention maps, and with
    extras 'all' the depth prior and the previous stage too."""
    kw = dict(attention_maps="maps")
    if extras == "all":
        kw.update(depth_prior="prior", prev_stage_volume="prev")
    return {k: ({"cross_attention": to(vols[v])} if k == "attention_maps" else to(vols[v]))
            for k, v in kw.items()}


_ARGS = ("pred", "gt", "pred", "gt", "xr")


@pytest.fixture(scope="module")
def jax_losses(suite, vols):
    """The JAX suite's losses on vols, once a case ('maps' or 'all')."""
    cache = {}

    def get(extras: str) -> dict:
        if extras not in cache:
            cache[extras] = suite[0](*(jnp.asarray(vols[k]) for k in _ARGS),
                                     **_suite_kwargs(vols, extras, jnp.asarray))
        return cache[extras]
    return get


@pytest.fixture(scope="module")
def vols():
    """8³ volumes of one sample, 64² X-rays, stage-1 attention maps."""
    rng = np.random.default_rng(5)
    v = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    maps = rng.random((1, HEADS, S1 ** 3, 4)).astype(np.float32)
    return {"pred": v(1, 1, S1, S1, S1), "gt": v(1, 1, S1, S1, S1),
            "prior": v(1, 1, S1, S1, S1), "prev": v(1, 1, 4, 4, 4),
            "xr": rng.uniform(0, 1, (1, 2, 1, XR, XR)).astype(np.float32),
            "maps": maps / maps.sum(-1, keepdims=True)}


# ------------------------------------------------------- attention capture ---


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-5, atol=1e-6)),
                                       ("bfloat16", dict(rtol=2 ** -7, atol=1e-6))])
def test_reference_attention_matches_jax(rng, dtype, tol):
    """return_probs=True: fp32 scores and softmax, probabilities rounded to
    q's dtype before the PV product, out in q's dtype (bf16: within one bf16
    ulp), probs fp32 within 1e-6."""
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for n in (40, 24, 24))
    jd = getattr(jnp, dtype)
    want_out, want_p = _reference_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                                            0.25, return_probs=True)
    td = getattr(torch, dtype)
    out, p = dot_product_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 0.25,
                                   return_probs=True)
    assert out.dtype == td and p.dtype == torch.float32 and p.shape == (2, 3, 40, 24)
    np.testing.assert_allclose(_np(p), np.asarray(want_p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(out.float()), np.asarray(want_out, np.float32), **tol)
    plain = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0.25)
    np.testing.assert_allclose(_np(dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                                         0.25, return_probs=True)[0]),
                               _np(plain), **SAME)


@pytest.fixture(scope="module")
def cascades(tmp_path_factory):
    """The scaled cascade in both packages on the same variables: the
    checkpoints, the JAX engine and the port engine's model."""
    shared = scaled_cascade(tmp_path_factory)
    return {"port": shared["port"], "jax_entry": shared["jax_entry"],
            "jax_engine": shared["jax_engine"], "torch": shared["engine"].model}


def _cross_attns(model):
    return [m for m in model.modules() if isinstance(m, MultiHeadCrossAttention)]


def test_capture_matches_jax(cascades, vols):
    """stage 1's captured cross-attention probabilities, block by block, and
    their mean against JAX's sown maps (store_attention=True): rows sum to 1;
    only stage 1 captures; the volume equals the uncaptured one; on exit the
    flags are restored and the maps dropped."""
    xr = vols["xr"]
    eng = cascades["jax_engine"]  # what its diagnose runs, which this warms
    jm = eng.model.clone(store_attention=True)
    jvol, st = jm.apply(eng.variables, jnp.asarray(xr, jnp.float32), max_stage=1, train=False,
                        mutable=["intermediates"])
    inter = st["intermediates"]["stage1"]["vit_backbone"]
    want_blocks = [np.asarray(inter[f"HybridViTBlock3D_{i}"]["MultiHeadCrossAttention_0"]
                              ["attention_weights"][0]) for i in range(DEPTHS[0])]
    want = np.asarray(jax_collect(st["intermediates"])["cross_attention"])

    tm = cascades["torch"]
    with torch.no_grad():
        plain = tm(torch.from_numpy(xr), max_stage=1)
        with tm.capture_attention():
            vol = tm(torch.from_numpy(xr), max_stage=1)
            kept = [m.attention_weights for m in _cross_attns(tm)]
            got = collect_attention_maps(tm)
    assert [w is not None for w in kept] == [True] * DEPTHS[0] + [False] * 2
    for g, w in zip(kept, want_blocks):
        assert g.shape == w.shape == (1, HEADS, S1 ** 3, w.shape[-1])
        np.testing.assert_allclose(_np(g), w, **MODEL)
    assert list(got) == ["cross_attention"]
    np.testing.assert_allclose(_np(got["cross_attention"]), want, **MODEL)
    np.testing.assert_allclose(_np(got["cross_attention"]).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(_np(vol), np.asarray(jvol), **MODEL)
    np.testing.assert_allclose(_np(vol), _np(plain), **SAME)
    assert all(not m.store_attention and m.attention_weights is None for m in _cross_attns(tm))


def test_no_capture_by_default(cascades, vols):
    """A normal forward keeps no map and collects {} (JAX: nothing sown);
    capture_attention sets the flag in stage 1 only and clears it on exit."""
    tm = cascades["torch"]
    with torch.no_grad():
        tm(torch.from_numpy(vols["xr"]), max_stage=2)
    assert collect_attention_maps(tm) == {}
    eng = cascades["jax_engine"]
    _, st = eng.model.apply(eng.variables, jnp.asarray(vols["xr"]), max_stage=1, train=False,
                            mutable=["intermediates"])
    assert jax_collect(st.get("intermediates", {})) == {}
    assert not any(m.store_attention for m in _cross_attns(tm))
    with tm.capture_attention():
        assert [m.store_attention for m in _cross_attns(tm)] == [True] * DEPTHS[0] + [False] * 2
    assert not any(m.store_attention for m in _cross_attns(tm))


def test_collect_attention_maps_same_shape_mean(rng):
    """The mean runs over the maps of the first map's shape, as JAX's."""
    mods = torch.nn.ModuleList(MultiHeadCrossAttention(8, 8, 2) for _ in range(3))
    maps = [rng.random(s).astype(np.float32) for s in ((1, 2, 5, 3), (1, 2, 4, 3), (1, 2, 5, 3))]
    for m, a in zip(mods, maps):
        m.attention_weights = torch.from_numpy(a)
    tree = {f"b{i}": {"attention_weights": (jnp.asarray(a),)} for i, a in enumerate(maps)}
    np.testing.assert_allclose(_np(collect_attention_maps(mods)["cross_attention"]),
                               np.asarray(jax_collect(tree)["cross_attention"]), **SAME)
    with capture_attention(mods):
        assert all(m.store_attention and m.attention_weights is None for m in mods)
    assert not any(m.store_attention for m in mods)


# ------------------------------------------------------------ feature metrics ---


def test_feature_pieces_match_jax(rng):
    a = rng.standard_normal((2, 6, 5, 7, 4)).astype(np.float32)
    b = (0.6 * a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("_feature_cosine", "_feature_correlation", "_feature_ssim"):
        np.testing.assert_allclose(float(getattr(fm, name)(ta, tb)),
                                   float(getattr(jfm, name)(_cl(a), _cl(b))), err_msg=name, **SAME)
    np.testing.assert_allclose(_np(fm._gram(ta)), np.asarray(jfm._gram(_cl(a))), **SAME)


def test_extractor_and_lpips_nets_match_jax(suite, vols):
    """The converted extractor's four levels and the 2D net's four taps (the
    JAX nets jitted: one compile each beats their eager op-by-op ones)."""
    jf = suite[0].jd._feature_metrics
    weights = suite[1]
    ext = fm.MultiLevelFeatureExtractor()
    ext.load_state_dict(weights["extractor"], strict=True)
    want = jax.jit(jf._extractor.apply)(jf._vars, _cl(vols["pred"]))
    with torch.no_grad():
        got = ext(torch.from_numpy(vols["pred"]))
    assert list(got) == list(want) == [f"level_{i}" for i in range(4)]
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.moveaxis(np.asarray(want[k]), -1, 1),
                                   err_msg=k, rtol=1e-4, atol=1e-5)
    net = fm._Slice2DFeatureNet()
    net.load_state_dict(weights["lpips"], strict=True)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 3, 20, 12)).astype(np.float32)
    jtaps = jax.jit(jf._lpips._net.apply)(jf._lpips._vars, jnp.asarray(np.moveaxis(img, 1, -1)))
    with torch.no_grad():
        taps = net(torch.from_numpy(img))
    for g, w in zip(taps, jtaps, strict=True):
        np.testing.assert_allclose(_np(g), np.moveaxis(np.asarray(w), -1, 1), rtol=1e-4, atol=1e-5)


def _as_suite_key(key: str, value: float):
    """A ComprehensiveFeatureMetrics key and value → the DiagnosticLosses key
    that carries it and the value that key holds there."""
    if key.startswith("level_"):
        return f"diagnostic_{key}", value
    if key == "lpips_average":
        return "lpips", value
    if key.startswith("lpips_"):
        return key, value
    name = key.removeprefix("overall_feature_")
    return f"feature_{name}", value if name in ("mse", "style") else 1.0 - value


def test_comprehensive_feature_metrics_match_jax(suite, vols, jax_losses):
    """Every key: per-level MSE / cosine / correlation / SSIM / style, their
    means and the three LPIPS views (slices by linspace → int32), against the
    JAX ComprehensiveFeatureMetrics as its DiagnosticLosses reports them
    (feature metrics of (gt_x0, pred_x0); cosine, correlation and SSIM as
    1 − mean)."""
    want = jax_losses("maps")
    weights = suite[1]
    got = fm.ComprehensiveFeatureMetrics(weights=weights["extractor"],
                                         lpips_weights=weights["lpips"])(
        torch.from_numpy(vols["gt"]), torch.from_numpy(vols["pred"]))
    assert len(got) == 4 * 5 + 5 + 4
    mapped = dict(_as_suite_key(k, float(v)) for k, v in got.items())
    assert len(mapped) == len(got)
    assert {k for k in want if k.startswith(("diagnostic_level_", "feature_", "lpips"))} \
        == set(mapped)
    for k, v in mapped.items():
        np.testing.assert_allclose(v, float(want[k]), err_msg=k, rtol=1e-4, atol=1e-6)


def test_seeded_nets_take_flax_initialisers():
    """By default the nets are drawn from a seeded torch.Generator with
    flax's initialisers: lecun_normal kernels (std √(1/fan_in), cut at 2σ of
    the untruncated normal), zero biases, unit / zero GroupNorm; frozen and
    the same for the same seed."""
    a = fm.seeded_net(fm.MultiLevelFeatureExtractor(), 99)
    b = fm.seeded_net(fm.MultiLevelFeatureExtractor(), 99)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    for conv in a.convs:
        w = conv.weight
        fan_in = w[0].numel()
        sigma = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * sigma + 1e-7
        assert abs(float(w.std()) / (1.0 / fan_in) ** 0.5 - 1.0) < 0.05
        assert not conv.bias.any() and not w.requires_grad
    assert all(bool((n.weight == 1).all() and not n.bias.any()) for n in a.norms)


# -------------------------------------------------------- the diagnostic suite ---


@pytest.mark.parametrize("extras", ["maps", "all"])
def test_diagnostic_losses_match_jax(suite, vols, jax_losses, extras):
    """Every key of DiagnosticLosses against the JAX suite, with the
    attention maps (what ``diagnose`` passes) and with the depth prior and
    the previous stage too (every branch taken); without the maps the
    cross-attention terms are 0 and nothing else moves."""
    weights = suite[1]
    tkw = _suite_kwargs(vols, extras, torch.from_numpy)
    args = [vols[k] for k in _ARGS]
    want = jax_losses(extras)
    port = diagnostics.DiagnosticLosses(weights=weights)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args), **tkw)
    assert sorted(got) == sorted(want)  # a jitted dict comes back key-sorted
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in got.values())
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, rtol=1e-4, atol=1e-6)
    moved = ("depth_consistency", "stage_transition", "prior_improvement_ratio")
    assert all((float(want[k]) != 0) == (extras == "all") for k in moved)
    assert float(want["cross_attention_align"]) != 0
    assert diagnostics.analyze_component_health(got) == jdiag.analyze_component_health(want)
    tkw.pop("attention_maps")
    with torch.no_grad():
        bare = port(*(torch.from_numpy(a) for a in args), **tkw)
    ca = ("cross_attention_align", "cross_attention_sparsity")
    assert all(float(bare[k]) == 0 for k in ca)
    total = got["total"] - diagnostics.LOSS_WEIGHTS["cross_attention_align"] * got[ca[0]]
    np.testing.assert_allclose(float(bare["total"]), float(total), rtol=1e-6)
    assert all(torch.equal(bare[k], got[k]) for k in got if k not in ca + ("total",))


_HEALTH_CASES = {
    "low": dict(diffusion=0.005, projection_single=0.001, depth_consistency=0.0001,
                cross_attention_align=0.05, frequency_low=0.1, frequency_high=0.1,
                stage_transition=0.005, feature_mse=0.005, lpips=0.05),
    "mid": dict(diffusion=0.03, projection_single=0.01, depth_consistency=0.01,
                cross_attention_align=0.2, frequency_low=0.3, frequency_high=0.1,
                stage_transition=0.03, feature_mse=0.03, lpips=0.2),
    "high": dict(diffusion=0.07, projection_single=0.04, depth_consistency=0.04,
                 cross_attention_align=0.4, frequency_low=0.1, frequency_high=0.3,
                 stage_transition=0.07, feature_mse=0.07, lpips=0.4),
    "worst": dict(diffusion=0.5, projection_single=0.5, depth_consistency=0.3,
                  cross_attention_align=0.9, frequency_low=0.0, frequency_high=0.0,
                  stage_transition=0.5, feature_mse=0.5, lpips=0.9, extra=[1.0, 2.0]),
    "edges": dict(diffusion=0.01, projection_single=0.05, depth_consistency=0.0,
                  cross_attention_align=0.1, stage_transition=0.1, feature_mse=0.1, lpips=0.5),
}


@pytest.mark.parametrize("case", sorted(_HEALTH_CASES))
def test_analyze_component_health_matches_jax(case):
    """Equal grades on the same float inputs (0-d tensors here, 0-d arrays
    there; non-scalars ignored)."""
    losses = _HEALTH_CASES[case]
    got = diagnostics.analyze_component_health(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in losses.items()})
    want = jdiag.analyze_component_health(
        {k: jnp.asarray(v, jnp.float32) for k, v in losses.items()})
    assert got == want
    assert diagnostics.analyze_component_health(
        {k: np.float32(v) for k, v in losses.items() if np.ndim(v) == 0}) == want


def test_cli_diagnose_matches_jax(suite, cascades, tmp_path, capsys, monkeypatch):
    """`diagnose` on synthetic item 1 at max_stage 1 with live capture, the
    port on the CPU and the JAX CLI on the Orbax entry of the same variables,
    both suites on the JAX nets: every loss, the grades and the captured
    keys. The JAX CLI gets the shared JAX engine (the same restore).
    Afterwards the port's engine holds no map and no flag."""
    jd, weights = suite
    monkeypatch.setattr(jdiag, "DiagnosticLosses", lambda: jd)
    monkeypatch.setattr(jax_inference, "InferenceEngine", lambda path: cascades["jax_engine"])
    monkeypatch.setattr(diagnostics, "DiagnosticLosses",
                        functools.partial(diagnostics.DiagnosticLosses, weights=weights))
    args = ["diagnose", "--synthetic", "--index", "1"]
    jax_cli.main(args + ["--checkpoint", str(cascades["jax_entry"]),
                         "--output", str(tmp_path / "jax.json")])
    capsys.readouterr()
    engines = []
    real = InferenceEngine.__init__

    def keep(self, *a, **kw):
        real(self, *a, **kw)
        engines.append(self)

    monkeypatch.setattr(InferenceEngine, "__init__", keep)
    cli.main(args + ["--checkpoint", str(cascades["port"]), "--device", "cpu",
                     "--output", str(tmp_path / "port.json")])
    printed = json.loads(capsys.readouterr().out)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert printed == got
    assert got["captured_attention"] == want["captured_attention"] == ["cross_attention"]
    assert sorted(got["losses"]) == sorted(want["losses"])
    for k in want["losses"]:
        np.testing.assert_allclose(got["losses"][k], want["losses"][k], err_msg=k,
                                   **MODEL)
    assert got["health"] == want["health"]
    assert got["losses"]["cross_attention_align"] > 0
    assert all(not m.store_attention and m.attention_weights is None
               for m in _cross_attns(engines[0].model))
