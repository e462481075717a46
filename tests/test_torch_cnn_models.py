"""The port's CNN decoder family and its loss against the JAX package, with
converted weights: the two views-as-channels encoders, every block of
``models/cnn_models.py`` and ``depth_modulated_broadcast`` at small shapes
(rtol/atol 2e-5, the tolerance of tests/test_parity_cnn_blocks.py); the
three decoders at full size by shape (the port on the meta device, JAX by
``jax.eval_shape``: their 128³ / 256³ forwards are too slow for the CPU, as
tests/test_models.py:170-171 finds) and by a converted state dict loading
``strict=True``; the transfer counts of ``shape_matched_transfer``;
each decoder's composition at a 2³ seed, the JAX ``__call__`` run with its
seed and broadcast sizes cut to match; ``group_norm_flax`` over several
group slices against plain autograd; ``Direct256Loss`` at 16³ (every
component and the total, both FFT branches, the non-finite fallback);
``Trainer.fit`` and ``cli transfer`` on a decoder. Value parity of a whole
decoder at full size is the one ``slow`` test here."""

import contextlib
import copy
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.losses import direct256 as jd
from hybrid_vit_cascade_tpu.losses.direct256 import Direct256Loss as JaxLoss
from hybrid_vit_cascade_tpu.models import cnn_models as jcm
from hybrid_vit_cascade_tpu.models import encoders as jenc
from hybrid_vit_cascade_tpu.ops import resize as jres
from hybrid_vit_cascade_tpu.training.checkpoint import shape_matched_transfer as jax_transfer
from hybrid_vit_cascade_tpu_torch import cli, convert
from hybrid_vit_cascade_tpu_torch.config import Config
from hybrid_vit_cascade_tpu_torch.inference.infer import InferenceEngine, save_checkpoint
from hybrid_vit_cascade_tpu_torch.losses import direct256 as d256
from hybrid_vit_cascade_tpu_torch.losses.direct256 import Direct256Loss, get_loss_summary_string
from hybrid_vit_cascade_tpu_torch.models import cnn_models as cm
from hybrid_vit_cascade_tpu_torch.models import encoders as enc
from hybrid_vit_cascade_tpu_torch.ops import conv3d, resize
from hybrid_vit_cascade_tpu_torch.training import trainer as trainer_mod
from hybrid_vit_cascade_tpu_torch.training.checkpoint import load_entry, shape_matched_transfer
from tests.test_torch_models import jax_variables, random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
FULL_XR = (1, 2, 1, 512, 512)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _cl(a):  # NCDHW → NDHWC
    return jnp.asarray(np.moveaxis(a, 1, -1))


def _to_ncdhw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _small_seed(model, edge=2):
    """The decoder with its seed volume cut to edge³ (nothing else in its
    forward fixes the size): the output is its scale × edge."""
    c = model.initial_volume.shape[1]
    model.initial_volume = torch.nn.Parameter(0.02 * torch.randn(1, c, edge, edge, edge))
    return model


@pytest.mark.parametrize("name", ["simple", "b200"])
def test_encoder_matches_jax(rng, name):
    xr = rng.standard_normal((2, 2, 1, 64, 64)).astype(np.float32)
    jm, tm = ((jenc.SimpleXrayEncoder(feature_dim=40), enc.SimpleXrayEncoder(40))
              if name == "simple" else (jenc.XRayEncoderB200(), enc.XRayEncoderB200()))
    tree, jv = jax_variables(jm, rng, jnp.asarray(xr))
    want = _to_ncdhw(jax.jit(jm.apply)(jv, jnp.asarray(xr)))
    tm.load_state_dict(convert.flax_tree(tree["params"]), strict=True)
    with torch.no_grad():
        got = tm(_t(xr)).numpy()
    assert got.shape == want.shape == (2, 40 if name == "simple" else 128, 4, 4)
    np.testing.assert_allclose(got, want, **TOL)


# (JAX module, port module, input channels and size, second input)
BLOCKS = {
    "rdb": (lambda: jcm.ResidualDenseBlock(growth_rate=12, num_layers=3),
            lambda: cm.ResidualDenseBlock(16, 12, 3), (16, 6)),
    "cbam": (lambda: jcm.CBAM(reduction=4), lambda: cm.CBAM(16, 4), (16, 8)),
    "upconv_gelu_rdb": (lambda: jcm.UpConvStage(24, 8, rdbs=((8, 2), (6, 3))),
                        lambda: cm.UpConvStage(5, 24, 8, ((8, 2), (6, 3))), (5, 4)),
    "upconv_relu": (lambda: jcm.UpConvStage(16, 4, act="relu"),
                    lambda: cm.UpConvStage(3, 16, 4, act="relu"), (3, 5)),
    "fusion": (lambda: jcm.XrayFusion(40), lambda: cm.XrayFusion(16 + 12, 40), (16, 6)),
    "fusion_bare": (lambda: jcm.XrayFusion(8, bare_conv=True),
                    lambda: cm.XrayFusion(16 + 12, 8, bare_conv=True), (16, 6)),
    "skip_k3_gn": (lambda: jcm.SkipProj(2, 16, 3, 4), lambda: cm.SkipProj(6, 2, 16, 3, 4), (6, 4)),
    "skip_k1": (lambda: jcm.SkipProj(4, 8, 1, None), lambda: cm.SkipProj(6, 4, 8, 1, None),
                (6, 3)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(rng, name):
    make_jax, make_port, (c, s) = BLOCKS[name]
    x = rng.standard_normal((2, c, s, s, s)).astype(np.float32)
    args = [x]
    if name.startswith("fusion"):
        args.append(rng.standard_normal((2, 12, s, s, s)).astype(np.float32))
    jm, tm = make_jax(), make_port()
    tree, jv = jax_variables(jm, rng, *map(_cl, args))
    want = _to_ncdhw(jax.jit(jm.apply)(jv, *map(_cl, args)))
    tm.load_state_dict(convert.flax_tree(tree["params"]), strict=True)
    with torch.no_grad():
        got = tm(*map(_t, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("modulate,dtype", [(True, "float32"), (False, "float32"),
                                            (True, "bfloat16")])
def test_depth_modulated_broadcast_matches_jax(rng, modulate, dtype):
    f = rng.standard_normal((2, 5, 6, 6)).astype(np.float32)
    want = jcm.depth_modulated_broadcast(jnp.asarray(np.moveaxis(f, 1, -1)).astype(dtype), 16,
                                         modulate)
    got = cm.depth_modulated_broadcast(_t(f).to(getattr(torch, dtype)), 16, modulate)
    assert got.shape == (2, 5, 16, 16, 16) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _to_ncdhw(want.astype(jnp.float32)),
                               **(TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)))


@pytest.mark.parametrize("scale,slabs", [(2, 1), (8, 3)])
def test_upsample_vjp_matches_jax(rng, monkeypatch, scale, slabs):
    """The decoders' trilinear ×scale upsample and its VJP, fp32, against
    JAX's ``resize_trilinear`` (the JAX decoders' resize) and its VJP; the
    backward in ``slabs`` slabs of the gradient (RESIZE_CHUNK_BYTES cut)."""
    x = rng.standard_normal((2, 3, 4, 3, 5)).astype(np.float32)
    size = tuple(scale * n for n in x.shape[2:])
    g = rng.standard_normal((2, 3, *size)).astype(np.float32)
    monkeypatch.setattr(resize, "RESIZE_CHUNK_BYTES", 4 * int(np.prod(size)) * (6 // slabs))
    want, vjp = jax.vjp(lambda a: jres.resize_trilinear(a, size, align_corners=False),
                        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = cm._upsample(xt, scale, torch.float32)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


@pytest.mark.parametrize("modulate", [True, False])
def test_depth_modulated_broadcast_vjp_matches_jax(rng, modulate):
    """``depth_modulated_broadcast``'s VJP (its bilinear resize, then the
    broadcast along depth), fp32, against JAX's."""
    f = rng.standard_normal((2, 5, 6, 6)).astype(np.float32)
    g = rng.standard_normal((2, 5, 16, 16, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jcm.depth_modulated_broadcast(a, 16, modulate),
                     jnp.asarray(np.moveaxis(f, 1, -1)))
    want = np.moveaxis(np.asarray(vjp(_cl(g))[0]), -1, 1)
    ft = _t(f).requires_grad_(True)
    cm.depth_modulated_broadcast(ft, 16, modulate).backward(_t(g))
    np.testing.assert_allclose(ft.grad.numpy(), want, **TOL)


# ------------------------------------------------------- decoders, full size ---

DECODERS = {
    "direct128_h200": (jcm.Direct128ModelH200, cm.Direct128ModelH200, 128),
    "direct256_h200": (jcm.Direct256ModelH200, cm.Direct256ModelH200, 256),
    "direct256_b200": (jcm.Direct256ModelB200, cm.Direct256ModelB200, 256),
}
_TREES: dict = {}


def decoder_tree(family: str):
    """(numpy variables, output shape) of the full-size JAX decoder: init
    and forward traced for shapes only, variables drawn from numpy."""
    if family not in _TREES:
        jm = DECODERS[family][0]()
        xr = jax.ShapeDtypeStruct(FULL_XR, jnp.float32)
        out, template = jax.eval_shape(lambda x: jm.init_with_output(jax.random.PRNGKey(0), x), xr)
        _TREES[family] = (random_variables(template, np.random.default_rng(7)), tuple(out.shape))
    return _TREES[family]


@pytest.mark.parametrize("family", sorted(DECODERS))
def test_decoder_shapes_and_strict_state_dict(family):
    tree, jax_out = decoder_tree(family)
    port_cls, size = DECODERS[family][1:]
    model = port_cls()
    sd = convert.cnn_decoder(tree)
    model.load_state_dict(sd, strict=True)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    with torch.device("meta"):
        out = port_cls()(torch.empty(FULL_XR))
    assert tuple(out.shape) == jax_out == (1, 1, size, size, size)


# (JAX decoder, port decoder, the JAX seed's edge) at narrower X-ray
# features and fewer RDBs where the decoder takes them
SMALL_DECODERS = {
    "direct128_h200": (lambda: jcm.Direct128ModelH200(xray_feature_dim=24, num_rdb=2),
                       lambda: cm.Direct128ModelH200(24, num_rdb=2), 16),
    "direct256_h200": (lambda: jcm.Direct256ModelH200(xray_feature_dim=24, num_rdb=2),
                       lambda: cm.Direct256ModelH200(24, num_rdb=2), 32),
    "direct256_b200": (jcm.Direct256ModelB200, cm.Direct256ModelB200, 16),
}


@contextlib.contextmanager
def _jax_seed_edge(full: int, edge: int = 2):
    """The JAX decoders' ``__call__`` with a seed of edge³: it fixes the
    seed's shape (``self.param`` and ``jnp.broadcast_to``) and each scale's
    X-ray broadcast size, so those three are cut by full / edge and nothing
    else of the call changes."""
    k = full // edge
    broadcast = jcm.depth_modulated_broadcast

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def broadcast_to(a, shape):
            if a.ndim == 5 and a.shape[:4] == (1, edge, edge, edge):  # the seed
                shape = (shape[0], edge, edge, edge, shape[4])
            return jnp.broadcast_to(a, shape)

    def normal(stddev):
        return lambda key, shape, dtype=jnp.float32: stddev * jax.random.normal(
            key, (1, edge, edge, edge, shape[-1]), dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcm, "jnp", _Jnp())
        mp.setattr(jcm.nn.initializers, "normal", normal)
        mp.setattr(jcm, "depth_modulated_broadcast", lambda f, size, m: broadcast(f, size // k, m))
        yield


@pytest.mark.parametrize("family", sorted(SMALL_DECODERS))
def test_decoder_composition_matches_jax(rng, family):
    """Each decoder's whole forward at a 2³ seed (16³ out, the B200's 32³),
    fp32, against the JAX ``__call__`` on the same converted variables: which
    skip feeds which projection, the concat orders, where CBAM sits."""
    make_jax, make_port, full = SMALL_DECODERS[family]
    xr = rng.uniform(-1, 1, (2, 2, 1, 64, 64)).astype(np.float32)
    jm = make_jax()
    with _jax_seed_edge(full):
        tree, jv = jax_variables(jm, rng, jnp.asarray(xr))
        want = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(xr)))
    tm = _small_seed(make_port())
    tm.load_state_dict(convert.cnn_decoder(tree), strict=True)
    with torch.no_grad():
        got = tm(_t(xr)).numpy()
    edge = 32 if family == "direct256_b200" else 16
    assert got.shape == want.shape == (2, 1, edge, edge, edge)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _group_norm_autograd(x, scale, bias, groups, dtype):
    """flax GroupNorm as group_norm_flax computed it before its own backward:
    one pass over every group, differentiated by autograd."""
    B, C = x.shape[:2]
    xr = x.float().reshape(B, groups, C // groups, *x.shape[2:])
    red = tuple(range(2, xr.dim()))
    mean = xr.mean(dim=red, keepdim=True)
    var = ((xr * xr).mean(dim=red, keepdim=True) - mean * mean).clamp_min(0.0)
    cshape = (1, groups, C // groups) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + 1e-5) * scale.float().reshape(cshape)
    y = (xr - mean) * mul + bias.float().reshape(cshape)
    return y.reshape(x.shape).to(dtype)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_flax_slices_match_autograd(rng, monkeypatch, dtype, channels_last):
    """GN_CHUNK_BYTES cut so that 7 groups go in slices of 3, 3 and 1: the
    output, dx, dscale and dbias against plain autograd of the one-pass
    formula, on NCDHW and channels-last input."""
    B, C, G, S = 2, 28, 7, 5
    monkeypatch.setattr(conv3d, "GN_CHUNK_BYTES", 3 * 4 * B * (C // G) * S ** 3)
    dt = getattr(torch, dtype)
    x0 = (torch.from_numpy(rng.standard_normal((B, C, S, S, S)).astype(np.float32)) * 2 + 0.5)
    x0 = x0.to(dt)
    gy = torch.from_numpy(rng.standard_normal((B, C, S, S, S)).astype(np.float32)).to(dt)
    if channels_last:
        x0 = x0.contiguous(memory_format=torch.channels_last_3d)
        gy = gy.contiguous(memory_format=torch.channels_last_3d)
    sb0 = torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
    sb0[0] += 1
    results = []
    for fn in (conv3d.group_norm_flax, _group_norm_autograd):
        x = x0.clone().requires_grad_(True)
        scale, bias = (sb0[i].clone().requires_grad_(True) for i in (0, 1))
        y = fn(x, scale, bias, G, dt)
        y.backward(gy)
        results.append((y, x.grad, scale.grad, bias.grad))
    for name, got, want in zip(("y", "dx", "dscale", "dbias"), *results):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        torch.testing.assert_close(got, want, msg=name)


@pytest.mark.parametrize("src,dst,some", [("direct128_h200", "direct256_h200", True),
                                          ("direct128_h200", "direct256_b200", False)])
def test_transfer_counts_match_jax(src, dst, some):
    """Transferred and skipped counts, port state dicts against JAX trees (the
    B200 decoder shares no name and shape with the 128³ one in either)."""
    (src_tree, _), (dst_tree, _) = decoder_tree(src), decoder_tree(dst)
    _, *want = jax_transfer(dst_tree["params"], src_tree["params"])
    params = dict(convert.cnn_decoder(dst_tree))
    _, *got = shape_matched_transfer(params, convert.cnn_decoder(src_tree))
    assert got == want and (want[0] > 0) == some and want[1] > 0


# --------------------------------------------------------------- the loss ---

@pytest.fixture(scope="module")
def losses():
    """The JAX loss with its three nets' variables drawn from numpy (flax's
    init traced for shapes only, biases non-zero), and the port's loss on
    them converted."""
    rng = np.random.default_rng(3)

    def numpy_init(self, key, x):
        template = jax.eval_shape(lambda: nn.Module.init(self, key, x))
        return jax.tree.map(jnp.asarray, random_variables(template, rng))

    with pytest.MonkeyPatch.context() as mp:
        for net in (jd._PyramidFeatureNet, jd._StyleFeatureNet, jd._AttentionNet):
            mp.setattr(net, "init", numpy_init)
        jl = JaxLoss()
    tl = Direct256Loss(weights=convert.direct256_nets(jl._pyr_vars, jl._style_vars,
                                                      jl._attn_vars))
    return jl, tl


def _jax_call(jl, pred, target):
    return jax.jit(lambda a, b: jl(a, b))(jnp.asarray(pred), jnp.asarray(target))


@pytest.mark.parametrize("shape", [(2, 1, 16, 16, 16), (1, 1, 15, 16, 13)])
def test_direct256_loss_matches_jax(losses, rng, shape):
    """Every component and the total: the rfft half-spectrum branch of the
    focal frequency loss at even sizes, the full spectrum at odd ones."""
    jl, tl = losses
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = (0.7 * target + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    want = _jax_call(jl, pred, target)
    got = tl(_t(pred), _t(target))
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL, err_msg=k)
    line = get_loss_summary_string(got)
    assert line.startswith("Loss: ") and line.count("|") == 7


# the even shape of test_direct256_loss_matches_jax only: the odd one's
# values are held there, and each shape costs one more compile of JAX's
# gradient of the whole loss
@pytest.mark.parametrize("shape", [(2, 1, 16, 16, 16)])
def test_direct256_loss_grad_matches_jax(losses, rng, monkeypatch, shape):
    """The total loss's gradient with respect to the prediction (the focal
    loss's rfft half-spectrum branch, a batch of two) against ``jax.grad``
    of JAX's loss, with the nets' layers recomputed in the backward
    (``remat``) and without: the two bitwise equal, with the GroupNorms in
    one chunk of groups and in chunks of two; and with ``remat`` the convs
    cut into parts of 5 output channels, as a 256³ map of 128 channels is
    (CONV_OUT_LIMIT)."""
    jl, tl = losses
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = (0.7 * target + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda a, b: jl(a, b)["total_loss"]))(
        jnp.asarray(pred), jnp.asarray(target)))
    for chunk in (conv3d.GN_CHUNK_BYTES, 2 * 4 * int(np.prod(shape)) * 4):
        monkeypatch.setattr(conv3d, "GN_CHUNK_BYTES", chunk)
        grads = []
        for remat in (False, True):
            p = _t(pred).requires_grad_(True)
            whole = Direct256Loss(weights=tl._nets, remat=remat)(p, _t(target))
            whole["total_loss"].backward()
            grads.append(p.grad)
        assert torch.equal(grads[0], grads[1]), chunk
        np.testing.assert_allclose(grads[1].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    monkeypatch.setattr(d256, "CONV_OUT_LIMIT", 5 * int(np.prod(shape)))
    p = _t(pred).requires_grad_(True)
    loss = Direct256Loss(weights=tl._nets, remat=True)(p, _t(target))
    loss["total_loss"].backward()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    for k, v in whole.items():
        np.testing.assert_allclose(float(loss[k].detach()), float(v.detach()), **LOSS_TOL,
                                   err_msg=k)


def test_direct256_loss_fallback(losses, rng):
    """A non-finite total falls back to L1 + SSIM + TV in both packages."""
    jl, tl = losses
    inf = float("inf")
    jl_inf = copy.copy(jl)
    jl_inf.w = {**jl.w, "focal": inf}
    tl_inf = Direct256Loss(focal_freq_weight=inf, weights=tl._nets)
    target = rng.uniform(-1, 1, (1, 1, 16, 16, 16)).astype(np.float32)
    pred = rng.uniform(-1, 1, target.shape).astype(np.float32)
    want = _jax_call(jl_inf, pred, target)
    got = tl_inf(_t(pred), _t(target))
    fallback = float(got["l1_loss"] + got["ssim_loss"] + got["tv_loss"])
    assert np.isfinite(fallback) and float(got["total_loss"]) == pytest.approx(fallback)
    np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), **LOSS_TOL)


# ------------------------------------------------------ training, transfer ---

def _decoder_cfg(tmp_path, family="direct128_h200") -> Config:
    cfg = Config.from_json(f"configs/{family}.json" if family != "direct256_h200"
                           else "configs/direct128_h200.json")
    cfg.model.family, cfg.model.dtype = family, "float32"
    cfg.data.synthetic, cfg.data.synthetic_patients, cfg.data.xray_size = True, 3, 64
    cfg.data.train_split, cfg.data.val_split = 0.67, 0.34
    cfg.training.num_epochs, cfg.training.batch_size = 1, 2
    cfg.checkpoints.save_dir = str(tmp_path / "run")
    return cfg


def test_fit_trains_a_cnn_decoder(tmp_path, monkeypatch):
    """Trainer.fit's single-model branch on Direct128ModelH200 with its seed
    cut to 2³ (16³ out, 16³ phantoms): Direct256Loss, the remat'd upsample
    stages, every parameter trained, the entries and a resume that trains
    nothing."""
    cfg = _decoder_cfg(tmp_path)
    monkeypatch.setattr(trainer_mod, "build_model", lambda c: _small_seed(cm.Direct128ModelH200(
        16, num_rdb=1)))
    monkeypatch.setattr(trainer_mod, "data_volume_size", lambda c: (16, 16, 16))
    tr = trainer_mod.Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    metrics = tr.fit()
    assert sorted(metrics) == ["loss", "psnr", "ssim"] and all(np.isfinite(list(metrics.values())))
    after = tr.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    run = tmp_path / "run"
    for entry in ("latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"):
        assert (run / entry / "checkpoint.pt").exists(), entry
    rows = (run / "training_log.jsonl").read_text().splitlines()
    assert [json.loads(r)["phase"] for r in rows] == ["train"]
    assert trainer_mod.Trainer(cfg, device="cpu").fit() == {}  # resumed at its last epoch
    assert len((run / "training_log.jsonl").read_text().splitlines()) == 1


def test_cli_transfer_decoder(tmp_path, capsys):
    """``cli transfer --init-only`` from a full-size Direct128ModelH200 file
    into direct256_h200: the counts JAX's shape_matched_transfer gives on the
    same trees, the transferred tensors the source's, the entry written at
    epoch −1 and loaded by InferenceEngine."""
    src_tree, _ = decoder_tree("direct128_h200")
    src_cfg = _decoder_cfg(tmp_path)
    src = cm.Direct128ModelH200()
    src.load_state_dict(convert.cnn_decoder(src_tree), strict=True)
    save_checkpoint(tmp_path / "src.pt", src_cfg, src)
    dst_cfg = _decoder_cfg(tmp_path, "direct256_h200")
    (tmp_path / "dst.json").write_text(json.dumps(dst_cfg.to_dict()))
    cli.main(["transfer", "--from-checkpoint", str(tmp_path / "src.pt"), "--init-only",
              "--config", str(tmp_path / "dst.json"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    _, n, skipped = jax_transfer(decoder_tree("direct256_h200")[0]["params"], src_tree["params"])
    assert line.startswith(f"transfer: {n} leaves transferred, {skipped} skipped")
    tree, meta = load_entry(tmp_path / "run" / "latest")
    assert meta["epoch"] == -1 and not (tmp_path / "run" / "latest_opt").exists()
    moved = [k for k, v in src.state_dict().items()
             if k in tree["state_dict"] and tree["state_dict"][k].shape == v.shape]
    assert len(moved) == n and all(torch.equal(tree["state_dict"][k], src.state_dict()[k])
                                   for k in moved)
    engine = InferenceEngine(tmp_path / "run" / "latest", device="cpu")
    assert isinstance(engine.model, cm.Direct256ModelH200)


def test_remat_changes_no_value(rng):
    """With remat the stages and every RDB recompute in the backward, and
    the 256³ decoders' top scale (the H200's fusion, the B200's last
    upsample stage with the fusion after it; each skip projection, the
    concat's 1×1 fusion, the head) in regions of its own: the loss and every
    gradient are the ones without it. (The B200 decoder, at full width, from
    a 1³ seed: a 16³ output.)"""
    xr = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 1, 32, 32)).astype(np.float32))
    for make, edge in ((lambda remat: cm.Direct128ModelH200(8, num_rdb=1, remat=remat), 2),
                       (lambda remat: cm.Direct256ModelH200(8, num_rdb=1, remat=remat), 2),
                       (lambda remat: cm.Direct256ModelB200(remat=remat), 1)):
        losses, grads = [], []
        for remat in (False, True):
            torch.manual_seed(0)
            model = _small_seed(make(remat), edge)
            loss = model(xr, train=True).square().mean()
            loss.backward()
            losses.append(loss.detach())
            grads.append({n: p.grad for n, p in model.named_parameters()})
        assert sorted(grads[0]) == sorted(grads[1]) and torch.equal(*losses)
        for n, g in grads[0].items():
            torch.testing.assert_close(grads[1][n], g, rtol=1e-5, atol=1e-7, msg=n)


@pytest.mark.slow
def test_direct128_value_parity(rng):
    """Direct128ModelH200(xray_feature_dim=32, num_rdb=1) at full size, fp32,
    against JAX: a 128³ CPU forward in each package."""
    jm = jcm.Direct128ModelH200(xray_feature_dim=32, num_rdb=1, remat=False)
    xr = rng.standard_normal((1, 2, 1, 128, 128)).astype(np.float32)
    tree, jv = jax_variables(jm, rng, jnp.asarray(xr))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(jv, jnp.asarray(xr)))
    tm = cm.Direct128ModelH200(32, num_rdb=1)
    tm.load_state_dict(convert.cnn_decoder(tree), strict=True)
    with torch.no_grad():
        got = tm(_t(xr)).numpy()
    assert got.shape == want.shape == (1, 1, 128, 128, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
