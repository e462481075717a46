"""Head dims other than 32 and 64, and ``model.attn_impl``, against the JAX
package.

The flash kernels have instances at d = 32, 64 and 128; the wrappers of
``ops/cuda/flash_attention.py`` zero-pad any other d ≤ 128 to the next of
them (``kernel_head_dim``, ``pad_head_dim``) and refuse d > 128. On the CPU
the wrappers run the plain versions, so the padded path is held here through
the helper the wrappers call (``_at_kernel_head_dim``) with the
plain versions in the kernels' place. ``dot_product_attention`` against the
JAX one with ``impl="flash"`` (Pallas in interpret mode, which pads d to
``ceil(d + 1, 128)`` lanes itself) and ``"xla"``: forward 2e-5, gradients
5e-4, fp32 (tests/test_flash_attention.py's tolerances). A scaled cascade
(tests/test_parity_cascade.py:46-47 sizes) with 2 heads of 16 against JAX at
2e-4 (tests/test_torch_cascade.py's). The kernels themselves at these head
dims run on the card: tests/test_torch_kernels.py
``test_flash_head_dims_match_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.models import ProgressiveCascadeModel as JaxCascade
from hybrid_vit_cascade_tpu.ops.attention import dot_product_attention as jax_attention
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.config import Config, validate_config
from hybrid_vit_cascade_tpu_torch.inference.infer import (
    InferenceEngine,
    build_model,
    save_checkpoint,
)
from hybrid_vit_cascade_tpu_torch.models.attention import check_head_dims, set_attn_impl
from hybrid_vit_cascade_tpu_torch.ops import attention as attn
from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa
from hybrid_vit_cascade_tpu_torch.ops.cuda import library  # noqa: F401  (the hvc:: operators)
from tests.test_torch_models import jax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
CASCADE_TOL = dict(rtol=2e-4, atol=2e-4)
S1, S2, S3 = 8, 16, 32
XR, E = 64, 32


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------- the instance and padding ---

@pytest.mark.parametrize("d,inst", [(1, 32), (8, 32), (16, 32), (31, 32), (32, 32), (33, 64),
                                    (48, 64), (64, 64), (65, 128), (96, 128), (127, 128),
                                    (128, 128)])
def test_kernel_head_dim_rule(d, inst):
    """The instance is the least of 32, 64 and 128 at or above d; padding
    appends zero lanes and leaves the rest; an instance's own d is not
    copied."""
    assert fa.HEAD_DIMS == (32, 64, 128)
    assert fa.kernel_head_dim(d) == inst
    t = torch.randn(2, 5, d)
    p = fa.pad_head_dim(t, inst)
    assert p.shape == (2, 5, inst) and p.is_contiguous()
    assert torch.equal(p[..., :d], t) and not p[..., d:].any()
    assert (p is t) == (d == inst)


@pytest.mark.parametrize("d", [0, 129, 256, 512])
def test_head_dims_over_128_refused(d):
    with pytest.raises(ValueError, match="up to 128"):
        fa.kernel_head_dim(d)


@pytest.mark.parametrize("d", [8, 16, 48, 96, 128])
def test_padded_plain_matches_unpadded(d):
    """The wrappers' padded path (q, k, v, out and dout zero-padded to the
    instance's d, the real d's scale, the outputs sliced back) with the plain
    versions in the kernels' place, against the plain versions at d: the
    forward (out, lse) and the gradients of the fused backward, of L alone
    and of M alone. Zero lanes add exact zeros, so the two differ by
    summation order only. At d = 128 nothing is padded: the same call."""
    bh, nq, nk = 3, 37, 50
    q, k, v, dout = (torch.from_numpy(a) for a in _arrays(d, (bh, nq, d), (bh, nk, d),
                                                           (bh, nk, d), (bh, nq, d)))
    scale = d ** -0.5
    want_out, want_lse = fa.flash_attention_plain(q, k, v, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, want_out, want_lse, dout, scale)
    got = fa._at_kernel_head_dim(fa.flash_attention_plain, q, k, v, scale)
    args = (q, k, v, want_out, want_lse, dout, scale)
    grads = fa._at_kernel_head_dim(fa.flash_attention_bwd_plain, *args)
    dq = fa._at_kernel_head_dim(lambda *a: fa.flash_attention_bwd_plain(*a)[0], *args)
    dkv = fa._at_kernel_head_dim(lambda *a: fa.flash_attention_bwd_plain(*a)[1:], *args)
    out, lse = got
    assert out.shape == (bh, nq, d) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6, atol=1e-6)
    for g, w in list(zip(grads, want)) + [(dq, want[0]), (dkv[0], want[1]), (dkv[1], want[2])]:
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_exported_operator_takes_any_head_dim():
    """``hvc::flash_attention_fwd`` (what ``cli export`` traces) at padded and
    unpadded head dims: torch.library's checks of the CPU and fake
    implementations."""
    for d in (16, 128):
        q, k, v = (torch.from_numpy(a) for a in _arrays(d, (2, 9, d), (2, 11, d), (2, 11, d)))
        torch.library.opcheck(torch.ops.hvc.flash_attention_fwd.default, (q, k, v, d ** -0.5))


# ----------------------------------------------- against the JAX dispatcher ---

@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("d", [16, 128])
def test_attention_matches_jax(d, impl):
    """The port's ``dot_product_attention`` (the kernels' plain versions on the
    CPU) against JAX's with the same impl: Pallas in interpret mode for
    "flash", ``_reference_attention`` for "xla"; output and the gradients of
    q, k and v under one cotangent."""
    b, h, nq, nk = 1, 2, 40, 72
    q, k, v, ct = _arrays(100 + d, (b, h, nq, d), (b, h, nk, d), (b, h, nk, d), (b, h, nq, d))
    out, vjp = jax.vjp(lambda a, b_, c: jax_attention(a, b_, c, impl=impl), jnp.asarray(q),
                       jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = attn.dot_product_attention(tq, tk, tv, impl=impl)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD_TOL)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


@pytest.fixture(scope="module")
def cascade_d16():
    """The scaled cascade with 2 heads of 16 at every stage: JAX (its XLA
    attention) on numpy variables, and the variables."""
    rng = np.random.default_rng(16)
    jm = JaxCascade(stage_sizes=(S1, S2, S3), voxel_dim=E, stage_depths=(1, 1, 1),
                    stage_heads=(2, 2, 2), xray_feature_dim=E, attn_impl="xla")
    tree, jv = jax_variables(jm, rng, jnp.zeros((1, 2, 1, XR, XR)), max_stage=3)
    xr = rng.standard_normal((1, 2, 1, XR, XR)).astype(np.float32)
    want = jax.tree.map(np.asarray, jm.apply(jv, jnp.asarray(xr), max_stage=3,
                                             return_intermediate=True, train=False))
    return tree, xr, want


def _cascade_config(heads=(2, 2, 2), attn_impl="auto", voxel_dim=E) -> Config:
    cfg = Config()
    m = cfg.model
    m.family, m.voxel_dim, m.xray_feature_dim, m.dtype = "cascade", voxel_dim, E, "float32"
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), heads, (S1, S2, S3)
    m.attn_impl = attn_impl
    cfg.data.xray_size, cfg.data.synthetic = XR, True
    return cfg


def test_cascade_head_dim_16_matches_jax(cascade_d16):
    """``build_model`` of the scaled cascade at d = 16 (the kernel path, the
    plain versions on the CPU) reconstructs every stage as JAX does."""
    tree, xr, want = cascade_d16
    model = build_model(_cascade_config())
    assert {m.head_dim for m in model.modules() if hasattr(m, "head_dim")} == {16}
    model.load_state_dict(convert.cascade(tree), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xr), return_intermediate=True, max_stage=3)
    for s, size in zip((1, 2, 3), (S1, S2, S3)):
        g = got[f"stage{s}"].numpy()
        assert g.shape == (1, 1, size, size, size)
        np.testing.assert_allclose(g, want[f"stage{s}"], err_msg=f"stage{s}", **CASCADE_TOL)


# ----------------------------------------------------------------- attn_impl ---

@pytest.mark.parametrize("impl,plain_calls", [("xla", 2), ("auto", 0), ("flash", 0)])
def test_attn_impl_reaches_its_path(cascade_d16, monkeypatch, impl, plain_calls):
    """``model.attn_impl`` from the config reaches every attention call:
    "xla" takes ``_reference_attention`` (stage 1's self- and
    cross-attention), "auto" and "flash" the kernel path; the volume is the
    same either way."""
    tree, xr, want = cascade_d16
    calls = []
    real = attn._reference_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(attn, "_reference_attention", counted)
    model = build_model(_cascade_config(attn_impl=impl))
    assert {m.attn_impl for m in model.modules() if hasattr(m, "attn_impl")} == {impl}
    model.load_state_dict(convert.cascade(tree), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xr), max_stage=1)
    assert len(calls) == plain_calls
    np.testing.assert_allclose(got.numpy(), want["stage1"], **CASCADE_TOL)


@pytest.mark.parametrize("return_probs", [False, True])
def test_flash_sharded_raises_as_jax(return_probs):
    """Without a model>1 mesh (the port has none) "flash_sharded" raises the
    JAX dispatcher's ValueError, word for word."""
    q, k, v = _arrays(3, (2, 4, 8, 16), (2, 4, 6, 16), (2, 4, 6, 16))
    with pytest.raises(ValueError) as want:
        jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash_sharded",
                      return_probs=return_probs)
    with pytest.raises(ValueError) as got:
        attn.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   impl="flash_sharded", return_probs=return_probs)
    assert str(got.value) == str(want.value)


def test_unknown_attn_impl_refused():
    """An attn_impl outside the JAX dispatcher's four fails validate_config,
    and the attention call of a model built with it."""
    cfg = _cascade_config(attn_impl="pallas")
    with pytest.raises(ValueError, match="attn_impl"):
        validate_config(cfg)
    model = build_model(cfg).eval()
    with pytest.raises(ValueError, match="impl"), torch.no_grad():
        model(torch.zeros(1, 2, 1, XR, XR), max_stage=1)
    validate_config(_cascade_config(attn_impl="xla"))


# ---------------------------------------------------- the refusal of d > 128 ---

def test_head_dims_over_128_refused_up_front(tmp_path):
    """On the card a model with a head dim over 128 on the kernel path is
    refused before its first step, naming the limit (``check_head_dims``,
    which the Trainer, the InferenceEngine and training.measure call); on
    the CPU, or with attn_impl "xla", it runs."""
    cfg = _cascade_config(heads=(1, 2, 2), voxel_dim=256)
    with torch.device("meta"):
        model = build_model(cfg)
    with pytest.raises(ValueError, match="up to 128") as err:
        check_head_dims(model, "cuda")
    assert "1 heads of 256" in str(err.value)
    check_head_dims(model, "cpu")
    check_head_dims(set_attn_impl(model, "xla"), "cuda")
    with torch.device("meta"):
        check_head_dims(build_model(_cascade_config(heads=(2, 2, 2), voxel_dim=256)), "cuda")
    save_checkpoint(tmp_path / "d256.pt", cfg, build_model(cfg))
    with pytest.raises(ValueError, match="up to 128"):
        InferenceEngine(tmp_path / "d256.pt", device="cuda")
