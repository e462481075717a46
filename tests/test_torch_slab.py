"""The port's slab-streamed chains (hybrid_vit_cascade_tpu_torch/ops/slab.py)
and chain conv ops against the JAX package, on the CPU.

- The three chain schedules (dense, 'recompute' slabs, 'streamed' under each
  storage policy) against the JAX function of the same name, on the specs
  and shapes of tests/test_slab.py: values at 2e-5, gradients of the input
  and every chain array at 5e-5, that file's tolerances.
- The plain chain conv (window, Σ/Σ² epilogue, act prologue, and its VJP
  with stats cotangents) against the JAX package's conv3d_k3s1_chain /
  conv3d_k3s2_chain, which run their Pallas kernels in interpret mode on the
  CPU, at the smallest widths their shape gates take (W 128 at stride 1,
  W 256 at stride 2).
- JAX's flat streamed body (HVC_PALLAS_INTERPRET=1, HVC_ACT_FUSE=0/1,
  HVC_GN_FOLD=1/0, set by monkeypatch as tests/test_slab.py:161-212 does)
  against the port's streamed schedule with act_fuse off/on, gn_fold on/off.
- One bf16 streamed chain against JAX's, within a few bf16 ulps.
Same numpy inputs and weights into both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.ops import slab as jslab
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3 import conv3d_k3s1_chain as jax_chain_s1
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3s2 import conv3d_k3s2_chain as jax_chain_s2
from hybrid_vit_cascade_tpu_torch.ops import slab as tslab
from hybrid_vit_cascade_tpu_torch.ops.conv3d import conv3d_chain
from tests.test_torch_models import _chain_arrays
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

VAL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)

STEM_SPEC = [("conv", 6, 1, 3, 1), ("gn", 6, 3), ("act", "gelu"),
             ("conv", 8, 6, 3, 2), ("gn", 8, 4), ("act", "silu"),
             ("conv", 12, 8, 3, 2), ("gn", 12, 4), ("act", "silu")]
DETAIL_SPEC = [("conv", 6, 1, 3, 1), ("gn", 6, 2), ("act", "gelu"),
               ("conv", 4, 6, 3, 1), ("gn", 4, 2), ("act", "gelu"),
               ("conv", 1, 4, 1, 1)]
FLAT_S1_SPEC = [("conv", 6, 1, 3, 1), ("gn", 6, 3), ("act", "gelu"),
                ("conv", 4, 6, 3, 1), ("gn", 4, 2), ("act", "gelu"),
                ("conv", 2, 4, 1, 1)]
# the three storage / dense-tail decisions of chain_apply_streamed
POLICIES = {"store_all": dict(store_min_flops=0.0, dense_max_voxels=0),
            "recompute": dict(store_min_flops=1e30, dense_max_voxels=0),
            "dense_tail": dict(store_min_flops=0.0, dense_max_voxels=8 * 8 * 8)}


def force_streaming(monkeypatch):
    """Make both packages' cascades stream their stage-3 chains at test sizes:
    at 32³ every level fits chain_apply_streamed's dense_max_voxels (129³),
    so the schedule would run its dense tail from the start. Both cascades
    look the function up at call time (the JAX module imports it inside
    __call__), so wrapping it with dense_max_voxels=0 streams every level."""
    from hybrid_vit_cascade_tpu_torch.models import cascade as tcascade

    for mod, name in ((jslab, "chain_apply_streamed"), (tcascade, "chain_apply_streamed")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(real, dense_max_voxels=0))


def _chains(rng, spec):
    chain = _chain_arrays(rng, spec)
    jchain = [tuple(jnp.asarray(p) if isinstance(p, np.ndarray) else p for p in op)
              for op in chain]
    tchain = [tuple(torch.from_numpy(p).requires_grad_() if isinstance(p, np.ndarray) else p
                    for p in op) for op in chain]
    return jchain, tchain


def _arrays(chain):
    return [p for op in chain for p in op[1:] if hasattr(p, "shape")]


def _rebuild(chain, arrs):
    it = iter(arrs)
    return [tuple(next(it) if hasattr(p, "shape") else p for p in op) for op in chain]


def _jax_run(fn, x, jchain, cot=None):
    """fn's value, and with `cot` the gradients of Σ(fn·cot) wrt x and every
    chain array."""
    xj = jnp.asarray(x)
    if cot is None:
        return np.asarray(fn(xj, jchain)), None
    arrs = _arrays(jchain)

    def loss(xv, a):
        return jnp.sum(fn(xv, _rebuild(jchain, a)) * jnp.asarray(cot))

    val = np.asarray(fn(xj, jchain))
    gx, ga = jax.grad(loss, argnums=(0, 1))(xj, arrs)
    return val, [np.asarray(gx)] + [np.asarray(g) for g in ga]


def _port_run(fn, x, tchain, cot=None):
    xt = torch.from_numpy(x).requires_grad_(cot is not None)
    out = fn(xt, tchain)
    if cot is None:
        return out.detach().numpy(), None
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt] + _arrays(tchain))
    return out.detach().numpy(), [g.numpy() for g in grads]


SCHEDULES = [  # (name, spec, shape, num_slabs, policy, gradients)
    ("dense", DETAIL_SPEC, (1, 1, 16, 8, 8), None, None, False),
    ("slab", STEM_SPEC, (1, 1, 16, 8, 8), 4, None, False),
    ("slab", DETAIL_SPEC, (1, 1, 16, 8, 8), 4, None, True),
    ("slab", STEM_SPEC, (2, 1, 32, 8, 8), 8, None, False),
    ("slab", DETAIL_SPEC, (1, 1, 12, 8, 8), 8, None, False),  # 12 % 8: clamps to 4
    ("streamed", DETAIL_SPEC, (1, 1, 16, 8, 8), 4, "store_all", True),
    ("streamed", STEM_SPEC, (1, 1, 16, 8, 8), 4, "recompute", True),
    ("streamed", STEM_SPEC, (2, 1, 32, 8, 8), 8, "dense_tail", False),
    ("streamed", DETAIL_SPEC, (1, 1, 12, 8, 8), 8, "store_all", False),  # clamps to 4
    ("streamed", DETAIL_SPEC, (1, 1, 16, 8, 8), 4, "dense_tail", False),
    ("streamed", STEM_SPEC, (2, 1, 32, 8, 8), 8, "recompute", False),  # B=2: no GN fold
]


@pytest.mark.parametrize("name,spec,shape,n,policy,grads", SCHEDULES)
def test_chain_schedule_matches_jax(rng, name, spec, shape, n, policy, grads):
    jchain, tchain = _chains(rng, spec)
    x = rng.standard_normal(shape).astype(np.float32)
    if name == "dense":
        jfn, tfn = jslab.chain_apply_dense, tslab.chain_apply_dense
    elif name == "slab":
        jfn = lambda v, c: jslab.chain_apply_slab(v, c, n)  # noqa: E731
        tfn = lambda v, c: tslab.chain_apply_slab(v, c, n)  # noqa: E731
    else:
        kw = POLICIES[policy]
        jfn = lambda v, c: jslab.chain_apply_streamed(v, c, n, **kw)  # noqa: E731
        tfn = lambda v, c: tslab.chain_apply_streamed(v, c, n, **kw)  # noqa: E731
    out_shape = jax.eval_shape(lambda v: jslab.chain_apply_dense(v, jchain), x).shape
    cot = rng.standard_normal(out_shape).astype(np.float32) if grads else None
    want, want_g = _jax_run(jfn, x, jchain, cot)
    got, got_g = _port_run(tfn, x, tchain, cot)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **VAL_TOL)
    if grads:
        assert len(got_g) == len(want_g) == 1 + len(_arrays(tchain))
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"gradient {i}")


# ------------------------------------------------------------ chain conv ops ---

# The JAX kernels' gelu uses _erf_f32 (A&S 7.1.28, |error| ≤ 3e-7 in erf),
# the port's plain version torch.erf: ≤ ~1e-6 apart in act(x) for the inputs
# here, and the products sum 27·Cin of them. The rest is summation order:
# the tolerances of tests/test_pallas_conv.py widened to cover that.
OP_TOL = dict(rtol=1e-4, atol=2e-5)
VJP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride,window,want_sums,act", [
    (1, "front", True, None),    # planes before vlo zeroed, Σ/Σ² epilogue
    (1, "back", True, "gelu"),   # planes from vhi on zeroed, gelu prologue
    (1, "both", False, "silu"),
    (2, "front", True, "silu"),
    (2, "back", True, None),
    (2, "both", False, "gelu"),
])
def test_chain_conv_matches_jax(rng, stride, window, want_sums, act):
    B, cin, cout, H, W = 1, 2, 3, 4, 128 * stride
    dext = 5  # slab planes: 3 outputs at stride 1, 2 at stride 2
    vlo, vhi = {"front": (1, dext), "back": (0, dext - 1), "both": (1, dext - 2)}[window]
    d_out = dext - 2 if stride == 1 else (dext - 1) // 2
    x = rng.standard_normal((B, cin, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ho, wo = H // stride, W // stride
    g = rng.standard_normal((B, cout, d_out * ho * wo)).astype(np.float32)
    gs = [rng.standard_normal((B, cout)).astype(np.float32) for _ in range(2)]

    jfn = jax_chain_s1 if stride == 1 else jax_chain_s2
    meta = (dext, H, W, want_sums, act)
    win = jnp.asarray([vlo, vhi], jnp.int32)
    res, vjp = jax.vjp(lambda xf, wv, bv: jfn(meta, xf, win, wv, bv),
                       jnp.asarray(x.reshape(B, cin, -1)), jnp.asarray(w), jnp.asarray(b))
    want = [np.asarray(r) for r in (res if want_sums else (res,))]
    ct = (jnp.asarray(g), jnp.asarray(gs[0]), jnp.asarray(gs[1])) if want_sums else jnp.asarray(g)
    want_dx, want_dw, want_db = (np.asarray(t) for t in vjp(ct))

    xt = torch.from_numpy(x).requires_grad_()
    wt, bt = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = conv3d_chain(xt.narrow(2, vlo, vhi - vlo), wt, bt, stride, vlo, d_out, want_sums, act)
    got = got if want_sums else (got,)
    np.testing.assert_allclose(got[0].detach().numpy().reshape(B, cout, -1), want[0], **OP_TOL)
    for s_got, s_want in zip(got[1:], want[1:]):  # sums over d_out·ho·wo outputs
        np.testing.assert_allclose(s_got.detach().numpy(), s_want, rtol=1e-4, atol=1e-3)
    outs = [got[0].reshape(B, cout, -1)] + list(got[1:])
    cots = [torch.from_numpy(g)] + ([torch.from_numpy(t) for t in gs] if want_sums else [])
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    dx, dw, db = torch.autograd.grad(loss, (xt, wt, bt))
    np.testing.assert_allclose(dx.numpy().reshape(B, cin, -1), want_dx, **VJP_TOL)
    np.testing.assert_allclose(dw.numpy(), want_dw, **VJP_TOL)
    np.testing.assert_allclose(db.numpy(), want_db, **VJP_TOL)


# ------------------------------------------------- the flat streamed body ---

@pytest.mark.parametrize("act_fuse,gn_fold", [pytest.param("0", "1", id="0"),
                                              pytest.param("1", "1", id="1"),
                                              pytest.param("0", "0", id="0-nofold")])
def test_flat_streamed_body_matches_jax(rng, monkeypatch, act_fuse, gn_fold):
    """JAX's TPU-only body (Pallas chain kernels in interpret mode, conv→GN
    fold, in-kernel stats, optional act prologue) against the port's
    streamed schedule with the same switches (HVC_ACT_FUSE / HVC_GN_FOLD
    there, act_fuse / gn_fold here): values, and with the fused prologue
    (whose VJP runs the act′ epilogue) or without the fold (the GroupNorm
    affine stays in the body) the gradients too."""
    jchain, tchain = _chains(rng, FLAT_S1_SPEC)
    x = rng.standard_normal((1, 1, 8, 4, 128)).astype(np.float32)
    grads = act_fuse == "1" or gn_fold == "0"
    cot = rng.standard_normal((1, 2, 8, 4, 128)).astype(np.float32) if grads else None
    kw = POLICIES["store_all"]
    monkeypatch.setenv("HVC_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("HVC_ACT_FUSE", act_fuse)
    monkeypatch.setenv("HVC_GN_FOLD", gn_fold)
    want, want_g = _jax_run(lambda v, c: jslab.chain_apply_streamed(v, c, 4, **kw),
                            x, jchain, cot)
    got, got_g = _port_run(
        lambda v, c: tslab.chain_apply_streamed(v, c, 4, act_fuse=act_fuse == "1",
                                                gn_fold=gn_fold == "1", **kw),
        x, tchain, cot)
    assert (got_g is None) == (not grads)
    np.testing.assert_allclose(got, want, **VAL_TOL)
    for i, (g, w) in enumerate(zip(got_g or [], want_g or [])):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"gradient {i}")


# ----------------------------------------------------------------- bf16 ---

def test_streamed_bf16_matches_jax(rng):
    """bf16 chain, 4 slabs, store-all: the two packages round at other
    places (the port's GroupNorm is the affine of the flat body, JAX's CPU
    body normalises by group; XLA may keep a fused elementwise chain in fp32),
    so they agree to a few bf16 ulps of the output's scale, not bitwise."""
    jchain, tchain = _chains(rng, DETAIL_SPEC)
    x = rng.standard_normal((1, 1, 16, 8, 8)).astype(np.float32)
    kw = POLICIES["store_all"]
    want = np.asarray(jslab.chain_apply_streamed(jnp.asarray(x), jchain, 4, dtype=jnp.bfloat16,
                                                 **kw).astype(jnp.float32))
    with torch.no_grad():
        got = tslab.chain_apply_streamed(torch.from_numpy(x), tchain, 4, dtype=torch.bfloat16,
                                         **kw)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.abs(want).max()  # one bf16 ulp at the output's largest value
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 4 * ulp, (err.max(), ulp)
    assert err.mean() <= 0.25 * ulp
