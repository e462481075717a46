"""Ops of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its port; on a CPU
tensor the port's kernel wrappers run their plain PyTorch versions. The
Pallas flash kernel runs in interpret mode, as tests/test_flash_attention.py
runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.ops.attention import _reference_attention
from hybrid_vit_cascade_tpu.ops.attention import dot_product_attention as jax_attention
from hybrid_vit_cascade_tpu.ops.conv3d import group_norm_core as jax_group_norm
from hybrid_vit_cascade_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from hybrid_vit_cascade_tpu.ops.pool import max_pool_nd as jax_max_pool
from hybrid_vit_cascade_tpu.ops.resize import resize_trilinear as jax_resize
from hybrid_vit_cascade_tpu.ops.slab import conv3d_ncdhw as jax_conv3d
from hybrid_vit_cascade_tpu_torch.ops.attention import dot_product_attention
from hybrid_vit_cascade_tpu_torch.ops.conv3d import conv1x1_ncdhw, conv3d_ncdhw, group_norm_core
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build, launch_counts
from hybrid_vit_cascade_tpu_torch.ops.cuda.conv3d_k3 import conv3d_k3, conv3d_k3_plain
from hybrid_vit_cascade_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd,
    flash_attention_plain,
)
from hybrid_vit_cascade_tpu_torch.ops.pool import max_pool_nd
from hybrid_vit_cascade_tpu_torch.ops.resize import resize_bilinear, resize_trilinear
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out", [(10, 12, 14), (3, 4, 5), (5, 12, 7)])
def test_resize_matches_jax(rng, align_corners, out):
    x = _f32(rng, (2, 3, 5, 6, 7))
    want = np.asarray(jax_resize(jnp.asarray(x), out, align_corners=align_corners))
    got = resize_trilinear(torch.from_numpy(x), out, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out", [(10, 12, 14), (3, 4, 5), (5, 12, 7)])
def test_resize_backward_matches_jax(rng, align_corners, out):
    """The resize's backward (the interpolation matrices transposed, a fixed
    order of adds) against JAX's VJP and against ``F.interpolate``'s own
    backward in float64."""
    import jax

    x, g = _f32(rng, (2, 3, 5, 6, 7)), _f32(rng, (2, 3, *out))
    _, vjp = jax.vjp(lambda v: jax_resize(v, out, align_corners=align_corners), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    resize_trilinear(xt, out, align_corners=align_corners).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    torch.nn.functional.interpolate(x64.reshape(6, 1, 5, 6, 7), size=out, mode="trilinear",
                                    align_corners=align_corners).backward(
        torch.from_numpy(g).double().reshape(6, 1, *out))
    np.testing.assert_allclose(xt.grad.numpy(), x64.grad.numpy().reshape(x.shape), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_bilinear_backward_is_interpolate_backward(rng, align_corners):
    x, g = _f32(rng, (2, 3, 7, 9)), _f32(rng, (2, 3, 12, 4))
    xt = torch.from_numpy(x).requires_grad_(True)
    resize_bilinear(xt, (12, 4), align_corners=align_corners).backward(torch.from_numpy(g))
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    torch.nn.functional.interpolate(x64, size=(12, 4), mode="bilinear",
                                    align_corners=align_corners).backward(
        torch.from_numpy(g).double())
    np.testing.assert_allclose(xt.grad.numpy(), x64.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_resize_backward_copies_its_matrices_once(rng):
    """The backward's interpolation matrices are made on the gradient's
    device once a shape: a second backward copies nothing from the host."""
    from hybrid_vit_cascade_tpu_torch.ops import resize

    x = torch.from_numpy(_f32(rng, (1, 2, 5, 6, 7))).requires_grad_(True)
    resize.resize_trilinear(x, (9, 11, 13)).sum().backward()
    first = resize._resize_matrix_on.cache_info()
    resize.resize_trilinear(x, (9, 11, 13)).sum().backward()
    again = resize._resize_matrix_on.cache_info()
    assert again.misses == first.misses and again.hits == first.hits + 3
    assert resize._resize_matrix_on(6, 11, False, x.device).device == x.device


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_matches_jax(rng, window, stride, padding):
    x = _f32(rng, (2, 3, 11, 9))
    want = np.asarray(jax_max_pool(jnp.asarray(x), window, spatial_axes=(2, 3),
                                   stride=stride, padding=padding))
    got = max_pool_nd(torch.from_numpy(x), window, stride=stride, padding=padding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,stride,padding", [(2, None, 0), (3, 2, 1)])
def test_max_pool_3d_matches_jax(rng, window, stride, padding):
    """The (N, C, D, H, W) form (the diagnostic perceptual net's pool)."""
    x = _f32(rng, (2, 3, 7, 9, 6))
    want = np.asarray(jax_max_pool(jnp.asarray(x), window, spatial_axes=(2, 3, 4),
                                   stride=stride, padding=padding))
    got = max_pool_nd(torch.from_numpy(x), window, stride=stride, padding=padding).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        max_pool_nd(torch.from_numpy(x[0, 0]), window)


@pytest.mark.parametrize("shape,groups", [((2, 16, 4, 5, 6), 4), ((1, 32, 3, 3, 3), 8),
                                          ((2, 64, 5, 7), 32)])
def test_group_norm_core_matches_jax(rng, shape, groups):
    x = _f32(rng, shape, 2.0) + 0.5
    scale = _f32(rng, shape[1:2]) + 1.0
    bias = _f32(rng, shape[1:2])
    want = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups))
    got = group_norm_core(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("b,cin,cout,dhw", [(1, 1, 8, (8, 8, 8)), (2, 3, 5, (5, 6, 10)),
                                            (1, 16, 8, (6, 4, 8))])
def test_conv3d_plain_matches_jax(rng, stride, b, cin, cout, dhw):
    # Tolerance of tests/test_pallas_conv.py:49.
    x = _f32(rng, (b, cin, *dhw))
    w = _f32(rng, (cout, cin, 3, 3, 3), 0.1)
    bias = _f32(rng, (cout,))
    want = np.asarray(jax_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), stride,
                                 d_padding=1, hw_padding=1))
    before = launch_counts()
    got = conv3d_ncdhw(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), stride)
    assert launch_counts() == before  # CPU: plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_conv1x1_matches_jax(rng):
    x = _f32(rng, (2, 32, 4, 5, 6))
    w = _f32(rng, (3, 32, 1, 1, 1), 0.2)
    bias = _f32(rng, (3,))
    want = np.asarray(jax_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), 1,
                                 d_padding=0, hw_padding=0))
    got = conv1x1_ncdhw(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nk,d", [(200, 77, 32), (130, 100, 64), (64, 256, 32)])
def test_flash_plain_matches_jax_kernel(rng, nq, nk, d):
    # Tolerance of tests/test_flash_attention.py:29 (fp32).
    q, k, v = (_f32(rng, (2, 2, n, d)) for n in (nq, nk, nk))
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_kernel = np.asarray(jax_flash(jq, jk, jv, scale, block_q=64, block_kv=64))
    want_ref = np.asarray(_reference_attention(jq, jk, jv, scale))
    out, lse = flash_attention_plain(*(torch.from_numpy(a.reshape(4, -1, d)) for a in (q, k, v)),
                                     scale)
    got = out.numpy().reshape(2, 2, nq, d)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy().reshape(2, 2, nq), want_lse, rtol=1e-5, atol=1e-5)


def test_flash_plain_chunks_rows(rng, monkeypatch):
    """The plain version's query-row chunking (which bounds its score memory)
    gives the unchunked result."""
    import hybrid_vit_cascade_tpu_torch.ops.cuda.flash_attention as fa

    q, k, v = (torch.from_numpy(_f32(rng, (3, n, 32))) for n in (50, 40, 40))
    whole = fa.flash_attention_plain(q, k, v, 0.2)
    monkeypatch.setattr(fa, "_PLAIN_CHUNK_SCORES", 3 * 40 * 7)  # 7 rows per chunk
    chunked = fa.flash_attention_plain(q, k, v, 0.2)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_dot_product_attention_matches_jax(rng):
    q, k, v = (_f32(rng, (2, 4, n, 8)) for n in (33, 17, 17))
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v)), impl="xla"))
    before = flash_attention_fwd.launches
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert flash_attention_fwd.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for a CPU tensor; any device
    other than cpu or cuda raises instead of falling back."""
    q = torch.empty((1, 8, 32), device="meta")
    with pytest.raises(RuntimeError):
        flash_attention_fwd(q, q, q, 1.0)
    x = torch.empty((1, 4, 4, 4, 4), device="meta")
    w = torch.empty((4, 4, 3, 3, 3), device="meta")
    for stride in (1, 2):
        with pytest.raises(RuntimeError):
            conv3d_k3(x, w, None, stride, 1, (4 - 1) // stride + 1, dense=True)



def test_dense_conv_checks_the_contract():
    """A call counted as a dense kernel (B-G) must be the padding-1 conv:
    offset 1, every output plane, no options."""
    x = torch.zeros((1, 4, 6, 4, 4))
    w = torch.zeros((4, 4, 3, 3, 3))
    for args in ((1, 0, 6), (1, 1, 5), (2, 1, 4)):
        with pytest.raises(ValueError):
            conv3d_k3(x, w, None, *args, dense=True)
    with pytest.raises(ValueError):
        conv3d_k3(x, w, None, 2, 1, 3, True, dense=True)
    assert conv3d_k3(x, w, None, 2, 1, 3, dense=True).shape == (1, 4, 3, 2, 2)

def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_dir_follows_sources(monkeypatch, tmp_path):
    """The library is cached by a hash of the sources: an unchanged tree
    maps to the same directory, an edited source to a new one."""
    assert {"flash_attention.cu", "conv3d_k3.cu"} <= {p.name for p in _build.sources()}
    for src in _build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.build_dir()
    assert first == _build.build_dir() and first.parent == _build.BUILD_DIR
    (tmp_path / "conv3d_k3.cu").write_text((tmp_path / "conv3d_k3.cu").read_text() + "\n")
    assert _build.build_dir() != first


# ------------------------------------------------------- torch.library ops ---

@pytest.mark.parametrize("bh,nq,nk,d", [(3, 20, 17, 32), (2, 9, 40, 64)])
def test_flash_op_opcheck(rng, bh, nq, nk, d):
    """hvc::flash_attention_fwd passes torch.library.opcheck (schema, fake
    tensor, AOT dispatch) and on the CPU is the plain version, bit for bit."""
    q, k, v = (torch.from_numpy(_f32(rng, (bh, n, d))) for n in (nq, nk, nk))
    torch.library.opcheck(torch.ops.hvc.flash_attention_fwd.default, (q, k, v, d ** -0.5))
    for got, want in zip(torch.ops.hvc.flash_attention_fwd(q, k, v, d ** -0.5),
                         flash_attention_plain(q, k, v, d ** -0.5)):
        assert torch.equal(got, want)


# (x shape, w shape, bias, stride, qlo, d_out, want_sums, act, dense): dense
# convs at both strides, chain calls with the window, sums and prologue, and
# a D-narrowed view with free batch and channel strides.
_CONV_OP_CASES = [((2, 3, 5, 6, 10), (5, 3), True, 1, 1, 5, False, None, True),
                  ((1, 4, 6, 5, 7), (3, 4), False, 2, 1, 3, False, None, True),
                  ((2, 3, 5, 6, 10), (5, 3), True, 1, 0, 4, True, "gelu", False),
                  ((1, 2, 4, 6, 6), (8, 2), True, 2, 2, 3, True, "silu", False),
                  ((1, 8, 6, 4, 5), (1, 8), False, 1, 2, 3, False, None, False)]


@pytest.mark.parametrize("case", _CONV_OP_CASES)
@pytest.mark.parametrize("view", [False, True])
def test_conv_op_opcheck(rng, case, view):
    """hvc::conv3d_k3 passes torch.library.opcheck with and without sums (the
    empty (0,) sums when none are asked), and on the CPU is the plain
    version (the kernel wrapper's CPU branch), bit for bit."""
    xs, (cout, cin), has_bias, stride, qlo, d_out, sums, act, dense = case
    big = torch.from_numpy(_f32(rng, (xs[0], xs[1], xs[2] + 3, *xs[3:])))
    x = big[:, :, 1:1 + xs[2]] if view else big[:, :, :xs[2]].contiguous()
    w = torch.from_numpy(_f32(rng, (cout, cin, 3, 3, 3), 0.2))
    bias = torch.from_numpy(_f32(rng, (cout,))) if has_bias else None
    args = (x, w, bias, stride, qlo, d_out, sums, act, dense)
    torch.library.opcheck(torch.ops.hvc.conv3d_k3.default, args)
    out, s1, s2 = torch.ops.hvc.conv3d_k3(*args)
    for want in (conv3d_k3_plain(x, w, bias, stride, qlo, d_out, sums, act),
                 conv3d_k3(x, w, bias, stride, qlo, d_out, sums, act, dense=dense)):
        if sums:
            assert all(torch.equal(a, b) for a, b in zip((out, s1, s2), want))
        else:
            assert torch.equal(out, want) and s1.shape == s2.shape == (0,)


def test_models_reach_the_forward_kernels_through_the_ops(rng):
    """The autograd Functions' forwards call the hvc:: ops (what torch.export
    records): a traced conv and attention hold one op node each."""
    from hybrid_vit_cascade_tpu_torch.ops.attention import dot_product_attention as attn

    x = torch.from_numpy(_f32(rng, (1, 2, 4, 4, 4)))
    w = torch.from_numpy(_f32(rng, (8, 2, 3, 3, 3)))
    q = torch.from_numpy(_f32(rng, (1, 2, 5, 32)))

    class Both(torch.nn.Module):
        def forward(self, x, q):
            return conv3d_ncdhw(x, w, None, 2), attn(q, q, q)

    with torch.no_grad():
        program = torch.export.export(Both(), (x, q))
    ops = [str(n.target) for n in program.graph.nodes if str(n.target).startswith("hvc.")]
    assert sorted(ops) == ["hvc.conv3d_k3.default", "hvc.flash_attention_fwd.default"]
