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
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
from hybrid_vit_cascade_tpu_torch.ops.cuda.conv3d_k3 import conv3d_k3s1, conv3d_k3s2
from hybrid_vit_cascade_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd,
    flash_attention_plain,
)
from hybrid_vit_cascade_tpu_torch.ops.pool import max_pool_nd
from hybrid_vit_cascade_tpu_torch.ops.resize import resize_trilinear


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out", [(10, 12, 14), (3, 4, 5), (5, 12, 7)])
def test_resize_matches_jax(rng, align_corners, out):
    x = _f32(rng, (2, 3, 5, 6, 7))
    want = np.asarray(jax_resize(jnp.asarray(x), out, align_corners=align_corners))
    got = resize_trilinear(torch.from_numpy(x), out, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_matches_jax(rng, window, stride, padding):
    x = _f32(rng, (2, 3, 11, 9))
    want = np.asarray(jax_max_pool(jnp.asarray(x), window, spatial_axes=(2, 3),
                                   stride=stride, padding=padding))
    got = max_pool_nd(torch.from_numpy(x), window, stride=stride, padding=padding).numpy()
    np.testing.assert_array_equal(got, want)


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
    before = (conv3d_k3s1.launches, conv3d_k3s2.launches)
    got = conv3d_ncdhw(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), stride)
    assert (conv3d_k3s1.launches, conv3d_k3s2.launches) == before  # CPU: plain version
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
    for fn in (conv3d_k3s1, conv3d_k3s2):
        with pytest.raises(RuntimeError):
            fn(x, w, None)


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
