"""CUDA kernels of the PyTorch port against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu_torch.ops.cuda.conv3d_k3 import (
    conv3d_k3_plain,
    conv3d_k3s1,
    conv3d_k3s2,
)
from hybrid_vit_cascade_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda

# Tolerances (|got - want| <= atol + rtol·|want|). fp32: both sides
# accumulate in fp32 in another order. bf16: both sides round once to bf16
# at the end (one ulp is 2^-8 relative), from the same bf16 inputs.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, dev, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape, dtype=np.float32)).to(dev, dtype)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= atol + rtol * want.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nq,nk,d", [(3, 200, 77, 32), (3, 200, 77, 64), (2, 130, 300, 32),
                                        (8, 1024, 1024, 32), (4, 1024, 256, 64)])
def test_flash_matches_plain(dev, dtype, bh, nq, nk, d):
    q, k, v = (_randn((bh, n, d), dtype, dev, s) for s, n in ((0, nq), (1, nk), (2, nk)))
    scale = d ** -0.5
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, scale)
    assert flash_attention_fwd.launches == before + 1
    want_out, want_lse = flash_attention_plain(q, k, v, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want_out, dtype)
    _close(lse, want_lse, torch.float32)


def test_flash_rejects_unsupported(dev):
    q = torch.zeros((1, 8, 48), device=dev)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, 1.0)
    q = torch.zeros((1, 8, 32), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q, 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("b,cin,cout,dhw", [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10)),
                                            (1, 1, 32, (16, 16, 16)), (1, 64, 32, (8, 24, 40)),
                                            (1, 32, 64, (16, 16, 16))])
def test_conv_matches_plain(dev, dtype, stride, b, cin, cout, dhw):
    x = _randn((b, cin, *dhw), dtype, dev, 3)
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, 4) / (27 * cin) ** 0.5).to(dtype)
    bias = _randn((cout,), torch.float32, dev, 5)
    fn = conv3d_k3s1 if stride == 1 else conv3d_k3s2
    before = fn.launches
    got = fn(x, w, bias)
    assert fn.launches == before + 1
    want = conv3d_k3_plain(x, w, bias, stride)
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


def test_conv_rejects_mixed_dtype(dev):
    x = torch.zeros((1, 4, 4, 4, 4), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((4, 4, 3, 3, 3), device=dev)
    with pytest.raises(TypeError):
        conv3d_k3s1(x, w, None)
