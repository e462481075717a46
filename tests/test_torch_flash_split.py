"""The port's split flash backward (kernels L and M on the card; on the CPU
their plain version) against the JAX package's split backward
``_bwd_pallas``, which ``flash_attention`` runs when its ``FUSED_BWD`` is
off (``HVC_FLASH_FUSED_BWD=0``) — in Pallas interpret mode here, as
tests/test_flash_attention.py:70 runs it.

The gradients of Σ out·cot through each package's attention, with the same
numpy inputs: head dims 32 and 64 and one ragged Nq×Nk pair (not multiples
of the JAX blocks). Tolerances: the JAX tests' own, fp32 5e-4, bf16 3e-2.
Also the port's split path against its fused path (kernel D's function) at
1e-6."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu_torch.ops import attention
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the module (the package's __init__ exports its function under the same name)
jfa = importlib.import_module("hybrid_vit_cascade_tpu.ops.pallas.flash_attention")

TOL = {"float32": 5e-4, "bfloat16": 3e-2}
CASES = [(96, 80, 32), (64, 64, 64), (72, 90, 32)]  # (Nq, Nk, d); the last is ragged


def _inputs(nq, nk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, nk, d)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((1, 2, nq, d)).astype(np.float32)
    return q, k, v, cot


def _port_grads(q, k, v, cot, dtype):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = attention.dot_product_attention(qt, kt, vt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,d", CASES)
def test_split_grads_match_jax(monkeypatch, nq, nk, d, dtype):
    q, k, v, cot = _inputs(nq, nk, d)
    calls = {"jax": 0, "port": 0}

    def counted(real, key):
        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return fn

    monkeypatch.setattr(jfa, "FUSED_BWD", False)
    monkeypatch.setattr(jfa, "_bwd_pallas", counted(jfa._bwd_pallas, "jax"))
    jdt = jnp.dtype(dtype)

    def loss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, d ** -0.5, block_q=32, block_kv=32)
        return (out.astype(jnp.float32) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))

    monkeypatch.setattr(attention, "FUSED_BWD", False)
    monkeypatch.setattr(attention.fa, "flash_attention_bwd_split",
                        counted(attention.fa.flash_attention_bwd_split, "port"))
    got = _port_grads(q, k, v, cot, getattr(torch, dtype))
    assert calls == {"jax": 1, "port": 1}
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("nq,nk,d", CASES)
def test_split_path_matches_fused_path(monkeypatch, nq, nk, d):
    q, k, v, cot = _inputs(nq, nk, d, seed=1)
    monkeypatch.setattr(attention, "FUSED_BWD", True)
    fused = _port_grads(q, k, v, cot, torch.float32)
    monkeypatch.setattr(attention, "FUSED_BWD", False)
    split = _port_grads(q, k, v, cot, torch.float32)
    for a, b, name in zip(split, fused, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


def test_switch_follows_the_jax_variable():
    """FUSED_BWD is read from HVC_FLASH_FUSED_BWD at import, as the JAX
    package reads it: '0' selects the split backward; unset, the fused one."""
    import os
    import subprocess
    import sys

    assert attention.FUSED_BWD == (os.environ.get("HVC_FLASH_FUSED_BWD", "1") != "0")
    code = ("from hybrid_vit_cascade_tpu_torch.ops import attention; "
            "print(attention.FUSED_BWD)")
    res = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "HVC_FLASH_FUSED_BWD": "0"}, capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.strip() == "False"
