"""The forward kernels as ``torch.library`` operators, so that ``torch.export``
(and any other tracer) sees each launch as one graph node.

Two operators in the ``hvc`` namespace:

- ``hvc::flash_attention_fwd(q, k, v, scale) -> (out, lse)``: kernel A
  (``flash_attention.flash_attention_fwd``), every instance.
- ``hvc::conv3d_k3(x, w, bias?, stride, qlo, d_out, want_sums, act?, dense)
  -> (out, s1, s2)``: kernels B, C, H and I (``conv3d_k3.conv3d_k3``), every
  instance its C rules pick. The schema has one return type, so the op always
  returns three tensors: without ``want_sums`` s1 and s2 are empty (0,) fp32
  tensors.

Each is implemented for CUDA and CPU tensors by its kernel wrapper, which
launches the kernel (with its checks and launch counters) on a CUDA tensor
and runs the plain version (``flash_attention_plain``, ``conv3d_k3_plain``)
on a CPU tensor, and has a fake implementation (shapes and dtypes only, which
a tracer runs). A tensor on any other device finds no implementation and
raises, and no implementation falls back to another. Every output is a new
tensor: none aliases an input.

Registered through ``torch.library.Library("hvc", "DEF")`` with ``define``
and ``impl``, the dispatcher's own route into a Python kernel; no autograd
kernel is registered. The autograd Functions of ``ops/attention.py`` and
``ops/conv3d.py`` call the forward ops inside their ``forward`` and keep
their backward wrappers (kernels D-G, J-M), which stay plain functions.

A process that loads an exported program holding these ops imports this
module first (``inference/serving.py``); nothing else of the port is needed.
"""

from __future__ import annotations

import torch

from . import conv3d_k3 as ck
from . import flash_attention as fa

LIB = torch.library.Library("hvc", "DEF")
LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)")
LIB.define("conv3d_k3(Tensor x, Tensor w, Tensor? bias, int stride, int qlo, int d_out, "
           "bool want_sums, str? act, bool dense) -> (Tensor, Tensor, Tensor)")


def _flash_fake(q, k, v, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def _no_sums(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((0,), dtype=torch.float32)


def _conv(x, w, bias, stride, qlo, d_out, want_sums, act, dense):
    res = ck.conv3d_k3(x, w, bias, stride, qlo, d_out, want_sums, act, dense=dense)
    return res if want_sums else (res, _no_sums(x), _no_sums(x))


def _conv_fake(x, w, bias, stride, qlo, d_out, want_sums, act, dense):
    B, H, W = x.shape[0], x.shape[3], x.shape[4]
    cout = w.shape[0]
    out = x.new_empty((B, cout, d_out, (H - 1) // stride + 1, (W - 1) // stride + 1))
    if not want_sums:
        return out, _no_sums(x), _no_sums(x)
    return (out, x.new_empty((B, cout), dtype=torch.float32),
            x.new_empty((B, cout), dtype=torch.float32))


for key in ("CUDA", "CPU"):
    LIB.impl("flash_attention_fwd", fa.flash_attention_fwd, key)
    LIB.impl("conv3d_k3", _conv, key)
torch.library.register_fake("hvc::flash_attention_fwd", _flash_fake, lib=LIB)
torch.library.register_fake("hvc::conv3d_k3", _conv_fake, lib=LIB)
