"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of hybrid_vit_cascade_tpu/ops/pallas).

Each kernel wrapper counts the launches of its kernel: the flash-attention
wrappers in their ``.launches``, the conv wrappers in
``conv3d_k3.LAUNCHES``, one counter per kernel letter, and the conv probe
wrappers (family N) in ``conv_probe.LAUNCHES``, one counter per wrapper. ``launch_counts``
reads them all and ``reset_launch_counts`` sets them to 0.
"""

from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Kernel launches per counter since the last reset: flash_attention (A),
    flash_attention_tc (the launches of A on the tensor-core instance),
    flash_attention_bwd (D), flash_attention_bwd_tc (those of D on its
    tensor-core instance), flash_attention_bwd_dq (L),
    flash_attention_bwd_dq_tc (those of L on its tensor-core instance),
    flash_attention_bwd_dkv (M), flash_attention_bwd_dkv_tc (those of M on
    its tensor-core instance), and the conv counters conv3d_k3s{1,2} (B, C),
    conv3d_k3s1_dgrad (B as the stride-1 data gradient), conv3d_k3s2_dgrad
    (F), conv3d_k3s{1,2}_wgrad (E, G) and their ``_chain`` forms (H, I; H as
    the stride-1 data gradient, J; K), the launches on a tensor-core instance,
    counted beside their letter: conv3d_k3s1_tc (B, forward and data
    gradient), conv3d_k3s1_chain_tc (H, likewise), conv3d_k3s2_tc (C),
    conv3d_k3s2_chain_tc (I), conv3d_k3s{1,2}_wgrad_tc (E, G and K),
    conv3d_k3s2_dgrad_tc (F), conv3d_k3s2_chain_dgrad_tc (J),
    conv3d_k3s1_dgrad_c1_tc and conv3d_k3s1_chain_dgrad_c1_tc (B and H with
    one output channel, the data gradient of a 1-channel conv),
    conv3d_k3s1_c1in_tc and conv3d_k3s1_chain_c1in_tc (B and H with one input
    channel, the forward of a 1-channel conv), conv3d_k3s2_c1in_tc (C and I
    likewise), conv3d_k3s1_wgrad_c1in_tc (E and K at stride 1 with one input
    channel), conv3d_k3s2_wgrad_c1in_tc (G and K at stride 2 likewise),
    conv3d_k3s2_dgrad_c1in_tc (F and J with one dx channel),
    conv3d_k3s2_dgrad_c1in_fp32 (those in fp32, on their CUDA-core form),
    conv3d_k3s2_c1in, conv3d_k3s2_dgrad_c1in and
    conv3d_k3s2_wgrad_c1in (C/I, F/J and G/K with one input channel: the 1→64
    stem, whichever instance),
    and conv_probe_{v1,v2,v3,v3p,v5,v6,v4,v8} (N), conv_probe_v1_wgmma and
    conv_probe_v1_wgmma_m32 (those of conv_probe_v1 on V0's and V1's wgmma
    instances), conv_probe_v2_wgmma, conv_probe_v3_wgmma, conv_probe_v3p_wgmma,
    conv_probe_v4_wgmma, conv_probe_v6_wgmma, conv_probe_v5_wgmma and
    conv_probe_v8_wgmma (those of conv_probe_v2, conv_probe_v3, conv_probe_v3p,
    conv_probe_v4, conv_probe_v6, conv_probe_v5 and conv_probe_v8 on their
    wgmma instances)."""
    from . import conv3d_k3 as ck
    from . import conv_probe as cp
    from . import flash_attention as fa

    return {"flash_attention": fa.flash_attention_fwd.launches,
            "flash_attention_tc": fa.flash_attention_fwd.tc_launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "flash_attention_bwd_tc": fa.flash_attention_bwd.tc_launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dq_tc": fa.flash_attention_bwd_dq.tc_launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "flash_attention_bwd_dkv_tc": fa.flash_attention_bwd_dkv.tc_launches, **ck.LAUNCHES,
            **cp.LAUNCHES}


def reset_launch_counts() -> None:
    from . import conv3d_k3 as ck
    from . import conv_probe as cp
    from . import flash_attention as fa

    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        fn.launches = 0
    fa.flash_attention_fwd.tc_launches = 0
    fa.flash_attention_bwd.tc_launches = 0
    fa.flash_attention_bwd_dq.tc_launches = 0
    fa.flash_attention_bwd_dkv.tc_launches = 0
    for counters in (ck.LAUNCHES, cp.LAUNCHES):
        for name in counters:
            counters[name] = 0
