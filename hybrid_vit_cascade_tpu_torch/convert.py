"""JAX variables → the port's state_dict.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of arrays (numpy, or anything ``np.asarray`` accepts) and returns
the ``state_dict`` of the matching module of this package. The inverse of
``torch_to_jax_variables`` in tests/test_parity_cascade.py and its helpers in
tests/test_parity_model.py.

Layouts: flax Dense kernels are (in, out) and torch wants (out, in); flax
nn.Conv kernels are (k…, I, O) and torch wants (O, I, k…). ConvNCDHW kernels
and the chain ``*_kernel`` parameters are already OIDHW and copy as they
are; the stage-1 seed volume moves from NDHWC to NCDHW. BatchNorm running
statistics come from ``batch_stats``. ``vgg16`` converts the perceptual
loss's VGG variables, ``diagnostic_nets`` the diagnostic suite's three frozen
nets, ``direct256_nets`` the CNN decoders' loss nets. The CNN decoders keep
flax's module names, so ``flax_tree`` converts them by walking the tree.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

StateDict = dict  # name → torch.Tensor


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _volume(a) -> torch.Tensor:
    """A seed volume (1, D, H, W, C) → (1, C, D, H, W)."""
    return _t(a).permute(0, 4, 1, 2, 3).contiguous()


def _dense(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[prefix + "weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        sd[prefix + "bias"] = _t(p["bias"])


def _norm(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[prefix + "weight"] = _t(p["scale"])
    sd[prefix + "bias"] = _t(p["bias"])


def _flax_conv(p: Mapping, prefix: str, sd: StateDict) -> None:
    k = _t(p["kernel"])
    perm = (k.dim() - 1, k.dim() - 2) + tuple(range(k.dim() - 2))  # (k…, I, O) → (O, I, k…)
    sd[prefix + "weight"] = k.permute(*perm).contiguous()
    if "bias" in p:
        sd[prefix + "bias"] = _t(p["bias"])


def _ncdhw_conv(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[prefix + "weight"] = _t(p["kernel"])
    sd[prefix + "bias"] = _t(p["bias"])


def _indexed(p: Mapping, stem: str) -> list[str]:
    """Keys `stem_0`, `stem_1`, … of p in index order."""
    keys = [k for k in p if re.fullmatch(rf"{stem}_\d+", k)]
    return sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))


def xray_conditioning(p: Mapping, stats: Mapping, prefix: str = "") -> StateDict:
    """XrayConditioningModule."""
    sd: StateDict = {}
    for i in range(3):
        _flax_conv(p[f"Conv_{i}"], f"{prefix}conv{i + 1}.", sd)
        bn = f"{prefix}bn{i + 1}."
        _norm(p[f"BatchNorm_{i}"], bn, sd)
        sd[bn + "running_mean"] = _t(stats[f"BatchNorm_{i}"]["mean"])
        sd[bn + "running_var"] = _t(stats[f"BatchNorm_{i}"]["var"])
        sd[bn + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    _dense(p["to_cond"], prefix + "to_cond.", sd)
    _dense(p["Dense_0"], prefix + "time1.", sd)
    _dense(p["Dense_1"], prefix + "time2.", sd)
    return sd


def multiscale_encoder(p: Mapping, stats: Mapping, prefix: str = "") -> StateDict:
    """MultiScaleXrayEncoder. flax numbers the branch GroupNorms in call order,
    which is the branches' sorted name order (to_stage1_a, to_stage1_b,
    to_stage2)."""
    sd = xray_conditioning(p["xray_encoder"], stats["xray_encoder"], prefix + "xray_encoder.")
    branches = sorted(k[:-len("_conv")] for k in p if k.endswith("_conv"))
    for i, name in enumerate(branches):
        _flax_conv(p[f"{name}_conv"], f"{prefix}down.{name}.conv.", sd)
        _norm(p[f"GroupNorm_{i}"], f"{prefix}down.{name}.norm.", sd)
    return sd


def vit_block(p: Mapping, prefix: str = "") -> StateDict:
    """HybridViTBlock3D."""
    sd: StateDict = {}
    _dense(p["AdaLNModulation_0"]["Dense_0"], prefix + "adaln.linear.", sd)
    for i in range(3):
        _norm(p[f"LayerNorm_{i}"], f"{prefix}norm{i + 1}.", sd)
    sa, ca, mlp = p["MultiHeadSelfAttention_0"], p["MultiHeadCrossAttention_0"], p["Mlp_0"]
    _dense(sa["Dense_0"], prefix + "self_attn.qkv.", sd)
    _dense(sa["Dense_1"], prefix + "self_attn.proj.", sd)
    _dense(ca["q"], prefix + "cross_attn.q.", sd)
    _dense(ca["kv"], prefix + "cross_attn.kv.", sd)
    _dense(ca["Dense_0"], prefix + "cross_attn.proj.", sd)
    _dense(mlp["Dense_0"], prefix + "mlp.fc1.", sd)
    _dense(mlp["Dense_1"], prefix + "mlp.fc2.", sd)
    return sd


def vit3d(p: Mapping, prefix: str = "") -> StateDict:
    """HybridViT3D, from either of the JAX stems: feature-first
    (ConvNCDHW_i / GroupNormNCDHW_i) or channels-last (Conv_i / GroupNorm_i);
    a conv beyond the last GroupNorm is the projection conv."""
    sd: StateDict = {}
    ncdhw = any(k.startswith("ConvNCDHW_") for k in p)
    conv_stem, gn_stem = ("ConvNCDHW", "GroupNormNCDHW") if ncdhw else ("Conv", "GroupNorm")
    convs, norms = _indexed(p, conv_stem), _indexed(p, gn_stem)
    to_torch = _ncdhw_conv if ncdhw else _flax_conv
    for i, (c, g) in enumerate(zip(convs, norms)):
        to_torch(p[c], f"{prefix}stem_convs.{i}.", sd)
        _norm(p[g], f"{prefix}stem_norms.{i}.", sd)
    if len(convs) > len(norms):
        to_torch(p[convs[len(norms)]], prefix + "proj.", sd)
    sd[prefix + "pos_embed"] = _t(p["pos_embed"])
    for i, blk in enumerate(_indexed(p, "HybridViTBlock3D")):
        sd.update(vit_block(p[blk], f"{prefix}blocks.{i}."))
    _norm(p["LayerNorm_0"], prefix + "norm.", sd)
    _dense(p["Dense_0"], prefix + "head.", sd)
    return sd


def _flat(p: Mapping, prefix: str, sd: StateDict) -> None:
    """Chain-owning modules keep the JAX flat parameter names."""
    for k, v in p.items():
        sd[prefix + k] = _t(v)


def cascade(variables: Mapping) -> StateDict:
    """ProgressiveCascadeModel, for any number of built stages (a
    stage-pruned tree converts to a model built with fewer stages)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    s1 = params["stage1"]
    sd["stage1.initial_volume"] = _volume(s1["initial_volume"])
    sd.update(multiscale_encoder(s1["xray_encoder"], stats["stage1"]["xray_encoder"],
                                 "stage1.xray_encoder."))
    sd.update(vit3d(s1["vit_backbone"], "stage1.vit_backbone."))
    if "xray_encoder" in params:
        sd.update(multiscale_encoder(params["xray_encoder"], stats["xray_encoder"],
                                     "xray_encoder."))
    if "stage2" in params:
        s2 = params["stage2"]
        sd["stage2.residual_weight"] = _t(s2["residual_weight"])
        up = s2["upsample_from_64"]
        _ncdhw_conv(up["ConvNCDHW_0"], "stage2.upsample_from_64.conv.", sd)
        _norm(up["GroupNormNCDHW_0"], "stage2.upsample_from_64.norm.", sd)
        sd.update(vit3d(s2["vit_refiner"], "stage2.vit_refiner."))
    if "stage3" in params:
        s3 = params["stage3"]
        sd["stage3.residual_weight"] = _t(s3["residual_weight"])
        sd["stage3.detail_weight"] = _t(s3["detail_weight"])
        trunk = dict(s3["vit_trunk"])
        sd.update(vit3d(trunk.pop("vit_refiner"), "stage3.vit_trunk.vit_refiner."))
        _flat(trunk, "stage3.vit_trunk.", sd)
        _flat(s3["detail_enhancer"], "stage3.detail_enhancer.", sd)
    return sd


def vgg16(variables: Mapping) -> StateDict:
    """The VGG16-prefix filters of the JAX ``TriPlanarPerceptualLoss``
    (``{"params": {"Conv_i": {"kernel" (3, 3, I, O), "bias"}}}``) →
    ``Conv_i.weight`` (O, I, 3, 3) / ``Conv_i.bias`` for the port's
    ``TriPlanarPerceptualLoss(weights=...)``."""
    p = variables["params"]
    sd: StateDict = {}
    for name in _indexed(p, "Conv"):
        sd[f"{name}.weight"] = _t(p[name]["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    return sd


def _conv_stack(p: Mapping, convs: str = "convs.", norms: str | None = None) -> StateDict:
    """flax ``Conv_i`` (and ``GroupNorm_i``) → ``<convs>i.weight`` / ``.bias``
    (and ``<norms>i.weight`` / ``.bias``)."""
    sd: StateDict = {}
    for i, name in enumerate(_indexed(p, "Conv")):
        _flax_conv(p[name], f"{convs}{i}.", sd)
    if norms is not None:
        for i, name in enumerate(_indexed(p, "GroupNorm")):
            _norm(p[name], f"{norms}{i}.", sd)
    return sd


def diagnostic_nets(perceptual_vars: Mapping, extractor_vars: Mapping,
                    lpips_vars: Mapping) -> dict:
    """The JAX diagnostic suite's frozen nets → the ``weights=`` of the port's
    ``DiagnosticLosses``: ``{"perceptual": Simple3DPerceptualNet,
    "extractor": MultiLevelFeatureExtractor, "lpips": _Slice2DFeatureNet}``
    state dicts, from the variables of ``DiagnosticLosses._perc_vars``,
    ``ComprehensiveFeatureMetrics._vars`` and ``LPIPS3D._vars``."""
    return {"perceptual": _conv_stack(perceptual_vars["params"]),
            "extractor": _conv_stack(extractor_vars["params"], norms="norms."),
            "lpips": _conv_stack(lpips_vars["params"])}


def flax_tree(p: Mapping, prefix: str = "") -> StateDict:
    """A params tree whose module names the port keeps (the CNN decoders,
    their encoders and blocks, the loss nets): a leaf module with a 2D
    ``kernel`` is a Dense, with a higher-rank one a flax nn.Conv, with a
    ``scale`` a norm; ``initial_volume`` moves to NCDHW; every other entry is
    a submodule of the same name."""
    sd: StateDict = {}
    for name, v in p.items():
        if name == "initial_volume":
            sd[prefix + name] = _volume(v)
        elif "kernel" in v:
            (_dense if np.ndim(v["kernel"]) == 2 else _flax_conv)(v, f"{prefix}{name}.", sd)
        elif "scale" in v:
            _norm(v, f"{prefix}{name}.", sd)
        else:
            sd.update(flax_tree(v, f"{prefix}{name}."))
    return sd


def cnn_decoder(variables: Mapping) -> StateDict:
    """Direct128ModelH200, Direct256ModelH200 or Direct256ModelB200 (no
    batch statistics: GroupNorm only)."""
    return flax_tree(variables["params"])


def direct_regression(variables: Mapping) -> StateDict:
    """DirectCTRegression: the BatchNorm encoder with its running statistics,
    the seed volume and the channels-last-stem ViT."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = xray_conditioning(params["xray_encoder"], stats["xray_encoder"], "xray_encoder.")
    sd["initial_volume"] = _volume(params["initial_volume"])
    sd.update(vit3d(params["vit_backbone"], "vit_backbone."))
    return sd


def direct256_nets(pyramid_vars: Mapping, style_vars: Mapping, attention_vars: Mapping) -> dict:
    """The JAX ``Direct256Loss``'s frozen nets (``_pyr_vars``, ``_style_vars``,
    ``_attn_vars``) → the ``weights=`` of the port's ``Direct256Loss``."""
    return {"pyramid": flax_tree(pyramid_vars["params"]),
            "style": flax_tree(style_vars["params"]),
            "attention": flax_tree(attention_vars["params"])}
