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
nets, ``direct256_nets`` the CNN decoders' loss nets. The CNN decoders and
the diffusion family's depth lifter keep flax's module names, so
``flax_tree`` converts them by walking the tree.

The Orbax reader (``convert_orbax.py``, which runs where JAX is) calls
``variables``, the converter of a checkpoint's family, and
``adamw_state``, which puts optax's AdamW moments and counts through the
same converter into an ``Optimizer.state_dict()``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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


def diffusion(variables: Mapping) -> StateDict:
    """UnifiedHybridViTCascade: the time MLP (``Dense_0``, ``Dense_1``), the
    BatchNorm encoder with its running statistics, and per stage
    ``prev_proj_{name}`` and ``stage_{name}`` (the lifter and
    ``depth_to_volume`` by flax's names, the channels-last-stem ViT). The
    streamed and dense lifters share one tree."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    for name in ("Dense_0", "Dense_1"):
        _dense(params[name], f"{name}.", sd)
    sd.update(xray_conditioning(params["xray_encoder"], stats["xray_encoder"], "xray_encoder."))
    for name, p in params.items():
        if name.startswith("prev_proj_"):
            _dense(p, f"{name}.", sd)
        elif name.startswith("stage_"):
            rest = dict(p)
            sd.update(vit3d(rest.pop("vit_backbone"), f"{name}.vit_backbone."))
            sd.update(flax_tree(rest, f"{name}."))
    return sd


FAMILIES = {"cascade": cascade, "direct_vit": direct_regression,
            "direct128_h200": cnn_decoder, "direct256_h200": cnn_decoder,
            "direct256_b200": cnn_decoder, "diffusion": diffusion}


def variables(family: str, tree: Mapping) -> StateDict:
    """The converter of model family ``family`` (a checkpoint's
    ``config.model.family``) applied to its variables tree."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}; the converters cover "
                         f"{sorted(FAMILIES)}")
    return FAMILIES[family](tree)


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _with_leaves(tree: Mapping, fn, prefix: tuple = ()) -> dict:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    return {k: (_with_leaves(v, fn, prefix + (k,)) if isinstance(v, Mapping)
                else fn(prefix + (k,), v)) for k, v in tree.items()}


def leaf_sources(family: str, tree: Mapping) -> Dict[str, tuple]:
    """For each entry of ``variables(family, tree)``, the path of the one
    leaf of ``tree["params"]`` or ``tree["batch_stats"]`` it is made from.
    Checks what the moments' conversion rests on: that the family's
    converter moves every leaf by a copy, a transpose or a permutation and
    nothing else (no sum, no scale, no mix of two leaves), so that it maps
    optax's ``mu`` and ``nu`` exactly as it maps the parameters. Two probes
    go through the converter: each leaf filled with its own index (which
    entry comes from which leaf), and each leaf holding 0, 1, … in its own
    order (each entry must hold exactly those values, once each)."""
    shapes = {p: np.shape(v) for col in ("params", "batch_stats") if col in tree
              for p, v in _leaves(tree[col], (col,))}
    paths = list(shapes)
    index = {p: i for i, p in enumerate(paths)}

    def probe(fill):
        return variables(family, {col: _with_leaves(tree[col], fill, (col,))
                                  for col in ("params", "batch_stats") if col in tree})

    ids = probe(lambda p, _: np.full(shapes[p], index[p], np.float32))
    order = probe(lambda p, _: np.arange(int(np.prod(shapes[p])), dtype=np.float32)
                  .reshape(shapes[p]))
    out = {}
    for name, t in ids.items():
        if not t.is_floating_point():  # num_batches_tracked: made, not converted
            continue
        src = int(t.flatten()[0]) if t.numel() else -1
        if t.numel() == 0 or not bool((t == src).all()):
            raise AssertionError(f"convert.{FAMILIES[family].__name__}: {name} mixes leaves")
        n = int(np.prod(shapes[paths[src]]))
        got = order[name].flatten()
        if t.numel() != n or float(got.min()) < 0 or not torch.equal(got, got.round()) \
                or not bool((torch.bincount(got.long(), minlength=n) == 1).all()):
            raise AssertionError(f"convert.{FAMILIES[family].__name__}: {name} is not a "
                                 f"permutation of {'/'.join(paths[src])}")
        out[name] = paths[src]
    return out


def adamw_state(family: str, tree: Mapping, mu: Mapping, nu: Mapping, adam_count: int,
                schedule_count: int, step: int, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> dict:
    """optax's AdamW state → ``{"optimizer": Optimizer.state_dict(), "step":
    step}``, the port's ``latest_opt`` entry.

    ``tree`` is the model's variables (the JAX layout, as for ``variables``);
    ``mu`` and ``nu`` are ``ScaleByAdamState``'s moments, trees of the shape
    of ``tree["params"]`` with None at every frozen parameter (optax's
    ``MaskedNode``); ``adam_count`` is its count, ``schedule_count``
    ``ScaleByScheduleState``'s. ``optimizer`` is the port's optimizer for the
    same stage, built by ``make_optimizer`` over ``model``'s trainable
    parameters (``apply_stage_freeze``): its parameter groups give the
    hyperparameters and the order of the parameters, and its trainable set
    must be the one the moments hold, else ValueError naming the parameters.
    The moments go through the family's converter (``leaf_sources`` checks it
    permutes); each parameter's ``step`` is ``adam_count`` and each group's
    ``schedule_step`` is ``schedule_count``. The group's ``lr`` stays the one
    ``make_optimizer`` set: the optimizer that loads the state sets it from
    its schedule at ``schedule_step``, as optax evaluates its schedule at the
    count."""
    sources = leaf_sources(family, tree)
    params = tree["params"]
    names = {id(p): n for n, p in model.named_parameters()}
    param_names = set(names.values())
    held = {n for n, path in sources.items()
            if n in param_names and _at(mu, path[1:]) is not None}
    trained = {names[id(p)] for g in optimizer.param_groups for p in g["params"]}
    if held != trained:
        raise ValueError(
            f"the optimizer state's trainable set is not the port's rule for this stage: "
            f"moments for {sorted(held - trained)} which the rule freezes, none for "
            f"{sorted(trained - held)} which it trains")

    def moments(m: Mapping) -> StateDict:
        filled = _with_leaves(params, lambda p, v: (np.zeros(np.shape(v), np.float32)
                                                    if _at(m, p) is None else _at(m, p)))
        return variables(family, {**tree, "params": filled})

    exp_avg, exp_avg_sq = moments(mu), moments(nu)
    sd = optimizer.state_dict()
    state, i = {}, 0
    for group, saved in zip(optimizer.param_groups, sd["param_groups"]):
        for p in group["params"]:
            n = names[id(p)]
            state[i] = {"step": torch.tensor(float(adam_count), dtype=torch.float32),
                        "exp_avg": exp_avg[n].to(p.dtype), "exp_avg_sq": exp_avg_sq[n].to(p.dtype)}
            i += 1
        saved["schedule_step"] = int(schedule_count)
    return {"optimizer": {"state": state, "param_groups": sd["param_groups"]}, "step": int(step)}


def _at(tree: Mapping, path: tuple):
    """The entry of ``tree`` at ``path``; None where the path ends early in a
    None (a masked subtree)."""
    for k in path:
        if tree is None:
            return None
        tree = tree[k]
    return tree
