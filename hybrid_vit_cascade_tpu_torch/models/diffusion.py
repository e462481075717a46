"""Diffusion model family (counterpart of hybrid_vit_cascade_tpu/models/diffusion.py).

v-parameterised (or ε-parameterised) conditional diffusion over CT volumes
with a cosine noise schedule: a depth-lifting prior, projected to 16 channels,
is concatenated onto the noisy volume (17 channels into the denoiser's
stride-2 stem), and a multi-view Beer–Lambert DRR physics loss is taken on
the clamped predicted x₀. ``ddim_sample`` and ``cascaded_ddim_sample`` are
the deterministic (η = 0) samplers.

Volumes are NCDHW, the X-ray features NCHW. Module names are flax's
(``Dense_0``/``Dense_1`` the time MLP, ``xray_encoder``, ``prev_proj_{stage}``,
``stage_{stage}`` holding ``depth_lifter``, ``depth_to_volume`` and
``vit_backbone``), so ``convert.diffusion`` maps a JAX tree. The denoiser's
3×3×3 convs and attentions run on the hand-written kernels (the token stem
on C, the projection on B, attention on A; in training D, E, F, G); the
lifter's convs are cuDNN, as the JAX package leaves them to XLA.

Randomness: where the JAX module threads PRNG keys, this one takes a
``torch.Generator`` (drawn on the generator's device, then moved), or the
draws themselves (``t``, ``noise``, ``x_T``), so that a test can pass JAX's.
The bits of a generator's draws differ from JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.drr import drr_beer_lambert
from ..ops.resize import resize_bilinear, resize_trilinear
from .cnn_models import Conv3d
from .depth_lifting import CascadedDepthLifting
from .encoders import XrayConditioningModule
from .layers import Linear, number_dropout_sites
from .vit3d import HybridViT3D

COND_DIM = 1024
TIME_EMBED_DIM = 256  # the time MLP's width (Dense_0, Dense_1)
PRIOR_CHANNELS = 16  # depth_to_volume's output: the prior beside the noisy volume
DEPTH_SIZES = (64, 128, 256)  # the lifter's depth ladder (fusion above the first)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in fp32 on the host, as XLA computes
    it: step = iota · fp32(1 / (num − 1)) (XLA turns the division by the
    constant into a product with its reciprocal), start·(1 − step) +
    stop·step, the endpoint appended."""
    f = np.float32
    if num == 1:
        return np.array([start], f)
    div = num - 1
    step = np.arange(div, dtype=f) * (f(1) / f(div))
    out = f(start) * (f(1) - step) + f(stop) * step
    return np.concatenate([out, np.array([stop], f)]).astype(f)


def cumprod_f32(a: np.ndarray, base: int = 16) -> np.ndarray:
    """``jnp.cumprod`` of a 1-D fp32 array as XLA on the CPU associates it
    (its rewrite of the reduce-window scan): blocks of ``base`` taken left to
    right, the blocks' totals scanned the same way, each block scaled by the
    product of the blocks before it."""
    n = len(a)
    if n <= base:
        return np.cumprod(a, dtype=np.float32)
    nb = -(-n // base)
    blocks = np.ones(nb * base, np.float32)
    blocks[:n] = a
    inner = np.cumprod(blocks.reshape(nb, base), axis=1, dtype=np.float32)
    totals = cumprod_f32(inner[:, -1].copy(), base)
    inner[1:] *= totals[:-1, None]
    return inner.reshape(-1)[:n]


def ddim_timesteps(num_timesteps: int, num_steps: int) -> np.ndarray:
    """The sampler's timesteps, ``linspace(T − 1, 0, n).round()`` in fp32 with
    round-half-to-even, as int64. Built on the host: at n = 25 the fp32
    values pass through 832.5 and 499.5 exactly, so another linspace (one
    ulp off) would move a timestep by one."""
    return np.round(linspace_f32(num_timesteps - 1, 0, num_steps)).astype(np.int64)


class NoiseSchedule(nn.Module):
    """Cosine (Improved-DDPM) or linear beta schedule (JAX ``diffusion.py:31-70``):
    the fp32 tables √ᾱ and √(1 − ᾱ), built on the host, as non-persistent
    buffers, and the identities that read them."""

    def __init__(self, num_timesteps: int = 1000, schedule_type: str = "cosine"):
        super().__init__()
        self.num_timesteps = num_timesteps
        self.schedule_type = schedule_type
        sa, so = self.tables_np(num_timesteps, schedule_type)
        self.register_buffer("sqrt_alphas_cumprod", torch.from_numpy(sa), persistent=False)
        self.register_buffer("sqrt_one_minus_alphas_cumprod", torch.from_numpy(so),
                             persistent=False)

    @staticmethod
    def tables_np(T: int, schedule_type: str = "cosine") -> Tuple[np.ndarray, np.ndarray]:
        f = np.float32
        if schedule_type == "cosine":
            s = f(0.008)
            x = linspace_f32(0.0, T, T + 1)
            ac = np.cos(((x / f(T)) + s) / f(1 + 0.008) * f(math.pi) * f(0.5)) ** 2
            betas = np.clip(f(1) - ac[1:] / ac[:-1], f(0.0001), f(0.9999))
        else:
            betas = linspace_f32(0.0001, 0.02, T)
        alphas_cumprod = cumprod_f32((f(1) - betas).astype(f))
        return np.sqrt(alphas_cumprod).astype(f), np.sqrt(f(1) - alphas_cumprod).astype(f)

    def _at(self, t: torch.Tensor, ndim: int):
        shape = (-1,) + (1,) * (ndim - 1)
        return (self.sqrt_alphas_cumprod[t].reshape(shape),
                self.sqrt_one_minus_alphas_cumprod[t].reshape(shape))

    def q_sample(self, x_start, t, noise):
        sa, so = self._at(t, x_start.dim())
        return sa * x_start + so * noise

    def v_target(self, x_start, noise, t):
        sa, so = self._at(t, x_start.dim())
        return sa * noise - so * x_start

    def pred_x_start_from_v(self, x_noisy, v, t):
        sa, so = self._at(t, x_noisy.dim())
        return sa * x_noisy - so * v

    def pred_x_start_from_eps(self, x_noisy, eps, t):
        sa, so = self._at(t, x_noisy.dim())
        return (x_noisy - so * eps) / sa.clamp_min(1e-8)


class UnifiedCascadeStage(nn.Module):
    """One diffusion stage (JAX ``diffusion.py:73-153``): depth-lifting prior →
    ``depth_to_volume`` (1×1×1 conv to 16 channels) → trilinear resize
    (align_corners=True) when the prior's (D, H′, W′) differs from the volume
    → concat with the noisy volume (17 channels) → HybridViT3D denoiser with
    the channels-last stem's numerics (flax GroupNorm), cond_dim 1024 and the
    previous-stage embedding when ``use_prev_stage``. With ``remat`` the
    whole lifter is one recompute region and so is each ViT block."""

    def __init__(self, volume_size: Tuple[int, int, int], voxel_dim: int = 384,
                 vit_depth: int = 6, num_heads: int = 6, xray_feature_dim: int = 512,
                 use_prev_stage: bool = False, use_depth_lifting: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False, lift_slabs: int = 0):
        super().__init__()
        self.volume_size = tuple(volume_size)
        self.dtype = dtype
        self.remat = remat
        self.use_depth_lifting = use_depth_lifting
        in_ch = 1
        if use_depth_lifting:
            self.depth_lifter = CascadedDepthLifting(
                xray_feature_dim, self.volume_size[0], DEPTH_SIZES, use_prev_stage, dtype,
                lift_slabs)
            self.depth_to_volume = Conv3d(xray_feature_dim, PRIOR_CHANNELS, 1, dtype=dtype)
            in_ch += PRIOR_CHANNELS
        self.vit_backbone = HybridViT3D(
            self.volume_size, in_ch, voxel_dim, vit_depth, num_heads,
            context_dim=xray_feature_dim, cond_dim=COND_DIM, dtype=dtype, layout="NDHWC",
            remat=remat, remat_mode="block", use_prev_stage=use_prev_stage)

    def forward(self, noisy_volume: torch.Tensor, xray_features: torch.Tensor,
                cond: torch.Tensor, prev_stage_volume: Optional[torch.Tensor] = None,
                prev_stage_embed: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        """noisy_volume (B, 1, D, H, W), xray_features (B, C, H′, W′), cond
        (B, 1024), prev_stage_volume (B, 1, D′, H″, W″) or None,
        prev_stage_embed (B, 256) or None → (B, 1, D, H, W) in ``dtype``."""
        x = noisy_volume.to(self.dtype)
        if self.use_depth_lifting:
            if self.remat and torch.is_grad_enabled():
                prior = checkpoint(self.depth_lifter, xray_features, prev_stage_volume,
                                   use_reentrant=False)
            else:
                prior = self.depth_lifter(xray_features, prev_stage_volume)
            prior = self.depth_to_volume(prior)
            prior = resize_trilinear(prior, self.volume_size, align_corners=True)
            x = torch.cat([x, prior.to(x.dtype)], dim=1)  # (B, 17, D, H, W)
        context = xray_features.flatten(2).transpose(1, 2)  # (B, H′·W′, C), row-major
        return self.vit_backbone(x, context, cond, seed, prev_stage_embed)


class UnifiedHybridViTCascade(nn.Module):
    """Multi-stage diffusion cascade with physics loss (JAX
    ``diffusion.py:156-285``). ``stage_configs`` is the ladder of dicts
    (``name``, ``volume_size``, ``voxel_dim``, ``vit_depth``, ``num_heads``,
    ``use_depth_lifting``, ``use_physics_loss``, optional ``physics_weight``);
    every stage of it is built. Stages after the first condition on a
    previous volume (``prev_proj_{name}`` over its mean, the lifter's fusion,
    the blocks' previous-stage embedding).

    ``forward(x_start (B, 1, D, H, W), xrays (B, V, 1, S, S), stage_name,
    generator, ...)``: ``mode="loss"`` draws t ~ U{0..T−1} and the noise from
    ``generator`` (or takes ``t`` and ``noise``) and returns {loss,
    diffusion_loss, physics_loss}; ``mode="denoise"`` takes x_start as x_t
    and ``t`` (B,) and returns the raw v / ε prediction (B, 1, D, H, W) in
    fp32. ``train=True`` uses batch-statistics BatchNorm (running statistics
    updated) and dropout seeded from ``generator``."""

    def __init__(self, stage_configs: Sequence[Dict], xray_embed_dim: int = 512,
                 num_timesteps: int = 1000, v_parameterization: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False, lift_slabs: int = 0):
        super().__init__()
        self.stage_configs = tuple(dict(c) for c in stage_configs)
        self.num_timesteps = num_timesteps
        self.v_parameterization = v_parameterization
        self.dtype = dtype
        self.Dense_0 = Linear(1, TIME_EMBED_DIM, dtype=dtype)
        self.Dense_1 = Linear(TIME_EMBED_DIM, TIME_EMBED_DIM, dtype=dtype)
        self.xray_encoder = XrayConditioningModule(embed_dim=xray_embed_dim,
                                                   time_embed_dim=TIME_EMBED_DIM,
                                                   cond_dim=COND_DIM, dtype=dtype)
        for i, cfg in enumerate(self.stage_configs):
            name = cfg["name"]
            if i > 0:
                self.add_module(f"prev_proj_{name}", Linear(1, 256, dtype=dtype))
            self.add_module(f"stage_{name}", UnifiedCascadeStage(
                tuple(cfg["volume_size"]), cfg["voxel_dim"], cfg["vit_depth"], cfg["num_heads"],
                xray_embed_dim, use_prev_stage=i > 0,
                use_depth_lifting=cfg.get("use_depth_lifting", True), dtype=dtype, remat=remat,
                lift_slabs=lift_slabs))
        self.schedule = NoiseSchedule(num_timesteps, "cosine")
        number_dropout_sites(self)

    def stage_index(self, stage_name: str) -> int:
        return [c["name"] for c in self.stage_configs].index(stage_name)

    def forward(self, x_start: torch.Tensor, xrays: torch.Tensor, stage_name: str,
                generator: Optional[torch.Generator] = None,
                prev_stage_volume: Optional[torch.Tensor] = None, train: bool = False,
                mode: str = "loss", t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None):
        dev = x_start.device
        B = x_start.shape[0]
        T = self.num_timesteps
        sched = self.schedule
        if mode not in ("loss", "denoise"):
            raise ValueError(f"mode {mode!r}")
        if t is None:
            if mode == "denoise":
                raise ValueError("mode='denoise' needs the timesteps t")
            t = _draw(lambda g, d: torch.randint(0, T, (B,), generator=g, device=d),
                      generator, dev)
        t = torch.as_tensor(t, device=dev).long()
        if mode == "denoise":
            x_noisy = x_start.float()
        else:
            if noise is None:
                noise = _draw(lambda g, d: torch.randn(x_start.shape, generator=g, device=d),
                              generator, dev)
            x_noisy = sched.q_sample(x_start.float(), t, noise.float())
        seed = None
        if train:
            seed = int(_draw(lambda g, d: torch.randint(0, 1 << 62, (1,), generator=g, device=d),
                             generator, dev))

        te = self.Dense_1(F.silu(self.Dense_0((t.float() / T)[:, None])))
        _, cond, feats = self.xray_encoder(xrays, te, train)

        idx = self.stage_index(stage_name)
        cfg = self.stage_configs[idx]
        prev_embed = prev_vol = None
        if prev_stage_volume is not None and idx > 0:
            prev_vol = prev_stage_volume
            gap = prev_vol.float().mean(dim=(2, 3, 4))  # (B, 1)
            prev_embed = getattr(self, f"prev_proj_{stage_name}")(gap)
        predicted = getattr(self, f"stage_{stage_name}")(
            x_noisy, feats, cond, prev_vol, prev_embed, seed).float()
        if mode == "denoise":
            return predicted

        if self.v_parameterization:
            target = sched.v_target(x_start.float(), noise.float(), t)
            pred_x0 = sched.pred_x_start_from_v(x_noisy, predicted, t)
        else:
            target = noise.float()
            pred_x0 = sched.pred_x_start_from_eps(x_noisy, predicted, t)
        diffusion_loss = ((predicted - target) ** 2).mean()

        physics_loss = torch.zeros((), dtype=torch.float32, device=dev)
        if cfg.get("use_physics_loss", True):
            x0 = pred_x0.clamp(-1.5, 1.5)[:, 0]  # (B, D, H, W)
            views = []
            for v in range(xrays.shape[1]):
                drr = drr_beer_lambert(x0, "lateral" if v == 1 else "ap")
                tgt = xrays[:, v, 0].float()
                drr = resize_bilinear(drr, tgt.shape[-2:], align_corners=True)
                views.append(((drr - tgt) ** 2).mean())
            physics_loss = sum(views) / len(views)
        total = diffusion_loss + cfg.get("physics_weight", 0.3) * physics_loss
        return {"loss": total, "diffusion_loss": diffusion_loss, "physics_loss": physics_loss}


def load_ladder_state(model: UnifiedHybridViTCascade, state: Dict[str, torch.Tensor]) -> list:
    """Load ``state`` into the ladder, strict in what it holds: the whole
    ladder (the port's own entries), or one stage's ``stage_{name}`` and
    ``prev_proj_{name}`` with the shared encoder and time MLP and no other
    stage: the layout the JAX ``fit_diffusion`` writes, whose variables hold
    only the stage it trains. Every key of ``state`` must be the model's, at
    its shape, and the keys it lacks exactly those of the other stages; the
    other stages keep their values. Returns the names of the stages loaded."""
    names = [c["name"] for c in model.stage_configs]

    def stage_of(key: str) -> Optional[str]:
        top = key.split(".", 1)[0]
        for n in names:
            if top in (f"stage_{n}", f"prev_proj_{n}"):
                return n
        return None
    own = model.state_dict()
    held = {stage_of(k) for k in state} - {None}
    if len(held) != 1:
        model.load_state_dict(state, strict=True)
        return names
    others = {k for k in own if stage_of(k) not in (None, *held)}
    missing, extra = set(own) - set(state), set(state) - set(own)
    if extra or missing != others:
        raise RuntimeError(
            f"a diffusion entry holding stage {sorted(held)[0]!r} alone must hold every key of "
            f"that stage, the shared encoder and the time MLP, and no other: unexpected "
            f"{sorted(extra)[:5]}, missing {sorted(missing - others)[:5]}")
    model.load_state_dict({**own, **state}, strict=True)
    return sorted(held)


def _draw(fn, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """fn(generator, its device) drawn where the generator lives (the default
    generator on ``device`` when None), moved to ``device``."""
    where = generator.device if generator is not None else device
    return fn(generator, where).to(device)


@torch.no_grad()
def ddim_sample(model: UnifiedHybridViTCascade, xrays: torch.Tensor, stage_name: str,
                generator: Optional[torch.Generator] = None, num_steps: int = 20,
                prev_stage_volume: Optional[torch.Tensor] = None,
                x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic DDIM (η = 0) sampling of one stage (JAX
    ``diffusion.py:288-335``), v-parameterised:
        x0 = √ᾱ·x_t − √(1−ᾱ)·v,  ε = √(1−ᾱ)·x_t + √ᾱ·v,
        x_{t′} = √ᾱ′·x0 + √(1−ᾱ′)·ε,
    x0 clamped to ±1.5; the last step returns x0. x_T (B, 1, D, H, W) is
    drawn from ``generator`` unless given. Returns fp32."""
    dev = xrays.device
    B = xrays.shape[0]
    volume_size = tuple(model.stage_configs[model.stage_index(stage_name)]["volume_size"])
    sched = model.schedule
    sa, so = sched.sqrt_alphas_cumprod, sched.sqrt_one_minus_alphas_cumprod
    ts = ddim_timesteps(model.num_timesteps, num_steps)
    if x_T is None:
        x_T = _draw(lambda g, d: torch.randn((B, 1, *volume_size), generator=g, device=d),
                    generator, dev)
    x = x_T.float().to(dev)
    for i in range(num_steps):
        t = torch.full((B,), int(ts[i]), dtype=torch.long, device=dev)
        v = model(x, xrays, stage_name, prev_stage_volume=prev_stage_volume, train=False,
                  mode="denoise", t=t)
        x0 = sched.pred_x_start_from_v(x, v, t).clamp(-1.5, 1.5)
        if i + 1 == num_steps:
            return x0
        eps = so[t].reshape(-1, 1, 1, 1, 1) * x + sa[t].reshape(-1, 1, 1, 1, 1) * v
        tn = torch.full((B,), int(ts[i + 1]), dtype=torch.long, device=dev)
        x = sa[tn].reshape(-1, 1, 1, 1, 1) * x0 + so[tn].reshape(-1, 1, 1, 1, 1) * eps
    return x


def cascaded_ddim_sample(model: UnifiedHybridViTCascade, xrays: torch.Tensor,
                         generator: Optional[torch.Generator] = None, num_steps: int = 20,
                         x_T: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Progressive DDIM sampling (JAX ``diffusion.py:338-367``): each stage of
    the ladder in order, every refiner conditioned on the previous stage's
    generated volume. x_T {stage: (B, 1, D, H, W)} gives a stage's initial
    noise; otherwise it is drawn from ``generator``. Returns {stage_name:
    (B, 1, D, H, W)}."""
    out: Dict[str, torch.Tensor] = {}
    prev = None
    for cfg in model.stage_configs:
        name = cfg["name"]
        vol = ddim_sample(model, xrays, name, generator, num_steps, prev_stage_volume=prev,
                          x_T=(x_T or {}).get(name))
        out[name] = vol
        prev = vol
    return out
