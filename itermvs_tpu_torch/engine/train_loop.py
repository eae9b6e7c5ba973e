"""Train/val steps, the optimizer and a fresh init (counterpart of
itermvs_tpu/engine/train_loop.py).

The recipe is the JAX package's: global-norm gradient clip 2.0, then
weight decay added to the gradient, then Adam(0.9, 0.999, eps 1e-8), as
`optax.chain(clip_by_global_norm(2.0), add_decayed_weights(wd), adam)`
chains them; MultiStep LR halving at the `--lrepochs` milestones, set
per epoch. The clip is written as optax writes it (`g / norm · 2.0`
where norm ≥ 2.0, untouched below), not as `clip_grad_norm_`, which
scales by `2.0 / (norm + 1e-6)` always. `torch.optim.Adam(weight_decay=)`
adds `wd · param` to the gradient before its moments, as
`add_decayed_weights` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from itermvs_tpu_torch.engine.metrics import depth_metrics
from itermvs_tpu_torch.models.losses import full_loss

CLIP_NORM = 2.0


def parse_lrepochs(lrepochs: str):
    """'4,8,12:2' → (milestone epochs [4,8,12], gamma 1/2)."""
    milestones_str, rate_str = lrepochs.split(":")
    milestones = [int(e) for e in milestones_str.split(",")]
    return milestones, 1.0 / float(rate_str)


def lr_for_epoch(base_lr: float, epoch: int, lrepochs: str) -> float:
    milestones, gamma = parse_lrepochs(lrepochs)
    scale = 1.0
    for m in milestones:
        if epoch >= m:
            scale *= gamma
    return base_lr * scale


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fresh weights with the JAX package's (flax's) initializers, drawn
    from a `torch.Generator` seeded with `seed` (the numbers differ from
    JAX's; the distributions do not):
      * Conv kernels: lecun_normal, a normal truncated at ±2σ and rescaled
        to variance 1/fan_in (fan_in = in_channels · kh · kw);
      * ConvTranspose kernels: variance_scaling(1/3, fan_in, uniform),
        U(±sqrt(1/fan_in)) with fan_in = in_channels · kh · kw;
      * biases 0; BN scale 1, bias 0, running mean 0, running var 1.
    """
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.ConvTranspose2d):
                cin, _, kh, kw = module.weight.shape
                limit = math.sqrt(1.0 / (cin * kh * kw))
                module.weight.uniform_(-limit, limit, generator=gen)
            elif isinstance(module, nn.Conv2d):
                _, cin, kh, kw = module.weight.shape
                # flax: stddev = sqrt(1/fan_in) / .879..., the std of a
                # unit normal truncated at ±2.
                std = math.sqrt(1.0 / (cin * kh * kw)) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=gen)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
                continue
            else:
                continue
            if module.bias is not None:
                module.bias.zero_()
    return model


def make_optimizer(model: nn.Module, wd: float = 0.0) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8) with `wd` added to the gradient; the lr
    is set per step (`train_step`) and kept in the state_dict."""
    return torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=wd)


def clip_by_global_norm_(params, max_norm: float = CLIP_NORM) -> torch.Tensor:
    """optax.clip_by_global_norm on the `.grad`s (every parameter has one),
    in place, without a host sync: where the global norm is ≥ max_norm
    each gradient becomes g / norm · max_norm. Returns the norm before
    clipping."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def forward_loss(model, batch, regress: bool):
    """(loss, outputs) of a train-mode `Pipeline` on a device batch."""
    outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_min"],
                    batch["depth_max"])
    loss = full_loss(outputs, batch["depth"], batch["mask"], batch["depth_min"],
                     batch["depth_max"], regress)
    return loss, outputs


def _scalars(loss, outputs, batch, num_iters):
    with torch.no_grad():
        scalars = {"loss": loss.detach()}
        scalars.update(depth_metrics(
            [d.detach() for d in outputs["depths"]["combine"]],
            outputs["depths_upsampled"][0].detach(), batch["depth"], batch["mask"],
            num_iters))
    return scalars


def train_step(model, optimizer, batch, lr: float, regress: bool, num_iters: int):
    """One step: forward in train mode (BN batch statistics, running ones
    updated), loss, backward, clip, Adam at `lr`. Returns the scalars
    (0-dim tensors on the device: reading them is the only sync)."""
    model.train()
    for group in optimizer.param_groups:
        group["lr"] = lr
    loss, outputs = forward_loss(model, batch, regress)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # A parameter the loss does not reach (stage 1: the confidence head)
    # gets a zero gradient, as under optax, so that Adam and the weight
    # decay still update it.
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_(params)
    optimizer.step()
    return _scalars(loss, outputs, batch, num_iters)


def val_step(model, batch, regress: bool, num_iters: int):
    """Validation: loss and metrics with BN in eval mode, no gradient."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            loss, outputs = forward_loss(model, batch, regress)
            return _scalars(loss, outputs, batch, num_iters)
    finally:
        model.train(was_training)


def to_device_batch(sample, device) -> dict:
    """A collated loader sample (numpy) → the step's batch of tensors on
    `device`: level_0 images (all the model reads), every level of the
    projections, GT depth and mask, and the depth range."""
    def dev(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    return {
        "imgs": {"level_0": dev(sample["imgs"]["level_0"])},
        "proj_matrices": {k: dev(v) for k, v in sample["proj_matrices"].items()},
        "depth": {k: dev(v) for k, v in sample["depth"].items()},
        "mask": {k: dev(v) for k, v in sample["mask"].items()},
        "depth_min": dev(sample["depth_min"]),
        "depth_max": dev(sample["depth_max"]),
    }
