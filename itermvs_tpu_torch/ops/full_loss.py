"""The multi-term training loss (the counterpart of
itermvs_tpu/models/losses.py:24-97, `_masked_mean`, `_bce_with_logits`
and `full_loss`, which XLA fuses under `jit`), kernels K23 `full_loss`
and its backward K24 `full_loss_grad`, and `FullLoss`, the autograd
Function that runs them.

With n predictions, decay cᵢ = 0.8^(n−i−1), norm(d) the depth
normalisation (ops/depth_range.py, in float32), ĝ = norm(GT level 2),
ĝ₀ = norm(GT level 0), m₁ = (mask level 2 > 0.5), m₀ = (mask level 0 >
0.5), gt = ⌊clamp(ĝ, 0, 1)·255·m₁⌋ and wᵢ = (|gt − argmax pᵢ| ≤ 4), the
loss is Σₜ coeffₜ · Sₜ / countₜ over the terms t (0 where countₜ = 0):
    t   term    coeffₜ       Sₜ = Σ over the pixels of          countₜ
    0   init    256·0.8ⁿ     |norm(initial) − ĝ|·m₁             Σm₁
    1   up      256          |norm(upsampled) − ĝ₀|·m₀ (level 0) Σm₀
    then per prediction i, in stage 2 (regress) three terms,
        ce_i    cᵢ           −log(max(pᵢ[gt], 1e-5))·m₁         Σm₁
        win_i   256·cᵢ       |norm(combineᵢ) − ĝ|·m₁·wᵢ         Σm₁·wᵢ
        bce_i   cᵢ           bce(confᵢ, |norm(combineᵢ) − ĝ| < 0.002)·m₁   Σm₁
    and in stage 1 ce_i alone: 17 terms at n = 5 in stage 2, 7 in stage 1.
In a process group each count is the global batch's (one all-reduce of
the count vector) and the loss is this rank's share, local sums over
global counts, as `_masked_mean` makes it.

K23 reads each probability once (NCHW storage, a thread per pixel, the
256 bins strided by H·W) and writes every term's sum and count in
float64, folded in a fixed order (no atomics: two launches are
bit-equal), and saves for the backward pᵢ at the GT bin, gt and wᵢ.
Torch ops on the [T] vectors then form the loss. K24 writes, from
those and the upstream gradient, ∂pᵢ (dense NCHW [B, 256, H, W], the
layout K7 reads in place: zero except at the GT bin), ∂combineᵢ,
∂confidenceᵢ, ∂initial and ∂upsampled, with u = (g·coeffₜ)/countₜ
(0 where countₜ = 0) and each operation rounded in float32 in the order
of autograd's backward of the plain forward (so the float32 formula is
within one unit in the last place of autograd's result):
    ∂pᵢ[gt] = (0 + −(u·m₁)) / max(p, 1e-5) where p ≥ 1e-5, else 0
    ∂d      = −((v·sgn δ) / (idmin − idmax)) · (r·r) for an L1 term's depth
              d, v = u·mask, δ = norm(d) − its GT, r = 1/(d + 1e-5)
    ∂l      = (−((v/(x + 1))·x)·sgn l + (−v)·t) + (l ≥ 0 ? v : 0) for a
              confidence logit l, v = u·m₁, x = exp(−|l|), t its target.
Tie rules (PyTorch's, which JAX does not share): the clamp at p = 1e-5
and at l = 0 passes the gradient (`jnp.clip`/`jnp.maximum` split it);
sgn(0) = 0, so |x|'s gradient at 0 is 0 in both.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/full_loss.cu, csrc/full_loss_grad.cu, sharing csrc/full_loss.cuh;
float32 only: every loss input is float32 in both precisions) or raise;
only CPU tensors take the plain PyTorch versions beside them. A
probability whose storage is not dense NCHW (the model's `permute` view
of its [B, 256, H, W] output), or a depth, confidence, GT or mask that is
not contiguous, is copied once and counted on `full_loss_terms.copies`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.ops.depth_range import depth_normalization
from itermvs_tpu_torch.ops.depth_readout import NUM_BINS, RADIUS
from itermvs_tpu_torch.parallel.mesh import all_reduce_sum, is_initialized

MAX_PREDICTIONS = 16    # the kernels' pointer arrays
CONF_THRESHOLD = 0.002
P_MIN = 1e-5


# ------------------------------------------------------------------ plain forward
def _masked_mean(x, mask):
    count = mask.sum()
    if is_initialized():
        count = all_reduce_sum(count.detach())
    mean = (x * mask).sum() / torch.clamp(count, min=1.0)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


def _bce_with_logits(logits, targets):
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def full_loss_plain(outputs, depths_gt, masks, depth_min, depth_max, regress=True):
    """The loss in eager PyTorch (models/losses.py's arguments): what the
    port ran before K23 and K24, and runs on the CPU."""
    batch = depth_min.shape[0]
    idmin = (1.0 / depth_min).reshape(batch, 1, 1, 1)
    idmax = (1.0 / depth_max).reshape(batch, 1, 1, 1)

    mask_0 = (masks["level_0"] > 0.5).float()
    mask_1 = (masks["level_2"] > 0.5).float()
    depth_gt_0 = depths_gt["level_0"]
    depth_gt_1 = depths_gt["level_2"]

    norm_gt = depth_normalization(depth_gt_1, idmin, idmax)          # [B,H,W,1]
    gt_index = torch.clamp(norm_gt, 0.0, 1.0) * (NUM_BINS - 1)
    gt_index = torch.floor(gt_index * mask_1).long()                 # [B,H,W,1]

    probabilities = outputs["depths"]["probability"]
    combines = outputs["depths"]["combine"]
    confidences = outputs["confidences"]
    num_prediction = len(combines)

    # 1. Initialization sweep depth.
    init_norm = depth_normalization(outputs["depths"]["initial"][0], idmin, idmax)
    loss = 0.8 ** num_prediction * NUM_BINS * _masked_mean(
        (init_norm - norm_gt).abs(), mask_1)

    for i in range(num_prediction):
        coeff = 0.8 ** (num_prediction - i - 1)
        probability = torch.clamp(probabilities[i], min=1e-5)         # [B,H,W,256]
        # The one-hot cross-entropy: −log p at the GT bin.
        ce = -torch.log(probability).gather(-1, gt_index)
        loss = loss + coeff * _masked_mean(ce, mask_1)

        if regress:
            pred_index = probability.argmax(dim=-1, keepdim=True)
            in_window = ((gt_index >= pred_index - RADIUS)
                         & (gt_index <= pred_index + RADIUS)).float()
            norm_depth = depth_normalization(combines[i], idmin, idmax)
            loss = loss + coeff * NUM_BINS * _masked_mean(
                (norm_depth - norm_gt).abs(), mask_1 * in_window)

            conf_gt = ((norm_depth.detach() - norm_gt).abs() < 0.002).float()
            bce = _bce_with_logits(confidences[i], conf_gt)
            loss = loss + coeff * _masked_mean(bce, mask_1)

    # 5. Upsampled final depth at full crop resolution.
    norm_gt_0 = depth_normalization(depth_gt_0, idmin, idmax)
    norm_up = depth_normalization(outputs["depths_upsampled"][0], idmin, idmax)
    return loss + NUM_BINS * _masked_mean((norm_up - norm_gt_0).abs(), mask_0)


# ------------------------------------------------------------------ the terms
def term_count(n: int, regress: bool) -> int:
    """T, the terms of n predictions (module docstring)."""
    return 2 + n * (3 if regress else 1)


def coefficients(n: int, regress: bool) -> list[float]:
    """coeffₜ of each term as the plain forward forms it (Python floats,
    rounded to float32 where they multiply a float32 tensor)."""
    out = [0.8 ** n * NUM_BINS, NUM_BINS]
    for i in range(n):
        c = 0.8 ** (n - i - 1)
        out += [c, c * NUM_BINS, c] if regress else [c]
    return out


@functools.lru_cache(maxsize=None)
def _coefficients_on(n: int, regress: bool, device: torch.device) -> torch.Tensor:
    """`coefficients` as a float64 tensor on `device`, made once."""
    return torch.tensor(coefficients(n, regress), dtype=torch.float64, device=device)


class LossInputs(NamedTuple):
    """The loss's tensors as the kernels read them: depth_min, depth_max
    [B]; gt2, m2, initial and each combine and confidence [B, H, W]
    (level 2); gt0, m0, up [B, H0, W0] (level 0); each probability
    [B, 256, H, W]."""
    dmin: torch.Tensor
    dmax: torch.Tensor
    gt2: torch.Tensor
    m2: torch.Tensor
    gt0: torch.Tensor
    m0: torch.Tensor
    initial: torch.Tensor
    up: torch.Tensor
    probs: tuple
    combines: tuple
    confs: tuple


def loss_tensors(outputs, depths_gt, masks, depth_min, depth_max, regress=True) -> tuple:
    """models/losses.py's arguments as `FullLoss` takes them: (dmin, dmax,
    gt2, m2, gt0, m0, initial, up, *probs, *combines, *confs), the [B, H,
    W, C] tensors as they are (the model's outputs are `permute` views of
    NCHW); in stage 1 no combine or confidence."""
    depths = outputs["depths"]
    n = len(depths["probability"])
    return (depth_min, depth_max, depths_gt["level_2"], masks["level_2"], depths_gt["level_0"],
            masks["level_0"], depths["initial"][0], outputs["depths_upsampled"][0],
            *depths["probability"],
            *((*depths["combine"][:n], *outputs["confidences"][:n]) if regress else ()))


def loss_inputs(regress: bool, *tensors) -> LossInputs:
    """`LossInputs` of `loss_tensors`: views, nothing copied (each
    probability's [B, 256, H, W] view of the [B, H, W, 256] one, each
    [B, H, W, 1] tensor's plane)."""
    plane = lambda x: x[..., 0]
    n = (len(tensors) - 8) // (3 if regress else 1)
    rest = tensors[8 + n:]
    return LossInputs(*tensors[:2], *map(plane, tensors[2:8]),
                      tuple(p.permute(0, 3, 1, 2) for p in tensors[8:8 + n]),
                      tuple(map(plane, rest[:len(rest) // 2])),
                      tuple(map(plane, rest[len(rest) // 2:])))


def _decisions(inp: LossInputs):
    """What the loss decides in the inputs' own dtype, as the plain
    forward does: (idmin, idmax [B, 1, 1], m₁, m₀, ĝ, ĝ₀, gt [B, H, W]
    int64)."""
    b = inp.dmin.shape[0]
    idmin, idmax = (1.0 / inp.dmin).reshape(b, 1, 1), (1.0 / inp.dmax).reshape(b, 1, 1)
    dt = inp.gt2.dtype
    m1, m0 = (inp.m2 > 0.5).to(dt), (inp.m0 > 0.5).to(dt)
    ngt = depth_normalization(inp.gt2, idmin, idmax)
    gt = torch.floor(torch.clamp(ngt, 0.0, 1.0) * (NUM_BINS - 1) * m1).long()
    return idmin, idmax, m1, m0, ngt, depth_normalization(inp.gt0, idmin, idmax), gt


def loss_terms_plain(inp: LossInputs, regress: bool, acc=None, argmax=False):
    """Plain version of K23: (stats [2, T] float64, each term's sum over
    these pixels and its count; saved (p at the GT bin [n, B, H, W],
    flags [n + 1, B, H, W] uint8: gt, then each wᵢ); the argmax [n, B, H,
    W] int32 where `argmax`, else None). The depth normalisation and every
    decision (masks, gt, argmax, wᵢ, the confidence target) in the
    inputs' dtype as the plain forward takes them; each pixel's term in
    `acc` (the inputs' dtype by default; float64 is chip_smoke's
    reference) from those; the sums in float64."""
    acc = acc or inp.gt2.dtype
    idmin, idmax, m1, m0, ngt, ngt0, gt = _decisions(inp)
    n = len(inp.probs)
    w = lambda x: x.to(acc)
    l1 = lambda d, ref, ranges: (w(depth_normalization(d, *ranges)) - w(ref)).abs()
    ranges = (idmin, idmax)
    values = [l1(inp.initial, ngt, ranges) * w(m1), l1(inp.up, ngt0, ranges) * w(m0)]
    counts = [m1, m0]
    p_gt, flags, arg = [], [gt.to(torch.uint8)], []
    for i, prob in enumerate(inp.probs):
        p = prob.gather(1, gt[:, None])[:, 0]
        p_gt.append(p)
        values.append(-torch.log(torch.clamp(w(p), min=P_MIN)) * w(m1))
        counts.append(m1)
        if not regress:
            continue
        a = torch.clamp(prob, min=P_MIN).argmax(dim=1)
        arg.append(a.int())
        inw = ((gt >= a - RADIUS) & (gt <= a + RADIUS)).to(m1.dtype)
        flags.append(inw.to(torch.uint8))
        nd = depth_normalization(inp.combines[i], idmin, idmax)
        diff = (w(nd) - w(ngt)).abs()
        target = ((nd - ngt).abs() < CONF_THRESHOLD).to(acc)
        values += [diff * w(m1 * inw), _bce_with_logits(w(inp.confs[i]), target) * w(m1)]
        counts += [m1 * inw, m1]
    if not regress:
        flags += [torch.zeros_like(flags[0])] * n
    sums = torch.stack([v.double().sum() for v in values])
    stats = torch.stack([sums, torch.stack([c.double().sum() for c in counts])])
    return stats, (torch.stack(p_gt), torch.stack(flags)), torch.stack(arg) if argmax and arg \
        else None


def loss_of(stats, counts, n: int, regress: bool, dtype=torch.float32) -> torch.Tensor:
    """Σₜ coeffₜ · Sₜ / max(countₜ, 1) over the terms with countₜ > 0,
    from K23's sums and the (global) counts, in float64, as `dtype`."""
    coeff = _coefficients_on(n, regress, stats.device)
    weight = torch.where(counts > 0, coeff / counts.clamp(min=1.0), 0.0)
    return (stats[0] * weight).sum().to(dtype)


# ------------------------------------------------------------------ plain backward
def term_grads(grad, counts, n, regress, acc=torch.float32) -> torch.Tensor:
    """u [T] in `acc`: autograd's upstream of each term's masked sum,
    where(countₜ > 0, g·coeffₜ, 0) / max(countₜ, 1), each op rounded in
    `acc` (coeffₜ rounded to `acc` first)."""
    coeff = torch.tensor(coefficients(n, regress), dtype=acc, device=counts.device)
    cnt = counts.to(acc)
    scaled = grad.to(acc) * coeff
    return torch.where(cnt > 0, scaled, torch.zeros_like(scaled)) / torch.clamp(cnt, min=1.0)


def _l1_grad(v, delta, den, d, acc):
    """∂d of an L1 term |norm(d) − ref|·mask with v = u·mask: autograd's
    chain through the abs, the normalisation's divide and reciprocal."""
    r = 1.0 / (d.to(acc) + 1e-5)
    return -((v * torch.sgn(delta).to(acc)) / den) * (r * r)


def _bce_grad(v, l, target):
    """∂l of bce(l, target)·m₁ with v = u·m₁, the three paths summed as
    autograd accumulates them: (|l|'s, l·t's) then the clamp's."""
    x = torch.exp(-l.abs())
    through_abs = (-((v / (x + 1)) * x)) * torch.sgn(l)
    through_mul = (-v) * target
    through_clamp = torch.where(l >= 0, v, torch.zeros_like(v))
    return (through_abs + through_mul) + through_clamp


def full_loss_grad_plain(grad, counts, saved, inp: LossInputs, regress: bool, acc=None):
    """Plain version of K24: (∂p [n, B, 256, H, W], ∂small [1 + 2n', B, H,
    W]: ∂initial, then each ∂combine and each ∂confidence (n' = n in
    stage 2, 0 in stage 1), ∂up [B, H0, W0]) from the upstream gradient
    `grad` (0-dim), the global `counts` [T], K23's `saved` and the inputs,
    in `acc` (the inputs' dtype by default: the float32 formula, bit-equal
    to autograd of the plain forward; float64 is chip_smoke's reference),
    with the decisions in the inputs' dtype."""
    acc = acc or inp.gt2.dtype
    n = len(inp.probs)
    p_gt, flags = saved
    idmin, idmax, m1, m0, ngt, ngt0, gt = _decisions(inp)
    u = term_grads(grad, counts, n, regress, acc)
    w = lambda x: x.to(acc)
    den = w(idmin) - w(idmax)
    d_init = _l1_grad(u[0] * w(m1), depth_normalization(inp.initial, idmin, idmax) - ngt, den,
                      inp.initial, acc)
    d_up = _l1_grad(u[1] * w(m0), depth_normalization(inp.up, idmin, idmax) - ngt0, den,
                    inp.up, acc)
    b, h, wd = inp.gt2.shape
    d_prob = torch.zeros(n, b, NUM_BINS, h, wd, dtype=acc, device=inp.gt2.device)
    d_comb, d_conf = [], []
    per = 3 if regress else 1
    for i in range(n):
        p = w(p_gt[i])
        ce = (0.0 + -(u[2 + per * i] * w(m1))) / torch.clamp(p, min=P_MIN)
        d_prob[i].scatter_(1, gt[:, None], torch.where(p_gt[i] >= P_MIN, ce,
                                                       torch.zeros_like(ce))[:, None])
        if regress:
            mask_w = m1 * flags[1 + i].to(m1.dtype)
            delta = depth_normalization(inp.combines[i], idmin, idmax) - ngt
            d_comb.append(_l1_grad(u[3 + per * i] * w(mask_w), delta, den, inp.combines[i],
                                   acc))
            target = (delta.abs() < CONF_THRESHOLD).to(acc)
            d_conf.append(_bce_grad(u[4 + per * i] * w(m1), w(inp.confs[i]), target))
    return d_prob, torch.stack([d_init, *d_comb, *d_conf]), d_up


# ------------------------------------------------------------------ the kernels
THREADS, LEVEL0_PER_THREAD = 256, 4       # csrc/full_loss.cuh kThreads, kLevel0


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(tensors), 1))(*(t.data_ptr() for t in tensors))


def kernel_inputs(inp: LossInputs) -> LossInputs:
    """`inp` in the kernels' layouts: each probability's NCHW storage where
    it is dense, every other tensor where it is contiguous; anything else
    copied once and counted on `full_loss_terms.copies`."""
    def dense(t):
        if t.is_contiguous():
            return t
        full_loss_terms.copies += 1
        return t.contiguous()

    return LossInputs(*map(dense, inp[:8]), tuple(map(dense, inp.probs)),
                      tuple(map(dense, inp.combines)), tuple(map(dense, inp.confs)))


def _check(name: str, inp: LossInputs, regress: bool) -> None:
    """Raise unless `inp` has the loss's shapes (`LossInputs`), every
    tensor is float32 and (off the CPU) all lie on one CUDA device."""
    n, b = len(inp.probs), inp.dmin.shape[0] if inp.dmin.dim() == 1 else 0
    if not (b and inp.dmax.shape == (b,) and inp.gt2.dim() == 3 and inp.gt0.dim() == 3
            and inp.gt2.shape[0] == inp.gt0.shape[0] == b):
        raise ValueError(f"{name}: needs the depth range [B] and the GT [B, H, W] at both "
                         f"levels, got {[tuple(t.shape) for t in inp[:6]]}")
    if not (1 <= n <= MAX_PREDICTIONS and len(inp.combines) == len(inp.confs)
            == (n if regress else 0)):
        raise ValueError(f"{name}: needs 1 to {MAX_PREDICTIONS} probabilities and, in stage "
                         f"2 only, a combine and a confidence each, got {n}, "
                         f"{len(inp.combines)}, {len(inp.confs)}")
    plane, plane0 = inp.gt2.shape, inp.gt0.shape
    level2, level0 = [inp.m2, inp.initial, *inp.combines, *inp.confs], [inp.m0, inp.up]
    if any(t.shape != plane for t in level2) or any(t.shape != plane0 for t in level0):
        raise ValueError(f"{name}: level-2 tensors must be {tuple(plane)} and level-0 ones "
                         f"{tuple(plane0)}, got {[tuple(t.shape) for t in level2 + level0]}")
    if any(p.shape != (b, NUM_BINS, *plane[1:]) for p in inp.probs):
        raise ValueError(f"{name}: probabilities must be {(b, NUM_BINS, *plane[1:])}, got "
                         f"{[tuple(p.shape) for p in inp.probs]}")
    tensors = [*inp[:8], *inp.probs, *inp.combines, *inp.confs]
    device = inp.dmin.device
    dtypes = {t.dtype for t in tensors}
    if dtypes != {torch.float32} and (device.type != "cpu" or dtypes != {torch.float64}):
        raise ValueError(f"{name}: needs float32 tensors (float64 too on the CPU), got "
                         f"{sorted(map(str, dtypes))}")
    if device.type != "cpu" and (device.type != "cuda"
                                 or any(t.device != device for t in tensors)):
        raise ValueError(f"{name}: needs the inputs on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")


def _blocks(inp: LossInputs) -> int:
    """K23's blocks: n per THREADS level-2 pixels, one per THREADS ·
    LEVEL0_PER_THREAD level-0 pixels."""
    return (len(inp.probs) * -(-inp.gt2.numel() // THREADS)
            + -(-inp.gt0.numel() // (THREADS * LEVEL0_PER_THREAD)))


def terms_buffers(inp: LossInputs, regress: bool):
    """K23's outputs and scratch: (stats [2, T] float64, p at the GT bin
    [n, B, H, W] float32, flags [n + 1, B, H, W] uint8, partials float64
    [blocks, 6])."""
    n, dev = len(inp.probs), inp.gt2.device
    return (torch.empty(2, term_count(n, regress), dtype=torch.float64, device=dev),
            torch.empty(n, *inp.gt2.shape, device=dev),
            torch.empty(n + 1, *inp.gt2.shape, dtype=torch.uint8, device=dev),
            torch.empty(_blocks(inp), 6, dtype=torch.float64, device=dev))


def _shape_args(inp: LossInputs) -> tuple:
    b, h, w = inp.gt2.shape
    return (inp.initial.data_ptr(), inp.up.data_ptr(), inp.gt2.data_ptr(), inp.m2.data_ptr(),
            inp.gt0.data_ptr(), inp.m0.data_ptr(), inp.dmin.data_ptr(), inp.dmax.data_ptr(),
            b, h * w, inp.gt0[0].numel())


def full_loss_args(inp: LossInputs, regress, stats, p_gt, flags, partials, argmax=None):
    """K23's C arguments for checked kernel inputs (`kernel_inputs`),
    writing `terms_buffers`' tensors and, where given, the argmax [n, B,
    H, W] int32."""
    return (_pointers(inp.probs), _pointers(inp.combines), _pointers(inp.confs),
            len(inp.probs), int(regress), *_shape_args(inp), p_gt.data_ptr(), flags.data_ptr(),
            None if argmax is None else argmax.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), torch.cuda.current_stream().cuda_stream)


def _launch(name: str, args: tuple) -> None:
    kernels.check_launch(name, kernels.function(name)(*args))


def full_loss_terms(inp: LossInputs, regress: bool):
    """K23 (its plain version `loss_terms_plain` on the CPU): (stats [2, T]
    float64, saved (p at the GT bin, flags))."""
    _check("full_loss", inp, regress)
    if inp.dmin.device.type == "cpu":
        with torch.no_grad():
            return loss_terms_plain(inp, regress)[:2]
    inp = kernel_inputs(inp)
    stats, p_gt, flags, partials = terms_buffers(inp, regress)
    with torch.cuda.device(inp.gt2.device):
        _launch("full_loss", full_loss_args(inp, regress, stats, p_gt, flags, partials))
    full_loss_terms.launches += 1
    return stats, (p_gt, flags)


def grad_buffers(inp: LossInputs, regress: bool):
    """K24's outputs, float32: (∂p, one [B, 256, H, W] per prediction,
    each freed when K7 has read it; ∂small [1 + 2n', B, H, W]; ∂up [B,
    H0, W0], the last two from one allocation)."""
    n, (b, h, w) = len(inp.probs), inp.gt2.shape
    small = (1 + (2 * n if regress else 0)) * b * h * w
    d_prob = [torch.empty(b, NUM_BINS, h, w, device=inp.gt2.device) for _ in range(n)]
    d_small, d_up = torch.empty(small + inp.gt0.numel(), device=inp.gt2.device).split(
        (small, inp.gt0.numel()))
    return d_prob, d_small.view(-1, b, h, w), d_up.view(inp.gt0.shape)


def full_loss_grad_args(inp: LossInputs, regress, grad, counts, saved, outs):
    """K24's C arguments for checked kernel inputs (its probabilities are
    not read): the upstream gradient (float32, one element), the global
    counts [T] float64, K23's `saved` and `grad_buffers`' tensors
    `outs`."""
    d_prob, d_small, d_up = outs
    n = len(d_prob)
    coeff = _coefficients_on(n, regress, grad.device)
    return (_pointers(inp.combines), _pointers(inp.confs), n, int(regress),
            *_shape_args(inp), saved[0].data_ptr(), saved[1].data_ptr(), grad.data_ptr(),
            coeff.data_ptr(), counts.data_ptr(), _pointers(d_prob), d_small.data_ptr(),
            d_up.data_ptr(), torch.cuda.current_stream().cuda_stream)


def full_loss_grad(grad, counts, saved, inp: LossInputs, regress: bool):
    """K24 (its plain version on the CPU): (∂p, ∂small, ∂up) as
    `full_loss_grad_plain` gives them (∂p a list of [B, 256, H, W] on the
    card), from the upstream gradient `grad` (0-dim float32), the global
    counts [T] (float64) and K23's `saved`."""
    _check("full_loss_grad", inp, regress)
    n = len(inp.probs)
    shape = (n, *inp.gt2.shape)
    if (counts.shape != (term_count(n, regress),) or grad.numel() != 1
            or saved[0].shape != shape or saved[1].shape != (n + 1, *shape[1:])):
        raise ValueError(f"full_loss_grad: needs counts [{term_count(n, regress)}], a "
                         f"one-element gradient and K23's saved tensors {shape}, got "
                         f"{tuple(counts.shape)}, {tuple(grad.shape)}, "
                         f"{[tuple(t.shape) for t in saved]}")
    if inp.dmin.device.type == "cpu":
        with torch.no_grad():
            return full_loss_grad_plain(grad, counts, saved, inp, regress)
    outs = grad_buffers(inp, regress)
    inp = kernel_inputs(inp._replace(probs=()))          # K24 reads no probability
    grad = grad.reshape(()).float().contiguous()
    counts = counts.double().contiguous()
    with torch.cuda.device(inp.gt2.device):
        _launch("full_loss_grad", full_loss_grad_args(inp, regress, grad, counts, saved, outs))
    full_loss_grad.launches += 1
    return outs


class FullLoss(torch.autograd.Function):
    """K23 forward, K24 backward (their plain versions on the CPU) over
    `loss_tensors`. Keeps K23's p at the GT bin and flags and the global
    counts for the backward, which is K24's launch and views of its
    outputs."""

    @staticmethod
    def forward(ctx, regress, *tensors):
        inp = loss_inputs(regress, *tensors)
        stats, saved = full_loss_terms(inp, regress)
        # A process group's counts are the global batch's: one all-reduce.
        counts = all_reduce_sum(stats[1]) if is_initialized() else stats[1]
        ctx.regress, ctx.inp, ctx.saved, ctx.counts = regress, inp, saved, counts
        return loss_of(stats, counts, len(inp.probs), regress, inp.gt2.dtype)

    @staticmethod
    def backward(ctx, grad):
        d_prob, d_small, d_up = full_loss_grad(grad, ctx.counts, ctx.saved, ctx.inp,
                                               ctx.regress)
        grads = (None,) * 7 + (d_small[0].unsqueeze(-1), d_up.unsqueeze(-1),
                               *(d.permute(0, 2, 3, 1) for d in d_prob),
                               *d_small[1:].unsqueeze(-1))
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def fused_full_loss(outputs, depths_gt, masks, depth_min, depth_max, regress=True):
    """models/losses.py's `full_loss` through `FullLoss`."""
    return FullLoss.apply(regress, *loss_tensors(outputs, depths_gt, masks, depth_min,
                                                 depth_max, regress))


# Launches of each kernel, and copies of inputs the kernels could not read
# where they lay.
full_loss_terms.launches = full_loss_grad.launches = 0
full_loss_terms.copies = 0
