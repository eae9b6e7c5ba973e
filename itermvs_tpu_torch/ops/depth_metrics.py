"""The training step's depth metrics (the counterpart of
itermvs_tpu/engine/metrics.py:13-63, `_per_image_masked_mean`,
`_batch_mean`, `abs_depth_error`, `threshold_metric` and `depth_metrics`,
which XLA fuses under `jit`: :47 is the call this module replaces), kernel
K27 `depth_metrics`.

With n = num_iters + 1 level-2 predictions est_j (their GT and mask:
level 2) and the upsampled depth (level 0), m = (mask > 0.5) as 0/1 (0.5
is out) and e = |est − gt| in the inputs' dtype (float32 on the card, so
`e > t` decides as JAX's does), each metric is an abs error (v = e) or
an outlier rate (v = [e > t], strict), per image b
    count_b = Σ m,   mean_b = Σ v·m / max(count_b, 1) where count_b > 0, else 0,
and over the batch n = #{b: count_b > 0}, total = Σ_b mean_b·[count_b > 0],
the metric total / max(n, 1) where n > 0, else 0. Each image's mean is
formed in the inputs' dtype, as JAX forms it; n and total are float64
sums, which hold a batch of float32 means exactly in any order, and the
metric is their quotient rounded to that dtype. A NaN or infinite
estimate at a masked-out pixel makes that image's Σ e·m NaN (NaN·0), as
JAX's product does; an outlier rate stays finite (NaN > t is false).
The M = 5 + 2n metrics, in the JAX dict's order (`metric_names`):
abs_error_initial, thres1mm_initial (prediction 0), abs_error_final_full,
thres{1,2,4,8}mm_final_full (level 0), then per iteration j
thres1mm_gru_j and abs_error_gru_j (prediction j).

`depth_metrics` returns (means [M], table [M, 2] float64) with each
metric's (n, total) row, so that a process group sums all the tables in
one all-reduce before it divides (engine/metrics.py). On a CUDA tensor it
launches K27 (csrc/depth_metrics.cu; float32 only: the depths are
float32 in both precisions) or raises: one C call, no host sync. Only
CPU tensors take the plain version, `depth_metrics_plain`, the eager code
the port ran before K27 (with the batch sums in float64).
An input that is not contiguous is copied once and counted on
`depth_metrics.copies`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from itermvs_tpu_torch import kernels

MAX_PREDICTIONS = 16                      # csrc/depth_metrics.cu kMaxPred
THRESHOLDS = (1, 2, 4, 8)                 # the level-0 outlier rates, mm
# csrc/depth_metrics.cu: kThreads, kLevel2 and kLevel0 (pixels per thread),
# kSlots2 and kSlots0 (partial sums per level-2 and level-0 block).
THREADS, LEVEL2, LEVEL0, SLOTS2, SLOTS0 = 256, 4, 8, 1 + 2 * MAX_PREDICTIONS, 6


@functools.lru_cache(maxsize=None)
def metric_names(num_iters: int) -> tuple[str, ...]:
    """The metrics' names in the JAX dict's order (module docstring)."""
    names = ["abs_error_initial", "thres1mm_initial", "abs_error_final_full",
             *(f"thres{t}mm_final_full" for t in THRESHOLDS)]
    for j in range(1, num_iters + 1):
        names += [f"thres1mm_gru_{j}", f"abs_error_gru_{j}"]
    return tuple(names)


# ------------------------------------------------------------------ plain version
def per_image_masked_mean(values, mask):
    """[B, ...] masked mean per image → ([B] means, [B] has-valid flags)."""
    b = values.shape[0]
    v = values.reshape(b, -1)
    m = mask.reshape(b, -1)
    count = m.sum(dim=1)
    means = (v * m).sum(dim=1) / torch.clamp(count, min=1.0)
    means = torch.where(count > 0, means, torch.zeros_like(means))
    return means, (count > 0).to(values.dtype)


def batch_sums(per_image, has_valid):
    """[n, total] of a batch mean in float64: the images with any valid
    pixel, and the sum of their means (an image whose mask is empty
    counts for nothing)."""
    return torch.stack([has_valid.double().sum(), (per_image * has_valid).double().sum()])


def batch_means(table, dtype=torch.float32):
    """The metrics of their [M, 2] (n, total) rows, total / max(n, 1) in
    `dtype`. Where n is 0 every image's mean is 0 (`per_image_masked_mean`),
    so total is 0 and the metric the 0 of JAX's `where`: three ops,
    clamp, div and the cast."""
    return (table[:, 1] / table[:, 0].clamp(min=1.0)).to(dtype)


def abs_error_sums(depth_est, depth_gt, mask):
    """`batch_sums` of the mean |est − gt| over the mask."""
    mask = (mask > 0.5).to(depth_est.dtype)
    return batch_sums(*per_image_masked_mean((depth_est - depth_gt).abs(), mask))


def threshold_sums(depth_est, depth_gt, mask, thres):
    """`batch_sums` of the share of masked pixels with |err| > thres."""
    mask = (mask > 0.5).to(depth_est.dtype)
    outlier = ((depth_est - depth_gt).abs() > thres).to(depth_est.dtype)
    return batch_sums(*per_image_masked_mean(outlier, mask))


def depth_metrics_plain(preds, up, gt2, m2, gt0, m0):
    """Plain version of K27, the eager metrics: (means [M], table [M, 2])
    of the predictions `preds` (level 2, GT `gt2`, mask `m2`) and the
    upsampled depth `up` (level 0, `gt0`, `m0`), in the inputs' dtype."""
    rows = [abs_error_sums(preds[0], gt2, m2), threshold_sums(preds[0], gt2, m2, 1),
            abs_error_sums(up, gt0, m0), *(threshold_sums(up, gt0, m0, t) for t in THRESHOLDS)]
    for est in preds[1:]:
        rows += [threshold_sums(est, gt2, m2, 1), abs_error_sums(est, gt2, m2)]
    table = torch.stack(rows)
    return batch_means(table, preds[0].dtype), table


# ------------------------------------------------------------------ the kernel
def _check(preds, up, gt2, m2, gt0, m0) -> None:
    """Raise unless there are 1 to MAX_PREDICTIONS predictions, each
    level's tensors share one shape, both levels one batch of images with
    pixels, and (off the CPU) every tensor is float32 on one CUDA
    device."""
    if not 1 <= len(preds) <= MAX_PREDICTIONS:
        raise ValueError(f"depth_metrics: needs 1 to {MAX_PREDICTIONS} predictions, got "
                         f"{len(preds)}")
    level2, level0 = (*preds, gt2, m2), (up, gt0, m0)
    shape2, shape0 = gt2.shape, gt0.shape
    if (any(t.shape != shape2 for t in level2) or any(t.shape != shape0 for t in level0)
            or gt2.dim() < 2 or gt0.dim() < 2 or shape2[0] != shape0[0]
            or 0 in (gt2.numel(), gt0.numel())):
        raise ValueError(f"depth_metrics: needs [B, ...] level-2 tensors of one shape and "
                         f"[B, ...] level-0 tensors of one shape, got "
                         f"{[tuple(t.shape) for t in level2 + level0]}")
    device = gt2.device
    if device.type == "cpu" and all(t.device == device for t in level2 + level0):
        return
    if device.type != "cuda" or any(t.device != device or t.dtype != torch.float32
                                    for t in level2 + level0):
        got = sorted({(str(t.device), str(t.dtype)) for t in level2 + level0})
        raise ValueError(f"depth_metrics: needs float32 tensors on one CUDA device (or all on "
                         f"the CPU), got {got}")


def scratch_size(images: int, hw2: int, hw0: int, n: int) -> int:
    """Float64 elements of K27's scratch: each level-2 and level-0 block's
    partial sums, then each image's 2n + 7 sums."""
    blocks2 = -(-hw2 // (THREADS * LEVEL2))
    blocks0 = -(-hw0 // (THREADS * LEVEL0))
    return images * (blocks2 * SLOTS2 + blocks0 * SLOTS0 + 1 + 2 * n + SLOTS0)


def metric_buffers(preds, gt0):
    """K27's (scratch float64, means float32 [M], table float64 [M, 2]) for
    `preds` and a level-0 tensor `gt0`; the table is the scratch's
    allocation's tail."""
    b, m = gt0.shape[0], 5 + 2 * len(preds)
    size = scratch_size(b, preds[0].numel() // b, gt0.numel() // b, len(preds))
    scratch, table = torch.empty(size + 2 * m, dtype=torch.float64,
                                 device=gt0.device).split((size, 2 * m))
    return scratch, torch.empty(m, device=gt0.device), table.view(m, 2)


def metric_args(preds, up, gt2, m2, gt0, m0, scratch, means, table) -> tuple:
    """K27's C arguments for contiguous checked inputs, writing `means` and
    `table` with `scratch` (`metric_buffers`)."""
    b = gt2.shape[0]
    pointers = (ctypes.c_void_p * len(preds))(*(p.data_ptr() for p in preds))
    return (pointers, len(preds), gt2.data_ptr(), m2.data_ptr(), up.data_ptr(), gt0.data_ptr(),
            m0.data_ptr(), b, gt2.numel() // b, gt0.numel() // b, scratch.data_ptr(),
            scratch.numel(), means.data_ptr(), table.data_ptr(),
            torch.cuda.current_stream().cuda_stream)


def _dense(t):
    if t.is_contiguous():
        return t
    depth_metrics.copies += 1
    return t.contiguous()


def depth_metrics(preds, up, gt2, m2, gt0, m0):
    """K27 (its plain version on the CPU): (means [M], table [M, 2]) of
    the predictions `preds` (level 2) and the upsampled depth `up` (level
    0), each [B, ...] with its GT and mask (module docstring)."""
    _check(preds, up, gt2, m2, gt0, m0)
    if gt2.device.type == "cpu":
        with torch.no_grad():
            return depth_metrics_plain(preds, up, gt2, m2, gt0, m0)
    preds = [_dense(p) for p in preds]
    up, gt2, m2, gt0, m0 = map(_dense, (up, gt2, m2, gt0, m0))
    scratch, means, table = metric_buffers(preds, gt0)
    with torch.cuda.device(gt2.device):
        kernels.check_launch("depth_metrics", kernels.function("depth_metrics")(
            *metric_args(preds, up, gt2, m2, gt0, m0, scratch, means, table)))
    depth_metrics.launches += 1
    return means, table


# Launches of the kernel, and copies of inputs it could not read where they lay.
depth_metrics.launches = depth_metrics.copies = 0
