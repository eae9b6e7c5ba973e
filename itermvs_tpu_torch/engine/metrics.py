"""Depth metrics + epoch aggregation (counterpart of
itermvs_tpu/engine/metrics.py).

Metrics are computed per image over the valid mask, then averaged over
the images of the batch that have any valid pixel (in a process group,
of the global batch: both sums of the batch mean are summed over the
ranks, parallel/mesh.py). `depth_metrics` takes the whole set from one
call of ops/depth_metrics.py (K27 on the card). Functions take [B, H, W,
1] maps and return 0-dim tensors, so a step reads them back only when it
logs.
"""
from __future__ import annotations

from itermvs_tpu_torch.ops import depth_metrics as metric_ops
from itermvs_tpu_torch.parallel.mesh import all_reduce_sum, is_initialized


def _batch_mean(row, dtype):
    """A metric in `dtype` of its [n, total] (`metric_ops.batch_sums`), the
    group's where there is one."""
    if is_initialized():
        row = all_reduce_sum(row)
    return metric_ops.batch_means(row[None], dtype)[0]


def abs_depth_error(depth_est, depth_gt, mask):
    """Mean |est − gt| over mask, averaged per image then over batch."""
    return _batch_mean(metric_ops.abs_error_sums(depth_est, depth_gt, mask), depth_est.dtype)


def threshold_metric(depth_est, depth_gt, mask, thres):
    """Fraction of masked pixels with |err| > thres (outlier rate)."""
    return _batch_mean(metric_ops.threshold_sums(depth_est, depth_gt, mask, thres),
                       depth_est.dtype)


def depth_metrics(depths_combine, depth_upsampled, depth_gt, mask, num_iters):
    """The reference's scalar set as a flat dict, in the JAX dict's order:
    0-dim views of one tensor. In a process group the float64 [M, 2]
    table of every metric's (n, total) is summed over the ranks in one
    all-reduce (counted on `depth_metrics.all_reduces`), then divided
    (clamp, div, the cast to the means' dtype)."""
    if len(depths_combine) < num_iters + 1:
        raise ValueError(f"depth_metrics: needs {num_iters + 1} predictions, got "
                         f"{len(depths_combine)}")
    means, table = metric_ops.depth_metrics(
        depths_combine[:num_iters + 1], depth_upsampled, depth_gt["level_2"],
        mask["level_2"], depth_gt["level_0"], mask["level_0"])
    if is_initialized():
        depth_metrics.all_reduces += 1
        means = metric_ops.batch_means(all_reduce_sum(table), means.dtype)
    return dict(zip(metric_ops.metric_names(num_iters), means.unbind()))


# All-reduces the metrics made (one per call in a process group).
depth_metrics.all_reduces = 0


class DictAverageMeter:
    """Running mean of scalar dicts (each update weighs `n`)."""

    def __init__(self):
        self.data: dict[str, float] = {}
        self.count = 0

    def update(self, new_input: dict, n: int = 1):
        self.count += n
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v) * n

    def mean(self):
        return {k: v / self.count for k, v in self.data.items()}
