"""Launch counters of the port's hand-written kernels.

Each kernel's wrapper adds one to its counter (`launches`, or
`launches_bf16` for the bfloat16 form) where it launches the kernel, and
nowhere else: a wrapper given CPU tensors runs its plain version and
counts nothing. These read and reset them all, under each kernel's
report name (its source's name, `_bf16` for the bfloat16 form), so that
a caller can check which kernels a run went through.
"""
from __future__ import annotations

from itermvs_tpu_torch.ops.bn_act import bn_act, bn_act_grad
from itermvs_tpu_torch.ops.bn_stats import bn_stats_grad_, bn_sums
from itermvs_tpu_torch.ops.clip_adam import clip_adam_, grad_norm
from itermvs_tpu_torch.ops.consistency import consistency
from itermvs_tpu_torch.ops.depth_metrics import depth_metrics
from itermvs_tpu_torch.ops.conv_gru import gru_reset, gru_reset_grad, gru_update, gru_update_grad
from itermvs_tpu_torch.ops.depth_readout import depth_readout, depth_readout_grad
from itermvs_tpu_torch.ops.full_loss import full_loss_grad, full_loss_terms
from itermvs_tpu_torch.ops.init_depth import init_depth_forward, init_depth_grad
from itermvs_tpu_torch.ops.resize import (
    resize_forward, resize_grad, upsample2x_add, upsample2x_grad)
from itermvs_tpu_torch.ops.sweep import sweep_premul
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue
from itermvs_tpu_torch.ops.sweep_grad import sweep_grad_ref, sweep_grad_src
from itermvs_tpu_torch.ops.upsample import convex_upsample_grad, upsample_depth
from itermvs_tpu_torch.ops.view_aggregate import view_aggregate, view_aggregate_grad
from itermvs_tpu_torch.ops.view_weight import view_weight_forward, view_weight_grad
from itermvs_tpu_torch.ops.warping import fused_sweep_taps

# Every counted wrapper of a kernel with both dtype forms by its report
# name (without `_bf16`), then those of the float32-only kernels.
COUNTERS = {"sweep_premul": sweep_premul, "corr_epilogue": corr_epilogue,
            "sweep_grad_ref": sweep_grad_ref, "sweep_grad_src": sweep_grad_src,
            "depth_readout": depth_readout, "depth_readout_grad": depth_readout_grad,
            "sweep_taps": fused_sweep_taps, "convex_upsample": upsample_depth,
            "convex_upsample_grad": convex_upsample_grad, "gru_reset": gru_reset,
            "gru_update": gru_update, "gru_update_grad": gru_update_grad,
            "gru_reset_grad": gru_reset_grad, "bn_act": bn_act, "bn_act_grad": bn_act_grad,
            "upsample2x_add": upsample2x_add, "upsample2x_grad": upsample2x_grad,
            "bn_stats": bn_sums, "bn_stats_grad": bn_stats_grad_,
            "resize_bilinear": resize_forward, "resize_bilinear_grad": resize_grad,
            "view_weight": view_weight_forward, "view_weight_grad": view_weight_grad}
F32_COUNTERS = {"view_aggregate": view_aggregate, "view_aggregate_grad": view_aggregate_grad,
                "full_loss": full_loss_terms, "full_loss_grad": full_loss_grad,
                "grad_norm": grad_norm, "clip_adam": clip_adam_, "depth_metrics": depth_metrics,
                "init_depth": init_depth_forward, "init_depth_grad": init_depth_grad}
# Every kernel's report name, float32 forms first.
KERNEL_NAMES = ("sweep_premul", "corr_epilogue", "fusion_consistency", "sweep_grad_ref",
                "sweep_grad_src", "depth_readout", "depth_readout_grad", "sweep_taps",
                "convex_upsample", "convex_upsample_grad", "view_aggregate",
                "view_aggregate_grad", "gru_reset", "gru_update", "gru_update_grad",
                "gru_reset_grad", "bn_act", "bn_act_grad", "upsample2x_add", "upsample2x_grad",
                "bn_stats", "bn_stats_grad", "full_loss", "full_loss_grad", "grad_norm",
                "clip_adam", "depth_metrics", "resize_bilinear", "resize_bilinear_grad",
                "view_weight", "view_weight_grad", "init_depth", "init_depth_grad",
                "sweep_premul_bf16",
                "corr_epilogue_bf16", "sweep_grad_ref_bf16", "sweep_grad_src_bf16",
                "depth_readout_bf16", "depth_readout_grad_bf16", "sweep_taps_bf16",
                "convex_upsample_bf16", "convex_upsample_grad_bf16", "gru_reset_bf16",
                "gru_update_bf16", "gru_update_grad_bf16", "gru_reset_grad_bf16", "bn_act_bf16",
                "bn_act_grad_bf16", "upsample2x_add_bf16", "upsample2x_grad_bf16",
                "bn_stats_bf16", "bn_stats_grad_bf16", "resize_bilinear_bf16",
                "resize_bilinear_grad_bf16", "view_weight_bf16", "view_weight_grad_bf16")


def launch_counts() -> dict[str, int]:
    """{report name: launches} of all fifty-six kernels."""
    counts = {"fusion_consistency": consistency.launches}
    counts.update({name: fn.launches for name, fn in F32_COUNTERS.items()})
    for name, fn in COUNTERS.items():
        counts[name] = fn.launches
        counts[f"{name}_bf16"] = fn.launches_bf16
    return {k: counts[k] for k in KERNEL_NAMES}


def reset_launch_counts() -> None:
    """Every launch counter to 0, and the counts of K7's, K20's, K29's,
    K31's and K33's gradient copies and of K23's and K27's input copies."""
    consistency.launches = 0
    depth_readout_grad.copies = upsample2x_grad.copies = full_loss_terms.copies = 0
    resize_grad.copies = view_weight_grad.copies = init_depth_grad.copies = 0
    depth_metrics.copies = 0
    for fn in COUNTERS.values():
        fn.launches = fn.launches_bf16 = 0
    for fn in F32_COUNTERS.values():
        fn.launches = 0
