"""IterMVS core: plane-sweep matching + GRU probability iteration
(counterpart of itermvs_tpu/models/itermvs.py), in test and train mode.

Maps are NCHW; depth-sample stacks are [B, N, H, W]. Every sweep runs
`fused_sweep_taps` (K8 `sweep_taps`) → `SweepCorr` (K2 `sweep_premul` →
K1 `corr_epilogue`; backward K4 `sweep_grad_ref` and K5
`sweep_grad_src`), once per (source view, level), through
`chunked_warp_corr`. Each depth prediction reads the 256-bin head out
through `depth_readout` (K6; backward K7 `depth_readout_grad`), and the
last is ×4 upsampled through `upsample_depth` (K9 `convex_upsample`;
backward K10 `convex_upsample_grad`). Every bilinear resize (the init
sweep's view weights and depth, the hidden state with its tanh, the
reference features of levels 1 and 3, the confidence) runs K28
`resize_bilinear` (backward K29 `resize_bilinear_grad`; ops/resize.py).
Each sweep's views are aggregated through `view_aggregate` (K11;
backward K12 `view_aggregate_grad`). The
GRU's gates run K13 `gru_reset` and K14 `gru_update` between its
convolutions (backward K15 `gru_update_grad`, K16 `gru_reset_grad`;
models/blocks.py `ConvGRU`).

Numerical semantics kept from the JAX package:
  - init-branch view weights are bilinearly ×2 upsampled before reuse
    and frozen in the iterations;
  - correlation aggregation divides by (1e-5 + Σ view weights), both
    sums folded in view order;
  - the hidden state starts from the 32-channel level-3 CorrNet score
    volume, ×2 upsampled then tanh'd;
  - in test mode the confidence head runs only on the last iteration,
    and the returned coarse depth is the one taken before that update;
  - in train mode every prediction (the init head and each iteration)
    returns its depth, 256-bin probability and confidence logits, and the
    gradient stops where the JAX package stops it: at the sweep
    coordinates, at the view weights entering the iterations, and at the
    normalized depth after each prediction (the GRU input and the next
    samples).

Precision follows the JAX modules' `dtype`: in bfloat16 the convolutions
of CorrNet, PixelViewWeight, the GRU, the heads and the upsample weights
compute in bfloat16, as do the hidden state and the sweep's tables and
taps (the source features and `fused_sweep_taps(table_dtype=...)`); the
sweep's correlation, the outputs of CorrNet and PixelViewWeight, the head
logits, every softmax, the windowed expectation, the convex upsampling
weights (K9 reads the bfloat16 mask logits and softmaxes them in
float32) and every depth and confidence map stay float32.

Six chains run under `torch.profiler.record_function` labels, so that
a profile can sum their device time: `fused_sweep_taps` (K8), `resize`
(K28: the six bilinear resizes),
`depth_readout` (K6: the 256-bin softmax and the windowed expectation),
`convex_upsample` (K9: the 9-tap mask softmax and the ×4 convex
upsample), `view_aggregate` (K11: the view-weighted correlation
aggregation of every sweep) and, in models/blocks.py, `conv_gru` (K13
and K14, the GRU's elementwise work, not its convolutions). A label only
marks a range; it adds no sync and changes no result.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from itermvs_tpu_torch.models.blocks import ConvGRU, ConvReLU, conv, conv_transpose
from itermvs_tpu_torch.ops.depth_range import depth_unnormalization
from itermvs_tpu_torch.ops.depth_readout import (  # noqa: F401 (windowed_expectation)
    NUM_BINS, RADIUS, depth_readout, windowed_expectation)
from itermvs_tpu_torch.ops.resize import resize
from itermvs_tpu_torch.ops.sweep_grad import SweepCorr
from itermvs_tpu_torch.ops.upsample import upsample_depth
from itermvs_tpu_torch.ops.view_aggregate import view_aggregate
from itermvs_tpu_torch.ops.warping import device_constant, fused_sweep_taps

NUM_INIT_SAMPLES = 32   # initialization sweep samples
GROUPS = 8              # correlation groups
INTERVAL_SCALE = 1.0 / 256.0
HIDDEN_DIM = 32

# Per-level sampling offsets in normalized-inverse-depth units, scaled by
# INTERVAL_SCALE at the use site.
CORR_INTERVALS = {
    "level1": (-2.0, -2.0 / 3.0, 2.0 / 3.0, 2.0),
    "level2": (-8.0, -8.0 / 3.0, 8.0 / 3.0, 8.0),
    "level3": (-32.0, 32.0),
}
LEVELS = ("level1", "level2", "level3")


def initial_depth_samples(inverse_depth_min, inverse_depth_max, height, width,
                          num_sample: int = NUM_INIT_SAMPLES):
    """Uniform inverse-depth sweep [B, num_sample, H, W]."""
    batch = inverse_depth_min.shape[0]
    idmin = inverse_depth_min.reshape(batch, 1, 1, 1)
    idmax = inverse_depth_max.reshape(batch, 1, 1, 1)
    frac = torch.arange(num_sample, dtype=torch.float32,
                        device=idmin.device).reshape(1, num_sample, 1, 1) / (
        num_sample - 1)
    inv = idmax + frac * (idmin - idmax)
    return (1.0 / inv).expand(batch, num_sample, height, width)


def bilinear(x, out_hw, tanh: bool = False):
    """K28 (`ops.resize.resize`): x [B, C, H, W] resized to `out_hw`,
    tanh'd where `tanh`, under the `resize` label."""
    with record_function("resize"):
        return resize(x, out_hw, tanh)


def chunked_warp_corr(src, ref, flat_idx, taps, groups: int = GROUPS):
    """Gather + bilinear taps + group correlation for one (view, level),
    differentiable in `src` and `ref` (`ops.sweep_grad.SweepCorr`).

    Args:
      src: [B, H1, W1, C] NHWC source features (contiguous).
      ref: [B, HW, C] reference features on the sweep grid.
      flat_idx: [B, n, HW] int32 base indices; taps: [4, B, n, HW].

    Returns correlation [B, n, G, HW] float32.
    """
    return SweepCorr.apply(src, ref, flat_idx, taps, groups)


class PixelViewWeight(nn.Module):
    """Per-pixel source-view weight."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Sequential(ConvReLU(GROUPS, 16, dtype=dtype),
                                  conv(16, 1, 1, pad=0, dtype=dtype))

    def forward(self, corr):
        """corr: [B, N, G, H, W] → weight [B, H, W] float32."""
        b, n, g, h, w = corr.shape
        x = self.conv(corr.reshape(b * n, g, h, w)).reshape(b, n, h, w).float()
        return torch.softmax(x, dim=1).amax(dim=1)


class CorrNet(nn.Module):
    """Per-depth-slice 2D encoder-decoder on correlation."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = ConvReLU(GROUPS, 8, dtype=dtype)
        self.conv1 = ConvReLU(8, 16, stride=2, dtype=dtype)
        self.conv2 = ConvReLU(16, 32, stride=2, dtype=dtype)
        self.conv3 = conv_transpose(32, 16, dtype)
        self.conv4 = conv_transpose(16, 8, dtype)
        self.conv5 = conv(8, 1, dtype=dtype)

    def forward(self, corr):
        """corr: [B, N, G, H, W] → score volume [B, N, H, W] float32."""
        b, n, g, h, w = corr.shape
        conv0 = self.conv0(corr.reshape(b * n, g, h, w))
        conv1 = self.conv1(conv0)
        x = self.conv2(conv1)
        x = conv1 + self.conv3(x)
        x = conv0 + self.conv4(x)
        return self.conv5(x).reshape(b, n, h, w).float()


class Evaluation(nn.Module):
    """Plane-sweep matching: warp + group corr + view-weighted aggregation."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pixel_view_weight = PixelViewWeight(dtype)
        self.corr_conv1 = nn.ModuleList([CorrNet(dtype) for _ in range(3)])

    def init_sweep(self, ref_feature, src_features, rel_projs, depth_samples):
        """Initialization branch on level 3.

        Args:
          ref_feature: [B, H8·W8, 48] level-3 reference feature (NHWC flat).
          src_features: list of V−1 NHWC [B, H8, W8, 48] maps (the gather
            tables: the taps take their dtype).
          rel_projs: [B, V−1, 4, 4] level-3 relative projections.
          depth_samples: [B, 32, H8, W8].

        Returns view_weights [B, V−1, H4, W4] (×2 upsampled) and the score
        volume [B, 32, H8, W8]. (The init-sweep depth, which only training
        reads, is `init_depth` of the score.)
        """
        b, n, h, w = depth_samples.shape
        with record_function("fused_sweep_taps"):
            flat_idx, taps = fused_sweep_taps(
                rel_projs[:, :, None], depth_samples, (0,) * n,
                (tuple(src_features[0].shape[1:3]),), src_features[0].dtype)
        corr = torch.stack([
            chunked_warp_corr(src, ref_feature, flat_idx[:, v], taps[:, :, v])
            for v, src in enumerate(src_features)], dim=1)         # [B,V−1,N,G,HW]
        weight = self.pixel_view_weight(
            corr.reshape(-1, n, GROUPS, h, w)).reshape(b, -1, h * w)
        with record_function("view_aggregate"):
            correlation = view_aggregate(corr.unbind(1), weight)    # [B,N,G,HW]
        score = self.corr_conv1[2](correlation.reshape(b, n, GROUPS, h, w))
        return bilinear(weight.reshape(b, -1, h, w), (2 * h, 2 * w)), score

    @staticmethod
    def init_depth(score, idmin_b, idmax_b):
        """Init-sweep depth [B, 1, H4, W4]: the expectation of the sample
        index under the softmax of the score, unnormalized, ×2 upsampled."""
        n = score.shape[1]
        probability = torch.softmax(score, dim=1)
        index = torch.arange(n, dtype=torch.float32,
                             device=score.device).reshape(1, n, 1, 1)
        normalized = (index * probability).sum(dim=1, keepdim=True) / (n - 1.0)
        h, w = score.shape[-2:]
        return bilinear(depth_unnormalization(normalized, idmin_b, idmax_b), (2 * h, 2 * w))

    def iter_sweep(self, ref_features, src_features, rel_projs, depth_samples,
                   view_weights):
        """Iteration branch over levels 1..3.

        Args:
          ref_features: dict level1..3 of [B, H4·W4, C] NHWC-flat reference
            features, already resized to the 1/4 grid.
          src_features: dict level1..3 of per-view lists of NHWC
            [B, Hl, Wl, Cl] maps at native level resolution.
          rel_projs: dict level1..3 of [B, V−1, 4, 4].
          depth_samples: [B, 10, H4, W4] per-level sample stacks
            concatenated (level1 ×4, level2 ×4, level3 ×2).
          view_weights: [B, V−1, H4, W4], frozen.

        Returns correlation scores [B, 10, H4, W4].
        """
        b, _, h, w = depth_samples.shape
        weights = view_weights.detach().reshape(b, -1, h * w)      # [B,V−1,HW]
        rel_stack = torch.stack([rel_projs[k] for k in LEVELS], dim=2)
        src_hws = tuple(tuple(src_features[k][0].shape[1:3]) for k in LEVELS)
        counts = [len(CORR_INTERVALS[k]) for k in LEVELS]
        level_of_sample = sum(([i] * c for i, c in enumerate(counts)), [])
        with record_function("fused_sweep_taps"):
            flat_idx, taps = fused_sweep_taps(rel_stack, depth_samples,
                                              level_of_sample, src_hws,
                                              src_features["level1"][0].dtype)
        scores = []
        off = 0
        for i, key in enumerate(LEVELS):
            n = counts[i]
            corrs = [chunked_warp_corr(src, ref_features[key], flat_idx[:, v, off:off + n],
                                       taps[:, :, v, off:off + n])
                     for v, src in enumerate(src_features[key])]
            with record_function("view_aggregate"):
                agg = view_aggregate(corrs, weights)                # [B,n,G,HW]
            scores.append(self.corr_conv1[i](agg.reshape(b, n, GROUPS, h, w)))
            off += n
        return torch.cat(scores, dim=1)


class Update(nn.Module):
    """ConvGRU + depth/confidence heads. The hidden state is in the compute
    dtype; the heads' logits are float32."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM, dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dtype
        self.gru = ConvGRU(hidden_dim, 1 + sum(len(v) for v in CORR_INTERVALS.values()), dt)
        self.depth_head = nn.Sequential(
            conv(hidden_dim, 32, 3, pad=2, dilation=2, bias=False, dtype=dt), nn.ReLU(),
            conv(32, 64, 1, pad=0, bias=False, dtype=dt), nn.ReLU(),
            conv(64, NUM_BINS, 1, pad=0, dtype=dt))
        self.confidence_head = nn.Sequential(
            conv(hidden_dim, 32, 3, pad=2, dilation=2, bias=False, dtype=dt), nn.ReLU(),
            conv(32, 1, 1, pad=0, dtype=dt))
        self.hidden_init_head = nn.Sequential(
            conv(NUM_INIT_SAMPLES, 64, 3, bias=False, dtype=dt), nn.ReLU(),
            conv(64, hidden_dim, 1, pad=0, dtype=dt))

    def hidden_init(self, score_volume):
        """[B, 32, H8, W8] level-3 score volume → hidden [B, hidden, H4, W4]."""
        h, w = score_volume.shape[-2:]
        return bilinear(self.hidden_init_head(score_volume), (2 * h, 2 * w), tanh=True)

    def depth(self, hidden, probability: bool = True):
        """(normalized depth [B, 1, H, W], probability [B, 256, H, W]) from
        the 256-bin depth head, both float32; without `probability` (test
        mode, where nothing reads it) the second is None and never
        written."""
        logits = self.depth_head(hidden)
        with record_function("depth_readout"):
            return depth_readout(logits, probability)

    def confidence(self, hidden):
        """Confidence logits [B, 1, H, W], float32."""
        return self.confidence_head(hidden).float()

    def forward(self, hidden, normalized_depth, corr):
        """One GRU step. corr: [B, 10, H, W]; normalized_depth [B, 1, H, W]."""
        return self.gru(hidden, torch.cat([normalized_depth, corr], dim=1))


class IterMVS(nn.Module):
    """Init sweep → hidden/depth init → GRU iterations."""

    def __init__(self, iteration: int = 4, test: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if iteration < 1:
            raise ValueError("IterMVS needs at least one iteration")
        self.iteration = iteration
        self.test = test
        self.evaluation = Evaluation(dtype)
        self.update = Update(HIDDEN_DIM, dtype)
        self.upsample = nn.Sequential(
            conv(32, 64, 3, bias=False, dtype=dtype), nn.ReLU(),
            conv(64, 16 * 9, 1, pad=0, bias=False, dtype=dtype))

    def _upsample_weights(self, ref_level2):
        """Convex-upsample mask logits [B, 144, H4, W4] in the compute
        dtype, as the conv gives them (the 9-tap softmax runs inside
        `upsample_depth`)."""
        return self.upsample(ref_level2)

    def forward(self, ref_features, src_features, rel_projs, depth_min, depth_max):
        """Args:
          ref_features: dict level1..3 of NCHW [B, Cl, Hl, Wl] maps.
          src_features: dict level1..3 of per-view lists of NCHW maps.
          rel_projs: dict level1..3 of [B, V−1, 4, 4] (src @ inv(ref)).
          depth_min, depth_max: [B].

        Returns, in test mode, (depth [B,1,H4,W4], depth_upsampled
        [B,1,H,W], confidence [B,1,H4,W4], confidence_upsampled [B,1,H,W]);
        in train mode, as the JAX package, (depths, [depth_upsampled],
        confidences, confidence_upsampled): depths a dict of lists
        "initial" [init-sweep depth], "combine" (depth of the init head,
        then of each iteration, [B,1,H4,W4]) and "probability" (the same
        predictions' [B,256,H4,W4]); confidences their logits [B,1,H4,W4].
        """
        batch, _, h4, w4 = ref_features["level2"].shape
        idmin = 1.0 / depth_min.reshape(batch)
        idmax = 1.0 / depth_max.reshape(batch)
        idmin_b = idmin.reshape(batch, 1, 1, 1)
        idmax_b = idmax.reshape(batch, 1, 1, 1)

        mask_logits = self._upsample_weights(ref_features["level2"])

        # The sweep kernels read NHWC: sources per view at their native
        # level size, references on the sweep grid, flattened.
        def nhwc(x):
            return x.permute(0, 2, 3, 1).contiguous()

        def nhwc_flat(x):
            return nhwc(x).reshape(x.shape[0], -1, x.shape[1])

        src_nhwc = {k: [nhwc(f) for f in src_features[k]] for k in LEVELS}
        ref_iter = {
            "level1": nhwc_flat(bilinear(ref_features["level1"], (h4, w4))),
            "level2": nhwc_flat(ref_features["level2"]),
            "level3": nhwc_flat(bilinear(ref_features["level3"], (h4, w4))),
        }

        depth_samples = initial_depth_samples(idmin, idmax, h4 // 2, w4 // 2)
        view_weights, score_volume = self.evaluation.init_sweep(
            nhwc_flat(ref_features["level3"]), src_nhwc["level3"],
            rel_projs["level3"], depth_samples)

        hidden = self.update.hidden_init(score_volume)
        normalized_depth, probability = self.update.depth(hidden, not self.test)

        depths = {"combine": [], "probability": [], "initial": []}
        confidences = []
        if not self.test:
            depths["initial"].append(
                self.evaluation.init_depth(score_volume, idmin_b, idmax_b))
            depths["combine"].append(
                depth_unnormalization(normalized_depth, idmin_b, idmax_b))
            depths["probability"].append(probability)
            confidences.append(self.update.confidence(hidden))
            normalized_depth = normalized_depth.detach()

        intervals = device_constant(
            sum((CORR_INTERVALS[k] for k in LEVELS), ()), torch.float32,
            idmin.device).reshape(1, -1, 1, 1) * INTERVAL_SCALE

        for it in range(self.iteration):
            s = torch.clamp(normalized_depth + intervals, 0.0, 1.0)
            samples = depth_unnormalization(s, idmin_b, idmax_b)
            corr = self.evaluation.iter_sweep(
                ref_iter, src_nhwc, rel_projs, samples, view_weights)
            last = it == self.iteration - 1
            if self.test and last:
                depth = depth_unnormalization(normalized_depth, idmin_b, idmax_b)
            hidden = self.update(hidden, normalized_depth, corr)
            normalized_depth, probability = self.update.depth(hidden, not self.test)
            if not self.test or last:
                logits = self.update.confidence(hidden)
            if not self.test:
                depths["combine"].append(
                    depth_unnormalization(normalized_depth, idmin_b, idmax_b))
                depths["probability"].append(probability)
                confidences.append(logits)
                if not last:
                    normalized_depth = normalized_depth.detach()

        with record_function("convex_upsample"):
            up = upsample_depth(normalized_depth, mask_logits)
        depth_upsampled = depth_unnormalization(up, idmin_b, idmax_b)
        confidence = torch.sigmoid(logits)
        confidence_upsampled = bilinear(confidence, (4 * h4, 4 * w4))
        if self.test:
            return depth, depth_upsampled, confidence, confidence_upsampled
        return depths, [depth_upsampled], confidences, confidence_upsampled
