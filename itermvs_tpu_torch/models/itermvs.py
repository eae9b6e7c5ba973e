"""IterMVS core, test mode: plane-sweep matching + GRU probability
iteration (counterpart of itermvs_tpu/models/itermvs.py).

Maps are NCHW; depth-sample stacks are [B, N, H, W]. Every sweep runs
`fused_sweep_taps` (plain torch) → K2 `sweep_premul` → K1
`corr_epilogue`, once per (source view, level), through
`chunked_warp_corr`.

Numerical semantics kept from the JAX package:
  - init-branch view weights are bilinearly ×2 upsampled before reuse
    and frozen in the iterations;
  - correlation aggregation divides by (1e-5 + Σ view weights);
  - the hidden state starts from the 32-channel level-3 CorrNet score
    volume, ×2 upsampled then tanh'd;
  - in test mode the confidence head runs only on the last iteration,
    and the returned coarse depth is the one taken before that update.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from itermvs_tpu_torch.models.blocks import ConvGRU, ConvReLU, conv, conv_transpose
from itermvs_tpu_torch.ops.depth_range import depth_unnormalization
from itermvs_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear
from itermvs_tpu_torch.ops.sweep import sample_chunks, sweep_premul
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue
from itermvs_tpu_torch.ops.upsample import convex_upsample
from itermvs_tpu_torch.ops.warping import fused_sweep_taps

NUM_BINS = 256          # output probability bins over normalized inverse depth
RADIUS = 4              # windowed-expectation half width
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


def windowed_expectation(probability: torch.Tensor) -> torch.Tensor:
    """Normalized depth [B, 1, H, W] from a [B, NUM_BINS, H, W] distribution.

    Expectation over the ±RADIUS window around the argmax bin, normalized
    by the window's mass. A window clipped at bin 0 (or NUM_BINS−1)
    counts that bin once per clipped tap, as the reference's
    `clip(argmax + k)` gather does: `max(0, RADIUS − argmax)` extra
    weight at bin 0, symmetric at the top bin.
    """
    dt = probability.dtype
    idx = probability.argmax(dim=1, keepdim=True).to(dt)          # [B,1,H,W]
    bins = torch.arange(NUM_BINS, dtype=dt,
                        device=probability.device).reshape(1, -1, 1, 1)
    weight = ((bins - idx).abs() <= RADIUS).to(dt)
    extra_lo = torch.clamp(RADIUS - idx, min=0.0)
    extra_hi = torch.clamp(idx + RADIUS - (NUM_BINS - 1), min=0.0)
    zero = torch.zeros((), dtype=dt, device=probability.device)
    weight = (weight
              + torch.where(bins == 0.0, extra_lo, zero)
              + torch.where(bins == float(NUM_BINS - 1), extra_hi, zero))
    pw = probability * weight
    regress = (pw * bins).sum(dim=1, keepdim=True) / (
        1e-6 + pw.sum(dim=1, keepdim=True))
    return regress / (NUM_BINS - 1.0)


def chunked_warp_corr(src, ref, flat_idx, taps, groups: int = GROUPS):
    """Gather + bilinear taps + group correlation for one (view, level),
    through K2 `sweep_premul` and K1 `corr_epilogue`, split on sample
    boundaries only where the premul block would exceed
    `ops.sweep.PREMUL_BUDGET_BYTES`.

    Args:
      src: [B, H1, W1, C] NHWC source features (contiguous).
      ref: [B, HW, C] reference features on the sweep grid.
      flat_idx: [B, n, HW] int32 base indices; taps: [4, B, n, HW].

    Returns correlation [B, n, G, HW] float32.
    """
    b, n, hw = flat_idx.shape
    c = src.shape[-1]
    outs = []
    for s0, s1 in sample_chunks(b, n, hw, c):
        m = s1 - s0
        premul = sweep_premul(
            src, flat_idx[:, s0:s1].reshape(b, m * hw).contiguous(),
            taps[:, :, s0:s1].reshape(4, b, m * hw).contiguous(), ref, m)
        corr = corr_epilogue(premul.reshape(b * m * hw, 4 * c), b * m, groups)
        outs.append(corr.reshape(groups, b, m, hw))
    corr = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return corr.permute(1, 2, 0, 3)                                # [B,n,G,HW]


class PixelViewWeight(nn.Module):
    """Per-pixel source-view weight."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Sequential(ConvReLU(GROUPS, 16), conv(16, 1, 1, pad=0))

    def forward(self, corr):
        """corr: [B, N, G, H, W] → weight [B, H, W]."""
        b, n, g, h, w = corr.shape
        x = self.conv(corr.reshape(b * n, g, h, w)).reshape(b, n, h, w)
        return torch.softmax(x, dim=1).amax(dim=1)


class CorrNet(nn.Module):
    """Per-depth-slice 2D encoder-decoder on correlation."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvReLU(GROUPS, 8)
        self.conv1 = ConvReLU(8, 16, stride=2)
        self.conv2 = ConvReLU(16, 32, stride=2)
        self.conv3 = conv_transpose(32, 16)
        self.conv4 = conv_transpose(16, 8)
        self.conv5 = conv(8, 1)

    def forward(self, corr):
        """corr: [B, N, G, H, W] → score volume [B, N, H, W]."""
        b, n, g, h, w = corr.shape
        conv0 = self.conv0(corr.reshape(b * n, g, h, w))
        conv1 = self.conv1(conv0)
        x = self.conv2(conv1)
        x = conv1 + self.conv3(x)
        x = conv0 + self.conv4(x)
        return self.conv5(x).reshape(b, n, h, w)


class Evaluation(nn.Module):
    """Plane-sweep matching: warp + group corr + view-weighted aggregation."""

    def __init__(self):
        super().__init__()
        self.pixel_view_weight = PixelViewWeight()
        self.corr_conv1 = nn.ModuleList([CorrNet() for _ in range(3)])

    def init_sweep(self, ref_feature, src_features, rel_projs, depth_samples):
        """Initialization branch on level 3.

        Args:
          ref_feature: [B, H8·W8, 48] level-3 reference feature (NHWC flat).
          src_features: list of V−1 NHWC [B, H8, W8, 48] maps.
          rel_projs: [B, V−1, 4, 4] level-3 relative projections.
          depth_samples: [B, 32, H8, W8].

        Returns view_weights [B, V−1, H4, W4] (×2 upsampled) and the score
        volume [B, 32, H8, W8]. (The JAX branch also returns the init-sweep
        depth, which only training reads.)
        """
        b, n, h, w = depth_samples.shape
        flat_idx, taps = fused_sweep_taps(
            rel_projs[:, :, None], depth_samples, (0,) * n,
            (tuple(src_features[0].shape[1:3]),))
        corr = torch.stack([
            chunked_warp_corr(src, ref_feature, flat_idx[:, v], taps[:, :, v])
            for v, src in enumerate(src_features)], dim=1)
        corr = corr.reshape(b, len(src_features), n, GROUPS, h, w)
        weight = self.pixel_view_weight(
            corr.reshape(-1, n, GROUPS, h, w)).reshape(b, -1, h, w)
        correlation = (corr * weight[:, :, None, None]).sum(dim=1) / (
            1e-5 + weight.sum(dim=1))[:, None, None]
        score = self.corr_conv1[2](correlation)                     # [B,N,H,W]
        return upsample_bilinear(weight, 2), score

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
        weight_sum = 1e-5 + view_weights.sum(dim=1)                # [B,H,W]
        rel_stack = torch.stack([rel_projs[k] for k in LEVELS], dim=2)
        src_hws = tuple(tuple(src_features[k][0].shape[1:3]) for k in LEVELS)
        counts = [len(CORR_INTERVALS[k]) for k in LEVELS]
        level_of_sample = sum(([i] * c for i, c in enumerate(counts)), [])
        flat_idx, taps = fused_sweep_taps(rel_stack, depth_samples,
                                          level_of_sample, src_hws)
        scores = []
        off = 0
        for i, key in enumerate(LEVELS):
            n = counts[i]
            agg = None
            for v, src in enumerate(src_features[key]):
                corr_v = chunked_warp_corr(
                    src, ref_features[key], flat_idx[:, v, off:off + n],
                    taps[:, :, v, off:off + n]).reshape(b, n, GROUPS, h, w)
                wv = view_weights[:, v][:, None, None]              # [B,1,1,H,W]
                agg = corr_v * wv if agg is None else agg + corr_v * wv
            scores.append(self.corr_conv1[i](agg / weight_sum[:, None, None]))
            off += n
        return torch.cat(scores, dim=1)


class Update(nn.Module):
    """ConvGRU + depth/confidence heads."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM):
        super().__init__()
        self.gru = ConvGRU(hidden_dim, 1 + sum(len(v) for v in CORR_INTERVALS.values()))
        self.depth_head = nn.Sequential(
            conv(hidden_dim, 32, 3, pad=2, dilation=2, bias=False), nn.ReLU(),
            conv(32, 64, 1, pad=0, bias=False), nn.ReLU(),
            conv(64, NUM_BINS, 1, pad=0))
        self.confidence_head = nn.Sequential(
            conv(hidden_dim, 32, 3, pad=2, dilation=2, bias=False), nn.ReLU(),
            conv(32, 1, 1, pad=0))
        self.hidden_init_head = nn.Sequential(
            conv(NUM_INIT_SAMPLES, 64, 3, bias=False), nn.ReLU(),
            conv(64, hidden_dim, 1, pad=0))

    def hidden_init(self, score_volume):
        """[B, 32, H8, W8] level-3 score volume → hidden [B, hidden, H4, W4]."""
        return torch.tanh(upsample_bilinear(self.hidden_init_head(score_volume), 2))

    def depth(self, hidden):
        """Normalized depth [B, 1, H, W] from the 256-bin depth head."""
        return windowed_expectation(torch.softmax(self.depth_head(hidden), dim=1))

    def forward(self, hidden, normalized_depth, corr, confidence_flag=False):
        """One GRU step. corr: [B, 10, H, W]; normalized_depth [B, 1, H, W]."""
        hidden = self.gru(hidden, torch.cat([normalized_depth, corr], dim=1))
        confidence = None
        if confidence_flag:
            confidence = torch.sigmoid(self.confidence_head(hidden))
        return hidden, self.depth(hidden), confidence


class IterMVS(nn.Module):
    """Init sweep → hidden/depth init → GRU iterations (test mode)."""

    def __init__(self, iteration: int = 4):
        super().__init__()
        if iteration < 1:
            raise ValueError("IterMVS needs at least one iteration")
        self.iteration = iteration
        self.evaluation = Evaluation()
        self.update = Update(HIDDEN_DIM)
        self.upsample = nn.Sequential(
            conv(32, 64, 3, bias=False), nn.ReLU(),
            conv(64, 16 * 9, 1, pad=0, bias=False))

    def _upsample_weights(self, ref_level2):
        """Convex-upsample tap weights [B, 9, 4, 4, H4, W4]."""
        b, _, h, w = ref_level2.shape
        x = self.upsample(ref_level2).reshape(b, 9, 4, 4, h, w)
        return torch.softmax(x, dim=1)

    def forward(self, ref_features, src_features, rel_projs, depth_min, depth_max):
        """Args:
          ref_features: dict level1..3 of NCHW [B, Cl, Hl, Wl] maps.
          src_features: dict level1..3 of per-view lists of NCHW maps.
          rel_projs: dict level1..3 of [B, V−1, 4, 4] (src @ inv(ref)).
          depth_min, depth_max: [B].

        Returns (depth [B,1,H4,W4], depth_upsampled [B,1,H,W],
        confidence [B,1,H4,W4], confidence_upsampled [B,1,H,W]).
        """
        batch, _, h4, w4 = ref_features["level2"].shape
        idmin = 1.0 / depth_min.reshape(batch)
        idmax = 1.0 / depth_max.reshape(batch)
        idmin_b = idmin.reshape(batch, 1, 1, 1)
        idmax_b = idmax.reshape(batch, 1, 1, 1)

        upsample_weights = self._upsample_weights(ref_features["level2"])

        # The sweep kernels read NHWC: sources per view at their native
        # level size, references on the sweep grid, flattened.
        def nhwc(x):
            return x.permute(0, 2, 3, 1).contiguous()

        def nhwc_flat(x):
            return nhwc(x).reshape(x.shape[0], -1, x.shape[1])

        src_nhwc = {k: [nhwc(f) for f in src_features[k]] for k in LEVELS}
        ref_iter = {
            "level1": nhwc_flat(resize_bilinear(ref_features["level1"], (h4, w4))),
            "level2": nhwc_flat(ref_features["level2"]),
            "level3": nhwc_flat(resize_bilinear(ref_features["level3"], (h4, w4))),
        }

        depth_samples = initial_depth_samples(idmin, idmax, h4 // 2, w4 // 2)
        view_weights, score_volume = self.evaluation.init_sweep(
            nhwc_flat(ref_features["level3"]), src_nhwc["level3"],
            rel_projs["level3"], depth_samples)

        hidden = self.update.hidden_init(score_volume)
        normalized_depth = self.update.depth(hidden)

        intervals = torch.tensor(
            sum((CORR_INTERVALS[k] for k in LEVELS), ()), dtype=torch.float32,
            device=idmin.device).reshape(1, -1, 1, 1) * INTERVAL_SCALE

        for it in range(self.iteration):
            s = torch.clamp(normalized_depth + intervals, 0.0, 1.0)
            samples = depth_unnormalization(s, idmin_b, idmax_b)
            corr = self.evaluation.iter_sweep(
                ref_iter, src_nhwc, rel_projs, samples, view_weights)
            last = it == self.iteration - 1
            if last:
                depth = depth_unnormalization(normalized_depth, idmin_b, idmax_b)
            hidden, normalized_depth, confidence = self.update(
                hidden, normalized_depth, corr, confidence_flag=last)

        up = convex_upsample(normalized_depth, upsample_weights, scale=4)
        depth_upsampled = depth_unnormalization(up, idmin_b, idmax_b)
        confidence_upsampled = upsample_bilinear(confidence, 4)
        return depth, depth_upsampled, confidence, confidence_upsampled
