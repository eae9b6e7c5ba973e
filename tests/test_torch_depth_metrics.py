"""The training metrics (ops/depth_metrics.py: kernel K27 `depth_metrics`;
engine/metrics.py) on the CPU, where the port runs K27's plain version:
the port's `depth_metrics` against the JAX package's
(itermvs_tpu/engine/metrics.py) on the same numpy inputs, B = 3, level 2
16x20, level 0 64x80, num_iters 1 and 4, with the edge cases planted: an
image with an empty level-2 mask, one with an empty level-0 mask, errors
of exactly 1, 2, 4 and 8 (e > t is strict), masks of exactly 0.5 (out);
NaN and infinite estimates at masked-out and valid pixels; every mask
empty. Then K27's arithmetic emulated in numpy against chip_smoke's gates,
a world-1 gloo group's one all-reduce, the wrapper's refusals and copies,
and chip_smoke's cases, plan, bound and gates.

JAX is called as its function is written, op by op: under `jit` XLA
rewrites the product v·m into select(m, v, 0), so there a NaN estimate at
a masked-out pixel reads as finite. The port and K27 multiply, as the
function does. Tolerances: rel 1e-6, abs 1e-7
(tests/test_torch_train.py::test_depth_metrics_and_meter_match_jax's:
XLA and torch sum in other orders).
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.engine import metrics as jax_metrics
from itermvs_tpu_torch.engine import metrics
from itermvs_tpu_torch.ops import depth_metrics as dm

B, H, W = 3, 16, 20
REL, ABS = 1e-6, 1e-7
KINDS = ("planted", "nan", "empty")


def _case(seed, n, kind):
    """(preds, up, gt2, m2, gt0, m0) in numpy [B, H, W, 1] float32 from
    `seed`: GT 2..12, errors 0..10, 70% of the pixels valid, and the cases
    of `kind` (module docstring) on image 0's first two rows."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.rand(*s).astype(np.float32)
    gt2, gt0 = 2 + 10 * u(B, H, W), 2 + 10 * u(B, 4 * H, 4 * W)
    preds = [gt2 + 20 * u(B, H, W) - 10 for _ in range(n)]
    up = gt0 + 20 * u(B, 4 * H, 4 * W) - 10
    m2 = (u(B, H, W) > 0.3).astype(np.float32)
    m0 = (u(B, 4 * H, 4 * W) > 0.3).astype(np.float32)
    if kind == "empty":
        m2[:], m0[:] = 0.0, 0.0
    else:
        m2[1], m0[2] = 0.0, 0.0
        errors = np.array([1, -1, 2, -2, 4, -4, 8, -8, 9, 9], np.float32)
        for gt, ests, mask in ((gt2, preds, m2), (gt0, [up], m0)):
            gt[0, 0, :10] = 5.0
            for est in ests:
                est[0, 0, :10] = 5.0 + errors
            mask[0, 0, :11] = [1.0] * 8 + [0.5, 0.5, np.nextafter(np.float32(0.5), np.float32(1))]
    if kind == "nan":
        m2[0, 1, :2] = 0.0
        preds[0][0, 1, 0] = np.nan
        preds[-1][0, 1, 1] = np.inf
        m0[0, 1, 0] = 1.0
        up[0, 1, 0] = np.nan
    return tuple(x[..., None] for x in (*preds, up, gt2, m2, gt0, m0))


def _split(arrays, n):
    """`_case`'s tuple → (preds, up, GT dict, mask dict)."""
    preds, (up, gt2, m2, gt0, m0) = list(arrays[:n]), arrays[n:]
    return preds, up, {"level_2": gt2, "level_0": gt0}, {"level_2": m2, "level_0": m0}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("num_iters", [1, 4])
def test_depth_metrics_match_jax(num_iters, kind):
    n = num_iters + 1
    preds, up, gt, mask = _split(_case(7, n, kind), n)
    want = jax_metrics.depth_metrics([jnp.asarray(p) for p in preds], jnp.asarray(up),
                                     {k: jnp.asarray(v) for k, v in gt.items()},
                                     {k: jnp.asarray(v) for k, v in mask.items()}, num_iters)
    t = torch.from_numpy
    got = metrics.depth_metrics([t(p) for p in preds], t(up), {k: t(v) for k, v in gt.items()},
                                {k: t(v) for k, v in mask.items()}, num_iters)
    assert list(got) == list(want) == list(dm.metric_names(num_iters))
    nan = {k for k, v in want.items() if np.isnan(float(v))}
    assert nan == {k for k, v in got.items() if math.isnan(float(v))}
    if kind == "nan":       # masked-out NaN (initial), inf (last), valid NaN (level 0)
        assert nan == {"abs_error_initial", f"abs_error_gru_{num_iters}", "abs_error_final_full"}
    else:
        assert not nan
    for key in set(want) - nan:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=REL, abs=ABS), key
    if kind == "empty":
        assert all(float(v) == 0.0 for v in got.values())
    if kind == "planted":   # e > t is strict: the planted ±t errors are not outliers
        edge = [x[:1, :1, :10] for x in _case(7, n, kind)]
        e, e0 = (np.abs(edge[0] - edge[n + 1]), np.abs(edge[n] - edge[n + 3]))
        assert list(e[0, 0, :8, 0]) == list(e0[0, 0, :8, 0]) == [1, 1, 2, 2, 4, 4, 8, 8]


def _emulated(preds, up, gt2, m2, gt0, m0):
    """K27's arithmetic in numpy (csrc/depth_metrics.cu): per image float64
    sums of float32 terms, rounded to float32 and divided in float32, the
    images' means added in order in float64 and the quotient rounded to
    float32. Returns (means, n column) [M]."""
    f32 = np.float32

    def image_sums(est, gt, m, t=None):
        e = np.abs(est - gt)
        mask = (m > 0.5).astype(f32)
        v = e if t is None else (e > t).astype(f32)
        b = est.shape[0]
        with np.errstate(invalid="ignore"):         # NaN·0 and inf·0 are NaN, as on the card
            return ((v * mask).reshape(b, -1).astype(np.float64).sum(1),
                    mask.reshape(b, -1).astype(np.float64).sum(1))

    def batch(sums, counts):
        valid, total = 0.0, 0.0
        for s, c in zip(sums, counts):
            c = f32(c)
            has = f32(1) if c > 0 else f32(0)
            mean = f32(f32(s) / max(c, f32(1))) if c > 0 else f32(0)
            valid, total = valid + float(has), total + float(f32(mean * has))
        return f32(total / max(valid, 1.0)), valid

    rows = [batch(*image_sums(preds[0], gt2, m2)), batch(*image_sums(preds[0], gt2, m2, 1)),
            batch(*image_sums(up, gt0, m0)),
            *(batch(*image_sums(up, gt0, m0, t)) for t in dm.THRESHOLDS)]
    for est in preds[1:]:
        rows += [batch(*image_sums(est, gt2, m2, 1)), batch(*image_sums(est, gt2, m2))]
    means, valid = zip(*rows)
    return np.array(means, np.float32), np.array(valid)


@pytest.mark.parametrize("kind", KINDS)
def test_k27_arithmetic_meets_the_card_gates(kind):
    """K27's rounding, emulated, against the plain version as chip_smoke's
    `hold_depth_metrics` holds the kernel: outlier rates within 1 ulp of
    float32's (bit-equal: both divide exact counts in float32 and sum the
    batch exactly in float64), mean errors within 1e-6 of float64's, NaN
    where it is NaN, the same count of images with a valid pixel."""
    arrays = _case(11, 5, kind)
    means, valid = _emulated(arrays[:5], *arrays[5:])
    tensors = [torch.from_numpy(a) for a in arrays]
    plain32, table32 = dm.depth_metrics_plain(tensors[:5], *tensors[5:])
    plain64 = dm.depth_metrics_plain([t.double() for t in tensors[:5]],
                                     *(t.double() for t in tensors[5:]))[0]
    table = torch.stack([torch.from_numpy(valid), table32[:, 1]], 1)
    errs = chip_smoke.metric_errors(dm.metric_names(4), torch.from_numpy(means), table, plain32,
                                    table32, plain64)
    assert errs["max_ulps"] == 0 and errs["max_rel"] <= chip_smoke.METRIC_REL
    assert errs["nan_agree"] and errs["counts_equal"]


def test_a_process_group_reduces_the_table_once(monkeypatch):
    """In a (world-1 gloo) group `depth_metrics` all-reduces the [M, 2]
    table once, counts it, and gives one process's values bit for bit."""
    preds, up, gt, mask = _split([torch.from_numpy(a) for a in _case(3, 5, "planted")], 5)
    alone = metrics.depth_metrics(preds, up, gt, mask, 4)
    calls = []
    reduce = metrics.all_reduce_sum
    monkeypatch.setattr(metrics, "all_reduce_sum", lambda x: calls.append(x.shape) or reduce(x))
    before = metrics.depth_metrics.all_reduces
    with chip_smoke.process_group("gloo", "cpu"):
        shared = metrics.depth_metrics(preds, up, gt, mask, 4)
    assert calls == [(15, 2)] and metrics.depth_metrics.all_reduces == before + 1
    assert list(shared) == list(alone)
    assert all(torch.equal(shared[k], alone[k]) for k in alone)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("change, match", [
    (dict(preds=[_meta((B, H, W, 1))] * 17), "1 to 16 predictions"),
    (dict(preds=[]), "1 to 16 predictions"),
    (dict(m2=_meta((B, H, W))), "one shape"),
    (dict(up=_meta((B + 1, 4 * H, 4 * W, 1)), gt0=_meta((B + 1, 4 * H, 4 * W, 1)),
          m0=_meta((B + 1, 4 * H, 4 * W, 1))), "one shape"),
    (dict(gt2=_meta((B, H, W, 1), torch.float64)), "float32"),
    (dict(), "CUDA device"),
])
def test_the_wrapper_refuses_what_k27_does_not_take(change, match):
    """Predictions beyond K27's pointer list or none, levels of mixed
    shapes or batches, another dtype, a device that is neither the CPU nor
    CUDA: refused before any launch."""
    args = dict(preds=[_meta((B, H, W, 1))] * 5, up=_meta((B, 4 * H, 4 * W, 1)),
                gt2=_meta((B, H, W, 1)), m2=_meta((B, H, W, 1)),
                gt0=_meta((B, 4 * H, 4 * W, 1)), m0=_meta((B, 4 * H, 4 * W, 1)))
    args.update(change)
    launches = dm.depth_metrics.launches
    with pytest.raises(ValueError, match=match):
        dm.depth_metrics(**args)
    assert dm.depth_metrics.launches == launches


def test_too_few_predictions_for_the_iterations_are_refused():
    preds, up, gt, mask = _split([torch.from_numpy(a) for a in _case(3, 2, "planted")], 2)
    with pytest.raises(ValueError, match="needs 5 predictions"):
        metrics.depth_metrics(preds, up, gt, mask, 4)


def test_inputs_k27_cannot_read_are_copied_and_counted():
    dm.depth_metrics.copies = 0
    dense = _meta((B, H, W, 1))
    assert dm._dense(dense) is dense and dm.depth_metrics.copies == 0
    strided = _meta((B, H, 2 * W, 1))[:, :, ::2]
    assert dm._dense(strided).is_contiguous() and dm.depth_metrics.copies == 1
    chip_smoke.reset_launch_counts()
    assert dm.depth_metrics.copies == 0


def test_layout_constants_match_the_kernel_source():
    """The wrapper's scratch (float64: each level-2 block's 33 and each
    level-0 block's 6 partial sums, then 2n + 7 per image) follows
    csrc/depth_metrics.cu's constants."""
    with open(dm.__file__.replace("ops/depth_metrics.py", "csrc/depth_metrics.cu")) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kThreads"], consts["kLevel2"], consts["kLevel0"], consts["kMaxPred"],
            consts["kSlots0"]) == (dm.THREADS, dm.LEVEL2, dm.LEVEL0, dm.MAX_PREDICTIONS,
                                   dm.SLOTS0)
    assert dm.SLOTS2 == 1 + 2 * consts["kMaxPred"]
    # The training step: 20 level-2 and 160 level-0 blocks per image.
    assert dm.scratch_size(4, 128 * 160, 512 * 640, 5) == 4 * (20 * 33 + 160 * 6 + 17)
    assert dm.scratch_size(1, 1, 1, 1) == 33 + 6 + 9


def test_chip_smoke_names_plans_and_bounds_k27():
    """chip_smoke files K27's two kernels under `depth_metrics` (float32
    only), plans one launch (two device kernels) per training step and
    none per map, labels the chain, reports it per step beside its source
    and the JAX call it replaces, and bounds it by one read of the 5
    predictions, level-2 GT and mask and the level-0 depth, GT and mask."""
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::depth_metrics_pixel_kernel((anonymous namespace)::"
               "Planes, int, float const*, float const*)") == "depth_metrics"
    assert cat("(anonymous namespace)::depth_metrics_fold_kernel(double const*, double "
               "const*, int, int, int, int, double*, float*)") == "depth_metrics"
    assert chip_smoke.KERNELS_PER_LAUNCH["depth_metrics"] == 2
    for dtype in (torch.float32, torch.bfloat16):
        shapes = chip_smoke.sweep_shapes(640, 512, 5, 4, 4, itemsize=dtype.itemsize)
        assert chip_smoke.planned_step_counts(shapes, dtype)["depth_metrics"] == 1
        assert chip_smoke.planned_map_counts(shapes, dtype)["depth_metrics"] == 0
    assert "depth_metrics" in chip_smoke.CHAINS and "depth_metrics" in chip_smoke.REPORT_PER_STEP
    assert chip_smoke.kernel_sources()["depth_metrics"] == (
        "itermvs_tpu_torch/csrc/depth_metrics.cu", "itermvs_tpu/engine/metrics.py:47")
    pixels2, pixels0 = 4 * 128 * 160, 4 * 512 * 640
    nbytes, ops = chip_smoke.metrics_work(5, pixels2, pixels0)
    assert nbytes == 4 * (7 * pixels2 + 3 * pixels0) + (4 + 16) * 15 == 18022700
    assert chip_smoke.bound_ms(nbytes, ops)[1] == "bytes"
    assert chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, train=True)["depth_metrics"] == \
        pytest.approx(1e3 * nbytes / chip_smoke.PEAK_BYTES_PER_S)
    assert chip_smoke.chain_bound_ms(1600, 1152, 5, 4)["depth_metrics"] == 0


def test_chip_smoke_metrics_cases_plant_their_cases():
    gen = torch.Generator().manual_seed(0)
    preds, up, gt2, m2, gt0, m0 = chip_smoke.metrics_case(4, 8, 12, 3, gen, dev="cpu")
    assert len(preds) == 3 and up.shape == gt0.shape == m0.shape == (4, 32, 48, 1)
    assert all(p.shape == gt2.shape == m2.shape == (4, 8, 12, 1) for p in preds)
    assert not m2[1].any() and m2[0].any() and not m0[2].any() and m0[1].any()
    for est, gt, m in ((preds[1], gt2, m2), (up, gt0, m0)):
        e = (est - gt).abs()[0, 0, :8, 0].tolist()
        assert e == [1, 1, 2, 2, 4, 4, 8, 8] and m[0, 0, :8].eq(1).all()
        assert m[0, 0, 8:11, 0].tolist() == [0.5, 0.5, 0.5 + 2 ** -24]
    preds, up, gt2, m2, gt0, m0 = chip_smoke.metrics_case(3, 7, 9, 3, gen, "nan", dev="cpu")
    assert preds[0][0, 1, 0].isnan() and preds[2][0, 1, 1].isinf() and not m2[0, 1, :2].any()
    assert up[0, 1, 0].isnan() and m0[0, 1, 0] == 1
    names = dm.metric_names(2)
    means, table = dm.depth_metrics_plain(preds, up, gt2, m2, gt0, m0)
    assert {k for k, v in zip(names, means.tolist()) if math.isnan(v)} == {
        "abs_error_initial", "abs_error_gru_2", "abs_error_final_full"}
    empty = chip_smoke.metrics_case(2, 4, 5, 2, gen, "empty", dev="cpu")
    assert not any(t.any() for t in (empty[3], empty[5]))
    assert not dm.depth_metrics_plain(*empty)[0].any()


def test_chip_smoke_metric_gates():
    """`metric_errors` finds an outlier rate 2 ulps off, a mean error off
    by more than 1e-6, a NaN that moved, and another count of images."""
    names = dm.metric_names(1)
    for kind in ("planted", "nan"):
        arrays = [torch.from_numpy(a) for a in _case(5, 2, kind)]
        plain32, table32 = dm.depth_metrics_plain(arrays[:2], *arrays[2:])
        plain64 = dm.depth_metrics_plain([t.double() for t in arrays[:2]],
                                         *(t.double() for t in arrays[2:]))[0]
        errors = lambda got, table=table32: chip_smoke.metric_errors(
            names, got, table, plain32, table32, plain64)
        clean = errors(plain32)
        assert clean["max_ulps"] == 0 and clean["max_rel"] <= 1e-7
        assert clean["nan_agree"] and clean["counts_equal"]
        table = table32.clone()
        table[0, 0] += 1
        assert not errors(plain32, table)["counts_equal"]
    got = plain32.clone()                               # the NaN case's
    got[0] = 1.0                                        # abs_error_initial was NaN
    assert not errors(got)["nan_agree"]
    got = plain32.clone()
    got[1] = torch.nextafter(torch.nextafter(got[1], torch.tensor(2.0)), torch.tensor(2.0))
    assert errors(got)["max_ulps"] == 2
    arrays = [torch.from_numpy(a) for a in _case(5, 2, "planted")]
    plain32, table32 = dm.depth_metrics_plain(arrays[:2], *arrays[2:])
    got = plain32.clone()
    got[names.index("abs_error_gru_1")] *= 1 + 1e-5
    assert chip_smoke.metric_errors(names, got, table32, plain32, table32,
                                    plain32.double())["max_rel"] > 1e-6
