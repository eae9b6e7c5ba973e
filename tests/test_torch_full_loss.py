"""The training loss (ops/full_loss.py: kernels K23 `full_loss` and K24
`full_loss_grad`) on the CPU, where the port runs their plain versions:
the port's `full_loss` against the JAX package's
(itermvs_tpu/models/losses.py) on the same numpy inputs at B = 2, 8x10
(level 0 32x40), 5 predictions, stage 1 and 2, with GT bins at 0 and 255,
argmaxes 4 and 5 bins either side of the GT bin, a probability below
1e-5 at the GT bin and an empty mask planted; K24's plain formula against
`jax.grad` of the JAX loss and against autograd of the plain forward;
`FullLoss` (the plain K23 and K24 the card's path runs) against both;
gradcheck in float64; the wrappers' errors on `meta` tensors.

Tolerances: the forward 1e-6 relative (the existing parity test's bound:
XLA and torch sum in other orders); the gradients against `jax.grad`
1e-5 relative to each tensor's largest element, on inputs drawn away
from the ties where PyTorch's and JAX's rules differ (the clamp at
p = 1e-5 and at logit 0); against autograd of the plain forward within
one float32 unit in the last place (the formula repeats autograd's
operations in its order); `FullLoss`'s loss 1e-6 relative (K23's plain
version sums each term in float64, the eager loss in float32).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.models.losses import full_loss as jax_full_loss
from itermvs_tpu_torch.models.losses import full_loss
from itermvs_tpu_torch.ops import full_loss as fl

B, H, W, N = 2, 8, 10, 5
DMIN, DMAX = np.array([2.0, 3.0], np.float32), np.array([10.0, 12.0], np.float32)
REL_FWD, REL_GRAD = 1e-6, 1e-5


def _norm(d, b):
    """The loss's normalisation in float32, as the port computes it."""
    idmin, idmax = np.float32(1) / DMIN[b], np.float32(1) / DMAX[b]
    return ((np.float32(1) / (d + np.float32(1e-5))) - idmax) / (idmin - idmax)


def _fabricate(seed, b=B, h=H, w=W, n=N, empty=False):
    """Loss inputs in NCHW numpy, with the edge cases planted (module
    docstring): pixel (0, 0, 0)'s GT bin 0, (0, 0, 1)'s 255; each
    prediction's argmax at GT ± 4 and ± 5 on four pixels of image 1, its
    probability at the GT bin below 1e-5 on one. Logits are away from 0
    and depths away from the confidence threshold (no ties)."""
    rng = np.random.RandomState(seed)
    h0, w0 = 4 * h, 4 * w
    dmin, dmax = DMIN[:b, None, None], DMAX[:b, None, None]
    gt2 = rng.uniform(dmin * 0.9, dmax * 1.1, (b, h, w)).astype(np.float32)
    m2 = (rng.rand(b, h, w) > 0.25).astype(np.float32)
    plant = (b, h, w) == (B, H, W)
    if plant:
        gt2[0, 0, 0], gt2[0, 0, 1] = DMAX[0] * 1.5, DMIN[0] * 0.7
        gt2[1, 1, :5] = np.linspace(DMIN[1] * 1.5, DMAX[1] * 0.7, 5)     # bins 5..250
        m2[0, 0, :2] = m2[1, 1, :5] = 1.0
    if empty:
        m2[:] = 0.0
    ngt = _norm(gt2, np.arange(b)[:, None, None])
    gt = np.floor(np.clip(ngt, 0, 1) * np.float32(255) * m2).astype(np.int64)
    assert not plant or (gt[0, 0, 0] == 0 and (empty or gt[0, 0, 1] == 255))
    logits = rng.rand(n, b, 256, h, w) * 3.0
    for i in range(n if plant else 0):
        for k, off in enumerate((4, -4, 5, -5)):
            logits[i, 1, int(np.clip(gt[1, 1, k] + off, 0, 255)), 1, k] = 9.0
        logits[i, 1, gt[1, 1, 4], 1, 4] = -20.0           # p below 1e-5 at the GT bin
    prob = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    prob = prob.astype(np.float32)
    # Combines near the GT (inside and outside the confidence threshold).
    offset = rng.uniform(0.0006, 0.02, (n, b, h, w)) * rng.choice([-1, 1], (n, b, h, w))
    offset[np.abs(np.abs(offset) - 0.002) < 2e-4] = 0.004
    target = np.clip(ngt, 0.01, 0.99) + offset
    idmin, idmax = 1 / DMIN[:b, None, None], 1 / DMAX[:b, None, None]
    combine = (1 / (idmax + target * (idmin - idmax))).astype(np.float32)
    conf = rng.uniform(0.1, 2.0, (n, b, h, w)) * rng.choice([-1, 1], (n, b, h, w))
    m0 = (rng.rand(b, h0, w0) > 0.25) & (not empty)
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(prob=prob, combine=combine, conf=f32(conf),
                initial=f32(rng.uniform(dmin, dmax, (b, h, w))),
                up=f32(rng.uniform(dmin, dmax, (b, h0, w0))), gt2=gt2, m2=m2,
                gt0=f32(rng.uniform(dmin, dmax, (b, h0, w0))), m0=f32(m0),
                dmin=DMIN[:b].copy(), dmax=DMAX[:b].copy())


def _nhwc(f, as_array, xp=np):
    """models/losses.py's arguments ([B, H, W, C]) from `_fabricate`'s,
    each made by `as_array` (numpy's or, with `xp` jnp, JAX's arrays)."""
    last = lambda x: as_array(x[..., None])
    outputs = {"depths": {
        "probability": [as_array(xp.moveaxis(p, 1, -1)) for p in f["prob"]],
        "combine": [last(c) for c in f["combine"]], "initial": [last(f["initial"])]},
        "confidences": [last(c) for c in f["conf"]], "depths_upsampled": [last(f["up"])]}
    gt = {"level_0": last(f["gt0"]), "level_2": last(f["gt2"])}
    masks = {"level_0": last(f["m0"]), "level_2": last(f["m2"])}
    return outputs, gt, masks, as_array(f["dmin"]), as_array(f["dmax"])


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


_jax_full_loss = jax.jit(jax_full_loss, static_argnames="regress")


def _jax_loss(f, regress):
    return float(_jax_full_loss(*_nhwc(f, jnp.asarray, jnp), regress=regress))


def _leaves(f, dtype=torch.float32):
    """Port arguments whose depth outputs are leaves that take a gradient:
    (args, [probs, combines, confs, initial, up] leaves, NHWC)."""
    args = _nhwc(f, lambda x: _torch(x).to(dtype))
    outputs = args[0]
    leaves = [outputs["depths"]["probability"], outputs["depths"]["combine"],
              outputs["confidences"], outputs["depths"]["initial"],
              outputs["depths_upsampled"]]
    for group in leaves:
        for t in group:
            t.requires_grad_()
    return args, leaves


def _ulps(a, b):
    """Float32 units in the last place between a and b, elementwise."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.fixture(scope="module")
def inputs():
    return {empty: _fabricate(5, empty=empty) for empty in (False, True)}


@pytest.mark.parametrize("regress", [True, False])
@pytest.mark.parametrize("empty", [False, True])
def test_forward_matches_jax(inputs, regress, empty):
    """The port's loss on the CPU (the eager plain forward) and FullLoss's
    plain K23 (sums in float64) against the JAX loss."""
    f = inputs[empty]
    want = _jax_loss(f, regress)
    args = _nhwc(f, _torch)
    got = float(full_loss(*args, regress=regress))
    fused = float(fl.fused_full_loss(*args, regress=regress))
    assert np.isfinite(got) and got == pytest.approx(want, rel=REL_FWD)
    assert fused == pytest.approx(want, rel=REL_FWD)
    if empty:                       # only the level-0 term counts
        stats, _ = fl.full_loss_terms(fl.loss_inputs(regress, *fl.loss_tensors(
            *args, regress=regress)), regress)
        assert stats[1].tolist() == [0.0, float(f["m0"].sum())] + [0.0] * (stats.shape[1] - 2)


def test_terms_plant_their_cases(inputs):
    """K23's plain version: the GT bins 0 and 255, the argmax 4 and 5 bins
    either side (window in, out), p < 1e-5 at the GT bin kept raw (for
    the backward's clamp rule), and each term's count."""
    f = inputs[False]
    args = _nhwc(f, _torch)
    inp = fl.loss_inputs(True, *fl.loss_tensors(*args))
    stats, (p_gt, flags), arg = fl.loss_terms_plain(inp, True, argmax=True)
    assert flags[0, 0, 0, 0] == 0 and flags[0, 0, 0, 1] == 255
    gt = flags[0, 1, 1, :4].long()
    for i in range(N):
        assert (arg[i, 1, 1, :4] - gt).tolist() == [4, -4, 5, -5]
        assert flags[1 + i, 1, 1, :4].tolist() == [1, 1, 0, 0]
        assert 0 < p_gt[i, 1, 1, 4] < fl.P_MIN
    m1 = float(f["m2"].sum())
    counts = stats[1].tolist()
    assert counts[0] == m1 and counts[1] == float(f["m0"].sum())
    assert counts[2::3] == [m1] * N and counts[4::3] == [m1] * N
    assert counts[3::3] == [float((flags[1 + i].double() * torch.from_numpy(f["m2"])).sum())
                            for i in range(N)]


@pytest.mark.parametrize("regress", [True, False])
def test_backward_matches_jax_and_autograd(inputs, regress):
    """K24's plain formula (through FullLoss's backward) against jax.grad
    of the JAX loss (1e-5 of each tensor's largest element) and against
    autograd of the plain forward (one float32 ulp)."""
    f = inputs[False]
    names = ("prob", "combine", "conf", "initial", "up")

    def loss(prob, combine, conf, initial, up):
        g = dict(f, prob=prob, combine=combine, conf=conf, initial=initial, up=up)
        return jax_full_loss(*_nhwc(g, jnp.asarray, jnp), regress=regress)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*(jnp.asarray(f[k])
                                                               for k in names))
    want = {k: np.asarray(g) for k, g in zip(names, jgrads)}

    args, leaves = _leaves(f)
    flat = [t for group in leaves for t in group]
    plain = torch.autograd.grad(fl.full_loss_plain(*args, regress=regress), flat,
                                allow_unused=True)
    args2, leaves2 = _leaves(f)
    flat2 = [t for group in leaves2 for t in group]
    fused = torch.autograd.grad(fl.fused_full_loss(*args2, regress=regress), flat2,
                                allow_unused=True)
    nchw = lambda t: None if t is None else np.moveaxis(t.numpy(), -1, 1)
    split = lambda g: {"prob": np.stack([nchw(t) for t in g[:N]]),
                       "combine": [nchw(t) for t in g[N:2 * N]],
                       "conf": [nchw(t) for t in g[2 * N:3 * N]],
                       "initial": nchw(g[3 * N]), "up": nchw(g[3 * N + 1])}
    got, auto = split(fused), split(plain)
    for k in names:
        if not regress and k in ("combine", "conf"):
            assert all(t is None for t in got[k] + auto[k])
            assert not want[k].any()
            continue
        g, a = np.stack(got[k]).reshape(want[k].shape), np.stack(auto[k]).reshape(want[k].shape)
        scale = np.abs(want[k]).max()
        assert scale > 0
        assert np.abs(g - want[k]).max() <= REL_GRAD * scale, k
        assert _ulps(g, a).max() <= 1, k
    # The clamp passes no gradient below 1e-5; the dense ∂p is one-hot.
    prob_grad = got["prob"]
    assert not prob_grad[:, 1, :, 1, 4].any()
    assert ((prob_grad != 0).sum(axis=2) <= 1).all()


@pytest.mark.parametrize("regress", [True, False])
def test_gradcheck_in_float64(regress):
    """FullLoss (the plain K23 and K24) against finite differences in
    float64, at B = 1, 2x3, 2 predictions."""
    f = _fabricate(7, b=1, h=2, w=3, n=2)
    f = {k: v.astype(np.float64) for k, v in f.items()}
    args, leaves = _leaves(f, torch.float64)
    tensors = fl.loss_tensors(*args, regress=regress)

    def fn(*xs):
        return fl.FullLoss.apply(regress, *tensors[:6], *xs)

    assert torch.autograd.gradcheck(fn, tuple(tensors[6:]), fast_mode=True)


def test_process_group_counts_are_all_reduced_once(inputs, monkeypatch):
    """In a (world-1 gloo) group FullLoss all-reduces K23's count vector
    once, and its loss and gradients equal one process's."""
    f = inputs[False]
    args, leaves = _leaves(f)
    flat = [t for group in leaves for t in group]
    alone = fl.fused_full_loss(*args)
    want = torch.autograd.grad(alone, flat)
    calls = []
    reduce = fl.all_reduce_sum
    monkeypatch.setattr(fl, "all_reduce_sum", lambda x: calls.append(x.shape) or reduce(x))
    with chip_smoke.process_group("gloo", "cpu"):
        shared = fl.fused_full_loss(*args)
        got = torch.autograd.grad(shared, flat)
    assert calls == [(fl.term_count(N, True),)]
    assert torch.equal(alone, shared) and all(torch.equal(a, b) for a, b in zip(got, want))


def _meta_inputs(regress=True, **changes):
    plane, plane0 = (B, H, W), (B, 4 * H, 4 * W)
    make = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    t = dict(dmin=make((B,)), dmax=make((B,)), gt2=make(plane), m2=make(plane),
             gt0=make(plane0), m0=make(plane0), initial=make(plane), up=make(plane0),
             probs=tuple(make((B, 256, H, W)) for _ in range(N)),
             combines=tuple(make(plane) for _ in range(N)) if regress else (),
             confs=tuple(make(plane) for _ in range(N)) if regress else ())
    t.update(changes)
    return fl.LossInputs(**t)


@pytest.mark.parametrize("change, match", [
    (dict(gt0=torch.empty(B, 4 * H, device="meta")), "GT"),
    (dict(probs=(torch.empty(B, 128, H, W, device="meta"),) * N), "probabilities"),
    (dict(up=torch.empty(B, H, W, device="meta")), "level-0"),
    (dict(confs=()), "a combine and a confidence"),
    (dict(probs=(torch.empty(B, 256, H, W, dtype=torch.bfloat16, device="meta"),) * N),
     "float32"),
    (dict(), "CUDA device"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(change, match):
    inp = _meta_inputs(**change)
    with pytest.raises(ValueError, match=match):
        fl.full_loss_terms(inp, True)
    counts = torch.empty(fl.term_count(N, True), dtype=torch.float64, device="meta")
    saved = (torch.empty(N, B, H, W, device="meta"),
             torch.empty(N + 1, B, H, W, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match=match):
        fl.full_loss_grad(torch.ones((), device="meta"), counts, saved, inp, True)


def test_layouts_the_kernels_cannot_read_are_copied_and_counted():
    """A probability laid out channels-last (its NCHW view not dense) and
    a strided depth are copied once each; the model's layouts are not."""
    fl.full_loss_terms.copies = 0
    dense = _meta_inputs()
    assert fl.kernel_inputs(dense) == dense and fl.full_loss_terms.copies == 0
    nhwc = torch.empty(B, H, W, 256, device="meta").permute(0, 3, 1, 2)
    strided = torch.empty(B, H, 2 * W, device="meta")[..., ::2]
    fixed = fl.kernel_inputs(_meta_inputs(probs=(nhwc,) * N, initial=strided))
    assert fl.full_loss_terms.copies == N + 1
    assert all(t.is_contiguous() for t in (*fixed.probs, fixed.initial))
    fl.full_loss_terms.copies = 0


def test_chip_smoke_names_counts_and_bounds_the_loss_kernels():
    """chip_smoke's report and launch plan: K23's two kernels and K24's
    are filed under their report names (float32 only), the training
    step launches each once, the `full_loss` chain is labelled, and
    K23's byte bound over a step is one read of each of the 5
    probabilities [4, 256, 128, 160] plus a few bytes per pixel."""
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::full_loss_kernel(Planes, Planes, Planes, int, "
               "int, Inputs, int, float*, unsigned char*, int*, double*)") == "full_loss"
    assert cat("void (anonymous namespace)::full_loss_fold_kernel(double const*, double*, "
               "int, int, int, int)") == "full_loss"
    assert cat("void (anonymous namespace)::full_loss_grad_kernel<4>(Planes, Planes, int, "
               "int, Inputs)") == "full_loss_grad"
    assert cat("void (anonymous namespace)::view_aggregate_grad_kernel(float const*)") == \
        "view_aggregate_grad"
    shapes = chip_smoke.sweep_shapes(640, 512, 5, 4, 4)
    plan = chip_smoke.planned_step_counts(shapes, torch.bfloat16)
    assert plan["full_loss"] == plan["full_loss_grad"] == 1
    assert "full_loss" in chip_smoke.CHAINS and "full_loss" in chip_smoke.REPORT_PER_STEP
    assert chip_smoke.kernel_sources()["full_loss_grad"][0] == \
        "itermvs_tpu_torch/csrc/full_loss_grad.cu"
    pixels, pixels0 = 4 * 128 * 160, 4 * 512 * 640
    nbytes, _ = chip_smoke.loss_work(5, pixels, pixels0, True)
    assert nbytes == 4 * 256 * 5 * pixels + (12 + 8 * 5 + 4 * 5 + 6) * pixels + 12 * pixels0
    assert chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, train=True)["full_loss"] == \
        pytest.approx(1e3 * nbytes / chip_smoke.PEAK_BYTES_PER_S)
    assert chip_smoke.chain_bound_ms(1600, 1152, 5, 4)["full_loss"] == 0
    grad_bytes, _ = chip_smoke.loss_work(5, pixels, pixels0, True, grad=True)
    assert grad_bytes - nbytes == 4 * (1 + 10) * pixels + 4 * pixels0
    stage1, _ = chip_smoke.loss_work(5, pixels, pixels0, False)
    assert stage1 == 4 * 5 * pixels + (12 + 4 * 5 + 6) * pixels + 12 * pixels0


def test_chip_smoke_loss_cases_plant_their_cases():
    """`loss_case` on the CPU: the model's layouts (no copy), GT bins 0
    and 255, argmaxes at GT ± 4 and ± 5 (inside, outside the window), p
    at the GT bin below 1e-5 and exactly 1e-5, |δ| = 0 with a logit of 0,
    a NaN bin and an infinite one taking the argmax (finite sums); the
    empty case counts no level-2 pixel."""
    gen = torch.Generator().manual_seed(1)
    tensors = chip_smoke.loss_case(2, 4, 12, 3, gen, dev="cpu")
    inp = fl.loss_inputs(True, *tensors)
    fl.full_loss_terms.copies = 0
    assert fl.kernel_inputs(inp) == inp and fl.full_loss_terms.copies == 0
    stats, (p_gt, flags), arg = fl.loss_terms_plain(inp, True, argmax=True)
    assert flags[0, 0, 0, :2].tolist() == [0, 255]
    assert (arg[:, 0, 0, 2:6] - flags[0, 0, 0, 2:6]).tolist() == [[4, -4, 5, -5]] * 3
    assert flags[1:, 0, 0, 2:6].tolist() == [[1, 1, 0, 0]] * 3
    assert (p_gt[:, 0, 0, 6] < fl.P_MIN).all() and (p_gt[:, 0, 0, 7] == np.float32(1e-5)).all()
    assert (inp.confs[0][0, 0, 8] == 0) and (inp.combines[0][0, 0, 8] == inp.gt2[0, 0, 8])
    gt = flags[0, 0, 0].long()
    assert (arg[:, 0, 0, 9] == (gt[9] + 20) % 256).all()        # the NaN bin
    assert (arg[:, 0, 0, 10] == (gt[10] + 30) % 256).all()      # the +inf bin
    assert torch.isfinite(stats).all()
    assert float(full_loss(*chip_smoke.plain_arguments(tensors, True))) == pytest.approx(
        float(fl.loss_of(stats, stats[1], 3, True)), rel=REL_FWD)
    empty = fl.full_loss_terms(fl.loss_inputs(False, *chip_smoke.loss_case(
        2, 4, 10, 3, gen, regress=False, empty=True, dev="cpu")), False)[0]
    assert empty[1, 0] == 0 and empty[1, 1] > 0


def test_chip_smoke_holds_the_training_phases_to_the_loss_kernels():
    """`hold_loss_path`: no copy by K23 or K7, every probability gradient
    dense, no eager loss op (`loss_op_events`: any gather or argmax)."""
    from tests.test_torch_chip_smoke import _Event, _record

    events = [_Event("aten::gather_backward", 0, 1, "cpu"), _Event("full_loss_kernel", 0, 1),
              _Event("void at::native::reduce_kernel<ArgMaxOps<float>>", 1, 2)]
    assert chip_smoke.loss_op_events(events) == {
        "aten::gather_backward": 1, "void at::native::reduce_kernel<ArgMaxOps<float>>": 1}
    dense = [{"layout": "dense"}] * 5
    chip_smoke.hold_loss_path("t", 0, 0, dense, {})
    for args, match in (((1, 0, dense, {}), "K23 copied 1"), ((0, 2, dense, {}), "K7 2"),
                        ((0, 0, [{"layout": "channels-last"}], {}), "not dense"),
                        ((0, 0, None, {"aten::argmax": 1}), "eager loss ran")):
        with pytest.raises(SystemExit, match=match):
            chip_smoke.hold_loss_path("t", *args)
    single = {"runs": [[_record(10.0, 1.0)]]}
    copied = {"runs": [[_record(10.0, 1.0, loss_copies=1)]]}
    with pytest.raises(SystemExit, match="K23 copied 1"):
        chip_smoke.hold_ddp("t", [copied, copied], single, chip_smoke.planned_counts())
    profiled = dict(single, profile={"prob_grad_layouts": dense,
                                     "eager_loss_events": {"GatherBackward0": 1}})
    with pytest.raises(SystemExit, match="eager loss ran"):
        chip_smoke.hold_ddp("t", [profiled, profiled], single, chip_smoke.planned_counts())
