"""BatchNorm's training statistics (K21 `bn_stats`) and their term of the
input gradient (K22 `bn_stats_grad`) on the CPU, where the port runs
their plain versions: the training epilogue `bn_train` (`BnTrain`: K17
on the batch statistics, K18 then K22 backward) in the port's
`ConvBnReLU` and `ResidualBlock` (stride 2 and 1) with the DTU weights
against `jax.vjp` of the JAX package's blocks in train mode
(itermvs_tpu/models/blocks.py:90-165, flax's BatchNorm) on the same numpy
inputs, float32 and bfloat16; the plain versions against float64;
`BnTrain`'s backward against autograd of the composition it replaced
(var_mean with grad, then `BnAct`) and against finite differences; the
process-group path of a world-1 gloo group against one process; the
wrappers' errors.

Tolerances: float32 output and gradients 1e-5 relative L2 (the
convolutions sum in another order in the two frameworks, and flax's
batch variance is E[x²] − E[x]², the port's two-pass); bfloat16 output
MODULE_TOL, 2e-2 relative L2 (tests/test_torch_bf16.py's bound for a
bf16 module against JAX), bf16 gradients GRAD_TOL_BF16, 1e-2: ∂x and the
weights' gradients are sums of bf16-rounded products whose rounding
places differ in XLA:CPU and torch, measured at 1.3-3.9e-3 here. Running
statistics as tests/test_torch_bn_act.py holds them (float32 1e-5
relative and 1e-6 absolute, bf16 1e-4 relative L2). K21's plain sums
in float64 within 1e-12 of a float64 reference (Σy relative to Σ|y|,
the squares relative), the process group's merge of two ranks' sums
(Chan's rule, float64) against float64 statistics of their whole batch
within 1e-6 (the float32 rounding of the result); K22's plain version within
4 float32 roundings of the float64 formula on the same inputs, relative
to the terms' magnitude. Against the replaced composition: the output,
∂w, ∂b and an identity skip's gradient bit for bit (the same statistics
and K18 on the CPU); ∂y and a downsample skip's gradient 1e-6 relative
L2 in float32 (var_mean's backward recomputes the mean; the explicit
formula adds the same terms in another order), in bfloat16 within 2^-7
of |K18's ∂y| + |∂y| (both round twice, at other places: the old sum
rounded the statistics' term to bf16 before adding it to K18's).
The world-1 group: 1e-6 relative L2 (the group path's sums and
divisions against var_mean's).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models.blocks import ConvBnReLU as JaxConvBnReLU
from itermvs_tpu.models.blocks import ResidualBlock as JaxResidualBlock
from itermvs_tpu_torch.models import blocks as port_blocks
from itermvs_tpu_torch.models.blocks import ConvBnReLU, ResidualBlock
from itermvs_tpu_torch.ops import bn_stats as stats_ops
from itermvs_tpu_torch.ops.bn_act import bn_act
from itermvs_tpu_torch.ops.bn_stats import bn_train
from itermvs_tpu_torch.weights import npz_state_dict, pretrained_path

CKPT = pretrained_path("dtu")
BATCH, HEIGHT, WIDTH = 2, 16, 24
BF16 = torch.bfloat16
MODULE_TOL, GRAD_TOL_BF16 = 2e-2, 1e-2
DIMS = (0, 2, 3)
# (name in FeatureNet, input channels, port block, JAX block)
BLOCKS = {"conv1": (3, lambda dt: ConvBnReLU(3, 8, dtype=dt),
                    lambda dt: JaxConvBnReLU(8, dtype=dt)),
          "layer1_0": (8, lambda dt: ResidualBlock(8, 16, 2, dt),
                       lambda dt: JaxResidualBlock(16, stride=2, dtype=dt)),
          "layer1_1": (16, lambda dt: ResidualBlock(16, 16, dtype=dt),
                       lambda dt: JaxResidualBlock(16, dtype=dt))}
JNP = {torch.float32: jnp.float32, BF16: jnp.bfloat16}
FORMS = [("plain", True), ("plain", False), ("residual", True), ("downsample", True)]


def _rl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def dtu():
    return npz_state_dict(CKPT), load_npz_variables(CKPT)


@pytest.mark.parametrize("name", list(BLOCKS))
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_training_blocks_match_jax_vjp(dtu, name, dtype):
    """A train-mode block through `bn_train` against jax.vjp of the flax
    block: the output, the updated running statistics, ∂x and every
    parameter's gradient (convolutions, BN scales and biases)."""
    sd, variables = dtu
    cin, port, jax_block = BLOCKS[name]
    prefix = f"feature_net.{name.replace('_', '.')}."
    block = port(dtype).train()
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    jvars = {k: variables[k]["feature_net"][name] for k in ("params", "batch_stats")}
    rng = np.random.RandomState(11)
    x = rng.randn(BATCH, HEIGHT, WIDTH, cin).astype(np.float32)
    if name != "conv1":
        x = np.maximum(x, 0.0)              # a block's input is a ReLU's output
    jb = jax_block(JNP[dtype])

    def fwd(params, xj):
        return jb.apply({"params": params, "batch_stats": jvars["batch_stats"]}, xj, True,
                        mutable=["batch_stats"])

    xj = jnp.asarray(x).astype(JNP[dtype])
    want, mutated = fwd(jvars["params"], xj)
    g = rng.randn(*want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, v: fwd(p, v)[0], jvars["params"], xj)
    d_params, d_x = vjp(jnp.asarray(g).astype(JNP[dtype]))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous().requires_grad_()
    out = block(xt)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2).to(dtype))
    f32 = dtype == torch.float32
    assert _rl2(_np(out.permute(0, 2, 3, 1)), _np(want)) <= (1e-5 if f32 else MODULE_TOL)
    tol = 1e-5 if f32 else GRAD_TOL_BF16
    err = _rl2(_np(xt.grad.permute(0, 2, 3, 1)), _np(d_x))
    assert err <= tol, ("x", err)
    grads = dict(block.named_parameters())
    subs = [k for k in ("conv1", "conv2", "downsample") if k in d_params] or [None]
    for sub in subs:
        tree = d_params if sub is None else d_params[sub]
        key = "" if sub is None else f"{sub}."
        want_g = {"conv.weight": _np(tree["conv"]["conv"]["kernel"]).transpose(3, 2, 0, 1),
                  "bn.weight": tree["bn"]["bn"]["scale"], "bn.bias": tree["bn"]["bn"]["bias"]}
        for k, w in want_g.items():
            err = _rl2(_np(grads[key + k].grad), _np(w))
            assert err <= tol, (sub, k, err)
    stats = {k: v for k, v in block.state_dict().items() if "running" in k}
    flat = jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]
    assert len(flat) == len(stats)
    for path, value in flat:
        key = ".".join([p.key for p in path[:-3]] + ["bn", f"running_{path[-1].key}"])
        if f32:
            np.testing.assert_allclose(stats[key].numpy(), np.asarray(value), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert _rl2(stats[key].numpy(), value) <= 1e-4, key


def test_plain_versions_against_float64():
    """K21's plain sums (Σy, Σ(y − ȳ)² about y's own mean) and K22's plain
    term against float64, in float32 and from bfloat16; `bn_batch_stats`
    on the CPU is var_mean of the float32 input, bit for bit."""
    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, BF16):
        y = (0.4 + 1.7 * torch.randn(3, 5, 7, 9, generator=gen)).to(dtype)
        yd = y.double()
        sums = stats_ops.bn_sums(y)
        m2 = (yd - yd.mean(DIMS).view(1, -1, 1, 1)).square().sum(DIMS)
        assert sums.dtype == torch.float64 and sums.shape == (2, 5)
        for got, want, scale in ((sums[0], yd.sum(DIMS), yd.abs().sum(DIMS)),
                                 (sums[1], m2, m2)):
            assert ((got - want).abs() <= 1e-12 * scale).all()
        var, mean = torch.var_mean(y.float(), dim=DIMS, unbiased=False)
        got = stats_ops.bn_batch_stats(y)
        assert torch.equal(got[0], mean) and torch.equal(got[1], var)

        d_y = torch.randn(y.shape, generator=gen).to(dtype)
        d_mean, d_var = 50 * torch.randn(5, generator=gen), 50 * torch.randn(5, generator=gen)
        got = stats_ops.bn_stats_grad_plain(d_y, y, mean, d_mean, d_var, 189)
        col = lambda v: v.double().view(1, -1, 1, 1)
        centred = yd - col(mean)
        want = d_y.double() + col(d_mean) / 189 + 2 * col(d_var) / 189 * centred
        scale = d_y.double().abs() + (col(d_mean) / 189).abs() + (
            2 * col(d_var) / 189 * centred).abs()
        ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7
        assert got.dtype == dtype
        assert ((got.double() - want).abs() <= 4 * ulp * scale).all()


def _inputs(form, dtype, shape=(2, 4, 6, 7), seed=1):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    draw = lambda: (0.3 + 1.5 * torch.randn(*shape, generator=gen, dtype=torch.float64))

    def vectors():
        sign = torch.tensor([1.0, -1.0]).repeat(c)[:c]
        return ((sign * (0.5 + torch.rand(c, generator=gen))).to(torch.float32),
                torch.randn(c, generator=gen).to(torch.float32))

    return (draw().to(dtype), vectors(), None if form == "plain" else draw().to(dtype),
            vectors() if form == "downsample" else None,
            torch.randn(shape, generator=gen).to(dtype))


@pytest.mark.parametrize("form,relu", FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_bn_train_backward_matches_the_replaced_composition(form, relu, dtype):
    """`bn_train` on `bn_batch_stats` against autograd of var_mean with
    grad on the float32 input followed by `BnAct` (the port before K21
    and K22): the same output, ∂w, ∂b and identity skip gradient, ∂y and
    a downsample skip's gradient within one rounding (see the top)."""
    y, (w, b), skip, skip_wb, g = _inputs(form, dtype)
    count = y.numel() // y.shape[1]

    def run(mode):
        """Gradients of `bn_train` ("new"), of var_mean with grad + BnAct
        ("old"), or of BnAct alone on detached statistics ("k18")."""
        ins = [t.detach().clone().requires_grad_() if t is not None else None
               for t in (y, w, b, skip, *(skip_wb or (None, None)))]
        yy, ww, bb, ss, w2, b2 = ins

        def stats(x):
            if mode != "old":
                return stats_ops.bn_batch_stats(x)
            var, mean = torch.var_mean(x.float(), dim=DIMS, unbiased=False)
            return mean, var

        mean, var = stats(yy)
        skip_bn = None if w2 is None else (w2, b2, *stats(ss))
        if mode == "new":
            out = bn_train(yy, ww, bb, mean, var, count, ss, skip_bn, relu)
        else:
            out = bn_act(yy, ww, bb, mean, var, ss, skip_bn, relu)
        out.backward(g)
        return out, [None if t is None else t.grad for t in ins]

    out, got = run("new")
    out_old, want = run("old")
    k18 = run("k18")[1]
    assert torch.equal(out, out_old)
    for i, (a, z) in enumerate(zip(got, want)):
        if z is None:
            assert a is None
        elif i == 0 or (i == 3 and form == "downsample"):
            if dtype == torch.float32:
                assert _rl2(a.numpy(), z.numpy()) <= 1e-6, i
            else:
                scale = z.float().abs() + k18[i].float().abs()
                assert ((a.float() - z.float()).abs() <= 2.0 ** -7 * scale).all(), i
        else:
            assert torch.equal(a, z), i


@pytest.mark.parametrize("form,relu", FORMS)
def test_bn_train_gradcheck(form, relu):
    """`bn_train` on float64 batch statistics of its own input (so its
    backward is the whole gradient: K18's plain version, then K22's on
    float64 with r = 1/count exactly) against finite differences."""
    y, (w, b), skip, skip_wb, _ = _inputs(form, torch.float64, (2, 3, 4, 5), seed=2)
    count = y.numel() // y.shape[1]

    def stats(x):
        with torch.no_grad():
            mean = x.mean(DIMS)
            return mean, (x - mean.view(1, -1, 1, 1)).square().mean(DIMS)

    def fn(yy, ww, bb, ss, w2, b2):
        skip_bn = None if w2 is None else (w2, b2, *stats(ss))
        return bn_train(yy, ww, bb, *stats(yy), count, ss, skip_bn, relu)

    args = [t.double().clone().requires_grad_() if t is not None else None
            for t in (y, w, b, skip, *(skip_wb or (None, None)))]
    assert torch.autograd.gradcheck(fn, args)


def test_process_group_statistics_and_gradient_match_one_process():
    """A stride-2 ResidualBlock in train mode inside a world-1 gloo group
    (the global statistics over all-reduces, ∂mean and ∂var summed over
    the group and divided by the count tensor before K22) against the
    same block outside it: output, running statistics and gradients."""
    sd = npz_state_dict(CKPT)
    prefix = "feature_net.layer1.0."
    x = np.maximum(np.random.RandomState(4).randn(2, 8, 12, 16), 0).astype(np.float32)
    g = np.random.RandomState(5).randn(2, 16, 6, 8).astype(np.float32)

    def run():
        block = ResidualBlock(8, 16, 2).train()
        block.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                               if k.startswith(prefix)})
        xt = torch.from_numpy(x).requires_grad_()
        out = block(xt)
        out.backward(torch.from_numpy(g))
        return out, xt.grad, block

    out, d_x, block = run()
    with chip_smoke.process_group("gloo", "cpu"):
        out_g, d_x_g, block_g = run()
    assert _rl2(out_g.detach().numpy(), out.detach().numpy()) <= 1e-6
    assert _rl2(d_x_g.numpy(), d_x.numpy()) <= 1e-6
    for (k, p), (_, q) in zip(block.named_parameters(), block_g.named_parameters()):
        assert _rl2(q.grad.numpy(), p.grad.numpy()) <= 1e-6, k
    for k, v in block.state_dict().items():
        if "running" in k:
            assert _rl2(block_g.state_dict()[k].numpy(), v.numpy()) <= 1e-6, k


def test_group_merge_of_two_ranks_matches_float64(monkeypatch):
    """`BatchNorm._global_statistics` on one rank's half of a batch, with
    the all-reduce adding the other half's share (two ranks of unequal
    means and sizes): mean and variance of the whole batch within 1e-6
    of float64, the count the whole batch's."""
    gen = torch.Generator().manual_seed(6)
    halves = [(0.2 + 1.3 * torch.randn(n, 3, 5, 6, generator=gen)) + shift
              for n, shift in ((2, 0.0), (3, 4.0))]
    s1, q1 = stats_ops.bn_sums_plain(halves[1])
    n1 = halves[1].numel() // 3
    calls = []

    def two_ranks(local):
        if not calls:
            other = torch.cat([s1, s1.new_full((1,), n1)])
        else:
            total = calls[0]
            other = q1 + n1 * (s1 / n1 - total[:3] / total[3:]).square()
        calls.append(local + other)
        return calls[-1]

    monkeypatch.setattr(port_blocks, "all_reduce_sum", two_ranks)
    mean, var, count = port_blocks.BatchNorm._global_statistics(halves[0])
    whole = torch.cat(halves).double()
    m64 = whole.mean(DIMS)
    v64 = (whole - m64.view(1, -1, 1, 1)).square().mean(DIMS)
    assert count.item() == whole.numel() // 3 and len(calls) == 2
    assert ((mean.double() - m64).abs() <= 1e-6 * m64.abs()).all()
    assert ((var.double() - v64).abs() <= 1e-6 * v64).all()


def test_wrappers_check_their_inputs():
    """On the CPU the wrappers count nothing; a wrong shape or vector
    length raises there; a wrong dtype, non-float32 vectors, a
    non-contiguous or non-CUDA tensor raise before any launch."""
    y, _, skip, _, g = _inputs("downsample", torch.float32)
    c = y.shape[1]
    mean, d_mean, d_var = torch.zeros(c), torch.ones(c), torch.ones(c)
    counters = (stats_ops.bn_sums, stats_ops.bn_stats_grad_)
    before = [(f.launches, f.launches_bf16) for f in counters]
    stats_ops.bn_batch_stats(y)
    stats_ops.bn_sums(y)
    stats_ops.bn_stats_grad_(g.clone(), y, mean, d_mean, d_var, 10,
                             (g.clone(), skip, mean, d_mean, d_var))
    assert [(f.launches, f.launches_bf16) for f in counters] == before
    with pytest.raises(ValueError, match="must be one"):
        stats_ops.bn_sums(y[0])
    with pytest.raises(ValueError, match="must be one"):
        stats_ops.bn_stats_grad_(g[:1], y, mean, d_mean, d_var, 10)
    with pytest.raises(ValueError, match="per-channel vectors"):
        stats_ops.bn_stats_grad_(g.clone(), y, mean[:2], d_mean, d_var, 10)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="one dtype"):
        stats_ops.bn_batch_stats(meta(y.double()))
    with pytest.raises(ValueError, match="float32 per-channel"):
        stats_ops.bn_stats_grad_(meta(g), meta(y), meta(mean.double()), meta(d_mean),
                                 meta(d_var), 10)
    with pytest.raises(ValueError, match="one dtype"):
        stats_ops.bn_sums(meta(y.double()))
    with pytest.raises(ValueError, match="contiguous"):
        stats_ops.bn_batch_stats(meta(y).transpose(2, 3))
    with pytest.raises(ValueError, match="one dtype"):
        stats_ops.bn_stats_grad_(meta(g.to(BF16)), meta(y), *map(meta, (mean, d_mean, d_var)),
                                 10)
    with pytest.raises(ValueError, match="CUDA device"):
        stats_ops.bn_stats_grad_(meta(g), meta(y), *map(meta, (mean, d_mean, d_var)), 10)
