"""FeatureNet's BatchNorm epilogue (K17 `bn_act` and its backward K18
`bn_act_grad`) on the CPU, where the port runs their plain versions: the
port's `ConvBnReLU` and `ResidualBlock` (stride 2 and 1) with the DTU
weights and running statistics carried over by `weights.py` against the
JAX package's blocks (itermvs_tpu/models/blocks.py:106-165) on the same
numpy inputs, in eval and train mode, float32 and bfloat16, forward and
(train mode) gradients against `jax.vjp`; `BnAct`'s backward against
autograd of the plain forward and gradcheck; the running-statistics
update; the wrappers' errors.

Tolerances: float32 forward 1e-5 relative L2 (the convolutions sum in
another order in the two frameworks, and JAX's batch variance is
E[x²] − E[x]², the port's two-pass); bfloat16 forward MODULE_TOL, 2e-2
relative L2, as tests/test_torch_bf16.py holds every bf16 module against
JAX (bf16 rounds at other places in XLA:CPU and in torch); gradients
1e-5 relative L2 in float32. `BnAct`'s ∂y and ∂skip equal autograd's
through the plain forward bit for bit (the same operations and
roundings); ∂w, ∂b, ∂mean and ∂var come from the sums by other formulas,
within 1e-5 relative L2. Train mode's updated running statistics match
flax's within 1e-5 (relative, 1e-6 absolute) in float32 and 1e-4
relative L2 in bfloat16 (chip_smoke's bound for bf16 BN statistics), and
move bit for bit as before K17 (var_mean of the float32 input, then
0.9·r + 0.1·s).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models.blocks import ConvBnReLU as JaxConvBnReLU
from itermvs_tpu.models.blocks import ResidualBlock as JaxResidualBlock
from itermvs_tpu_torch.models.blocks import BatchNorm, ConvBnReLU, ResidualBlock
from itermvs_tpu_torch.ops.bn_act import BnAct, bn_act, bn_act_grad, bn_act_plain
from itermvs_tpu_torch.weights import npz_state_dict, pretrained_path

CKPT = pretrained_path("dtu")
BATCH, HEIGHT, WIDTH = 2, 24, 32
BF16 = torch.bfloat16
MODULE_TOL = 2e-2       # tests/test_torch_bf16.py's bound for a bf16 module against JAX
# (name in FeatureNet, input channels, port block, JAX block)
BLOCKS = {"conv1": (3, lambda dt: ConvBnReLU(3, 8, dtype=dt),
                    lambda dt: JaxConvBnReLU(8, dtype=dt)),
          "layer1_0": (8, lambda dt: ResidualBlock(8, 16, 2, dt),
                       lambda dt: JaxResidualBlock(16, stride=2, dtype=dt)),
          "layer1_1": (16, lambda dt: ResidualBlock(16, 16, dtype=dt),
                       lambda dt: JaxResidualBlock(16, dtype=dt))}
JNP = {torch.float32: jnp.float32, BF16: jnp.bfloat16}


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


def _blocks(dtu, name, dtype, train):
    """(the port's block, the JAX block, its variables, a seeded NHWC
    input) for FeatureNet's block `name` with the DTU weights."""
    sd, variables = dtu
    cin, port, jax_block = BLOCKS[name]
    prefix = f"feature_net.{name.replace('_', '.')}."
    block = port(dtype)
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    block.train(train)
    jvars = {k: variables[k]["feature_net"][name] for k in ("params", "batch_stats")}
    x = np.random.RandomState(7).randn(BATCH, HEIGHT, WIDTH, cin).astype(np.float32)
    if name != "conv1":
        x = np.maximum(x, 0.0)              # a block's input is a ReLU's output
    return block, jax_block(JNP[dtype]), jvars, x


def _port(block, x, dtype):
    return block(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", list(BLOCKS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_blocks_match_flax(dtu, name, train, dtype):
    """ConvBnReLU (form a) and ResidualBlock at stride 2 (form c) and 1
    (form b) against the JAX blocks, and in train mode the updated
    running statistics."""
    block, jax_block, jvars, x = _blocks(dtu, name, dtype, train)
    xj = jnp.asarray(x).astype(JNP[dtype])
    if train:
        want, mutated = jax_block.apply(jvars, xj, True, mutable=["batch_stats"])
    else:
        want = jax_block.apply(jvars, xj, False)
    with torch.no_grad():
        got = _port(block, x, dtype)
    assert got.dtype == dtype
    err = _rl2(_np(got), _np(want))
    assert err <= (1e-5 if dtype == torch.float32 else MODULE_TOL), err
    if train:
        stats = {k: v for k, v in block.state_dict().items() if "running" in k}
        flat = jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]
        assert len(flat) == len(stats)
        for path, value in flat:
            key = ".".join([p.key for p in path[:-3]] + ["bn", f"running_{path[-1].key}"])
            if dtype == torch.float32:
                np.testing.assert_allclose(stats[key].numpy(), np.asarray(value), rtol=1e-5,
                                           atol=1e-6)
            else:
                assert _rl2(stats[key].numpy(), value) <= 1e-4, key


@pytest.mark.parametrize("name", ["layer1_0", "layer1_1"])
def test_residual_block_gradients_match_jax_vjp(dtu, name):
    """A train-mode ResidualBlock's gradients (input, convolutions, BN
    scales and biases) against jax.vjp of the flax block, float32."""
    block, jax_block, jvars, x = _blocks(dtu, name, torch.float32, True)
    g = np.random.RandomState(8).randn(*jax_block.apply(
        jvars, jnp.asarray(x), True, mutable=["batch_stats"])[0].shape).astype(np.float32)

    def fwd(params, xj):
        return jax_block.apply({"params": params, "batch_stats": jvars["batch_stats"]}, xj,
                               True, mutable=["batch_stats"])[0]

    _, vjp = jax.vjp(fwd, jvars["params"], jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = block(xt)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert _rl2(_np(xt.grad.permute(0, 2, 3, 1)), _np(d_x)) <= 1e-5
    grads = dict(block.named_parameters())
    for sub in [k for k in ("conv1", "conv2", "downsample") if k in d_params]:
        tree = d_params[sub]
        want = {"conv.weight": np.asarray(tree["conv"]["conv"]["kernel"]).transpose(3, 2, 0, 1),
                "bn.weight": tree["bn"]["bn"]["scale"], "bn.bias": tree["bn"]["bn"]["bias"]}
        for key, w in want.items():
            err = _rl2(_np(grads[f"{sub}.{key}"].grad), w)
            assert err <= 1e-5, (sub, key, err)


def _inputs(form, dtype, shape=(2, 3, 4, 5), seed=0):
    gen = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    draw = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)

    def vectors():
        return (draw(c), draw(c), draw(c), 0.5 + torch.rand(c, generator=gen,
                                                           dtype=torch.float64))
    y, skip = draw(*shape).to(dtype), draw(*shape).to(dtype)
    first = tuple(v.to(dtype if dtype == torch.float64 else torch.float32) for v in vectors())
    second = tuple(v.to(first[0].dtype) for v in vectors())
    return (y, first, None if form == "plain" else skip,
            second if form == "downsample" else None)


FORMS = [("plain", True), ("plain", False), ("residual", True), ("downsample", True),
         ("downsample", False)]


@pytest.mark.parametrize("form,relu", FORMS)
def test_bn_act_gradcheck(form, relu):
    """BnAct's backward (K18's plain version, then the per-channel
    formulas) against finite differences in float64, every input."""
    y, vec, skip, skip_bn = _inputs(form, torch.float64)
    args = [y, *vec, skip, *(skip_bn or (None,) * 4)]
    args = [a.clone().requires_grad_() if a is not None else None for a in args]
    assert torch.autograd.gradcheck(lambda *a: BnAct.apply(*a, relu), args)


@pytest.mark.parametrize("form,relu", FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_bn_act_backward_matches_autograd_of_the_plain_forward(form, relu, dtype):
    """∂y and ∂skip bit-equal to autograd through bn_act_plain; the
    vectors' gradients within 1e-5 relative L2; the forward bit-equal."""
    y, vec, skip, skip_bn = _inputs(form, dtype, (2, 4, 6, 7), seed=1)
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (y, *vec, skip, *(skip_bn or (None,) * 4))]
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(dtype)

    def run(fn):
        ins = [t.detach().clone().requires_grad_() if t is not None else None for t in leaves]
        out = fn(ins[0], *ins[1:5], skip=ins[5],
                 skip_bn=None if ins[6] is None else tuple(ins[6:]), relu=relu)
        out.backward(g)
        return out, [None if t is None else t.grad for t in ins]

    out, got = run(bn_act)
    out_plain, want = run(bn_act_plain)
    assert torch.equal(out, out_plain)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
        elif i in (0, 5):
            assert torch.equal(a, b), i
        else:
            assert _rl2(a.numpy(), b.numpy()) <= 1e-5, i


def test_running_statistics_move_as_before():
    """Train mode moves the running statistics bit for bit as before K17
    (var_mean of the float32 input without grad, then 0.9·r + 0.1·s), in
    float32 and from a bfloat16 input; eval mode leaves them."""
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, BF16):
        bn = BatchNorm(6, dtype)
        with torch.no_grad():
            bn.running_mean.normal_(generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
        x = (1.3 * torch.randn(3, 6, 5, 7, generator=gen) + 0.4).to(dtype).requires_grad_()
        mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
        bn.train()
        out = bn(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        assert torch.equal(bn.running_mean, mean0.mul_(0.9).add_(0.1 * mean))
        assert torch.equal(bn.running_var, var0.mul_(0.9).add_(0.1 * var))
        assert int(bn.num_batches_tracked) == 1 and out.dtype == dtype
        out.float().sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()
        bn.eval()
        before = bn.running_mean.clone()
        with torch.no_grad():
            bn(x)
        assert torch.equal(bn.running_mean, before)


def test_wrappers_check_their_inputs():
    """On the CPU the wrappers count nothing; a missing skip, a wrong
    vector shape, float64 or non-float32 vectors, non-contiguous and
    non-CUDA tensors raise before any launch."""
    y, (w, b, mean, var), skip, skip_bn = _inputs("downsample", torch.float32)
    before = (bn_act.launches, bn_act.launches_bf16, bn_act_grad.launches)
    bn_act(y, w, b, mean, var, skip, skip_bn)
    bn_act_grad(y, y, y, w, mean, var)
    assert (bn_act.launches, bn_act.launches_bf16, bn_act_grad.launches) == before
    with pytest.raises(ValueError, match="skip_bn needs the skip"):
        bn_act(y, w, b, mean, var, None, skip_bn)
    with pytest.raises(ValueError, match="per-channel vectors"):
        bn_act(y, w[:2], b, mean, var)
    with pytest.raises(ValueError, match="DOWNSAMPLE form only"):
        bn_act_grad(y, y, y, w, mean, var, xd=skip)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="one dtype"):
        bn_act(meta(y.double()), *map(meta, (w, b, mean, var)))
    with pytest.raises(ValueError, match="float32 per-channel"):
        bn_act(meta(y), meta(w.to(BF16)), *map(meta, (b, mean, var)))
    with pytest.raises(ValueError, match="contiguous"):
        bn_act(meta(y).transpose(2, 3), *map(meta, (w, b, mean, var)))
    with pytest.raises(ValueError, match="CUDA device"):
        bn_act(meta(y), *map(meta, (w, b, mean, var)))
