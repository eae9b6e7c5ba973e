"""FeatureNet's BatchNorm epilogue (the counterpart of the XLA fusion, one
per convolution, of flax's BatchNorm normalise, the cast to the compute
dtype, the ReLU and the residual add at itermvs_tpu/models/blocks.py:90-120
and :152-165), and kernels K17 `bn_act` and its backward K18
`bn_act_grad`. The convolutions stay in cuDNN; the statistics are the
caller's (models/blocks.py `BatchNorm.statistics`): the running
statistics in eval, the batch's from K21 `bn_stats` in training, where
ops/bn_stats.py's `bn_train` runs K17 and K18 and adds the statistics'
term of ∂y with K22 `bn_stats_grad`.

For a convolution's output y [N, C, H, W] in the compute dtype and one
BatchNorm's per-channel float32 vectors w, b, mean, var:
    bn(y) = (y − mean) · (rsqrt(var + 1e-5) · w) + b     (flax's order, f32)
rounded to the compute dtype, and
    (a) relu(bn(y))                  ConvBnReLU (a lone BN: relu=False)
    (b) relu(bn(y) + skip)           ResidualBlock, stride 1
    (c) relu(bn(y) + bn'(xd))        ResidualBlock, stride 2 (`skip_bn`)
with the add and the ReLU in the compute dtype: in bfloat16 each BN
output is rounded first, as JAX rounds it.

K18 takes g = ∂out and the saved out (the ReLU's mask: out > 0), y (and
xd), and returns ∂y = g'·mul and ∂skip (g', or g'·mul' in form c) in the
compute dtype, and per channel, in float32, five rows per BN: the sums
s1 = Σg' (∂b) and s2 = Σg'·(y − mean) (xd and mean' for the second BN),
then ∂w = s2·rstd, ∂mean = −s1·mul and ∂var = −s2·w·rstd³/2 (rstd =
rsqrt(var + 1e-5)). `BnAct.backward` hands ∂w and ∂b to autograd (and
∂mean, ∂var, for statistics that autograd differentiates); ops/bn_stats.py's
`BnTrain` feeds ∂mean and ∂var to K22.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/bn_act.cu, csrc/bn_act_grad.cu, sharing csrc/bn_act.cuh) or raise;
only a CPU tensor takes the plain PyTorch versions beside them. A
kernel's tensors must be contiguous NCHW of one dtype and its vectors
contiguous float32 [C]: nothing is copied. K17's output is bit-equal to
its plain version on the card, and so are K18's ∂y and ∂skip; its sums
add the same terms in another, fixed order (no atomics).
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch import kernels

DTYPES = (torch.float32, torch.bfloat16)
EPS = 1e-5
# Elements of a plane per block of K18 (csrc/bn_act.cuh kSpan): sizes the
# scratch of per-block partial sums.
SPAN = 4096
PLAIN, RESIDUAL, DOWNSAMPLE = 0, 1, 2


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype BN computes in: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _col(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype).view(1, -1, 1, 1)


def bn_mul(w, var, dtype=torch.float32) -> torch.Tensor:
    """flax's per-channel factor rsqrt(var + 1e-5) · w, [1, C, 1, 1]."""
    return torch.rsqrt(_col(var, dtype) + EPS) * _col(w, dtype)


def bn_plain(y, w, b, mean, var) -> torch.Tensor:
    """flax's normalise (y − mean) · mul + b in float32 (float64 for a
    float64 y), rounded to y's dtype."""
    acc = _acc(y.dtype)
    return ((y.to(acc) - _col(mean, acc)) * bn_mul(w, var, acc) + _col(b, acc)).to(y.dtype)


def bn_act_plain(y, w, b, mean, var, skip=None, skip_bn=None, relu=True) -> torch.Tensor:
    """Plain PyTorch version of K17 (see the module docstring)."""
    out = bn_plain(y, w, b, mean, var)
    if skip is not None:
        out = out + (skip if skip_bn is None else bn_plain(skip, *skip_bn))
    return torch.relu(out) if relu else out


def bn_vector_rows(s1, s2, w, var) -> list:
    """One BN's five per-channel rows of K18 from its sums s1 = Σg' and
    s2 = Σg'·(x − mean): [s1, s2, ∂w, ∂mean, ∂var]."""
    rstd = torch.rsqrt(var.to(s1.dtype) + EPS)
    w = w.to(s1.dtype)
    return [s1, s2, s2 * rstd, -(s1 * (rstd * w)), -0.5 * s2 * w * (rstd * rstd * rstd)]


def bn_act_grad_plain(grad, y, out, w, mean, var, form=PLAIN, xd=None, skip_bn=None,
                      relu=True):
    """Plain PyTorch version of K18 in `form` (PLAIN, RESIDUAL or
    DOWNSAMPLE, whose `xd` and `skip_bn` are the second BN's input and
    vectors): (∂y, ∂skip or None, rows [5 or 10, C]) from ∂out `grad`,
    ∂y and ∂skip as autograd computes them through bn_act_plain, the rows
    `bn_vector_rows`' per BN."""
    acc = _acc(grad.dtype)
    masked = torch.ops.aten.threshold_backward(grad, out, 0) if relu else grad
    g = masked.to(acc)
    dims = (0, 2, 3)
    d_y = (g * bn_mul(w, var, acc)).to(grad.dtype)
    s1 = g.sum(dims)
    rows = bn_vector_rows(s1, (g * (y.to(acc) - _col(mean, acc))).sum(dims), w, var)
    d_skip = masked if form == RESIDUAL else None
    if form == DOWNSAMPLE:
        w2, _, mean2, var2 = skip_bn
        d_skip = (g * bn_mul(w2, var2, acc)).to(grad.dtype)
        rows += bn_vector_rows(s1, (g * (xd.to(acc) - _col(mean2, acc))).sum(dims), w2, var2)
    return d_y, d_skip, torch.stack(rows)


def _form(skip, skip_bn) -> int:
    if skip_bn is not None and skip is None:
        raise ValueError("bn_act: skip_bn needs the skip it normalises")
    return PLAIN if skip is None else RESIDUAL if skip_bn is None else DOWNSAMPLE


def _shapes(name, y, vectors, skip=None, skip_bn=None) -> None:
    """Raise unless y is [N, C, H, W], the skip y's shape, every
    per-channel vector [C] and a second BN's vectors come with its skip."""
    _form(skip, skip_bn)
    if y.dim() != 4:
        raise ValueError(f"{name}: y {tuple(y.shape)} must be [N, C, H, W]")
    c = y.shape[1]
    if skip is not None and skip.shape != y.shape:
        raise ValueError(f"{name}: skip {tuple(skip.shape)} must be y's {tuple(y.shape)}")
    for v in (*vectors, *(skip_bn or ())):
        if v is not None and v.shape != (c,):
            raise ValueError(f"{name}: per-channel vectors must be [{c}], got "
                             f"{tuple(v.shape)}")


def _check(name, tensors, vectors) -> None:
    """Raise unless the tensors are contiguous, of one dtype of DTYPES,
    and the vectors contiguous float32, all on one CUDA device."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: needs one dtype of {DTYPES}, got "
                         f"{[t.dtype for t in tensors]}")
    if any(v.dtype != torch.float32 for v in vectors):
        raise ValueError(f"{name}: needs float32 per-channel vectors, got "
                         f"{[v.dtype for v in vectors]}")
    if not all(t.is_contiguous() for t in (*tensors, *vectors)):
        raise ValueError(f"{name}: needs contiguous NCHW tensors and vectors")
    if device.type != "cuda" or any(t.device != device for t in (*tensors, *vectors)):
        raise ValueError(f"{name}: needs the inputs on one CUDA device, got "
                         f"{[str(t.device) for t in (*tensors, *vectors)]}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def spans_of(p: int) -> int:
    """K18's spans per plane of p elements."""
    return -(-p // SPAN)


def bn_act_args(y, w, b, mean, var, skip, skip_bn, relu, out) -> tuple:
    """K17's C arguments for checked inputs, writing `out`."""
    n, c, h, wd = y.shape
    w2, b2, mean2, var2 = skip_bn or (None,) * 4
    return (y.data_ptr(), _ptr(skip), out.data_ptr(), w.data_ptr(), b.data_ptr(),
            mean.data_ptr(), var.data_ptr(), _ptr(w2), _ptr(b2), _ptr(mean2), _ptr(var2),
            n, c, h * wd, _form(skip, skip_bn), int(relu), _stream())


def bn_act_grad_args(grad, y, out, w, mean, var, form, xd, skip_bn, relu, d_y, d_skip,
                     rows, partials) -> tuple:
    """K18's C arguments for checked inputs, writing ∂y, ∂skip (or None),
    the rows [5 or 10, C] and the scratch `partials` (`grad_buffers`)."""
    n, c, h, wd = y.shape
    w2, _, mean2, var2 = skip_bn or (None,) * 4
    return (grad.data_ptr(), _ptr(out) if relu else None, y.data_ptr(), _ptr(xd),
            d_y.data_ptr(), _ptr(d_skip), rows.data_ptr(), partials.data_ptr(), w.data_ptr(),
            mean.data_ptr(), var.data_ptr(), _ptr(w2), _ptr(mean2), _ptr(var2), n, c, h * wd,
            spans_of(h * wd), form, int(relu), _stream())


def grad_buffers(y, form):
    """K18's outputs and scratch for y in `form`: (∂y, ∂skip or None, rows
    [5·B, C], partials [B + 1, N·C·spans]) for its B BNs (2 in DOWNSAMPLE,
    else 1)."""
    n, c, h, w = y.shape
    bns = 2 if form == DOWNSAMPLE else 1
    f32 = dict(dtype=torch.float32, device=y.device)
    return (torch.empty_like(y), None if form == PLAIN else torch.empty_like(y),
            torch.empty(5 * bns, c, **f32), torch.empty(bns + 1, n * c * spans_of(h * w), **f32))


def launch(name: str, dtype: torch.dtype, args: tuple) -> None:
    """Kernel `name`'s bare launch in `dtype` on its C arguments
    (`*_args`). Counts nothing (the wrappers do)."""
    kname = f"{name}_bf16" if dtype == torch.bfloat16 else name
    kernels.check_launch(kname, kernels.function(kname)(*args))


def _count(fn, dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _tensors(*tensors):
    return [t for t in tensors if t is not None]


def _forward(y, w, b, mean, var, skip, skip_bn, relu):
    """K17 (or its plain version on the CPU)."""
    vectors = (w, b, mean, var)
    _shapes("bn_act", y, vectors, skip, skip_bn)
    if y.device.type == "cpu":
        return bn_act_plain(y, w, b, mean, var, skip, skip_bn, relu)
    _check("bn_act", _tensors(y, skip), (*vectors, *(skip_bn or ())))
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        launch("bn_act", y.dtype, bn_act_args(y, w, b, mean, var, skip, skip_bn, relu, out))
    _count(bn_act, y.dtype)
    return out


def bn_act_grad(grad, y, out, w, mean, var, form=PLAIN, xd=None, skip_bn=None, relu=True):
    """K18 (or its plain version on the CPU) in `form`: (∂y, ∂skip or
    None, rows). `out` (K17's output) is read only for the ReLU's mask;
    in DOWNSAMPLE `xd` is the second BN's input and `skip_bn` its (w',
    b', mean', var'), b' unused."""
    if not (form == DOWNSAMPLE) == (xd is not None) == (skip_bn is not None):
        raise ValueError("bn_act_grad: xd and skip_bn go with the DOWNSAMPLE form only")
    _shapes("bn_act_grad", y, (w, mean, var), xd, skip_bn)
    if grad.shape != y.shape or (relu and out.shape != y.shape):
        raise ValueError(f"bn_act_grad: grad {tuple(grad.shape)} and out must be y's "
                         f"{tuple(y.shape)}")
    if y.device.type == "cpu":
        return bn_act_grad_plain(grad, y, out, w, mean, var, form, xd, skip_bn, relu)
    _check("bn_act_grad", _tensors(grad, out if relu else None, y, xd),
           (w, mean, var, *((skip_bn[0], skip_bn[2], skip_bn[3]) if skip_bn else ())))
    d_y, d_skip, rows, partials = grad_buffers(y, form)
    with torch.cuda.device(y.device):
        launch("bn_act_grad", y.dtype, bn_act_grad_args(
            grad, y, out, w, mean, var, form, xd, skip_bn, relu, d_y, d_skip, rows, partials))
    _count(bn_act_grad, y.dtype)
    return d_y, d_skip, rows


class BnAct(torch.autograd.Function):
    """K17 forward, K18 backward (their plain versions on the CPU).
    Saves y, the output (for the ReLU's mask), the vectors and, in form c,
    xd; not the identity skip."""

    @staticmethod
    def forward(ctx, y, w, b, mean, var, skip, w2, b2, mean2, var2, relu):
        skip_bn = None if w2 is None else (w2, b2, mean2, var2)
        out = _forward(y, w, b, mean, var, skip, skip_bn, relu)
        ctx.form, ctx.relu = _form(skip, skip_bn), relu
        ctx.save_for_backward(y, out if relu else None, w, mean, var,
                              skip if skip_bn is not None else None, w2, mean2, var2)
        return out

    @staticmethod
    def backward(ctx, grad):
        y, out, w, mean, var, xd, w2, mean2, var2 = ctx.saved_tensors
        skip_bn = None if w2 is None else (w2, None, mean2, var2)
        d_y, d_skip, rows = bn_act_grad(grad, y, out, w, mean, var, ctx.form, xd, skip_bn,
                                        ctx.relu)
        # Per BN: ∂w, ∂b (= s1), ∂mean, ∂var from rows [s1, s2, ∂w, ∂mean, ∂var].
        vec = [(r[2], r[0], r[3], r[4]) for r in rows.view(-1, 5, rows.shape[-1])]
        second = vec[1] if skip_bn is not None else (None,) * 4
        grads = (d_y, *vec[0], d_skip, *second, None)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def bn_act(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mean: torch.Tensor,
           var: torch.Tensor, skip: torch.Tensor | None = None, skip_bn: tuple | None = None,
           relu: bool = True) -> torch.Tensor:
    """relu(bn(y) [+ skip or + bn'(skip)]) in y's dtype (float32 or
    bfloat16): `w`, `b`, `mean`, `var` the BN of y, float32 [C];
    `skip` the identity skip, or with `skip_bn` = (w', b', mean', var')
    the downsample convolution's output, normalised by that BN.
    Differentiable in every input (BnAct)."""
    w2, b2, mean2, var2 = skip_bn or (None,) * 4
    if _needs_grad((y, w, b, mean, var, skip, w2, b2, mean2, var2)):
        return BnAct.apply(y, w, b, mean, var, skip, w2, b2, mean2, var2, relu)
    return _forward(y, w, b, mean, var, skip, skip_bn, relu)


# Launches of each kernel's float32 and bfloat16 forms.
bn_act.launches = bn_act.launches_bf16 = 0
bn_act_grad.launches = bn_act_grad.launches_bf16 = 0
