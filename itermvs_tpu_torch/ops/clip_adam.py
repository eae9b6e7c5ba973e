"""The optimizer update, optax's clip → decayed weights → Adam chain (the
counterpart of itermvs_tpu/engine/train_loop.py:50-58, `optax.chain(
clip_by_global_norm(2.0), add_decayed_weights(wd), adam(lr, 0.9, 0.999))`,
which XLA fuses into the jitted step), kernels K25 `grad_norm` and K26
`clip_adam`, and `clip_adam_step_`, the entry point `train_step` calls in
place of a clip and `torch.optim.Adam.step`.

In float32, in optax's order of operations (optax 0.2.6:
transforms/_clipping.py clip_by_global_norm, transforms/_adding.py
add_decayed_weights, _src/transform.py scale_by_adam,
tree_utils/_tree_math.py update_moment and bias_correction), with t the
step count after its increment:
    n  = ‖g‖₂ over every gradient (Σg² in float64, its square root
         rounded to float32)
    g₁ = g where n < max_norm, else (g / n)·max_norm
    g₂ = g₁ + wd·p, only where wd > 0 (optax adds no decay at wd 0)
    m  = (1−β₁)·g₂ + β₁·m
    v  = (1−β₂)·g₂² + β₂·v
    u  = (m / (1−β₁ᵗ)) / (√(v / (1−β₂ᵗ)) + eps)
    p  = p + (−lr)·u
(1−β) is rounded once from the double, as optax's Python scalars are; β₁ᵗ
and β₂ᵗ are float32 powers. This is not `torch.optim.Adam.step`'s order
(it forms the update as p − (lr/bc₁)·m / (√v/√bc₂ + eps)), which rounds
differently.

The state is `torch.optim.Adam`'s: `make_optimizer` still returns one,
whose `param_groups` hold lr, the betas, eps and the weight decay, and
whose per-parameter state `step` (a CPU tensor, as Adam keeps it without
`capturable`), `exp_avg` (m) and `exp_avg_sq` (v) this update creates as
Adam would, and then reads and writes. So checkpoints save and restore as
before, and an Adam state written by `optimizer.step()` resumes here.

On CUDA tensors the wrappers launch the hand-written kernels
(csrc/grad_norm.cu, csrc/clip_adam.cu, sharing csrc/clip_adam.cuh;
float32 only: parameters and Adam state are float32 in both precisions)
or raise; only CPU tensors take the plain PyTorch versions beside them.
Both kernels walk a table of the tensors' pointers and sizes passed by
value in the kernel parameters (`tensor_tables`, at most MAX_TENSORS per
launch): no copy to the card, no launch per tensor, and no host sync: K25
leaves the norm on the card, where K26 reads it.
"""
from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import numpy as np
import torch

from itermvs_tpu_torch import kernels

CLIP_NORM = 2.0
MAX_TENSORS = 128                       # csrc/clip_adam.cuh kMaxTensors
THREADS, PER_THREAD = 256, 8            # kThreads, kPerThread
BLOCK_ELEMS = THREADS * PER_THREAD      # kBlockElems


class Hyper(NamedTuple):
    """The update's scalars, each a float32 value (a Python float): the
    clip threshold, −lr, the decay, β₁ and 1−β₁, β₂ and 1−β₂, eps, β₁ᵗ and
    β₂ᵗ."""
    max_norm: float
    neg_lr: float
    wd: float
    b1: float
    c1: float
    b2: float
    c2: float
    eps: float
    b1t: float
    b2t: float


def hyper(group: dict, step: float, max_norm: float = CLIP_NORM) -> Hyper:
    """`Hyper` of one of Adam's param_groups at step `step` (after its
    increment), rounded to float32 as optax rounds them: 1−β from the
    double, βᵗ a float32 power."""
    f32 = lambda x: float(np.float32(x))
    b1, b2 = (float(b) for b in group["betas"])
    power = lambda b: f32(np.float32(b) ** np.float32(step))
    return Hyper(f32(max_norm), f32(-float(group["lr"])), f32(group["weight_decay"]), f32(b1),
                 f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(group["eps"]), power(b1), power(b2))


# ------------------------------------------------------------------ plain versions
def grad_norm_plain(grads) -> torch.Tensor:
    """Plain version of K25: [Σg², √Σg²] in float64 on the gradients'
    device (0 and 0 for none)."""
    if not grads:
        return torch.zeros(2, dtype=torch.float64)
    total = torch.stack([g.double().square().sum() for g in grads]).sum()
    return torch.stack([total, total.sqrt()])


def clip_adam_plain_(params, grads, exp_avgs, exp_avg_sqs, norm, h: Hyper) -> None:
    """Plain version of K26: the update (module docstring) in place on
    each p, m, v, from K25's `norm` ([2] float64; [1] is read), one
    PyTorch op per operation, each rounded in the tensors' dtype. The
    divisors n, 1−β₁ᵗ and 1−β₂ᵗ are tensors on the device: PyTorch's CUDA
    divide by a Python scalar multiplies by its reciprocal instead."""
    if not params:
        return
    with torch.no_grad():
        dt, dev = params[0].dtype, params[0].device
        n = norm[1].to(dt)
        keep = n < h.max_norm
        bc1 = torch.tensor(np.float32(1.0) - np.float32(h.b1t), dtype=dt, device=dev)
        bc2 = torch.tensor(np.float32(1.0) - np.float32(h.b2t), dtype=dt, device=dev)
        for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
            g = torch.where(keep, g, g / n * h.max_norm)
            if h.wd > 0:
                g = g + h.wd * p
            m.copy_(h.c1 * g + h.b1 * m)
            v.copy_(h.c2 * (g * g) + h.b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + h.eps)
            p.copy_(p + h.neg_lr * u)


# ------------------------------------------------------------------ the table
class Table(ctypes.Structure):
    """csrc/clip_adam.cuh `Table`: one launch's tensors."""
    _fields_ = [("p", ctypes.c_void_p * MAX_TENSORS), ("g", ctypes.c_void_p * MAX_TENSORS),
                ("m", ctypes.c_void_p * MAX_TENSORS), ("v", ctypes.c_void_p * MAX_TENSORS),
                ("numel", ctypes.c_longlong * MAX_TENSORS),
                ("first", ctypes.c_int * (MAX_TENSORS + 1)), ("count", ctypes.c_int),
                ("block0", ctypes.c_int)]


def tensor_tables(grads, params=None, exp_avgs=None, exp_avg_sqs=None,
                  max_tensors: int = MAX_TENSORS):
    """(tables, blocks): the `Table`s of the tensors in order, at most
    `max_tensors` (≤ MAX_TENSORS) per launch, empty tensors left out, and
    the blocks of all launches (`BLOCK_ELEMS` elements of one tensor per
    block, numbered on from one launch to the next). A column not given
    (K25 reads the gradients alone) holds null pointers."""
    if not 1 <= max_tensors <= MAX_TENSORS:
        raise ValueError(f"tensor_tables: 1 to {MAX_TENSORS} tensors per launch, "
                         f"got {max_tensors}")
    columns = [c if c is not None else [None] * len(grads)
               for c in (params, grads, exp_avgs, exp_avg_sqs)]
    rows = [r for r in zip(*columns) if r[1].numel()]
    chunks = [rows[i:i + max_tensors] for i in range(0, len(rows), max_tensors)]
    tables = (Table * len(chunks))()
    blocks = 0
    for table, chunk in zip(tables, chunks):
        n = len(chunk)
        for field, column in zip(("p", "g", "m", "v"), zip(*chunk)):
            getattr(table, field)[:n] = [None if t is None else t.data_ptr() for t in column]
        numel = [g.numel() for _, g, _, _ in chunk]
        table.numel[:n] = numel
        table.first[:n + 1] = list(itertools.accumulate(
            (-(-k // BLOCK_ELEMS) for k in numel), initial=0))
        table.count, table.block0 = n, blocks
        blocks += table.first[n]
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"tensor_tables: {blocks} blocks exceed one launch's grid")
    return tables, blocks


# ------------------------------------------------------------------ the kernels
def _check(name: str, grads, *others) -> None:
    """Raise unless every list has the gradients' length, and each
    tensor's row (p, m, v beside g) has one shape, and the tensors lie on
    one device: on CUDA float32 and contiguous, on the CPU a floating
    dtype. (Once per step over 400 tensors: attribute reads only.)"""
    if any(len(o) != len(grads) for o in others):
        raise ValueError(f"{name}: needs one parameter, gradient and moment each, got "
                         f"{[len(grads)] + [len(o) for o in others]}")
    if not grads:
        return
    cuda, index = grads[0].is_cuda, grads[0].get_device()
    if not cuda and grads[0].device.type != "cpu":
        raise ValueError(f"{name}: needs tensors on one CUDA device (or the CPU), got "
                         f"{grads[0].device}")
    for row in zip(grads, *others):
        shape = row[0].shape
        for t in row:
            if t.shape != shape:
                raise ValueError(f"{name}: shapes differ within a row: "
                                 f"{[tuple(t.shape) for t in row]}")
            if (t.is_cuda is not cuda or t.get_device() != index
                    or (t.dtype is not torch.float32 or not t.is_contiguous() if cuda
                        else not t.is_floating_point())):
                raise ValueError(f"{name}: needs float32 contiguous tensors on one CUDA device "
                                 f"(or floating ones on the CPU), got "
                                 f"{[(str(t.dtype), str(t.device), t.is_contiguous()) for t in row]}")


def _launch(name: str, args: tuple) -> None:
    kernels.check_launch(name, kernels.function(name)(*args))


def grad_norm(grads, tables=None) -> torch.Tensor:
    """K25 (its plain version on the CPU): [Σg², √Σg²], float64 on the
    gradients' device. `tables`: `tensor_tables(grads, ...)` of gradients
    the caller has checked, where it has them."""
    if tables is None:
        _check("grad_norm", grads)
    if not grads or grads[0].device.type == "cpu":
        return grad_norm_plain(grads)
    tables, blocks = tables or tensor_tables(grads)
    dev = grads[0].device
    buf = torch.empty(2 + blocks, dtype=torch.float64, device=dev)
    out, partials = buf[:2], buf[2:]
    with torch.cuda.device(dev):
        _launch("grad_norm", (tables, len(tables), partials.data_ptr(), blocks, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream))
    grad_norm.launches += 1
    return out


def clip_adam_(params, grads, exp_avgs, exp_avg_sqs, norm, h: Hyper, tables=None) -> None:
    """K26 (its plain version on the CPU): the update in place on each p,
    m and v from K25's `norm`. `tables`: `tensor_tables(grads, params,
    exp_avgs, exp_avg_sqs)` of tensors the caller has checked, where it
    has them."""
    if tables is None:
        _check("clip_adam", grads, params, exp_avgs, exp_avg_sqs)
    if not grads:
        return
    if grads[0].device.type == "cpu":
        clip_adam_plain_(params, grads, exp_avgs, exp_avg_sqs, norm, h)
        return
    if not (norm.dtype == torch.float64 and norm.shape == (2,) and norm.is_contiguous()
            and norm.device == grads[0].device):
        raise ValueError(f"clip_adam: needs K25's [2] float64 output on the gradients' "
                         f"device, got {norm.dtype} {tuple(norm.shape)} on {norm.device}")
    tables, _ = tables or tensor_tables(grads, params, exp_avgs, exp_avg_sqs)
    with torch.cuda.device(grads[0].device):
        _launch("clip_adam", (tables, len(tables), norm.data_ptr(), *h,
                              torch.cuda.current_stream().cuda_stream))
    clip_adam_.launches += 1


# ------------------------------------------------------------------ the entry point
_UNSUPPORTED = ("amsgrad", "maximize", "capturable", "differentiable", "fused",
                "decoupled_weight_decay")


def adam_state(optimizer: torch.optim.Adam, params) -> tuple[list, list, list]:
    """(steps, exp_avgs, exp_avg_sqs) of `params` in `optimizer`'s state,
    each created where missing as `torch.optim.Adam` creates it: `step` a
    0-dim CPU tensor of the default scalar dtype, the moments zeros like
    the parameter."""
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    steps, ms, vs = [], [], []
    for p in params:
        state = optimizer.state[p]
        if len(state) == 0:
            state["step"] = torch.tensor(0.0, dtype=scalar)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        steps.append(state["step"])
        ms.append(state["exp_avg"])
        vs.append(state["exp_avg_sq"])
    return steps, ms, vs


def clip_adam_step_(optimizer: torch.optim.Adam, max_norm: float = CLIP_NORM) -> torch.Tensor:
    """One optax update of every parameter of `optimizer` (a
    `torch.optim.Adam` of one parameter group, as `make_optimizer` builds
    it, without amsgrad, maximize, capturable, fused or decoupled decay)
    from its `.grad`, which every parameter must have: the global norm
    (K25), then the clip, the group's decay and Adam at its lr (K26). The
    steps are incremented as Adam increments them and must agree. Returns
    [Σg², ‖g‖₂] (float64, on the parameters' device; nothing is read
    back)."""
    if len(optimizer.param_groups) != 1:
        raise ValueError(f"clip_adam_step_: needs one parameter group, got "
                         f"{len(optimizer.param_groups)}")
    group = optimizer.param_groups[0]
    bad = [k for k in _UNSUPPORTED if group.get(k)]
    if bad:
        raise ValueError(f"clip_adam_step_: Adam options {bad} are not the optax chain")
    params = list(group["params"])
    if any(p.grad is None for p in params):
        raise ValueError("clip_adam_step_: every parameter needs a gradient (train_step "
                         "fills the ones the loss does not reach with zeros)")
    steps, ms, vs = adam_state(optimizer, params)
    grads = [p.grad for p in params]
    _check("clip_adam", grads, params, ms, vs)
    if not params:
        return grad_norm_plain([])
    torch._foreach_add_(steps, 1)
    stacked = torch.stack(steps)
    if not bool((stacked == stacked[0]).all()):
        raise ValueError(f"clip_adam_step_: the parameters' steps differ: "
                         f"{sorted(set(stacked.tolist()))}")
    tables = tensor_tables(grads, params, ms, vs) if grads[0].is_cuda else None
    norm = grad_norm(grads, tables)
    clip_adam_(params, grads, ms, vs, norm, hyper(group, float(stacked[0]), max_norm), tables)
    return norm


# Launches of each kernel (one per C call; each call launches one kernel per
# table, and K25 its fold).
grad_norm.launches = clip_adam_.launches = 0
