"""The optimizer update (itermvs_tpu_torch/ops/clip_adam.py: K25
grad_norm, K26 clip_adam and `clip_adam_step_`) on the CPU, where the
wrappers run their plain versions, against optax's chain
(`itermvs_tpu.engine.train_loop.make_optimizer`: clip_by_global_norm(2.0)
→ add_decayed_weights(wd) → adam).

Tolerances: parameters after each step abs 1e-7 (as
tests/test_torch_train.py holds the update; the norm here is a float64
sum where optax sums in float32, and XLA may contract the moments' sums);
Adam's moments rel 1e-6 (a few float32 roundings apart). The small tree
keeps every element away from cancellation, as that file's small tree
does: |g| in [1, 3] (scaled below the clip by 0.02) with the sign of p,
|p| in [0.05, 0.15], so wd·p never cancels the gradient. The kernels'
arithmetic, emulated in numpy float32 one rounding per operation, must
equal the plain version bit for bit: that is the card's gate
(chip_smoke.check_clip_adam) between K26 and the plain version.
The real model's gradients and `train_step` against the JAX step are held
in tests/test_torch_train.py, beside the JAX step its fixtures compute.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from itermvs_tpu.engine.train_loop import make_optimizer as jax_make_optimizer
from itermvs_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from itermvs_tpu_torch.engine.train_loop import clip_by_global_norm_, make_optimizer
from itermvs_tpu_torch.ops import clip_adam as ops

SHAPES = {"a": (6, 5), "b": (7,), "c": (3, 2, 2)}
LRS = (1e-3, 1e-3, 5e-4)            # the third step at another lr


def _tree(seed, scale):
    """(params, [grads of 3 steps]) of the small tree, numpy float32."""
    rng = np.random.RandomState(seed)
    params = {k: (rng.uniform(0.05, 0.15, s) * rng.choice([-1, 1], s)).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.uniform(1.0, 3.0, v.shape) * np.sign(v) * scale).astype(np.float32)
              for k, v in params.items()} for _ in LRS]
    return params, grads


def _optax_steps(params, grads, wd):
    """optax's chain over the steps: [(params, mu, nu) after each step]."""
    tx = jax_make_optimizer(wd)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    out = []
    for g, lr in zip(grads, LRS):
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = jax.tree.map(lambda a, u: a + u, p, updates)
        adam = state.inner_state[2][0]
        out.append(tuple(jax.tree.map(np.asarray, t) for t in (p, adam.mu, adam.nu)))
    return out


def _module(params):
    return torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                   for k, v in params.items()})


@pytest.mark.parametrize("clipped", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_plain_update_matches_optax(clipped, wd):
    """Three steps of `clip_adam_step_` (t = 1, 2, 3, the last at another
    lr) against optax's chain: the clip engaged (global norm ≈ 12) or not
    (≈ 0.25), with and without the decay."""
    params, grads = _tree(3, 1.0 if clipped else 0.02)
    module = _module(params)
    optimizer = make_optimizer(module, wd)
    for (want_p, want_m, want_v), g, lr in zip(_optax_steps(params, grads, wd), grads, LRS):
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.param_groups[0]["lr"] = lr
        norm = ops.clip_adam_step_(optimizer)
        assert norm.dtype == torch.float64 and (float(norm[1]) > 2.0) == clipped
        for k, p in module.items():
            state = optimizer.state[p]
            np.testing.assert_allclose(p.detach().numpy(), want_p[k], rtol=0, atol=1e-7)
            np.testing.assert_allclose(state["exp_avg"].numpy(), want_m[k], rtol=1e-6)
            np.testing.assert_allclose(state["exp_avg_sq"].numpy(), want_v[k], rtol=1e-6)
    assert all(float(optimizer.state[p]["step"]) == len(LRS) for p in module.values())


def _emulate(p, g, m, v, norm, h):
    """K26's arithmetic in numpy float32, one rounding per operation, in
    the order of csrc/clip_adam.cu."""
    f = np.float32
    n = f(norm)
    if not n < f(h.max_norm):
        g = (g / n) * f(h.max_norm)
    if f(h.wd) > 0:
        g = g + f(h.wd) * p
    m = f(h.c1) * g + f(h.b1) * m
    v = f(h.c2) * (g * g) + f(h.b2) * v
    u = (m / (f(1) - f(h.b1t))) / (np.sqrt(v / (f(1) - f(h.b2t))) + f(h.eps))
    return p + f(h.neg_lr) * u, m, v


@pytest.mark.parametrize("case", ["clip", "no_clip", "clip_wd"])
def test_kernel_arithmetic_equals_the_plain_version(case):
    """The plain version (one PyTorch op per operation) equals K26's
    formula emulated in numpy float32 bit for bit, at t = 1 and t = 7,
    and K25's float64 norm is the float64 sum's square root."""
    rng = np.random.RandomState(5)
    shapes = [(33,), (4, 9), (2, 3, 5)]
    scale = 1.0 if case.startswith("clip") else 0.01
    group = {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8,
             "weight_decay": 1e-4 if case == "clip_wd" else 0.0}
    ps = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
    ms = [(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    vs = [(rng.rand(*s) * 0.01).astype(np.float32) for s in shapes]
    norm = ops.grad_norm_plain([torch.from_numpy(g) for g in gs])
    exact = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in gs))
    assert float(norm[1]) == pytest.approx(exact, rel=1e-15)
    assert (float(norm[1]) >= 2.0) == case.startswith("clip")
    for step in (1, 7):
        h = ops.hyper(group, step)
        tp, tm, tv = ([torch.from_numpy(a.copy()) for a in arrays] for arrays in (ps, ms, vs))
        ops.clip_adam_(tp, [torch.from_numpy(g) for g in gs], tm, tv, norm, h)
        for i in range(len(shapes)):
            want = _emulate(ps[i], gs[i], ms[i], vs[i], float(norm[1]), h)
            for got, w in zip((tp[i], tm[i], tv[i]), want):
                assert np.array_equal(got.numpy().view(np.int32), w.view(np.int32))


def test_hyper_rounds_as_optax():
    """1 − β rounded once from the double (optax's Python scalars), βᵗ a
    float32 power, −lr, every value a float32."""
    h = ops.hyper({"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.0}, 3)
    assert h.c1 == float(np.float32(0.1)) and h.c1 != float(np.float32(1) - np.float32(0.9))
    assert h.b1t == float(np.float32(0.9) ** np.float32(3))
    assert h.neg_lr == -float(np.float32(1e-3)) and h.max_norm == 2.0
    assert all(v == float(np.float32(v)) for v in h)


def test_state_saves_restores_and_an_adam_state_resumes(tmp_path):
    """The update's state is torch.optim.Adam's: it saves through
    `save_checkpoint`, restores into a fresh `make_optimizer`, and the
    restored run's next step equals the live one's bit for bit. An Adam
    state written by the old path (`clip_by_global_norm_` +
    `optimizer.step()`) resumes under the new update at its step count,
    as optax's third step from that state's moments."""
    params, grads = _tree(4, 1.0)
    module = _module(params)
    optimizer = make_optimizer(module, 0.1)
    for g in grads[:2]:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        ops.clip_adam_step_(optimizer)
    path = save_checkpoint(str(tmp_path), 0, module, optimizer, step=2)
    restored = _module(params)
    restored_opt = make_optimizer(restored, 0.1)
    assert restore_checkpoint(path, restored, restored_opt) == (0, 2)
    for m in (module, restored):
        for k, p in m.items():
            p.grad = torch.from_numpy(grads[2][k].copy())
    ops.clip_adam_step_(optimizer)
    ops.clip_adam_step_(restored_opt)
    for k in params:
        a, b = optimizer.state[module[k]], restored_opt.state[restored[k]]
        assert torch.equal(module[k], restored[k]) and float(b["step"]) == 3
        assert b["step"].device.type == "cpu" and b["step"].dtype == a["step"].dtype
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])

    old = _module(params)
    old_opt = make_optimizer(old, 0.1)
    for g in grads[:2]:
        for k, p in old.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_by_global_norm_(list(old.values()))
        old_opt.step()
    path = save_checkpoint(str(tmp_path), 1, old, old_opt)
    resumed = _module(params)
    resumed_opt = make_optimizer(resumed, 0.1)
    restore_checkpoint(path, resumed, resumed_opt)
    for k, p in resumed.items():
        p.grad = torch.from_numpy(grads[2][k].copy())
    ops.clip_adam_step_(resumed_opt)
    # optax's third step from the old path's moments and parameters.
    tx = jax_make_optimizer(0.1)
    p2 = {k: jnp.asarray(v.detach().numpy()) for k, v in old.items()}
    state = tx.init(p2)
    moments = lambda key: {k: jnp.asarray(old_opt.state[p][key].numpy()) for k, p in old.items()}
    adam = state.inner_state[2]
    adam = (adam[0]._replace(count=jnp.asarray(2, jnp.int32), mu=moments("exp_avg"),
                             nu=moments("exp_avg_sq")), *adam[1:])
    state = state._replace(inner_state=(*state.inner_state[:2], adam))
    state.hyperparams["learning_rate"] = jnp.float32(1e-3)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads[2]), state, p2)
    for k, p in resumed.items():
        assert float(resumed_opt.state[p]["step"]) == 3
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p2[k] + updates[k]),
                                   rtol=0, atol=1e-7)


def test_tensor_tables_keep_order_sizes_and_chunks():
    """The host-side table: tensors in order, empty ones left out, each
    tensor's blocks (BLOCK_ELEMS elements each) numbered on from the
    tensor before and from the launch before, at most MAX_TENSORS (or the
    given limit) per launch, absent columns null; the layout of
    csrc/clip_adam.cuh's Table within CUDA's 32764 bytes of parameters."""
    numels = [1, 2048, 2049, 0, 20736, 5] + [3] * 300
    grads = [torch.zeros(n) for n in numels]
    params = [torch.zeros(n) for n in numels]
    kept = [i for i, n in enumerate(numels) if n]
    tables, blocks = ops.tensor_tables(grads, params, params, params)
    assert len(tables) == 3 and [t.count for t in tables] == [128, 128, len(kept) - 256]
    per_block = [-(-numels[i] // ops.BLOCK_ELEMS) for i in kept]
    assert per_block[:5] == [1, 1, 2, 11, 1] and blocks == sum(per_block)
    row = 0
    for t in tables:
        assert t.block0 == sum(per_block[:row])
        assert list(t.first[:t.count + 1]) == [sum(per_block[row:row + j])
                                             for j in range(t.count + 1)]
        for j in range(t.count):
            i = kept[row + j]
            assert t.g[j] == grads[i].data_ptr() and t.p[j] == t.m[j] == t.v[j] == \
                params[i].data_ptr()
            assert t.numel[j] == numels[i]
        row += t.count
    norm_tables, norm_blocks = ops.tensor_tables(grads[:6], max_tensors=2)
    assert [t.count for t in norm_tables] == [2, 2, 1] and norm_blocks == 16
    assert [t.block0 for t in norm_tables] == [0, 2, 15]
    assert all(t.p[j] is None and t.m[j] is None for t in norm_tables for j in range(t.count))
    assert ops.tensor_tables([]) [1] == 0 and len(ops.tensor_tables([])[0]) == 0
    for bad in (0, ops.MAX_TENSORS + 1):
        with pytest.raises(ValueError, match="tensors per launch"):
            ops.tensor_tables(grads, max_tensors=bad)
    size = 4 * ops.MAX_TENSORS * 8 + ops.MAX_TENSORS * 8 + (ops.MAX_TENSORS + 1) * 4 + 8
    assert ctypes.sizeof(ops.Table) == -(-size // 8) * 8 <= 32764 - 64


def test_entry_point_refuses_what_it_does_not_run():
    """No gradient, an Adam option outside the optax chain, more than one
    parameter group, steps that differ, and rows of other shapes raise; a
    device other than CUDA or the CPU is refused by the wrappers (no
    fallback)."""
    params, grads = _tree(6, 1.0)
    module = _module(params)
    optimizer = make_optimizer(module)
    with pytest.raises(ValueError, match="needs a gradient"):
        ops.clip_adam_step_(optimizer)
    for k, p in module.items():
        p.grad = torch.from_numpy(grads[0][k].copy())
    amsgrad = torch.optim.Adam(module.parameters(), amsgrad=True)
    with pytest.raises(ValueError, match="amsgrad"):
        ops.clip_adam_step_(amsgrad)
    two_groups = torch.optim.Adam([{"params": [module["a"]]}, {"params": [module["b"]]}])
    with pytest.raises(ValueError, match="one parameter group"):
        ops.clip_adam_step_(two_groups)
    ops.clip_adam_step_(optimizer)
    optimizer.state[module["a"]]["step"] += 1
    with pytest.raises(ValueError, match="steps differ"):
        ops.clip_adam_step_(optimizer)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.clip_adam_([torch.zeros(3)], [torch.zeros(4)], [torch.zeros(3)], [torch.zeros(3)],
                       torch.zeros(2, dtype=torch.float64), ops.hyper(
                           optimizer.param_groups[0], 1))
    meta = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="CUDA device"):
        ops.grad_norm(meta)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.clip_adam_(meta, meta, meta, meta, torch.zeros(2, dtype=torch.float64),
                       ops.hyper(optimizer.param_groups[0], 1))


def test_cpu_wrappers_count_no_launch():
    """On the CPU the wrappers run the plain versions and count nothing."""
    before = (ops.grad_norm.launches, ops.clip_adam_.launches)
    params, grads = _tree(7, 1.0)
    module = _module(params)
    optimizer = make_optimizer(module)
    for k, p in module.items():
        p.grad = torch.from_numpy(grads[0][k].copy())
    ops.clip_adam_step_(optimizer)
    assert (ops.grad_norm.launches, ops.clip_adam_.launches) == before
