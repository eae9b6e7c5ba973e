"""The port's data-parallel training (parallel/mesh.py) on the CPU, against
its one-process step and the JAX package's single-device step.

Two ranks, each its own Python process started fresh (no JAX in them),
joined over gloo on localhost (`chip_smoke.run_ranks`, the helper
chip_smoke's `train_ddp_2rank` runs on the card), take one step each on
their 2 samples of a global batch of 4 distinct samples (128×96, 3
views, iteration 2, tests/test_train.py's scene) whose masks keep
another share of pixels in each sample: stage 2 (--regress) and stage 1
from JAX's own fresh `model.init`, and one val step. The JAX side is
`make_train_step` / `make_val_step` on all 4 in this process.

Tolerances: loss and val scalars rel 1e-5 (abs 1e-6 for a scalar that is
0 in exact arithmetic); BN running statistics after the step 1e-5 of
max|want| (tests/test_torch_train.py's); the clipped gradient of the
two ranks against the one-process port's rel L2 1e-4 (that file's). The
parameters after the step: Adam's first step moves each element by
lr·g/(|g| + eps), ±lr wherever |g| ≫ eps, so an element whose gradient
is within f32 noise of 0 (the view-weight bias's is 0 in exact
arithmetic) lands 2·lr from the other framework's. Every element must
agree within 1e-6 but for a share of 1e-3 (46-56 of the 341,333
against JAX here; the step of one rank's 2 samples alone moves a fifth
of them). The batch and init use seed 2, as
tests/test_torch_train.py does, for the reason given there (argmax
near-ties).
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.engine.train_loop import (
    create_train_state, make_optimizer as jax_make_optimizer, make_train_step,
    make_val_step)
from itermvs_tpu.models import Pipeline as JaxPipeline
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models.losses import _masked_mean
from itermvs_tpu_torch.weights import flax_state_dict, flax_tree, load_state
from tests.test_train import _make_batch

SEED = 2
ITERATION = 2
LR = 1e-3
WORLD = 2
BATCH = 4
STAGES = {"stage2": True, "stage1": False}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _rel_l2(got: dict, want: dict) -> float:
    diff = sum(np.sum((got[k].astype(np.float64) - w) ** 2) for k, w in want.items())
    return float(np.sqrt(diff / sum(np.sum(w.astype(np.float64) ** 2)
                                    for w in want.values())))


def _assert_same_adam_step(got: dict, want: dict):
    """Parameters after one step: all but a share of 1e-3 within 1e-6."""
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[k] - w).ravel() for k, w in want.items()])
    assert np.mean(diff > 1e-6) <= 1e-3, (np.sum(diff > 1e-6), diff.size)


def _batch():
    """4 distinct samples; sample i keeps pixels with probability 0.9 − 0.2·i."""
    rng = np.random.RandomState(SEED)
    batch = jax.tree.map(np.array, _make_batch(rng, batch=BATCH, views=3, height=96,
                                                 width=128))
    keep = (0.9 - 0.2 * np.arange(BATCH))[:, None, None, None]
    batch["mask"] = {k: (rng.rand(*m.shape) < keep).astype(np.float32)
                     for k, m in batch["mask"].items()}
    return batch


@pytest.fixture(scope="module")
def results():
    """(batch, JAX variables, JAX results, one-process port records, per-rank
    records). The two ranks run while JAX compiles."""
    batch = _batch()
    model = JaxPipeline(iteration=ITERATION, test=False)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(SEED), batch["imgs"], batch["proj_matrices"],
        batch["depth_min"], batch["depth_max"], train=False))
    job = {"state": flax_state_dict(variables), "sample": chip_smoke.tensor_tree(batch),
           "batch": BATCH, "iteration": ITERATION, "dtype": "float32", "lr": LR,
           "runs": [{"regress": r, "steps": 1} for r in STAGES.values()], "val": True}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(chip_smoke.run_ranks, job, WORLD, "gloo", "cpu", 600, env)
        tx = jax_make_optimizer()
        steps = [make_train_step(model, tx, regress=r, num_iters=ITERATION)
                 for r in STAGES.values()]
        val = make_val_step(model, regress=True, num_iters=ITERATION)

        @jax.jit
        def everything(state, b):               # one compile for all three
            return [s(state, b, jnp.float32(LR)) for s in steps], val(
                state.params, state.batch_stats, b)

        stepped, val_scalars = everything(create_train_state(variables, tx), batch)
        want = {"val": {k: float(v) for k, v in val_scalars.items()}, "runs": [
            {"loss": float(scalars["loss"]), "params": _flat(jax.tree.map(np.asarray, st.params)),
             "batch_stats": _flat(jax.tree.map(np.asarray, st.batch_stats))}
            for st, scalars in stepped]}
        threads = torch.get_num_threads()
        torch.set_num_threads(2)        # the suite runs six workers
        try:
            single = chip_smoke.run_steps(job, device="cpu")
        finally:
            torch.set_num_threads(threads)
        return batch, variables, want, single, ranks.result()


def _port(record):
    """One step's record → (params, batch_stats) as flat flax trees."""
    tree = flax_tree(record["state"])
    return _flat(tree["params"]), _flat(tree["batch_stats"])


@pytest.mark.parametrize("stage", list(STAGES))
def test_two_ranks_match_one_process(results, stage):
    _, _, _, single, ranks = results
    i = list(STAGES).index(stage)
    want = single["runs"][i][0]
    assert want["metric_all_reduces"] == 0
    for rank in ranks:
        got = rank["runs"][i][0]
        assert got["metric_all_reduces"] == 1       # the metrics' table, once per step
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        grads = {k: g.numpy() for k, g in got["grads"].items()}
        assert _rel_l2(grads, {k: g.numpy().astype(np.float64)
                               for k, g in want["grads"].items()}) <= 1e-4
        (p, s), (wp, ws) = _port(got), _port(want)
        _assert_same_adam_step(p, wp)
        for key, w in ws.items():
            np.testing.assert_allclose(s[key], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=key)


@pytest.mark.parametrize("stage", list(STAGES))
def test_two_ranks_match_the_jax_step(results, stage):
    _, _, want, _, ranks = results
    want = want["runs"][list(STAGES).index(stage)]
    for rank in ranks:
        got = rank["runs"][list(STAGES).index(stage)][0]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        params, stats = _port(got)
        _assert_same_adam_step(params, want["params"])
        for key, w in want["batch_stats"].items():
            np.testing.assert_allclose(stats[key], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=key)


def test_ranks_end_the_step_bit_equal(results):
    _, _, _, _, ranks = results
    for i in range(len(STAGES)):
        a, b = (r["runs"][i][0]["state"] for r in ranks)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_val_step_over_two_ranks(results):
    """The val step's loss and metrics are the global batch's on every
    rank: as one process's and as the JAX val step's, from one all-reduce
    of the metrics' table."""
    _, _, want, single, ranks = results
    assert set(single["val"]) == set(want["val"])
    assert single["val_metric_all_reduces"] == 0
    for rank in ranks:
        assert rank["val_metric_all_reduces"] == 1
        for key, w in want["val"].items():
            assert rank["val"][key] == pytest.approx(w, rel=1e-5, abs=1e-6), key
            assert rank["val"][key] == pytest.approx(single["val"][key], rel=1e-5,
                                                     abs=1e-6), key


def test_each_rank_alone_would_see_other_statistics(results):
    """On these samples a rank's own BN moments and masked means are not
    the global ones by far more than the tolerances above, so a step that
    skipped the reductions fails the tests of this file."""
    batch, variables, _, single, _ = results
    state = flax_state_dict(variables)
    half = chip_smoke.slice_batch(chip_smoke.tensor_tree(batch), 0, BATCH // WORLD)
    model = load_state(Pipeline(iteration=ITERATION, test=False), state, "init").train()
    with torch.no_grad():
        model(half["imgs"], half["proj_matrices"], half["depth_min"], half["depth_max"])
    _, local = _port({"state": model.state_dict()})
    _, global_ = _port(single["runs"][0][0])
    worst = max(np.abs(local[k] - w).max() / np.abs(w).max() for k, w in global_.items())
    assert worst > 100 * 1e-5

    depth = torch.tensor(batch["depth"]["level_2"])
    mask = torch.tensor(batch["mask"]["level_2"])
    whole = float(_masked_mean(depth, mask))
    for r in range(WORLD):
        part = slice(r * BATCH // WORLD, (r + 1) * BATCH // WORLD)
        assert abs(float(_masked_mean(depth[part], mask[part])) - whole) > 100 * 1e-5 * whole
    counts = mask.sum(dim=(1, 2, 3))
    assert len(set(counts.tolist())) == BATCH




# ------------------------------------------------------------ contracts
def test_distributed_flag_contract(monkeypatch):
    """tests/test_train.py's contract with torchrun's variables: off never
    joins; auto skips with no launcher and with single-process VALUES
    (torchrun's WORLD_SIZE=1, SLURM_NTASKS=1), joins when one says more
    than one process; on always joins. NCCL for a CUDA device, gloo for
    the CPU, unless named."""
    from itermvs_tpu_torch.parallel import mesh as pmesh

    calls = []
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda backend, **k: calls.append((backend, k)))
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda: 2)
    for var in pmesh._PROCESS_COUNT_ENV_VARS:
        monkeypatch.delenv(var, raising=False)

    with pytest.raises(ValueError, match="auto/on/off"):
        pmesh.initialize_distributed("yes")
    assert pmesh.initialize_distributed("off") is False
    assert pmesh.initialize_distributed("auto") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert pmesh.initialize_distributed("auto") is False
    assert not calls

    monkeypatch.setenv("WORLD_SIZE", "2")
    assert pmesh.initialize_distributed("auto") is True
    assert calls == [("nccl", {"init_method": "env://"})]
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    assert pmesh.initialize_distributed("auto", device="cpu") is True
    assert calls[-1][0] == "gloo"
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert pmesh.initialize_distributed("on", backend="gloo", device="cuda") is True
    assert calls[-1][0] == "gloo" and len(calls) == 3
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pmesh.local_device("cuda") == torch.device("cuda", 3)
    assert pmesh.local_device("cpu") == torch.device("cpu")


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), float(i), np.float32)}


@pytest.mark.parametrize("size,batch,seed,epoch,count", [
    (12, 6, 11, 4, 3), (13, 4, 0, 1, 2), (10, 4, 3, 0, 4), (9, 2, 5, 2, 1), (7, 4, 1, 3, 2)])
def test_loader_slices_match_the_jax_loader(size, batch, seed, epoch, count):
    """Each process's index batches and `len`, shuffled or not, with and
    without drop_last, as `itermvs_tpu.data.loader.DataLoader` gives them
    (tests/test_multihost.py's partition, process by process); iterating
    yields those samples."""
    from itermvs_tpu.data.loader import DataLoader as JaxLoader
    from itermvs_tpu_torch.data.loader import BatchOrder, DataLoader

    for shuffle in (True, False):
        for drop_last in (True, False):
            for p in range(count):
                jl = JaxLoader(_Indexed(size), batch_size=batch, shuffle=shuffle,
                               num_workers=1, drop_last=drop_last, seed=seed,
                               process_index=p, process_count=count)
                jl.set_epoch(epoch)
                want = [[int(i) for i in b] for b in jl._batch_indices()]
                order = BatchOrder(size, batch, shuffle, drop_last, seed, p, count)
                order.epoch = epoch
                assert order.batches() == want, (shuffle, drop_last, p)
                loader = DataLoader(_Indexed(size), batch, shuffle, drop_last, seed,
                                    process_index=p, process_count=count)
                assert len(loader) == len(jl)
                loader.set_epoch(epoch)
                got = [b["x"][:, 0].astype(int).tolist() for b in loader]
                assert got == want


def test_loader_refuses_a_batch_the_processes_do_not_divide():
    from itermvs_tpu_torch.data.loader import DataLoader

    with pytest.raises(ValueError, match="must divide evenly over 3 processes"):
        DataLoader(_Indexed(8), batch_size=4, process_index=0, process_count=3)


def test_pad_batch_matches_jax_and_keeps_the_metrics(results):
    """`pad_batch` as the JAX train.py's, and a val batch of 2 padded to
    4 gives the unpadded batch's loss and metrics (rel 1e-6)."""
    import importlib

    from itermvs_tpu_torch.engine.train_loop import to_device_batch, val_step
    from itermvs_tpu_torch.train import pad_batch

    jax_train = importlib.import_module("train")
    batch, variables, _, _, _ = results
    short = chip_smoke.slice_batch(batch, 1, 2)
    padded, n = pad_batch(short, BATCH)
    want, n_want = jax_train.pad_batch(short, BATCH)
    assert n == n_want == 2
    got_flat, want_flat = _flat(padded), _flat(want)
    assert set(got_flat) == set(want_flat)
    for key, w in want_flat.items():
        assert np.array_equal(got_flat[key], w), key
    assert pad_batch(batch, BATCH)[0] is batch

    model = load_state(Pipeline(iteration=ITERATION, test=False),
                       flax_state_dict(variables), "init")
    ref = val_step(model, to_device_batch(short, "cpu"), True, ITERATION)
    pad = val_step(model, to_device_batch(padded, "cpu"), True, ITERATION)
    for key in ref:
        assert float(pad[key]) == pytest.approx(float(ref[key]), rel=1e-6, abs=1e-7), key
