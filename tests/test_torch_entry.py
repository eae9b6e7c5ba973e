"""The port's entry points (itermvs_tpu_torch/entry.py) on the CPU, against
__graft_entry__.py.

`_example_inputs` must equal the JAX function's arrays bit for bit at
the forward's size and at the dry run's; the JAX module is imported for
its inputs only, and no JAX forward runs here. `entry(device="cpu")`
meets what tests/test_graft_entry.py asserts of the JAX forward. The dry
run runs two gloo ranks on the CPU (each a process of its own) and is
held against the one-process step over its whole batch, with
tests/test_torch_parallel.py's loss tolerance (rel 1e-5); that file
holds two ranks against the JAX step. A restore that drops the
optimizer's state must fail the resume check.
"""
import os
import time

import numpy as np
import pytest
import torch

import __graft_entry__
from itermvs_tpu_torch import entry as port_entry
from itermvs_tpu_torch.engine.checkpoint import restore_checkpoint
from itermvs_tpu_torch.engine.train_loop import (
    init_weights, make_optimizer, to_device_batch, train_step)
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.ops.counts import KERNEL_NAMES
from itermvs_tpu_torch.parallel import launch, mesh


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads per test, as each dry-run rank: the suite runs six
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(1, 5, 128, 160), (2, 3, 64, 96)])
def test_example_inputs_are_the_jax_arrays(shape):
    got = port_entry._example_inputs(*shape)
    want = __graft_entry__._example_inputs(*shape)
    for g, w in zip(got, want):
        g, w = (g, w) if isinstance(g, dict) else ({"": g}, {"": w})
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    imgs, projs, _, _ = got
    assert imgs["level_3"].shape == (shape[0], shape[1], shape[2] >> 3, shape[3] >> 3, 3)
    assert projs["level_0"].shape == (shape[0], shape[1], 4, 4)


def test_entry_on_the_cpu():
    """What tests/test_graft_entry.py asserts of the JAX forward."""
    fn, args = port_entry.entry(device="cpu")
    depth, conf = fn(*args)
    assert np.isfinite(depth.numpy()).all() and np.isfinite(conf.numpy()).all()
    assert depth.shape[1:3] == (128, 160)
    assert depth.shape == conf.shape == (1, 128, 160, 1)


def test_without_a_card_both_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)


def test_dryrun_on_two_cpu_ranks(monkeypatch, capsys):
    """Two gloo ranks: the resume within 1e-6, the ranks bit-equal (both
    checked inside), and step 1's loss that of one process taking the
    same step on the whole 2-row batch from the same init."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rec = port_entry.dryrun_multichip(2, device="cpu", timeout=300)
    assert "dryrun_multichip(2) ok: loss=" in capsys.readouterr().out
    assert rec["backend"] == "gloo" and rec["devices"] == ["cpu", "cpu"]
    assert rec["ranks_bit_equal"] and rec["restored_bit_equal"]
    assert rec["state_rel_after_step"] == 0         # the CPU adds in a fixed order
    assert abs(rec["live"] - rec["restored"]) <= 1e-6 * max(1.0, abs(rec["live"]))
    zero = dict.fromkeys(KERNEL_NAMES, 0)          # CPU: the plain versions
    assert rec["launches"] == [[zero] * 4] * 2

    model = init_weights(Pipeline(iteration=2, test=False), 0)
    batch = to_device_batch(port_entry.dryrun_batch(2), "cpu")
    want = train_step(model, make_optimizer(model), batch, 1e-3, regress=True,
                      num_iters=2)["loss"].item()
    assert rec["loss"] == pytest.approx(want, rel=1e-5)


@pytest.fixture
def one_rank_group(monkeypatch):
    """A world-1 gloo group in this process, joined as torchrun's rank 0."""
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(launch.free_port()),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    mesh.initialize_distributed("on", backend="gloo", device="cpu")
    yield
    torch.distributed.destroy_process_group()


def _restore_model_only(path, model, optimizer):
    """`restore_checkpoint` that leaves the optimizer fresh."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(raw["model"])
    return int(raw["epoch"]), raw["step"]


def _restore_step_count_zero(path, model, optimizer):
    """`restore_checkpoint` that loses Adam's step counts only."""
    out = restore_checkpoint(path, model, optimizer)
    for entry in optimizer.state.values():
        entry["step"].zero_()
    return out


@pytest.mark.parametrize("restore", [_restore_model_only, _restore_step_count_zero])
def test_resume_check_sees_a_restore_that_loses_optimizer_state(one_rank_group, monkeypatch,
                                                                tmp_path, restore):
    """The restored step's loss is taken before its Adam update, so it
    matches the live one's even when the optimizer's moments or step
    counts were lost; the state compared before that step does not."""
    monkeypatch.setattr(port_entry, "restore_checkpoint", restore)
    rec = port_entry._dryrun_steps(0, 1, torch.device("cpu"), str(tmp_path))
    assert abs(rec["live"] - rec["restored"]) <= 1e-6 * max(1.0, abs(rec["live"]))
    assert all(name.startswith("optimizer.state.") for name in rec["restore_mismatch"])
    with pytest.raises(RuntimeError, match="restored state differs from the live one's"):
        port_entry.check_resume(rec)


def _sleep(rank, world, port, seconds):
    time.sleep(float(seconds))


def test_launcher_stops_the_ranks_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed,
                       match=r"rank 1 of 2 failed .*past the 4 s deadline"):
        launch.run_ranks("tests.test_torch_entry", "_sleep", (120,), 2, timeout=4,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert time.monotonic() - t0 < 60
