"""The port's training data path and checkpoints against the JAX package.

* the loader's index batches equal JAX `DataLoader`'s for (seed, epoch,
  skip), shuffled or not, with and without drop_last (exact);
* `dtu_yao` train and val samples of tests/synthetic_scene's DTU fixture
  equal JAX's element for element, colour jitter and the robust-train
  view choice and scale included (exact: the same numpy, PIL and cv2
  calls on the same per-item generator);
* checkpoints: names, ordering, a save/restore round trip (a mid-epoch
  step save resumes on the same next batch), and the JAX package's torch
  importer reads a port checkpoint into the port's own weights (exact).
"""
import os

import numpy as np
import pytest
import torch

from itermvs_tpu.data import find_dataset_def as jax_dataset
from itermvs_tpu.data.loader import DataLoader as JaxDataLoader
from itermvs_tpu.engine.torch_import import import_torch_checkpoint
from itermvs_tpu_torch.data import find_dataset_def
from itermvs_tpu_torch.data.loader import DataLoader
from itermvs_tpu_torch.engine.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from itermvs_tpu_torch.engine.train_loop import init_weights, make_optimizer, train_step
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import flax_tree
from tests.synthetic_scene import build_dtu_training_dir


class _IdxDataset:
    """Samples that are their own indices, with the epoch they were drawn in."""

    def __init__(self, n):
        self.n = n
        self.epoch = None

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32), "epoch": int(self.epoch)}


def _indices(loader):
    return [b["x"][:, 0].astype(int).tolist() for b in loader]


@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (13, 3, True, True), (13, 3, True, False), (7, 4, False, False), (8, 4, True, True)])
@pytest.mark.parametrize("seed,epoch,skip", [(7, 5, 0), (1, 0, 1), (3, 2, 2)])
def test_loader_batches_match_jax(n, batch, shuffle, drop_last, seed, epoch, skip):
    want_loader = JaxDataLoader(_IdxDataset(n), batch, shuffle=shuffle, num_workers=1,
                                drop_last=drop_last, seed=seed)
    got_loader = DataLoader(_IdxDataset(n), batch, shuffle=shuffle, drop_last=drop_last,
                            seed=seed)
    assert len(got_loader) == len(want_loader)
    for loader in (want_loader, got_loader):
        loader.set_epoch(epoch, skip)
    assert _indices(got_loader) == _indices(want_loader)
    # The next iteration is the next epoch, with no skip, in both.
    got, want = list(got_loader), list(want_loader)
    assert [b["x"][:, 0].tolist() for b in got] == [b["x"][:, 0].tolist() for b in want]
    assert all((b["epoch"] == epoch + 1).all() for b in got)


@pytest.fixture(scope="module")
def dtu_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    return root, build_dtu_training_dir(root)


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("mode,robust,epoch,idx", [
    ("train", True, 0, 0), ("train", True, 3, 5), ("val", False, 0, 2)])
def test_dtu_yao_samples_match_jax(dtu_dir, mode, robust, epoch, idx):
    root, listfile = dtu_dir
    got_ds = find_dataset_def("dtu_yao")(root, listfile, mode, 5, robust_train=robust, seed=1)
    want_ds = jax_dataset("dtu_yao")(root, listfile, mode, 5, robust_train=robust, seed=1)
    assert got_ds.metas == want_ds.metas and len(got_ds) == 7
    got_ds.set_epoch(epoch)
    want_ds.set_epoch(epoch)
    got, want = got_ds[idx], want_ds[idx]
    _assert_same(got, want)
    assert got["imgs"]["level_0"].shape == (5, 512, 640, 3)
    assert got["depth"]["level_2"].shape == (128, 160, 1)


def test_blendedmvs_is_registered_and_copies_the_jax_loader():
    cls = find_dataset_def("blendedmvs")
    assert cls.__module__ == "itermvs_tpu_torch.data.blendedmvs"
    with pytest.raises(ValueError, match="not ported"):
        find_dataset_def("no_such_set")


@pytest.fixture(scope="module")
def trained():
    """A port model and optimizer after one step on a small batch."""
    from tests.test_train import _make_batch

    batch = _make_batch(np.random.RandomState(0), batch=1, views=3)
    batch = {k: ({l: torch.from_numpy(np.array(v)) for l, v in x.items()}
                 if isinstance(x, dict) else torch.from_numpy(np.array(x)))
             for k, x in batch.items()}
    model = init_weights(Pipeline(iteration=1, test=False), 0)
    optimizer = make_optimizer(model)
    train_step(model, optimizer, batch, 1e-3, True, 1)
    return model, optimizer


def test_checkpoint_round_trip_and_order(trained, tmp_path):
    model, optimizer = trained
    logdir = str(tmp_path)
    assert latest_checkpoint(logdir) is None
    p0 = save_checkpoint(logdir, 0, model, optimizer)
    assert os.path.basename(p0) == "model_000000.ckpt"
    p_mid = save_checkpoint(logdir, 1, model, optimizer, step=40)
    assert os.path.basename(p_mid) == "model_000001_step00000040.ckpt"
    assert latest_checkpoint(logdir) == p_mid
    restored = Pipeline(iteration=1, test=False)
    restored_opt = make_optimizer(restored)
    assert restore_checkpoint(p_mid, restored, restored_opt) == (1, 40)
    for (k, a), b in zip(model.state_dict().items(), restored.state_dict().values()):
        assert torch.equal(a, b), k
    assert restored_opt.state_dict()["state"].keys() == optimizer.state_dict()["state"].keys()
    for i, st in optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                restored_opt.state_dict()["state"][i][k])), (i, k)
    p_end = save_checkpoint(logdir, 1, model, optimizer)
    assert latest_checkpoint(logdir) == p_end            # supersedes the step save
    assert restore_checkpoint(p_end, restored, restored_opt) == (1, None)
    assert sorted(os.listdir(logdir)) == ["model_000000.ckpt", "model_000001.ckpt",
                                          "model_000001_step00000040.ckpt"]


def test_step_save_resumes_on_the_same_next_batch():
    """A run that stops after 2 batches of epoch 3 and resumes with
    set_epoch(3, skip=2) sees the batches a run that never stopped saw."""
    full = DataLoader(_IdxDataset(13), 3, shuffle=True, drop_last=True, seed=7)
    full.set_epoch(3)
    whole = _indices(full)
    resumed = DataLoader(_IdxDataset(13), 3, shuffle=True, drop_last=True, seed=7)
    resumed.set_epoch(3, skip_batches=2)
    assert _indices(resumed) == whole[2:]


def test_jax_importer_reads_a_port_checkpoint(trained, tmp_path):
    model, optimizer = trained
    path = save_checkpoint(str(tmp_path), 0, model, optimizer)
    got = import_torch_checkpoint(path)
    want = flax_tree(model.state_dict())
    for collection in ("params", "batch_stats"):
        flat_got, flat_want = {}, {}
        for tree, flat in ((got[collection], flat_got), (want[collection], flat_want)):
            stack = [("", tree)]
            while stack:
                prefix, node = stack.pop()
                for k, v in node.items():
                    key = f"{prefix}/{k}"
                    if isinstance(v, dict):
                        stack.append((key, v))
                    else:
                        flat[key] = np.asarray(v)
        assert sorted(flat_got) == sorted(flat_want)
        for key, w in flat_want.items():
            assert np.array_equal(flat_got[key], w), key
