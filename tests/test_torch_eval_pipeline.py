"""The port's eval core loop, `run_depth`, as a one-batch software
pipeline: batch i+1 is dispatched before batch i is finalized, and the
PFMs it writes are byte-equal to those of one `run_depth` call per batch
(128x96, 3 views, the vendored DTU weights, 2 GRU iterations, on the
CPU), with the feature cache on, off and evicting views of the batch in
flight, on the uint16 and the float32 wire, and at batch 2 with a ragged
last batch. Rows that `n_real` marks as padding are not written. A
failing batch still leaves the batch before it on disk, and a failing
write surfaces from `run_depth`.
"""
import os

import numpy as np
import pytest
import torch

from tests.synthetic_scene import build_scene_dir

from itermvs_tpu_torch.data import find_dataset_def
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

VIEWS, W, H = 3, 128, 96
QUIET = dict(log=lambda *_: None)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    build_scene_dir(root, num_views=VIEWS, width=W, height=H, write_gt_depth=False)
    return root


@pytest.fixture(scope="module")
def model():
    return load_npz_weights(Pipeline(iteration=2), pretrained_path("dtu"))


def batches(scene, batch_size):
    dataset = find_dataset_def("custom")(scene, VIEWS, (W, H))
    return list(torch.utils.data.DataLoader(dataset, batch_size=batch_size, shuffle=False))


def pfm_bytes(outdir):
    got = {}
    for kind in ("depth_est", "confidence"):
        for name in sorted(os.listdir(os.path.join(outdir, kind))):
            with open(os.path.join(outdir, kind, name), "rb") as f:
                got[(kind, name)] = f.read()
    return got


@pytest.mark.parametrize("batch_size,cache,cache_views,wire", [
    (1, True, 16, "uint16"),
    (1, False, 16, "uint16"),
    (1, True, 1, "uint16"),           # the LRU evicts views of the batch in flight
    (1, True, 16, "float32"),
    (1, False, 16, "float32"),
    (2, False, 16, "uint16"),         # batches of 2 and 1
    (2, False, 16, "float32"),
])
def test_pipelined_pfms_equal_one_batch_per_call(tmp_path, scene, model, batch_size, cache,
                                                 cache_views, wire):
    loaded = batches(scene, batch_size)
    assert [len(b["filename"]) for b in loaded] == ([1, 1, 1] if batch_size == 1 else [2, 1])
    opts = dict(feature_cache=cache, feature_cache_views=cache_views, result_wire=wire, **QUIET)
    host = []
    secs = run_depth(model, loaded, str(tmp_path / "all"), "cpu", host_secs=host, **opts)
    assert len(secs) == len(host) == len(loaded)
    assert all(s >= 0 for s in secs) and all(d >= 0 and f >= 0 for d, f in host)
    for b in loaded:
        run_depth(model, [b], str(tmp_path / "one"), "cpu", **opts)
    got, want = pfm_bytes(tmp_path / "all"), pfm_bytes(tmp_path / "one")
    assert len(want) == 2 * VIEWS and got == want


@pytest.mark.parametrize("wire", ["uint16", "float32"])
def test_padding_rows_are_not_written(tmp_path, scene, model, wire):
    """Batches [0, 1] with one real row, [0, 1] with none (padding alone)
    and [2] with one: maps 0 and 2 are written, as one call per batch
    writes them, and every batch counts in the returned seconds."""
    loaded = batches(scene, 2)
    opts = dict(feature_cache=False, result_wire=wire, **QUIET)
    host = []
    secs = run_depth(model, [loaded[0], loaded[0], loaded[1]], str(tmp_path / "padded"),
                     "cpu", host_secs=host, n_real=[1, 0, 1], **opts)
    assert len(secs) == len(host) == 3 and all(s >= 0 for s in secs)
    for b in loaded:
        run_depth(model, [b], str(tmp_path / "one"), "cpu", **opts)
    got, want = pfm_bytes(tmp_path / "padded"), pfm_bytes(tmp_path / "one")
    assert sorted(got) == [(kind, f"{v:08d}.pfm") for kind in ("confidence", "depth_est")
                           for v in (0, 2)]
    assert all(got[key] == want[key] for key in got)


def test_dispatch_of_the_next_batch_precedes_finalize(tmp_path, scene, model, monkeypatch):
    """The order of JAX eval.py's loop: d0, d1, f0, d2, f1, f2."""
    order = []
    match = model.match

    def recording_match(*args):
        order.append(f"d{sum(o.startswith('d') for o in order)}")
        return match(*args)

    monkeypatch.setattr(model, "match", recording_match)
    run_depth(model, batches(scene, 1), str(tmp_path), "cpu",
              log=lambda line: order.append(f"f{line.split()[1].split('/')[0]}"))
    assert order == ["d0", "d1", "f0", "d2", "f1", "f2"]


def test_a_failing_batch_leaves_the_previous_batch_written(tmp_path, scene, model,
                                                           monkeypatch):
    calls = []
    match = model.match

    def failing_match(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("batch 2 failed")
        return match(*args)

    monkeypatch.setattr(model, "match", failing_match)
    with pytest.raises(RuntimeError, match="batch 2 failed"):
        run_depth(model, batches(scene, 1), str(tmp_path), "cpu", **QUIET)
    assert len(calls) == 2
    for kind in ("depth_est", "confidence"):
        assert sorted(os.listdir(tmp_path / kind)) == ["00000000.pfm"]
    depth = np.fromfile(tmp_path / "depth_est" / "00000000.pfm", np.uint8)
    assert depth.size > W * H * 4


def test_a_failing_write_surfaces(tmp_path, scene, model):
    (tmp_path / "file").write_text("not a directory")
    with pytest.raises(OSError):
        run_depth(model, batches(scene, 1)[:1], str(tmp_path / "file"), "cpu", **QUIET)
