"""The port's tanks and eth3d loaders and its --scan_shard helpers against
the JAX package's (exact: same samples, same shards)."""
import importlib
import os

import numpy as np
import pytest

from itermvs_tpu.data import find_dataset_def as jax_dataset
from itermvs_tpu.data.eth3d import TEST_SCANS, TRAIN_SCANS
from itermvs_tpu.data.tanks import ADVANCED_SCANS, INTERMEDIATE_SCANS
from itermvs_tpu_torch import eval as port_eval
from itermvs_tpu_torch.data import find_dataset_def as port_dataset
from tests.test_eval_loaders import _write_eval_scan


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for key in ("imgs", "proj_matrices"):
        assert sorted(got[key]) == sorted(want[key])
        for level in got[key]:
            assert np.array_equal(got[key][level], want[key][level]), (key, level)
    for key in ("depth_min", "depth_max", "filename", "scan"):
        assert got[key] == want[key], key
    assert np.array_equal(got["view_ids"], want["view_ids"])


@pytest.mark.parametrize("split,scans", [("intermediate", INTERMEDIATE_SCANS),
                                         ("advanced", ADVANCED_SCANS)])
def test_tanks_loader_matches_jax(tmp_path, split, scans):
    rng = np.random.RandomState(0)
    for scan in scans:
        _write_eval_scan(os.path.join(str(tmp_path), split, scan), num_views=3,
                         width=128, height=96, rng=rng)
    got = port_dataset("tanks")(str(tmp_path), n_views=3, img_wh=(64, 48), split=split)
    want = jax_dataset("tanks")(str(tmp_path), n_views=3, img_wh=(64, 48), split=split)
    assert got.metas == want.metas and len(got) == len(scans) * 3
    for idx in (0, len(got) - 1):
        _assert_same_sample(got[idx], want[idx])


@pytest.mark.parametrize("split,scans", [("test", TEST_SCANS), ("train", TRAIN_SCANS)])
def test_eth3d_loader_matches_jax_with_negative_depth_min(tmp_path, split, scans):
    rng = np.random.RandomState(1)
    for scan in scans:
        _write_eval_scan(os.path.join(str(tmp_path), scan), num_views=3, width=96,
                         height=64, rng=rng, cam_depth_min=-0.5)
    got = port_dataset("eth3d")(str(tmp_path), split=split, n_views=3, img_wh=(96, 64))
    want = jax_dataset("eth3d")(str(tmp_path), split=split, n_views=3, img_wh=(96, 64))
    assert got.metas == want.metas and len(got) == len(scans) * 3
    sample = got[0]
    assert sample["depth_min"] == np.float32(1.0)
    _assert_same_sample(sample, want[0])


@pytest.fixture(scope="module")
def jax_eval():
    return importlib.import_module("eval")


@pytest.mark.parametrize("spec", [None, "0/1", "2/4", "3/4"])
def test_scan_shard_helpers_match_jax(jax_eval, spec):
    assert port_eval.parse_scan_shard(spec) == jax_eval.parse_scan_shard(spec)
    shard = port_eval.parse_scan_shard(spec)
    scans = [f"scan{i}" for i in range(7)]
    assert port_eval.shard_scans(scans, shard) == jax_eval.shard_scans(scans, shard)
    table = dict(zip(scans, range(7)))
    assert (port_eval.shard_scans(table.items(), shard)
            == jax_eval.shard_scans(table.items(), shard))

    class Metas:
        def __init__(self, metas):
            self.metas = list(metas)

    keyed = [(s, ref, [1, 2]) for s in ("b", "a", "c", "d", "e") for ref in range(3)]
    single = [(ref, [1, 2]) for ref in range(4)]
    for metas in (keyed, single, []):
        assert (port_eval.apply_scan_shard(Metas(metas), shard).metas
                == jax_eval.apply_scan_shard(Metas(metas), shard).metas)


@pytest.mark.parametrize("bad", ["4/4", "-1/2", "x/2", "2", "1/0"])
def test_scan_shard_rejects_bad_specs(bad):
    with pytest.raises(SystemExit):
        port_eval.parse_scan_shard(bad)


def test_threshold_tables_match_jax(jax_eval):
    for name in ("TANKS_INTERMEDIATE_THRES", "TANKS_ADVANCED_THRES",
                 "ETH3D_TEST_THRES", "ETH3D_TRAIN_THRES"):
        assert list(getattr(port_eval, name).items()) == list(getattr(jax_eval, name).items())
    assert list(port_eval.TANKS_INTERMEDIATE_THRES) == INTERMEDIATE_SCANS
    assert list(port_eval.ETH3D_TRAIN_THRES) == TRAIN_SCANS
