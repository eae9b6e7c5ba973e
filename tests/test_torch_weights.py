"""The port's npz → torch state_dict loader, and its reader of the
reference's torch checkpoints.

The round trip through the JAX package's torch importer must give back
the vendored npz bit-exactly: that shows the port's module tree carries
the reference's state_dict names and layouts (tolerance: exact). A
reference-format `.ckpt` (the `nn.DataParallel` prefix, the dead
`inner3`, `num_batches_tracked`) written here from the npz must load
into the port as the same tensors as the JAX importer's, carried over
by `flax_state_dict` (exact).
"""
import numpy as np
import pytest
import torch

from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.engine.torch_import import import_torch_checkpoint
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import (
    flax_state_dict, key_map, load_npz_weights, load_weights, npz_state_dict, pretrained_path,
    torch_state_dict)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", ["dtu", "blendedmvs"])
def test_strict_load_sets_every_parameter(name):
    model = Pipeline()
    for t in model.state_dict().values():
        if t.is_floating_point():
            t.fill_(float("nan"))
    load_npz_weights(model, pretrained_path(name))
    with np.load(pretrained_path(name)) as data:
        assert len(data.files) == len(key_map()) == 132
    for key, t in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.isfinite(t).all(), key


@pytest.mark.parametrize("name", ["dtu", "blendedmvs"])
def test_roundtrip_through_jax_importer_is_bit_exact(name, tmp_path):
    model = load_npz_weights(Pipeline(), pretrained_path(name))
    ckpt = tmp_path / "model.ckpt"
    torch.save({"epoch": 15, "model": {f"module.{k}": v for k, v in
                                       model.state_dict().items()}}, ckpt)
    got = _flatten(import_torch_checkpoint(str(ckpt)))
    want = _flatten(load_npz_variables(pretrained_path(name)))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, key
        assert np.array_equal(g, w), key


def test_state_dict_shapes_and_dtypes_match_the_modules():
    sd = npz_state_dict(pretrained_path("dtu"))
    ref = Pipeline().state_dict()
    for key, t in sd.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), key
        assert t.shape == ref[key].shape, key
    assert sd["feature_net.layer1.0.conv1.conv.weight"].shape == (16, 8, 3, 3)
    assert sd["iter_mvs.evaluation.corr_conv1.0.conv3.weight"].shape == (32, 16, 3, 3)
    assert sd["iter_mvs.update.depth_head.4.weight"].shape == (256, 64, 1, 1)


def test_load_rejects_a_foreign_npz(tmp_path):
    with np.load(pretrained_path("dtu")) as data:
        arrays = {k: data[k] for k in data.files}
    arrays.pop("params/iter_mvs/update/gru/convq/conv/bias")
    arrays["params/extra"] = np.zeros(3, np.float32)
    bad = tmp_path / "bad.npz"
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="unused .*params/extra.*missing .*convq"):
        npz_state_dict(str(bad))


def _reference_ckpt(path, name="dtu", wrap=True):
    """The npz as the reference's training wrote it: DataParallel keys,
    the unused third lateral, BN step counters, and (`wrap`) the
    `{epoch, model, optimizer}` dict around them."""
    sd = {f"module.{k}": v for k, v in npz_state_dict(pretrained_path(name)).items()}
    sd["module.feature_net.inner3.weight"] = torch.ones(32, 64, 1, 1)
    sd["module.feature_net.inner3.bias"] = torch.zeros(32)
    sd["module.feature_net.conv1.bn.num_batches_tracked"] = torch.tensor(1000)
    optimizer = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.ones(3)}},
                 "param_groups": [{"lr": 1e-3, "params": [0]}]}
    torch.save({"epoch": 15, "model": sd, "optimizer": optimizer} if wrap else sd, path)
    return str(path)


@pytest.mark.parametrize("wrap", [True, False], ids=["ckpt_dict", "bare_state_dict"])
def test_reference_checkpoint_loads_as_the_jax_importer_reads_it(tmp_path, wrap):
    path = _reference_ckpt(tmp_path / "model_000015.ckpt", wrap=wrap)
    want = flax_state_dict(import_torch_checkpoint(path))
    model = load_weights(Pipeline(), path)
    got = model.state_dict()
    assert set(want) == {k for k in got if not k.endswith("num_batches_tracked")}
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    assert not any("inner3" in k for k in torch_state_dict(path))


def test_reference_checkpoint_load_stays_strict(tmp_path):
    path = tmp_path / "bad.ckpt"
    sd = torch_state_dict(_reference_ckpt(tmp_path / "good.ckpt"))
    sd.pop("iter_mvs.update.gru.convq.bias")
    torch.save({"epoch": 0, "model": sd}, path)
    with pytest.raises(ValueError, match="not set .*convq.bias"):
        load_weights(Pipeline(), str(path))


def test_checkpoint_with_other_objects_is_read_in_full(tmp_path, capsys):
    """A pickle that `weights_only=True` refuses (here an argparse
    Namespace beside the weights) is read in full, with a note."""
    import argparse

    path = tmp_path / "with_args.ckpt"
    raw = torch.load(_reference_ckpt(tmp_path / "plain.ckpt"), weights_only=True)
    torch.save(dict(raw, args=argparse.Namespace(lr=1e-3)), path)
    want = torch_state_dict(str(tmp_path / "plain.ckpt"))
    got = torch_state_dict(str(path))
    assert "not a tensors-only pickle" in capsys.readouterr().out
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
