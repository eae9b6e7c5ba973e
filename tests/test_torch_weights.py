"""The port's npz → torch state_dict loader.

The round trip through the JAX package's torch importer must give back
the vendored npz bit-exactly: that shows the port's module tree carries
the reference's state_dict names and layouts (tolerance: exact).
"""
import numpy as np
import pytest
import torch

from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.engine.torch_import import import_torch_checkpoint
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import (
    key_map, load_npz_weights, npz_state_dict, pretrained_path)


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
