"""Vendored flax checkpoint (.npz) → torch state_dict for `Pipeline`.

The npz holds 132 `params/…` and `batch_stats/…` arrays named by the
flax module tree (`checkpoints/{dtu,blendedmvs}/model_000015.npz`). The
port's modules carry the reference's torch state_dict names, so this is
the inverse of the JAX package's torch importer:
  * Conv kernels HWIO → OIHW;
  * ConvTranspose kernels: undo the spatial flip and the transpose of the
    correlation form → IOHW;
  * BN scale/bias/mean/var → weight/bias/running_mean/running_var.
Loading is strict: every npz array is used exactly once, and every
parameter and buffer of the model is set except BN's
`num_batches_tracked`, which the npz does not carry.
"""
from __future__ import annotations

import os

import numpy as np
import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)


def pretrained_path(name: str = "dtu") -> str:
    """Path of the vendored weights `checkpoints/<name>/model_000015.npz`."""
    return os.path.join(REPO_DIR, "checkpoints", name, "model_000015.npz")


def _conv(w):
    return w.transpose(3, 2, 0, 1)                      # HWIO → OIHW


def _deconv(w):
    return w[::-1, ::-1].transpose(2, 3, 0, 1)          # flipped HWIO → IOHW


def _vec(w):
    return w


def key_map() -> list[tuple[str, str, object]]:
    """[(npz key, torch key, transform)] for the whole Pipeline."""
    out = []

    def conv_bn(dst, src):
        out.extend([
            (f"params/{dst}/conv/conv/kernel", f"{src}.conv.weight", _conv),
            (f"params/{dst}/bn/bn/scale", f"{src}.bn.weight", _vec),
            (f"params/{dst}/bn/bn/bias", f"{src}.bn.bias", _vec),
            (f"batch_stats/{dst}/bn/bn/mean", f"{src}.bn.running_mean", _vec),
            (f"batch_stats/{dst}/bn/bn/var", f"{src}.bn.running_var", _vec),
        ])

    def plain_conv(dst, src, bias=True):
        out.append((f"params/{dst}/conv/kernel", f"{src}.weight", _conv))
        if bias:
            out.append((f"params/{dst}/conv/bias", f"{src}.bias", _vec))

    fn = "feature_net"
    conv_bn(f"{fn}/conv1", f"{fn}.conv1")
    for layer in (1, 2, 3):
        for block in (0, 1):
            dst = f"{fn}/layer{layer}_{block}"
            src = f"{fn}.layer{layer}.{block}"
            conv_bn(f"{dst}/conv1", f"{src}.conv1")
            conv_bn(f"{dst}/conv2", f"{src}.conv2")
            if block == 0:
                conv_bn(f"{dst}/downsample", f"{src}.downsample")
    for k in (1, 2, 3):
        plain_conv(f"{fn}/output{k}", f"{fn}.output{k}")
    for k in (1, 2):
        plain_conv(f"{fn}/inner{k}", f"{fn}.inner{k}")

    mv = "iter_mvs"
    plain_conv(f"{mv}/upsample_conv0", f"{mv}.upsample.0", bias=False)
    plain_conv(f"{mv}/upsample_conv1", f"{mv}.upsample.2", bias=False)

    ev, evs = f"{mv}/evaluation", f"{mv}.evaluation"
    out.append((f"params/{ev}/pixel_view_weight/conv0/conv/conv/kernel",
                f"{evs}.pixel_view_weight.conv.0.conv.weight", _conv))
    plain_conv(f"{ev}/pixel_view_weight/conv1", f"{evs}.pixel_view_weight.conv.1")
    for i in range(3):
        dst, src = f"{ev}/corr_net{i + 1}", f"{evs}.corr_conv1.{i}"
        for c in ("conv0", "conv1", "conv2"):
            out.append((f"params/{dst}/{c}/conv/conv/kernel",
                        f"{src}.{c}.conv.weight", _conv))
        for c in ("conv3", "conv4"):
            out.append((f"params/{dst}/{c}/kernel", f"{src}.{c}.weight", _deconv))
        plain_conv(f"{dst}/conv5", f"{src}.conv5")

    up, ups = f"{mv}/update", f"{mv}.update"
    for gate in ("convz", "convr", "convq"):
        plain_conv(f"{up}/gru/{gate}", f"{ups}.gru.{gate}")
    plain_conv(f"{up}/depth_conv0", f"{ups}.depth_head.0", bias=False)
    plain_conv(f"{up}/depth_conv1", f"{ups}.depth_head.2", bias=False)
    plain_conv(f"{up}/depth_conv2", f"{ups}.depth_head.4")
    plain_conv(f"{up}/conf_conv0", f"{ups}.confidence_head.0", bias=False)
    plain_conv(f"{up}/conf_conv1", f"{ups}.confidence_head.2")
    plain_conv(f"{up}/hidden_conv0", f"{ups}.hidden_init_head.0", bias=False)
    plain_conv(f"{up}/hidden_conv1", f"{ups}.hidden_init_head.2")
    return out


def npz_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a vendored npz into a torch state_dict (CPU tensors). Raises
    if the npz holds an array the port does not use, or lacks one."""
    mapping = key_map()
    with np.load(path) as data:
        files = set(data.files)
        wanted = {k for k, _, _ in mapping}
        if files != wanted or len(wanted) != len(mapping):
            raise ValueError(
                f"{path}: npz keys do not match the port's modules; unused "
                f"{sorted(files - wanted)}, missing {sorted(wanted - files)}")
        return {tkey: torch.from_numpy(np.ascontiguousarray(fn(data[nkey])))
                for nkey, tkey, fn in mapping}


def load_npz_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Strictly load a vendored npz into `model` (a `Pipeline`)."""
    sd = npz_state_dict(path)
    expected = {k for k in model.state_dict()
                if not k.endswith("num_batches_tracked")}
    if set(sd) != expected:
        raise ValueError(
            f"{path}: state_dict mismatch; not set {sorted(expected - set(sd))}, "
            f"unknown {sorted(set(sd) - expected)}")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise ValueError(f"load_state_dict: missing {missing}, unexpected {unexpected}")
    return model
