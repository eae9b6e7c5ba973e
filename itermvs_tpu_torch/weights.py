"""Weights between the JAX package's flax variables and the port's torch
state_dict, in both directions, and the port's weight files.

The flax variables are a tree `{"params": …, "batch_stats": …}` named by
the flax module tree; the vendored npz (`checkpoints/{dtu,blendedmvs}/
model_000015.npz`) holds the same 132 arrays flat, `/`-joined. The
port's modules carry the reference's torch state_dict names, so the way
in is the inverse of the JAX package's torch importer:
  * Conv kernels HWIO → OIHW;
  * ConvTranspose kernels: undo the spatial flip and the transpose of the
    correlation form → IOHW;
  * BN scale/bias/mean/var → weight/bias/running_mean/running_var.
Each transform is a permutation of elements, so `flax_tree` maps a
state_dict or its gradients back the same way. Loading is strict: every
array is used exactly once, and every parameter and buffer of the model
is set except BN's `num_batches_tracked`, which flax does not carry.
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


_INVERSE = {_conv: lambda w: w.transpose(2, 3, 1, 0),                 # OIHW → HWIO
            _deconv: lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1],   # IOHW → flipped HWIO
            _vec: _vec}


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


def flat_state_dict(flat, source: str = "flax variables") -> dict[str, torch.Tensor]:
    """A flat `{"params/…": array}` mapping (the npz form) → torch
    state_dict (CPU tensors). Raises if it holds an array the port does
    not use, or lacks one."""
    mapping = key_map()
    keys = set(flat.keys())
    wanted = {k for k, _, _ in mapping}
    if keys != wanted or len(wanted) != len(mapping):
        raise ValueError(
            f"{source}: keys do not match the port's modules; unused "
            f"{sorted(keys - wanted)}, missing {sorted(wanted - keys)}")
    return {tkey: torch.from_numpy(np.array(fn(np.asarray(flat[nkey])), order="C"))
            for nkey, tkey, fn in mapping}


def flax_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Nested flax variables `{"params": …, "batch_stats": …}` of numpy
    arrays (e.g. a fresh JAX `model.init`) → torch state_dict."""
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = v

    walk("", variables)
    return flat_state_dict(flat)


def flax_tree(tensors: dict[str, torch.Tensor]) -> dict:
    """Inverse of `flax_state_dict`: a state_dict, or gradients keyed by
    parameter name, → nested flax tree of numpy arrays. Only the keys
    present are mapped (gradients give a `params` tree alone)."""
    tree: dict = {}
    for nkey, tkey, fn in key_map():
        if tkey not in tensors:
            continue
        node = tree
        parts = nkey.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        value = tensors[tkey].detach().cpu().numpy()
        node[parts[-1]] = np.ascontiguousarray(_INVERSE[fn](value))
    return tree


def npz_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a vendored npz into a torch state_dict (CPU tensors)."""
    with np.load(path) as data:
        return flat_state_dict({k: data[k] for k in data.files}, path)


def load_state(model: torch.nn.Module, sd: dict, source: str) -> torch.nn.Module:
    """Strictly load `sd` into `model` (a `Pipeline`): every parameter and
    buffer but `num_batches_tracked`, which `sd` may lack."""
    expected = {k for k in model.state_dict()
                if not k.endswith("num_batches_tracked")}
    given = {k for k in sd if not k.endswith("num_batches_tracked")}
    if given != expected:
        raise ValueError(
            f"{source}: state_dict mismatch; not set {sorted(expected - given)}, "
            f"unknown {sorted(given - expected)}")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise ValueError(f"load_state_dict: missing {missing}, unexpected {unexpected}")
    return model


def load_npz_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Strictly load a vendored npz into `model` (a `Pipeline`)."""
    return load_state(model, npz_state_dict(path), path)


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Strictly load weights into `model` from a vendored `.npz` or from a
    checkpoint of the port's trainer (a torch file `{"model": state_dict,
    ...}`, engine/checkpoint.py)."""
    if path.endswith(".npz"):
        return load_npz_weights(model, path)
    state = torch.load(path, map_location="cpu", weights_only=True)["model"]
    return load_state(model, state, path)
