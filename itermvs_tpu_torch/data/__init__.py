"""Dataset registry: the names the JAX package's CLIs accept."""
from __future__ import annotations

import importlib

_ALIASES = {
    "dtu_yao": "itermvs_tpu_torch.data.dtu",
    "blendedmvs": "itermvs_tpu_torch.data.blendedmvs",
    "dtu_yao_eval": "itermvs_tpu_torch.data.dtu_eval",
    "custom": "itermvs_tpu_torch.data.custom",
    "tanks": "itermvs_tpu_torch.data.tanks",
    "eth3d": "itermvs_tpu_torch.data.eth3d",
}


def find_dataset_def(dataset_name: str):
    if dataset_name not in _ALIASES:
        raise ValueError(f"dataset {dataset_name!r} is not ported; "
                         f"choose from {sorted(_ALIASES)}")
    return importlib.import_module(_ALIASES[dataset_name]).MVSDataset
