"""`python -m itermvs_tpu_torch.train` end to end on the CPU, and the
port's eval reading the checkpoint it wrote.

The fixture is tests/synthetic_scene's 1-reference DTU layout (7 metas,
640×512), batch 4, 2 GRU iterations: epoch 0 of stage 1, then
`--regress --resume` to epoch 2, then `--mode val` from the latest
checkpoint. Each command has a time limit of its own (600 s).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from itermvs_tpu_torch import train as port_train
from itermvs_tpu_torch.io import read_pfm
from tests.synthetic_scene import build_dtu_training_dir, build_scene_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMAND_TIMEOUT = 600


def _run(args):
    # Two torch threads: the suite runs six workers on the CPU's cores.
    result = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                            cwd=REPO, timeout=COMMAND_TIMEOUT,
                            env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"))
    assert result.returncode == 0, result.stdout[-3000:] + result.stderr[-3000:]
    return result.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    listfile = build_dtu_training_dir(root)
    logdir = str(tmp_path_factory.mktemp("logs"))
    common = ["-m", "itermvs_tpu_torch.train", "--dataset", "dtu_yao", "--trainpath", root,
              "--trainlist", listfile, "--vallist", listfile, "--batch_size", "4",
              "--iteration", "2", "--summary_freq", "1", "--logdir", logdir,
              "--device", "cpu", "--loader_processes", "0"]
    stage1 = _run(common + ["--epochs", "1"])
    files1 = sorted(os.listdir(logdir))
    stage2 = _run(common + ["--epochs", "2", "--regress", "--resume"])
    val = _run(common + ["--mode", "val"])
    return logdir, (stage1, files1), stage2, val


def _losses(out):
    return [float(line.split("train loss = ")[1].split(",")[0])
            for line in out.splitlines() if "train loss = " in line]


def test_cli_trains_stage1_then_resumes_stage2(runs):
    logdir, (stage1, files1), stage2, _ = runs
    assert "model_000000.ckpt" in files1 and "model_000001.ckpt" not in files1
    assert "start at epoch 0" in stage1 and "start at epoch 1" in stage2
    assert "resuming" in stage2 and "model_000000.ckpt" in stage2
    for out in (stage1, stage2):
        losses = _losses(out)
        assert len(losses) == 1 and np.isfinite(losses).all()   # 7 metas // 4
        assert "avg_test_scalars:" in out
    assert {"model_000000.ckpt", "model_000001.ckpt"} <= set(os.listdir(logdir))
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(logdir))


def test_cli_val_mode_reads_the_latest_checkpoint(runs):
    logdir, _, _, val = runs
    assert f"resuming {os.path.join(logdir, 'model_000001.ckpt')}" in val
    scalars = val.split("avg_test_scalars:")[1]
    assert "'loss'" in scalars and "abs_error_final_full" in scalars
    assert "train loss" not in val


def test_port_eval_reads_a_trained_checkpoint(runs, tmp_path):
    logdir, _, _, _ = runs
    scene = str(tmp_path / "scene")
    os.makedirs(scene)
    build_scene_dir(scene, num_views=3, width=128, height=96, write_gt_depth=False)
    _run(["-m", "itermvs_tpu_torch.eval", "--dataset=custom", "--batch_size=1",
          "--n_views", "3", "--img_wh", "128", "96", f"--testpath={scene}",
          f"--outdir={tmp_path / 'out'}", "--loadckpt",
          os.path.join(logdir, "model_000001.ckpt"), "--device", "cpu", "--iteration", "2"])
    depth, _ = read_pfm(str(tmp_path / "out" / "depth_est" / "00000000.pfm"))
    assert depth.shape == (96, 128, 1) and np.isfinite(depth).all()
    assert (tmp_path / "out" / "custom.ply").exists()


def test_cli_trains_in_bfloat16(tmp_path):
    """`--precision bfloat16`: one stage-2 step and a validation pass on
    the fixture; the checkpoint it saves holds float32 weights."""
    root = str(tmp_path / "dtu")
    listfile = build_dtu_training_dir(root)
    logdir = str(tmp_path / "logs")
    out = _run(["-m", "itermvs_tpu_torch.train", "--dataset", "dtu_yao", "--trainpath", root,
                "--trainlist", listfile, "--vallist", listfile, "--batch_size", "4",
                "--iteration", "2", "--summary_freq", "1", "--logdir", logdir,
                "--device", "cpu", "--loader_processes", "0", "--epochs", "1", "--regress",
                "--precision", "bfloat16"])
    assert "precision: bfloat16" in out
    losses = _losses(out)
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert "avg_test_scalars:" in out
    state = torch.load(os.path.join(logdir, "model_000000.ckpt"), map_location="cpu",
                       weights_only=True)["model"]
    assert all(t.dtype == torch.float32 for t in state.values() if t.is_floating_point())


def test_trainer_defaults_to_cuda_and_never_falls_back(monkeypatch, tmp_path):
    assert port_train.parser.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--trainpath", str(tmp_path), "--logdir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("flag,match", [
    pytest.param(["--distributed", "on"], "--distributed on is not ported",
                 id="flag1---distributed on is not ported"),
    pytest.param(["--debug_nans"], "--debug_nans is not ported",
                 id="flag2---debug_nans is not ported")])
def test_trainer_rejects_unported_flags(flag, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        port_train.main(["--device", "cpu", "--logdir", str(tmp_path / "logs"), *flag])
    assert not (tmp_path / "logs").exists()


def test_trainer_flags_match_jax_train():
    """The same flags and defaults as the JAX train.py, plus --device."""
    import importlib

    jax_train = importlib.import_module("train")
    want = {a.dest: a.default for a in jax_train.parser._actions}
    got = {a.dest: a.default for a in port_train.parser._actions}
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
