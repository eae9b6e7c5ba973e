"""The port's eval CLI: its flags against the JAX eval.py's, `--debug_nans`
(128×96, 3 views, iteration 2: the same PFMs bit for bit, and a NaN
weight caught), and a `--precision bfloat16` run end to end on the CPU.

The bf16 run is the textured plane scene of tests/test_bf16_mode.py
(384×288, 4 views, the vendored DTU weights): its depth maps, written as
float32 PFMs, must lie within the verify recipe's 0.05 of the analytic
plane (median), and fusion must write the PLY.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from itermvs_tpu_torch import eval as port_eval
from itermvs_tpu_torch.io import read_pfm, read_ply
from itermvs_tpu_torch.weights import npz_state_dict, pretrained_path
from tests.synthetic_scene import Z0, build_scene_dir, make_cameras, render_view

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_eval():
    return importlib.import_module("eval")


def test_eval_flags_match_jax_eval(jax_eval):
    """Every dest of eval.py's parser, with its default; the port adds
    only --device; --precision offers the same choices."""
    want = {a.dest: a.default for a in jax_eval.parser._actions}
    got = {a.dest: a.default for a in port_eval.parser._actions}
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want

    def choices(parser):
        return next(a.choices for a in parser._actions if a.dest == "precision")

    assert choices(port_eval.parser) == choices(jax_eval.parser) == ["float32", "bfloat16"]


def _eval(scene, out, *flags):
    return subprocess.run(
        [sys.executable, "-m", "itermvs_tpu_torch.eval", "--dataset=custom", "--batch_size=1",
         "--n_views", "3", "--img_wh", "128", "96", f"--testpath={scene}", f"--outdir={out}",
         "--iteration", "2", "--device", "cpu", *flags],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"))


def test_eval_accepts_model_and_refuses_debug_nans(tmp_path):
    """`--model` parses; `--debug_nans` (once refused, hence the name)
    writes the same PFMs as a run without it, and stops at the module
    whose output first holds a NaN (here from a NaN weight)."""
    args = port_eval.parser.parse_args(["--model", "IterMVS", "--precision", "bfloat16"])
    assert args.model == "IterMVS" and args.precision == "bfloat16"
    scene = str(tmp_path / "scene")
    os.makedirs(scene)
    build_scene_dir(scene, num_views=3, width=128, height=96, write_gt_depth=False)
    for out, flags in (("plain", ()), ("checked", ("--debug_nans",))):
        result = _eval(scene, tmp_path / out, *flags)
        assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-3000:]
    for v in range(3):
        for kind in ("depth_est", "confidence"):
            want, _ = read_pfm(str(tmp_path / "plain" / kind / f"{v:08d}.pfm"))
            got, _ = read_pfm(str(tmp_path / "checked" / kind / f"{v:08d}.pfm"))
            assert np.array_equal(got, want), (kind, v)

    sd = npz_state_dict(pretrained_path("dtu"))
    sd["feature_net.conv1.conv.weight"][0, 0, 0, 0] = float("nan")
    torch.save({"epoch": 0, "model": sd}, tmp_path / "nan.ckpt")
    result = _eval(scene, tmp_path / "nan", "--debug_nans", "--loadckpt",
                   str(tmp_path / "nan.ckpt"))
    assert result.returncode != 0
    assert ("FloatingPointError: NaN in the output of module feature_net.conv1.conv "
            "(Conv2d)") in result.stderr, result.stderr[-3000:]


def test_eval_cli_runs_in_bfloat16(tmp_path):
    views, w, h = 4, 384, 288
    scene = str(tmp_path / "scene")
    os.makedirs(scene)
    build_scene_dir(scene, num_views=views, width=w, height=h, write_gt_depth=False)
    out = tmp_path / "out"
    result = subprocess.run(
        [sys.executable, "-m", "itermvs_tpu_torch.eval", "--model", "IterMVS",
         "--dataset=custom", "--batch_size=1", "--n_views", str(views), "--img_wh", str(w),
         str(h), f"--testpath={scene}", f"--outdir={out}", "--precision", "bfloat16",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"))
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-3000:]
    assert "precision: bfloat16" in result.stdout
    cams = make_cameras(views, w, h, np.random.RandomState(0))
    for v, (K, E) in enumerate(cams):
        depth, _ = read_pfm(str(out / "depth_est" / f"{v:08d}.pfm"))
        conf, _ = read_pfm(str(out / "confidence" / f"{v:08d}.pfm"))
        assert depth.dtype == conf.dtype == np.float32
        assert depth.shape == conf.shape == (h, w, 1) and np.isfinite(depth).all()
        gt = render_view(K, E, w, h)[1]
        assert np.median(np.abs(depth[..., 0] - gt)) < 0.05, v
    xyz, _ = read_ply(str(out / "custom.ply"))
    assert xyz.shape[0] > 0 and np.median(np.abs(xyz[:, 2] - Z0)) < 0.05
