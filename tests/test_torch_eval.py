"""The port's eval CLI against the JAX eval.py, and the port's isolation.

Tolerance for the PFMs (the model tolerance of test_torch_models.py):
median relative depth error ≤ 1e-4 and ≥ 99.5% of the scene's depth
pixels within 1e-3 relative; confidence within 1e-3 on ≥ 99.5% of
pixels. The fractions are taken over all maps of the scene: a near-tie
of two of the 256 depth bins at one coarse pixel can move its window
and, through the convex ×4 upsample, a ~16-pixel patch of one map.
Each map on its own must still have ≥ 99% of its pixels within 1e-3.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.synthetic_scene import build_scene_dir

from itermvs_tpu_torch import eval as port_eval
from itermvs_tpu_torch.io import read_pfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "checkpoints", "dtu", "model_000015.npz")
VIEWS, W, H = 3, 128, 96


def _run(cmd, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    result = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                            env=env, timeout=900)
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-3000:]
    return result


def test_port_pfms_match_jax_eval(tmp_path):
    scene = str(tmp_path / "scene")
    os.makedirs(scene)
    build_scene_dir(scene, num_views=VIEWS, width=W, height=H,
                    write_gt_depth=False)
    common = ["--dataset=custom", "--batch_size=1", "--n_views", str(VIEWS),
              "--img_wh", str(W), str(H), f"--testpath={scene}"]
    _run([sys.executable, os.path.join(REPO, "eval.py"), *common,
          f"--outdir={tmp_path / 'jax'}", "--loadckpt", NPZ])
    _run([sys.executable, "-m", "itermvs_tpu_torch.eval", *common,
          f"--outdir={tmp_path / 'port'}", "--loadckpt", NPZ, "--device", "cpu"])

    rel_all, conf_all = [], []
    for v in range(VIEWS):
        got, _ = read_pfm(str(tmp_path / "port" / "depth_est" / f"{v:08d}.pfm"))
        want, _ = read_pfm(str(tmp_path / "jax" / "depth_est" / f"{v:08d}.pfm"))
        assert got.shape == want.shape == (H, W, 1)
        assert np.isfinite(got).all()
        rel = np.abs(got - want) / np.abs(want)
        assert np.mean(rel <= 1e-3) >= 0.99, f"view {v}"
        rel_all.append(rel.ravel())
        cg, _ = read_pfm(str(tmp_path / "port" / "confidence" / f"{v:08d}.pfm"))
        cw, _ = read_pfm(str(tmp_path / "jax" / "confidence" / f"{v:08d}.pfm"))
        conf_all.append(np.abs(cg - cw).ravel())
    rel_all = np.concatenate(rel_all)
    assert np.median(rel_all) <= 1e-4
    assert np.mean(rel_all <= 1e-3) >= 0.995
    assert np.mean(np.concatenate(conf_all) <= 1e-3) >= 0.995


def _port_modules():
    """Every module of the port package, plus chip_smoke."""
    mods = ["chip_smoke"]
    pkg = os.path.join(REPO, "itermvs_tpu_torch")
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        for f in sorted(files):
            if f.endswith(".py"):
                mod = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = _port_modules()
    assert {"itermvs_tpu_torch.eval", "itermvs_tpu_torch.kernels",
            "itermvs_tpu_torch.ops.sweep", "itermvs_tpu_torch.weights"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'itermvs_tpu')\n"
        "             or m.startswith(('jax.', 'flax.', 'itermvs_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    result = _run([sys.executable, "-c", code])
    assert "clean" in result.stdout


def test_default_device_is_cuda_and_never_falls_back(monkeypatch, tmp_path):
    assert port_eval.parser.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(["--dataset", "custom", "--testpath", str(tmp_path),
                        "--outdir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.run_fusion(port_eval.parser.parse_args(
            ["--dataset", "custom", "--testpath", str(tmp_path),
             "--outdir", str(tmp_path / "out")]), (64, 48))
    assert not (tmp_path / "out").exists()


def test_eval_rejects_weights_it_cannot_read(tmp_path):
    with pytest.raises(SystemExit, match="vendored .npz"):
        port_eval.main(["--device", "cpu", "--dataset", "custom",
                        "--testpath", str(tmp_path), "--loadckpt", "model.ckpt"])


@pytest.fixture(scope="module")
def jax_eval():
    return importlib.import_module("eval")


def test_result_wire_matches_jax(jax_eval, rng):
    import jax.numpy as jnp

    depths = (rng.rand(2, 24, 32, 1) * 8 + 2).astype(np.float32)
    confs = rng.rand(2, 24, 32, 1).astype(np.float32)
    want = [np.asarray(x) for x in jax_eval.quantize_results(
        jnp.asarray(depths), jnp.asarray(confs))]
    got = [x.numpy() for x in port_eval.quantize_results(
        torch.from_numpy(depths), torch.from_numpy(confs))]
    assert got[0].dtype == got[3].dtype == np.uint16
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.astype(np.float64) - w.astype(np.float64)).max() <= 1
    d_got, c_got = port_eval.dequantize_results(*got)
    d_want, c_want = jax_eval.dequantize_results(*want)
    span = depths.max() - depths.min()
    assert np.abs(d_got - d_want).max() <= 2 * span / 65535
    assert np.abs(d_got - depths[..., 0]).max() <= span / 65535
    np.testing.assert_allclose(c_got, c_want, atol=2 / 65535)


@pytest.mark.parametrize("argv,env,want", [
    (["--dataset", "custom"], None, (640, 480)),
    (["--dataset", "custom", "--img_wh", "320", "240"], "64x48", (320, 240)),
    (["--dataset", "dtu_yao_eval"], None, (1600, 1152)),
    (["--dataset", "dtu_yao_eval"], "160 128", (160, 128)),
    (["--dataset", "tanks"], None, (1920, 1024)),
    (["--dataset", "tanks", "--img_wh", "320", "240"], None, (1920, 1024)),
    (["--dataset", "eth3d"], None, (1920, 1280)),
    (["--dataset", "eth3d"], "96x64", (96, 64)),
])
def test_resolve_img_wh_matches_jax(jax_eval, monkeypatch, argv, env, want):
    if env is None:
        monkeypatch.delenv("ITERMVS_IMG_WH", raising=False)
    else:
        monkeypatch.setenv("ITERMVS_IMG_WH", env)
    got = port_eval.resolve_img_wh(port_eval.parser.parse_args(argv))
    assert got == jax_eval.resolve_img_wh(jax_eval.parser.parse_args(argv)) == want
