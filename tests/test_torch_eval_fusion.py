"""The port's eval CLI end to end (depth, then fusion) against eval.py on a
5-view custom scene, so that the custom geo_mask_thres of 3 can be met.

Tolerance: point counts within 1%; the median |z - Z0| of each cloud
below 0.05 (the JAX verify recipe's bar, scene depth 5.0) and the two
medians within 0.005 of each other; the same mask files. The scene is
256x192: at 128x96 both packages fuse the same 2749 points, but the
model's depth is too coarse there for the 0.05 bar (median 0.162 in
both).
"""
import os
import subprocess
import sys

import numpy as np

from tests.synthetic_scene import Z0, build_scene_dir

from itermvs_tpu_torch.io import read_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "checkpoints", "dtu", "model_000015.npz")
VIEWS, W, H = 5, 256, 192


def _run(cmd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    result = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                            env=env, timeout=900)
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-3000:]
    return result


def test_port_eval_fuses_like_jax_eval(tmp_path):
    scene = str(tmp_path / "scene")
    os.makedirs(scene)
    build_scene_dir(scene, num_views=VIEWS, width=W, height=H, write_gt_depth=False)
    common = ["--dataset=custom", "--batch_size=1", "--n_views", str(VIEWS),
              "--img_wh", str(W), str(H), f"--testpath={scene}", "--loadckpt", NPZ]
    _run([sys.executable, os.path.join(REPO, "eval.py"), *common,
          f"--outdir={tmp_path / 'jax'}"])
    out = _run([sys.executable, "-m", "itermvs_tpu_torch.eval", *common,
                f"--outdir={tmp_path / 'port'}", "--device", "cpu"]).stdout
    assert "fusion: 1 scan(s)" in out

    clouds = {}
    for name in ("jax", "port"):
        folder = tmp_path / name
        assert sorted(os.listdir(folder / "depth_est")) == [
            f"{v:08d}.pfm" for v in range(VIEWS)]
        clouds[name], rgb = read_ply(str(folder / "custom.ply"))
        assert rgb is not None and rgb.shape == clouds[name].shape
    assert sorted(os.listdir(tmp_path / "port" / "mask")) == sorted(
        os.listdir(tmp_path / "jax" / "mask")) == sorted(
        f"{v:08d}_{k}.png" for v in range(VIEWS) for k in ("photo", "geo", "final"))
    n, n_jax = len(clouds["port"]), len(clouds["jax"])
    assert n > 0
    assert abs(n - n_jax) <= 0.01 * n_jax
    med = {k: float(np.median(np.abs(v[:, 2] - Z0))) for k, v in clouds.items()}
    assert med["port"] < 0.05 and med["jax"] < 0.05
    assert abs(med["port"] - med["jax"]) <= 0.005
