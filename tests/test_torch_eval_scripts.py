"""The port's eval recipes, eval_{dtu,tanks,eth,custom}_torch.sh.

Each must hand the port's eval the flags its JAX script hands eval.py,
in the same order, launched as `torchrun --standalone --nproc_per_node
$NGPUS -m itermvs_tpu_torch.eval` with `--batch_size=$NGPUS` (the JAX
scripts' `--batch_size=1` at the default NGPUS=1); stand-ins for
`python` and `torchrun` on PATH record each call. Then one real run of
eval_dtu_torch.sh on the CPU, as tests/test_eval_scripts.py runs
eval_dtu.sh: the default CKPT_FILE (the vendored .npz), a 6-view
synthetic DTU scan rendered at DTU's 1600x1200, eval at 288x224
(ITERMVS_IMG_WH): of the multiple-of-32 sizes tried, the one of fewest
pixels whose fused cloud keeps more than 20000 points (256x224 keeps
fewer).
"""
import os
import subprocess

import numpy as np
import pytest

from itermvs_tpu_torch.io import read_ply
from tests.synthetic_scene import Z0, build_scene_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VENDORED = os.path.join(REPO, "checkpoints", "dtu", "model_000015.npz")
DATA_VARS = ("DTU_TESTING", "TANK_TESTING", "ETH3D_TESTING", "CUSTOM_TESTING")
PREFIX = {"python": ["eval.py"],
          "torchrun": ["--standalone", "--nproc_per_node", None, "-m",
                       "itermvs_tpu_torch.eval"]}


def _calls(script, tmp_path, **env):
    """[(program, argv)] of each call `script` makes of python or torchrun."""
    bin_dir = tmp_path / "bin"
    if not bin_dir.exists():
        bin_dir.mkdir()
        for prog in PREFIX:
            stand_in = bin_dir / prog
            stand_in.write_text('#!/usr/bin/env bash\necho "$(basename "$0") $*" >> "$CALLS"\n')
            stand_in.chmod(0o755)
    calls = tmp_path / "calls.txt"
    calls.unlink(missing_ok=True)
    full = {k: v for k, v in os.environ.items()
            if k not in ("CKPT_FILE", "OUT_DIR", "NGPUS", *DATA_VARS)}
    full.update(PATH=f"{bin_dir}:{os.environ['PATH']}", CALLS=str(calls),
                **{v: "/data" for v in DATA_VARS}, **env)
    result = subprocess.run(["bash", os.path.join(REPO, script), "--device", "cpu"],
                            capture_output=True, text=True, cwd=REPO, env=full, timeout=60)
    assert result.returncode == 0, result.stderr
    return [(line.split()[0], line.split()[1:]) for line in calls.read_text().splitlines()]


def _eval_flags(call, nproc=None):
    """The flags after the launch prefix of one recorded call."""
    prog, argv = call
    prefix = [nproc if p is None else p for p in PREFIX[prog]]
    assert argv[:len(prefix)] == prefix, argv
    return argv[len(prefix):]


@pytest.mark.parametrize("name", ["dtu", "tanks", "eth", "custom"])
def test_torch_script_passes_the_jax_scripts_flags(name, tmp_path):
    jax_calls = _calls(f"eval_{name}.sh", tmp_path)
    torch_calls = _calls(f"eval_{name}_torch.sh", tmp_path)
    assert [p for p, _ in jax_calls] == ["python"] * len(jax_calls)
    assert [p for p, _ in torch_calls] == ["torchrun"] * len(jax_calls)
    assert len(jax_calls) == (2 if name in ("tanks", "eth") else 1)
    want = [_eval_flags(c) for c in jax_calls]
    assert [_eval_flags(c, "1") for c in torch_calls] == want
    assert all("--batch_size=1" in flags and flags[-2:] == ["--device", "cpu"]
               and "--loadckpt ./checkpoints/dtu/model_000015.npz" in " ".join(flags)
               for flags in want)

    two = [_eval_flags(c, "2") for c in _calls(f"eval_{name}_torch.sh", tmp_path, NGPUS="2")]
    assert two == [[{"--batch_size=1": "--batch_size=2"}.get(f, f) for f in flags]
                   for flags in want]


@pytest.mark.skipif(not os.path.exists(VENDORED), reason="vendored weights not present")
def test_eval_dtu_torch_script_runs_from_clean_checkout(tmp_path):
    root = str(tmp_path / "data")
    # 6 views: DTU fusion's geo_mask_thres of 4 needs >= 5 source views.
    os.makedirs(os.path.join(root, "scan1"))
    build_scene_dir(os.path.join(root, "scan1"), num_views=6,
                    width=1600, height=1200, write_gt_depth=False)
    testlist = str(tmp_path / "list.txt")
    with open(testlist, "w") as f:
        f.write("scan1\n")
    outdir = str(tmp_path / "out")

    env = {k: v for k, v in os.environ.items() if k not in ("CKPT_FILE", "NGPUS")}
    env.update(ITERMVS_IMG_WH="288x224", DTU_TESTING=root, OUT_DIR=outdir,
               OMP_NUM_THREADS="2")
    result = subprocess.run(
        ["bash", os.path.join(REPO, "eval_dtu_torch.sh"),
         "--testlist", testlist, "--n_views", "4", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-3000:]

    ply = os.path.join(outdir, "itermvs001_l3.ply")
    assert os.path.exists(ply), os.listdir(outdir)
    xyz, _ = read_ply(ply)
    assert xyz.shape[0] > 20000
    assert np.median(np.abs(xyz[:, 2] - Z0)) < 0.05
