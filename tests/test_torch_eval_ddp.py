"""The port's data-parallel eval: one process per device under torchrun,
against the JAX eval.py sharded over a device mesh.

`eval_batches` (data/loader.py) gives each process the rows that JAX's
`batch_sharding` puts on its device, the short last batch padded as
eval.py's `_pad` pads it. End to end, the port's CLI runs as two gloo
ranks on the CPU (`torch.distributed.run`, 128x96, 3 views, iteration 2,
the vendored DTU weights): at `--batch_size 2` on both result wires its
PFMs equal, bit for bit, one process's at batch 1 with the feature cache
off (each rank's local batch is 1), and lie within
tests/test_torch_eval.py's tolerance of the JAX eval.py at
`--batch_size 2` over 2 devices; at `--batch_size 1` rank 0 evaluates
alone. Every run writes each map once and rank 0 alone fuses.
"""
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from itermvs_tpu.parallel.mesh import batch_sharding, make_mesh
from itermvs_tpu_torch.data import find_dataset_def
from itermvs_tpu_torch.data.loader import eval_batches
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path
from tests.synthetic_scene import build_scene_dir
from tests.test_torch_eval import assert_pfms_match_jax
from tests.test_torch_eval_pipeline import pfm_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "checkpoints", "dtu", "model_000015.npz")
VIEWS, W, H, ITERATION = 3, 128, 96, 2
WORLD = 2
# (run, --batch_size, --result_wire): the port's two-rank CLI runs.
RUNS = (("bs2_uint16", 2, "uint16"), ("bs2_float32", 2, "float32"),
        ("bs1_uint16", 1, "uint16"))


@pytest.mark.parametrize("size,batch,world", [
    (5, 2, 2), (4, 4, 2), (3, 4, 2), (1, 4, 4), (9, 8, 4), (7, 6, 3), (10, 8, 8),
    (6, 2, 1), (5, 4, 1)])
def test_eval_batches_are_the_rows_of_each_device(size, batch, world):
    """Per global batch, process r's indices are device r's shard of the
    padded index array and `n_real` counts its unpadded ones."""
    sharding = batch_sharding(make_mesh(jax.devices()[:world]))
    per_rank = [eval_batches(size, batch, r, world) for r in range(world)]
    starts = range(0, size, batch)
    assert all(len(b) == len(starts) for b in per_rank)
    for i, start in enumerate(starts):
        x = np.arange(start, min(start + batch, size))
        n_real = len(x)
        x = np.concatenate([x, np.repeat(x[-1:], batch - n_real, axis=0)])
        shards = jax.device_put(x, sharding).addressable_shards
        rows = {s.device: (s.index[0].indices(batch), np.asarray(s.data)) for s in shards}
        for r, device in enumerate(sharding.mesh.devices):
            (lo, hi, _), data = rows[device]
            indices, real = per_rank[r][i]
            assert indices == data.tolist(), (r, i)
            assert real == int(np.sum(np.arange(lo, hi) < n_real)), (r, i)
    assert sum(n for b in per_rank for _, n in b) == size


def test_eval_batches_refuse_a_batch_the_processes_do_not_divide():
    with pytest.raises(ValueError, match="must divide evenly over 2 processes"):
        eval_batches(5, 3, 0, 2)


def _torchrun(scene, out, batch_size, wire):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "--tee", "3", "-m", "itermvs_tpu_torch.eval",
         "--dataset=custom", f"--batch_size={batch_size}", "--n_views", str(VIEWS),
         "--img_wh", str(W), str(H), f"--testpath={scene}", f"--outdir={out}",
         "--iteration", str(ITERATION), "--result_wire", wire, "--loadckpt", NPZ,
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"))


def _jax_eval(scene, out):
    """eval.py at --batch_size 2 over 2 devices: the conftest's count of 8
    would not divide the batch and send it down its one-device path."""
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   os.environ.get("XLA_FLAGS", ""))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "eval.py"), "--dataset=custom",
         f"--batch_size={WORLD}", "--n_views", str(VIEWS), "--img_wh", str(W), str(H),
         f"--testpath={scene}", f"--outdir={out}", "--iteration", str(ITERATION),
         "--loadckpt", NPZ],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                 XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count={WORLD}".strip()))


def _one_process(scene, out, wire, cache):
    """The port in this process at batch 1, as one CLI process runs it."""
    dataset = find_dataset_def("custom")(scene, VIEWS, (W, H))
    model = load_npz_weights(Pipeline(iteration=ITERATION), pretrained_path("dtu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)            # as each rank; the suite runs six workers
    try:
        run_depth(model, torch.utils.data.DataLoader(dataset, batch_size=1), out, "cpu",
                  feature_cache=cache, result_wire=wire, log=lambda *_: None)
    finally:
        torch.set_num_threads(threads)


def _rank_lines(stdout):
    """{rank: [lines]} of torchrun's `--tee` output ("[default<r>]:line")."""
    lines = {}
    for line in stdout.splitlines():
        m = re.match(r"\[\D*(\d+)\]:(.*)", line)
        if m:
            lines.setdefault(int(m.group(1)), []).append(m.group(2))
    return lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank runs and JAX's start side by side; the one-process
    references run in this process meanwhile. Returns (root, {run:
    CompletedProcess}, JAX's CompletedProcess)."""
    root = tmp_path_factory.mktemp("ddp")
    scene = str(root / "scene")
    os.makedirs(scene)
    build_scene_dir(scene, num_views=VIEWS, width=W, height=H, write_gt_depth=False)
    with ThreadPoolExecutor(len(RUNS) + 1) as pool:
        started = {name: pool.submit(_torchrun, scene, root / name, bs, wire)
                   for name, bs, wire in RUNS}
        jax_run = pool.submit(_jax_eval, scene, root / "jax")
        for wire, cache in (("uint16", False), ("float32", False), ("uint16", True)):
            _one_process(scene, str(root / f"one_{wire}_{'cache' if cache else 'nocache'}"),
                         wire, cache)
        done = {name: f.result() for name, f in started.items()}
        return root, done, jax_run.result()


def _ok(result):
    assert result.returncode == 0, result.stdout[-3000:] + result.stderr[-3000:]
    return _rank_lines(result.stdout)


@pytest.mark.parametrize("run,wire", [("bs2_uint16", "uint16"), ("bs2_float32", "float32")])
def test_two_ranks_write_one_process_pfms(runs, run, wire):
    """Batch 2 over 2 ranks: 3 maps in batches [0, 1] and [2, pad]; rank 0
    writes maps 0 and 2, rank 1 map 1 and nothing of its padded row; the
    PFMs are one process's at batch 1, cache off, byte for byte."""
    root, done, _ = runs
    ranks = _ok(done[run])
    assert "data-parallel eval over 2 processes" in ranks[0]
    for r in range(WORLD):
        wrote = sum(n for _, n in eval_batches(VIEWS, 2, r, WORLD))
        assert f"rank {r}: wrote {wrote} of {VIEWS} maps" in ranks[r]
    got, want = pfm_bytes(root / run), pfm_bytes(root / f"one_{wire}_nocache")
    assert len(want) == 2 * VIEWS and got == want


def test_rank_zero_alone_fuses(runs):
    """The PLY comes from rank 0's fusion after the barrier; rank 1
    returns without fusing."""
    root, done, _ = runs
    for run, _, _ in RUNS:
        ranks = _ok(done[run])
        assert any(line.startswith("fusion: 1 scan(s)") for line in ranks[0]), run
        assert not any("fusion" in line or "processing" in line for line in ranks[1]), run
        assert os.path.exists(root / run / "custom.ply"), run


def test_a_batch_the_ranks_do_not_divide_runs_on_rank_zero(runs):
    """Batch 1 over 2 ranks: rank 0 evaluates every map as one process
    does (feature cache on), rank 1 says it is idle and loads nothing."""
    root, done, _ = runs
    ranks = _ok(done["bs1_uint16"])
    assert not any("data-parallel" in line for lines in ranks.values() for line in lines)
    assert any("rank 0 evaluates alone and this rank is idle" in line for line in ranks[1])
    assert not any(line.startswith(("loading model", "Iter")) for line in ranks[1])
    got, want = pfm_bytes(root / "bs1_uint16"), pfm_bytes(root / "one_uint16_cache")
    assert len(want) == 2 * VIEWS and got == want


def test_two_ranks_match_the_jax_eval_over_two_devices(runs):
    root, done, jax_run = runs
    _ok(done["bs2_uint16"])
    assert jax_run.returncode == 0, jax_run.stdout[-2000:] + jax_run.stderr[-3000:]
    assert "data-parallel eval over 2 devices" in jax_run.stdout
    assert_pfms_match_jax(root / "bs2_uint16", root / "jax", VIEWS, (H, W, 1))
