"""The port's fusion against the JAX package's, on the CPU.

Tolerances:
* consistency (plain version vs `_consistency_kernel`): mask bits equal on
  >= 99.9% of pixels (a threshold test may flip on a borderline pixel
  under another summation order), lo and hi within 1e-6 relative, uint16
  depth within +-2 where the geo bits agree;
* the sampler: equal to 1e-6 (the same products in the same order);
* filter_depth: mask PNGs equal on >= 99.9% of pixels, vertex counts
  within 0.1%, >= 99.9% of the port's points within 1e-4 * Z0 of a JAX
  point, with equal colours;
* PNG and PLY codecs: exact.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image
from scipy.spatial import cKDTree

from itermvs_tpu import fusion as jax_fusion
from itermvs_tpu.io import ply as jax_ply
from itermvs_tpu.ops.grid_sample import gather_bilinear, pack_corners
from itermvs_tpu_torch import fusion as port_fusion
from itermvs_tpu_torch.io import PlyWriter, read_ply, save_pfm, write_ply, write_png
from itermvs_tpu_torch.ops import consistency as port_cons
from tests.synthetic_scene import Z0, build_scene_dir

W, H = 160, 120
THRES = dict(geo_pixel_thres=1.0, geo_depth_thres=0.01, photo_thres=0.3)


@pytest.fixture(scope="module")
def sphere_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sphere"))
    cams, depths = build_scene_dir(root, num_views=5, width=W, height=H,
                                   scene="sphere_step", write_gt_depth=False)
    return cams, depths


def _inputs(cams, depths, srcs, seed=0):
    """ref view 0 vs `srcs`: (ref depth with planted zero and negative
    pixels, seeded confidence with pixels exactly at photo_thres, source
    stack, camera matrices as numpy f32)."""
    rng = np.random.RandomState(seed)
    ref = depths[0].copy()
    ref[:4, :4] = 0.0
    ref[60, 10:20] = -1.0
    conf = rng.uniform(0.0, 0.6, ref.shape).astype(np.float32)
    conf[::7, ::5] = np.float32(THRES["photo_thres"])
    mats = port_fusion.consistency_matrices(
        cams[0][0], cams[0][1], [cams[s][0] for s in srcs], [cams[s][1] for s in srcs])
    src = np.array([depths[s] for s in srcs], np.float32).reshape(len(srcs), H, W)
    return ref, conf, src, [m.numpy() for m in mats]


def _jax(ref, conf, src, mats, bucket, geo_mask_thres=3):
    """JAX `_consistency_kernel` with the source axis padded to `bucket`
    (padded slots replicate source 0, masked out by src_valid)."""
    s = src.shape[0]
    idx = list(range(s)) + [0] * (bucket - s)
    r2s, s2r, k_ref, k_ref_inv, k_srcs, k_srcs_inv = mats
    if s == 0:      # all padding: every slot holds the reference, masked out
        src, r2s = ref[None], np.eye(4, dtype=np.float32)[None]
        s2r, k_srcs, k_srcs_inv = r2s, k_ref[None], k_ref_inv[None]
        idx = [0] * bucket
    valid = np.zeros(bucket, np.float32)
    valid[:s] = 1.0
    out = jax_fusion._consistency_kernel(
        jnp.asarray(ref), jnp.asarray(conf), jnp.asarray(src[idx]), jnp.asarray(valid),
        jnp.asarray(r2s[idx]), jnp.asarray(s2r[idx]), jnp.asarray(k_ref),
        jnp.asarray(k_ref_inv), jnp.asarray(k_srcs[idx]), jnp.asarray(k_srcs_inv[idx]),
        geo_mask_thres=geo_mask_thres, **THRES)
    depth_q, lo, hi, bits = (np.asarray(x) for x in out)
    return depth_q, float(lo), float(hi), bits


def _port(ref, conf, src, mats, geo_mask_thres=3):
    t = torch.from_numpy
    avg, bits = port_cons.consistency(t(ref), t(conf), t(src), *map(t, mats),
                                      geo_mask_thres=geo_mask_thres, **THRES)
    assert avg.dtype == torch.float32 and bits.dtype == torch.uint8
    depth_q, lo, hi = port_cons.quantize_depth(avg)
    return depth_q.numpy(), float(lo), float(hi), bits.numpy()


def _assert_close(got, want):
    q, lo, hi, bits = got
    qj, loj, hij, bitsj = want
    assert q.dtype == np.uint16 and q.shape == qj.shape == (H, W)
    assert np.mean(bits == bitsj) >= 0.999
    assert abs(lo - loj) <= 1e-6 * max(abs(loj), 1e-6)
    assert abs(hi - hij) <= 1e-6 * max(abs(hij), 1e-6)
    agree = (bits & 2) == (bitsj & 2)
    assert np.abs(q.astype(np.int64) - qj.astype(np.int64))[agree].max() <= 2


@pytest.mark.parametrize("srcs", [[1, 2, 3, 4], [1, 2, 3]], ids=["S4", "S3_vs_padded_4"])
def test_consistency_matches_jax(sphere_scene, srcs):
    cams, depths = sphere_scene
    ref, conf, src, mats = _inputs(cams, depths, srcs)
    got = _port(ref, conf, src, mats)
    _assert_close(got, _jax(ref, conf, src, mats, bucket=4))
    bits = got[3]
    # The scene has occlusion and the plants: some geo bits fail, most pass.
    assert 0.3 < np.mean((bits & 2) > 0) < 0.995
    assert not (bits[:4, :4] & 2).any()                  # zero depth never passes
    assert not (bits[::7, ::5] & 1).any()                # conf == thres is not photo


def test_no_sources_matches_jax_all_padding_bucket(sphere_scene):
    cams, depths = sphere_scene
    ref, conf, src, mats = _inputs(cams, depths, [])
    assert src.shape == (0, H, W)
    got = _port(ref, conf, src, mats)
    want = _jax(ref, conf, src, mats, bucket=2)
    assert np.array_equal(got[3], want[3]) and not (got[3] & 2).any()
    assert (got[1], got[2]) == (want[1], want[2])
    assert np.abs(got[0].astype(np.int64) - want[0].astype(np.int64)).max() <= 1


@pytest.mark.parametrize("geo_mask_thres", [3, 4, 5])
def test_geo_threshold_is_count_at_least(sphere_scene, geo_mask_thres):
    """geo = count >= geo_mask_thres: with 4 sources, 4 passes and 5 never."""
    cams, depths = sphere_scene
    ref, conf, src, mats = _inputs(cams, depths, [1, 2, 3, 4])
    got = _port(ref, conf, src, mats, geo_mask_thres)
    _assert_close(got, _jax(ref, conf, src, mats, 4, geo_mask_thres))
    share = np.mean((got[3] & 2) > 0)
    assert (share == 0) == (geo_mask_thres == 5)


def test_tiny_depths_keep_both_divides():
    """Reference and source on one camera, depth 1e-6 everywhere: the
    source projection (no epsilon) lands on the pixel itself, the
    reprojection's 1e-6 halves its coordinates, so only pixels within
    2 px of the origin stay within 1 px. Without the epsilon every pixel
    would pass."""
    h, w = 12, 16
    k = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1]], np.float32)
    e = np.eye(4, dtype=np.float32)
    depth = np.full((h, w), 1e-6, np.float32)
    conf = np.ones((h, w), np.float32)
    mats = [m.numpy() for m in port_fusion.consistency_matrices(k, e, [k, k], [e, e])]
    t = torch.from_numpy
    avg, bits = port_cons.consistency(t(depth), t(conf), t(np.stack([depth, depth])),
                                      *map(t, mats), geo_mask_thres=2, **THRES)
    ys, xs = np.mgrid[:h, :w]
    assert np.array_equal((bits.numpy() & 2) > 0, np.hypot(xs, ys) / 2 < 1.0)
    out = jax_fusion._consistency_kernel(
        jnp.asarray(depth), jnp.asarray(conf), jnp.asarray(np.stack([depth, depth])),
        jnp.ones(2), *map(jnp.asarray, mats), geo_mask_thres=2, **THRES)
    assert np.array_equal(bits.numpy(), np.asarray(out[3]))


def test_plain_version_runs_no_matmul(sphere_scene):
    """No product of the geometry may go through a matmul (TF32 on the
    card): record every torch function the plain version calls."""
    from torch.overrides import TorchFunctionMode

    called = set()

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            called.add(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    cams, depths = sphere_scene
    ref, conf, src, mats = _inputs(cams, depths, [1, 2])
    with Record():
        port_cons.consistency_plain(*map(torch.from_numpy, (ref, conf, src, *mats)),
                                    geo_mask_thres=1, **THRES)
    assert called and not called & {"matmul", "mm", "bmm", "einsum", "__matmul__",
                                     "tensordot", "linear", "baddbmm", "addmm"}


def test_sampler_matches_jax_at_edges_and_non_finite():
    rng = np.random.RandomState(3)
    s, h, w = 2, 7, 9
    maps = rng.uniform(1.0, 5.0, (s, h, w)).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, -1.5, -1.0, -0.5, -1e-7, 0.0, 0.25,
               w - 1.0, w - 0.5, w - 1e-6, float(w), w + 0.5, h - 1.0, h - 0.5,
               float(h)]
    vals = np.array(special + list(rng.uniform(-2, w + 2, 20)), np.float32)
    px, py = np.meshgrid(vals, vals)
    px = np.broadcast_to(px.ravel(), (s, px.size)).copy()
    py = np.broadcast_to(py.ravel(), (s, py.size)).copy()
    got = port_cons.sample_bilinear_zeros(torch.from_numpy(maps), torch.from_numpy(px),
                                          torch.from_numpy(py)).numpy()
    want = np.asarray(gather_bilinear(pack_corners(jnp.asarray(maps)[..., None]),
                                      jnp.asarray(px), jnp.asarray(py)))[..., 0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    bad = ~np.isfinite(px) | ~np.isfinite(py)
    assert bad.any() and (got[bad] == 0).all()


def test_wrapper_checks_shapes_index_width_and_device():
    meta = dict(device="meta")
    s, h, w = 64, 1300, 26000                 # S*H*W >= 2^31
    args = (torch.empty(h, w, **meta), torch.empty(h, w, **meta),
            torch.empty(s, h, w, **meta), torch.empty(s, 4, 4), torch.empty(s, 4, 4),
            torch.empty(3, 3), torch.empty(3, 3), torch.empty(s, 3, 3),
            torch.empty(s, 3, 3))
    with pytest.raises(ValueError, match="2\\^31"):
        port_cons.consistency(*args, 1.0, 0.01, 0.3, 3)
    small = (torch.empty(4, 5, **meta), torch.empty(4, 5, **meta),
             torch.empty(1, 4, 5, **meta), *(a[:1] if a.ndim == 3 else a
                                             for a in args[3:]))
    with pytest.raises(ValueError, match="unsupported device"):
        port_cons.consistency(*small, 1.0, 0.01, 0.3, 3)
    with pytest.raises(ValueError, match="do not agree"):
        port_cons.consistency(small[0], small[1], torch.empty(2, 4, 5, **meta),
                              *small[3:], 1.0, 0.01, 0.3, 3)


def test_record_round_trips_to_the_matrices(sphere_scene):
    """The kernel's record: a 24-float head (K_ref, K_ref^-1, zeros), then
    one 48-float block per source at a 16-byte stride (R|t ref->src, R|t
    src->ref, K_src, K_src^-1, zeros), as the kernel's float4 loads read it."""
    cams, depths = sphere_scene
    _, _, _, mats = _inputs(cams, depths, [1, 2, 3])
    r2s, s2r, k_ref, k_ref_inv, k_srcs, k_srcs_inv = map(torch.from_numpy, mats)
    rec = port_cons.record(k_ref, k_ref_inv, r2s, k_srcs, k_srcs_inv, s2r)
    assert rec.dtype == torch.float32 and rec.device.type == "cpu" and rec.is_contiguous()
    assert port_cons.HEAD_FLOATS % 4 == 0 and port_cons.SOURCE_FLOATS == 48
    assert rec.numel() == 24 + 48 * 3 and rec.data_ptr() % 16 == 0
    assert torch.equal(rec[:9].view(3, 3), k_ref)
    assert torch.equal(rec[9:18].view(3, 3), k_ref_inv)
    assert not rec[18:24].any()
    per = rec[24:].view(3, 48)
    assert torch.equal(per[:, :12].view(3, 3, 4), r2s[:, :3])
    assert torch.equal(per[:, 12:24].view(3, 3, 4), s2r[:, :3])
    assert torch.equal(per[:, 24:33].view(3, 3, 3), k_srcs)
    assert torch.equal(per[:, 33:42].view(3, 3, 3), k_srcs_inv)
    assert not per[:, 42:].any()
    empty = port_cons.record(k_ref, k_ref_inv, r2s[:0], k_srcs[:0], k_srcs_inv[:0], s2r[:0])
    assert torch.equal(empty, rec[:24])


def test_record_stays_on_the_matrices_device():
    """Matrices already on a device give a record there, with no copy to
    the host and back (meta tensors stand in for the card's)."""
    meta = dict(device="meta", dtype=torch.float64)
    s = 3
    rec = port_cons.record(torch.empty(3, 3, **meta), torch.empty(3, 3, **meta),
                           torch.empty(s, 4, 4, **meta), torch.empty(s, 3, 3, **meta),
                           torch.empty(s, 3, 3, **meta), torch.empty(s, 4, 4, **meta))
    assert rec.device.type == "meta" and rec.dtype == torch.float32
    assert rec.shape == (port_cons.shared_bytes(s) // 4,)


@pytest.mark.parametrize("sources,nbytes", [(1, 288), (10, 2016), (64, 12384), (256, 49248)])
def test_shared_memory_of_the_record(sources, nbytes):
    """4 * (24 + 48 S) bytes; past 48 KB only at 256 sources, where the
    kernel opts in to more dynamic shared memory."""
    assert port_cons.shared_bytes(sources) == nbytes
    assert (nbytes > 48 * 1024) == (sources == 256)


def test_more_sources_than_the_kernel_takes_raise():
    with pytest.raises(ValueError, match="at most 256"):
        port_cons.shared_bytes(257)
    meta = dict(device="meta")
    s, h, w = 257, 4, 5
    with pytest.raises(ValueError, match="at most 256"):
        port_cons.consistency(torch.empty(h, w, **meta), torch.empty(h, w, **meta),
                              torch.empty(s, h, w, **meta), torch.empty(s, 4, 4),
                              torch.empty(s, 4, 4), torch.empty(3, 3), torch.empty(3, 3),
                              torch.empty(s, 3, 3), torch.empty(s, 3, 3), 1.0, 0.01, 0.3, 3)


def test_launcher_takes_cuda_tensors_only():
    """The launcher has no plain fallback: CPU maps raise before any build."""
    maps = (torch.zeros(4, 5), torch.zeros(4, 5), torch.zeros(1, 4, 5),
            torch.zeros(port_cons.shared_bytes(1) // 4))
    with pytest.raises(ValueError, match="one CUDA device"):
        port_cons.launch_consistency(*maps, 1.0, 0.01, 0.3, 3)


# ---------------------------------------------------------- filter_depth
@pytest.fixture(scope="module", params=["plane", "sphere_step"])
def fused(request, tmp_path_factory):
    """One scene's exact depths + seeded confidence fused by both
    packages (with display), each into its own copy of the PFMs."""
    root = str(tmp_path_factory.mktemp(request.param))
    build_scene_dir(root, num_views=5, width=W, height=H, scene=request.param)
    rng = np.random.RandomState(0)
    for v in range(5):
        save_pfm(os.path.join(root, f"confidence/{v:08d}.pfm"),
                 rng.uniform(0.0, 1.0, (H, W)).astype(np.float32))
    out = {}
    for name, fn, extra in (("jax", jax_fusion.filter_depth, {}),
                            ("port", port_fusion.filter_depth, {"device": "cpu"})):
        folder = os.path.join(root, name)
        for kind in ("depth_est", "confidence"):
            shutil.copytree(os.path.join(root, kind), os.path.join(folder, kind))
        ply = os.path.join(root, f"{name}.ply")
        n, secs = fn(root, folder, ply, img_wh=(W, H), verbose=False,
                     display=True, **THRES, geo_mask_thres=3, **extra)
        assert secs > 0
        out[name] = dict(folder=folder, n=n, cloud=read_ply(ply))
    return out


def _png(path):
    return np.array(Image.open(path))


def test_filter_depth_masks_match_jax(fused):
    for v in range(5):
        for kind in ("photo", "geo", "final"):
            rel = f"mask/{v:08d}_{kind}.png"
            got = _png(os.path.join(fused["port"]["folder"], rel))
            want = _png(os.path.join(fused["jax"]["folder"], rel))
            assert got.dtype == np.uint8 and got.shape == want.shape == (H, W)
            assert set(np.unique(got)) <= {0, 255}
            assert np.mean(got == want) >= 0.999, rel


def test_filter_depth_cloud_matches_jax(fused):
    n, n_jax = fused["port"]["n"], fused["jax"]["n"]
    assert n > 0.3 * 5 * W * H
    assert abs(n - n_jax) <= 1e-3 * n_jax
    (xyz, rgb), (xyz_j, rgb_j) = fused["port"]["cloud"], fused["jax"]["cloud"]
    assert xyz.shape == (n, 3) and rgb.shape == (n, 3)
    dist, idx = cKDTree(xyz_j).query(xyz)
    near = dist < 1e-4 * Z0
    assert near.mean() >= 0.999
    assert (rgb[near] == rgb_j[idx[near]]).all()


def test_display_pngs_match_jax(fused):
    names = sorted(os.listdir(os.path.join(fused["jax"]["folder"], "display")))
    assert len(names) == 5 * 5
    assert sorted(os.listdir(os.path.join(fused["port"]["folder"], "display"))) == names
    for name in names:
        got = _png(os.path.join(fused["port"]["folder"], "display", name))
        want = _png(os.path.join(fused["jax"]["folder"], "display", name))
        assert got.shape == want.shape and got.dtype == want.dtype
        if name.endswith(("ref_img.png", "ref_depth.png")):
            assert np.array_equal(got, want), name
        else:
            assert np.mean(got == want) >= 0.999, name


# ----------------------------------------------------------------- codecs
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (13, 11, 3), (3, 17, 3)])
def test_png_decodes_to_its_input(tmp_path, rng, shape):
    img = rng.randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "port.png"), img)
    decoded = Image.open(str(tmp_path / "port.png"))
    assert decoded.mode == ("L" if len(shape) == 2 else "RGB")
    assert np.array_equal(np.array(decoded), img)
    Image.fromarray(img).save(str(tmp_path / "pil.png"))
    assert np.array_equal(np.array(Image.open(str(tmp_path / "pil.png"))), img)


def test_png_rejects_what_it_cannot_write(tmp_path):
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "x.png"), np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 4), np.uint8))


def test_ply_writer_bytes_equal_jax(tmp_path, rng):
    chunks = [(rng.randn(n, 3).astype(np.float32), rng.randint(0, 256, (n, 3)).astype(np.uint8))
              for n in (5, 0, 17)]
    paths = []
    for name, cls in (("port", PlyWriter), ("jax", jax_ply.PlyWriter)):
        path = str(tmp_path / f"{name}.ply")
        writer = cls(path)
        for xyz, rgb in chunks:
            writer.add(xyz, rgb)
        assert writer.close() == 22
        paths.append(path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    xyz, rgb = read_ply(paths[0])
    assert np.array_equal(xyz, np.concatenate([c[0] for c in chunks]))
    assert np.array_equal(rgb, np.concatenate([c[1] for c in chunks]))


def test_write_ply_reads_back_in_both_packages(tmp_path, rng):
    xyz = rng.randn(9, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (9, 3)).astype(np.uint8)
    write_ply(str(tmp_path / "a.ply"), xyz, rgb)
    for reader in (read_ply, jax_ply.read_ply):
        got_xyz, got_rgb = reader(str(tmp_path / "a.ply"))
        assert np.array_equal(got_xyz, xyz) and np.array_equal(got_rgb, rgb)
    with pytest.raises(ValueError):
        write_ply(str(tmp_path / "b.ply"), xyz[:, :2], rgb)
