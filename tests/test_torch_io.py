"""The port's numpy codecs against the JAX package's (exact: same bytes,
same arrays)."""
import numpy as np
import pytest

from itermvs_tpu import io as jax_io
from itermvs_tpu_torch import io as port_io


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (4, 6, 3)])
def test_pfm_roundtrips_across_packages(tmp_path, rng, shape):
    img = rng.randn(*shape).astype(np.float32)
    port_io.save_pfm(str(tmp_path / "port.pfm"), img)
    jax_io.save_pfm(str(tmp_path / "jax.pfm"), img)
    assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "jax.pfm").read_bytes()
    got, scale = port_io.read_pfm(str(tmp_path / "jax.pfm"))
    want, _ = jax_io.read_pfm(str(tmp_path / "port.pfm"))
    assert scale == 1.0 and np.array_equal(got, want)
    assert np.array_equal(got.reshape(img.shape), img)


def test_pfm_rejects_bad_input(tmp_path):
    with pytest.raises(TypeError):
        port_io.save_pfm(str(tmp_path / "x.pfm"), np.zeros((2, 2)))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n2 2\n-1.0\n")
    with pytest.raises(ValueError, match="not a PFM"):
        port_io.read_pfm(str(tmp_path / "bad.pfm"))


@pytest.mark.parametrize("interval", [None, 0.5])
def test_cam_file_matches_jax_reader(tmp_path, rng, interval):
    K = rng.rand(3, 3).astype(np.float32) * 100
    E = rng.rand(4, 4).astype(np.float32)
    path = str(tmp_path / "cam.txt")
    jax_io.write_cam_file(path, K, E, 425.0, 935.0, interval,
                          192 if interval else None)
    got = port_io.read_cam_file(path)
    want = jax_io.read_cam_file(path)
    assert got[2:] == want[2:] == (425.0, 935.0)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_pair_file_matches_jax_reader(tmp_path):
    path = str(tmp_path / "pair.txt")
    jax_io.write_pair_file(path, [(0, [(1, 9.5), (2, 3.0)]), (1, []),
                                  (2, [(0, 1.0)])])
    assert port_io.read_pair_file(path) == jax_io.read_pair_file(path) == [
        (0, [1, 2]), (2, [0])]
