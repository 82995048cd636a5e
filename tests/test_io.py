"""IO tests: native PNG loader + prefetch stream, serialization, trajectory
formats, atlas merge, EuRoC loader."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from PIL import Image

from openmavis_jax.geometry import lie
from openmavis_jax.io import datasets, serialization, trajectory
from openmavis_jax.slam_map import atlas, map_state as ms


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        p = str(d / f"{i:06d}.png")
        Image.fromarray(img, "L").save(p)
        paths.append((p, img))
    return paths


class TestNativeLoader:
    def test_decode_matches_pil(self, png_dir):
        from openmavis_jax.io import native_loader
        dec = native_loader.NativeDecoder()
        for p, gt in png_dir[:3]:
            img = dec.decode(p)
            assert img is not None
            np.testing.assert_array_equal(img.astype(np.uint8), gt)

    def test_stream_ordered(self, png_dir):
        from openmavis_jax.io import native_loader
        paths = [p for p, _ in png_dir]
        stream = native_loader.FrameStream(paths, 64, 48, n_threads=3,
                                           capacity=4)
        outs = list(stream)
        assert len(outs) == len(paths)
        for out, (_, gt) in zip(outs, png_dir):
            np.testing.assert_array_equal(out.astype(np.uint8), gt)
        stream.close()


class TestSerialization:
    def test_roundtrip(self, tmp_path):
        m = ms.allocate(4, 8, 16)
        m = m._replace(mp_pos=m.mp_pos.at[0].set(jnp.asarray([1., 2., 3.])),
                       n_mp=jnp.asarray(1, jnp.int32))
        path = str(tmp_path / "map.npz")
        cfg = {"n_features": 8}
        serialization.save_map(path, m, cfg)
        m2 = serialization.load_map(path, cfg)
        np.testing.assert_array_equal(np.asarray(m2.mp_pos),
                                      np.asarray(m.mp_pos))
        assert int(m2.n_mp) == 1

    def test_config_hash_mismatch(self, tmp_path):
        m = ms.allocate(2, 4, 8)
        path = str(tmp_path / "map.npz")
        serialization.save_map(path, m, {"a": 1})
        with pytest.raises(ValueError):
            serialization.load_map(path, {"a": 2})


class TestTrajectoryIO:
    def test_tum_roundtrip(self, tmp_path):
        n = 5
        times = np.arange(n) * 0.1
        R = np.asarray(jax.vmap(lie.so3_exp)(
            0.1 * jax.random.normal(jax.random.PRNGKey(0), (n, 3))))
        t = np.random.default_rng(1).normal(size=(n, 3))
        path = str(tmp_path / "traj.txt")
        trajectory.save_tum(path, times, R, t)
        t2, pos, quat = trajectory.load_tum(path)
        np.testing.assert_allclose(t2, times, atol=1e-5)
        np.testing.assert_allclose(pos, t, atol=1e-5)

    def test_euroc_format(self, tmp_path):
        times = np.asarray([1.5])
        R = np.eye(3)[None]
        t = np.asarray([[1.0, 2.0, 3.0]])
        path = str(tmp_path / "traj.csv")
        trajectory.save_euroc(path, times, R, t)
        line = open(path).read().strip()
        assert line.startswith("1500000000,")


class TestAtlas:
    def test_merge(self):
        a = atlas.Atlas()
        a.create_map(8, 4, 16)
        m1 = a.current_map
        m1 = ms.insert_keyframe(
            m1, 0, jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(3),
            jnp.zeros(3), 0.0, jnp.zeros((4, 2)), jnp.zeros((4, 256),
            jnp.int8), jnp.zeros((4,), jnp.int32), jnp.ones((4,)),
            jnp.zeros((4,), jnp.int32), jnp.ones((4,), bool),
            jnp.asarray([0, 1, -1, -1], jnp.int32))
        m1 = m1._replace(
            mp_pos=m1.mp_pos.at[:2].set(jnp.asarray([[1., 0., 5.],
                                                     [0., 1., 4.]])),
            mp_valid=m1.mp_valid.at[:2].set(True),
            n_mp=jnp.asarray(2, jnp.int32))

        m2 = ms.allocate(8, 4, 16)
        m2 = ms.insert_keyframe(
            m2, 0, jnp.eye(3), jnp.asarray([1.0, 0, 0]), jnp.zeros(3),
            jnp.zeros(3), jnp.zeros(3), 1.0, jnp.zeros((4, 2)),
            jnp.zeros((4, 256), jnp.int8), jnp.zeros((4,), jnp.int32),
            jnp.ones((4,)), jnp.zeros((4,), jnp.int32),
            jnp.ones((4,), bool), jnp.asarray([0, -1, -1, -1], jnp.int32))
        m2 = m2._replace(
            mp_pos=m2.mp_pos.at[:1].set(jnp.asarray([[2., 2., 6.]])),
            mp_valid=m2.mp_valid.at[:1].set(True),
            n_mp=jnp.asarray(1, jnp.int32))

        s = jnp.asarray(2.0)
        R = lie.so3_exp(jnp.asarray([0.0, 0.0, 0.5]))
        t = jnp.asarray([1.0, -1.0, 0.0])
        merged, ok = atlas.merge_maps(m1, m2, s, R, t)
        assert ok
        assert int(merged.n_kf) == 2
        assert int(merged.n_mp) == 3
        # src landmark transformed: 2 R p + t
        expect = 2.0 * R @ jnp.asarray([2., 2., 6.]) + t
        np.testing.assert_allclose(np.asarray(merged.mp_pos[2]),
                                   np.asarray(expect), atol=1e-5)
        # src KF observation re-indexed to the appended landmark id
        assert int(merged.kf_obs[1, 0]) == 2


class TestEuRoCLoader:
    def test_load_sequence(self, tmp_path):
        # build a tiny EuRoC-layout dataset
        rng = np.random.default_rng(2)
        mav = tmp_path / "seq" / "mav0"
        for cam in ["cam0"]:
            (mav / cam / "data").mkdir(parents=True)
            with open(mav / cam / "data.csv", "w") as f:
                for i in range(3):
                    ns = int(1e9 * (10 + i * 0.05))
                    name = f"{ns}.png"
                    img = rng.integers(0, 255, (32, 40), np.uint8)
                    Image.fromarray(img, "L").save(
                        str(mav / cam / "data" / name))
                    f.write(f"{ns},{name}\n")
        (mav / "imu0").mkdir(parents=True)
        with open(mav / "imu0" / "data.csv", "w") as f:
            for i in range(20):
                ns = int(1e9 * (10 + i * 0.005))
                f.write(f"{ns},0.1,0.2,0.3,0.0,0.0,9.81\n")

        seq = datasets.load_euroc(str(tmp_path / "seq"), cams=("cam0",))
        assert seq.n_frames == 3
        assert seq.n_cams == 1
        fr = seq.frame(0)
        assert fr.shape == (1, 32, 40)
        imu = seq.imu_between(10.0, 10.02)
        assert len(imu) == 4
        np.testing.assert_allclose(imu[0, 1:4], [0.1, 0.2, 0.3])


class TestKittiLoader:
    def test_load_sequence(self, tmp_path):
        """KITTI odometry layout: times.txt + image_0/000000.png
        (reference: Examples/Stereo/stereo_kitti.cc LoadImages)."""
        rng = np.random.default_rng(4)
        seq_dir = tmp_path / "00"
        for cam in ["image_0", "image_1"]:
            (seq_dir / cam).mkdir(parents=True)
            for i in range(4):
                img = rng.integers(0, 255, (24, 30), np.uint8)
                Image.fromarray(img, "L").save(
                    str(seq_dir / cam / f"{i:06d}.png"))
        with open(seq_dir / "times.txt", "w") as f:
            for i in range(4):
                f.write(f"{i * 0.1:.6e}\n")

        seq = datasets.load_kitti(str(seq_dir), cams=("image_0", "image_1"))
        assert seq.n_frames == 4
        assert seq.n_cams == 2
        fr = seq.frame(2)
        assert fr.shape == (2, 24, 30)
        np.testing.assert_allclose(seq.cam_times,
                                   [0.0, 0.1, 0.2, 0.3], atol=1e-9)
        assert seq.imu_between(0.0, 1.0).shape == (0, 7)

    def test_tumvi_alias(self, tmp_path):
        """TUM-VI ships the EuRoC mav0 layout; the loader delegates."""
        rng = np.random.default_rng(5)
        mav = tmp_path / "room1" / "mav0"
        (mav / "cam0" / "data").mkdir(parents=True)
        with open(mav / "cam0" / "data.csv", "w") as f:
            for i in range(2):
                ns = int(1e9 * (5 + i * 0.05))
                name = f"{ns}.png"
                img = rng.integers(0, 255, (16, 16), np.uint8)
                Image.fromarray(img, "L").save(
                    str(mav / "cam0" / "data" / name))
                f.write(f"{ns},{name}\n")
        (mav / "imu0").mkdir(parents=True)
        with open(mav / "imu0" / "data.csv", "w") as f:
            f.write(f"{int(5e9)},0.0,0.0,0.0,0.0,0.0,9.81\n")
        seq = datasets.load_tumvi(str(tmp_path / "room1"))
        assert seq.n_frames == 2
        assert seq.frame(0).shape == (1, 16, 16)


def test_atlas_multi_map_roundtrip(tmp_path):
    """Whole-Atlas checkpoint: N maps + current index survive a save/load
    cycle (reference: System::SaveAtlas/LoadAtlas serialize the full
    Atlas, src/System.cc:1420-1556)."""
    from openmavis_jax.io import serialization
    from openmavis_jax.slam_map import atlas as atlas_mod
    from openmavis_jax.slam_map import map_state as ms

    atlas = atlas_mod.Atlas()
    for i in range(3):
        atlas.create_map(max_kf=4, max_feat=16, max_mp=32)
        m = atlas.current_map
        atlas.current_map = m._replace(
            kf_t=m.kf_t.at[0].set(jnp.asarray([float(i), 0.0, 0.0])),
            n_kf=jnp.asarray(i + 1, jnp.int32))
    atlas.current = 1
    path = str(tmp_path / "atlas.npz")
    serialization.save_atlas(path, atlas, {"sensor": "IMU_MULTI"})

    maps, current = serialization.load_atlas(path,
                                             {"sensor": "IMU_MULTI"})
    assert len(maps) == 3 and current == 1
    for i, m in enumerate(maps):
        assert int(m.n_kf) == i + 1
        assert float(m.kf_t[0, 0]) == float(i)

    # config-hash binding still enforced
    with pytest.raises(ValueError):
        serialization.load_atlas(path, {"sensor": "MONOCULAR"})

    # a single-map checkpoint loads as a 1-map atlas (back compat)
    mpath = str(tmp_path / "one.npz")
    serialization.save_map(mpath, maps[2], {"sensor": "IMU_MULTI"})
    maps1, cur1 = serialization.load_atlas(mpath,
                                           {"sensor": "IMU_MULTI"})
    assert len(maps1) == 1 and cur1 == 0
    assert int(maps1[0].n_kf) == 3
