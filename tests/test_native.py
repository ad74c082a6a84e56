"""Native C++ components must match the numpy implementations exactly."""

import os

import numpy as np
import pytest

from obvi_slam_tpu import native


@pytest.mark.skipif(not native.available(), reason="native lib not built")
class TestPairPlanNative:
    def test_matches_numpy_exactly(self):
        rng = np.random.default_rng(2)
        n = 5000
        block = rng.integers(0, 60, n)
        land = rng.integers(0, 800, n)
        mask = rng.random(n) > 0.1

        from obvi_slam_tpu.solver.schur import _build_pairs

        native_out = _build_pairs(block, land, mask)
        os.environ["OBVI_NATIVE"] = "0"
        try:
            # Force-reset the lazy loader so the env var takes effect.
            native._lib = None
            numpy_out = _build_pairs(block, land, mask)
        finally:
            os.environ["OBVI_NATIVE"] = "1"
            native._lib = None
        assert len(native_out) == len(numpy_out)
        for i, (a, b) in enumerate(zip(native_out, numpy_out)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"field {i}")

    def test_empty(self):
        from obvi_slam_tpu.solver.schur import _build_pairs

        out = _build_pairs(
            np.zeros(4, np.int64), np.zeros(4, np.int64), np.zeros(4, bool)
        )
        assert out[3].sum() == 0  # no live pairs


@pytest.mark.skipif(not native.available(), reason="native lib not built")
class TestOrbLoaderNative:
    def test_parses_frame_files(self, tmp_path):
        f1 = tmp_path / "000003.txt"
        f1.write_text("3\n0 0 0 0 0 0 1\n7 1 100.5 200.25 2 110.0 201.0\n9 1 50 60\n")
        f2 = tmp_path / "000004.txt"
        f2.write_text("4\n0 0 0 0 0 0 1\n7 1 101.5 199.0\n")
        out = native.load_orb_observations_native([str(f1), str(f2)])
        assert out is not None
        feat, frame, cam, px, py = out
        assert len(feat) == 4
        np.testing.assert_array_equal(feat, [7, 7, 9, 7])
        np.testing.assert_array_equal(frame, [3, 3, 3, 4])
        np.testing.assert_array_equal(cam, [1, 2, 1, 1])
        np.testing.assert_allclose(px, [100.5, 110.0, 50.0, 101.5])

    def test_matches_python_reader(self, tmp_path):
        # Full directory equivalence against io.readers.
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
        from obvi_slam_tpu.synthetic import export_session, make_object_session

        data, gt_poses, _ = make_object_session(n_frames=6, seed=50)
        export_session(data, gt_poses, tmp_path)
        from obvi_slam_tpu.io.readers import read_orb_output_directory

        tracks_py, init_py = read_orb_output_directory(str(tmp_path / "orb_out"))
        paths = sorted(
            str(p)
            for p in (tmp_path / "orb_out").glob("*.txt")
        )
        feat, frame, cam, px, py = native.load_orb_observations_native(paths)
        # Rebuild track dict from flat arrays and compare.
        tracks_nat = {}
        for i in range(len(feat)):
            tracks_nat.setdefault(int(feat[i]), {}).setdefault(int(frame[i]), {})[
                int(cam[i])
            ] = (px[i], py[i])
        # Python reader drops single-observation features and ones without
        # init estimates; apply the same filter for comparison.
        tracks_nat = {
            f: t for f, t in tracks_nat.items() if f in tracks_py
        }
        assert set(tracks_nat) == set(tracks_py)
        for f in tracks_py:
            assert set(tracks_nat[f]) == set(tracks_py[f])
            for fr in tracks_py[f]:
                for c in tracks_py[f][fr]:
                    np.testing.assert_allclose(
                        tracks_nat[f][fr][c], tracks_py[f][fr][c], rtol=1e-12
                    )
