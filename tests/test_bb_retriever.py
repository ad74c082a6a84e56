"""Detector-querier tests: subprocess JSON-RPC protocol, corner validation,
worker crash regeneration, and precomputed-preference in the runner hook
(bounding_box_retriever.h semantics without ROS)."""

import os
import stat
import sys
import textwrap

import numpy as np
import pytest

from obvi_slam_tpu.frontend.bb_retriever import (
    PrecomputedBoundingBoxRetriever,
    SubprocessDetectorQuerier,
    make_bb_frontend_hook_with_querier,
)


def write_worker(tmp_path, body):
    path = tmp_path / "fake_detector.py"
    path.write_text(
        "#!/usr/bin/env python\nimport json, sys\n" + textwrap.dedent(body)
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return [sys.executable, str(path)]


ECHO_WORKER = """
for line in sys.stdin:
    req = json.loads(line)
    dets = [
        {"label": "chair", "conf": 0.9, "xyxy": [10, 20, 110, 220]},
        {"label": "bench", "conf": 0.8, "xyxy": [-5, 20, 110, 220]},
        {"label": "couch", "conf": 0.7, "xyxy": [10, 20, 6000, 220]},
    ]
    print(json.dumps({"detections": dets}), flush=True)
"""


def provider(frame_id, camera_id):
    return f"/tmp/img_{frame_id}_{camera_id}.png", (480, 640)


class TestSubprocessQuerier:
    def test_query_and_corner_validation(self, tmp_path):
        q = SubprocessDetectorQuerier(write_worker(tmp_path, ECHO_WORKER), provider)
        try:
            bbs = q.retrieve_bounding_boxes_for_image(3, 1)
            # Negative corner and > width corner discarded (reference :88-104).
            assert len(bbs) == 1
            bb = bbs[0]
            assert bb.semantic_class == "chair"
            assert bb.detection_confidence == pytest.approx(0.9)
            # xyxy [10,20,110,220] -> internal [x_min, x_max, y_min, y_max].
            np.testing.assert_array_equal(bb.corners, [10, 110, 20, 220])
        finally:
            q.close()

    def test_per_frame_multi_camera(self, tmp_path):
        q = SubprocessDetectorQuerier(write_worker(tmp_path, ECHO_WORKER), provider)
        try:
            by_cam = q.retrieve_bounding_boxes(5, [1, 2])
            assert set(by_cam) == {1, 2}
            assert all(len(v) == 1 for v in by_cam.values())
        finally:
            q.close()

    def test_worker_crash_regeneration(self, tmp_path):
        # Worker answers one request then exits; the querier must regenerate
        # it (regenerateClient, :127-143) and keep answering.
        body = """
        count = 0
        for line in sys.stdin:
            req = json.loads(line)
            print(json.dumps({"detections": [
                {"label": "chair", "conf": 0.5, "xyxy": [1, 2, 3, 4]}]}),
                flush=True)
            count += 1
            if count >= 1:
                sys.exit(0)
        """
        q = SubprocessDetectorQuerier(write_worker(tmp_path, body), provider)
        try:
            for _ in range(3):
                bbs = q.retrieve_bounding_boxes_for_image(0, 1)
                assert bbs is not None and len(bbs) == 1
        finally:
            q.close()

    def test_missing_image_returns_none(self, tmp_path):
        q = SubprocessDetectorQuerier(
            write_worker(tmp_path, ECHO_WORKER), lambda f, c: None
        )
        try:
            assert q.retrieve_bounding_boxes_for_image(0, 1) is None
            assert q.retrieve_bounding_boxes(0, [1]) == {}
        finally:
            q.close()


class TestHookIntegration:
    def test_precomputed_preferred_querier_fallback(self, tmp_path):
        from obvi_slam_tpu.synthetic import make_object_session
        from test_bb_frontend import make_frontend, object_config

        data, gt_poses, gt_objects = make_object_session()
        pre = PrecomputedBoundingBoxRetriever(data)
        assert pre.retrieve_bounding_boxes(0) is not None

        calls = []

        class FakeQuerier:
            def retrieve_bounding_boxes(self, frame_id, camera_ids):
                calls.append(frame_id)
                return {}

        class FakeFrontend:
            added = []

            def add_bounding_box_observations(self, f, c, bbs, observed):
                self.added.append((f, c, len(bbs)))

        fe = FakeFrontend()
        hook = make_bb_frontend_hook_with_querier(fe, FakeQuerier(), [1])
        # Frame 0 has precomputed detections -> no querier call.
        hook(data, None, 0)
        assert calls == []
        assert fe.added, "precomputed detections must flow to the frontend"
        # An unknown frame falls back to the querier and caches the result.
        missing = max(data.bounding_boxes) + 100
        hook(data, None, missing)
        assert calls == [missing]
        hook(data, None, missing)
        assert calls == [missing], "querier result must be cached in the data"


class TestExtractAllBoundingBoxesCli:
    def test_images_to_csv_roundtrip(self, tmp_path):
        import subprocess
        from pathlib import Path

        from obvi_slam_tpu.io.readers import read_bounding_boxes_by_node_id

        repo = Path(__file__).parent.parent
        images = tmp_path / "images"
        for cam in (1, 2):
            (images / str(cam)).mkdir(parents=True)
            for frame in range(3):
                (images / str(cam) / f"{frame}.png").write_bytes(b"fake")
        worker = write_worker(tmp_path, ECHO_WORKER)
        out_csv = tmp_path / "bbs.csv"
        r = subprocess.run(
            [sys.executable, str(repo / "cli" / "extract_all_bounding_boxes.py"),
             "--images_dir", str(images),
             "--detector_command", " ".join(worker),
             "--output_file", str(out_csv)],
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        bbs = read_bounding_boxes_by_node_id(str(out_csv))
        assert set(bbs) == {0, 1, 2}
        assert set(bbs[0]) == {1, 2}
        bb = bbs[0][1][0]
        assert bb.semantic_class == "chair"
        np.testing.assert_array_equal(bb.corners, [10, 110, 20, 220])
