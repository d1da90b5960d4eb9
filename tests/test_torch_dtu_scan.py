"""The DTU scan that ``chip_smoke.py`` phase 15 trains on is the same
bytes every time it is written.

``chip_smoke.write_dtu_scan`` renders its views in threads.  Its ray
directions were a float32 matrix product, and such products run
concurrently in several threads gave different bits from run to run (a
band of rays of one view in a few percent of the views written), so the
phase trained on other images now and then (ROADMAP §C, C2).  Without
the repair this test fails intermittently, as it did on that machine and
here; with it the writes agree.
"""
import hashlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as CS  # noqa: E402


def _digests(scan):
    out = {}
    for sub in ("image", "mask"):
        for f in sorted(os.listdir(os.path.join(scan, sub))):
            with open(os.path.join(scan, sub, f), "rb") as fh:
                out[f"{sub}/{f}"] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_dtu_scan_writes_repeat(tmp_path):
    """16 views at the phase's 1,600 x 1,200, written three times by the
    writer's 8 threads: every file byte-equal."""
    runs = []
    for k in range(3):
        scan = str(tmp_path / f"scan{k}")
        CS.write_dtu_scan(scan, 16)
        runs.append(_digests(scan))
    differing = [f for f in runs[0] if len({r[f] for r in runs}) > 1]
    assert not differing, differing


def test_view_dirs_is_the_rotation():
    """``view_dirs`` is ``d @ c2w[:3, :3].T`` (to float32 rounding)."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    c2w = CS._look_at(np.array([0.3, -2.0, 1.1]))
    got = CS.view_dirs(d, c2w)
    want = d.astype(np.float64) @ np.asarray(c2w, np.float64)[:3, :3].T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.dtype == np.float32
