"""The generator writes the same bytes for a seed, other bytes for
another, and videos that the program's own readers decode to the frames
it returns."""

import filecmp
import os

import numpy as np
import pytest

from benchmark.datapoint import content_index, stratified_shifts, write_datapoint
from benchmark.reference.plain import OPTIONS

SEED = 2**31 + 11


def _write(root, seed, fmt):
    return write_datapoint(str(root), seed=seed, n_cameras=2, image_hw=(64, 96),
                           grid_shape=(21, 17), n_frames=10, n_distinct=6, n_targets=4,
                           max_shift_px=2.0, video_format=fmt, device="cpu",
                           options=OPTIONS)


def _files(root):
    return sorted(f for f in os.listdir(root) if f != "deck.inp")


@pytest.mark.parametrize("fmt", ["mraw12", "cine10"])
def test_same_bytes_for_a_seed(tmp_path, fmt):
    a, b, c = _write(tmp_path / "a", SEED, fmt), _write(tmp_path / "b", SEED, fmt), \
        _write(tmp_path / "c", SEED + 1, fmt)
    names = _files(tmp_path / "a")
    assert names == _files(tmp_path / "b")
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b", names,
                                           shallow=False)
    assert not mismatch and not errors
    assert np.array_equal(a["contents"], b["contents"])
    assert not np.array_equal(a["contents"], c["contents"])


@pytest.mark.parametrize("fmt", ["mraw12", "cine10"])
def test_videos_decode_to_the_contents(tmp_path, fmt):
    from upsp_tpu_torch.io.video import video_reader

    dp = _write(tmp_path, SEED, fmt)
    ext = "mraw" if fmt == "mraw12" else "cine"
    for c in range(2):
        with video_reader(str(tmp_path / f"cam{c + 1:02d}.{ext}")) as r:
            for f in range(dp["n_frames"]):
                got = np.asarray(r.read_frame(f))
                want = dp["contents"][content_index(f, dp["n_distinct"]), c]
                assert np.array_equal(got, want)


def test_every_seed_asks_the_same_shifts():
    a, b = stratified_shifts(16, 2.0, SEED), stratified_shifts(16, 2.0, SEED + 7)
    assert np.array_equal(a[0], [0.0, 0.0])
    ra, rb = np.sort(np.hypot(*a.T)), np.sort(np.hypot(*b.T))
    assert np.allclose(ra, rb) and not np.allclose(a, b)
