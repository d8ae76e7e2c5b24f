"""Golden-snapshot regression tests: pin the numerics of the hot paths
against committed CPU snapshots (tests/golden/goldens.npz, regenerated only
deliberately via tests/golden/make_goldens.py).

The reference pins behavior with example outputs checked by eye; here the
pin is mechanical so cross-round refactors can't silently shift results.
"""
import pathlib
import sys

import numpy as np
import pytest

# by path: an installed package named `tests` would shadow `tests.golden`
sys.path.insert(0, str(pathlib.Path(__file__).parent / "golden"))

import make_goldens as gg  # noqa: E402

GOLD_PATH = pathlib.Path(__file__).parent / "golden" / "goldens.npz"


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(GOLD_PATH))


def test_variational_golden(gold):
    out = gg.golden_variational()
    np.testing.assert_allclose(out["vmt_wx"], gold["vmt_wx"],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(out["vmt_wy"], gold["vmt_wy"],
                               rtol=0, atol=2e-4)
    # occlusion labels are discrete; tiny energy ties may flip isolated
    # pixels under fusion-order drift
    assert (out["vmt_occ"] != gold["vmt_occ"]).mean() < 0.01


def test_distance_transform_golden(gold):
    out = gg.golden_distance_transform()
    np.testing.assert_allclose(out["dt_dist"], gold["dt_dist"],
                               rtol=0, atol=1e-4)
    assert (out["dt_labels"] != gold["dt_labels"]).mean() < 0.01


def test_epic_golden(gold):
    out = gg.golden_epic()
    # the geodesic closest-seed labels are discrete: f32 min-reassociation
    # (e.g. the round-3 quadrant-collapse in epic/distance.py) can flip
    # isolated pixels right on a seed-cell boundary, swapping which side's
    # flow they interpolate from — allow the same <1% drift the DT-label and
    # occlusion goldens do, and require everything else to pin at 1e-3
    diff = np.abs(out["epic_flow"] - gold["epic_flow"]).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01, (diff > 1e-3).mean()
    np.testing.assert_allclose(out["epic_flow"][diff <= 1e-3],
                               gold["epic_flow"][diff <= 1e-3],
                               rtol=0, atol=1e-3)


def test_mrf_golden(gold):
    out = gg.golden_mrf()
    np.testing.assert_array_equal(out["mrf_labels"], gold["mrf_labels"])
    np.testing.assert_array_equal(out["mrf_labels_bp"],
                                  gold["mrf_labels_bp"])
    np.testing.assert_allclose(out["mrf_labels_energy"],
                               gold["mrf_labels_energy"], rtol=1e-5)


def test_accumulate_golden(gold):
    out = gg.golden_accumulate()
    np.testing.assert_allclose(out["acc_flow"], gold["acc_flow"],
                               rtol=0, atol=1e-5)
