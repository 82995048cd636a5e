"""chip_smoke.py phases d (System facade) and f (four-device GBA) on the
CPU at a tiny size; phase f runs on four of the virtual CPU devices."""

import numpy as np
import pytest

import chip_smoke as cs


def test_phase_d_facade_tiny(tmp_path):
    out = cs.phase_facade(cs.TINY, str(tmp_path / "traj.txt"), n_frames=8)
    assert out["lines"] == 8 and out["finite"]


@pytest.mark.parametrize("from_saved", [False, True])
def test_phase_f_four_devices_tiny(tmp_path, from_saved):
    state = None
    if from_saved:
        state = str(tmp_path / "state.npz")
        st = cs.save_four_card_state(state, cs.TINY, 40)
    a = cs.phase_four_cards_atlas(atlas=(16, 1024, 64))
    i = cs.phase_four_cards_inertial(stream_size=cs.TINY, stream_frames=40,
                                     state=state)
    assert i["from_saved_state"] == from_saved
    if from_saved:
        assert i["n_kf"] == st["n_keyframes"]
    assert a["moved_m"] > 10 * cs.FOUR_CARD_TOL_M
    assert a["max_kf_delta_m"] < cs.FOUR_CARD_TOL_M
    assert i["imu_initialized"] and i["moved_m"] > 0
    assert i["max_kf_delta_m"] < cs.FOUR_CARD_TOL_M
    assert np.isfinite(list(a["chi2"].values())).all()
