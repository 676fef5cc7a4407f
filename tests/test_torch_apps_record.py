"""The port's recorder (silent_speech_tpu_torch/apps/record.py) against the
JAX package's, headless.

- The ``record`` command of both CLIs in process with ``sim=48`` (the
  same fake camera and face track): the same clips, the features within
  the feature bars (tests/test_features.py's 2e-4 / 1e-4; they are the
  same numpy, so bitwise in fact), the ROIs bitwise, the same label,
  speaker and landmark indices, in the reference npz schema.
- The recorder's modes through each package's app with a scripted
  session: the word keys, the dynamic lower-face selection (span-norm
  features, 2K+1 wide) and the EMA-stabilized ROI (recorder v2), each
  clip as the JAX recorder's.
"""

import glob
import os

import numpy as np
import pytest

from silent_speech_tpu.apps import cli as jcli
from silent_speech_tpu.apps import record as jrecord
from silent_speech_tpu.core.config import RecorderConfig as JRecorderConfig
from silent_speech_tpu.runtime import fakes as jfakes
from silent_speech_tpu_torch.apps import cli
from silent_speech_tpu_torch.apps import record
from silent_speech_tpu_torch.core.config import RecorderConfig
from silent_speech_tpu_torch.core.schema import load_clip
from silent_speech_tpu_torch.runtime import fakes
from torch_threads import one_blas_thread  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BAR_FEAT, REL_FEAT = 2e-4, 1e-4


def _clips(d):
    return [load_clip(p) for p in sorted(glob.glob(os.path.join(d, "*.npz")))]


def _same_clips(got_dir, want_dir):
    got, want = _clips(got_dir), _clips(want_dir)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.label, g.speaker) == (w.label, w.speaker)
        np.testing.assert_array_equal(g.idxs, w.idxs)
        assert g.X.dtype == np.float32 and g.X.shape == w.X.shape
        np.testing.assert_allclose(g.X, w.X, atol=BAR_FEAT, rtol=REL_FEAT)
        np.testing.assert_array_equal(g.X, w.X)  # the same numpy path
        if w.roi is None:
            assert g.roi is None
        else:
            assert g.roi.dtype == np.uint8
            np.testing.assert_array_equal(g.roi, w.roi)
    return got


def test_record_cli_clips_as_jax(tmp_path, capsys):
    args = ["record", "speaker=sim", "sim=48"]
    assert jcli.main(args + [f"out_dir={tmp_path / 'jax'}"]) == 0
    assert cli.main(args + [f"out_dir={tmp_path / 'port'}",
                            "device=cpu"]) == 0
    assert capsys.readouterr().out.count("saved sim_yes_") == 2
    clips = _same_clips(tmp_path / "port", tmp_path / "jax")
    assert clips[0].X.shape[1] == 180 and clips[0].roi.shape[1:] == (48, 96)


@pytest.mark.parametrize("mode", [
    dict(),  # the word keys: '2' selects 'no'
    dict(idxs_mode="dynamic", save_roi=False),
    dict(roi_ema_alpha=0.3)])
def test_record_modes_as_jax(tmp_path, mode):
    n = 40
    keys = [fakes.NO_KEY] * n
    keys[1], keys[6], keys[33] = ord("2"), ord("r"), ord("r")
    faces = fakes.face_track(n, open_seq=[6.0 + (i % 9) for i in range(n)])
    faces[3] = None  # a face loss before recording (the EMA resets)
    for name, app, cfg_cls, fk in (
            ("port", lambda c: record.main(c, device="cpu"), RecorderConfig,
             fakes),
            ("jax", jrecord.main, JRecorderConfig, jfakes)):
        cfg = cfg_cls(out_dir=str(tmp_path / name), speaker="sim",
                      min_frames=5, **mode)
        with fk.sim_session(keys=keys, n_frames=n, faces=faces):
            app(cfg)
    clips = _same_clips(tmp_path / "port", tmp_path / "jax")
    assert clips[0].label == "no"
    if mode.get("idxs_mode") == "dynamic":
        assert clips[0].X.shape[1] == 2 * len(clips[0].idxs) + 1
