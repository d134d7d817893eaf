"""The CPU-testable parts of chip_smoke.py and of bench.py's peak table:
refusing a non-GPU platform, unknown device kinds, the tolerance check,
the shape of the last line and the phase selection."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import bench
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform, kind="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("platform", ["cpu", "rocm", "none"])
def test_refuses_non_gpu_platform(platform):
    devices = [] if platform == "none" else [_dev(platform)]
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(devices)
    assert e.value.code not in (0, None)


def test_accepts_gpu():
    assert chip_smoke.require_gpu([_dev("gpu")]) is None


def test_peak_table_refuses_unknown_kind():
    with pytest.raises(ValueError, match="no peak bandwidth"):
        bench.peak_bytes_per_s("NVIDIA Imaginary 1GB")


def test_peak_table_knows_the_h100():
    assert bench.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("value,ok", [(0.0, True), (5e-5, True),
                                      (1e-4, True), (2e-4, False),
                                      (float("nan"), False),
                                      (float("inf"), False)])
def test_tolerance_check(value, ok, capsys):
    if ok:
        chip_smoke.check("gap", value, "mu/float32")
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check("gap", value, "mu/float32")
    line = capsys.readouterr().out
    assert "bound 0.0001" in line and ("ok" if ok else "FAIL") in line


def test_every_bound_has_a_reason():
    for key, (bound, reason) in chip_smoke.BOUNDS.items():
        assert 0 < bound < 1 and len(reason) > 20, key


def test_rel_gap():
    assert chip_smoke.rel_gap(101.0, 100.0) == pytest.approx(0.01)


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_shape(count):
    line = chip_smoke.result_line([_dev("gpu")] * count)
    assert "\n" not in line
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": count}}


def test_default_phases():
    assert chip_smoke.select_phases([]) == [
        "device", "mu", "newton", "layouts", "fold_in", "loop"]


def test_four_cards_selects_only_its_phases():
    phases = chip_smoke.select_phases(["--four-cards"])
    assert phases == ["device", "four_cards"]
    assert set(phases) <= set(chip_smoke.PHASES)


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_script_fails_without_gpu_and_prints_no_result():
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_script_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fold_in_reference_is_the_mu_rule(rng):
    """numpy_cmf.fold_in_mu (the fold-in phase's reference) against the
    estimator's transform at float64."""
    from baselines import numpy_cmf
    from pycmf_tpu import CMF

    X = np.abs(rng.rand(20, 11))
    m = CMF(n_components=3, max_iter=5, random_state=0,
            dtype="float64").fit(X)
    U0 = np.abs(rng.rand(6, 3))
    m.set_params(max_iter=12, eval_every=12, tol=0.0)
    got = m.transform(X[:6], U=U0)
    want = numpy_cmf.fold_in_mu(X[:6], m.V_, U0.copy(), n_iter=12)
    np.testing.assert_allclose(got, want, rtol=1e-10)
