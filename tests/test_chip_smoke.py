"""chip_smoke.py on the CPU: its device gate, its last-line contract,
its phase selection and comparison helpers, and every phase rehearsed at
small sizes (the chip run uses the sizes in CHIP_SIZES)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SMALL = {
    "vp": 22,
    "vp_large": 40,
    "smooth_check": 16,
    "smooth_rate": (12,),
    "poisson": 24,
    "four_vp": 24,
    "four_poisson": 32,
}


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


def _run_script(cwd, *args):
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args],
        cwd=cwd, env=_cpu_env(), capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--four",)], ids=["one", "four"])
def test_gate_exits_nonzero_without_gpu(args):
    r = _run_script(REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_final_line_schema():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = cs.final_line(dev)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line) == {"ok": True, "device": dev}


def test_four_selects_only_its_phases():
    one, four = cs.select_phases(False), cs.select_phases(True)
    assert four == cs.FOUR_CARD_PHASES and one == cs.ONE_CARD_PHASES
    assert not set(one) & set(four)
    assert set(one) | set(four) == set(cs.PHASES)


@pytest.mark.parametrize("four", [False, True], ids=["one", "four"])
def test_main_runs_selected_phases_then_prints_last_line(
    four, monkeypatch, capsys
):
    """main() with the device gate passed: the selected phases run, and
    the device line with the JAX device count comes last."""
    from ndsm_tpu.utils import device

    ran = []
    monkeypatch.setattr(device, "require_gpu", lambda: None)
    monkeypatch.setattr(device, "setup_compile_cache", lambda: "<cache>")
    monkeypatch.setattr(cs, "run_phases", lambda names, sizes, card: ran.extend(names))
    rc = cs.main(["--four"] if four else [])
    assert rc == 0
    assert tuple(ran) == cs.select_phases(four)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    obj = json.loads(last)
    assert obj["ok"] is True
    assert obj["device"] == device.device_record()


def test_gate_raises_and_helpers():
    assert cs.max_abs_diff([1.0, 2.0], [1.0, 2.5]) == 0.5
    assert cs.rel_max_diff([1.0, 2.0], [1.0, 4.0]) == 0.5
    assert cs.rel_max_diff([0.0], [0.0]) == 0.0
    cs.gate(True, "holds")
    with pytest.raises(cs.GateFailed):
        cs.gate(False, "does not hold")


def test_failing_phase_raises_without_final_line(monkeypatch, capsys):
    """A phase whose gate fails propagates: nothing swallows it."""
    from ndsm_tpu.utils import testing

    monkeypatch.setitem(testing.GOLDEN, 22, (1.0, 1.0, 1.0))
    with pytest.raises(cs.GateFailed):
        cs.run_phases(["vp_mixed"], SMALL)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("phase", list(cs.ONE_CARD_PHASES))
def test_one_card_phase_rehearsal(phase):
    cs.run_phases([phase], SMALL, "cpu")


@pytest.mark.parametrize("phase", list(cs.FOUR_CARD_PHASES))
def test_four_card_phase_rehearsal(phase):
    cs.run_phases([phase], SMALL, "cpu")


def test_smoother_rate_fields():
    s = cs.smoother_rate(12, K=2)
    assert s["m"] == 12
    for k in ("gsweeps", "floor_gbs", "copy_gbs", "share_of_copy"):
        assert np.isfinite(s[k]) and s[k] > 0


@pytest.mark.gpu
def test_one_card_phases_on_gpu(gpu_device):
    """Every one-card phase at small sizes on the card itself."""
    cs.run_phases(cs.ONE_CARD_PHASES, SMALL, str(gpu_device))
