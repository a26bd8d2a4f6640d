"""The measurement entry points' device helpers (ndsm_tpu/utils/device.py):
compile-cache location, accelerator gate, card identity."""

import os
import tempfile

import jax
import pytest

from ndsm_tpu.utils import device


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls instead of enabling a persistent
    cache in the test process."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_cache_env_set_is_left_to_jax(monkeypatch, config_calls):
    monkeypatch.setenv(device.CACHE_ENV, "/some/where/cache")
    assert device.setup_compile_cache() == "/some/where/cache"
    assert config_calls == []


def test_cache_env_unset_uses_checkout_path(monkeypatch, config_calls):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    path = device.setup_compile_cache()
    root = device.checkout_root()
    assert path == os.path.join(root, ".jax_cache")
    assert config_calls == [("jax_compilation_cache_dir", path)]
    assert os.path.isfile(os.path.join(root, "ndsm_tpu", "__init__.py"))


def test_cache_path_is_fixed_and_never_temporary(monkeypatch, config_calls):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    a = device.setup_compile_cache()
    b = device.setup_compile_cache()
    assert a == b
    tmp = os.path.realpath(tempfile.gettempdir())
    assert not os.path.realpath(a).startswith(tmp + os.sep)
    assert str(os.getpid()) not in a


def test_cache_path_is_ignored_by_git():
    with open(os.path.join(device.checkout_root(), ".gitignore")) as f:
        lines = {ln.strip() for ln in f}
    assert ".jax_cache/" in lines


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_gpu_identity_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert device.gpu_identity().startswith("nvidia-smi unavailable")


def test_device_record_fields():
    rec = device.device_record()
    assert rec == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
