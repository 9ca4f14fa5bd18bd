"""One persistent-compilation-cache helper for every entry point: it
leaves JAX_COMPILATION_CACHE_DIR alone when set, and otherwise uses a
fixed <checkout>/.jax_cache."""

from pathlib import Path

import jax
import pytest

from cuclark_tpu import compile_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def config_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_left_untouched(monkeypatch, config_calls, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cc")
    assert config_calls == []
    assert not (tmp_path / "cc").exists()  # JAX creates it, not us


def test_unset_uses_checkout_dir(monkeypatch, config_calls):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert config_calls == [("jax_compilation_cache_dir", want)]
    assert Path(want).is_dir()


def test_entry_points_share_the_helper(monkeypatch):
    """The CLI calls the helper on every invocation; bench.py and
    chip_smoke.py call it and configure no cache of their own."""
    from cuclark_tpu import cli

    seen = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: seen.append(1) or "x")
    assert cli.main(["info", "-D", str(REPO / "no_such_db")]) == 1
    assert seen == [1]
    for script in ("bench.py", "chip_smoke.py"):
        text = (REPO / script).read_text()
        assert "enable_compile_cache()" in text
        assert "jax_compilation_cache_dir" not in text
        assert "JAX_COMPILATION_CACHE_DIR" not in text
