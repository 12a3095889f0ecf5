"""DecoderTuning: the shipped profile is the source of truth — env vars
are overrides, and the YAML profile reproduces the code
defaults exactly."""

import os

import pytest

from lteax.phy.tuning import DecoderTuning


CLEAN = {k: None for k in DecoderTuning._ENV}


def _clear_env(monkeypatch):
    for var in DecoderTuning._ENV:
        monkeypatch.delenv(var, raising=False)


def test_from_env_clean_equals_defaults(monkeypatch):
    _clear_env(monkeypatch)
    assert DecoderTuning.from_env() == DecoderTuning()


def test_yaml_profile_reproduces_defaults():
    path = os.path.join(os.path.dirname(__file__), "..",
                        "configs", "tuning_default.yaml")
    assert DecoderTuning.from_yaml(path) == DecoderTuning()


def test_env_overrides(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("LTEAX_PALLAS_WIN", "64")
    monkeypatch.setenv("LTEAX_PALLAS_DTYPE", "f32")
    monkeypatch.setenv("LTEAX_LAYOUT_GLUE", "0")
    monkeypatch.setenv("LTEAX_RETRY_M", "0")
    monkeypatch.setenv("LTEAX_TURBO_IMPL", "plain")
    t = DecoderTuning.from_env()
    assert (t.win, t.mdtype, t.layout_glue, t.retry_m, t.turbo_impl) == \
        (64, "f32", False, 0, "plain")
    # untouched fields keep defaults
    assert t.acq == DecoderTuning().acq


def test_dict_roundtrip_and_unknown_key():
    t = DecoderTuning()
    assert DecoderTuning.from_dict(t.to_dict()) == t
    with pytest.raises(ValueError, match="unknown tuning keys"):
        DecoderTuning.from_dict({"nope": 1})


def test_early_crc_selection():
    t = DecoderTuning()
    assert t.early_crc(True) == "24B"
    assert t.early_crc(False) == "24A"
    from dataclasses import replace
    assert replace(t, earlystop=False).early_crc(True) is None
