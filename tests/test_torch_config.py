"""The port's config is a field-for-field copy of the JAX package's."""

import dataclasses

import pytest

from e3dge_torch import config as tc
from e3dge_tpu.utils import config as jc

PRESETS = [
    "default_config",
    "demo_view_synthesis_config",
    "stage1_config",
    "stage2_config",
    "tiny_test_config",
    "tiny_full_config",
]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_trees_equal(name):
    ours, theirs = getattr(tc, name)(), getattr(jc, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.decoder.channels() == theirs.decoder.channels()
    assert ours.decoder.n_latent == theirs.decoder.n_latent


def test_flagship_matches_graft_entry():
    from __graft_entry__ import _flagship_config

    assert dataclasses.asdict(tc.flagship_config()) == dataclasses.asdict(_flagship_config())


def test_validate_rejects_inconsistent_widths():
    bad = tc._with(tc.tiny_test_config(), renderer=dict(width=48))
    with pytest.raises(AssertionError):
        bad.validate()
