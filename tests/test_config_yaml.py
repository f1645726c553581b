"""The YAML subset parser behind config.load_yaml: the shipped profiles
load without PyYAML, parse exactly as PyYAML's safe_load does, and
anything outside the subset is refused."""

import glob
import os
import sys

import pytest

from ohm_tsd_slam.config import SlamConfig, load_yaml, parse_yaml

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_profiles_match_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_scalars_resolve_like_pyyaml():
    yaml = pytest.importorskip("yaml")
    text = """\
top:
  int: 10
  neg: -2
  plus: +3
  float: 0.025
  exp_float: 1.0e-3
  exp_no_dot: 1e-3
  leading_dot: .5
  inf: -.inf
  yes_bool: yes
  true_bool: True
  off_bool: Off
  null_tilde: ~
  empty:
  word: robot0
  slash/key: robot_1
  colon_in_value: a:b
  quoted: 'x # not a comment'
  dq: "3.0"
  commented: 7   # trailing comment
  nested:
    deeper:
      leaf: 1.5
after: 2
"""
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n",                 # block list
    "a: [1, 2]\n",                 # flow list
    "a: {b: 1}\n",                 # flow mapping
    "a: 1\n b: 2\n",               # over-indented sibling
    "a:\n    b: 1\n  c: 2\n",      # dedent to an unknown level
    "just a line\n",               # no key
    "a:\n\tb: 1\n",                # tab indentation
    "a: 1\na: 2\n",                # duplicate key
    "a: 'unterminated\n",          # open quote
    "a: &anchor 1\n",              # anchors
])
def test_malformed_input_is_refused(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_load_yaml_without_pyyaml(monkeypatch):
    """load_yaml never imports PyYAML (absent on some deployments)."""
    monkeypatch.setitem(sys.modules, "yaml", None)   # import -> error
    for path in CONFIGS:
        cfg = load_yaml(path)
        assert isinstance(cfg, SlamConfig)
    single = load_yaml([p for p in CONFIGS if "single" in p][0])
    assert single.grid.map_size == 10
    assert int(single.robots[0].registration.mode) == 3
    double = load_yaml([p for p in CONFIGS if "double" in p][0])
    assert len(double.robots) == 2
    assert double.robots[1].local_offset_x == 0.5
