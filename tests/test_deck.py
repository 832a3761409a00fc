"""The deck loader (io/deck.py) against PyYAML, and its refusals."""
import glob
import json
import os

import pytest

from lammps_buck_intel_tpu.io.deck import DeckError, load_deck, parse_deck

DECKS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "examples", "decks", "*.yaml")))


def test_every_deck_is_covered():
    assert len(DECKS) == 14


@pytest.mark.parametrize("path", DECKS, ids=os.path.basename)
def test_deck_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = load_deck(path)
    assert got == ref
    # same scalar types too (1 vs 1.0 vs "1"): JSON spells them apart
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_subset_features():
    text = (
        'a: "x # not a comment"  # a comment\n'
        "b:\n- 1\n- [2, 3.5e-4]\n"
        "c: 'it''s'\n"
        "d: {e: [1, {f: null}],\n    g: -.5}\n"
        "h:\n  i: true\n  j: ~\n")
    assert parse_deck(text) == {
        "a": "x # not a comment", "b": [1, [2, 3.5e-4]], "c": "it's",
        "d": {"e": [1, {"f": None}], "g": -0.5},
        "h": {"i": True, "j": None}}


@pytest.mark.parametrize("text", [
    "a: &anchor 1",            # anchors
    "a: *alias",               # aliases
    "a: !tag 1",               # tags
    "a: |\n  block",           # block scalars
    "---\na: 1",               # document markers
    "a: yes",                  # YAML 1.1 boolean spellings
    "a: off",
    "a: 1\na: 2",              # duplicate keys
    "a: {b: 1, b: 2}",
    "a:\n  - b: 1",            # block map inside a list item
    "a: [1, 2",                # unclosed flow collection
    "a:\n\tb: 1",              # tab indentation
    "- 1\n- 2",                # top level not a map
    "a: 1\n  b: 2",            # stray indentation
])
def test_outside_the_subset_raises(text):
    with pytest.raises(DeckError):
        parse_deck(text)


def test_load_deck_names_the_file(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("units: metal\nfixes: [{name: nve}\n")
    with pytest.raises(DeckError, match="bad.yaml"):
        load_deck(str(p))
