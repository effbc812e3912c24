"""The port's config reader and writer against PyYAML and the JAX package.

``skeletondiffusion_tpu_torch.utils.yaml_lite`` stands in for PyYAML, which
the card's machine does not have: here its reader is held to ``yaml.safe_load``
on every file under ``configs/**``; the port's ``load_config`` to the JAX
one on each config tree and each of its group options, with and without
overrides, types included; what ``save_config`` writes reads back equal under
both readers (a ``hypothesis`` round trip), and so does ``yaml.safe_dump``'s
output under ``yaml_lite``; and syntax outside the subset raises with its
line number.  Only this test imports PyYAML and the JAX config module.
"""
import math
import os
import pathlib

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from skeletondiffusion_tpu.utils.config import load_and_merge_autoenc_cfg as jax_merge
from skeletondiffusion_tpu.utils.config import load_config as jax_load_config
from skeletondiffusion_tpu_torch.utils import yaml_lite
from skeletondiffusion_tpu_torch.utils.config import (
    flatten_config,
    load_and_merge_autoenc_cfg,
    load_config,
    save_config,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
YAML_FILES = sorted(p.relative_to(REPO).as_posix() for p in CONFIGS.rglob("*.yaml"))
TREES = ("config_train_autoencoder", "config_train_diffusion", "config_eval")
GROUP_OPTIONS = [(tree, group.name, option.stem)
                 for tree in TREES
                 for group in sorted((CONFIGS / tree).iterdir()) if group.is_dir()
                 for option in sorted(group.glob("*.yaml"))]
OVERRIDES = ["lr=1e-3", "model.lr=1.e-3", "seed=7", "device_mesh.n_devices=null",
             "dataset.data_loader_train.datasets=[ACCAD, 'CMU', \"KIT\"]", "device=cpu",
             "task.history_sec=0.1", "model.num_epochs=2", "extra.flag=yes", "extra.eps=0.5e-2",
             "extra.none=", "extra.text=a b"]


def assert_same(a, b, path="$"):
    """Equal values of equal types, recursively (1 == 1.0 == True is not
    enough: a YAML reader that turns '1e-3' into a float would pass it)."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("path", YAML_FILES)
def test_reader_equals_pyyaml_on_config_file(path):
    text = (REPO / path).read_text()
    assert_same(yaml_lite.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("with_overrides", [False, True], ids=["plain", "overrides"])
@pytest.mark.parametrize("tree,group,option", GROUP_OPTIONS,
                         ids=[f"{t}-{g}-{o}" for t, g, o in GROUP_OPTIONS])
def test_load_config_equals_jax(tree, group, option, with_overrides):
    args = [f"{group}={option}"] + (OVERRIDES if with_overrides else [])
    ours = load_config(str(CONFIGS / tree), args)
    assert_same(ours, jax_load_config(str(CONFIGS / tree), args))
    assert ours[group] is not None
    if with_overrides:
        assert ours["lr"] == "1e-3" and ours["model"]["lr"] == 0.001 and ours["seed"] == 7
        assert ours["device_mesh"]["n_devices"] is None and ours["extra"]["flag"] is True


def test_load_config_unresolved_and_flattened_equal_jax():
    tree = str(CONFIGS / "config_eval")
    assert_same(load_config(tree, ["dataset=freeman"], resolve=False),
                jax_load_config(tree, ["dataset=freeman"], resolve=False))
    cfg = load_config(tree, ["stats_mode=probabilistic"])
    assert cfg["dataset"]["data_loader_test"]["if_load_mmgt"] is True
    assert flatten_config(cfg)["obs_length"] == 30 and flatten_config(cfg)["pred_length"] == 120


def test_merged_stage2_config_equals_jax(tmp_path):
    ae_cfg = flatten_config(load_config(str(CONFIGS / "config_train_autoencoder"),
                                        ["task.pose_box_size=1.2"]))
    save_config(ae_cfg, str(tmp_path / "ae" / "config.yaml"))
    diff = flatten_config(load_config(str(CONFIGS / "config_train_diffusion"),
                                      ["cov_matrix=reachability"]))
    path = str(tmp_path / "ae" / "config.yaml")
    merged = load_and_merge_autoenc_cfg(diff, path)
    assert_same(merged, jax_merge(diff, path))
    assert merged["pose_box_size"] == 1.2 and merged["reachability_matrix_stop_at"] == "hips"


# ---- the writer -----------------------------------------------------------------

SPECIAL = ["1e-3", "yes", "", "-x", "null", "~", "No", "0.5", ".inf", "1:30", "0x1F", "017",
           "- a", "a: b", "# c", "x #y", "'q'", '"d"', "[1]", "{}", "&a", "*b", "!t", "|", ">",
           "%", "@", "`", " lead", "trail ", "a  b", "2001-12-14", "<<", "=", "?", "?x", ":x"]


def strings(alphabet, min_size=0):
    return st.one_of(st.sampled_from([s for s in SPECIAL if len(s) >= min_size]),
                     st.text(alphabet=alphabet, min_size=min_size, max_size=12))


def trees(alphabet, key_min_size=0):
    scalars = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
                        st.floats(allow_nan=False, allow_infinity=False), strings(alphabet))
    keys = strings(alphabet, key_min_size)
    return st.recursive(
        scalars,
        lambda children: st.one_of(st.lists(children, max_size=4),
                                   st.dictionaries(keys, children, max_size=4)),
        max_leaves=20)


# the writer escapes what it must; PyYAML's own writer folds long or
# multi-line strings over lines and writes an empty key as a complex key
# (``? ''``), both outside the subset, so its output is read back on
# single-line text and non-empty keys
PRINTABLE = st.characters(min_codepoint=0x20, max_codepoint=0x7E)
WRITER_ALPHABET = st.one_of(PRINTABLE, st.sampled_from("é\t\n\x85\u2028\x00\x1b\ufeff"))
PYYAML_ALPHABET = st.one_of(PRINTABLE, st.sampled_from("éß"))


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(trees(WRITER_ALPHABET))
def test_save_config_round_trips_under_both_readers(tree):
    text = yaml_lite.dump(tree)
    assert_same(yaml_lite.load(text), tree)
    assert_same(yaml.safe_load(text), tree)


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(trees(PYYAML_ALPHABET, key_min_size=1))
def test_reader_reads_pyyaml_dump(tree):
    assert_same(yaml_lite.load(yaml.safe_dump(tree, sort_keys=False)), tree)


def test_save_config_file_reads_back(tmp_path):
    cfg = {"lr": "1e-3", "eps": 1e-05, "flag": "yes", "empty": "", "neg": "-x", "n": None,
           "datasets": ["ACCAD", "CMU"], "nested": {"a": [{"b": 1}, [2, 3]], "c": {}}}
    path = str(tmp_path / "exp" / "config.yaml")
    save_config(cfg, path)
    text = pathlib.Path(path).read_text()
    for quoted in ("'1e-3'", "'yes'", "''", "'-x'"):
        assert quoted in text, text
    assert_same(yaml_lite.read(path), cfg)
    with open(path) as f:
        assert_same(yaml.safe_load(f), cfg)


# ---- outside the subset -----------------------------------------------------------

UNSUPPORTED = {
    "anchor": "a: &x 1",
    "alias": "a: *x",
    "tag": "a: !!str 1",
    "literal block scalar": "a: |\n  text",
    "folded block scalar": "a: >\n  text",
    "multi-line plain scalar": "a: one\n  two",
    "multi-line quoted scalar": "a: 'one\n  two'",
    "flow mapping": "a: {b: 1}",
    "flow mapping in a sequence": "a: [{b: 1}]",
    "unclosed flow sequence": "a: [1, 2",
    "document marker": "---",
    "directive": "%YAML 1.1",
    "complex key": "? a",
    "tab indentation": "a:\n\tb: 1",
    "timestamp": "a: 2001-12-14",
    "merge key": "<<: 1",
    "mapping value in a plain scalar": "a: b: c",
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_syntax_raises_with_line_number(name):
    text = "ok: 1\n" + UNSUPPORTED[name]
    with pytest.raises(yaml_lite.YAMLError) as err:
        yaml_lite.load(text)
    assert err.value.line is not None and err.value.line >= 2, (name, str(err.value))
    assert str(err.value).startswith(f"line {err.value.line}: ")


def test_reader_keeps_what_pyyaml_keeps():
    """A few resolutions by name: floats need a dot, booleans are YAML 1.1's."""
    text = "a: 1e-3\nb: 1.e-3\nc: 0.5e-2\nd: 0.\ne: on\nf: Off\ng: ~\nh:\ni: 0x10\nj: -.5\n"
    got = yaml_lite.load(text)
    assert_same(got, yaml.safe_load(text))
    assert got["a"] == "1e-3" and got["b"] == 0.001 and got["d"] == 0.0 and got["e"] is True
