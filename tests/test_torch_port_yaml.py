"""The port's YAML reader and writer (``utils/yaml_io.py``) against PyYAML,
and its config loader (``configs/config.py``) against the JAX package's:
the same trees from both config files and from each snippet, YAML 1.1's
scalar rules included (``1e-3`` a string, ``1.0e-3`` a float, ``yes`` /
``off`` booleans, ``~`` None); constructs outside the subset raise and name
their line; what the writer and ``copy_config`` write reads back equal
under both readers.  Everything compares equal, no tolerance."""

import math
import os

import pytest
import yaml

from mdeical_image_segmentation_tpu.configs import config as jax_config
from mdeical_image_segmentation_tpu_torch.configs import (
    Config,
    apply_overrides,
    copy_config,
    load_config,
)
from mdeical_image_segmentation_tpu_torch.configs import config as port_config
from mdeical_image_segmentation_tpu_torch.utils import yaml_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, "configs", n)
           for n in ("unet3d_train.yml", "unet3d_predict.yml")]


def _same(got, want):
    """Equal, with the same types throughout (True is not 1, 1.0 is not 1)
    and NaN equal to NaN."""
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if type(got) is not type(want):
        return False
    if isinstance(want, dict):
        return (list(got) == list(want)
                and all(_same(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return len(got) == len(want) and all(map(_same, got, want))
    return got == want


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_read_as_pyyaml_reads_them(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_io.load(path), want)


SNIPPETS = [
    "a: 1e-3", "a: 1.0e-3", "a: 1.0e3", "a: 2.5E+4", "a: .5", "a: 0.",
    "a: yes", "a: Yes", "a: NO", "a: off", "a: On", "a: y", "a: true",
    "a: ~", "a: null", "a: Null", "a:", "a: ''", 'a: ""',
    "a: 010", "a: 0x1F", "a: 0b101", "a: 1:30", "a: -1_000", "a: +12",
    "a: 190:20:30.15", "a: .inf", "a: -.Inf", "a: .nan", "a: 00", "a: -0",
    "a: [[1, 2], [3, [4, []]]]", "a: [1, 2, ]", "a: [\n  1,\n  2]",
    "a: [a b, 'c, d', \"e\", 1e-3, 1.0e-3, yes]",
    "x: {a: 1, b: [1, 2], c: {d: ~}}",
    "a: 'it''s'", 'a: "x\\ty\\u00e9\\"q\\\\"',
    "a: \"['/data/train']\"", "a: '# not a comment'",
    "a: plain text here  # a comment", "a: x#y", "a: http://x.y/z",
    "key with space: v", "1: one\ntrue: t\n~: n", "'quoted key': 1",
    "- name: RandomRotate\n  axes: [[2, 1]]\n  angle_spectrum: 30\n"
    "- name: ToTensor\n  expand_dims: true",
    "a:\n- 1\n- 2\nb: 3", "a:\n  - - 1\n    - 2\n  - [3]",
    "- a: 1\n  l:\n  - 2\n  - 3\n- 4", "seq:\n  -\n    a: 1\n  - b",
    "a: 1\nb:\n  c:\n    d: [1]\n  e: f\ng: h", "---\na: 1",
    "1e-3", "false", "", "[1, 2]", "- - 1\n  - 2\n- 3",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_snippets_read_as_pyyaml_reads_them(text):
    assert _same(yaml_io.loads(text), yaml.safe_load(text))


UNSUPPORTED = [
    ("a: &x 1", "anchor"), ("a: *x", "alias"), ("a: !!str 1", "tag"),
    ("a: |\n  x", "block scalar"), ("a: >\n  x", "block scalar"),
    ("a: 1\n---\nb: 2", "documents"), ("a: multi\n  line", "multi-line"),
    ("? a\n: b", "complex keys"), ("%YAML 1.1\n---\na: 1", "directive"),
    ("a: 2001-01-01", "timestamp"), ("a:\n\t- 1", "tab"),
    ("a: [1, 2", "flow"), ("a: 'x", "unterminated"), ("a: -", "sequence"),
    ("a: 1\n  b: 2", "multi-line"),
]


@pytest.mark.parametrize("text,what", UNSUPPORTED)
def test_unsupported_constructs_raise_and_name_the_line(text, what):
    with pytest.raises(yaml_io.YAMLError, match=r"^line \d+: .*" + what):
        yaml_io.loads(text)


@pytest.mark.parametrize("data", [
    {"a": 1e-5, "b": 1e16, "c": 0.0002, "d": -2.5, "e": float("inf"),
     "f": float("nan"), "g": [1, 2.0, "x", None, True]},
    {"s": ["yes", "null", "1e-3", "010", "a: b", "#x", "", " pad", "x y",
           "/data/train", "['/data/train']", "it's", 'q"uote', "é\tñ"]},
    {"model": {"name": "UNet3D", "f_maps": [32, 64]},
     "pipe": [{"name": "RandomRotate", "axes": [[2, 1]], "d": {}},
              {"name": "ToTensor", "e": {"k": [1, {"z": 2}]}}],
     "nested": [[1, [2]], []], "empty": {}, 3: "int key", True: None},
    [{"a": 1}, [1, 2], "x"],
    "scalar", 1.5, None,
])
def test_dumps_reads_back_equal_under_both_readers(data):
    text = yaml_io.dumps(data)
    assert _same(yaml.safe_load(text), data), text
    assert _same(yaml_io.loads(text), data), text


@pytest.mark.parametrize("raw", [
    "1e-3", "1.0e-3", "false", "null", "yes", "[1, 2]", "['/a', '/b']",
    "/data/x.h5", "a b", "{a: 1}", "0.5", "True", "None", "'q'", "1:30",
])
def test_parse_value_matches_jax(raw):
    assert _same(port_config._parse_value(raw),
                 jax_config._parse_value(raw))


def _overrides():
    return ["--loaders.train.file_paths", "['/data/a.h5', '/data/b']",
            "trainer.max_num_iterations=6", "--optimizer.learning_rate",
            "1.0e-3", "--trainer.resume", "null", "--new.section.key", "yes",
            "--loaders.train.slice_builder.patch_shape", "[8, 64, 64]"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    argv = ["--config", path] + _overrides()
    got, want = load_config(argv), jax_config.load_config(argv)
    assert isinstance(got, Config) and _same(dict(got), dict(want))
    assert got["device"] == "auto"
    got = load_config(config_path=path, overrides=["device=cpu"])
    assert got.device == "cpu" and got.model.name == "UNet3D"
    got.model.f_maps = 8  # nested attribute writes reach the tree
    assert got["model"]["f_maps"] == 8


def test_apply_overrides_matches_jax_and_checks_its_input():
    base = {"a": {"b": 1}, "c": [1]}
    got = apply_overrides({"a": {"b": 1}, "c": [1]}, _overrides())
    want = jax_config.apply_overrides(dict(base, a={"b": 1}), _overrides())
    assert _same(got, want)
    with pytest.raises(ValueError, match="missing a value"):
        apply_overrides({}, ["--a.b"])
    with pytest.raises(TypeError, match="not a mapping"):
        apply_overrides({"a": 1}, ["a.b=2"])


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_copy_config_reads_back_equal(path, tmp_path):
    cfg = load_config(["--config", path] + _overrides())
    out = copy_config(cfg, str(tmp_path / "port"), config_path=path)
    jax_out = jax_config.copy_config(
        jax_config.load_config(["--config", path] + _overrides()),
        str(tmp_path / "jax"), config_path=path)
    assert os.path.basename(out) == os.path.basename(jax_out)
    with open(jax_out) as f:
        want = yaml.safe_load(f)
    with open(out) as f:
        assert _same(yaml.safe_load(f), want)
    assert _same(yaml_io.load(out), want)
    assert os.path.exists(os.path.join(str(tmp_path / "port"), "logs",
                                       os.path.basename(path)))
