"""The port's rule tables and logical axes against the JAX package's.

* The reference's ``tests/test_sharding.py`` cases on the port's
  ``distributed/sharding.py`` and ``models/common.py`` (a ``FakeMesh`` duck
  type, as there): the divisibility guard, its greedy prefix, the
  axis-reuse guard, pruning, the mixtral override, the rules context.
* ``safe_spec`` / ``tree_specs`` / ``batch_spec`` / ``cache_specs`` give
  the reference's spec on every leaf -- parameters, moments, cache, batch
  -- for all 10 archs x 3 modes x both production meshes.
* ``param_axes(cfg)`` equals the reference's axes tree leaf for leaf, and
  ``active_params_count()`` the reference's, for every arch.
"""

from __future__ import annotations

import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs.shapes as jshapes
from repro.configs import get_config as jget
from repro.distributed import sharding as jshd
from repro.models import serve as jserve
from repro.models.common import axis_rules as j_axis_rules
from repro.models.common import logical_to_spec as j_logical_to_spec
from repro.models.transformer import init_params as j_init_params
import repro_torch.configs.shapes as shapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import LogicalMesh, make_local_mesh, make_production_mesh
from repro_torch.models import serve
from repro_torch.models.common import axis_rules, current_mesh, current_rules, logical_to_spec
from repro_torch.models.transformer import param_axes, param_shapes


class FakeMesh:
    """Shape-only stand-in (mesh.shape mapping) for divisibility logic."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"pod16x16": dict(data=16, model=16), "pod2x16x16": dict(pod=2, data=16, model=16)}
MODE_SHAPE = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


# --------------------------------------------------------------------------- #
# The reference's cases
# --------------------------------------------------------------------------- #
def test_safe_spec_divisible():
    m = FakeMesh(pod=2, data=16, model=16)
    assert shd.safe_spec((256, 4096), ("batch", None), shd.TRAIN_RULES, m) == P(("pod", "data"),
                                                                               None)


def test_safe_spec_indivisible_falls_back():
    m = FakeMesh(pod=2, data=16, model=16)
    assert shd.safe_spec((51865, 1024), ("vocab", "d_model"), shd.TRAIN_RULES, m)[0] is None
    assert shd.safe_spec((256000, 8192), ("vocab", "d_model"), shd.TRAIN_RULES, m)[0] == "model"


def test_safe_spec_partial_tuple():
    m = FakeMesh(pod=2, data=16, model=16)
    assert shd.safe_spec((16,), ("batch",), shd.TRAIN_RULES, m) == P("pod")


def test_safe_spec_axis_reuse_guard():
    m = FakeMesh(data=16, model=16)
    assert shd.safe_spec((32, 32), ("a", "b"), {"a": "model", "b": "model"}, m) == P("model",
                                                                                    None)


def test_prune_rules_drops_missing_axes():
    pruned = shd.prune_rules(shd.TRAIN_RULES, FakeMesh(data=16, model=16))
    assert pruned["batch"] == "data" and pruned["heads"] == "model"
    assert pruned == jshd.prune_rules(jshd.TRAIN_RULES, FakeMesh(data=16, model=16))


def test_mixtral_arch_override():
    assert shd.rules_for("decode", arch="mixtral-8x22b")["d_model"] == "data"
    assert shd.rules_for("decode", arch="llama3.2-1b")["d_model"] is None
    for mode in MODE_SHAPE:
        for arch in ARCHS:
            assert shd.rules_for(mode, {"seq_sp": "data"}, arch=arch) == jshd.rules_for(
                mode, {"seq_sp": "data"}, arch=arch)


def test_logical_to_spec_respects_rules_context():
    with axis_rules({"batch": ("pod", "data"), "heads": "model"}, mesh="m"):
        assert logical_to_spec(("batch", "heads", None)) == P(("pod", "data"), "model", None)
        assert current_mesh() == "m" and current_rules()["heads"] == "model"
    assert logical_to_spec(("batch",)) == P(None)
    assert current_mesh() is None and current_rules() == {}


@pytest.mark.parametrize("axes", [("batch", "heads", None), ("heads", "kv_heads", "batch"),
                                  ("batch", "batch"), ("d_model", "batch", "vocab")])
def test_logical_to_spec_equals_the_references(axes):
    rules = {"batch": ("pod", "data"), "heads": "model", "kv_heads": "model",
             "d_model": "data", "vocab": ("model", "pod")}
    with j_axis_rules(rules):
        want = j_logical_to_spec(axes)
    with axis_rules(rules):
        assert logical_to_spec(axes) == tuple(want)
    assert logical_to_spec(axes, rules) == tuple(j_logical_to_spec(axes, rules))


def test_cache_axes_cover_all_families():
    for fam in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        ax = shd.cache_axes(fam)
        assert "length" in ax and ax == jshd.cache_axes(fam)
        assert all(isinstance(v, tuple) for v in ax.values())


def test_decode_rules_shard_kv_seq_on_model():
    spec = shd.safe_spec((16, 128, 32768, 8, 128), ("layers", "batch", "kv_seq", "kv_heads", None),
                         shd.rules_for("decode"), FakeMesh(pod=2, data=16, model=16))
    assert spec[2] == "model" and spec[1] == ("pod", "data") and spec[3] is None


def test_logical_mesh_has_the_production_shapes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.axis_names == ("pod", "data", "model") and two.size == 512
    with pytest.raises(ValueError):
        LogicalMesh((2, 2), ("data",))
    local = make_local_mesh()  # the CPU: one device
    assert local.axis_names == ("pod", "data", "model") and local.size == 1


def test_shard_bytes_divides_by_the_spec_axes():
    m = FakeMesh(pod=2, data=16, model=16)
    assert shd.shard_bytes((32, 64), torch.bfloat16, (("pod", "data"), "model"), m) == 8
    assert shd.shard_bytes((3, 5), torch.float32, (), m) == 60


# --------------------------------------------------------------------------- #
# Every leaf of every arch, mode and mesh
# --------------------------------------------------------------------------- #
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's parameter shapes and axes (``jax.eval_shape``)."""
    holder = {}

    def build(key):
        p, a = j_init_params(jget(arch, "full"), key)
        holder["axes"] = a
        return p

    shapes_ = jax.eval_shape(build, jax.random.PRNGKey(0))
    return shapes_, holder["axes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_references(arch):
    jshapes_, jaxes = _ref_params(arch)
    cfg = get_config(arch, "full")
    got, want = _flat(param_axes(cfg)), _flat(jaxes)
    assert got == want
    shp = _flat(param_shapes(cfg))
    assert {k: tuple(v[0]) for k, v in shp.items()} == {
        k: tuple(v.shape) for k, v in _flat(jshapes_).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_count_equals_the_references(arch):
    assert get_config(arch, "full").active_params_count() == jget(arch,
                                                                 "full").active_params_count()


def _ref_leaf_specs(tree_shapes, tree_axes, mesh, rules):
    flat_s, flat_a = _flat(tree_shapes), _flat(tree_axes)
    return {k: tuple(jshd.safe_spec(tuple(flat_s[k].shape), tuple(flat_a[k]), rules, mesh))
            for k in flat_s}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("mode", sorted(MODE_SHAPE))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_the_references_spec(arch, mode, mesh_name):
    """Parameters and moments (their specs are the parameters': the same
    shapes and axes), the cache of the mode's cell (prefill, decode) and
    the batch, leaf for leaf."""
    mesh = FakeMesh(**MESHES[mesh_name])
    cell = jshapes.SHAPES[MODE_SHAPE[mode]]
    jrules = jshd.prune_rules(jshd.rules_for(mode, arch=arch), mesh)
    rules = shd.prune_rules(shd.rules_for(mode, arch=arch), mesh)
    assert rules == jrules
    cfg = get_config(arch, "full")
    jshapes_, jaxes = _ref_params(arch)
    want = _ref_leaf_specs(jshapes_, jaxes, mesh, jrules)
    got = _flat(shd.tree_specs(
        {k: v for k, v in _meta_tree(param_shapes(cfg)).items()}, param_axes(cfg), mesh, rules))
    assert got == want

    jbatch = jshapes.input_specs(arch, MODE_SHAPE[mode])
    batch = shapes.input_specs(arch, MODE_SHAPE[mode])
    for key, sds in jbatch.items():
        assert shd.batch_spec(key, tuple(batch[key].shape), rules, mesh) == tuple(
            jshd.batch_spec(key, tuple(sds.shape), jrules, mesh)), key
    if mode == "train":
        return
    jcache = jax.eval_shape(lambda: jserve.init_cache(jget(arch, "full"), cell.global_batch,
                                                      cell.seq_len))
    cache = serve.init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")
    assert set(cache) == set(jcache)
    got = shd.cache_specs(cache, cfg.family, mesh, rules)
    for key, sds in jcache.items():
        assert tuple(cache[key].shape) == tuple(sds.shape), key
        want = jshd.safe_spec(tuple(sds.shape), jshd.cache_axes(cfg.family)[key], jrules, mesh)
        assert got[key] == tuple(want), key


def _meta_tree(spec_tree):
    return {k: _meta_tree(v) if isinstance(v, dict) else
            torch.empty(v[0], dtype=torch.bfloat16, device="meta") for k, v in spec_tree.items()}
