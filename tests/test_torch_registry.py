"""Serving bundles and the model registry: bundles the JAX package writes
(v1, and a two-model v2 registry with serving hints) restored by the port,
port-written registry bundles read by the JAX package, and the registry's
pool logic — LRU under a byte budget, the protected entry, ``unload`` —
with stub builders whose bytes are stated.  Parameters cross bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro import checkpoint as jax_ckpt
from repro.core import sde as jax_sde
from repro_torch import checkpoint as ckpt
from repro_torch.core import sde
from repro_torch.serving import LoadedModel, ModelRegistry, load_model, restore_for_serving
from repro_torch.serving.registry import EagerProgram, capture_or_eager

GAN = dict(data_dim=1, hidden_dim=8, noise_dim=4, width=16, num_steps=8)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def _assert_same(port_tree, jax_tree):
    got, want = dict(_leaves(port_tree)), dict(_leaves(jax.device_get(jax_tree)))
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_reference_v1_bundle_restores_as_default(tmp_path):
    with jax_config():
        jcfg = jax_sde.NeuralSDEConfig(**GAN)
        jparams = jax_sde.generator_init(jax.random.PRNGKey(1), jcfg)
        jax_ckpt.save_serving_bundle_v1(tmp_path, 5, jparams, "sde-gan", jcfg)
    meta, step = ckpt.load_serving_manifest(tmp_path)
    assert step == 5 and meta["schema"] == ckpt.SERVING_SCHEMA_V2
    assert meta["upgraded_from"] == ckpt.SERVING_SCHEMA_V1
    assert [m["model_id"] for m in meta["models"]] == ["default"]
    flat, _ = ckpt.load_serving_meta(tmp_path)
    assert flat["workload"] == "sde-gan" and flat["model_id"] == "default"
    model = load_model(tmp_path, device="cpu")
    assert model.model_id == "default" and model.step == 5 and model.hints == {}
    assert model.cfg == sde.NeuralSDEConfig(**GAN)
    _assert_same(model.params, jparams)
    params, cfg, got_step = restore_for_serving("sde-gan", tmp_path, "cpu")
    _assert_same(params, jparams)
    assert cfg == model.cfg and got_step == 5
    like = sde.generator_init(torch.Generator().manual_seed(0), model.cfg)
    flat_tree, _ = ckpt.restore_serving_model(tmp_path, like, "default")  # the flat v1 leaves
    _assert_same(flat_tree, jparams)


def test_reference_two_model_registry_bundle_restores_with_hints(tmp_path):
    with jax_config():
        jcfg = jax_sde.NeuralSDEConfig(**GAN)
        ja = jax_sde.generator_init(jax.random.PRNGKey(2), jcfg)
        jb = jax_sde.generator_init(jax.random.PRNGKey(3), jcfg)
        jax_ckpt.save_serving_registry(tmp_path, 7, {"a": (ja, "sde-gan", jcfg),
                                                     "b": (jb, "sde-gan", jcfg)},
                                       serving_hints={"b": {"quota": 4}})
    reg = ModelRegistry()
    assert reg.load(tmp_path, device="cpu") == ("a", "b")
    assert reg.ids() == ("a", "b") and "a" in reg
    _assert_same(reg.get("a").params, ja)
    _assert_same(reg.get("b").params, jb)
    assert reg.get("b").hints == {"quota": 4} and reg.get("a").hints == {}
    with pytest.raises(ValueError, match="2 model entries"):
        load_model(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="2 model entries"):
        ckpt.load_serving_meta(tmp_path)
    with pytest.raises(ValueError, match="has no model 'c'"):
        load_model(tmp_path, "c", device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        reg.load(tmp_path, device="cpu")


def test_port_registry_bundle_is_read_by_jax(tmp_path):
    from repro.serving.registry import ModelRegistry as JaxRegistry

    cfg = sde.NeuralSDEConfig(**GAN)
    pa = sde.generator_init(torch.Generator().manual_seed(4), cfg)
    pb = sde.generator_init(torch.Generator().manual_seed(5), cfg)
    ckpt.save_serving_registry(tmp_path, 2, {"a": (pa, "sde-gan", cfg),
                                             "b": (pb, "sde-gan", cfg)},
                               serving_hints={"a": {"quota": 2}})
    with jax_config():
        jreg = JaxRegistry()
        assert jreg.load(tmp_path) == ("a", "b")
        _assert_same(pb, jreg.get("b").params)
        assert jreg.get("a").hints == {"quota": 2}
    with pytest.raises(ValueError, match="not in the bundle"):
        ckpt.save_serving_registry(tmp_path, 3, {"a": (pa, "sde-gan", cfg)},
                                   serving_hints={"z": {}})


def test_port_v1_writer_upgrades_in_both_packages(tmp_path):
    cfg = sde.NeuralSDEConfig(**GAN)
    params = sde.generator_init(torch.Generator().manual_seed(6), cfg)
    ckpt.save_serving_bundle_v1(tmp_path, 1, params, "sde-gan", cfg)
    _assert_same(load_model(tmp_path, device="cpu").params,
                 jax.tree.map(lambda t: t.numpy(), params))
    with jax_config():
        from repro.serving.registry import load_model as jax_load_model

        _assert_same(params, jax_load_model(tmp_path).params)


def test_restore_for_serving_names_a_workload_mismatch(tmp_path):
    cfg = sde.NeuralSDEConfig(**GAN)
    ckpt.save_serving_bundle(tmp_path, 0, sde.generator_init(torch.Generator(), cfg),
                             "sde-gan", cfg)
    with pytest.raises(ValueError, match="trained for workload 'sde-gan'"):
        restore_for_serving("latent-sde", tmp_path, "cpu")


class _Stub:
    """A pool entry of stated bytes that records its release."""

    def __init__(self, nbytes, log):
        self.nbytes, self.log, self.released = nbytes, log, False

    def __call__(self, *args):
        return args

    def release(self):
        self.released = True
        self.log.append(self)


def _stub_registry(budget, ids=("m",)):
    reg = ModelRegistry(pool_budget_bytes=budget)
    cfg = sde.NeuralSDEConfig(**GAN)
    for mid in ids:
        reg.register(LoadedModel(mid, "sde-gan", cfg, sde.generator_init(torch.Generator(),
                                                                         cfg)))
    return reg


def test_pool_lru_evicts_coldest_under_the_budget():
    released = []
    reg = _stub_registry(250)
    build = lambda n: (lambda: _Stub(n, released))
    a = reg.compiled("m", "chunk", 1, build(100), verbose=False)
    reg.compiled("m", "chunk", 2, build(100), verbose=False)
    assert reg.compiled("m", "chunk", 1, build(999), verbose=False) is a  # a hit: touched
    reg.compiled("m", "chunk", 4, build(100), verbose=False)  # 300 B > 250: evict bucket 2
    assert reg.pool_keys() == (("m", "chunk", 1), ("m", "chunk", 4))
    assert reg.evictions == 1 and reg.compiles == 3 and reg.pool_bytes() == 200
    assert len(released) == 1 and released[0].nbytes == 100 and not a.released
    reg.compiled("m", "chunk", 2, build(100), verbose=False)  # a miss again: rebuilt
    assert reg.compiles == 4 and reg.evictions == 2
    assert reg.pool_keys() == (("m", "chunk", 2), ("m", "chunk", 4))


def test_pool_never_evicts_the_entry_just_built():
    released = []
    reg = _stub_registry(50)
    reg.compiled("m", "init", 1, lambda: _Stub(10, released), verbose=False)
    big = reg.compiled("m", "chunk", 8, lambda: _Stub(500, released), verbose=False)
    assert reg.pool_keys() == (("m", "chunk", 8),) and reg.pool_bytes() == 500
    assert reg.evictions == 1 and not big.released


def test_unload_drops_a_models_pool_only():
    released = []
    reg = _stub_registry(None, ids=("a", "b"))
    for mid in ("a", "b"):
        for kind in ("init", "chunk"):
            reg.compiled(mid, kind, 2, lambda: _Stub(64, released), verbose=False)
    assert reg.pool_bytes("a") == 128 and reg.pool_bytes() == 256
    reg.unload("a")
    assert reg.pool_keys() == (("b", "chunk", 2), ("b", "init", 2))
    assert len(released) == 2 and reg.ids() == ("b",)
    with pytest.raises(ValueError, match="not registered"):
        reg.unload("a")
    with pytest.raises(ValueError, match="no model 'a'"):
        reg.compiled("a", "chunk", 2, lambda: _Stub(1, released))


def test_pool_budget_validation_and_cpu_entries():
    with pytest.raises(ValueError, match="must be positive"):
        ModelRegistry(pool_budget_bytes=0)
    entry = capture_or_eager(lambda x: x + 1, (torch.zeros(3),))
    assert isinstance(entry, EagerProgram) and entry.nbytes == 0
    assert torch.equal(entry(torch.ones(3)), torch.full((3,), 2.0))


def test_register_replace_hot_swaps_and_drops_the_old_pool():
    released = []
    reg = _stub_registry(None)
    reg.compiled("m", "chunk", 1, lambda: _Stub(8, released), verbose=False)
    cfg = sde.NeuralSDEConfig(**GAN)
    new = LoadedModel("m", "sde-gan", cfg, sde.generator_init(torch.Generator(), cfg), step=9)
    with pytest.raises(ValueError, match="already registered"):
        reg.register(new)
    reg.register(new, replace=True)
    assert reg.get("m").step == 9 and reg.pool_keys() == () and len(released) == 1
