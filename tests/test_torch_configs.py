"""The port's config registry against the JAX package's, field for field:
every arch's ``CONFIG`` (and its variants ``CONFIG_SW``,
``CONFIG_SINKS``), the smoke configs, ``ASSIGNED``, ``LONG_500K``,
``applicable_shapes`` and ``config_for_shape`` for every arch × shape.
Exact equality (configs are data); ``dtype`` compares through the
framework's name for it."""
import dataclasses
import importlib

import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = jreg.list_archs()
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same(jcfg, tcfg):
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(jd) == set(td)
    for key in jd:
        if key == "dtype":
            assert td[key] == _DTYPES[jd[key]], key
        else:
            assert td[key] == jd[key], key


def _variants(module):
    return sorted(v for v in vars(module) if v.startswith("CONFIG"))


def test_registry_lists_the_same_archs():
    assert treg.list_archs() == ARCHS
    assert len(ARCHS) == 11
    assert treg.ASSIGNED == jreg.ASSIGNED
    assert treg.LONG_500K == jreg.LONG_500K


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_and_variant_matches_field_for_field(arch):
    jmod = importlib.import_module(jreg._MODULES[arch])
    tmod = importlib.import_module(treg._MODULES[arch])
    assert _variants(tmod) == _variants(jmod)
    for name in _variants(jmod):
        _same(getattr(jmod, name), getattr(tmod, name))
    _same(jreg.get_smoke_config(arch), treg.get_smoke_config(arch))
    _same(jreg.get_smoke_config(arch, num_layers=3, num_kv_heads=2),
          treg.get_smoke_config(arch, num_layers=3, num_kv_heads=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_resolve_like_the_reference(arch):
    assert treg.applicable_shapes(arch) == jreg.applicable_shapes(arch)
    for shape in jbase.INPUT_SHAPES:
        _same(jreg.config_for_shape(arch, shape),
              treg.config_for_shape(arch, shape))
    if arch == "glm4-9b":
        assert treg.config_for_shape(arch, "long_500k").name == \
            "glm4-9b-sinks"


def test_variants_resolve_by_name():
    _same(jreg.get_config("glm4-9b", variant="sinks"),
          treg.get_config("glm4-9b", variant="sinks"))
    _same(jreg.get_config("llama3-8b", variant="sw"),
          treg.get_config("llama3-8b", variant="sw"))
