"""The choice between a kernel and its plain version lives in
``ops/kernels`` alone: a tensor on the card runs the kernel, a tensor on
the CPU the plain version, and ``ops.kernels.plain_versions()`` is the one
switch that runs the plain versions on the card. No function of the port
takes a routing parameter, and the switch restores what it found."""

import importlib
import inspect
import pkgutil
import types

import pytest
import torch

from shermbot_navigation_tpu_torch.ops import kernels

ROUTING = {"use_kernel", "seq_kernel", "grid_kernel"}


def _modules(name):
    pkg = importlib.import_module(f"shermbot_navigation_tpu_torch.{name}")
    yield pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        yield importlib.import_module(info.name)


def _parameters(mod):
    """``(qualified name, parameter names)`` of every function, method and
    custom op defined in ``mod``."""
    for name, obj in vars(mod).items():
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if isinstance(obj, torch._library.custom_ops.CustomOpDef):
            ns, op = obj._name.split("::")
            schema = getattr(getattr(torch.ops, ns), op).default._schema
            yield obj._name, {a.name for a in schema.arguments}
        elif inspect.isfunction(obj):
            yield name, set(inspect.signature(obj).parameters)
        elif inspect.isclass(obj):
            for attr, fn in vars(obj).items():
                if inspect.isfunction(fn):
                    yield f"{name}.{attr}", set(
                        inspect.signature(fn).parameters)


@pytest.mark.parametrize("subpackage",
                         ["ops", "models", "parallel", "pipeline", "sim"])
def test_no_function_takes_a_routing_parameter(subpackage):
    found = [(f"{mod.__name__}.{fn}", sorted(params & ROUTING))
             for mod in _modules(subpackage)
             for fn, params in _parameters(mod) if params & ROUTING]
    assert not found, found


def test_switch_restores_the_rule_after_an_exception():
    card = types.SimpleNamespace(is_cuda=True)
    cpu = torch.zeros(1)
    assert kernels.wants_kernel(card) and not kernels.wants_kernel(cpu)
    with pytest.raises(RuntimeError, match="inside"):
        with kernels.plain_versions():
            assert not kernels.wants_kernel(card)
            with kernels.plain_versions():
                pass
            assert not kernels.wants_kernel(card)
            raise RuntimeError("inside")
    assert kernels.wants_kernel(card)
