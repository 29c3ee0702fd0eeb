"""The port's packages export what the reference's export (ROADMAP C11,
C12).

- Every package of ``repro`` that the port has (all but ``analysis``,
  ROADMAP A12a) lists the same public names in ``__all__`` in the port,
  apart from the port's own additions named in ``PORT_ONLY``, and each of
  the reference's names exists in the port.
- Each name is a module where the reference's is a module, a class
  where it is a class and a callable where it is a callable.  A package
  whose names resolve lazily (a module ``__getattr__``: ``kernels``) is
  asked in a fresh subprocess, since what was imported before decides
  what such a name is: ``from <package> import <names>`` in ``__all__``'s
  order and in the reverse order, on both sides.  In ``kernels``,
  ``flash_attention`` and ``flash_decode`` resolve to ``ops``'s callables
  when asked for first, and to the kernel modules once ``ops`` has been
  imported, on both sides.
"""
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
PACKAGES = ("checkpoint", "configs", "core", "data", "distributed",
            "kernels", "launch", "models", "obs", "optim", "runtime",
            "sweep", "train")
# names the port exports beyond the reference's: load_state copies a
# reference-form state into the port's, make_opt is the reference's
# train.steps function, exported by the port's package
PORT_ONLY = {"train": {"load_state", "make_opt"}}
# the packages with a module __getattr__ (lazily resolved names)
LAZY = ("kernels",)


def _public(pkg: str) -> list:
    return list(getattr(importlib.import_module(pkg), "__all__", []))


def kind(v) -> str:
    return ("module" if isinstance(v, types.ModuleType)
            else "class" if inspect.isclass(v)
            else "callable" if callable(v) else "value")


@pytest.mark.parametrize("name", PACKAGES)
def test_public_names_equal_the_reference(name):
    ref, port = _public(f"repro.{name}"), _public(f"repro_torch.{name}")
    assert set(port) - set(ref) == PORT_ONLY.get(name, set())
    assert [n for n in port if n in ref] == ref
    ref_mod = importlib.import_module(f"repro.{name}")
    mod = importlib.import_module(f"repro_torch.{name}")
    assert (hasattr(ref_mod, "__getattr__") or hasattr(mod, "__getattr__")) \
        == (name in LAZY)
    for n in ref:
        assert hasattr(mod, n), (name, n)
        if name not in LAZY:
            assert kind(getattr(mod, n)) == kind(getattr(ref_mod, n)), n


_RESOLVE = "import inspect, types\n" + inspect.getsource(kind) + """
import importlib, json, sys
mod = importlib.import_module(sys.argv[1])
print(json.dumps([kind(getattr(mod, n)) for n in json.loads(sys.argv[2])]))
"""


def _resolve(pkg: str, names: list) -> list:
    """What each of ``names`` of ``pkg`` is, asked in that order in a
    fresh process."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _RESOLVE, pkg,
                          json.dumps(names)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("order", ("all", "reversed"))
@pytest.mark.parametrize("name", LAZY)
def test_lazy_names_resolve_as_the_reference_in_a_fresh_process(name,
                                                                order):
    names = _public(f"repro.{name}")
    if order == "reversed":
        names = names[::-1]
    got = _resolve(f"repro_torch.{name}", names)
    assert got == _resolve(f"repro.{name}", names), names


def test_kernel_names_are_ops_callables_when_asked_first():
    """The case of ROADMAP C12: ``from repro_torch.kernels import
    flash_attention, flash_decode`` in a fresh process gives ``ops``'s
    callable, then the kernel module that importing ``ops`` bound, as the
    reference does."""
    names = ["flash_attention", "flash_decode"]
    want = _resolve("repro.kernels", names)
    assert want == ["callable", "module"]
    assert _resolve("repro_torch.kernels", names) == want
