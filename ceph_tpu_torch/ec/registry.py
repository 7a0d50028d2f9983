"""The erasure-code plugin registry.

The port of ``ceph_tpu/ec/registry.py``, the role of
``ErasureCodePluginRegistry`` (src/erasure-code/ErasureCodePlugin.h:
45-80, ErasureCodePlugin.cc:128): one factory keyed by plugin name over
the in-tree plugins, registered at import.  ``device`` is where the
code's chunks live: the card by default (raising without one), the CPU
(the kernels' plain versions) when asked; a profile with
``engine=native`` asks for no card whatever the device.
"""

from __future__ import annotations

from typing import Callable, Dict

from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile

_FACTORIES: Dict[str, Callable[..., ErasureCode]] = {}


def register(name: str, factory: Callable[..., ErasureCode]) -> None:
    """``factory(profile, device)`` builds and inits one code."""
    _FACTORIES[name] = factory


def plugins() -> list:
    return sorted(_FACTORIES)


def factory(plugin: str, profile: ErasureCodeProfile,
            device="cuda") -> ErasureCode:
    """ErasureCodePluginRegistry::factory: instantiate and init.

    ``profile['plugin']`` is the reference's profile convention; the
    explicit argument wins, as in the C++ signature."""
    f = _FACTORIES.get(plugin)
    if f is None:
        raise ErasureCodeError(
            -2, f"unknown erasure-code plugin {plugin!r}; "
                f"have {plugins()}")
    return f(dict(profile), device)


def profile_factory(profile: ErasureCodeProfile,
                    device="cuda") -> ErasureCode:
    """Build from a profile dict alone (``plugin=`` key, default
    jerasure: the OSDMonitor's default profile)."""
    return factory(profile.get("plugin", "jerasure"), profile, device)


def _register_builtins() -> None:
    from .clay import make_clay
    from .isa import make_isa
    from .jerasure import make_jerasure
    from .lrc import make_lrc
    from .shec import make_shec

    register("jerasure", make_jerasure)
    register("isa", make_isa)
    register("lrc", make_lrc)
    register("shec", make_shec)
    register("clay", make_clay)


_register_builtins()
