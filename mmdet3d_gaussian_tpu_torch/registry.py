"""Minimal registry + build-from-config layer for the PyTorch port.

The port keeps its own registry instances (the JAX package's registries
hold flax modules); the pattern is the same: a type-name string maps to a
class or factory, and ``build_from_cfg`` instantiates
``registry.get(cfg['type'])(**cfg-minus-type)``.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """Maps type-name strings to callables (classes or factory functions)."""

    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f'Registry(name={self.name}, items={list(self._module_dict)})'

    def get(self, key: str) -> Callable:
        if key not in self._module_dict:
            raise KeyError(f'{key!r} is not registered in {self.name}; '
                           f'available: {sorted(self._module_dict)}')
        return self._module_dict[key]

    def register_module(self, name: Optional[str] = None, force: bool = False,
                        module: Optional[Callable] = None):
        def _register(cls):
            key = name or cls.__name__
            if not force and key in self._module_dict:
                raise KeyError(f'{key} already registered in {self.name}')
            self._module_dict[key] = cls
            return cls

        if module is not None:
            return _register(module)
        return _register

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        return build_from_cfg(cfg, self, **default_kwargs)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   **default_kwargs) -> Any:
    """Instantiate ``registry.get(cfg['type'])(**cfg-minus-type)``."""
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {obj_type!r}')
    for k, v in default_kwargs.items():
        args.setdefault(k, v)
    return obj_cls(**args)


MODELS = Registry('models')            # encoders, backbones, necks, heads
ANCHOR_GENERATORS = Registry('anchor_generators')
BBOX_CODERS = Registry('bbox_coders')
LOSSES = Registry('losses')
