"""Policy registry (register_policy parity, policies.py:584-633).

Port of ``models/registry.py``. Each entry is a module exposing
init/forward/sequence/deterministic_action/state_size with identical
signatures; PPO looks policies up by name, mirroring the reference's
string-keyed policy registry.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm, mlp

_REGISTRY: Dict[str, ModuleType] = {}


def register_policy(name: str, module: ModuleType) -> None:
    if name in _REGISTRY and _REGISTRY[name] is not module:
        raise ValueError(f"policy {name!r} already registered")
    _REGISTRY[name] = module


def get_policy(name: str) -> ModuleType:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(_REGISTRY)}") from None


register_policy("CustomLSTMPolicy", lstm)   # the bp5 network (run_bp_v5.py:117-193)
register_policy("LstmPolicy", lstm)
register_policy("MlpPolicy", mlp)
