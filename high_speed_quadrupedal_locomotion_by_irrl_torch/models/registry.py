"""Policy registry (register_policy parity, policies.py:584-633).

Port of ``models/registry.py``. Each entry is a module exposing
init/forward/sequence/deterministic_action/state_size with identical
signatures; PPO looks policies up by name, mirroring the reference's
string-keyed policy registry. ``MlpPolicy`` is known by name but not ported
yet (``models/mlp.py``, ROADMAP.md Queue 1).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm

_REGISTRY: Dict[str, ModuleType] = {}
_NOT_PORTED = {"MlpPolicy": "models/mlp.py"}


def register_policy(name: str, module: ModuleType) -> None:
    if name in _REGISTRY and _REGISTRY[name] is not module:
        raise ValueError(f"policy {name!r} already registered")
    _REGISTRY[name] = module


def get_policy(name: str) -> ModuleType:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} ({_NOT_PORTED[name]}) is not in the PyTorch port yet: "
            "see ROADMAP.md, Queue 1")
    raise KeyError(f"unknown policy {name!r}; known: {sorted(_REGISTRY)}")


register_policy("CustomLSTMPolicy", lstm)   # the bp5 network (run_bp_v5.py:117-193)
register_policy("LstmPolicy", lstm)
