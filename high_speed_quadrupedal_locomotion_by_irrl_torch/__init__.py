"""PyTorch/CUDA port of the IRRL quadruped-locomotion framework.

Mirrors the module paths of ``high_speed_quadrupedal_locomotion_by_irrl_tpu``
(the JAX reference, which this package never imports):

- ``phys``     robot model (static 13-body arrays, per-env parameters)
- ``robot``    leg kinematics and the Bezier gait reference
- ``ops``      the physics substep and LSTM cell: plain PyTorch versions and
               hand-written CUDA kernels for Hopper (sources in ``csrc/``)
- ``envs``     the BlackPanther MDP, batched over a leading env axis
- ``models``   stacked-LSTM actor-critic and bp5 CSV weight loading
- ``analysis`` closed-loop evaluation (velocity tracking)
- ``cli``      the evaluation entry point

Every entry point takes a ``device`` and runs on ``cuda`` unless the caller
asks for ``cpu`` (:mod:`.device`).
"""

__version__ = "0.1.0"
