"""dddmr_navigation_tpu — a JAX 3D mobile-robot navigation framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``dddmr_navigation`` ROS 2 stack (3D point-cloud navigation: perception /
3D costmap, sampling-MPC local planner, point-cloud-graph global planner,
move-base FSM + recovery, 6DOF particle-filter localization, LiDAR SLAM).

Design stance (see SURVEY.md §7): all per-tick state is a pytree; a control
tick is a pure jitted function ``step(state, obs, goal) -> (state, cmd, diag)``;
batching over robots/scenarios is ``vmap``/``jax.sharding``, not threads.
"""

__version__ = "0.1.0"
