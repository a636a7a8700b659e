"""Test harness: an 8-device virtual CPU mesh, so multi-device sharding
paths run without several accelerators (SURVEY.md §4 implication).

The tests run on the CPU unless ``JAX_PLATFORMS`` names other platforms:
the GPU tests (``-m gpu``) run on a card with
``JAX_PLATFORMS=cuda,cpu``, which keeps the CPU devices for comparison."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from dddmr_navigation_tpu.jax_setup import use_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)
use_compile_cache()
