"""cvnets_tpu_torch: the PyTorch/CUDA port of cvnets_tpu for NVIDIA Hopper GPUs.

The JAX package ``cvnets_tpu`` stays the reference. This package mirrors its
directory and module names so each counterpart is easy to find, and replaces every
Pallas kernel on a ported path with a CUDA kernel written by hand for ``sm_90a``
(see ``ops/`` and ``csrc/``).

Import rule: nothing here imports ``jax``, ``flax``, ``optax``, ``yaml`` or ``PIL``
at module level. From ``cvnets_tpu`` only these jax-free modules are reused:
``utils.registry``, ``utils.logger``, ``utils.math_utils`` and
``options.parse_args``.
"""

__version__ = "0.1.0"
