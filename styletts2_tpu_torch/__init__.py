"""PyTorch/CUDA port of ``styletts2_tpu``.

The JAX package beside this one is the reference each module is held
against; this package imports neither it nor ``jax``.  Modules mirror the
JAX package's layout (``models/decoder/istftnet.py`` here is the counterpart
of ``styletts2_tpu/models/decoder/istftnet.py``), keep its public tensor
layouts, and name their parameters after the same torch ``state_dict`` keys,
so one weight set loads into both (``models.zoo.load_jax_params``).

Hand-written CUDA kernels live in ``csrc/`` and are built at first use into
``_build/`` (``kernels/build.py``); importing the package builds nothing.
"""
