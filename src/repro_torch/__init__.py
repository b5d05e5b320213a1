"""repro_torch — the PyTorch/CUDA port of the ``repro`` JAX package.

Same layout as the reference (``configs/``, ``data/``, ``core/``,
``kernels/``, ``models/``, ``launch/``) so each JAX module has one
counterpart here. The port imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``; numpy-only modules of the reference are carried as
copies. ``convert.from_reference`` turns the reference's params into the
port's. The kernels of the serving path are hand-written CUDA for Hopper
(``csrc/``), built with ``nvcc`` at first use (``kernels/build.py``).
"""
