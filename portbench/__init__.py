"""The benchmark of the PyTorch/CUDA port ``aa_admm_tpu_torch``.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on an NVIDIA GPU:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, mix or per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``mixes/<traffic>.json``, ``metrics/<metric>.py``;
a configuration names its driver, ``drivers/<driver>.py``. The plain
references that decide ``correct`` live in ``reference/`` and import nothing
of the port. Nothing here imports ``jax`` or the JAX package.
"""
