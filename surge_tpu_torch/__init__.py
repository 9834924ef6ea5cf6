"""surge_tpu_torch — the replay engine of surge_tpu in PyTorch, for NVIDIA Hopper.

A second package beside ``surge_tpu`` (the JAX reference). Module paths and names
mirror the reference, so ``surge_tpu_torch.replay.engine.ReplayEngine`` is the
counterpart of ``surge_tpu.replay.engine.ReplayEngine``. The package imports
``torch`` and numpy and never JAX or ``surge_tpu``: where it needs a numpy-only
reference module it keeps its own copy of the parts it uses.

Hand-written CUDA kernels live in ``csrc/`` and are built at first use by
:mod:`surge_tpu_torch._build`.
"""
