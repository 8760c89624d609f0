"""instant-ngp in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``instant_ngp_tpu`` (the JAX package beside it, which stays the
reference). Module paths mirror the JAX package's, so each module's
counterpart is easy to find. The runtime imports torch, numpy and the
standard library only; it never imports jax, msgpack or ``instant_ngp_tpu``.

This package covers the snapshot render path: ``testbed.Testbed("nerf")``,
``load_snapshot`` and ``render``. The four hot ops on that path are CUDA
kernels in ``csrc/`` (hash-grid encode, fused MLP, occupancy march,
composite); each wrapper runs its plain PyTorch version for CPU tensors.
"""
