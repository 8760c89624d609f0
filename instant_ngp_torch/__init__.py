"""instant-ngp in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``instant_ngp_tpu`` (the JAX package beside it, which stays the
reference). Module paths mirror the JAX package's, so each module's
counterpart is easy to find. The runtime imports torch, numpy and the
standard library only; it never imports jax, msgpack or ``instant_ngp_tpu``.

This package covers NeRF snapshot rendering (``testbed.Testbed("nerf")``,
``load_snapshot``, ``render``), NeRF training through ``Testbed.frame()``,
the neural-image primitive (``Testbed("image")``, ``load_training_data``,
``frame``, ``render``, ``compute_image_mse``), the SDF and volume primitives
(``Testbed("sdf")``, ``Testbed("volume")``) and the gather microbenchmarks
(``python -m instant_ngp_torch.bench.gather``). The hot ops
are CUDA kernels in ``csrc/``; each wrapper runs its plain PyTorch version
for CPU tensors and its kernel for CUDA tensors.
"""
