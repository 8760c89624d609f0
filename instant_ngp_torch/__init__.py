"""instant-ngp in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``instant_ngp_tpu`` (the JAX package beside it, which stays the
reference). Module paths mirror the JAX package's, so each module's
counterpart is easy to find. The runtime imports torch, numpy, scipy (the
ꟻLIP metric's filters, the camera predictor's matrix log) and the standard
library only; it never imports jax, msgpack or ``instant_ngp_tpu``.

This package covers the run entry point (``python -m instant_ngp_torch.run``,
``scripts/run.py``'s flags) and the pyngp surface it drives
(``instant_ngp_torch.pyngp``), NeRF snapshot rendering (``load_snapshot``,
``render`` at any spp), NeRF training through ``Testbed.frame()``,
the neural-image primitive (``Testbed("image")``, ``load_training_data``,
``frame``, ``render``, ``compute_image_mse``), the SDF and volume primitives
(``Testbed("sdf")``, ``Testbed("volume")``) and the gather microbenchmarks
(``python -m instant_ngp_torch.bench.gather``). The hot ops
are CUDA kernels in ``csrc/``; each wrapper runs its plain PyTorch version
for CPU tensors and its kernel for CUDA tensors.
"""
