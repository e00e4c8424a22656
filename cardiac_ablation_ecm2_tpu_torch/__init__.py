"""PyTorch/CUDA port of the finite element framework in ``cardiac_ablation_ecm2_tpu``.

The JAX package beside this one is the reference: every module here sits at
the same relative path as its counterpart there and computes the same thing.
This package imports ``torch`` and never ``jax``.  Plain tensor code is
PyTorch; every TPU kernel of the JAX package has a hand-written CUDA C++
counterpart for Hopper (``sm_90a``) in ``csrc/`` (the L↔E restriction's
gather-sum, transposing gather and segment-sum, the SELL SpMV, the fused
diffusion apply, also with bfloat16 qdata, and the probe gathers), built
on first use.

Every function that allocates on a device takes an explicit ``device``;
there is no global device.
"""

__version__ = "0.1.0"
