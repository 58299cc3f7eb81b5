"""lavida_mod_tpu_torch: the PyTorch/CUDA port of lavida_mod_tpu for NVIDIA
Hopper (H100), built beside the JAX package, which stays the reference.

Layer map (mirrors lavida_mod_tpu):

  ops/         plain tensor functions (norms, rope, attention, pooling,
               sampling, schedules, activations, quantizers and quantized
               linears) and the wrappers of the hand-written CUDA kernels
               (short_attention, gather, w8a8, w4_fused)
  csrc/        the CUDA C++ kernels, built by kernels.py with nvcc at
               first use
  models/      nn.Modules: SigLIP, projector, LLaDA (bf16 and the mixed
               int8/int4 serving layout), the composed LaViDa, and the
               host-side multimodal splice planner
  generation/  the prefix-cached masked-diffusion denoise loop
  convert.py   JAX params (numpy pytree) -> this package's state dict
  predict.py   single-image prediction CLI

This package imports torch and never jax.  From the JAX package it uses
only the jax-free `config`, `constants` and `data.anyres` modules.
"""

__version__ = "0.1.0"
