"""lavida_mod_tpu_torch: the PyTorch/CUDA port of lavida_mod_tpu for NVIDIA
Hopper (H100), built beside the JAX package, which stays the reference.

Layer map (mirrors lavida_mod_tpu):

  config.py    the model and generation configs (a copy; `as_port_config`
               takes the JAX package's dataclasses by field name)
  constants.py, data/   token constants, anyres geometry and image
               preprocessing, the BPE tokenizer, the conversation
               templates, prompt tokenization and the infill corruption
               (copies)
  ops/         plain tensor functions (norms, rope, attention, pooling,
               sampling, schedules, activations, quantizers and quantized
               linears, the int8 KV cache) and the wrappers of the
               hand-written CUDA kernels (short_attention, gather, w8a8,
               w4_fused, w4_matmul, w4_grouped, kv8_attention, vit_mlp,
               prefix_flash)
  csrc/        the CUDA C++ kernels (hopper.cuh: the TMA / mbarrier /
               wgmma helpers two of them share), built by kernels.py with
               nvcc at first use
  kernel_times.py  device, back-to-back and host time per call of the
               short_attention and w8a8_matmul wrappers of any checkout
               (chip_smoke.py's timers)
  models/      nn.Modules: SigLIP, projector, LLaDA (bf16, the mixed
               int8/int4 and the int4 serving layouts; with Qwen2's QKV
               bias it is the Dream LM), the composed LaViDa with its
               checkpoint loader (llada_loader and dream, the reference
               names of the two LMs), and the host-side multimodal splice
               planner
  generation/  the prefix-cached masked-diffusion denoise loop, plain and
               with chunked batch prefill, and the Dream sampler
  eval/        the eval adapter: text in and out, and batched generation
  train/       the masked-diffusion loss, the optax-equivalent optimizer
               and the multimodal train step (stage-1 / stage-2 training)
  convert.py   JAX params (numpy pytree) -> this package's state dict, or
               f32 training masters
  tools/       the safetensors reader and writer, the weight-delta tools
  predict.py   prediction CLI (one request or a batch, from a checkpoint
               directory or seeded weights)
  rehearse_8b_load.py  writes a full-size reference-layout checkpoint,
               loads it and answers one request in text

This package imports torch and never jax, and nothing of lavida_mod_tpu
(tests/test_torch_config.py checks both).
"""

__version__ = "0.1.0"
