"""The prefix-cached masked-diffusion denoise loop."""
