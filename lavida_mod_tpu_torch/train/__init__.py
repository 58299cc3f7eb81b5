"""Training of the port: the diffusion loss (loss.py), the optimizer and
train step (step.py) and the training CLI (cli.py, `python -m
lavida_mod_tpu_torch.train`, the port of the repository's train.py)."""
