"""Training of the port: the diffusion loss (loss.py) and the optimizer and
train step (step.py)."""
