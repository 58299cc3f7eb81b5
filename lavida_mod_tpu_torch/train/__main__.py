"""`python -m lavida_mod_tpu_torch.train ...`: the training CLI (cli.py)."""

from .cli import main

if __name__ == "__main__":
    main()
