"""``python -m jpdse_tpu_torch.train [flags]``: the twin of ``train.py``."""

from jpdse_tpu_torch.train.run import main

if __name__ == "__main__":
    main()
