"""``python -m gsrs_tpu_torch``: command-line training (`gsrs_tpu_torch.cli`)."""

from gsrs_tpu_torch.cli import main

if __name__ == "__main__":
    main()
