"""`python -m dagsfm_tpu_torch <command> [flags]`: see pipeline/cli.py."""

from dagsfm_tpu_torch.pipeline.cli import main

if __name__ == "__main__":
    main()
