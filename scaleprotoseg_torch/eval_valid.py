"""Validation evaluation of single-scale runs: the same engine as
``eval_valid_multiscale``, which reads the variant from the checkpoint.

    python -m scaleprotoseg_torch.eval_valid MODEL_NAME PHASE [...]
"""

from scaleprotoseg_torch.eval_valid_multiscale import (  # noqa: F401
    main, run_evaluation)

if __name__ == "__main__":
    main()
