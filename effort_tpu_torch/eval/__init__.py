"""Quality and speed evaluation over the port's Engine."""
from effort_tpu_torch.eval.harness import (  # noqa: F401
    effort_scale, cossim, matrix_quality_sweep, agreement_sweep, run_quiz)
