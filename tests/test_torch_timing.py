"""The port's timing utilities against the JAX package's (the CUDA-event
timers are tested on the card, in tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.utils.timing import fold_bounce as jax_fold_bounce
from effort_tpu_torch.utils import timing

torch.set_num_threads(2)


@pytest.mark.parametrize("n_in,n_out", [(64, 64), (64, 200), (128, 96)])
def test_fold_bounce_matches_jax(n_in, n_out):
    rng = np.random.default_rng(n_out)
    y = rng.standard_normal((2, n_out)).astype(np.float32)
    v = rng.standard_normal((2, n_in)).astype(np.float32)
    got = timing.fold_bounce(torch.from_numpy(y), torch.from_numpy(v))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_fold_bounce(jnp.asarray(y),
                                                jnp.asarray(v))))
    np.testing.assert_array_equal(np.abs(got.numpy()), np.abs(v))


def test_fresh_vectors_distinct_and_seeded():
    a = timing.fresh_vectors((16,), 3, device="cpu")
    b = timing.fresh_vectors((16,), 3, device="cpu")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
