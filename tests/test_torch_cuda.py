"""Tests that need an NVIDIA GPU (`cuda` marker; each skips without one).

This file imports no JAX, so it also runs on a machine without JAX, where
tests/conftest.py cannot load:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from effort_tpu_torch.config import BucketConfig
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.ops.bucketize import bucketize
from effort_tpu_torch.utils import timing


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_mxu_matvec_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card: the same
    stream length C and cos >= 0.9999 at every effort and tau."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    wt = torch.randn((4096, 4096), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=256,
                                    dtype=dtype))
    launches = LAUNCHES["mxu_matvec"]
    for e in (0.1, 0.5, 1.0):
        for tau in (0.97, 1.0):
            v = torch.randn(4096, generator=g, device="cuda")
            y, C = port_fs.mxu_matvec(bm, v, e, 0, tau=tau,
                                      return_len=True)
            yr, Cr = port_fs.mxu_matvec_ref(bm, v, e, 0, tau=tau,
                                            return_len=True)
            torch.cuda.synchronize()
            assert int(C) == int(Cr), (e, tau)
            c = torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0)
            assert float(c) >= 0.9999, (e, tau, float(c))
    assert LAUNCHES["mxu_matvec"] == launches + 6


@pytest.mark.cuda
def test_cuda_timers():
    """gpu_ms and chain_time return positive device times, and a chain
    twice as long takes longer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.randn(2048, 2048, device="cuda")
    ms = timing.gpu_ms(lambda x: x @ w, (torch.randn(8, 2048,
                                                        device="cuda"),))
    assert ms > 0

    def make_chain(n):
        def run(v):
            for _ in range(n):
                v = timing.fold_bounce(v @ w, v)
            return v
        return run
    args = [(v,) for v in timing.fresh_vectors((8, 2048), 8)]
    assert timing.chain_time(make_chain, 4, 16, args) > 0
