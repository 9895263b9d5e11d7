"""The port's profiling hooks (utils/profiling.py): JAX's
tests/test_profiling.py (StepTimer, the compiler dump, annotate) on the
port, and trace and warn_of_sync. On the CPU the trace records the host;
sass_dump (the JAX package's hlo_dump) needs the card and nvcc's
cuobjdump, so on the CPU it raises, and the card tests dump K1's SASS and
set the sync debug mode."""

import json
import os

import pytest
import torch

from effort_tpu_torch.utils.profiling import (StepTimer, annotate,
                                              sass_dump, trace,
                                              warn_of_sync)


def test_step_timer():
    t = StepTimer()
    with t.prep():
        x = torch.arange(8.0)
    with t.eval():
        (x * 2).sum()
    assert t.steps == 1 and t.prep_s >= 0.0 and t.eval_s >= 0.0
    s = t.summary()
    assert "tps" in s and "prep" in s and "ms/token" in s


def test_sass_dump_needs_a_card(tmp_path):
    """Without a card (and nvcc's build) there is nothing compiled to
    dump: sass_dump raises and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sass_dump("mxu_matvec", dump_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_annotate():
    with annotate("test-span"):
        torch.zeros(4) + 1


def test_trace_writes_chrome_trace(tmp_path):
    """trace() writes one Chrome trace into log_dir, with the annotated
    span in it."""
    with trace(str(tmp_path)) as d:
        assert d == str(tmp_path)
        with annotate("traced-span"):
            torch.ones(64).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "traced-span" for e in events)


def test_warn_of_sync_without_a_card():
    """Without a card there is nothing to wait for: the context runs its
    body and does nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ran = []
    with warn_of_sync():
        ran.append(1)
    assert ran == [1]


@pytest.mark.cuda
def test_sass_dump_on_card(tmp_path):
    """K1's library disassembled: sm_90a SASS of its kernels, written to
    dump_dir."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    txt = sass_dump("mxu_matvec", dump_dir=str(tmp_path))
    assert "sm_90a" in txt and "Function" in txt
    assert (tmp_path / "mxu_matvec.sass.txt").read_text() == txt


@pytest.mark.cuda
def test_warn_of_sync_on_card():
    """The sync debug mode is "warn" (1) inside and restored after; a host
    read inside warns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.cuda.get_sync_debug_mode()
    with warn_of_sync():
        assert torch.cuda.get_sync_debug_mode() == 1
        with pytest.warns(UserWarning):
            torch.ones(4, device="cuda").sum().item()
    assert torch.cuda.get_sync_debug_mode() == before
