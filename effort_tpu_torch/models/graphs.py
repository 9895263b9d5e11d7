"""Captured decode steps: one torch.cuda.CUDAGraph a step, replayed once a
token (the port's counterpart of the JAX package's jitted lax.scan).

A step reads every input from static device buffers (token, position,
effort, sampling values, the generator) and writes its results into
static buffers, so one capture serves every later call with the same key:
the caller fills the buffers with copy_ / fill_ and replays. The step
returns nothing, so every block the capture allocates is free again when
it ends, and the graphs of one engine share one memory pool.

Before capture the step runs once eagerly on a side stream (PyTorch's
rule for graphs): the lazy per-card tables and scratch it meets (RoPE
frequencies, threshold tables, instance ids, K1's and K4's scratch and
ticket, the nvcc builds) are made then, outside the graph's pool. That
run changes the step's state buffers, so callers fill them after a
capture. The kernels' per-card scratch is shared by every call on one
stream: a replay runs on the current stream, as eager calls do.
"""

from __future__ import annotations

import torch

from effort_tpu_torch.kernels import LAUNCHES, add_launches, launches_since


class StepGraph:
    """step() captured once on `device`. replay() replays it and counts the
    wrappers' launches of one step (kernels.LAUNCHES); the warm-up step and
    the capture count nothing, so a run counts what the same steps run
    eagerly count. A failed warm-up or capture raises, naming `key`:
    nothing falls back to the eager step.

    generator: a CUDA torch.Generator the step draws from; registered with
    the graph, so each replay draws the next numbers of its stream (the
    generator's seed and offset are read at every replay)."""

    def __init__(self, step, key, device, pool=None, generator=None):
        self.key = key
        before = dict(LAUNCHES)
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            warm = dict(LAUNCHES)
            with torch.cuda.graph(self.graph, pool=pool):
                step()
            self.launches = launches_since(warm)
        except Exception as e:
            raise RuntimeError(f"capturing the step {key} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            # set-up, not the run: the warm-up step's launches and the
            # capture's (which launches nothing) are not counted
            LAUNCHES.update(before)

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)
