"""The VIO step as a CUDA graph.

The JAX package runs the step as one compiled program (`jax.jit(stepped)`,
vins_tpu/estimator/estimator.py:310-346); the port dispatches it op by op
from Python, thousands of kernels per step.  `StepGraph` captures
`Estimator.packed_step` with `torch.cuda.CUDAGraph` and replays it: one
graph launch per VIO step.

`marg_old` is a Python bool that picks one of two marginalizations, so there
is one graph per value; both are captured together, on the first step.  The
graphs read static tensors and write static tensors, which live outside
their memory pools:

  * `blob`: the packed window (the estimator uploads into it),
  * `prior`: the marginalization prior.  Inside the captured region, after
    the step has read it, the step's new prior is copied into it, so the
    prior chains on the device from replay to replay; a reboot copies an
    empty prior into it (`load_prior`) instead of rebinding it,
  * `out`: the packed result, copied to the host after each replay.

A capture that fails raises; there is no eager fallback.

`BatchStepGraph` is the multi-stream pipeline's: one graph for S streams
over a static [S, D+1] input (the S blobs, each with its selection flag) and
a static stacked prior, of which only the selected streams' slots take the
new prior (`vins_tpu/parallel/multistream.py:176-195`'s `where(sel, new,
old)`), so a zero-blob slot's garbage never reaches a kept prior.
"""
from __future__ import annotations

import torch

from ..solver.problem import Prior, WindowState


def clone_prior(p: Prior) -> Prior:
    return Prior(J=p.J.clone(), r0=p.r0.clone(),
                 lin=WindowState(*[x.clone() for x in p.lin]), valid=p.valid.clone())


def copy_prior(dst: Prior, src: Prior) -> None:
    """dst ← src, field by field, in place."""
    for d, s in zip((dst.J, dst.r0, *dst.lin, dst.valid), (src.J, src.r0, *src.lin, src.valid)):
        d.copy_(s)


class StepGraph:
    """Both graphs of `step(blob, prior, marg_old)` over static tensors;
    `pack(result)` gives the flat tensor copied into `out`."""

    WARMUP = 2  # eager runs on a side stream before a capture

    def __init__(self, step, pack, blob_numel: int, prior: Prior):
        self.step, self.pack = step, pack
        self.blob = torch.zeros(blob_numel, dtype=prior.J.dtype, device=prior.J.device)
        self.prior = clone_prior(prior)
        self.out = None
        self.graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def load_prior(self, p: Prior) -> None:
        copy_prior(self.prior, p)

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def capture(self) -> None:
        """Capture one graph per value of marg_old, from the blob and prior
        now in the static tensors (the warm-up runs read them; only a replay
        writes the prior).  Synchronizes the device."""
        side = torch.cuda.Stream(device=self.blob.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for marg_old in (True, False):
                for _ in range(self.WARMUP):
                    out = self.pack(self.step(self.blob, self.prior, marg_old))
        torch.cuda.current_stream().wait_stream(side)
        self.out = torch.empty_like(out)
        for marg_old in (True, False):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                res = self.step(self.blob, self.prior, marg_old)
                self.out.copy_(self.pack(res))
                copy_prior(self.prior, res.prior)
            self.graphs[marg_old] = g
        self.captures += 1

    def replay(self, marg_old: bool) -> torch.Tensor:
        """One step on the static blob and prior; returns `out` (valid until
        the next replay)."""
        self.graphs[bool(marg_old)].replay()
        self.replays += 1
        return self.out


def stack_priors(priors) -> Prior:
    """The stacked prior [S, ...] of S streams' priors."""
    return Prior(J=torch.stack([p.J for p in priors]), r0=torch.stack([p.r0 for p in priors]),
                 lin=WindowState(*[torch.stack(xs) for xs in zip(*[p.lin for p in priors])]),
                 valid=torch.stack([p.valid for p in priors]))


def slot_prior(stacked: Prior, s: int) -> Prior:
    """Stream s's prior in a stacked prior (views)."""
    return Prior(J=stacked.J[s], r0=stacked.r0[s], lin=WindowState(*[x[s] for x in stacked.lin]),
                 valid=stacked.valid[s])


class BatchStepGraph:
    """The graph of `step(inp, prior) -> (out, kept prior)` for S streams,
    over static tensors: `inp` [S, D+1] (blob and selection flag per
    stream), the stacked `prior`, and `out` [S, R], the packed results."""

    WARMUP = 2

    def __init__(self, step, S: int, blob_numel: int, prior: Prior):
        self.step = step
        dt, dev = prior.J.dtype, prior.J.device
        self.inp = torch.zeros((S, blob_numel + 1), dtype=dt, device=dev)
        self.prior = stack_priors([prior] * S)
        self.out = None
        self.graph = None
        self.captures = 0
        self.replays = 0

    def capture(self) -> None:
        """Capture the graph from the input and prior now in the static
        tensors (the warm-up runs read them; only a replay writes the
        prior).  Synchronizes the device."""
        side = torch.cuda.Stream(device=self.inp.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                out, _ = self.step(self.inp, self.prior)
        torch.cuda.current_stream().wait_stream(side)
        self.out = torch.empty_like(out)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out, kept = self.step(self.inp, self.prior)
            self.out.copy_(out)
            copy_prior(self.prior, kept)
        self.graph = g
        self.captures += 1

    def replay(self) -> torch.Tensor:
        """One batched step; returns `out` (valid until the next replay)."""
        self.graph.replay()
        self.replays += 1
        return self.out
