"""The fused resample interval on the card: one training step captured as a
CUDA graph and replayed for each epoch of the interval.  It is the
counterpart of the JAX trainers' ``train_interval`` (``steps_per_call =
neg_every``: a ``lax.scan`` of the interval's steps in one dispatch,
``tpugraph/train/loop.py::fit``), and removes the per-step Python launch
cost and the host synchronise after each step.

``train/loop.py::train_loop`` keeps the interval boundary eager (encoder
forward, proposals, mining, draws: the shortlist paths do data-dependent
host work) and copies each boundary's batch into this step's static
buffers (``load``).  ``CapturedStep`` holds:

* the static batch: every tensor the step reads (pairs, weights,
  negatives, ``fit_mtl``'s draws), copied in at each boundary;
* one captured ``train_step``, the step the unfused loop runs eagerly:
  ``zero_grad``, forward, loss, backward and the step of a capturable
  Adam (``train/optim.py``), whose learning rate is a
  device tensor that ``LambdaLR`` fills between replays;
* with dropout, the generator of the mask, registered with the graph and
  reseeded before each replay with ``loop.step_seed``, so a replayed epoch
  draws the mask that the eager epoch draws from a fresh
  ``loop.step_generator``;
* with ``check_finite`` (``--debug-nans``), a static flag that each replay
  folds the step's ``finite_flag`` into on the device; the loop resets it
  before an interval and reads it at the interval's one synchronise.

Before capture, one warm-up step on the capture stream builds and loads
every kernel, allocates the wrappers' per-stream scratch, cuBLAS's
workspace and Adam's state; then the parameters and Adam's state are put
back as they were, so the warm-up leaves no trace in the run.  A failure
during capture or replay raises: nothing falls back to the eager path.
"""

from __future__ import annotations

from collections.abc import Callable

import torch


def train_step(opt: torch.optim.Optimizer,
               loss_fn: Callable[[dict, torch.Generator | None], tuple[torch.Tensor, dict]],
               batch: dict[str, torch.Tensor], gen: torch.Generator | None,
               after_backward: Callable[[], None] | None = None
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training step: ``zero_grad``, forward and loss (the dropout mask
    from ``gen``), backward, ``after_backward`` (the distributed trainer's
    sum of the replicated weights' gradients over the ranks), the
    optimizer's step.  The unfused loop runs it eagerly and
    ``CapturedStep`` captures it; the caller steps the learning-rate
    schedule after it.  Returns the loss and ``aux``, detached."""
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(batch, gen)
    loss.backward()
    if after_backward is not None:
        after_backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def finite_flag(opt: torch.optim.Optimizer, loss: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool on the loss's device, computed there without a
    synchronise: whether the step's loss, every gradient and every updated
    parameter of ``opt`` are finite."""
    params = [p for g in opt.param_groups for p in g["params"]]
    ts = [loss, *params, *(p.grad for p in params if p.grad is not None)]
    return torch.stack([torch.isfinite(t).all() for t in ts]).all()


class CapturedStep:
    """One training step over ``opt``'s parameters, captured on ``dev``.
    ``loss_fn(batch, generator)`` returns (loss, aux) with grad, as
    ``train_loop``'s; ``batch`` gives the static buffers' shapes and
    types; ``after_backward`` as ``train_step``'s.  The caller must hold
    no autograd graph of the parameters (a loss it kept): a parameter's
    gradient accumulator lives as long as such a graph, on the stream that
    made it, and the capture stream's backward would then wait on that
    stream, which capture forbids."""

    def __init__(self, opt: torch.optim.Adam,
                 loss_fn: Callable[[dict, torch.Generator | None], tuple[torch.Tensor, dict]],
                 batch: dict[str, torch.Tensor], dev: torch.device, dropout: bool,
                 check_finite: bool = False,
                 after_backward: Callable[[], None] | None = None):
        if dev.type != "cuda":
            raise ValueError(f"a captured step runs on the card, not {dev}")
        if not all(g["capturable"] for g in opt.param_groups):
            raise ValueError("a captured step needs a capturable Adam (make_optimizer)")
        self.opt, self.loss_fn, self.dev = opt, loss_fn, dev
        self.after_backward = after_backward
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.gen = torch.Generator(device=dev) if dropout else None
        self.stream = torch.cuda.Stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        # the replays' finite flag (check_finite); None when not checked
        self.finite = torch.ones((), dtype=torch.bool, device=dev) if check_finite else None
        self._warm_up()
        if self.gen is not None:
            self.graph.register_generator_state(self.gen)
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.loss, self.aux = train_step(opt, loss_fn, self.batch, self.gen, after_backward)
            if self.finite is not None:
                self.finite &= finite_flag(opt, self.loss)

    def _warm_up(self) -> None:
        """One eager step on the capture stream, then the parameters and
        Adam's state as they were (a state Adam had not made yet is zero,
        as a fresh one is)."""
        params = [p for g in self.opt.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        state = {p: {k: v.clone() for k, v in self.opt.state[p].items()}
                 for p in params if p in self.opt.state}
        self.stream.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.stream):
            if self.gen is not None:
                self.gen.manual_seed(0)
            train_step(self.opt, self.loss_fn, self.batch, self.gen, self.after_backward)
            with torch.no_grad():
                for p, v in zip(params, saved):
                    p.copy_(v)
                for p in params:
                    for k, v in self.opt.state[p].items():
                        if p in state:
                            v.copy_(state[p][k])
                        else:
                            v.zero_()
        torch.cuda.current_stream(self.dev).wait_stream(self.stream)
        self.opt.zero_grad(set_to_none=True)

    def load(self, batch: dict[str, torch.Tensor]) -> None:
        """Copy an interval's batch into the static buffers (and set the
        finite flag)."""
        if self.finite is not None:
            self.finite.fill_(True)
        for k, buf in self.batch.items():
            src = batch[k]
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(f"batch[{k!r}] is {src.dtype} {tuple(src.shape)}, the "
                                 f"captured step reads {buf.dtype} {tuple(buf.shape)}")
            buf.copy_(src)

    def replay(self, seed: int | None = None) -> torch.Tensor:
        """Run the step once, its dropout mask (if any) from ``seed``;
        returns a copy of its loss.  ``aux`` holds the last replay's."""
        if self.gen is not None:
            self.gen.manual_seed(seed)
        self.graph.replay()
        return self.loss.clone()
