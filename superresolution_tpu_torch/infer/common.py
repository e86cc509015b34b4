"""Shared helpers for the deploy-time inference rewrites.

Counterpart of superresolution_tpu/infer/common.py: the convs the JAX
package leaves to XLA are plain F.conv2d here, on NHWC tensors with
PyTorch's OIHW weights. Weights are read from a BasicSR-keyed state dict
(models/convert.py bridges the JAX trees into one).

Graphed has no counterpart in the reference, whose jit already runs a
stage as one program: it replays a deploy stage as a CUDA graph, for a
CUDA input with autograd off, and runs every other call eagerly. See
its docstring for the key it keeps one graph for, what it freezes, why
outputs are the caller's, and what the kernels' `.launches` count.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F


def state_tensors(params: Mapping, device: torch.device
                  ) -> dict[str, torch.Tensor]:
    """A state dict of numpy arrays or tensors -> detached tensors on
    `device`, each keeping its dtype."""
    return {k: (v.detach() if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v))).to(device)
            for k, v in params.items()}


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv kernel -> contiguous HWIO, the layout the kernels read."""
    return w.permute(2, 3, 1, 0).contiguous()


def conv_nhwc(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None = None,
              padding: str = "same") -> torch.Tensor:
    """Conv of NHWC `x` with an OIHW kernel (+ optional bias), in x's
    dtype; returns contiguous NHWC."""
    w = w.to(x.dtype)
    b = None if b is None else b.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def param_conv(x: torch.Tensor, params: Mapping[str, torch.Tensor],
               name: str, padding: str = "same") -> torch.Tensor:
    """conv_nhwc on the `name.weight` / `name.bias` entries of a state dict."""
    return conv_nhwc(x, params[f"{name}.weight"], params[f"{name}.bias"],
                     padding)


class PreboundModel:
    """A deploy model whose weights are bound already (fused_rrdb_model,
    fused_hybrid_model): .apply(_params, x) ignores the params, as the
    reference's PreboundModel, so the tilers take it in place of a module
    and its state dict; calling it runs the bound function too.
    `graphed`: the Graphed wrappers its stages run through (their
    counters), if any."""

    def __init__(self, apply_fn, graphed: tuple = ()):
        self._fn = apply_fn
        self.graphed = tuple(graphed)

    def apply(self, _params, x: torch.Tensor) -> torch.Tensor:
        return self._fn(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._fn(x)


def wants_graph(x: torch.Tensor) -> bool:
    """Whether Graphed replays a graph for input x: a CUDA tensor with
    autograd off (no_grad or inference_mode)."""
    return x.device.type == "cuda" and not torch.is_grad_enabled()


class Graphed:
    """fn (one tensor in, one tensor out, its weights bound) replayed as
    a CUDA graph where wants_graph(x) holds; every other call (CPU
    tensors, autograd on) runs fn(x) unchanged and counts in `eager`.

    One graph is kept, for the key of the call that captured it: x's
    shape, dtype and device, and whether inference mode is on. A call
    with another key (counted in `captures`) drops it, runs fn once
    eagerly on a side stream, which fills fn's lazy caches (cast
    weights, region ids, cuBLAS and cuDNN handles, kernel attributes)
    outside the graph, returns the memory that warm-up cached to the
    card (the graph allocates from a pool of its own), captures fn into
    a static input and output, and returns the replay's result; calls
    with the same key (`replays`) copy x into the static input, replay,
    and return a clone of the static output: what a call returns is
    the caller's and never aliases the graph's buffer. Whatever fn
    reads besides x (levers, weights) is frozen in the graph as its
    capture read it. Graphs made with share=other use other's memory
    pool and stream: safe, since replays run one at a time on the
    caller's stream and each output is copied out before the next.

    The kernels' `.launches` counters count launches on the host, at
    their wrappers: a capturing call launches fn's kernels twice (the
    warm-up and the capture pass), a replay none."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 share: Graphed | None = None):
        self._fn = fn
        self._owner = share or self
        self._key = self._graph = self._x_in = self._out = None
        self._pool = self._stream = None
        self.captures = self.replays = self.eager = 0

    @staticmethod
    def key(x: torch.Tensor) -> tuple:
        return (tuple(x.shape), x.dtype, x.device,
                torch.is_inference_mode_enabled())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not wants_graph(x):
            self.eager += 1
            return self._fn(x)
        k = self.key(x)
        if k == self._key:
            self.replays += 1
        else:
            self._capture(x)
            self._key = k
            self.captures += 1
        self._x_in.copy_(x)
        self._graph.replay()
        return self._out.clone()

    def _capture(self, x: torch.Tensor) -> None:
        self._key = self._graph = self._x_in = self._out = None
        own = self._owner
        if own._stream is None:
            own._stream = torch.cuda.Stream(x.device)
            own._pool = torch.cuda.graph_pool_handle()
        s = own._stream
        x_in = x.clone()
        s.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(s):
            self._fn(x_in)  # the warm-up: lazy caches filled, not captured
        # the warm-up's activations stay cached for the side stream, which
        # nothing else allocates on: they go back to the card
        torch.cuda.empty_cache()
        with torch.cuda.stream(s):
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=own._pool,
                                capture_error_mode="thread_local")
            try:
                out = self._fn(x_in)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(x.device).wait_stream(s)
        self._graph, self._x_in, self._out = graph, x_in, out
