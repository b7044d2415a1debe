"""A decode dispatch captured as a CUDA graph.

The JAX engine compiles one XLA program per step key and launches a
decode dispatch, all its fused steps, as that one program
(dynamo_tpu/engine/engine.py: `_get_step_fn`, cached and counted by
`_cache_jit`). The port's counterpart is a CUDA graph per key, captured at
the key's first dispatch over static device buffers and replayed after the
dispatch's host arrays are copied into them (TorchEngine._get_step_fn).

`StaticInputs` holds the buffers, each with a pinned host twin that a
dispatch's array is written into and copied from asynchronously.
`StepGraph` warms its body up, captures it, and replays it.

Kernel launches inside a graph are counted through replays: a capture
runs nothing, so the launches its wrappers counted are taken back and
added again on every replay (ops.COUNTS).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dynamo_tpu_torch.ops import COUNTS


class StaticInputs:
    """Named device buffers of fixed shapes and dtypes, each landed from a
    pinned host twin by an asynchronous copy. Every fill writes every
    buffer whole (padding rows too), so no buffer keeps a row of an
    earlier dispatch."""

    def __init__(self, specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device):
        # pinned, so the copies are asynchronous; a host twin is rewritten
        # only after the dispatch's ids reached the host, which follows its copy
        self._host = {name: torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")
                      for name, (shape, dtype) in specs.items()}
        self.host = {name: t.numpy() for name, t in self._host.items()}
        #: the device buffers a captured body reads
        self.device = {name: torch.zeros(shape, dtype=dtype, device=device)
                       for name, (shape, dtype) in specs.items()}

    def fill(self, arrays: dict[str, np.ndarray]) -> None:
        """Copy every named array, whole, into its device buffer."""
        if arrays.keys() != self.host.keys():
            raise ValueError(f"a fill names {sorted(arrays)}, the buffers are {sorted(self.host)}")
        for name, a in arrays.items():
            dst = self.host[name]
            if a.shape != dst.shape:
                raise ValueError(f"{name}: array of shape {a.shape} for a buffer of {dst.shape}")
            dst[...] = a
            self.device[name].copy_(self._host[name], non_blocking=True)


class StepGraph:
    """One step key's body, captured over its own StaticInputs. Calling it
    fills the buffers from host arrays, replays, and returns the static
    output, which the caller must copy out before any other graph that
    shares the memory pool replays (see `capture`)."""

    def __init__(self, specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device):
        self.inputs = StaticInputs(specs, device)
        self.graph = torch.cuda.CUDAGraph()
        self.out: torch.Tensor | None = None
        #: kernel variant -> launches (and plain calls) one replay makes
        self.launches: dict[str, tuple[int, int]] = {}
        self.replays = 0
        #: device memory the graph reads that no one else keeps alive (the
        #: decode workspace it was captured over)
        self.keep: tuple = ()

    def capture(self, body: Callable[[dict], torch.Tensor], pool,
                stream: torch.cuda.Stream) -> None:
        """Run body once on `stream` outside any capture, over the buffers
        as they are (zero: padding rows only, valid False, no history, so
        the write lands nothing and attention reads only the null page),
        which builds every kernel and starts cuBLAS there; then capture it
        on `stream` into `pool`. Graphs sharing a pool may reuse each
        other's intermediate memory, which is safe only because they
        replay one at a time and each replay's output is read before the
        next replay."""
        dev_stream = torch.cuda.current_stream(stream.device)
        stream.wait_stream(dev_stream)
        with torch.cuda.stream(stream):
            body(self.inputs.device)
        dev_stream.wait_stream(stream)
        before = {k: (c.launches, c.plain_calls) for k, c in COUNTS.items()}
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = body(self.inputs.device)
        for k, c in COUNTS.items():
            n = (c.launches - before[k][0], c.plain_calls - before[k][1])
            c.launches, c.plain_calls = before[k]  # the capture ran nothing
            if n != (0, 0):
                self.launches[k] = n

    def __call__(self, arrays: dict[str, np.ndarray]) -> torch.Tensor:
        self.inputs.fill(arrays)
        self.graph.replay()
        self.replays += 1
        for k, (launches, plain) in self.launches.items():
            COUNTS[k].launches += launches
            COUNTS[k].plain_calls += plain
        return self.out
