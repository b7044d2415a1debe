"""Engine dispatches captured as CUDA graphs, and their readback.

The JAX engine compiles one XLA program per step key and launches a
dispatch, a prefill chunk step or all the fused steps of a decode
dispatch, as that one program (dynamo_tpu/engine/engine.py: `_get_step_fn`,
cached and counted by `_cache_jit`). The port's counterpart is a CUDA
graph per key, captured at the key's first dispatch over static device
buffers and replayed after the dispatch's inputs are copied into them
(TorchEngine._get_step_fn).

`StaticInputs` holds the buffers, each with a pinned host twin that a
dispatch's array is written into and copied from asynchronously, or
filled on the device from another dispatch's output (a speculated decode
dispatch's tokens). `StepGraph` warms its body up, captures it, and
replays it. `Readback` starts a dispatch's outputs (the ids, and with
logprobs the chosen logprobs, top ids and top logprobs) on their way to
pinned host memory as soon as they are enqueued, so later replays may run
before the host reads them (the overlapped decode loop).

Kernel launches inside a graph are counted through replays: a capture
runs nothing, so the launches its wrappers counted are taken back and
added again on every replay (ops.COUNTS).
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.ops import COUNTS


class Readback:
    """A dispatch's outputs on the device and their copies to the host: the
    ids first, then any others (a logprob body's chosen logprobs, top ids
    and top logprobs). On the card each copy goes into a pinned tensor of
    its own, enqueued on the current stream right after the dispatch, with
    one event after them all: no later replay can overwrite an output
    before its copy has read it, and `numpy()` waits for the copies alone.
    On the CPU the outputs are already on the host."""

    def __init__(self, out: torch.Tensor | tuple[torch.Tensor, ...]):
        outs = out if isinstance(out, tuple) else (out,)
        #: the outputs on the device, valid until the next dispatch (a
        #: graph's static outputs are rewritten by later replays)
        self.outputs = outs
        self._ready = None
        self._host = outs
        if outs[0].is_cuda:
            # PyTorch's pinned allocator keeps these blocks until the copies ran
            self._host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                               for o in outs)
            for h, o in zip(self._host, outs):
                h.copy_(o, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()

    @property
    def device(self) -> torch.Tensor:
        """The ids on the device (a speculated dispatch's tokens)."""
        return self.outputs[0]

    def keep(self) -> None:
        """Copy the outputs on the device into memory of their own
        (enqueued on the current stream), for a reader on the device that
        comes after another replay: graphs that share a pool may overwrite
        each other's outputs (StepGraph.capture)."""
        self.outputs = tuple(o.clone() for o in self.outputs)

    def numpy(self) -> np.ndarray:
        """The ids on the host."""
        return self._all()[0]

    def extras(self) -> tuple[np.ndarray, ...]:
        """The outputs after the ids on the host (empty without any)."""
        return self._all()[1:]

    def _all(self) -> tuple[np.ndarray, ...]:
        if self._ready is not None:
            self._ready.synchronize()
        return tuple(h.numpy() for h in self._host)


class StaticInputs:
    """Named device buffers of fixed shapes and dtypes. Every fill writes
    every buffer whole (padding rows too), so no buffer keeps a row of an
    earlier dispatch: a host array lands from the buffer's pinned host twin
    by an asynchronous copy, a device tensor by a device-to-device copy,
    both on the current stream, after the dispatches enqueued before and
    before the replay that reads them."""

    def __init__(self, specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device):
        cuda = device.type == "cuda"
        # pinned, so the copies are asynchronous
        self._host = {name: torch.zeros(shape, dtype=dtype, pin_memory=cuda)
                      for name, (shape, dtype) in specs.items()}
        self.host = {name: t.numpy() for name, t in self._host.items()}
        #: the device buffers a captured body reads
        self.device = {name: torch.zeros(shape, dtype=dtype, device=device)
                       for name, (shape, dtype) in specs.items()}
        #: recorded after a fill's copies: the next fill rewrites the twins
        #: only once the copies have read them (a dispatch without readback,
        #: or one speculated before the last one was read, comes back to
        #: its twins before the device has run that far)
        self._copied = torch.cuda.Event() if cuda else None

    def fill(self, arrays: dict[str, np.ndarray | torch.Tensor]) -> None:
        """Copy every named array or device tensor, whole, into its buffer."""
        if arrays.keys() != self.host.keys():
            raise ValueError(f"a fill names {sorted(arrays)}, the buffers are {sorted(self.host)}")
        for name, a in arrays.items():
            buf = self.device[name]
            if tuple(a.shape) != tuple(buf.shape):
                raise ValueError(f"{name}: input of shape {tuple(a.shape)} for a buffer of "
                                 f"{tuple(buf.shape)}")
            if isinstance(a, torch.Tensor) and (a.dtype != buf.dtype or a.device != buf.device):
                raise ValueError(f"{name}: a {a.dtype} tensor on {a.device} for a {buf.dtype} "
                                 f"buffer on {buf.device}")
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            if isinstance(a, torch.Tensor):
                self.device[name].copy_(a)
                continue
            self.host[name][...] = a
            self.device[name].copy_(self._host[name], non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class StepGraph:
    """One step key's body, captured over its own StaticInputs. Calling it
    fills the buffers, replays, and returns a Readback of the static
    outputs (None for a body without any)."""

    def __init__(self, specs: dict[str, tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device):
        self.inputs = StaticInputs(specs, device)
        self.graph = torch.cuda.CUDAGraph()
        #: the body's output: a tensor or a tuple of them
        self.out: Optional[torch.Tensor | tuple[torch.Tensor, ...]] = None
        #: kernel variant -> launches (and plain calls) one replay makes
        self.launches: dict[str, tuple[int, int]] = {}
        self.replays = 0
        #: device memory the graph reads that no one else keeps alive (the
        #: decode workspace it was captured over)
        self.keep: tuple = ()

    def capture(self, body: Callable[[dict], Optional[torch.Tensor]], pool,
                stream: torch.cuda.Stream) -> None:
        """Run body once on `stream` outside any capture, over the buffers
        as they are (zero: padding rows only, valid False, no history, so
        the write lands nothing and attention reads only the null page),
        which builds every kernel and starts cuBLAS there; then capture it
        on `stream` into `pool`.

        Graphs sharing a pool may place one graph's output where another
        graph's intermediates live, so a replay may overwrite the output
        of any earlier replay. That is safe because every read of an
        output is enqueued on the engine's stream before the next replay:
        its copy to the host (Readback, started at the dispatch) and its
        copy into the next dispatch's inputs (StaticInputs.fill), or, where
        another replay comes between (a mixed step's pieces beside a
        consumed speculation), a copy of its own (Readback.keep). Replays
        run one at a time on that stream.

        The garbage collector is off during the capture: a collection
        there that frees another graph (one of an engine dropped in a
        reference cycle) resets it mid-capture, which CUDA forbids, and
        the capture fails."""
        dev_stream = torch.cuda.current_stream(stream.device)
        stream.wait_stream(dev_stream)
        with torch.cuda.stream(stream):
            body(self.inputs.device)
        dev_stream.wait_stream(stream)
        before = {k: (c.launches, c.plain_calls) for k, c in COUNTS.items()}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = body(self.inputs.device)
        finally:
            if collecting:
                gc.enable()
        for k, c in COUNTS.items():
            n = (c.launches - before[k][0], c.plain_calls - before[k][1])
            c.launches, c.plain_calls = before[k]  # the capture ran nothing
            if n != (0, 0):
                self.launches[k] = n

    def __call__(self, arrays: dict[str, np.ndarray | torch.Tensor]) -> Optional[Readback]:
        self.inputs.fill(arrays)
        self.graph.replay()
        self.replays += 1
        for k, (launches, plain) in self.launches.items():
            COUNTS[k].launches += launches
            COUNTS[k].plain_calls += plain
        return None if self.out is None else Readback(self.out)
