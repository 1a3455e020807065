"""Programs captured once as CUDA graphs and replayed: the port's counterpart
of ``jax.jit``, which compiles a program once and runs it.

``ScoreModel._enhance_jit`` (diffse_tpu/models/score_model.py) compiles
normalise -> STFT -> sampler -> iSTFT into one XLA program per shape bucket.
Here the same work launches ~1,300 kernels a network forward from Python;
``Program`` records them once into a CUDA graph (``torch.cuda.graph``) and
replays the graph, so that a call costs one graph launch on the host.

A program is a function ``fn(generator, **inputs)`` of static device
tensors that only launches work on the card: nothing in it may wait on the
device (a blocking copy, ``.item()``), and what it keeps between calls (the
kernels' ticket counters, packed or cast weights, FIR filters) must exist
before the capture. Building a ``Program``:

1. copies the example inputs into static buffers (Python numbers become
   float32 0-d tensors);
2. runs ``fn`` once on the device's capture stream (the warm-up): cuDNN
   and cuFFT settle their plans, the model packs and casts its weights,
   the kernels' library loads, and the wrappers make their per-stream
   state (the statistics pass's ticket counters) on this stream, for the
   batch the capture will see;
3. captures ``fn`` on that stream into a graph, with the program's own
   ``torch.Generator`` registered with it (``register_generator_state``),
   so that random draws inside the graph are graph-safe Philox draws;
4. keeps the static outputs and the kernels' launch counts made during the
   capture (``launch_counts``, ``conv_config_launches``, ``weight_casts``):
   a capture runs nothing on the card, and a replay launches the recorded
   kernels without passing through the wrappers, so the counts do not
   advance on replay. ``replays`` counts the replays: a program's kernel
   runs on the card are ``launch_counts`` times ``replays``.
   ``capture_seconds`` is the host time of steps 1-3 (the capture begins
   with a device synchronisation, so the warm-up run is in it).

Calling it copies the inputs into the buffers, sets the program's generator
to the caller's generator's state, replays, and hands the advanced state
back to the caller's generator: a replay draws what the eager function draws
from the same state and leaves the generator where the eager function
would.

The programs of one device are captured on one stream into one graph
memory pool (the caching allocator reuses a pool's free blocks only on the
stream that made them), so that a program per shape bucket adds to the
pool only what it needs beyond the largest program before it. Hence the
outputs are static buffers that the next call of any program on the device
may overwrite: copy them out before that call, and never replay two
programs of one device at once (on two streams or threads).

A capture that fails raises; nothing falls back to running ``fn`` eagerly.
"""

from __future__ import annotations

import numbers
import time
from typing import Callable, Dict, Union

import torch

from .ops import cuda_kernels
from .utils import forbid_capture

Value = Union[torch.Tensor, float]


_capture_sides = {}


def _capture_side(device: torch.device) -> tuple:
    """The stream that every program on ``device`` is warmed up and
    captured on, and the graph memory pool they share."""
    if device not in _capture_sides:
        _capture_sides[device] = (torch.cuda.Stream(device), torch.cuda.graph_pool_handle())
    return _capture_sides[device]


def _counts() -> tuple:
    return (dict(cuda_kernels.launch_counts), list(cuda_kernels.conv_config_launches),
            dict(cuda_kernels.weight_casts))


class Program:
    """``fn(generator, **inputs)`` captured as one CUDA graph on ``device``.

    Args:
        fn: the program; takes a ``torch.Generator`` on ``device`` and the
            inputs by name, and returns its outputs (tensors on ``device``,
            or anything holding them, with host values beside).
        inputs: example inputs by name (device or CPU tensors, or Python
            numbers for float32 scalars); the warm-up runs on these values.
        device: the CUDA device.
    """

    def __init__(self, fn: Callable, inputs: Dict[str, Value], device):
        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device)
        self.inputs = {}
        for name, value in inputs.items():
            if torch.is_tensor(value):
                self.inputs[name] = torch.empty(value.shape, dtype=value.dtype, device=self.device)
            else:
                self.inputs[name] = torch.empty((), dtype=torch.float32, device=self.device)
        self._fill(inputs)
        stream, pool = _capture_side(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            fn(self.generator, **self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        before = _counts()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = fn(self.generator, **self.inputs)
        after = _counts()
        self.launch_counts = {k: after[0][k] - before[0][k] for k in after[0]}
        self.conv_config_launches = [a - b for a, b in zip(after[1], before[1])]
        self.weight_casts = {k: after[2][k] - before[2][k] for k in after[2]}
        self.replays = 0
        self.capture_seconds = time.perf_counter() - t0

    def _fill(self, inputs: Dict[str, Value]) -> None:
        for name, value in inputs.items():
            buf = self.inputs[name]
            if torch.is_tensor(value):
                if tuple(value.shape) != tuple(buf.shape) or value.dtype != buf.dtype:
                    raise ValueError(f"input {name!r}: {value.dtype} {tuple(value.shape)}, the "
                                     f"program was captured for {buf.dtype} {tuple(buf.shape)}")
                if value.device.type == "cpu":  # a copy from pageable memory would block
                    value = value.pin_memory()
                buf.copy_(value, non_blocking=True)
            elif isinstance(value, numbers.Real):
                buf.fill_(float(value))
            else:
                raise TypeError(f"input {name!r}: a tensor or a real number, not {type(value)}")

    def __call__(self, generator: torch.Generator, **inputs: Value):
        """Replay with ``inputs`` (every input the program was built with)
        and ``generator``'s state; returns what ``fn`` returned at capture,
        whose tensors now hold this replay's results."""
        if inputs.keys() != self.inputs.keys():
            raise ValueError(f"inputs {sorted(inputs)}, the program takes {sorted(self.inputs)}")
        self._fill(inputs)
        self.generator.set_state(generator.get_state())
        self.graph.replay()
        self.replays += 1
        generator.set_state(self.generator.get_state())
        return self.outputs


class LoopProgram:
    """A loop whose trip count depends on the data, as three captured
    programs (``Program``): ``start``, one ``step``, ``finish``. A CUDA
    graph has a fixed body, so the host replays ``step`` ``steps_per_read``
    times (1 unless set) between reads of a done flag; those reads are the
    loop's only waits on the device.

    Args:
        start: ``start(generator, **inputs) -> carry``, a dict of device
            tensors whose ``"flags"`` entry is an int tensor with element 0
            non-zero once the loop is done.
        step: ``step(carry) -> carry`` (same keys, shapes and dtypes); once
            done it must return the carry unchanged, so that the result does
            not depend on ``steps_per_read``.
        finish: ``finish(generator, carry) -> outputs``.
        inputs, device: as for ``Program`` (the inputs are ``start``'s).

    The carry lives in buffers made at ``start``'s warm-up, outside the graph
    pool; each captured ``start`` and ``step`` writes its result there, and
    ``finish`` reads it. Calling the program returns ``finish``'s outputs;
    ``flags`` holds the last read of the flags (a list) and ``reads`` their
    number.
    """

    steps_per_read = 1

    def __init__(self, start: Callable, step: Callable, finish: Callable,
                 inputs: Dict[str, Value], device):
        self.device = torch.device(device)
        self.carry: Dict[str, torch.Tensor] = {}
        self.start = Program(lambda gen, **kw: self._store(start(gen, **kw)), inputs, self.device)
        self.step = Program(lambda gen: self._store(step(dict(self.carry))), {}, self.device)
        self.finish = Program(lambda gen: finish(gen, dict(self.carry)), {}, self.device)
        self.flags, self.reads = None, 0

    @property
    def programs(self) -> tuple:
        return self.start, self.step, self.finish

    def _store(self, carry: Dict[str, torch.Tensor]) -> None:
        if not self.carry:
            forbid_capture(self.device, "a loop's carry")
            self.carry = {k: torch.empty_like(v) for k, v in carry.items()}
        for k, v in carry.items():
            self.carry[k].copy_(v)

    def __call__(self, generator: torch.Generator, **inputs: Value):
        self.start(generator, **inputs)
        self.reads = 0
        while True:
            for _ in range(self.steps_per_read):
                self.step(generator)
            self.flags = self.carry["flags"].tolist()
            self.reads += 1
            if self.flags[0]:
                return self.finish(generator)
