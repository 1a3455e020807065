"""The enhance program as files that run with no model code (port of
diffse_tpu/serving/export.py, which serialises a ``jax.export`` program).

``save_artifact`` traces ``ScoreModel``'s bucket-static enhance program with
``torch.export``, for each distinct width bucket, as the programs of its
branch:

  - the one-forward branches (``sebridge``, ``sebridge_v2``,
    ``sebridge_v2_snr``, ``sebridge_v3_snr``): one program ``enhance``,
    normalise -> STFT -> the forward -> iSTFT;
  - ``bbed_pc``: ``start`` (normalise, STFT, the prior draw), ``step`` (one
    corrector and one predictor update, the JAX scan's body: it takes the
    step's grid values as inputs) and ``finish`` (the denoised mean, iSTFT);
    the grid (``ScoreModel._pc_grid``, computed once on the export device)
    is stored in ``meta["grid"]``, so that the loader runs the ``step``
    program N times on the values ``enhance`` runs;
  - ``bbed_ode``: ``start``, ``attempt`` (one RK45 attempt) and ``finish``
    (the denoising step, iSTFT), ``ScoreModel._ode_*``, which the loader
    runs as ``enhance`` runs them, reading the carry's done flag on the host
    after each attempt.

It writes

    artifact_dir/
      <program>_t<frames>.pt2  the exported programs of each width bucket
      weights.pt               the backbone's parameters and buffers by name
      prepared.pt              with the bf16 trunk: the bf16 casts and the
                               packed conv weights, by module name
      meta.json                format 2: branch, sampler, dtype, buckets and
                               their programs, the grid, the host contract

The hand kernels stay in the programs as the operators of
``ops.cuda_kernels`` (``torch.ops.diffse.*``): the loader imports that
kernel library, which registers them, and nothing of ``models``,
``sampling``, ``sde`` or ``transforms``. A program is traced for one
device, the one the model is on (``meta["device"]``), and loads there.

Every program takes ``(weights, prepared, carry, inputs, noise)``: the
weights (one dict, so that every program shares one copy); the bf16 trunk's
casts and packed weights (a dict, empty in float32), made once at export by
the blocks' own code (``layers.given_weights``), so that no program casts or
packs; the carry, the tensors one program hands the next (complex ones as
real views: the export carries complex tensors inside the graph, but its
inputs and outputs are real); the named inputs (``meta``'s per program: the
clean and noisy waveforms ``[1, pad_samples]`` and float32 scalars, the
corrector's ``snr``, ``t_hat`` and ``normfac`` of the ``_snr`` branches
snapped on the host from the client's ``est_snr`` as ``ScoreModel.enhance``
snaps it, ``karras.snap_to_karras_grid``, and a PC step's grid values); and
its draws. Each returns its carry or, last, the waveform ``[1, pad']``.

Randomness: a ``torch.Generator`` cannot be an input of an exported graph,
so a program takes its draws as an input, ``[n_draws, *shape, 2]`` float32
(the complex draws' real views). The loader draws them from
``torch.Generator(device).manual_seed(seed)`` one after the other, program
after program, with the shapes and in the order ``ScoreModel.enhance``
draws them (recorded at export per program), so that the artifact's output
is ``enhance``'s with ``generator=torch.Generator(device).manual_seed(seed)``.

On the card the loader runs each bucket as ``enhance`` runs the branch, a
captured CUDA graph with the draws inside it from the program's own
generator: the straight-line branches as one ``capture.Program`` (for
``bbed_pc``: ``start``, N calls of ``step``, ``finish`` in one graph),
``bbed_ode`` as a ``capture.LoopProgram``; all made when the artifact
loads, with cuDNN's convolutions and the matmuls pinned to float32 as the
model pins them (a process-wide switch, which the exported graph cannot
hold). ``bbed_pc`` runs on the linear time grid, as the JAX artifact does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..capture import LoopProgram, Program
from ..karras import snap_to_karras_grid
from ..ops import cuda_kernels  # noqa: F401  (registers torch.ops.diffse, which programs call)
from ..utils import float32_precision

FORMAT = 2
WEIGHTS_FILE = "weights.pt"
PREPARED_FILE = "prepared.pt"
META_FILE = "meta.json"
SAMPLE_RATE = 16000
EXPORTABLE_BRANCHES = ("bbed_pc", "bbed_ode", "sebridge", "sebridge_v2", "sebridge_v2_snr",
                       "sebridge_v3_snr")
# what every call gives the programs, as the loader's buffers
CALL_INPUTS = ("x_wav", "y_wav", "snr", "t_hat", "normfac")
_WEIGHT_PREFIX = "backbone."


def width_bucket(t_orig: int, hop_length: int):
    """``(t_pad_frames, pad_samples)`` of ``t_orig`` samples: this module's
    copy of ``transforms.width_bucket`` (frames padded up to a multiple of
    64), which the loader may not import."""
    frames = 1 + t_orig // hop_length
    t_pad = frames + (64 - frames % 64) % 64
    return t_pad, (t_pad - 1) * hop_length


def _phases(model, branch: str, n_steps: int, predictor: str, corrector: str,
            corrector_steps: int) -> dict:
    """The branch's programs in the order a call runs them: ``role -> (fn,
    inputs, carry)``, ``fn(noise, carry, **inputs)`` returning the carry's
    new entries or the waveform, the names of the call's inputs it takes,
    and the carry entries it reads (None: all of them)."""
    pc = (n_steps, predictor, corrector, corrector_steps)
    if branch == "bbed_pc":
        def pc_step(noise, carry, snr, t, step, std, end=None):
            out = model._pc_step(noise, *pc, carry, snr, t, step, std, end)
            return {"x": out["x"], "x_mean": out["x_mean"]}

        return {"start": (lambda noise, carry, y_wav: model._pc_start(noise, *pc, y_wav),
                          ("y_wav",), ()),
                "step": (pc_step, ("snr",), ("Y", "x")),
                "finish": (lambda noise, carry: model._pc_finish(carry), (),
                           ("x_mean", "norm_factor"))}
    if branch == "bbed_ode":
        return {"start": (lambda noise, carry, y_wav: model._ode_start(noise, n_steps, y_wav),
                          ("y_wav",), ()),
                "attempt": (lambda noise, carry: model._ode_attempt(n_steps, carry), (), None),
                "finish": (lambda noise, carry: model._ode_finish(noise, n_steps, carry), (),
                           None)}
    takes = (("y_wav",) + (("x_wav",) if branch == "sebridge_v2_snr" else ())
             + (("normfac",) if branch.endswith("_snr") else ())
             + (("t_hat",) if branch == "sebridge_v3_snr" else ()))

    def enhance(noise, carry, y_wav, x_wav=None, normfac=None, t_hat=None):
        return model._enhance_on_device(branch, noise, *pc, y=y_wav, x=x_wav, normfac=normfac,
                                        t_hat=t_hat)[0]

    return {"enhance": (enhance, takes, ())}


def _real(out, complex_keys: set):
    """A program's output with its complex carry entries as real views
    (their keys added to ``complex_keys``)."""
    if torch.is_tensor(out):
        return out
    complex_keys.update(k for k, v in out.items() if v.is_complex())
    return {k: torch.view_as_real(v) if v.is_complex() else v for k, v in out.items()}


class _Phase(torch.nn.Module):
    """One program's function with the backbone as a submodule, so that
    ``torch.func.functional_call`` can put the program's weights input in
    its place; ``noise`` is the draws' tensor, or (in the eager run at
    export) a ``noise(like)`` callable."""

    def __init__(self, model, fn, complex_keys: set):
        super().__init__()
        self.backbone = model.backbone
        self.fn, self.complex_keys = fn, complex_keys

    def forward(self, carry, inputs, noise):
        if torch.is_tensor(noise):
            draws = iter(torch.view_as_complex(noise).unbind(0) if noise.shape[0] else ())
            noise = lambda like: next(draws)  # noqa: E731
        carry = {k: torch.view_as_complex(v) if k in self.complex_keys else v
                 for k, v in carry.items()}
        return _real(self.fn(noise, carry, **inputs), self.complex_keys)


class _Program(torch.nn.Module):
    """The exported module: the phase with the weights and the prepared
    bf16 weights (``layers.given_weights``) as inputs; ``record`` (the
    eager run) makes the prepared weights into that dict."""

    def __init__(self, phase: _Phase, record: bool = False):
        super().__init__()
        self._phase, self.record = (phase,), record

    def forward(self, weights, prepared, carry, inputs, noise):
        from ..models.layers import given_weights

        phase = self._phase[0]
        with given_weights(phase.backbone, prepared, record=self.record):
            return torch.func.functional_call(phase, weights, (carry, inputs, noise))


def _weights(model, variables: Optional[dict]) -> dict:
    """The backbone's tensors by name, ``variables`` (e.g.
    ``train.state.eval_variables``) over its own, detached, as the programs'
    weights input (keys under ``_Phase``'s ``backbone.``)."""
    tensors = dict(model.backbone.named_parameters())
    tensors.update(model.backbone.named_buffers())
    tensors.update(variables or {})
    return {_WEIGHT_PREFIX + k: v.detach() for k, v in tensors.items()}


def _scalar(value: float, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _dtype_name(model) -> str:
    return str(getattr(model.backbone, "compute_dtype", torch.float32)).replace("torch.", "")


def export_enhance(model, variables: Optional[dict], branch: str, utt_samples: int,
                   n_steps: int = 30, predictor: str = "reverse_diffusion",
                   corrector: str = "ald", corrector_steps: int = 1,
                   prepared: Optional[dict] = None):
    """Trace the bucket-static programs of ``branch`` (``_phases``) of
    ``model`` (a ``ScoreModel`` on its device, float32 or bf16 trunk) for
    ``utt_samples``' width bucket.

    The programs first run once each, eagerly, in order, through the
    weights dict (``variables`` over the backbone's own): their draws and
    network forwards are counted, what the model keeps between calls (the
    FIR filters) is made, and the bf16 trunk's casts and packed weights go
    into ``prepared`` (a dict, filled in place; pass one dict for every
    bucket). Then each is exported. Returns ``(programs, info)``:
    ``programs`` a list of ``(role, ExportedProgram)`` in the order a call
    runs them, ``info`` a dict of ``t_pad``, ``pad_samples``, ``programs``
    (each one's ``role``, ``inputs``, ``carry``, ``draws`` and
    ``forwards``), ``draw_shape``, ``grid`` (``bbed_pc``: the steps' values
    by name, float32 as Python floats) and ``nfe`` (None for ``bbed_ode``,
    whose number of forwards depends on the data)."""
    if branch not in EXPORTABLE_BRANCHES:
        raise ValueError(f"branch {branch!r} cannot be exported; one of {EXPORTABLE_BRANCHES}")
    t_pad, pad_samples = width_bucket(utt_samples, model.cfg.hop_length)
    device = model.device
    prepared = {} if prepared is None else prepared
    weights = _weights(model, variables)
    rng = np.random.default_rng(0)
    wave = torch.from_numpy((0.1 * rng.standard_normal((1, pad_samples))).astype(np.float32))
    wave = wave.to(device)
    inputs = {"x_wav": wave, "y_wav": wave, "snr": _scalar(0.5, device),
              "t_hat": _scalar(0.5, device), "normfac": _scalar(1.0, device)}
    grid = None
    if branch == "bbed_pc":
        grid = model._pc_grid(n_steps, predictor, device)
        inputs.update({k: v[0] for k, v in grid.items()})

    phases, complex_keys = _phases(model, branch, n_steps, predictor, corrector,
                                   corrector_steps), set()
    forwards = [0]
    hook = model.backbone.register_forward_pre_hook(
        lambda module, args: forwards.__setitem__(0, forwards[0] + 1))
    carry, runs = {}, []
    try:
        for role, (fn, names, reads) in phases.items():
            if role == "step":
                names = names + tuple(grid)
            shapes, forwards[0] = [], 0

            def recording(like):
                shapes.append(tuple(like.shape))
                return torch.zeros_like(like)

            phase = _Phase(model, fn, complex_keys)
            given = {k: carry[k] for k in (carry if reads is None else reads)}
            ins = {k: inputs[k] for k in names}
            with torch.no_grad():
                out = _Program(phase, record=True)(weights, prepared, given, ins, recording)
            runs.append((role, phase, given, ins, shapes, forwards[0], names))
            if not torch.is_tensor(out):
                carry.update(out)
    finally:
        hook.remove()
    if any(r[0] == "attempt" and r[4] for r in runs):
        raise NotImplementedError("an ODE attempt that draws")
    shapes = {s for r in runs for s in r[4]}
    if len(shapes) > 1:
        raise NotImplementedError(f"draws of several shapes: {sorted(shapes)}")
    draw_shape = shapes.pop() if shapes else (1, 1, model.stft_cfg.num_freq_bins, t_pad)
    programs, info = [], []
    for role, phase, given, ins, drawn, n_forwards, names in runs:
        noise = torch.zeros((len(drawn), *draw_shape, 2), dtype=torch.float32, device=device)
        with torch.no_grad():
            exported = torch.export.export(_Program(phase),
                                           (weights, prepared, given, ins, noise))
        exported.example_inputs = None  # else each program's file would keep a copy of the weights
        programs.append((role, exported))
        info.append({"role": role, "inputs": list(names), "carry": list(given),
                     "draws": len(drawn), "forwards": n_forwards})
    nfe = None
    if branch != "bbed_ode":
        steps = len(grid["t"]) if grid is not None else 0
        nfe = sum(p["forwards"] * (steps if p["role"] == "step" else 1) for p in info)
    return programs, {
        "t_pad": t_pad, "pad_samples": pad_samples, "programs": info,
        "draw_shape": list(draw_shape), "nfe": nfe,
        "grid": None if grid is None else {k: v.cpu().tolist() for k, v in grid.items()}}


def save_artifact(path: str, model, variables: Optional[dict], branch: str, utt_samples,
                  n_steps: int = 30, predictor: str = "reverse_diffusion",
                  corrector: str = "ald", corrector_steps: int = 1,
                  oracle: bool = False) -> dict:
    """Export the programs of each distinct width bucket of ``utt_samples``
    (an int or a sequence of ints) and write them with the weights
    (``variables`` over the backbone's own; pass the EMA's), the bf16
    trunk's prepared weights and ``meta.json`` to ``path``; returns the
    meta. The loader serves each utterance with the smallest bucket that
    fits, the bucketing of ``ScoreModel.enhance``. ``meta["seconds"]`` has
    each bucket's export and save times."""
    lengths = ([utt_samples] if isinstance(utt_samples, (int, np.integer))
               else list(utt_samples))
    os.makedirs(path, exist_ok=True)
    buckets, seen, seconds, info, prepared = [], set(), [], None, {}
    for us in sorted(int(v) for v in lengths):
        # dedupe before the trace: two lengths often fall in one bucket
        if width_bucket(us, model.cfg.hop_length)[0] in seen:
            continue
        t0 = time.perf_counter()
        programs, info = export_enhance(model, variables, branch, us, n_steps=n_steps,
                                        predictor=predictor, corrector=corrector,
                                        corrector_steps=corrector_steps, prepared=prepared)
        t1 = time.perf_counter()
        seen.add(info["t_pad"])
        for (role, exported), program in zip(programs, info["programs"]):
            program["file"] = f"{role}_t{info['t_pad']}.pt2"
            torch.export.save(exported, os.path.join(path, program["file"]))
        seconds.append({"export": t1 - t0, "save": time.perf_counter() - t1})
        buckets.append({"t_pad_frames": info["t_pad"], "pad_samples": info["pad_samples"],
                        "programs": info["programs"], "draw_shape": info["draw_shape"]})
    t0 = time.perf_counter()
    weights = {k[len(_WEIGHT_PREFIX):]: v.cpu() for k, v in _weights(model, variables).items()}
    torch.save(weights, os.path.join(path, WEIGHTS_FILE))
    if prepared:
        torch.save({k: v.cpu() for k, v in prepared.items()}, os.path.join(path, PREPARED_FILE))
    meta = {
        "format": FORMAT,
        "branch": branch,
        "dtype": _dtype_name(model),
        "n_steps": n_steps,
        "predictor": predictor,
        "corrector": corrector,
        "corrector_steps": corrector_steps,
        "oracle": oracle,
        "device": model.device.type,
        "buckets": buckets,
        "grid": info["grid"],
        "prepared": PREPARED_FILE if prepared else None,
        # the JAX artifact's single-bucket mirrors
        "pad_samples": buckets[-1]["pad_samples"],
        "t_pad_frames": buckets[-1]["t_pad_frames"],
        "hop_length": model.cfg.hop_length,
        "sample_rate": SAMPLE_RATE,
        "model_type": model.cfg.model_type,
        "snr_conditioned": model.cfg.snr_conditioned,
        "fixed_snr": model.cfg.fixed_snr,
        "nfe": info["nfe"],
        "seconds": seconds,
        "weights_save_seconds": time.perf_counter() - t0,
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class _CachedHints:
    """The ``typing`` module as the export deserialiser sees it, with
    ``get_type_hints`` memoised: it asks for the hints of the same few schema
    classes once per graph node, which is most of a program's load time."""

    def __init__(self, typing_module):
        self._typing, self._hints = typing_module, {}

    def __getattr__(self, name):
        return getattr(self._typing, name)

    def get_type_hints(self, obj, globalns=None, localns=None, include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in self._hints:
            self._hints[key] = self._typing.get_type_hints(obj, globalns, localns,
                                                           include_extras)
        return self._hints[key]


_load_lock = threading.Lock()


def _load_program(path: str) -> torch.nn.Module:
    """``torch.export.load(path).module()``, its deserialiser's type-hint
    lookups memoised for the call (``_CachedHints``)."""
    from torch._export.serde import serialize

    with _load_lock:
        saved = getattr(serialize, "typing", None)
        if saved is not None:
            serialize.typing = _CachedHints(saved)
        try:
            return torch.export.load(path).module()
        finally:
            if saved is not None:
                serialize.typing = saved


class _Bucket:
    """One bucket's loaded programs (``role -> (meta, module)``), the draws'
    shape and, on the card, the captured graph: a ``capture.Program`` of
    the whole call, or for ``bbed_ode`` a ``capture.LoopProgram``.
    ``flags`` holds the ODE's last ``[done, nfev, attempts, status]``."""

    def __init__(self, programs: dict, weights: dict, prepared: dict, grid: Optional[dict],
                 info: dict, device: torch.device):
        self.programs, self.weights, self.prepared = programs, weights, prepared
        self.device = device
        self.pad_samples = int(info["pad_samples"])
        self.draw_shape = tuple(info["draw_shape"])
        self.loop = "attempt" in programs
        self.steps = []
        if grid is not None:
            grid = {k: torch.tensor(v, dtype=torch.float32, device=device)
                    for k, v in grid.items()}
            self.steps = [{k: v[i] for k, v in grid.items()} for i in range(len(grid["t"]))]
        count = {role: p["draws"] for role, (p, _) in programs.items()}
        # all of a call's draws: an ODE attempt draws none
        self.draws = sum(n * (len(self.steps) if role == "step" else 1)
                         for role, n in count.items())
        self._no_draws = torch.zeros((0, *self.draw_shape, 2), dtype=torch.float32,
                                     device=device)
        self.flags, self.program = None, None
        if device.type == "cuda":
            example = self._example()
            if self.loop:
                self.program = LoopProgram(
                    lambda gen, **inputs: self._call("start", self._drawn(gen), {}, inputs),
                    lambda carry: self._call("attempt", self._drawn(None), carry, {}),
                    lambda gen, carry: self._call("finish", self._drawn(gen), carry, {}),
                    example, device)
            else:
                self.program = Program(lambda gen, **inputs: self._run(self._drawn(gen), inputs),
                                       example, device)

    @property
    def capture_seconds(self) -> float:
        programs = self.program.programs if self.loop else (self.program,)
        return sum(p.capture_seconds for p in programs)

    def _example(self) -> dict:
        wave = torch.zeros((1, self.pad_samples), dtype=torch.float32)
        return {"x_wav": wave, "y_wav": wave, "snr": 0.5, "t_hat": 0.5, "normfac": 1.0}

    def _drawn(self, generator: Optional[torch.Generator]):
        """``noise(n)``: the next n draws from ``generator``, one by one in
        the sampler's order, as ``ScoreModel.enhance`` draws them
        (``utils.randn_like``)."""
        def noise(n):
            draws = [torch.randn(self.draw_shape, dtype=torch.complex64, device=self.device,
                                 generator=generator) for _ in range(n)]
            return torch.view_as_real(torch.stack(draws)) if draws else self._no_draws
        return noise

    def _call(self, role: str, noise, carry: dict, inputs: dict):
        """Program ``role`` on the carry and inputs it takes, with cuDNN's
        convolutions and the matmuls in float32 as the model pins them
        (``utils.float32_precision``): the exported graph holds the
        operations, not the process's TF32 switches, which otherwise let
        cuDNN take TF32 kernels (the default)."""
        p, module = self.programs[role]
        given = {k: carry[k] for k in p["carry"]}
        with float32_precision(self.device):
            return module(self.weights, self.prepared, given,
                          {k: inputs[k] for k in p["inputs"]}, noise(p["draws"]))

    def _run(self, noise, inputs: dict):
        """A whole call: the programs in order (``bbed_pc``'s step once for
        each of the grid's steps; ``bbed_ode``'s attempt until its done
        flag, read on the host), then the waveform."""
        if "enhance" in self.programs:
            return self._call("enhance", noise, {}, inputs)
        carry = self._call("start", noise, {}, inputs)
        if self.loop:
            while not carry["flags"][0]:
                carry = self._call("attempt", noise, carry, inputs)
            self.flags = carry["flags"].tolist()
        for grid in self.steps:
            carry.update(self._call("step", noise, carry, {**inputs, **grid}))
        return self._call("finish", noise, carry, inputs)

    def __call__(self, generator, draws: Optional[np.ndarray] = None, **inputs) -> torch.Tensor:
        """The programs on ``inputs`` with their draws from ``generator``, or
        the given ``draws`` (complex ``[n_draws, *shape]``, all of the
        call's in order), which run them eagerly."""
        if self.program is not None and draws is None:
            out = self.program(generator, **inputs)
            if self.loop:
                self.flags = self.program.flags
            return out
        tensors = {k: v.to(self.device) if torch.is_tensor(v) else _scalar(v, self.device)
                   for k, v in inputs.items()}
        with torch.no_grad():
            if draws is None:
                return self._run(self._drawn(generator), tensors)
            draws = np.asarray(draws, dtype=np.complex64)
            if draws.shape != (self.draws, *self.draw_shape):
                raise ValueError(f"draws of shape {draws.shape}; the program takes "
                                 f"{(self.draws, *self.draw_shape)}")
            given = torch.view_as_real(torch.from_numpy(draws)).to(self.device)
            taken = [0]

            def noise(n):
                taken[0] += n
                return given[taken[0] - n:taken[0]]

            return self._run(noise, tensors)


def load_artifact(path: str):
    """Load an artifact directory into an enhance callable that needs no
    model code.

    Returns ``(enhance, meta)`` where ``enhance(y_wav [T], seed=0,
    x_wav=None, est_snr=1.0, snr=0.5, draws=None) -> [T]`` (numpy float32)
    keeps the JAX loader's host contract: the smallest bucket that fits
    (``width_bucket``: when frames % 64 == 0 the bucket is up to hop-1
    samples shorter than the utterance, which is truncated, as
    ``ScoreModel.enhance`` does), zero-padding, and the output trimmed or
    zero-padded back to the input's length. The weights go to the device
    once; on the card each bucket's programs are warmed up and captured
    here. ``draws`` (complex ``[n_draws, *shape]``: all of a call's draws,
    as the bucket's ``draws`` and ``draw_shape`` say) replace the draws from
    ``seed`` and run the programs eagerly, so that two devices can be given
    the same noise. ``enhance`` is thread-safe (one call runs at a time);
    ``enhance.buckets`` are the loaded buckets (``_Bucket``). ``meta`` gains
    ``load_seconds``. An artifact of another format than this module's
    (``FORMAT``) is refused: export it again."""
    t0 = time.perf_counter()
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: artifact format {meta.get('format', 1)}, this loader reads "
                         f"format {FORMAT}; export it again (cli.export_artifact)")
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this artifact was exported for the card and there is no CUDA "
                           "device; export one on the CPU to run it there")
    weights = torch.load(os.path.join(path, WEIGHTS_FILE), map_location=device,
                         weights_only=True)
    weights = {_WEIGHT_PREFIX + k: v for k, v in weights.items()}
    prepared = {}
    if meta["prepared"]:
        prepared = torch.load(os.path.join(path, meta["prepared"]), map_location=device,
                              weights_only=True)
    buckets = []
    for info in sorted(meta["buckets"], key=lambda b: b["pad_samples"]):
        programs = {p["role"]: (p, _load_program(os.path.join(path, p["file"])))
                    for p in info["programs"]}
        buckets.append(_Bucket(programs, weights, prepared, meta["grid"], info, device))
    hop = int(meta["hop_length"])
    branch, fixed_snr = meta["branch"], meta["fixed_snr"]
    lock = threading.Lock()

    def enhance(y_wav, seed: int = 0, x_wav=None, est_snr: float = 1.0, snr: float = 0.5,
                draws: Optional[np.ndarray] = None):
        y_wav = np.asarray(y_wav, dtype=np.float32).reshape(-1)
        t_orig = y_wav.shape[-1]
        if t_orig == 0:
            raise ValueError("empty waveform")
        needed = width_bucket(t_orig, hop)[1]
        bucket = next((b for b in buckets if needed <= b.pad_samples), None)
        if bucket is None:
            raise ValueError(f"utterance of {t_orig} samples exceeds this artifact's largest "
                             f"bucket ({buckets[-1].pad_samples}); export a wider bucket")
        ps = bucket.pad_samples
        x_in = y_wav if x_wav is None else np.asarray(x_wav, dtype=np.float32).reshape(-1)
        yb = np.zeros((1, ps), np.float32)
        xb = np.zeros((1, ps), np.float32)
        yb[0, :min(t_orig, ps)] = y_wav[:ps]
        xb[0, :min(x_in.shape[-1], ps)] = x_in[:ps]
        t_hat, normfac = np.float32(0.5), np.float32(1.0)
        if branch.endswith("_snr"):
            t_hat, normfac = snap_to_karras_grid(est_snr, fixed_snr)
        with lock:
            generator = torch.Generator(device).manual_seed(int(seed))
            out = bucket(generator, draws, x_wav=torch.from_numpy(xb), y_wav=torch.from_numpy(yb),
                         snr=float(np.float32(snr)), t_hat=float(t_hat), normfac=float(normfac))
            x_hat = out[0, :t_orig].cpu().numpy()
        if x_hat.shape[-1] < t_orig:  # the frames % 64 == 0 bucket's tail
            x_hat = np.pad(x_hat, (0, t_orig - x_hat.shape[-1]))
        return x_hat

    enhance.buckets = buckets
    meta["load_seconds"] = time.perf_counter() - t0
    return enhance, meta


class ArtifactService:
    """``EnhanceService``'s face over an artifact directory: one utterance a
    request through the loaded program, no model code and no dynamic
    batching. Each request takes the next seed. ``*_snr`` artifacts hold
    no estimator: clients give ``est_snr`` (``?est_snr=`` on the HTTP
    front end), else 1.0."""

    def __init__(self, path: str, seed: int = 0):
        self._enhance, self.meta = load_artifact(path)
        self._seed = seed
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "audio_seconds": 0.0, "wall_seconds": 0.0, "errors": 0}

    def enhance(self, y_wav, est_snr=None, timeout=None):
        t0 = time.monotonic()
        with self._lock:
            seed = self._seed
            self._seed += 1
        try:
            out = self._enhance(y_wav, seed=seed,
                                est_snr=1.0 if est_snr is None else float(est_snr))
        except Exception:
            with self._lock:
                self._stats["errors"] += 1
            raise
        wall = time.monotonic() - t0
        with self._lock:
            self._stats["requests"] += 1
            self._stats["audio_seconds"] += np.size(y_wav) / SAMPLE_RATE
            self._stats["wall_seconds"] += wall
        return out

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        s["rtf_x_realtime"] = s["audio_seconds"] / s["wall_seconds"] if s["wall_seconds"] else 0.0
        s["buckets"] = [b["pad_samples"] for b in self.meta.get("buckets", [])]
        s["branch"] = self.meta.get("branch")
        return s

    def close(self, timeout: float = 0.0) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
