"""Rank functions of the port's frames-parallel CPU tests
(``tests/test_torch_sequence.py``), run by
``diffse_tpu_torch.parallel.dryrun.launch`` in spawned gloo ranks. Spawned
ranks import this module by name, so it imports nothing of JAX."""

import numpy as np
import torch

from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.snrnet import SNRNet
from diffse_tpu_torch.parallel import make_seq_mesh
from diffse_tpu_torch.parallel.mesh import world_size
from diffse_tpu_torch.parallel.sequence import constrain_frames, mesh_key
from diffse_tpu_torch.transforms import width_bucket


def port_model(spec) -> ScoreModel:
    """``spec``: "config", "backbone", "sde", "weights" (a state_dict) and,
    for an SNR-conditioned model, "snr_weights" (SNRNet's)."""
    snr = None
    if spec.get("snr_weights") is not None:
        snr = SNRNet()
        snr.load_state_dict(spec["snr_weights"], strict=True)
    model = ScoreModel(ScoreModelConfig(**spec["config"]), backbone_kwargs=spec["backbone"],
                       sde_kwargs=spec["sde"], device="cpu", snr_model=snr)
    model.backbone.load_state_dict(spec["weights"], strict=True)
    return model


def noise_from(draws):
    """A noise source handing out ``draws`` (numpy arrays) in order, each of
    the shape it is asked for; with ``draws`` an int, a generator of that
    seed's draws."""
    if isinstance(draws, int):
        generator = torch.Generator().manual_seed(draws)
        return lambda like: torch.randn(like.shape, dtype=like.dtype, generator=generator)
    it = iter(draws)

    def noise(like):
        z = torch.from_numpy(np.array(next(it)))
        assert tuple(z.shape) == tuple(like.shape)
        return z

    return noise


def enhance(model, case, seq_mesh=None):
    """``model.enhance`` of the case's waveforms on its draws."""
    return model.enhance(case["x"], case["y"], noise=noise_from(case["draws"]),
                         seq_mesh=seq_mesh, **case["kwargs"])


@torch.no_grad()
def ode_steps(model, case, seq_mesh=None):
    """``bbed_ode``'s start and ``case["attempts"]`` step attempts (the
    solver's reduced RMS norms: its initial step and each attempt's error)
    on the case's waveform padded to its width bucket, over ``seq_mesh``'s
    frames when given: the carry's flags, t and h, and its state's whole
    frames."""
    y = torch.from_numpy(case["y"])
    _, pad = width_bucket(y.shape[-1], model.cfg.hop_length)
    y = torch.nn.functional.pad(y, (0, pad - y.shape[-1]))
    with constrain_frames(seq_mesh) as seq:
        noise = noise_from(case["draws"])
        carry = model._ode_start(noise if seq is None else seq.draws(noise), 30, y)
        for _ in range(case["attempts"]):
            carry = model._ode_attempt(30, carry)
        state = carry["y"] if seq is None else seq.gather(carry["y"])
    return {"flags": carry["flags"].tolist(), "t": float(carry["t"]), "h": float(carry["h"]),
            "y": state.numpy()}


def sequence_cases(rank, cases):
    """Each case on this rank, by its "kind": "enhance" (the case's model
    and waveforms, ``enhance`` over a frames mesh of every rank, its axis
    named "axis"; returns the waveform, the model's captured programs after
    it and the mesh's key), "ode_steps" (``ode_steps`` over that mesh),
    "eval" (``cli.eval.main`` of "argv") or
    "too_many" (``make_seq_mesh`` of one rank more than the world: the
    error). Returns the results by case name."""
    torch.set_num_threads(1)
    out = {}
    for case in cases:
        if case["kind"] == "enhance":
            mesh = make_seq_mesh(device_type="cpu", axis_name=case.get("axis", "seq"))
            model = port_model(case["model"])
            out[case["name"]] = {"wave": enhance(model, case, mesh),
                                 "graphs": len(model._graphs), "mesh_key": mesh_key(mesh)}
        elif case["kind"] == "ode_steps":
            mesh = make_seq_mesh(device_type="cpu")
            out[case["name"]] = ode_steps(port_model(case["model"]), case, mesh)
        elif case["kind"] == "eval":
            from diffse_tpu_torch.cli import eval as eval_cli

            out[case["name"]] = eval_cli.main(case["argv"])
        elif case["kind"] == "too_many":
            try:
                make_seq_mesh(world_size() + 1, device_type="cpu")
                out[case["name"]] = None
            except ValueError as e:
                out[case["name"]] = str(e)
    return out
