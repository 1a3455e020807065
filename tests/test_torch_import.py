"""The port's paper-reproduction path against the JAX package's tools: the
reference-checkpoint importer (``diffse_tpu_torch.cli.convert_torch_checkpoint``
against ``tools/convert_torch_checkpoint.py``), ``cli.single_snrize`` against
``tools/single_snrize.py`` and ``cli.reproduce_tables`` against
``tools/reproduce_tables.py``.

One fabricated Lightning ``.ckpt`` of each kind (the reference's layout: a
``dnn.``-prefixed state_dict, ``hyper_parameters`` and a torch_ema shadow
list) goes through both importers; the port's restored tensors must be the
checkpoint's bit for bit, and its forward the JAX restored model's within
rtol 1e-5, atol 1e-6 (tests/test_torch_enhance.py's tolerance).
"""

import filecmp
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.train.restore import load_score_model as jax_load_score_model
from diffse_tpu.train.restore import load_snr_model as jax_load_snr_model
from diffse_tpu_torch.cli import convert_torch_checkpoint as port_conv
from diffse_tpu_torch.cli import reproduce_tables as port_tables
from diffse_tpu_torch.cli import single_snrize as port_snrize
from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
from diffse_tpu_torch.models.snrnet import SNRNet
from diffse_tpu_torch.train.restore import load_score_model, load_snr_model
from diffse_tpu_torch.train.state import eval_variables, load_ema
from test_torch_ncsnpp import random_jax_params

torch.set_num_threads(2)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(_TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_conv = _tool("convert_torch_checkpoint")
jax_tables = _tool("reproduce_tables")

# tests/test_convert.py's tiny NCSN++
TINY = dict(nf=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=16)
ARCH_ARGS = [a for k, v in TINY.items() for a in ("--arch", f"{k}={v!r}")]
HYPER = dict(sde="bbed", model_type="sebridge_v3", snr_conditioned="true", fixed_snr=0.17783,
             sigma_max=1.0, k=2.6, theta=0.52, T_sampling=0.999)
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)


def _save_ckpt(path, state_dict, hyper_parameters, shadow=None):
    ckpt = {"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in state_dict.items()},
            "hyper_parameters": hyper_parameters}
    if shadow is not None:
        ckpt["ema"] = {"shadow_params": [torch.from_numpy(np.ascontiguousarray(v))
                                         for v in shadow]}
    torch.save(ckpt, path)
    return path


@pytest.fixture(scope="module")
def score_ckpt(tmp_path_factory):
    """A reference-layout score checkpoint of the tiny NCSN++ with seeded
    random weights, and an EMA shadow of 0.5 x the parameters without the
    GFP ``W`` (torch_ema skips requires_grad=False parameters)."""
    params = random_jax_params(TINY, seed=7, frames=16)
    corr = jax_conv.ncsnpp_correspondence(**TINY)
    sd = {k: np.asarray(v, np.float32)
          for k, v in jax_conv.convert_flax_to_state_dict(params, corr).items()}
    gfp_w = {f"dnn.{tp}.W" for tp, _, kind in corr if kind == "gfp"}
    assert gfp_w == {"dnn.all_modules.0.W"}
    shadow = [0.5 * v for k, v in sd.items() if k not in gfp_w]
    path = str(tmp_path_factory.mktemp("score") / "ref.ckpt")
    return _save_ckpt(path, sd, HYPER, shadow), sd, gfp_w


@pytest.fixture(scope="module")
def imported(score_ckpt, tmp_path_factory):
    """The same .ckpt through both importers (``--ema``, the same
    ``--arch``), each restored by its own package."""
    path, _, _ = score_ckpt
    root = tmp_path_factory.mktemp("imported")
    jax_conv.main(["--torch_ckpt", path, "--out_dir", str(root / "jax"), "--ema", *ARCH_ARGS])
    port_conv.main(["--torch_ckpt", path, "--out_dir", str(root / "port"), "--ema", *ARCH_ARGS])
    return (jax_load_score_model(str(root / "jax")),
            load_score_model(str(root / "port"), device="cpu"), root)


def test_score_params_are_the_checkpoints_bitwise(score_ckpt, imported):
    _, sd, _ = score_ckpt
    _, (_, state), _ = imported
    restored = state.module.state_dict()
    assert sorted(restored) == sorted(k[len("dnn."):] for k in sd)
    for key, value in sd.items():
        assert torch.equal(restored[key[len("dnn."):]], torch.from_numpy(value)), key
    assert state.step == 0


def test_score_ema_is_the_shadow_with_the_gfp_w_live(score_ckpt, imported):
    """The EMA is the shadow list in the state_dict's order without the GFP
    ``W``, which is no EMA parameter and evaluates with its live value."""
    _, sd, gfp_w = score_ckpt
    _, (_, state), _ = imported
    ema = dict(zip(state.names, state.ema))
    assert sorted(ema) == sorted(k[len("dnn."):] for k in sd if k not in gfp_w)
    for name, value in ema.items():
        assert torch.equal(value, torch.from_numpy(0.5 * sd["dnn." + name])), name
    variables = eval_variables(state)
    for key in gfp_w:
        assert torch.equal(variables[key[len("dnn."):]], torch.from_numpy(sd[key]))


def test_score_hparams_match_the_jax_restore(imported):
    (jax_model, _), (model, _), root = imported
    for field in ("backbone", "sde", "model_type", "snr_conditioned", "fixed_snr", "sigma_max"):
        assert getattr(model.cfg, field) == getattr(jax_model.cfg, field), field
    assert model.hparams["sde_kwargs"] == jax_model.hparams["sde_kwargs"] == dict(
        k=2.6, theta=0.52, T_sampling=0.999)
    written = [json.load(open(root / side / "hparams.json")) for side in ("jax", "port")]
    assert written[0] == written[1]


def test_score_forward_matches_the_jax_restore(imported):
    """The restored EMA weights' forward (the consistency output of
    sebridge_v3) on one seeded input, port on the CPU vs JAX."""
    (jax_model, jax_state), (model, state), _ = imported
    rng = np.random.default_rng(0)
    shape = (1, 1, 16, 16)
    x, y = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
            for _ in range(2))
    t = np.asarray([0.5], np.float32)
    ref = jax.jit(lambda v, *a: jax_model.forward(v, *a)[0])(
        {"params": jax_state.ema_params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        out = model.forward(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
                            variables=eval_variables(state))
    assert float(np.max(np.abs(np.asarray(ref)))) > 1e-2  # the network is live
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FORWARD_TOL)


@pytest.mark.parametrize("sde", [None, "bbed", "bbve", "ouve", "proposed_1"])
def test_hparams_defaults_match_the_jax_tool(score_ckpt, tmp_path, sde):
    """Empty ``hyper_parameters`` and each SDE of the JAX tool's defaults
    (none of its keywords in the checkpoint): both tools write the same
    hparams, and the port restores the written config."""
    _, sd, _ = score_ckpt
    path = _save_ckpt(str(tmp_path / "ref.ckpt"), sd, {} if sde is None else {"sde": sde})
    for side, tool in (("jax", jax_conv), ("port", port_conv)):
        tool.main(["--torch_ckpt", path, "--out_dir", str(tmp_path / side), *ARCH_ARGS])
    written = [json.load(open(tmp_path / side / "hparams.json")) for side in ("jax", "port")]
    assert written[0] == written[1]
    config = written[1]["config"]
    assert (config["backbone"], config["sde"], config["model_type"], config["snr_conditioned"],
            config["fixed_snr"], config["sigma_max"]) == (
        "ncsnpp", sde or "bbed", "sebridge_v3", "true", 1.0, 1.0)
    defaults = dict(port_conv.SDE_DEFAULTS[sde or "bbed"])
    assert port_conv.SDE_DEFAULTS == jax_conv._SDE_DEFAULTS
    if sde == "bbve":  # the legacy name of BBED: sigma_max is its k
        defaults = dict(k=defaults.pop("sigma_max"), theta=defaults["theta"],
                        T_sampling=defaults["T_sampling"])
    assert written[1]["sde_kwargs"] == defaults
    model, _ = load_score_model(str(tmp_path / "port"), device="cpu")
    assert model.cfg.sde == config["sde"] and model.hparams["sde_kwargs"] == defaults


def _snrnet_state_dict(seed):
    """The reference SNRNet's state_dict under ``dnn.`` with seeded random
    values: both LSTM biases non-zero, which flax folds into one."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in SNRNet().state_dict().items():
        z = rng.standard_normal(tuple(value.shape)).astype(np.float32)
        out["dnn." + key] = (0.1 * z if value.ndim == 1
                             else z / np.sqrt(value[0].numel())).astype(np.float32)
    assert np.abs(out["dnn.blstm.bias_hh_l0"]).min() > 0
    return out


@pytest.fixture(scope="module")
def snr_ckpt(tmp_path_factory):
    sd, ema = _snrnet_state_dict(3), _snrnet_state_dict(4)
    path = str(tmp_path_factory.mktemp("snr") / "snr_estimator.ckpt")
    return _save_ckpt(path, sd, {"transform_type": "none"}, list(ema.values())), sd, ema


def test_snrnet_import_matches_the_jax_tool(snr_ckpt, tmp_path):
    """``--kind snrnet --ema``: the port keeps both LSTM biases, its
    parameters and EMA are the checkpoint's bit for bit, and its EMA forward
    matches the JAX restore's (which sums the biases)."""
    path, sd, ema = snr_ckpt
    for side, tool in (("jax", jax_conv), ("port", port_conv)):
        tool.main(["--torch_ckpt", path, "--out_dir", str(tmp_path / side), "--kind", "snrnet",
                   "--ema"])
    jax_model, jax_state = jax_load_snr_model(str(tmp_path / "jax"))
    model, state = load_snr_model(str(tmp_path / "port"), device="cpu")
    assert model.cfg.transform_type == jax_model.cfg.transform_type == "none"
    restored = state.module.state_dict()
    for key, value in sd.items():
        assert torch.equal(restored[key[len("dnn."):]], torch.from_numpy(value)), key
    assert state.names == [k[len("dnn."):] for k in ema]
    for name, e in zip(state.names, state.ema):
        assert torch.equal(e, torch.from_numpy(ema["dnn." + name])), name
    x = np.random.default_rng(5).standard_normal((2, 2, 256, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_model.dnn.apply)({"params": jax_state.ema_params},
                                                  jnp.asarray(x)))
    load_ema(state)
    with torch.no_grad():
        out = model.dnn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **FORWARD_TOL)


@pytest.mark.parametrize("kind", ["score", "snrnet"])
def test_wrong_shadow_count_raises(score_ckpt, snr_ckpt, tmp_path, kind):
    path, sd, _ = score_ckpt if kind == "score" else snr_ckpt
    ckpt = torch.load(path)
    ckpt["ema"]["shadow_params"] = ckpt["ema"]["shadow_params"][:-1]
    torch.save(ckpt, str(tmp_path / "short.ckpt"))
    argv = ["--torch_ckpt", str(tmp_path / "short.ckpt"), "--out_dir", str(tmp_path / "out"),
            "--ema", "--kind", kind] + (ARCH_ARGS if kind == "score" else [])
    with pytest.raises(ValueError, match="EMA shadow count"):
        port_conv.main(argv)


@pytest.mark.parametrize("change", ["missing", "unexpected", "not under dnn."])
def test_state_dict_key_mismatch_names_the_key(score_ckpt, tmp_path, change):
    """A key the model lacks, or one of the model's that the checkpoint
    lacks, is an error naming it (nothing is dropped silently)."""
    _, sd, _ = score_ckpt
    sd = dict(sd)
    if change == "missing":
        key = "all_modules.4.Conv_1.bias"
        del sd["dnn." + key]
    else:
        key = "dnn.all_modules.4.extra" if change == "unexpected" else "sde_buffer"
        sd[key] = np.zeros(3, np.float32)
    path = _save_ckpt(str(tmp_path / "ref.ckpt"), sd, HYPER)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        port_conv.main(["--torch_ckpt", path, "--out_dir", str(tmp_path / "out"), *ARCH_ARGS])


@pytest.mark.parametrize("arch", ["dtype='bf16'", "conditional=False", "snr_conditioning=True"])
def test_arch_outside_the_jax_tools_layout_is_refused(score_ckpt, tmp_path, arch):
    path, _, _ = score_ckpt
    with pytest.raises(SystemExit):
        port_conv.main(["--torch_ckpt", path, "--out_dir", str(tmp_path / "out"),
                        *ARCH_ARGS, "--arch", arch])


def test_single_snrize_matches_the_jax_tool(tmp_path):
    """Both tools on one small split (the second pair loud enough for the
    clip protection): the same wavs and active_rms.txt, byte for byte."""
    from diffse_tpu_torch.data.wavio import write_wav

    jax_snrize = _tool("single_snrize")
    rng = np.random.default_rng(2)
    in_dir = tmp_path / "in"
    for sub in ("clean", "noisy"):
        os.makedirs(in_dir / sub)
    t = np.arange(8000) / 16000
    for i, (amp, noise) in enumerate(((0.3, 0.05), (0.9, 0.02), (0.2, 0.1))):
        clean = (amp * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32)
        write_wav(str(in_dir / "clean" / f"u{i}.wav"), clean, 16000)
        write_wav(str(in_dir / "noisy" / f"u{i}.wav"),
                  clean + (noise * rng.standard_normal(len(t))).astype(np.float32), 16000)
    for side, tool in (("jax", jax_snrize), ("port", port_snrize)):
        tool.main(["--in_dir", str(in_dir), "--out_dir", str(tmp_path / side),
                   "--target_snr", "-5"])
    names = [f"{sub}/u{i}.wav" for sub in ("clean", "noisy", "noise") for i in range(3)]
    names.append("active_rms.txt")
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", names,
                                               shallow=False)
    assert sorted(match) == sorted(names), (mismatch, errors)


@pytest.fixture(scope="module")
def synthetic_valid(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vbd"))
    make_synthetic_dataset(root, num_train=0, num_valid=3, num_valid2=0, num_test=0,
                           duration_s=1.2)
    return os.path.join(root, "valid")


def test_mixture_scores_match_the_jax_tool(synthetic_valid):
    ours, ref = (tool._mixture_scores(synthetic_valid) for tool in (port_tables, jax_tables))
    assert sorted(ours) == sorted(ref) == ["estoi", "pesq", "si_sdr"]
    for metric in ref:
        np.testing.assert_allclose(ours[metric], ref[metric], rtol=1e-6)


def test_tables_constants_are_the_jax_tools():
    for name in ("TABLE1", "SNR_GRID", "TABLE2_PESQ", "TABLE3_SISDR", "ETA_FIXED_SNR",
                 "M_NAME"):
        assert getattr(port_tables, name) == getattr(jax_tables, name), name


def _dry_run(tmp_path, capsys, *flags):
    """The port's ``--synthetic_dry_run --device cpu`` with ``flags``: exit
    code 0 and the dry-run verdict. Returns the printed output."""
    rc = port_tables.main(["--synthetic_dry_run", "--device", "cpu", "--out_dir",
                           str(tmp_path), *flags])
    assert rc == 0
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if "[tables] RESULT" in l][-1]
    res = json.loads(line.split("RESULT ", 1)[1])
    assert res["verdict"].startswith("DRY-RUN COMPLETE")
    return out


def _check_table1(tmp_path, out):
    table = port_tables.read_columns(str(tmp_path / "table1" / "_results.csv"))
    assert len(table["filename"]) == 3
    assert all(len(table[m]) == 3 for m in ("pesq", "si_sdr", "estoi"))
    for cell in ("mixture PESQ", "mixture ESTOI", "mixture SI-SDR", "M6 PESQ", "M6 ESTOI",
                 "M6 SI-SDR"):
        assert f"  {cell:<28} ours=" in out, f"missing comparison line for {cell}"


def test_reproduce_tables_dry_run_table1(tmp_path, capsys):
    """The dry run's Table 1 alone (the harness's --skip_tables23): the
    eval CLI over the 3 synthetic valid files, the mixture row and every
    M6 comparison line."""
    out = _dry_run(tmp_path, capsys, "--skip_tables23")
    _check_table1(tmp_path, out)
    assert not (tmp_path / "tables23").exists()


def _check_tables23(tmp_path, out):
    table = port_tables.read_columns(str(tmp_path / "tables23" / "_results_deep.csv"))
    assert len(table["filename"]) == 2 and len(table) == 28
    for s in port_tables.SNR_GRID:
        for m in ("pesq", "si_sdr", "estoi"):
            assert len(table[f"{m}_{s}"]) == 2, f"missing {m}_{s}"
    for cell in [f"{m} @ {s:+d} dB" for m in ("PESQ", "SI-SDR") for s in port_tables.SNR_GRID]:
        assert f"  {cell:<28} ours=" in out, f"missing comparison line for {cell}"


@pytest.mark.slow
def test_reproduce_tables_synthetic_dry_run(tmp_path, capsys):
    """The whole dry run, with the JAX dry run's checks
    (tests/test_debug_and_tools.py, slow there too): Table 1 as above, the
    9-SNR sweep's 27 columns for both valid2 files and every per-SNR
    comparison line. ~57 s on 2 CPU threads: the tool's tiny NCSN++ attends
    at resolution 128, 12,288 positions at the 1.2 s files' 192 frames,
    three times a forward, and the sweep runs 18 forwards."""
    out = _dry_run(tmp_path, capsys)
    _check_table1(tmp_path, out)
    _check_tables23(tmp_path, out)


def test_reproduce_tables_enforced_fails_on_untrained_weights(tmp_path, capsys):
    """The enforced protocol end to end on port checkpoint directories
    (passed through) of a tiny untrained SNR-conditioned model on a 0.5 s
    stand-in: both tables, exit code 1 with every one of the 24 cells
    failing, and the fixed_snr warning for another eta's row."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.models.snr_model import SNRModel
    from diffse_tpu_torch.train import CheckpointManager, TrainState

    vbd = str(tmp_path / "vbd")
    make_synthetic_dataset(vbd, num_train=0, num_valid=3, num_valid2=2, num_test=0,
                           duration_s=0.5)
    model = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                                        snr_conditioned="true", fixed_snr=0.17783,
                                        sigma_max=1.0),
                       backbone_kwargs=dict(nf=4, ch_mult=(1, 1), num_res_blocks=1,
                                            attn_resolutions=(), image_size=256),
                       sde_kwargs=dict(k=2.6, theta=0.52, T_sampling=0.999), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "score"), hparams=model.hparams).save(
        0, TrainState(model.backbone))
    torch.manual_seed(1)
    snr = SNRModel(device="cpu")
    CheckpointManager(str(tmp_path / "snr"), hparams=snr.hparams).save(0, TrainState(snr.dnn))
    rc = port_tables.main(["--vbd_dir", vbd, "--ckpt", str(tmp_path / "score"), "--snr_ckpt",
                           str(tmp_path / "snr"), "--eta", "5", "--device", "cpu", "--out_dir",
                           str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "does not match eta=5" in out and "converting" not in out
    res = json.loads([l for l in out.splitlines() if "[tables] RESULT" in l][-1].split(
        "RESULT ", 1)[1])
    assert res["verdict"].startswith("PARITY FAIL (24 cells)")
    _check_tables23(tmp_path, out)
    for cell in ("mixture PESQ", "M5 PESQ", "M5 ESTOI", "M5 SI-SDR"):
        assert f"  {cell:<28} ours=" in out


def test_reproduce_tables_requires_inputs_without_dry_run():
    with pytest.raises(SystemExit):
        port_tables.main([])


def test_ensure_checkpoint_imports_once(snr_ckpt, tmp_path, capsys):
    """A .ckpt is imported into ``converted_<kind>`` once; a port checkpoint
    directory passes through; a directory without hparams.json is refused."""
    path, _, _ = snr_ckpt
    out = port_tables.ensure_checkpoint(path, "snrnet", str(tmp_path))
    assert out == str(tmp_path / "converted_snrnet")
    assert port_tables.ensure_checkpoint(path, "snrnet", str(tmp_path)) == out
    assert port_tables.ensure_checkpoint(out, "snrnet", str(tmp_path / "other")) == out
    assert capsys.readouterr().out.count("[tables] converting") == 1
    load_snr_model(out, device="cpu")
    with pytest.raises(FileNotFoundError):
        port_tables.ensure_checkpoint(str(tmp_path), "score", str(tmp_path))


def test_the_new_modules_import_neither_jax_nor_the_reference():
    """Every import statement of the three modules names the port (relative)
    or a third-party package, never jax, diffse_tpu or the root tools."""
    import ast

    for module in (port_conv, port_snrize, port_tables):
        tree = ast.parse(open(module.__file__).read())
        names = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                 for alias in node.names]
        names += [node.module for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.level == 0]
        assert not [n for n in names if n.split(".")[0] in ("jax", "diffse_tpu", "tools")], names
