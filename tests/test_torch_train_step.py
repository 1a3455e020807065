"""The port's train step against the JAX package's, on the CPU.

  - One update from given gradients: the JAX package's own
    ``make_train_step`` runs on a loss whose gradient is exactly the given
    tree (the sum of each parameter times its gradient), and the port's
    ``TrainState.apply_gradients`` takes the same gradients through the
    bridge; the parameters and the EMA within 1e-6, over two updates (Adam's
    bias correction and the EMA's warm-up move with the step).
  - Three full steps of the paper's loss (sebridge_v3, snr_conditioned
    true) on the tiny network, each with the JAX step's own draws: the loss
    within 1e-4 relative, the parameters within 2 * lr * 3 (Adam's first
    updates are ~lr * sign(g), and a gradient near zero may take the other
    sign in the other framework).
  - ``accum_steps=2`` against the average of the two microbatches'
    gradients computed by hand.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffse_tpu.train.state import create_train_state
from diffse_tpu.train.steps import make_train_step as jax_make_train_step
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.train import (TrainState, ema_decay_schedule, eval_variables,
                                    make_eval_step, make_train_step)
from test_torch_train_loss import TINY, jax_loss_draws, make_models, spec_pair

torch.set_num_threads(2)

LR = 1e-4


def _by_name(tree) -> dict:
    return {k: v.numpy() for k, v in
            state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), **TINY).items()}


def _port_params(state) -> dict:
    return {name: p.detach().numpy().copy() for name, p in state.module.named_parameters()}


def _port_ema(state) -> dict:
    return {name: e.numpy().copy() for name, e in zip(state.names, state.ema)}


def test_ema_schedule_matches_torch_ema():
    assert float(ema_decay_schedule(0.999, 1)) == pytest.approx(2 / 11)
    assert float(ema_decay_schedule(0.999, 10_000)) == pytest.approx(0.999)
    assert ema_decay_schedule(0.999, 3).dtype == np.float32


def test_update_from_given_gradients_matches_jax():
    jax_model, params, port = make_models("true", "sebridge_v3")
    rng = np.random.default_rng(20)
    grads = [jax.tree_util.tree_map_with_path(
        lambda path, p: np.zeros_like(p) if path[-1].key == "W" and p.ndim == 1
        else rng.standard_normal(p.shape).astype(np.float32), params) for _ in range(2)]

    class GivenGradients:
        """A loss whose gradient with respect to the params is the batch."""

        @staticmethod
        def loss_fn(variables, batch, key, train=True):
            terms = jax.tree_util.tree_map(lambda p, g: jnp.sum(p * g), variables["params"],
                                           batch)
            return sum(jax.tree_util.tree_leaves(terms)), {}

    opt = optax.adam(LR)
    jax_state = create_train_state({"params": params}, opt)
    step = jax_make_train_step(GivenGradients, opt, ema_decay=0.999, donate=False)
    for g in grads:
        jax_state, _ = step(jax_state, g, jax.random.PRNGKey(0))

    state = TrainState(port.backbone, lr=LR, ema_decay=0.999)
    for g in grads:
        by_name = _by_name(g)
        state.apply_gradients([torch.from_numpy(by_name[n]) for n in state.names])
    assert state.step == int(jax_state.step) == 2
    ref_params = _by_name(jax_state.variables["params"])
    ref_ema = _by_name(jax_state.ema_params)
    for name, p in _port_params(state).items():
        np.testing.assert_allclose(p, ref_params[name], rtol=0, atol=1e-6, err_msg=name)
    for name, e in _port_ema(state).items():
        np.testing.assert_allclose(e, ref_ema[name], rtol=0, atol=1e-6, err_msg=name)


def test_three_steps_match_jax():
    jax_model, params, port = make_models("true", "sebridge_v3")
    batches = [spec_pair(30 + i) for i in range(3)]
    keys = [jax.random.PRNGKey(40 + i) for i in range(3)]

    opt = optax.adam(LR)
    jax_state = create_train_state({"params": params}, opt)
    jax_step = jax_make_train_step(jax_model, opt, ema_decay=0.999, donate=False)
    ref_losses = []
    for (x, y), key in zip(batches, keys):
        jax_state, metrics = jax_step(jax_state, (jnp.asarray(x), jnp.asarray(y)), key)
        ref_losses.append(float(metrics["train_loss"]))

    state = TrainState(port.backbone, lr=LR, ema_decay=0.999)
    step = make_train_step(port)
    losses = []
    for (x, y), key in zip(batches, keys):
        draws = jax_loss_draws(jax_model, key, jnp.asarray(x))
        port.draw_loss_noise = lambda like, generator, draws=draws: draws
        state, metrics = step(state, (torch.from_numpy(x), torch.from_numpy(y)), None)
        losses.append(float(metrics["train_loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ref_params = _by_name(jax_state.variables["params"])
    for name, p in _port_params(state).items():
        np.testing.assert_allclose(p, ref_params[name], rtol=0, atol=2 * LR * 3, err_msg=name)
    assert state.step == 3


def test_accum_step_matches_manual_average():
    _, _, port = make_models("false", "sebridge_v2")
    manual = copy.deepcopy(port)
    micro = [spec_pair(50), spec_pair(51)]
    batch = tuple(torch.from_numpy(np.stack([m[i] for m in micro])) for i in range(2))

    state = TrainState(port.backbone, lr=LR)
    step = make_train_step(port, accum_steps=2)
    state, metrics = step(state, batch, torch.Generator().manual_seed(52))
    assert state.step == 1

    manual_state = TrainState(manual.backbone, lr=LR)
    gen = torch.Generator().manual_seed(52)
    grads_sum, loss_sum = None, 0.0
    for x, y in micro:
        mb = (torch.from_numpy(x), torch.from_numpy(y))
        loss = manual.loss_fn(mb, gen)
        g = torch.autograd.grad(loss, manual_state.params)
        grads_sum = g if grads_sum is None else [a + b for a, b in zip(grads_sum, g)]
        loss_sum += loss.item()
    params0 = [p.detach().clone() for p in manual_state.params]
    manual_state.apply_gradients([g / 2 for g in grads_sum])

    assert float(metrics["train_loss"]) == pytest.approx(loss_sum / 2, rel=1e-5)
    for a, e in zip(state.params, manual_state.params):
        np.testing.assert_allclose(a.detach().numpy(), e.detach().numpy(), rtol=1e-4, atol=1e-6)
    # the EMA takes the updated parameters at the first step's decay, 2/11
    d = 2 / 11
    np.testing.assert_allclose(state.ema[0].numpy(),
                               (d * params0[0] + (1 - d) * manual_state.params[0]).detach().numpy(),
                               rtol=1e-4, atol=1e-6)


def test_eval_variables_and_eval_step_take_the_ema():
    _, _, port = make_models("false", "sebridge_v2")
    state = TrainState(port.backbone, lr=LR)
    state.apply_gradients([torch.ones_like(p) for p in state.params])
    ev = eval_variables(state)
    assert all(ev[n] is e for n, e in zip(state.names, state.ema))
    assert ev["all_modules.0.W"] is port.backbone.all_modules[0].W  # frozen: no EMA
    raw = eval_variables(state, no_ema=True)
    assert all(raw[n] is p for n, p in zip(state.names, state.params))
    batch = tuple(torch.from_numpy(a) for a in spec_pair(60))
    eval_step = make_eval_step(port)
    ema_loss = eval_step(ev, batch, torch.Generator().manual_seed(1))["valid_loss"]
    raw_loss = eval_step(None, batch, torch.Generator().manual_seed(1))["valid_loss"]
    assert not port.backbone.training and ema_loss.grad_fn is None
    assert float(ema_loss) != float(raw_loss)
    # the EMA weights through functional_call equal them loaded in the module
    swapped = copy.deepcopy(port)
    swapped.backbone.load_state_dict(ev)
    again = make_eval_step(swapped)(None, batch, torch.Generator().manual_seed(1))["valid_loss"]
    assert torch.equal(again, ema_loss)


def test_step_refuses_what_is_not_ported():
    """``chain_steps`` and the mesh are ported: ``chain_steps=2`` is two
    single steps (the same updates, bitwise, and the losses), and a step
    over a one-rank mesh (a gloo group of this process) is the plain step,
    bitwise. What the step still refuses: a ``state_sharding`` without its
    mesh, and a state laid out over another mesh than the step's."""
    import torch.distributed as dist

    from diffse_tpu_torch.parallel import make_mesh, state_shardings
    from diffse_tpu_torch.parallel.mesh import init_single_process

    batches = [tuple(torch.from_numpy(a) for a in spec_pair(70 + i)) for i in range(2)]
    runs = []
    for chain in (1, 2):
        _, _, port = make_models("false", "sebridge_v2")
        state = TrainState(port.backbone, lr=LR)
        step = make_train_step(port, chain_steps=chain)
        gen = torch.Generator().manual_seed(71)
        if chain == 1:
            losses = [float(step(state, b, gen)[1]["train_loss"]) for b in batches]
        else:
            metrics = step(state, tuple(torch.stack(t) for t in zip(*batches)), gen)[1]
            assert float(metrics["train_loss_mean"]) == pytest.approx(np.mean(runs[0][1]))
            losses = [float(metrics["train_loss"])]
        runs.append((state, losses))
    assert runs[1][0].step == 2 and runs[1][1][0] == runs[0][1][1]
    for a, b in zip(runs[0][0].params + runs[0][0].ema, runs[1][0].params + runs[1][0].ema):
        assert torch.equal(a, b)

    init_single_process("cpu")
    try:
        mesh = make_mesh("cpu")
        updates = []
        for m in (None, mesh):
            _, _, port = make_models("false", "sebridge_v2")
            state = TrainState(port.backbone, lr=LR, mesh=m)
            loss = make_train_step(port, mesh=m)(state, batches[0],
                                                 torch.Generator().manual_seed(72))[1]
            updates.append((loss["train_loss"], [p.detach().clone() for p in state.params]))
        assert torch.equal(updates[0][0], updates[1][0])
        assert all(torch.equal(a, b) for a, b in zip(updates[0][1], updates[1][1]))
        with pytest.raises(ValueError, match="needs its mesh"):
            make_train_step(port, state_sharding=state_shardings(mesh, port.backbone))
        with pytest.raises(ValueError, match="another mesh"):
            make_train_step(port, mesh=mesh)(TrainState(port.backbone, lr=LR), batches[0],
                                             torch.Generator().manual_seed(72))
    finally:
        dist.destroy_process_group()
