"""Training pieces of the port against the JAX package, f32 on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
Where two frameworks are compared, dropout is off on both sides: in JAX by
a ``flax.linen.intercept_methods`` interceptor that returns the input of
``nn.Dropout.__call__`` (every JAX function is built and traced inside it,
and never reused outside it: a traced function keeps the dropout it was
traced with), in the port by putting its dropout modules in eval mode.

* focal loss: 2 and 4 tasks, with and without class weights, within 1e-6
  of the loss (the losses reach ~24, where one f32 ulp is 1.9e-6);
* initializers: each leaf's std within 5% of flax's (pooled over 16 or 8
  draws of ``model.init``), ``wh @ wh.T`` the identity within 1e-5, zero biases,
  one seed one net;
* BatchNorm in training mode: the FA net's output within 1e-5 and the
  updated running statistics within 1e-6 of flax's
  ``apply(..., train=True, mutable=["batch_stats"])``;
* one AdamW step, both nets from the same ``model.init``: loss within 1e-6
  of the loss, each gradient within 1e-5 (pileup) or 2e-5 (FA) of its
  largest entry (a conv bias before BatchNorm, whose exact gradient is 0:
  within 1e-5 of the net's largest on both sides; the FA batch is one on
  which both frameworks' ReLUs pass the same units); the optimizer alone:
  the port's AdamW given JAX's gradients puts every parameter within 1e-6
  of optax's update of the same gradients; the whole step: each parameter
  within 1e-6 where its gradient is at least 1e-5 and 1e-4 of its leaf's
  largest (below, Adam's first step amplifies the gradient's f32 noise:
  within ``2 lr`` there), and the BatchNorm statistics within 1e-6;
* dropout: inverted, identity in eval mode, reproducible from a generator,
  and a training-mode forward without a generator raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
from clair3_tpu.models import PileupNet as JaxPileupNet
from clair3_tpu.train import loss as jax_loss
from clair3_tpu.train.step import create_train_state, make_train_step
from clair3_tpu_torch.config import LABEL_SHAPE
from clair3_tpu_torch.models import FullAlignmentNet, PileupNet
from clair3_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from clair3_tpu_torch.models.full_alignment import BatchNorm, ConvBNRelu, ResBlock
from clair3_tpu_torch.models.init import init_weights
from clair3_tpu_torch.models.layers import Dropout
from clair3_tpu_torch.models.params_io import flatten_tree
from clair3_tpu_torch.testing import random_variables
from clair3_tpu_torch.train.loss import multitask_loss
from clair3_tpu_torch.train.step import batch_loss, make_optimizer

# narrow pileup widths keep the JAX scan's compile short
NARROW = dict(lstm1_units=16, lstm2_units=24, l4_units=32, l5_units=16)


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def dropout_off(net):
    for m in net.modules():
        if isinstance(m, Dropout):
            m.eval()
    return net


def one_hot_labels(rng, n):
    """[n, 90] labels, one class set per task."""
    y = np.zeros((n, sum(LABEL_SHAPE)), np.float32)
    start = 0
    for size in LABEL_SHAPE:
        y[np.arange(n), start + rng.randint(0, size, n)] = 1.0
        start += size
    return y


def probabilities(rng, n, n_tasks):
    outs = []
    for size in LABEL_SHAPE[:n_tasks]:
        z = rng.randn(n, size).astype(np.float32) * 3
        e = np.exp(z - z.max(1, keepdims=True))
        outs.append(e / e.sum(1, keepdims=True))
    return np.concatenate(outs, 1).astype(np.float32)


@pytest.mark.parametrize("add_indel_length", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss_matches_jax(add_indel_length, weighted):
    rng = np.random.RandomState(3)
    n_tasks = 4 if add_indel_length else 2
    p = probabilities(rng, 64, n_tasks)
    p[0, 0], p[1, 1] = 0.0, 1.0  # the clamp at both ends
    y = one_hot_labels(rng, 64)
    cw = ([jax_loss.effective_class_weights(rng.randint(1, 500, s)).astype(np.float32)
           for s in LABEL_SHAPE] if weighted else None)
    want = float(jax_loss.multitask_loss(
        jnp.asarray(p), jnp.asarray(y), add_indel_length=add_indel_length, gamma=2.0,
        task_class_weights=[jnp.asarray(w) for w in cw] if cw else None))
    got = float(multitask_loss(
        torch.from_numpy(p), torch.from_numpy(y), add_indel_length=add_indel_length, gamma=2.0,
        task_class_weights=[torch.from_numpy(w) for w in cw] if cw else None))
    print(f"[train] focal loss {n_tasks} tasks weighted={weighted}: {got:.6f}, "
          f"|d| {abs(got - want):.3g}")
    # 1e-6 relative to the loss: at a loss of ~16 one f32 ulp is 1.9e-6
    assert np.isfinite(got) and abs(got - want) <= 1e-6 * max(1.0, abs(want))


def _pooled_std(leaves_by_draw):
    """key -> std pooled over draws (sum and sum of squares)."""
    acc = {}
    for flat in leaves_by_draw:
        for k, v in flat.items():
            v = np.asarray(v, np.float64)
            s, s2, n = acc.get(k, (0.0, 0.0, 0))
            acc[k] = (s + v.sum(), s2 + (v * v).sum(), n + v.size)
    return {k: np.sqrt(s2 / n - (s / n) ** 2) for k, (s, s2, n) in acc.items()}


@pytest.mark.parametrize("kind", ["pileup", "fa"])
def test_init_matches_flax_in_distribution(kind):
    draws = 16 if kind == "pileup" else 8  # the FA net's smallest drawn leaf has 384 entries
    if kind == "pileup":
        jax_net = JaxPileupNet(add_indel_length=True, **NARROW)
        x0 = np.zeros((2, 33, 18), np.int32)
        make = lambda: PileupNet(add_indel_length=True, **NARROW)  # noqa: E731
    else:
        jax_net = JaxFullAlignmentNet(add_indel_length=True, input_channels=8)
        x0 = np.zeros((2, 55, 33, 8), np.int8)
        make = lambda: FullAlignmentNet(input_channels=8)  # noqa: E731
    init = jax.jit(lambda key: jax_net.init(key, x0, train=False))
    flax_std = _pooled_std(flatten_tree(jax.device_get(init(jax.random.PRNGKey(s))))
                           for s in range(draws))
    nets = [init_weights(make(), torch.Generator().manual_seed(s)) for s in range(draws)]
    port_std = _pooled_std(flatten_tree(to_jax_variables(n.state_dict())) for n in nets)
    assert set(port_std) == set(flax_std)
    worst = 0.0
    for key, want in flax_std.items():
        if want == 0.0:  # zeros, ones: equal exactly
            np.testing.assert_array_equal(
                flatten_tree(to_jax_variables(nets[0].state_dict()))[key],
                np.asarray(flatten_tree(jax.device_get(init(jax.random.PRNGKey(0))))[key]))
            continue
        rel = abs(port_std[key] - want) / want
        worst = max(worst, rel)
        assert rel <= 0.05, (key, port_std[key], want)
    print(f"[train] init {kind}: worst std difference {100 * worst:.2f}% of flax's")
    for mod in (nets[0].LSTM1, nets[0].LSTM2) if kind == "pileup" else ():
        for d in range(2):
            wh = mod.wh[d].detach().double()
            np.testing.assert_allclose(wh @ wh.T, np.eye(wh.shape[0]), atol=1e-5)
    again = init_weights(make(), torch.Generator().manual_seed(0))
    for (k, a), b in zip(nets[0].state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    other = init_weights(make(), torch.Generator().manual_seed(1))
    assert not torch.equal(other.L4.kernel, nets[0].L4.kernel)


def _fa_variables(channels, seed=5):
    return random_variables(FullAlignmentNet(input_channels=channels), seed=seed)


def test_batchnorm_train_mode_matches_flax():
    v = _fa_variables(8)
    x = np.random.RandomState(11).randint(-100, 101, (8, 55, 33, 8)).astype(np.int8)
    with fnn.intercept_methods(no_dropout):
        want, mutated = JaxFullAlignmentNet(add_indel_length=True, input_channels=8).apply(
            v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net = dropout_off(FullAlignmentNet(input_channels=8).train())
    net.load_state_dict(from_jax_variables(v), strict=True)
    got = net(torch.from_numpy(x)).detach().numpy()
    err = np.abs(got - np.asarray(want)).max()
    want_stats = flatten_tree(jax.device_get(mutated["batch_stats"]))
    got_state = net.state_dict()
    stat_err = max(np.abs(got_state[k.replace("/", ".")].numpy() - w).max()
                   for k, w in want_stats.items())
    before = flatten_tree(v["batch_stats"])
    moved = max(np.abs(w - before[k]).max() for k, w in want_stats.items())
    print(f"[train] BN train mode: max |dp| {err:.3g}, running stats max |d| "
          f"{stat_err:.3g} (moved by up to {moved:.3g})")
    assert err <= 1e-5 and stat_err <= 1e-6 and moved > 1e-3


def test_batchnorm_is_flax_not_torch():
    """Batch statistics with the biased variance, and flax's momentum 0.9
    (torch's 0.1) on the running ones."""
    bn = BatchNorm(3).train()
    x = torch.randn(4, 3, 5, 6, generator=torch.Generator().manual_seed(0)) * 2 + 1
    y = bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean, 0.1 * mean)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var)
    ref = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + 1e-3)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
    bn.eval()
    stats = (bn.mean.clone(), bn.var.clone())
    bn(x)
    assert torch.equal(stats[0], bn.mean) and torch.equal(stats[1], bn.var)


def _zero_by_construction(name):
    """A convolution's bias feeds a BatchNorm on batch statistics, which
    subtracts it again: its exact gradient is 0, and both frameworks
    return rounding noise there."""
    owner, leaf = name.rsplit(".", 1)
    return leaf == "bias" and owner.split(".")[-1].startswith("conv")


def _check_grads(got, want):
    """Each gradient's error relative to its leaf's largest entry; a
    gradient that is 0 by construction within 1e-5 of the net's largest
    entry, on both sides.  Returns the worst relative error."""
    net_max = max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for k, w in want.items():
        if _zero_by_construction(k):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-5 * net_max, k
            continue
        worst = max(worst, np.abs(got[k] - w).max() / np.abs(w).max())
    return worst


def _check_params(got, want, grads, lr):
    """Each parameter after one AdamW step within 1e-6 where its gradient
    is at least 1e-5 and 1e-4 of its leaf's largest entry.  Adam's first
    step moves a parameter by ``lr * g / (|g| + 1e-8)``, which turns the f32
    noise of a smaller gradient (up to ~2e-5 of the leaf's largest) into up
    to ``lr``: there both steps move it by at most ``lr`` (plus the decay).  BatchNorm statistics within 1e-6.  Returns the worst
    difference of the first kind and the share of entries of the second."""
    worst, small, total = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k] - w).abs().numpy()
        if k not in grads:  # BatchNorm statistics
            assert d.max() <= 1e-6, k
            continue
        g = np.abs(grads[k])
        tiny = (g < max(1e-5, 1e-4 * g.max())) | _zero_by_construction(k)
        small, total = small + tiny.sum(), total + tiny.size
        if (~tiny).any():
            worst = max(worst, d[~tiny].max())
        assert d[tiny].max(initial=0.0) <= 2.01 * lr, k
    assert worst <= 1e-6, worst
    return worst, small / total


def _check_optimizer(net, variables, grads_by_name, tx, params, grads, wd):
    """The port's AdamW given JAX's gradients against optax's update of the
    same gradients: every parameter within 1e-6, small gradients included
    (both optimizers see the same bits).  Returns the worst difference."""
    net.load_state_dict(from_jax_variables(variables), strict=True)
    opt = make_optimizer(net, 1e-3, wd)
    for k, p in net.named_parameters():
        p.grad = torch.from_numpy(grads_by_name[k].copy())
    opt.step()
    updates, _ = tx.update(grads, tx.init(params), params)
    want = from_jax_variables({"params": jax.device_get(optax.apply_updates(params, updates))})
    got = {k: p.detach().numpy() for k, p in net.named_parameters()}
    assert set(got) == set(want)
    worst = max(np.abs(got[k] - want[k].numpy()).max() for k in want)
    assert worst <= 1e-6, worst
    return worst


# (kind, heads, channels, gradient bound relative to each leaf's largest
# entry): the FA net's BatchNorm divides its inputs' rounding by the batch
# std, so its gradients carry ~1e-5 of f32 noise (measured <= 1.07e-5)
STEP_CASES = [
    ("pileup", False, 18, 1e-5),
    ("fa", True, 8, 2e-5),
    ("fa", True, 9, 2e-5),
]


def _relu_masks_port(net, x):
    """The units each ReLU passes, in a training-mode forward: the output
    of every ConvBNRelu and ResBlock, and of each ResBlock's first
    BatchNorm (its inner ReLU's input)."""
    masks, hooks = {}, []
    for name, mod in net.named_modules():
        if isinstance(mod, (ConvBNRelu, ResBlock)):
            post, key = True, name
        elif isinstance(mod, BatchNorm) and name.endswith(".bn1"):
            post, key = False, name
        else:
            continue
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, key=key: masks.__setitem__(key, o.detach().permute(0, 2, 3, 1) > 0)))
    try:
        with torch.no_grad():
            net(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return {k: v.numpy() for k, v in masks.items()}


def _relu_masks_jax(jax_net, variables, x):
    with fnn.intercept_methods(no_dropout):
        _, state = jax.jit(lambda v, x: jax_net.apply(
            v, x, train=True, capture_intermediates=True,
            mutable=["batch_stats", "intermediates"]))(variables, x)
    # each module's output, sown as a 1-tuple under ".../__call__"
    return {k[: -len("/__call__")].replace("/", "."): np.asarray(v)[0] > 0
            for k, v in flatten_tree(jax.device_get(state["intermediates"])).items()}


def _fa_batch(jax_net, variables, net, channels, B=8):
    """The first seeded int8 FA batch on which both frameworks' ReLUs pass
    the same units.  ReLU's gradient jumps at 0, and the two frameworks'
    pre-activations differ by rounding (up to ~2e-5 at these depths), so
    one unit within that of 0 passes a gradient term in one framework and
    drops it in the other, which moves every gradient upstream of it by
    up to ~1%: a batch clear of that is drawn."""
    for seed in range(21 + channels, 61 + channels):
        x = np.random.RandomState(seed).randint(-100, 101, (B, 55, 33, channels)).astype(np.int8)
        port = _relu_masks_port(net, x)
        want = _relu_masks_jax(jax_net, variables, x)
        if all(np.array_equal(m, want[k]) for k, m in port.items()):
            return x
    raise AssertionError("no seeded batch on which the ReLU masks agree")


@pytest.mark.parametrize("kind,add_indel,channels,grad_tol", STEP_CASES)
def test_one_adamw_step_matches_jax(kind, add_indel, channels, grad_tol):
    B, has_bn = 8, kind == "fa"
    if kind == "pileup":
        jax_net = JaxPileupNet(add_indel_length=add_indel, **NARROW)
        make = lambda: PileupNet(add_indel_length=add_indel, **NARROW)  # noqa: E731
        x0, wd = np.zeros((2, 33, 18), np.int32), 1e-4
    else:
        jax_net = JaxFullAlignmentNet(add_indel_length=add_indel, input_channels=channels)
        make = lambda: FullAlignmentNet(input_channels=channels)  # noqa: E731
        x0, wd = np.zeros((2, 55, 33, channels), np.int8), 1e-7
    net = make()
    # create_train_state's state, built under jit (its model.init runs the
    # scan op by op otherwise); its optimizer is optax.adamw(lr, wd)
    tx = optax.adamw(1e-3, weight_decay=wd)
    with fnn.intercept_methods(no_dropout):
        state = jax.jit(lambda key: create_train_state(
            jax_net, key, jnp.asarray(x0), learning_rate=1e-3, weight_decay=wd)[0])(
            jax.random.PRNGKey(3))
    variables = jax.device_get({"params": state.params,
                                **({"batch_stats": state.batch_stats} if has_bn else {})})
    net.load_state_dict(from_jax_variables(variables), strict=True)
    dropout_off(net.train())
    if kind == "pileup":
        x = np.random.RandomState(21 + channels).randint(-30, 30, (B, 33, 18)).astype(np.int32)
    else:
        x = _fa_batch(jax_net, variables, net, channels, B)
        net.load_state_dict(from_jax_variables(variables), strict=True)  # stats the search moved
    y = one_hot_labels(np.random.RandomState(7 + channels), B)

    with fnn.intercept_methods(no_dropout):
        def loss_of(params):
            vs = dict(variables, params=params)
            if has_bn:
                preds, _ = jax_net.apply(vs, x, train=True, mutable=["batch_stats"])
            else:
                preds = jax_net.apply(vs, x, train=True)
            return jax_loss.multitask_loss(preds, y, add_indel_length=add_indel)

        grads = jax.jit(jax.grad(loss_of))(state.params)
        step = make_train_step(jax_net, tx, add_indel_length=add_indel, has_batch_stats=has_bn)
        new_state, want_loss = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(4))
    opt = make_optimizer(net, 1e-3, wd)
    loss = batch_loss(net, torch.from_numpy(x), torch.from_numpy(y), None, add_indel)
    loss.backward()
    loss = float(loss.detach())
    got_grads = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
    opt.step()

    want_grads = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.device_get(grads)}).items()}
    opt_err = _check_optimizer(make(), variables, want_grads, tx, state.params, grads, wd)
    loss_err = abs(loss - float(want_loss))
    grad_err = _check_grads(got_grads, want_grads)
    want_after = from_jax_variables(jax.device_get(
        {"params": new_state.params, **({"batch_stats": new_state.batch_stats} if has_bn else {})}))
    got_after = net.state_dict()
    assert set(got_after) == set(want_after)
    param_err, small = _check_params(got_after, want_after, want_grads, 1e-3)
    print(f"[train] step {kind} c={channels}: loss {loss:.6f} |d| {loss_err:.3g}, "
          f"grads max rel {grad_err:.3g}, AdamW on JAX's gradients max |d| {opt_err:.3g}, "
          f"params after the step max |d| {param_err:.3g} "
          f"({100 * small:.4f}% of entries have a small gradient or a zero one by construction)")
    # 1e-6 relative to the loss, as for the focal loss alone
    assert loss_err <= 1e-6 * max(1.0, abs(float(want_loss)))
    assert grad_err <= grad_tol


def test_dropout_inverted_and_reproducible():
    d = Dropout(0.5).train()
    x = torch.ones(20000)
    a = d(x, torch.Generator().manual_seed(1))
    b = d(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(a.mean().item() - 1.0) < 0.03
    assert not torch.equal(a, d(x, torch.Generator().manual_seed(2)))
    assert torch.equal(d.eval()(x, None), x)


@pytest.mark.parametrize("make", [lambda: PileupNet(**NARROW),
                                  lambda: FullAlignmentNet(input_channels=8)],
                         ids=["pileup", "fa"])
def test_training_forward_without_generator_raises(make):
    net = make()
    x = torch.zeros((2, 33, 18) if isinstance(net, PileupNet) else (2, 55, 33, 8),
                    dtype=torch.int32 if isinstance(net, PileupNet) else torch.int8)
    with pytest.raises(ValueError, match="eval"):
        net(x)
    net.eval()(x)
