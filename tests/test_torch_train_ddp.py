"""Data-parallel training in the port (``train --data_parallel``:
``parallel/mesh.py``, ``train/step.py::replicate``, the trainer under a
process group), f32 on the CPU.  Every rank is an OS process of its own,
started with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), on gloo.

* 4 ranks against ``clair3_tpu`` on a 4-device mesh, dropout off on both
  sides: the pileup net through each package's trainer for 4 steps on
  batches of 50 rows, padded to 52, within the bounds of
  ``test_train_model_matches_jax`` but two: a leaf may have one unit's
  fan-in past 1e-4, and the trained nets' p part by up to 5e-5 (the mesh
  run's own rounding noise, see the test); the FA net through one step of each
  (``make_train_step(..., mesh=...)``), on a batch where both frameworks'
  ReLUs pass the same units, within ``test_one_adamw_step_matches_jax``'s
  bounds.
* 2 and 4 ranks against one device, dropout on, through ``fit``: the
  training losses within rtol 1e-5; the pileup net over three steps, its
  parameters within atol 1e-5 but where AdamW turns a near-zero gradient's
  rounding into up to ``lr``; the FA net over one step, as
  ``test_one_adamw_step_matches_jax`` holds a step, with its validation
  loss within rtol 1e-3 (see the test); every rank's parameters and
  BatchNorm statistics equal to rank 0's.
* The FA net's ``BatchNorm`` across 2 and 4 ranks against the layer on
  the whole batch: output, input gradients, parameter gradients and
  running statistics within 1e-6 of each one's largest entry (at least 1:
  the parameter gradients are sums over the batch, where one f32 ulp can
  exceed 1e-6).
* ``train --data_parallel --device cpu`` over an HDF5 bin in 2 ranks:
  rank 0 alone writes the checkpoints, and its ``best_val_loss.npz``
  agrees with one rank's within the bounds above; a rank that fails makes
  every rank exit non-zero; a group of another size raises; ``--device
  cuda`` without a GPU raises.
* ``shard_rows`` of a batch padded by ``pad_to_multiple`` gives each rank
  the rows the JAX mesh puts on its device.

Child processes write to files, not pipes, and every wait has a timeout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from test_torch_train import (_check_grads, _check_params, _fa_batch, dropout_off, no_dropout,
                              one_hot_labels)
from test_torch_train_trainer import _cfg, check_trained_like_jax, init_variables, tiny_bin  # noqa: F401

from clair3_tpu.models import FullAlignmentNet as JaxFullAlignmentNet
from clair3_tpu.parallel.mesh import get_mesh, shard_batch
from clair3_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from clair3_tpu.train.step import create_train_state, make_train_step, shard_train_state
from clair3_tpu.train.trainer import train_model as jax_train_model
from clair3_tpu_torch.cli import main as port_main
from clair3_tpu_torch.config import TrainConfig
from clair3_tpu_torch.models import FullAlignmentNet
from clair3_tpu_torch.models.bridge import from_jax_variables
from clair3_tpu_torch.models.full_alignment import BatchNorm, ConvBNRelu, ResBlock
from clair3_tpu_torch.models.params_io import load_variables, save_variables
from clair3_tpu_torch.parallel.mesh import init_data_parallel, pad_to_multiple, shard_rows
from clair3_tpu_torch.testing import ArrayDataset, random_counts
from clair3_tpu_torch.train.data import write_bin
from clair3_tpu_torch.train.trainer import fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

# one rank: runs ``job`` with the JSON arguments through run_ranks, which
# joins the group torchrun's variables describe, and writes ``{out}.{rank}.npz``
WORKER = textwrap.dedent("""
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from clair3_tpu_torch.models.layers import Dropout
    from clair3_tpu_torch.parallel.mesh import run_ranks, shard_rows

    job, out, args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    if not args.get("dropout", True):
        Dropout.forward = lambda self, x, generator: x


    def save(**arrays):
        np.savez(f"{out}.{dist.get_rank()}.npz", **arrays)


    def batchnorm(device):
        from clair3_tpu_torch.models.full_alignment import BatchNorm, ConvBNRelu, ResBlock

        z = np.load(args["inputs"])
        x, w = (torch.from_numpy(shard_rows(z[k], dist.get_rank(), dist.get_world_size()))
                for k in ("x", "w"))
        layer = BatchNorm(x.shape[1]).train()
        layer.scale.data.copy_(torch.from_numpy(z["scale"]))
        layer.bias.data.copy_(torch.from_numpy(z["bias"]))
        layer.group = dist.group.WORLD
        x.requires_grad_()
        y = layer(x)
        (y * w).sum().backward()
        grads = torch.stack([layer.scale.grad, layer.bias.grad])
        dist.all_reduce(grads)  # each rank holds its rows' share of the sum
        save(y=y.detach().numpy(), x_grad=x.grad.numpy(), param_grads=grads.numpy(),
             mean=layer.mean.numpy(), var=layer.var.numpy())


    def relu_masks(net, masks):
        # the units each ReLU passes in net's first forward, into masks
        from clair3_tpu_torch.models.full_alignment import BatchNorm, ConvBNRelu, ResBlock

        def hook(mod, inputs, out, name):
            masks.setdefault(f"mask/{name}", (out.detach() > 0).numpy())

        for name, mod in net.named_modules():
            if isinstance(mod, (ConvBNRelu, ResBlock)) or name.endswith(".bn1"):
                mod.register_forward_hook(lambda m, i, o, name=name: hook(m, i, o, name))
        return net


    def train(device):
        from clair3_tpu_torch.config import TrainConfig
        from clair3_tpu_torch.models.params_io import load_variables
        from clair3_tpu_torch.testing import ArrayDataset
        from clair3_tpu_torch.train import trainer

        nets, masks, replicate = [], {}, trainer.replicate

        def recording(net, dev):
            nets.append(relu_masks(net, masks))
            return replicate(net, dev)

        trainer.replicate = recording
        cfg = TrainConfig(**args["cfg"])
        init = load_variables(args["init"]) if args.get("init") else None
        if "bins" in args:
            r = trainer.train_model(args["bins"], args["out_dir"], cfg, max_steps=args["steps"],
                                    init_variables=init, device=device, data_parallel=True)
        else:
            z = np.load(args["data"])
            data = ArrayDataset([z["x"]], [z["y"]], chunk_size=cfg.chunk_size)
            r = trainer.fit(data, args["out_dir"], cfg, max_steps=args["steps"],
                            init_variables=init, device=device, data_parallel=True)
        state = {k: v.numpy() for k, v in nets[0].state_dict().items()}
        state.update({f"grad/{k}": p.grad.numpy() for k, p in nets[0].named_parameters()},
                     **masks)
        save(history=np.array(r["history"], dtype=np.float64),
             meta=np.array(json.dumps({k: r[k] for k in ("best_val_loss", "epochs",
                                                         "model_path")})), **state)


    def step(device):
        from clair3_tpu_torch.models import FullAlignmentNet
        from clair3_tpu_torch.models.bridge import from_jax_variables
        from clair3_tpu_torch.models.params_io import load_variables
        from clair3_tpu_torch.train.step import make_optimizer, replicate, train_step

        z = np.load(args["data"])
        x, y = (torch.from_numpy(shard_rows(z[k], dist.get_rank(), dist.get_world_size()))
                for k in ("x", "y"))
        net = FullAlignmentNet(input_channels=x.shape[-1])
        net.load_state_dict(from_jax_variables(load_variables(args["init"])), strict=True)
        model = replicate(net, device)
        opt = make_optimizer(net, 1e-3, 1e-7)
        loss = train_step(model, opt, x, y, None, True)
        save(loss=np.array(loss), **{f"grad/{k}": p.grad.numpy() for k, p in
                                     net.named_parameters()},
             **{k: v.numpy() for k, v in net.state_dict().items()})


    run_ranks({"batchnorm": batchnorm, "train": train, "step": step}[job], torch.device("cpu"))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, world, argvs, tag):
    """``world`` ranks, rank ``r`` running ``python argvs[r]`` with
    torchrun's variables; returns (processes, log paths) once all exited,
    every one killed at the time limit."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        logs.append(str(tmp_path / f"{tag}.{rank}.log"))
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, *argvs[rank]], stdout=log,
                                          stderr=subprocess.STDOUT, cwd=str(tmp_path), env=env))
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, logs


def _run_job(tmp_path, world, job, **args):
    """``WORKER``'s ``job`` on ``world`` ranks; each rank's saved arrays."""
    out = str(tmp_path / job)
    procs, logs = _launch(tmp_path, world, [["-c", WORKER, job, out, json.dumps(args)]] * world,
                          job)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, open(log).read()[-4000:]
    ranks = []
    for r in range(world):
        with np.load(f"{out}.{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


def test_shard_rows_are_the_mesh_shards():
    mesh = get_mesh(n_devices=4)
    for n in (8, 50, 3):
        x = np.arange(n * 6, dtype=np.int32).reshape(n, 2, 3)
        padded, n0 = pad_to_multiple(x, 4)
        want, _ = jax_pad_to_multiple(x, 4)
        assert n0 == n and np.array_equal(padded, want)
        shards = sorted(shard_batch(mesh, want).addressable_shards, key=lambda s: s.index[0].start)
        for rank, shard in enumerate(shards):
            assert np.array_equal(shard_rows(padded, rank, 4), np.asarray(shard.data))
    with pytest.raises(ValueError, match="pad"):
        shard_rows(np.zeros((6, 2)), 0, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_batchnorm_across_ranks_is_the_whole_batch(tmp_path, world):
    rng = np.random.RandomState(11)
    z = {"x": (rng.randn(8, 3, 5, 6) * 2 + 1).astype(np.float32),
         "w": rng.randn(8, 3, 5, 6).astype(np.float32),
         "scale": (1 + 0.1 * rng.randn(3)).astype(np.float32),
         "bias": (0.1 * rng.randn(3)).astype(np.float32)}
    np.savez(tmp_path / "bn.npz", **z)
    ranks = _run_job(tmp_path, world, "batchnorm", inputs=str(tmp_path / "bn.npz"))

    layer = BatchNorm(3).train()
    layer.scale.data.copy_(torch.from_numpy(z["scale"]))
    layer.bias.data.copy_(torch.from_numpy(z["bias"]))
    x = torch.from_numpy(z["x"]).requires_grad_()
    y = layer(x)
    (y * torch.from_numpy(z["w"])).sum().backward()
    want = {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "param_grads": np.stack([layer.scale.grad.numpy(), layer.bias.grad.numpy()]),
            "mean": layer.mean.numpy(), "var": layer.var.numpy()}
    got = {k: np.concatenate([r[k] for r in ranks]) for k in ("y", "x_grad")}
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in got}
    for k in ("param_grads", "mean", "var"):
        errs[k] = max(float(np.abs(r[k] - want[k]).max()) for r in ranks)
    print(f"[ddp] BatchNorm over {world} ranks vs the whole batch, max |d|: {errs}; largest "
          f"|value|: { {k: float(np.abs(w).max()) for k, w in want.items()} }")
    for k, err in errs.items():
        # the parameter gradients are sums of 240 terms, ~20: one f32 ulp there is 1.9e-6
        assert err <= 1e-6 * max(1.0, float(np.abs(want[k]).max())), k
    # the moved running statistics are equal on every rank, bit for bit
    for r in ranks[1:]:
        assert np.array_equal(r["mean"], ranks[0]["mean"]) and np.array_equal(r["var"],
                                                                             ranks[0]["var"])


def test_pileup_trainer_4_ranks_matches_jax_mesh(tmp_path, tiny_bin, init_variables):
    """The JAX trainer on a 4-device mesh against 4 port ranks: batches of
    50 rows are padded to 52 (13 a rank) on both sides."""
    with fnn.intercept_methods(no_dropout):
        want = jax_train_model([tiny_bin], str(tmp_path / "jax"), _cfg(), mesh=get_mesh(n_devices=4),
                               max_steps=4, init_variables=init_variables)
    save_variables(str(tmp_path / "init.npz"), jax.device_get(init_variables))
    ranks = _run_job(tmp_path, 4, "train", dropout=False, bins=[tiny_bin],
                     out_dir=str(tmp_path / "port"), steps=4, init=str(tmp_path / "init.npz"),
                     cfg=dict(pileup=True, add_indel_length=False, batch_size=50,
                              chunk_size_pileup=25, max_epoch=3, seed=0))
    got = dict(json.loads(str(ranks[0]["meta"])),
               history=[tuple(h) for h in ranks[0]["history"].tolist()])
    for r in ranks[1:]:
        assert np.array_equal(r["history"], ranks[0]["history"])
    # JAX's mesh run moves the 128 fan-in weights of one L5_2 unit, whose
    # gradient is rounding noise, by up to 2.6e-4 through Adam; the port's
    # 4 ranks keep them within 7e-7 of JAX's one-device run (measured), and
    # the trained nets' p then part by 1.8e-5
    check_trained_like_jax(got, want, unit_past=True, p_tol=5e-5)


def test_fa_step_4_ranks_matches_jax_mesh(tmp_path):
    channels, B, wd = 8, 8, 1e-7
    jax_net = JaxFullAlignmentNet(add_indel_length=True, input_channels=channels)
    tx = optax.adamw(1e-3, weight_decay=wd)
    x0 = np.zeros((2, 55, 33, channels), np.int8)
    with fnn.intercept_methods(no_dropout):
        state = jax.jit(lambda key: create_train_state(
            jax_net, key, jnp.asarray(x0), learning_rate=1e-3, weight_decay=wd)[0])(
            jax.random.PRNGKey(3))
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    net = FullAlignmentNet(input_channels=channels)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    x = _fa_batch(jax_net, variables, dropout_off(net.train()), channels, B)
    y = one_hot_labels(np.random.RandomState(7 + channels), B)

    mesh = get_mesh(n_devices=4)
    with fnn.intercept_methods(no_dropout):
        def loss_of(params):
            from clair3_tpu.train import loss as jax_loss

            preds, _ = jax_net.apply(dict(variables, params=params), x, train=True,
                                     mutable=["batch_stats"])
            return jax_loss.multitask_loss(preds, y, add_indel_length=True)

        grads = jax.jit(jax.grad(loss_of))(state.params)
        step = make_train_step(jax_net, tx, add_indel_length=True, has_batch_stats=True, mesh=mesh)
        new_state, want_loss = step(shard_train_state(state, mesh), shard_batch(mesh, x),
                                    shard_batch(mesh, y), jax.random.PRNGKey(4))

    save_variables(str(tmp_path / "init.npz"), variables)
    np.savez(tmp_path / "batch.npz", x=x, y=y)
    ranks = _run_job(tmp_path, 4, "step", dropout=False, init=str(tmp_path / "init.npz"),
                     data=str(tmp_path / "batch.npz"))
    got = ranks[0]
    want_grads = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.device_get(grads)}).items()}
    got_grads = {k: got[f"grad/{k}"] for k in want_grads}
    want_after = from_jax_variables(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got_after = {k: torch.from_numpy(got[k]) for k in want_after}
    loss_err = abs(float(got["loss"]) - float(want_loss))
    grad_err = _check_grads(got_grads, want_grads)
    param_err, small = _check_params(got_after, want_after, want_grads, 1e-3)
    print(f"[ddp] FA step, 4 ranks vs the JAX 4-device mesh: loss {float(got['loss']):.6f} "
          f"|d| {loss_err:.3g}, grads max rel {grad_err:.3g}, params after the step max |d| "
          f"{param_err:.3g} ({100 * small:.4f}% of entries have a small gradient)")
    assert loss_err <= 1e-6 * max(1.0, abs(float(want_loss)))
    assert grad_err <= 2e-5
    for r in ranks[1:]:
        assert all(np.array_equal(r[k], got[k]) for k in got)


def _relu_masks(net, masks):
    """``WORKER``'s ``relu_masks``: the units each ReLU passes in ``net``'s
    first forward, into ``masks``."""
    def hook(mod, inputs, out, name):
        masks.setdefault(f"mask/{name}", (out.detach() > 0).numpy())

    for name, mod in net.named_modules():
        if isinstance(mod, (ConvBNRelu, ResBlock)) or name.endswith(".bn1"):
            mod.register_forward_hook(lambda m, i, o, name=name: hook(m, i, o, name))
    return net


def _dataset(kind, n_chunks, chunk, seed):
    """Seeded rows for ``n_chunks`` whole chunks at every offset the
    trainer draws (half a chunk of slack), so every batch is a multiple of
    ``chunk`` rows: the ranks then split it with no padding, as one device
    takes it."""
    n = n_chunks * chunk + chunk // 2
    if kind == "pileup":
        x = random_counts(seed, (n, 33, 18))
    else:
        x = np.random.RandomState(seed).randint(-100, 101, (n, 55, 33, 8)).astype(np.int8)
    return x, one_hot_labels(np.random.RandomState(seed + 1), n)


# (TrainConfig, steps, data seed): the FA net for one step, on a batch on
# which the step is clear of f32's discontinuities at 1, 2 and 4 ranks (see
# the test)
DROPOUT_CASES = {
    "pileup": (dict(pileup=True, add_indel_length=False, batch_size=32, chunk_size_pileup=16,
                    max_epoch=2, seed=3), 3, 5),
    "fa": (dict(pileup=False, add_indel_length=True, batch_size=16, chunk_size_fa=8,
                max_epoch=2, seed=3), 1, 7),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["pileup", "fa"])
def test_ranks_match_one_device_with_dropout(tmp_path, kind, world):
    """``fit`` on ``world`` ranks against ``fit`` on one device, dropout on
    and batches that split with no padding.  The losses within rtol 1e-5.
    AdamW moves an entry by up to ``lr`` a step whatever the size of its
    gradient (``lr * g / (|g| + 1e-8)``), so where a gradient is f32
    rounding noise (a conv bias before BatchNorm, exactly 0; entries
    within the noise of their leaf) the ranks' other summation order moves
    the entry by up to 2 lr a step.  The pileup net: three steps, its
    parameters within 1e-5 on all but a 1e-5 share of the net's entries,
    those within 2 lr a step.  The FA net amplifies such entries: a step
    later some of its leaves' gradients differ by ~16% (measured at 2
    ranks), so it is held over one step, as ``test_one_adamw_step_matches_jax``
    holds it: gradients within 2e-5 of each leaf's largest entry,
    parameters within 1e-6 where the gradient is clear of the noise, and
    the BatchNorm statistics within 1e-6.  Its batch is one on which every
    ReLU passes the same units at 1, 2 and 4 ranks (asserted): a unit on the
    other side moves the gradients upstream of it by ~1% (measured 1.2% at
    4 ranks), as between the two frameworks (``_fa_batch``).  Of the data
    seeds 5-12, 5, 6, 8, 9 and 12 have such a unit, 11 some other
    discontinuity (parameters 2e-3 apart with equal masks); 7 and 10 have
    none.  Its validation loss, after the step,
    within rtol 1e-3: in eval mode BatchNorm subtracts the running mean,
    so the conv biases moved on noise shift it (measured 6.6e-5 at 2 ranks
    and 1.5e-4 at 4)."""
    cfg, steps, seed = DROPOUT_CASES[kind]
    chunk = cfg["chunk_size_pileup" if kind == "pileup" else "chunk_size_fa"]
    x, y = _dataset(kind, 5, chunk, seed)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    ranks = _run_job(tmp_path, world, "train", data=str(tmp_path / "data.npz"),
                     out_dir=str(tmp_path / "ranks"), steps=steps, cfg=cfg)
    nets, masks = [], {}
    with pytest.MonkeyPatch.context() as mp:
        from clair3_tpu_torch.train import trainer

        build = trainer.build_model
        mp.setattr(trainer, "build_model",
                   lambda *a: nets.append(_relu_masks(build(*a), masks)) or nets[-1])
        want = fit(ArrayDataset([x], [y], chunk_size=chunk), str(tmp_path / "one"),
                   TrainConfig(**cfg), max_steps=steps, device=torch.device("cpu"))
    want_state = {k: v.numpy() for k, v in nets[0].state_dict().items()}
    want_grads = {k: p.grad.numpy() for k, p in nets[0].named_parameters()}
    want_hist = np.array(want["history"], dtype=np.float64)
    got = ranks[0]
    diffs = {k: np.abs(got[k] - w) for k, w in want_state.items()}
    over = sum(int((d > 1e-5).sum()) for d in diffs.values())
    print(f"[ddp] {kind}, {world} ranks vs one device, dropout on, {steps} steps: history "
          f"{got['history'].tolist()} vs {want_hist.tolist()}; parameters and statistics max "
          f"|d| {max(d.max() for d in diffs.values()):.3g}, {over} of "
          f"{sum(d.size for d in diffs.values())} entries over 1e-5")
    assert np.array_equal(got["history"][:, :2], want_hist[:, :2])
    np.testing.assert_allclose(got["history"][:, 2], want_hist[:, 2], rtol=1e-5)
    # the FA net's validation runs after the step, with BatchNorm on its
    # running mean, where the conv biases moved on noise no longer cancel
    np.testing.assert_allclose(got["history"][:, 3], want_hist[:, 3],
                               rtol=1e-5 if kind == "pileup" else 1e-3)
    if kind == "pileup":
        assert over <= 1e-5 * sum(d.size for d in diffs.values())
        assert max(d.max() for d in diffs.values()) <= 2.01e-3 * steps
    else:
        flips = {k: int((np.concatenate([r[k] for r in ranks]) != m).sum())
                 for k, m in masks.items()}
        assert masks and not any(flips.values()), f"ReLUs pass other units: {flips}"
        grad_err = _check_grads({k: got[f"grad/{k}"] for k in want_grads}, want_grads)
        param_err, small = _check_params({k: torch.from_numpy(got[k]) for k in want_state},
                                         {k: torch.from_numpy(w) for k, w in want_state.items()},
                                         want_grads, 1e-3)
        print(f"[ddp] fa step: gradients max rel {grad_err:.3g}, parameters where the gradient "
              f"is clear max |d| {param_err:.3g} ({100 * small:.3f}% not clear)")
        assert grad_err <= 2e-5
    for r in ranks[1:]:
        assert all(np.array_equal(r[k], got[k]) for k in want_state)


def _bin(path, n=96, seed=2):
    write_bin(str(path), random_counts(seed, (n, 33, 18)), one_hot_labels(
        np.random.RandomState(seed), n), [f"chr1:{i + 1}:A" for i in range(n)],
        ["" for _ in range(n)])
    return str(path)


TRAIN_ARGS = ["--platform", "hifi", "--pileup", "--max_epoch", "1", "--batch_size", "48",
              "--device", "cpu", "--data_parallel"]


def test_cli_train_data_parallel_two_ranks(tmp_path):
    """Only rank 0 writes, and it writes one device's net."""
    bin_fn = _bin(tmp_path / "p.bin")
    outs = [tmp_path / f"rank{r}" for r in range(2)]
    procs, logs = _launch(tmp_path, 2, [["-m", "clair3_tpu_torch", "train", "--bin_fn", bin_fn,
                                         "--output_dir", str(out), *TRAIN_ARGS] for out in outs],
                          "cli")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, open(log).read()[-4000:]
    assert "best_val_loss=" in open(logs[0]).read() and "best_val_loss=" not in open(logs[1]).read()
    assert sorted(os.listdir(outs[0])) == ["best_val_loss.npz", "epoch_0_0.npz"]
    assert os.listdir(outs[1]) == []
    # one rank: this process, the group of one that run_ranks forms itself
    assert port_main(["train", "--bin_fn", bin_fn, "--output_dir", str(tmp_path / "one"),
                      *TRAIN_ARGS]) == 0
    assert not dist.is_initialized()
    got = load_variables(str(outs[0] / "best_val_loss.npz"))
    want = load_variables(str(tmp_path / "one" / "best_val_loss.npz"))
    got, want = from_jax_variables(got), from_jax_variables(want)
    err = max(float((got[k] - w).abs().max()) for k, w in want.items())
    print(f"[ddp] train --data_parallel, 2 ranks vs 1: best_val_loss.npz max |d| {err:.3g}")
    assert err <= 1e-5


def test_failed_rank_fails_every_rank(tmp_path):
    """Rank 1 finds no bin; rank 0, waiting in a collective, exits non-zero
    too, well before the group's timeout."""
    bin_fn = _bin(tmp_path / "p.bin", n=40)
    argvs = [["-m", "clair3_tpu_torch", "train", "--bin_fn", b, "--output_dir",
              str(tmp_path / "out"), *TRAIN_ARGS] for b in (bin_fn, str(tmp_path / "missing.bin"))]
    procs, logs = _launch(tmp_path, 2, argvs, "fail")
    assert [p.returncode != 0 for p in procs] == [True, True], [open(l).read()[-2000:] for l in logs]


def test_group_of_another_size_raises():
    addr = f"tcp://127.0.0.1:{_free_port()}"
    dist.init_process_group("gloo", init_method=addr, world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="rank 0 of world_size=2 .* world_size=1"):
            init_data_parallel(torch.device("cpu"), 0, 2, addr)
        assert init_data_parallel(torch.device("cpu"), 0, 1, addr) == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_data_parallel_on_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["train", "--bin_fn", str(tmp_path / "missing.bin"), "--output_dir",
                   str(tmp_path / "out"), "--data_parallel"])
