"""FA conv1 kernel (K3, ``csrc/fa_conv1.cu``) against cuDNN on the card,
the twin of ``scripts/bench_fa_conv1.py``, on ``--device`` (default
``cuda``).

    python -m clair3_tpu_torch.bench_fa_conv1 [--device cuda|cpu]

At bf16, B = 2048, depth 89 x 33 x 8 channels, 30 iterations of
``bench.bench_forward``'s loop (a staged batch perturbed by ``i % 3``, the
full output summed on the device, best of 3 after a warm run), with seeded
random weights (``testing.random_variables``, seed 0):

* the whole FA net on cuDNN (``F.conv2d``) against the same net with
  ``use_kernel_conv1=True`` (K3 for conv1, cuDNN for the rest);
* the same K3 route with conv1's output made channels_last, the layout
  cuDNN's conv1 hands the rest of the net (each route's layout printed);
* the conv1 stage alone: ``F.conv2d`` + BatchNorm + ReLU (the net's own
  ``conv1`` module) against ``ops.fa_conv1.fa_conv1``, in us per sample.

Before anything is timed the kernel route is held against the cuDNN net on
256 rows of the batch, within phase 4's bound of ``chip_smoke.py`` (bf16,
random weights: max |dp| <= 2e-2); the script exits non-zero otherwise.
The FA net's FLOPs are counted from its layer shapes at depth 89 (every
convolution and dense product, 2 per multiply-add: ``fa_net_flops``), and
``fa_net_mfu`` is the cuDNN net's rate over the H100's 989 TFLOP/s dense
bf16 peak, printed beside the card's name and power limit.  The last line
before the table is the kernels' launches (``[kernels]``).

On ``--device cpu`` both routes are their plain twins (no kernel runs) and
no MFU is printed.  ``C3T_BENCH_SMOKE=1`` is a wiring check at B = 16, 2
iterations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

B, D, W, C = 2048, 89, 33, 8
ITERS = 30
ROUTE_TOL = 2e-2  # chip_smoke.py phase 4: bf16 kernel route vs standard net, random weights
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16


def fa_net_flops(net, depth: int, width: int = 33) -> int:
    """Floating-point operations of one sample through ``net`` (a
    ``FullAlignmentNet``) at ``depth`` x ``width``: 2 per multiply-add of
    every convolution and dense product, from the shapes a forward gives
    each layer (BatchNorm, pooling and activations not counted)."""
    from clair3_tpu_torch.models import FullAlignmentNet
    from clair3_tpu_torch.models.full_alignment import Conv
    from clair3_tpu_torch.models.layers import Dense

    probe = FullAlignmentNet(add_indel_length=net.n_heads == 4,
                             input_channels=net.input_channels).eval()
    total = []

    def count(module, inputs, out):
        if isinstance(module, Conv):
            total.append(2 * out.numel() * module.weight[0].numel())
        else:
            total.append(2 * out.numel() * module.kernel.shape[0])

    hooks = [m.register_forward_hook(count) for m in probe.modules()
             if isinstance(m, (Conv, Dense))]
    try:
        with torch.inference_mode():
            probe(torch.zeros((1, depth, width, net.input_channels), dtype=torch.int8))
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def main(argv=None) -> int:
    from clair3_tpu_torch.bench import bench_forward, kernel_counts
    from clair3_tpu_torch.device import resolve_device
    from clair3_tpu_torch.models import FullAlignmentNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.ops import fa_conv1 as k3
    from clair3_tpu_torch.testing import random_variables
    from clair3_tpu_torch.wgs_scale_demo import device_label

    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.bench_fa_conv1",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the nets; cuda raises when no GPU is present")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    label = device_label(device)
    batch, iters = (16, 2) if os.environ.get("C3T_BENCH_SMOKE") == "1" else (B, ITERS)
    dt = torch.bfloat16
    print(f"[fa_conv1] device: {label}; bf16, B={batch}, {D}x{W}x{C}, {iters} iterations")
    if device.type != "cuda":
        print("[fa_conv1] on the CPU both routes are their plain twins: no kernel runs")

    net_off = FullAlignmentNet(add_indel_length=True, input_channels=C, compute_dtype=dt)
    net_off.load_state_dict(from_jax_variables(random_variables(net_off, seed=0)))
    net_off = net_off.to(device).eval()
    net_on = FullAlignmentNet(add_indel_length=True, input_channels=C, compute_dtype=dt,
                              use_kernel_conv1=True)
    net_on.load_state_dict(net_off.state_dict())
    net_on = net_on.to(device).eval()
    net_f32 = FullAlignmentNet(add_indel_length=True, input_channels=C)
    net_f32.load_state_dict(net_off.state_dict())
    net_f32 = net_f32.to(device).eval()

    def stage():
        return torch.from_numpy(np.random.RandomState(1).randint(
            -100, 100, (batch, D, W, C)).astype(np.int8)).to(device)

    conv, bn = net_off.conv1.conv, net_off.conv1.bn

    def conv1_cudnn(x):
        return net_off.conv1((x.to(dt) / 100.0).permute(0, 3, 1, 2))

    def conv1_kernel(x):
        return k3.fa_conv1(x, conv.weight.permute(2, 3, 1, 0), conv.bias, bn.scale, bn.bias,
                           bn.mean, bn.var, eps=1e-3, norm=100.0, compute_dtype=dt)

    # the kernel route against the cuDNN net before anything is timed
    xs = stage()[:256]
    with torch.inference_mode():
        off, on, f32 = net_off(xs), net_on(xs), net_f32(xs)
        stage_err = (conv1_kernel(xs).permute(0, 3, 1, 2).float()
                     - conv1_cudnn(xs).float()).abs().max().item()
    err = (on - off).abs().max().item()
    print(f"[fa_conv1] route check: kernel route vs cuDNN net max |dp| {err:.3g} (bound "
          f"{ROUTE_TOL:g}); vs the f32 net {(on - f32).abs().max().item():.3g}, cuDNN bf16 "
          f"vs f32 {(off - f32).abs().max().item():.3g}; conv1 stage kernel vs cuDNN max "
          f"|d| {stage_err:.3g}")
    if not err <= ROUTE_TOL:
        print(f"[fa_conv1] FAILED: the kernel route is {err:.3g} from the cuDNN net",
              file=sys.stderr)
        return 1

    t_off = bench_forward(net_off, stage, batch, iters)
    print(f"[fa_conv1] full net, cuDNN conv path:     {t_off:,.0f} cand/s "
          f"({1e6 / t_off:.3f} us/sample) ({label})")
    t_on = bench_forward(net_on, stage, batch, iters)
    print(f"[fa_conv1] full net, conv1 kernel (K3):   {t_on:,.0f} cand/s "
          f"({1e6 / t_on:.3f} us/sample, {t_on / t_off:.2f}x vs cuDNN) ({label})")
    # the layout the rest of the net runs in: cuDNN's conv1 keeps the
    # channels_last memory of its input's NHWC view, K3 hands back NCHW;
    # the K3 route again with conv1's output made channels_last
    with torch.inference_mode():
        layouts = {name: fn(xs).permute(0, 3, 1, 2) if name == "K3" else fn(xs)
                   for name, fn in (("cuDNN", conv1_cudnn), ("K3", conv1_kernel))}
    print("[fa_conv1] conv1 output channels_last: " + ", ".join(
        f"{name} {t.is_contiguous(memory_format=torch.channels_last)}"
        for name, t in layouts.items()))
    hook = net_on.res_block1.register_forward_pre_hook(
        lambda module, args: (args[0].contiguous(memory_format=torch.channels_last),))
    try:
        t_cl = bench_forward(net_on, stage, batch, iters)
    finally:
        hook.remove()
    print(f"[fa_conv1] full net, K3 + channels_last:  {t_cl:,.0f} cand/s "
          f"({1e6 / t_cl:.3f} us/sample, {t_cl / t_off:.2f}x vs cuDNN) ({label})")
    for name, fn in (("conv1 stage alone, F.conv2d + BN + ReLU", conv1_cudnn),
                     ("conv1 stage alone, K3 kernel", conv1_kernel)):
        rate = bench_forward(fn, stage, batch, iters)
        print(f"[fa_conv1] {name}: {1e6 / rate:.4f} us/sample ({label})")

    flops = fa_net_flops(net_off, D, W)
    print(f"[fa_conv1] FA net FLOPs at depth {D}: {flops} per sample ({flops / 1e9:.4f} "
          f"GFLOP, counted from its layer shapes)")
    if device.type == "cuda":
        mfu = flops * t_off / PEAK_BF16_FLOPS
        print(f"[fa_conv1] fa_net_mfu {mfu:.4f} ({100 * mfu:.2f}% of 989 TFLOP/s dense bf16; "
              f"cuDNN net at {flops * t_off / 1e12:.2f} TFLOP/s) ({label})")
    print(f"[kernels] {json.dumps(kernel_counts())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
