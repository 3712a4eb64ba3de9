"""The port's shipped pileup routes re-measured under one loop, the twin of
``scripts/bench_history.py``, on ``--device`` (default ``cuda``).

    python -m clair3_tpu_torch.bench_history [--device cuda|cpu]

Every route runs the committed hifi pileup net (``pileup_hifi.npz``) under
``bench.bench_forward`` (a staged batch perturbed by ``i % 3``, the full
output summed on the device, best of 3 after a warm run), B = 8192 and 30
iterations; the FA net (``fa_hifi.npz``) at depth 89, B = 2048:

  pileup eager           the plain ``PileupNet`` at bf16 (the counterpart of
                         the JAX "lax.scan + XLA heads" route)
  pileup trunk + eager   K1 without heads (``pileup_trunk_packed``,
                         ``n_heads = 0``) and the heads as eager ops (the
                         counterpart of ``TrunkPallasXlaHeads``)
  pileup K1 f32 SIMT     the whole net on ``csrc/pileup_full.cu`` at f32
  pileup K1 bf16 TC      the whole net on ``csrc/pileup_tc.cu``'s tensor-core
                         launches L1/L2/L3 (the shipped route)
  FA cuDNN               ``FullAlignmentNet`` at bf16 on ``F.conv2d``

The JAX script's r04 "logistic-form gates" route never shipped in the
port, so it has no counterpart here.  Before anything is timed, every
pileup route's probabilities are held within 0.02 of the shipped route's on
256 rows (the JAX script's assertion); the script exits non-zero
otherwise.  The rows are real pileup tensors, the first 256 candidates of
``bench.make_workload`` at 0.05 Mb: on the JAX script's random counts bf16
itself moves this trained net's probabilities by more than 0.02 against
f32 (0.0223 for K1's bf16 plain twin over those 256 rows, on the CPU), so
there the bound could not tell a wrong route from rounding.  The random
counts' differences are printed beside, reported only.  It ends with the
JAX script's markdown table.

On ``--device cpu`` only the eager routes run (the pileup net and the FA
net; the pileup check is then against the shipped route's plain twin), and
the script says that the kernel routes were not run; on the card every
route runs.  ``C3T_HISTORY_SMOKE=1`` is the JAX script's wiring mode: B =
64 (FA 16), 2 iterations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROUTE_TOL = 0.02


class TrunkKernelEagerHeads(torch.nn.Module):
    """K1 without heads (its ``n_heads = 0`` mode) and the head branches as
    eager ops, head for head the ``PileupNet`` math at the compute dtype."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from clair3_tpu_torch.ops.pileup_full import pileup_trunk_packed

        dt = self.net.compute_dtype
        trunk = pileup_trunk_packed(x, self.net.packed_operands(dt, x.device))
        outs = []
        for l5, out in self.net.heads():
            logits = out(F.selu(l5(trunk, dt)), dt)
            outs.append(torch.softmax(F.selu(logits.float()), dim=-1))
        return torch.cat(outs, dim=-1)


def real_pileup_rows(n: int) -> torch.Tensor:
    """The first ``n`` pileup candidates of ``bench.make_workload`` at 0.05
    Mb (the hifi fixtures' training distribution), ``[n, 33, 18]`` int32."""
    import tempfile

    from clair3_tpu_torch.bench import make_workload
    from clair3_tpu_torch.native import pileup_region_native
    from clair3_tpu_torch.pileup.extractor import candidate_tensors

    with tempfile.TemporaryDirectory(prefix="c3t_history_") as d:
        bam, ref, _, _ = make_workload(d, genome_mb=0.05)
        res = pileup_region_native(bam, ref, 0, "chr1", 0, len(ref), threads=0)
        tensors, _, _ = candidate_tensors(res, "chr1")
    return torch.from_numpy(np.ascontiguousarray(tensors[:n], dtype=np.int32))


def _pileup(variables, dt, use_kernel, device):
    from clair3_tpu_torch.models import PileupNet
    from clair3_tpu_torch.models.bridge import from_jax_variables

    net = PileupNet(add_indel_length=False, compute_dtype=dt, use_kernel=use_kernel)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net.to(device).eval()


def main(argv=None) -> int:
    from clair3_tpu_torch.bench import bench_forward, kernel_counts
    from clair3_tpu_torch.device import resolve_device
    from clair3_tpu_torch.models import FullAlignmentNet
    from clair3_tpu_torch.models.bridge import from_jax_variables
    from clair3_tpu_torch.testing import load_trained_fixture
    from clair3_tpu_torch.wgs_scale_demo import device_label

    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.bench_history",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the routes; cuda raises when no GPU is present")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    label = device_label(device)
    on_card = device.type == "cuda"
    bf16 = torch.bfloat16
    vp = load_trained_fixture("pileup_hifi.npz")
    vf = load_trained_fixture("fa_hifi.npz")

    smoke = os.environ.get("C3T_HISTORY_SMOKE") == "1"  # CPU wiring check
    B_P, ITERS_P = (64, 2) if smoke else (8192, 30)
    B_F, ITERS_F = (16, 2) if smoke else (2048, 30)
    print(f"[history] device: {label}; pileup B={B_P}, FA B={B_F}, {ITERS_P} iterations",
          file=sys.stderr)

    def stage_pileup():
        return torch.from_numpy(np.random.RandomState(0).randint(
            -30, 30, (B_P, 33, 18)).astype(np.int32)).to(device)

    def stage_fa():
        return torch.from_numpy(np.random.RandomState(1).randint(
            -100, 100, (B_F, 89, 33, 8)).astype(np.int8)).to(device)

    shipped = _pileup(vp, bf16, True, device)
    routes = [("pileup eager PyTorch, bf16 (lax.scan + XLA heads)",
               _pileup(vp, bf16, False, device))]
    if on_card:
        routes += [("pileup K1 trunk kernel + eager heads, bf16 (TrunkPallasXlaHeads)",
                    TrunkKernelEagerHeads(shipped)),
                   ("pileup K1 f32, SIMT kernel (csrc/pileup_full.cu)",
                    _pileup(vp, torch.float32, True, device))]
    else:
        print("[history] on the CPU the kernel routes (trunk kernel + eager heads, K1 "
              "f32 SIMT, K1 bf16 tensor cores) were not run; the check below holds the "
              "eager route against the shipped route's plain twin", file=sys.stderr)
    fa = FullAlignmentNet(add_indel_length=True, compute_dtype=bf16)
    fa.load_state_dict(from_jax_variables(vf), strict=True)
    fa = fa.to(device).eval()

    # every route computes the same trained net (bf16 noise only)
    real, rand = real_pileup_rows(256).to(device), stage_pileup()[:256]
    with torch.inference_mode():
        want = {"real": shipped(real), "random": shipped(rand)}
        for name, m in routes:
            d, d_rand = ((m(x) - want[k]).abs().max().item()
                         for k, x in (("real", real), ("random", rand)))
            print(f"[history] {name} vs shipped: max-abs prob diff {d:.2e} on 256 real "
                  f"pileup rows (bound {ROUTE_TOL}); {d_rand:.2e} on the JAX script's "
                  "random counts (reported only)", file=sys.stderr)
            if not d < ROUTE_TOL:
                print(f"[history] FAILED: {name} diverged from the shipped net: {d}",
                      file=sys.stderr)
                return 1

    rows = []

    def measure(name, model, stage, batch, iters):
        cps = bench_forward(model, stage, batch, iters)
        rows.append((name, cps))
        print(f"[history] {name}: {cps:,.0f} cand/s ({label})", file=sys.stderr)

    for name, m in routes:
        measure(name, m, stage_pileup, B_P, ITERS_P)
    if on_card:
        measure("pileup K1 bf16, tensor cores L1/L2/L3 (csrc/pileup_tc.cu; shipped)",
                shipped, stage_pileup, B_P, ITERS_P)
    measure("FA cuDNN conv, depth 89, bf16", fa, stage_fa, B_F, ITERS_F)

    print(f"[kernels] {json.dumps(kernel_counts())}")
    print(f"\n| configuration ({label}) | cand/s (bench.bench_forward) |")
    print("|---|---|")
    for name, cps in rows:
        print(f"| {name} | {cps:,.0f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
