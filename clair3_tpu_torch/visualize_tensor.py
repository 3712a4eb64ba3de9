"""Render candidate tensors from a dump_tensors fixture as text heatmaps,
the port's copy of ``scripts/visualize_tensor.py`` (numpy only; reference:
docs/model_input_visualization.md renders the same tensors with
matplotlib).

    python -m clair3_tpu_torch dump_tensors --bam_fn r.bam --ref_fn ref.fa \
        --ctg_name chr1 --tensor_fn /tmp/p
    python -m clair3_tpu_torch.visualize_tensor /tmp/p.npy [index]

Pileup tensors ([N,33,18]) print one row per channel with the reference
channel layout; full-alignment tensors ([N,depth,33,C]) print one block per
channel with one row per read.
"""

import os
import sys

import numpy as np

PILEUP_CHANNELS = [
    "A+", "C+", "G+", "T+", "Iall+", "I1+", "Dall+", "D1+", "D+",
    "A-", "C-", "G-", "T-", "Iall-", "I1-", "Dall-", "D1-", "D-",
]
FA_CHANNELS = ["ref", "alt", "strand", "MQ", "BQ", "AF", "insert", "HP", "dwell"]
SHADES = " .:-=+*#%@"


def shade(v, lo, hi):
    if hi <= lo:
        return SHADES[0]
    t = (v - lo) / (hi - lo)
    return SHADES[min(len(SHADES) - 1, max(0, int(t * (len(SHADES) - 1))))]


def show_pileup(t, info):
    print(f"pileup tensor {info}: [33 positions x 18 channels]")
    lo, hi = t.min(), t.max()
    print(f"value range [{lo}, {hi}]  (ref-base channels are negated)")
    center = t.shape[0] // 2
    header = "".join("|" if i == center else " " for i in range(t.shape[0]))
    print(f"{'':>6} {header}   <- candidate column")
    for ch in range(t.shape[1]):
        row = "".join(shade(abs(v), 0, max(abs(lo), abs(hi))) for v in t[:, ch])
        print(f"{PILEUP_CHANNELS[ch]:>6} {row}")


def show_fa(t, info):
    depth, positions, channels = t.shape
    print(f"full-alignment tensor {info}: [{depth} reads x {positions} "
          f"positions x {channels} channels]")
    for ch in range(channels):
        plane = t[:, :, ch]
        lo, hi = int(plane.min()), int(plane.max())
        print(f"\n-- channel {ch} ({FA_CHANNELS[ch]}) range [{lo}, {hi}] --")
        for r in range(depth):
            if not plane[r].any():
                continue
            print("".join(shade(abs(v), 0, max(abs(lo), abs(hi), 1))
                          for v in plane[r]))


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    path = sys.argv[1]
    idx = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    tensors = np.load(path)
    infos = open(path + ".info").read().splitlines() \
        if os.path.exists(path + ".info") else []
    info = infos[idx].split("\t")[0] if idx < len(infos) else f"#{idx}"
    t = tensors[idx]
    if t.ndim == 2:
        show_pileup(t, info)
    else:
        show_fa(t, info)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
