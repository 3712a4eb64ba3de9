"""Generate and execute the port's quick-demo notebooks, the twin of
``scripts/build_notebooks.py``, into ``clair3_tpu_torch/notebooks/``:

* the three platform demos (the reference's
  colab/clair3_{ont,pacbio_hifi,illumina}_quick_demo.ipynb analogs): each
  simulates platform-shaped reads with the built-in simulator, runs the
  cascade through ``python -m clair3_tpu_torch call`` and pins an
  acceptance table (precision/recall/F1), as the JAX notebooks do;
* the twin of ``notebooks/quick_demo.ipynb``: simulate, build training
  data, train a ``PileupNet`` with the port's trainer, call the held-out 40
  kb and score it.

    python -m clair3_tpu_torch.build_notebooks [--device cuda|cpu] [--no-exec] [--out_dir DIR]
        [ont hifi ilmn quick_demo]

Every notebook runs on ``--device`` (default ``cuda``); a markdown cell
names the device it was executed on and how to run it on the other.
Machine-specific paths (temporary directories, the repository, installed
packages) are scrubbed from the cell outputs, so regenerating does not
churn the committed notebooks.
"""

from __future__ import annotations

import argparse
import os
import re

import nbformat
from nbformat.v4 import new_code_cell, new_markdown_cell, new_notebook

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_DIR = os.path.join(REPO, "clair3_tpu_torch", "notebooks")

PLATFORMS = {
    "ont": dict(
        title="Clair3-TPU (PyTorch port) ONT quick demo",
        nb_name="clair3_tpu_torch_ont_quick_demo.ipynb",
        ref_nb="colab/clair3_ont_quick_demo.ipynb",
        read_length=3000, coverage=40, error=0.04, length=120_000,
        extra_flags="", snp_f1=0.99, indel_f1=0.95,
        blurb=(
            "Oxford Nanopore long reads: 3 kb reads at 40x with 4% base "
            "error. The cascade phases het SNPs with the built-in phaser "
            "and haplotags reads inside the native full-alignment "
            "extractor (the reference does this in C: "
            "`src/clair3_full_alignment_dwell.c:315-422`). For r10 dwell "
            "models add `--enable_dwell_time` (reads must carry `mv:B:c` "
            "tags)."),
    ),
    "hifi": dict(
        title="Clair3-TPU (PyTorch port) PacBio HiFi quick demo",
        nb_name="clair3_tpu_torch_pacbio_hifi_quick_demo.ipynb",
        ref_nb="colab/clair3_pacbio_hifi_quick_demo.ipynb",
        read_length=8000, coverage=25, error=0.01, length=100_000,
        extra_flags="", snp_f1=0.99, indel_f1=0.99,
        blurb=(
            "PacBio HiFi: 8 kb reads at 25x with 1% base error. HiFi uses "
            "the 55-deep full-alignment matrix and platform AF presets "
            "(reference: `shared/param_f.py:11`, `run_clair3.py:304-326`)."),
    ),
    "ilmn": dict(
        title="Clair3-TPU (PyTorch port) Illumina quick demo",
        nb_name="clair3_tpu_torch_illumina_quick_demo.ipynb",
        ref_nb="colab/clair3_illumina_quick_demo.ipynb",
        read_length=150, coverage=40, error=0.002, length=60_000,
        extra_flags="--no_phasing_for_fa", snp_f1=0.99, indel_f1=0.90,
        blurb=(
            "Illumina short reads: 150 bp reads at 40x. `--platform ilmn` "
            "automatically realigns reads around indels with the native "
            "de-Bruijn-consensus + affine-gap realigner before BOTH stages "
            "and uses the region-scoped FA-wins merge (reference: "
            "`preprocess/RealignReads.py`, `preprocess/MergeVcf.py:59-155`)."),
    ),
}

DEVICE_MD = """\
This copy was executed with `DEVICE = {device!r}` by
`python -m clair3_tpu_torch.build_notebooks --device {device}`.
{other}"""
ON_CPU = ("On a GPU host, `python -m clair3_tpu_torch.build_notebooks` (its default "
          "`--device cuda`) executes it again on the card; or set `DEVICE = \"cuda\"` "
          "below and run the cells.")
ON_CARD = ("Without a GPU, `python -m clair3_tpu_torch.build_notebooks --device cpu` "
           "executes it on the CPU; or set `DEVICE = \"cpu\"` below.")

SETUP_SRC = '''\
import os, sys, subprocess, tempfile
# the notebook runs from clair3_tpu_torch/notebooks/ of the repository
REPO = os.path.abspath(os.path.join("..", ".."))
sys.path.insert(0, REPO)
DEVICE = {device!r}  # "cuda": the GPU (bf16 and the pileup kernels); "cpu": f32 on the CPU
work = tempfile.mkdtemp(prefix="c3t_{plat}_demo_")
print("work dir:", work)'''

SIM_SRC = '''\
# Simulate a diploid sample with platform-shaped reads (no genome data /
# network in this environment; with real data, point --bam_fn/--ref_fn at
# an indexed BAM + FASTA instead and score with hap.py).
import random
from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

L = {length}
ref = random_reference(L, seed=11)
rng = random.Random(11)
variants = []
for pos in range(500, L - 500, 160):
    gt = (1, 1) if rng.random() < 0.5 else (0, 1)
    kind = rng.random()
    if kind < 0.7:  # SNP
        alt = rng.choice([b for b in "ACGT" if b != ref[pos]])
        variants.append(SimVariant(pos, ref[pos], alt, gt))
    elif kind < 0.85:  # insertion
        ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 3)))
        variants.append(SimVariant(pos, ref[pos], ref[pos] + ins, gt))
    else:  # deletion
        dlen = rng.randint(1, 3)
        variants.append(SimVariant(pos, ref[pos:pos + dlen + 1], ref[pos], gt))

fasta, bam, _, _ = write_test_case(
    work, ref_length=L, variants=variants, coverage={coverage},
    read_length={read_length}, seed=11, error_rate={error})
print(f"{{len(variants)}} simulated variants, "
      f"{{os.path.getsize(bam)/1e6:.1f}} MB BAM")'''

CALL_SRC = '''\
# Run the full two-stage cascade through the port's CLI on DEVICE.
# --use_oracle_engines substitutes alt-info-driven oracle networks so the
# demo runs in seconds without model files; drop it and pass
# --model_path DIR (pileup.{{npz,pt}} + full_alignment.{{npz,pt}}) to use
# trained or reference checkpoints.
out = os.path.join(work, "out")
cmd = [sys.executable, "-m", "clair3_tpu_torch", "call",
       "--bam_fn", bam, "--ref_fn", fasta, "--output", out,
       "--platform", {plat!r}, "--use_oracle_engines",
       "--var_pct_full", "1.0", "--ref_pct_full", "1.0",
       "--threads", "2", "--device", DEVICE] + {extra_flags!r}.split()
env = dict(os.environ, PYTHONPATH=REPO)
res = subprocess.run(cmd, env=env, capture_output=True, text=True)
print(res.stdout[-2000:])
assert res.returncode == 0, res.stderr[-2000:]'''

SCORE_SRC = '''\
# Score the merged VCF against the simulated truth -- the acceptance table
# (the reference pins hap.py tables the same way:
# docs/quick_demo/ont_quick_demo.md:95-99).
from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
from clair3_tpu_torch.postprocess import variant_metrics

truth = [VcfRecord("chr1", v.pos + 1, v.ref, v.alt, 60, "PASS", ".", "GT",
                   "1/1" if v.genotype == (1, 1) else "0/1")
         for v in variants]
query = list(VcfReader(os.path.join(out, "merge_output.vcf.gz")))
m = variant_metrics(truth, query)

header = ["VariantType", "FP", "FN", "TP", "Precision", "Recall", "F1-score"]
print("".join(h.ljust(13) for h in header))
for vt in ("SNP", "INDEL"):
    r = m[vt]
    print("".join(str(x).ljust(13) for x in (
        vt, r.query_fp, r.truth_fn, r.truth_tp,
        round(r.precision, 4), round(r.recall, 4), round(r.f1, 4))))

assert m["SNP"].f1 >= {snp_f1}, f"SNP F1 regression: {{m['SNP'].f1}}"
assert m["INDEL"].f1 >= {indel_f1}, f"INDEL F1 regression: {{m['INDEL'].f1}}"
print("\\nacceptance: PASS")'''

TAIL_MD = """\
### Going further

* **Train both networks from scratch and call with them** (the full
  acceptance run with pinned F1 gates):
  `python -m clair3_tpu_torch.full_cascade_demo demo_out hifi` trains a
  real PileupNet + FullAlignmentNet on a training slice and calls the
  held-out tail with them.
* **gVCF output**: add `--gvcf` to the call command above.
* **Reference checkpoints**: pass a directory of the reference's
  `pileup.pt` / `full_alignment.pt` as `--model_path`; they load directly.
* **Scaling**: `python -m clair3_tpu_torch.wgs_scale_demo --mbases 50
  --contigs 3 --output soak_out` runs the 50 Mb soak.
* **Speed**: `python -m clair3_tpu_torch.bench` measures the cascade and
  both nets' forward capacity on the card."""

QUICK_INTRO_MD = """\
# clair3_tpu_torch quick demo

The PyTorch port of Clair3's two-stage variant-calling cascade
(pileup BiLSTM -> candidate routing -> full-alignment CNN -> merge), the
twin of `notebooks/quick_demo.ipynb`. Self-contained: it simulates a
diploid genome (no external data needed), trains a real `PileupNet`, calls
a held-out region, and scores SNP/Indel precision-recall-F1 against the
simulated truth.

On a machine with real data, skip the simulation cell and point
`bam`/`fasta` at your files plus `--model_path` at trained checkpoints
(reference-layout `pileup.pt` / `full_alignment.pt` load directly)."""

QUICK_CELLS = [
    ("code", '''\
import os, sys, tempfile
# the notebook runs from clair3_tpu_torch/notebooks/ of the repository
sys.path.insert(0, os.path.abspath(os.path.join("..", "..")))
DEVICE = {device!r}  # "cuda": train and call on the GPU; "cpu": f32 on the CPU
out_dir = tempfile.mkdtemp(prefix="c3t_nb_")
print("outputs ->", out_dir)'''),
    ("markdown", """\
## 1. Simulate a diploid genome
260 kb reference, SNPs + 1-3 bp indels every ~130 bp, 25x coverage,
2% read error.  The last 40 kb is held out for evaluation."""),
    ("code", '''\
import random
from clair3_tpu_torch.testing import SimVariant, random_reference, write_test_case

L, TRAIN_END = 260_000, 220_000
ref = random_reference(L, seed=7)
rng = random.Random(7)
variants = []
for pos in range(400, L - 400, 130):
    kind, gt = rng.random(), (1, 1) if rng.random() < 0.5 else (0, 1)
    if kind < 0.7:
        variants.append(SimVariant(pos, ref[pos], rng.choice([b for b in 'ACGT' if b != ref[pos]]), gt))
    elif kind < 0.85:
        ins = ''.join(rng.choice('ACGT') for _ in range(rng.randint(1, 3)))
        variants.append(SimVariant(pos, ref[pos], ref[pos] + ins, gt))
    else:
        d = rng.randint(1, 3)
        variants.append(SimVariant(pos, ref[pos:pos + d + 1], ref[pos], gt))
fasta, bam, _, _ = write_test_case(out_dir, ref_length=L, variants=variants,
                                   coverage=25, read_length=900, seed=7, error_rate=0.02)
len(variants)'''),
    ("markdown", """\
## 2. Training data from the TRAIN region
Native C++ pileup extraction -> `[N, 33, 18]` count tensors; labels in
the reference's 90-wide gt21/zygosity/indel-length space."""),
    ("code", '''\
from clair3_tpu_torch.pileup.extractor import create_pileup_tensors
from clair3_tpu_torch.train.data import TruthVariant, build_labels

truths = [TruthVariant('chr1', v.pos + 1, v.ref, v.alt, *sorted(v.genotype)) for v in variants]
tensors, pos_infos, alt_infos, _ = create_pileup_tensors(
    bam, fasta, 'chr1', 1, TRAIN_END, min_snp_af=0.08, min_indel_af=0.12)
labels, keep = build_labels(pos_infos, truths, maximum_non_variant_ratio=5.0)
int(keep.sum()), 'training samples\''''),
    ("markdown", """\
## 3. Train the pileup network
AdamW + per-task focal loss, early stopping -- the reference's Train
recipe (clair3/Train.py), through the port's trainer on DEVICE: from an
HDF5 bin with `train_model` where h5py imports, else from the same arrays
in memory with `fit` (`testing.ArrayDataset`)."""),
    ("code", '''\
import importlib.util
from clair3_tpu_torch.config import TrainConfig
from clair3_tpu_torch.testing import ArrayDataset
from clair3_tpu_torch.train.data import write_bin
from clair3_tpu_torch.train.trainer import fit, train_model

cfg = TrainConfig(pileup=True, add_indel_length=False, batch_size=1000,
                  chunk_size_pileup=100, max_epoch=60, seed=0, early_stop_patience=15)
model_dir = os.path.join(out_dir, 'model')
if importlib.util.find_spec('h5py'):
    bin_fn = os.path.join(out_dir, 'pileup.bin')
    write_bin(bin_fn, tensors[keep], labels[keep],
              [x for x, k in zip(pos_infos, keep) if k],
              [x for x, k in zip(alt_infos, keep) if k])
    result = train_model([bin_fn], model_dir, cfg, max_steps=400, device=DEVICE)
else:
    data = ArrayDataset([tensors[keep]], [labels[keep]], chunk_size=cfg.chunk_size)
    result = fit(data, model_dir, cfg, max_steps=400, device=DEVICE)
result['best_val_loss']'''),
    ("markdown", """\
## 4. Call the held-out region
The production pipeline: chunk planning -> native extraction -> bucketed
forward (`InferenceEngine`; on a GPU bf16 and the pileup kernels, each
batch split over every visible card) ->
native decode -> sorted, indexed VCF."""),
    ("code", '''\
import torch
from clair3_tpu_torch.cli import load_model, resolve_compute_dtype
from clair3_tpu_torch.config import CallConfig
from clair3_tpu_torch.parallel.mesh import local_devices
from clair3_tpu_torch.pipeline.call import VariantCaller
from clair3_tpu_torch.pipeline.engine import InferenceEngine

device = torch.device(DEVICE)
devices = local_devices(device)  # on "cuda" every visible card: each batch is split over them
engine = InferenceEngine(load_model(result['model_path'], 'pileup', devices[0],
                                    resolve_compute_dtype('auto', device)),
                         devices[0], buckets=(256, 1024), devices=devices)
eval_bed = os.path.join(out_dir, 'eval.bed')
with open(eval_bed, 'w') as fh:
    fh.write(f'chr1\\t{TRAIN_END}\\t{L}\\n')
call_cfg = CallConfig(platform='hifi', bam_fn=bam, ref_fn=fasta, bed_fn=eval_bed,
                      output_dir=os.path.join(out_dir, 'out'),
                      indel_min_af=0.12, pileup_only=True, threads=4)
outputs = VariantCaller(call_cfg, pileup_engine=engine).run()
outputs'''),
    ("markdown", """\
## 5. Score against the simulated truth
Genotype-exact SNP/Indel precision, recall, F1 (the reference pins
hap.py tables the same way, docs/quick_demo/ont_quick_demo.md)."""),
    ("code", '''\
from clair3_tpu_torch.io.vcf import VcfReader, VcfRecord
from clair3_tpu_torch.postprocess import variant_metrics

truth_recs = [VcfRecord('chr1', v.pos + 1, v.ref, v.alt, 60, 'PASS', '.', 'GT',
                        '1/1' if v.genotype == (1, 1) else '0/1')
              for v in variants if v.pos >= TRAIN_END]
m = variant_metrics(truth_recs, list(VcfReader(outputs['merge_output'])))
header = ['VariantType', 'FP', 'FN', 'TP', 'Precision', 'Recall', 'F1-score']
print(''.join(h.ljust(13) for h in header))
for vt in ('SNP', 'INDEL'):
    r = m[vt]
    print(''.join(str(x).ljust(13) for x in (
        vt, r.query_fp, r.truth_fn, r.truth_tp,
        round(r.precision, 4), round(r.recall, 4), round(r.f1, 4))))
assert m['SNP'].f1 >= 0.95
print('\\nacceptance: PASS')'''),
    ("markdown", """\
## Going further
* Full two-stage cascade (trains BOTH nets, phasing + haplotagged
  full-alignment re-calling): `python -m clair3_tpu_torch.full_cascade_demo`.
* WGS-scale soak with gVCF: `python -m clair3_tpu_torch.wgs_scale_demo --mbases 50`.
* Real BAM/CRAM + trained models: `python -m clair3_tpu_torch call --bam_fn in.bam
  --ref_fn ref.fa --output out --model_path models/ --platform ont`."""),
]

QUICK_NAME = "clair3_tpu_torch_quick_demo.ipynb"


def _device_md(device: str) -> str:
    return DEVICE_MD.format(device=device, other=ON_CPU if device == "cpu" else ON_CARD)


def platform_cells(plat: str, spec: dict, device: str):
    return [
        new_markdown_cell(
            f"# {spec['title']}\n\n"
            f"The PyTorch/CUDA port's rebuild of Clair3's quick demo (reference analog: "
            f"`{spec['ref_nb']}`; the JAX package's twin: `colab/`). {spec['blurb']}\n\n"
            "The pipeline is the real production path: native pileup "
            "feature extraction, candidate selection, phasing + "
            "haplotype-aware full-alignment re-calling, merge, and an "
            "indexed VCF."),
        new_markdown_cell(_device_md(device)),
        new_code_cell(SETUP_SRC.format(plat=plat, device=device)),
        new_code_cell(SIM_SRC.format(**spec)),
        new_code_cell(CALL_SRC.format(plat=plat, **spec)),
        new_code_cell(SCORE_SRC.format(**spec)),
        new_markdown_cell(TAIL_MD),
    ]


def quick_demo_cells(device: str):
    cells = [new_markdown_cell(QUICK_INTRO_MD), new_markdown_cell(_device_md(device))]
    for kind, src in QUICK_CELLS:
        cells.append(new_code_cell(src.replace("{device!r}", repr(device)))
                     if kind == "code" else new_markdown_cell(src))
    return cells


def scrub(text: str) -> str:
    """Machine-specific paths out of a cell output: temporary directories
    (their random suffix and their parent), the repository and installed
    packages."""
    text = re.sub(r"[^\s'\"]*/(c3t_(?:[a-z0-9]+_demo|nb))_\w+", r"$TMPDIR/\1", text)
    text = text.replace(REPO, "<repo>")
    return re.sub(r"[^\s'\"]*/site-packages/", "<site-packages>/", text)


def build(name: str, cells, execute: bool, out_dir: str = NB_DIR, timeout: int = 7200) -> str:
    nb = new_notebook(metadata={
        "kernelspec": {"display_name": "Python 3", "language": "python",
                       "name": "python3"},
        "language_info": {"name": "python"},
    })
    nb.cells = cells
    os.makedirs(out_dir, exist_ok=True)
    if execute:
        from nbclient import NotebookClient

        # the cells find the repository two levels above their directory
        NotebookClient(nb, timeout=timeout, kernel_name="python3",
                       resources={"metadata": {"path": NB_DIR}}).execute()
    for cell in nb.cells:
        for out in cell.get("outputs", []) or []:
            if "text" in out:
                out["text"] = scrub(out["text"])
            for k, v in list(out.get("data", {}).items()):
                if isinstance(v, str):
                    out["data"][k] = scrub(v)
    path = os.path.join(out_dir, name)
    nbformat.write(nb, path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clair3_tpu_torch.build_notebooks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", choices=[*PLATFORMS, "quick_demo"],
                    help="notebooks to build (default: all four)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device the notebooks run on; cuda raises when no GPU is present")
    ap.add_argument("--no-exec", dest="execute", action="store_false",
                    help="write the notebooks without executing them")
    ap.add_argument("--out_dir", default=NB_DIR,
                    help="where to write them (default: clair3_tpu_torch/notebooks/)")
    args = ap.parse_args(argv)
    if args.execute:
        from clair3_tpu_torch.device import resolve_device

        resolve_device(args.device)
    for which in args.which or [*PLATFORMS, "quick_demo"]:
        if which == "quick_demo":
            path = build(QUICK_NAME, quick_demo_cells(args.device), args.execute, args.out_dir)
        else:
            spec = PLATFORMS[which]
            path = build(spec["nb_name"], platform_cells(which, spec, args.device),
                         args.execute, args.out_dir)
        print(f"[notebooks] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
