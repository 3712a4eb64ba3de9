"""The port's copies of the JAX package's framework-free modules stay equal
to their originals.

Each copied file equals its original once the package name is substituted
(``clair3_tpu`` -> ``clair3_tpu_torch``, whole word).  A few files differ on
purpose; for each the differences are named here, as edits applied to the
substituted original, or as the list of definitions that were copied into a
module of the port's own.  When the reference changes, its copy fails here
instead of drifting.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "clair3_tpu")
PORT = os.path.join(REPO, "clair3_tpu_torch")

VERBATIM = [
    "config.py", "gvcf.py", "postprocess.py", "models/zoo.py",
    "task/__init__.py", "task/labels.py", "utils/__init__.py",
    "io/__init__.py", "io/arith.py", "io/bai.py", "io/bam.py", "io/bed.py", "io/bgzf.py",
    "io/cram.py", "io/fasta.py", "io/fqzcomp.py", "io/rans.py", "io/rans_nx16.py",
    "io/tabix.py", "io/tok3.py", "io/vcf.py",
    "pileup/__init__.py", "pileup/extractor.py", "fullalign/__init__.py",
    "fullalign/extractor.py", "decode/__init__.py", "decode/decoder.py",
    "pipeline/merge_sort.py", "pipeline/select.py",
    "phase/__init__.py", "phase/external.py", "phase/final_phasing.py", "phase/phaser.py",
    "realign/__init__.py", "realign/align.py", "realign/dbg.py", "realign/realigner.py",
    "native/common.h", "native/inflate.h",
    "native/clair3t_align.cc", "native/clair3t_arith.cc", "native/clair3t_bzip2.cc",
    "native/clair3t_cram.cc", "native/clair3t_dbg.cc", "native/clair3t_decode.cc",
    "native/clair3t_fullalign.cc", "native/clair3t_gvcf.cc", "native/clair3t_pack.cc",
    "native/clair3t_pileup.cc", "native/clair3t_rans.cc", "native/clair3t_rans_nx16.cc",
    "native/clair3t_xz.cc",
]

_NO_DIST = "            raise NotImplementedError(_NO_DIST)\n"

# file -> the (old, new) edits that turn the substituted original into the copy
EDITED = {
    # the --dist_* branches need parallel.distributed (jax); they raise
    "pipeline/call.py": [
        ("logger = logging.getLogger(__name__)\n",
         "logger = logging.getLogger(__name__)\n\n"
         "# multi-process calling needs the JAX package's parallel.distributed\n"
         '_NO_DIST = "multi-process calling (dist_process_count > 1) is not ported"\n'),
        ("            from clair3_tpu_torch.parallel.distributed import own_tasks\n\n"
         "            tasks = own_tasks(tasks, cfg.dist_process_id,\n"
         "                              cfg.dist_process_count)\n"
         '            logger.info("[plan] process %d/%d owns %d chunks",\n'
         "                        cfg.dist_process_id, cfg.dist_process_count,\n"
         "                        len(tasks))\n", _NO_DIST),
        ("            # multi-host: quantile cutoffs must come from EVERY process's\n"
         "            # rows or shards route different candidates than a single\n"
         "            # process (the reference's SelectQual likewise runs over the\n"
         "            # complete pileup VCF, preprocess/SelectQual.py)\n"
         "            from clair3_tpu_torch.parallel.distributed import gather_rowpack\n"
         "            from clair3_tpu_torch.pipeline.select import (cutoffs_from_rowpack,\n"
         "                                                    stats_rowpack)\n\n"
         "            pack = gather_rowpack(stats_rowpack(pileup_stats, contig_names))\n"
         "            var_qual, ref_qual, global_phase_qual = cutoffs_from_rowpack(\n"
         "                *pack, cfg.var_pct_full, cfg.ref_pct_full,\n"
         "                cfg.var_pct_phasing)\n", _NO_DIST),
    ],
    # the override has a name of the port's own; one build under a file lock
    "native/__init__.py": [
        ("import ctypes\nimport os\n", "import ctypes\nimport fcntl\nimport os\n"),
        ("CLAIR3T_NATIVE_SO", "CLAIR3T_TORCH_NATIVE_SO"),
        ("""        return _SO
    # compile to a temp path then rename: concurrent worker processes must
    # never dlopen a half-written .so
    tmp = _SO + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", *_SRCS, "-o", tmp, "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
""", """        return _SO
    # one build for all processes: the others wait on the lock, then find
    # the library the first one built
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_src:
            return _SO
        # compile to a temp path then rename: concurrent worker processes must
        # never dlopen a half-written .so
        tmp = _SO + f".tmp.{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", *_SRCS, "-o", tmp, "-lz",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
"""),
    ],
    # enable_compilation_cache imports jax; the decoder needs the rest
    "utils/common.py": [("CUT", "enable_compilation_cache")],
}

# port module -> (original, the definitions copied into it, edits by name)
DEFINITIONS = {
    # the help text describes the port's backend, not the TPU's
    "cli.py": ("clair3_tpu/cli.py", ["_add_call_args", "_reconcile_dwell",
                                     "resolve_model_file", "_validate_call_inputs"], {
        "_add_call_args": [
            ('"server (e.g. http://tpu-host:8618); no local "',
             '"server (e.g. http://gpu-host:8618); no local "'),
            ('help="inference compute dtype; auto = bf16 on TPU "\n'
             '                        "(benchmarked production config), fp32 elsewhere")',
             'help="inference compute dtype; auto = bf16 on CUDA, "\n'
             '                        "fp32 on the CPU")'),
            ('help="write a jax.profiler trace', 'help="write a torch.profiler trace'),
            ('help="coordinator address host:port of process 0 "\n'
             '                        "(omit on TPU pod slices with runtime bootstrap)")',
             'help="coordinator address host:port of process 0")'),
        ]}),
    "testing.py": ("clair3_tpu/testing.py", [
        "BASES", "_FA_BASE_FROM_VAL", "SimVariant", "random_reference",
        "_read_from_reference", "simulate_reads", "write_test_case", "PileupOracleEngine",
        "FullAlignmentOracleEngine", "trained_fixture_path"], {}),
    # simulate() drops its import of the simulator, which is its own module here
    "testing.py#demo": ("scripts/full_cascade_demo.py", ["PLATFORMS", "simulate"], {
        "simulate": [("    from clair3_tpu_torch.testing import SimVariant, random_reference, "
                      "write_test_case\n\n", "")]}),
    "ops/fa_compact.py": ("clair3_tpu/ops/fa_compact.py", [
        "_pack_base", "pack_fa", "_unpack", "unpack_fa_numpy", "K_BUCKETS", "_SPARSE_CH",
        "pack_fa_sparse", "_unpack_sparse", "unpack_fa_sparse_numpy"], {}),
    "ops/pileup_compact.py": ("clair3_tpu/ops/pileup_compact.py", [
        "_NO_NEG", "pack_pileup", "_unpack", "unpack_pileup_numpy"], {}),
}
# what the port's copies must not carry (jax)
ABSENT = {"ops/fa_compact.py": ["unpack_fa_jax", "unpack_fa_sparse_jax"],
          "ops/pileup_compact.py": ["unpack_pileup_jax"],
          "testing.py": ["FlaxCpuEngine"],
          "utils/common.py": ["enable_compilation_cache"]}


def _sub(text: str) -> str:
    return re.sub(r"\bclair3_tpu\b", "clair3_tpu_torch", text)


def _read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _definitions(path: str):
    """Top-level name -> its source (decorators included), substituted."""
    src = _read(path)
    lines = src.splitlines(keepends=True)
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
        else:
            continue
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        out[name] = _sub("".join(lines[first - 1: node.end_lineno]))
    return out


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_original(rel):
    assert _read(os.path.join(PORT, rel)) == _sub(_read(os.path.join(JAX, rel))), (
        f"clair3_tpu_torch/{rel} drifted from clair3_tpu/{rel}")


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_copy_differs_only_as_named(rel):
    want = _sub(_read(os.path.join(JAX, rel)))
    for old, new in EDITED[rel]:
        if old == "CUT":
            cut = _definitions(os.path.join(JAX, rel))[new]
            old, new = "\n\n" + cut, ""
        assert old in want, f"{rel}: the named edit no longer applies: {old[:80]!r}"
        want = want.replace(old, new)
    assert _read(os.path.join(PORT, rel)) == want


@pytest.mark.parametrize("key", sorted(DEFINITIONS))
def test_copied_definitions_equal_originals(key):
    rel = key.split("#")[0]
    original, names, edits = DEFINITIONS[key]
    have = _definitions(os.path.join(PORT, rel))
    want = _definitions(os.path.join(REPO, original))
    for name in names:
        expected = want[name]
        for old, new in edits.get(name, []):
            assert old in expected, f"{name}: the named edit no longer applies"
            expected = expected.replace(old, new)
        assert have.get(name) == expected, f"{rel}::{name} drifted from {original}"
    for name in ABSENT.get(rel, []):
        assert name not in have, f"{rel} carries {name}, which needs jax"


def test_every_copy_is_listed():
    """Every file of the port that shares a relative path with the JAX
    package is checked above."""
    listed = set(VERBATIM) | set(EDITED) | {k.split("#")[0] for k in DEFINITIONS}
    shared = set()
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cc", ".h")):
                rel = os.path.relpath(os.path.join(root, name), PORT)
                if os.path.exists(os.path.join(JAX, rel)):
                    shared.add(rel)
    # the port's own modules that share a name with the JAX package's
    own = {"__init__.py", "__main__.py", "models/__init__.py", "models/full_alignment.py",
           "models/params_io.py", "models/pileup.py", "ops/__init__.py", "ops/lstm.py",
           "pipeline/__init__.py", "pipeline/engine.py"}
    assert shared - own == listed, sorted((shared - own) ^ listed)
