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
    "compat.py", "config.py", "gvcf.py", "gvcf_validate.py", "postprocess.py",
    "models/convert.py", "models/schema.py", "models/zoo.py",
    "task/__init__.py", "task/labels.py", "utils/__init__.py",
    "io/__init__.py", "io/arith.py", "io/bai.py", "io/bam.py", "io/bed.py", "io/bgzf.py",
    "io/cram.py", "io/fasta.py", "io/fqzcomp.py", "io/rans.py", "io/rans_nx16.py",
    "io/tabix.py", "io/tok3.py", "io/vcf.py",
    "pileup/__init__.py", "pileup/extractor.py", "fullalign/__init__.py",
    "fullalign/extractor.py", "decode/__init__.py", "decode/decoder.py",
    "pipeline/call.py", "pipeline/merge_sort.py", "pipeline/select.py",
    "phase/__init__.py", "phase/external.py", "phase/final_phasing.py", "phase/phaser.py",
    "realign/__init__.py", "realign/align.py", "realign/dbg.py", "realign/realigner.py",
    "train/data.py", "train/unify.py",
    "native/common.h", "native/inflate.h",
    "native/clair3t_align.cc", "native/clair3t_arith.cc", "native/clair3t_bzip2.cc",
    "native/clair3t_cram.cc", "native/clair3t_dbg.cc", "native/clair3t_decode.cc",
    "native/clair3t_fullalign.cc", "native/clair3t_gvcf.cc", "native/clair3t_pack.cc",
    "native/clair3t_pileup.cc", "native/clair3t_rans.cc", "native/clair3t_rans_nx16.cc",
    "native/clair3t_xz.cc",
]

# file -> the (old, new) edits that turn the substituted original into the copy
EDITED = {
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
    # the server loads the port's engines on a device; the wire format, the
    # coalescer, the server and the client are the JAX package's
    "serve.py": [
        ('"""Remote inference serving: a TPU-resident engine server + thin client.',
         '"""Remote inference serving: a GPU-resident engine server + thin client.'),
        ("The\nTPU-native equivalent is this pair:", "The\nport's equivalent is this pair:"),
        ("  production engines on the TPU host (bf16 + Pallas + compact wire forms,\n"
         "  exactly `cli call`'s engines)",
         "  production engines on the GPU host (bf16 + CUDA kernels + compact wire\n"
         "  forms, exactly `cli call`'s engines)"),
        ("  forward passes execute on the serving TPU.", "  forward passes execute on the serving GPU."),
        ("submitter thread (jit dispatch already serialized)",
         "submitter thread (one CUDA stream per engine)"),
        ('                 fa_prefix: str = "full_alignment") -> EngineServer:\n'
         '    """Load `cli call`\'s production engines and wrap them in a server."""\n'
         "    from clair3_tpu_torch.cli import _load_engine, resolve_model_file\n",
         '                 fa_prefix: str = "full_alignment",\n'
         '                 device: str = "cuda") -> EngineServer:\n'
         '    """Load `cli call`\'s production engines on ``device`` and wrap them in\n'
         '    a server; ``cuda`` splits each batch over every visible card, and\n'
         '    raises when no GPU is visible."""\n'
         "    from clair3_tpu_torch.cli import _load_engine, resolve_compute_dtype, resolve_model_file\n"
         "    from clair3_tpu_torch.device import resolve_device\n\n"
         "    dev = resolve_device(device)\n"
         "    dt = resolve_compute_dtype(compute_dtype, dev)\n"),
        ("        engines[kind] = _load_engine(path, kind, platform,\n"
         "                                     compute_dtype=compute_dtype)\n",
         "        engines[kind] = _load_engine(path, kind, dev, dt)\n"),
    ],
}

# port module -> (original, the definitions copied into it, edits by name)
DEFINITIONS = {
    # the help text describes the port's backend, not the TPU's
    "cli.py": ("clair3_tpu/cli.py", ["_add_call_args", "_reconcile_dwell",
                                     "resolve_model_file", "_validate_call_inputs",
                                     "cmd_serve", "cmd_tensor2bin",
                                     "cmd_decode_probabilities", "cmd_sort_vcf",
                                     "cmd_merge_vcf", "cmd_dump_tensors", "cmd_split_bam",
                                     "cmd_models", "cmd_metrics", "cmd_validate_gvcf"], {
        "_add_call_args": [
            ('"server (e.g. http://tpu-host:8618); no local "\n'
             '                        "models needed")',
             '"server (e.g. http://gpu-host:8618); no local "\n'
             '                        "models needed, and --device is not used")'),
            ('help="inference compute dtype; auto = bf16 on TPU "\n'
             '                        "(benchmarked production config), fp32 elsewhere")',
             'help="inference compute dtype; auto = bf16 on CUDA, "\n'
             '                        "fp32 on the CPU")'),
            ('help="write a jax.profiler trace', 'help="write a torch.profiler trace'),
            ('help="coordinator address host:port of process 0 "\n'
             '                        "(omit on TPU pod slices with runtime bootstrap)")',
             'help="coordinator address host:port of process 0")'),
        ],
        # the engines load on --device; the kernels need no compilation cache
        "cmd_serve": [
            ("(TPU host side of", "(GPU host side of"),
            ("    from clair3_tpu_torch.utils.common import enable_compilation_cache\n", ""),
            ("so TPU-host operators", "so GPU-host operators"),
            ("    enable_compilation_cache()\n", ""),
            ("fa_model=args.full_alignment_model)",
             "fa_model=args.full_alignment_model,\n        device=args.device)"),
        ]}),
    # the class weights are numpy; the losses are the port's own
    "train/loss.py": ("clair3_tpu/train/loss.py", ["effective_class_weights"], {}),
    # convert.py's main writes .npz through the JAX package's save_variables
    "models/params_io.py": ("clair3_tpu/models/params_io.py", ["save_variables"], {}),
    # the mesh itself is a torch.distributed process group here
    "parallel/mesh.py": ("clair3_tpu/parallel/mesh.py", ["pad_to_multiple"], {}),
    "testing.py": ("clair3_tpu/testing.py", [
        "BASES", "_FA_BASE_FROM_VAL", "SimVariant", "random_reference",
        "_read_from_reference", "simulate_reads", "write_test_case", "PileupOracleEngine",
        "FullAlignmentOracleEngine", "trained_fixture_path",
        "vcf_rows_numerically_equivalent"], {}),
    # simulate() drops its import of the simulator, which is its own module here
    "testing.py#demo": ("scripts/full_cascade_demo.py", ["PLATFORMS", "simulate"], {
        "simulate": [("    from clair3_tpu_torch.testing import SimVariant, random_reference, "
                      "write_test_case\n\n", "")]}),
    # the soak's input simulation, its peak-RSS probe and its VCF reader
    "wgs_scale_demo.py": ("scripts/wgs_scale_demo.py", [
        "SEG", "peak_rss_gb", "build_input", "_vcf_body"], {}),
    "train_fixture_checkpoints.py": ("scripts/train_fixture_checkpoints.py", ["_freeze"], {}),
    # the bench's workload, routing, cascade and decode microbench
    "bench.py": ("bench.py", [
        "GENOME_MB", "N_CHUNKS", "PLATS", "VAR_PCT_FULL", "MATRIX_DEPTH", "make_workload",
        "route_candidates", "run_cascade", "bench_oracle_decode"], {}),
    "visualize_tensor.py": ("scripts/visualize_tensor.py", [
        "PILEUP_CHANNELS", "FA_CHANNELS", "SHADES", "shade", "show_pileup", "show_fa",
        "main"], {}),
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


# the parsers of the JAX CLI's main(), as blocks of the port's main();
# `train` names the process group behind --data_parallel and adds --device
PARSER_BLOCKS = {
    "sort_vcf..decode_probabilities": (
        '    sv = sub.add_parser("sort_vcf"',
        '    dp.set_defaults(func=cmd_decode_probabilities)\n', []),
    "dump_tensors..split_bam": ('    dt = sub.add_parser("dump_tensors"',
                                '    sb.set_defaults(func=cmd_split_bam)\n', []),
    "models..validate_gvcf": ('    zl = sub.add_parser(',
                              '    vg.set_defaults(func=cmd_validate_gvcf)\n', []),
    "tensor2bin": ('    t2b = sub.add_parser("tensor2bin"', '    t2b.set_defaults(func=cmd_tensor2bin)\n',
                   []),
    "train": ('    tr = sub.add_parser("train"', '    tr.set_defaults(func=cmd_train)\n', [
        ('                    help="shard batches over all devices via a Mesh")\n',
         '                    help="shard batches over all devices via a process group "\n'
         '                         "(torchrun --nproc_per_node=<cards>, else one rank per "\n'
         '                         "visible GPU)")\n'),
        ('    tr.set_defaults(func=cmd_train)\n',
         '    tr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),\n'
         '                    help="device of the trained net; cuda raises when no GPU "\n'
         '                         "is present")\n'
         '    tr.set_defaults(func=cmd_train)\n'),
    ]),
}


def _block(text, start, end):
    i = text.index(start)
    return text[i: text.index(end, i) + len(end)]


@pytest.mark.parametrize("name", sorted(PARSER_BLOCKS))
def test_parser_blocks_equal_originals(name):
    start, end, edits = PARSER_BLOCKS[name]
    want = _block(_sub(_read(os.path.join(JAX, "cli.py"))), start, end)
    for old, new in edits:
        assert old in want, f"{name}: the named edit no longer applies: {old[:80]!r}"
        want = want.replace(old, new)
    assert _block(_read(os.path.join(PORT, "cli.py")), start, end) == want


# the reference-flag entry point: --device passes on to the port's `call`,
# whose default is the GPU, where the original drops it
ENTRY_EDITS = [
    ("    python run_clair3_tpu.py --bam_fn", "    python run_clair3_tpu_torch.py --bam_fn"),
    ("    # external-tool paths and device selection the reference accepts but the\n"
     "    # single-program design has no use for (value-taking flags)\n"
     '    ignored = {"--pypy", "--python", "--samtools", "--parallel", "--device"}\n',
     "    # external-tool paths the reference accepts but the single-program design\n"
     "    # has no use for (value-taking flags); --device passes on to `call`,\n"
     "    # which runs on the GPU unless it says cpu\n"
     '    ignored = {"--pypy", "--python", "--samtools", "--parallel"}\n'),
]


def test_entry_point_differs_only_as_named():
    want = _sub(_read(os.path.join(REPO, "run_clair3_tpu.py")))
    for old, new in ENTRY_EDITS:
        assert old in want, f"the named edit no longer applies: {old[:80]!r}"
        want = want.replace(old, new)
    assert _read(os.path.join(REPO, "run_clair3_tpu_torch.py")) == want


def test_every_copy_is_listed():
    """Every file of the port that shares a relative path with the JAX
    package is checked above (the port's twins of ``scripts/`` are named in
    DEFINITIONS besides)."""
    listed = set(VERBATIM) | set(EDITED) | {k.split("#")[0] for k, (original, _, _) in
                                            DEFINITIONS.items()
                                            if original.startswith("clair3_tpu/")}
    shared = set()
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cc", ".h")):
                rel = os.path.relpath(os.path.join(root, name), PORT)
                if os.path.exists(os.path.join(JAX, rel)):
                    shared.add(rel)
    # the port's own modules that share a name with the JAX package's
    own = {"__init__.py", "__main__.py", "models/__init__.py", "models/fb.py",
           "models/full_alignment.py",
           "models/pileup.py", "ops/__init__.py", "ops/lstm.py",
           "parallel/__init__.py", "parallel/distributed.py",
           "pipeline/__init__.py", "pipeline/engine.py",
           "train/__init__.py", "train/step.py", "train/trainer.py"}
    assert shared - own == listed, sorted((shared - own) ^ listed)
