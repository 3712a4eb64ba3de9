"""The tabix indexer in the port's native library
(``native.tabix_payload_native``, ``native/clair3t_tabix.cc``) against the
Python indexer it stands in for (``io.tabix.tabix_payload_python``).

The native payload must equal the Python one byte for byte, quirks included,
on the cases of ``tests/test_tabix.py``, random multi-contig files, rows at
the edges of bins and linear windows, rows across BGZF blocks (one longer
than two blocks), files with no rows and hand-built BGZF files (a last row
without a newline, a block of 64 KiB that ends on a newline, empty blocks).
The ``.tbi`` that ``write_tabix_index`` writes equals the JAX package's, and
``TabixReader.fetch`` reads the same rows over both indexes.  Without the
library the Python indexer runs and ``vcf.index_native`` never closes; rows
the native parser declines are indexed, or rejected, by the Python indexer as
before.
"""

import os
import random

import pytest

from clair3_tpu.io.tabix import write_tabix_index as jax_write_tabix_index

from clair3_tpu_torch import native, spans
from clair3_tpu_torch.io.bgzf import BGZF_EOF, BgzfWriter, compress_block
from clair3_tpu_torch.io.tabix import TabixReader, tabix_payload_python, write_tabix_index
from clair3_tpu_torch.io.vcf import VcfWriter

HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"
BLOCK = 65280  # the writer's uncompressed bytes per block


@pytest.fixture(scope="module", autouse=True)
def lib():
    assert native.native_available(), "the port's native library did not build"


def _row(ctg, pos, ref="A", info="."):
    return f"{ctg}\t{pos}\t.\t{ref}\tT\t30\tPASS\t{info}\tGT\t0/1"


def _write_vcf(path, rows, header=HEADER):
    with VcfWriter(path, header) as w:
        for r in rows:
            w.write(r)
    return path


def _write_blocks(path, chunks):
    """A BGZF file of one block per chunk of text (bytes), then the EOF block."""
    with open(path, "wb") as fh:
        for chunk in chunks:
            fh.write(compress_block(chunk))
        fh.write(BGZF_EOF)
    return path


def _bgzf(payload):
    """The bytes BgzfWriter writes for ``payload``."""
    import io

    buf = io.BytesIO()
    w = BgzfWriter(buf)
    w.write(payload)
    w.close()
    return buf.getvalue()


def _same_payload(path):
    want = bytes(tabix_payload_python(path))
    have = native.tabix_payload_native(path)
    assert have is not None, "the native library declined the file"
    assert have == want
    return want


def _same_index_as_jax(path, tmp_path):
    port_tbi = write_tabix_index(path, str(tmp_path / "port.tbi"))
    jax_tbi = jax_write_tabix_index(path, str(tmp_path / "jax.tbi"))
    with open(port_tbi, "rb") as a, open(jax_tbi, "rb") as b:
        assert a.read() == b.read()
    return port_tbi


def _random_rows(n_rows, seed, contigs=3, span_bp=3_000_000):
    rng = random.Random(seed)
    rows, per = [], n_rows // contigs
    for c in range(contigs):
        for p in sorted(rng.sample(range(1, span_bp), per)):
            ref = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 60)))
            rows.append(_row(f"chr{c + 1}", p, ref, f"DP={rng.randint(1, 99)}"))
    return rows


def _edge_rows():
    """Rows just below and above multiples of 2^14, 2^17 and 2^20, and
    deletions that cross 16 kb windows and bin boundaries."""
    rows = []
    starts = set()
    for shift in (14, 17, 20):
        for k in (1, 2, 3):
            edge = k << shift
            for d in (-2, -1, 0, 1, 2):
                starts.add(edge + d)
    for beg in sorted(starts):
        rows.append(_row("chr1", beg + 1))
    # deletions: REF lengths that end just before, at and past a window edge
    for k in (1, 5, 8, 64):
        edge = k << 14
        for beg, ref_len in ((edge - 3, 3), (edge - 3, 4), (edge - 1, 60), (edge - 40, 41)):
            rows.append(_row("chr2", beg + 1, "A" * ref_len))
    rows.sort(key=lambda r: (r.split("\t")[0], int(r.split("\t")[1])))
    return rows


def _straddling_rows():
    """Rows of many lengths, so that rows straddle block boundaries, and one
    row longer than two blocks."""
    rng = random.Random(5)
    rows = [_row("chr1", 10 + i, info="X" * rng.randint(0, 3000)) for i in range(200)]
    rows.append(_row("chr1", 500, info="L" * (2 * BLOCK + 1234)))
    rows += [_row("chr1", 600 + i, info="Y" * rng.randint(0, 2000)) for i in range(100)]
    return rows


CASES = {
    # the cases of tests/test_tabix.py
    "small": lambda: [_row("chr1", p) for p in (100, 5000, 20000, 100000)]
    + [_row("chr2", p, "AGG") for p in (50, 70000)],
    "many_rows_spanning_blocks": lambda: [
        f"chr1\t{p}\t.\tA\tT\t30.00\tPASS\tP\tGT:GQ:DP:AD:AF\t0/1:30:30:15,15:0.5000"
        for p in sorted(random.Random(0).sample(range(1, 5_000_000), 4000))],
    "random_10k": lambda: _random_rows(10_000, 1),
    "random_100k": lambda: _random_rows(100_000, 2, contigs=5, span_bp=30_000_000),
    "bin_and_window_edges": _edge_rows,
    "straddling_blocks": _straddling_rows,
    "header_only": lambda: [],
    # a contig that comes back, four columns (REF is the rest of the row), CRLF
    # endings, leading zeros in POS, an empty REF
    "odd_rows": lambda: [_row("chr1", 5), _row("chr2", 7), _row("chr1", "0009"),
                         "chr3\t11\t.\tACGTAC", _row("chr3", 12) + "\r",
                         "chr3\t13\t.\t\tT\t30"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_payload_equals_the_python_one(case, tmp_path):
    path = _write_vcf(str(tmp_path / "x.vcf.gz"), CASES[case]())
    _same_payload(path)
    _same_index_as_jax(path, tmp_path)


@pytest.mark.parametrize("case", ["small", "many_rows_spanning_blocks", "random_10k",
                                  "bin_and_window_edges", "straddling_blocks", "odd_rows"])
def test_fetch_reads_the_same_rows_over_both_indexes(case, tmp_path, monkeypatch):
    path = _write_vcf(str(tmp_path / "x.vcf.gz"), CASES[case]())
    native_tbi = write_tabix_index(path, str(tmp_path / "native.tbi"))
    monkeypatch.setattr(native, "get_lib", _unavailable)
    python_tbi = write_tabix_index(path, str(tmp_path / "python.tbi"))
    a, b = TabixReader(path, native_tbi), TabixReader(path, python_tbi)
    assert a.names == b.names
    rng = random.Random(7)
    for ctg in a.names + ["chrX"]:
        for _ in range(20):
            lo = rng.randrange(0, 3_000_000)
            hi = lo + rng.choice((1, 100, 20_000, 300_000))
            assert list(a.fetch(ctg, lo, hi)) == list(b.fetch(ctg, lo, hi)), (ctg, lo, hi)


def test_the_pipeline_outputs_index_alike(tmp_path):
    """Every .vcf.gz a pileup-only ``call`` writes, indexed on both routes."""
    from clair3_tpu_torch.config import CallConfig
    from clair3_tpu_torch.pipeline.call import VariantCaller
    from clair3_tpu_torch.testing import (PileupOracleEngine, SimVariant, random_reference,
                                          write_test_case)

    ref = random_reference(1500, seed=91)
    v = SimVariant(700, ref[700], "C" if ref[700] != "C" else "G", (1, 1))
    fasta, bam, _, _ = write_test_case(str(tmp_path), ref_length=1500, variants=[v],
                                       coverage=20, read_length=500, seed=91)
    cfg = CallConfig(platform="ont", bam_fn=bam, ref_fn=fasta,
                     output_dir=str(tmp_path / "out"), pileup_only=True)
    outputs = VariantCaller(cfg, pileup_engine=PileupOracleEngine()).run()
    gz = [os.path.join(cfg.output_dir, f) for f in sorted(os.listdir(cfg.output_dir))
          if f.endswith(".vcf.gz")]
    assert outputs["merge_output"] in gz
    for path in gz:
        payload = _same_payload(path)
        with open(path + ".tbi", "rb") as fh:
            assert fh.read() == _bgzf(payload)
    got = list(TabixReader(outputs["merge_output"]).fetch("chr1", 690, 710))
    assert len(got) == 1 and "\t701\t" in got[0]


def _unavailable():
    raise OSError("no native library")


HAND_BUILT = {
    # the last row has no newline: it is not indexed
    "last_row_without_newline": [
        (HEADER + "\n" + _row("chr1", 10) + "\n" + _row("chr1", 20)).encode()],
    # a row split over three blocks, and a row that starts at a block's start
    "row_over_three_blocks": [
        (HEADER + "\n" + _row("chr1", 10) + "\nchr1\t3").encode(), b"0\t.\tACG",
        ("\tT\t30\tPASS\t.\tGT\t0/1\n" + _row("chr1", 40) + "\n").encode(),
        (_row("chr1", 50) + "\n").encode()],
    # a block of 64 KiB whose last byte is a row's newline
    "block_of_64k_ending_on_a_newline": [
        ((_row("chr1", 100, info="Z" * (65536 - len(_row("chr1", 100, info="")) - 1)))
         + "\n").encode(),
        (_row("chr1", 200) + "\n").encode()],
    # empty blocks between rows, and before a row that starts a block
    "empty_blocks": [
        (_row("chr1", 10) + "\n" + _row("chr1", 20)[:-3]).encode(), b"",
        b"0/1\n", b"", (_row("chr1", 30) + "\n").encode(), b""],
    # no block at all but the EOF block
    "no_rows": [],
}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_bgzf(case, tmp_path):
    path = _write_blocks(str(tmp_path / "x.vcf.gz"), HAND_BUILT[case])
    _same_payload(path)
    _same_index_as_jax(path, tmp_path)


@pytest.mark.parametrize("isize", [0, 7])
def test_a_block_whose_isize_is_wrong_goes_to_python(isize, tmp_path):
    """The Python reader ignores ISIZE; the library declines such a file."""
    text = (HEADER + "\n" + _row("chr1", 10) + "\n").encode()
    block = bytearray(compress_block(text))
    block[-4:] = isize.to_bytes(4, "little")
    path = str(tmp_path / "x.vcf.gz")
    with open(path, "wb") as fh:
        fh.write(bytes(block) + BGZF_EOF)
    assert native.tabix_payload_native(path) is None
    assert tabix_payload_python(path)[4:8] == b"\x01\x00\x00\x00"  # one contig read
    _same_index_as_jax(path, tmp_path)


def test_an_empty_file(tmp_path):
    path = str(tmp_path / "x.vcf.gz")
    open(path, "wb").close()
    _same_payload(path)


def test_without_the_library_the_python_indexer_runs(tmp_path, monkeypatch):
    path = _write_vcf(str(tmp_path / "x.vcf.gz"), CASES["random_10k"]())
    before = spans.totals().get("vcf.index_native", (0.0, 0))[1]
    write_tabix_index(path, str(tmp_path / "native.tbi"))
    assert spans.totals()["vcf.index_native"][1] == before + 1
    monkeypatch.setattr(native, "get_lib", _unavailable)
    assert native.tabix_payload_native(path) is None
    calls = []
    real = tabix_payload_python
    monkeypatch.setattr("clair3_tpu_torch.io.tabix.tabix_payload_python",
                        lambda p: calls.append(p) or real(p))
    write_tabix_index(path, str(tmp_path / "python.tbi"))
    assert calls == [path]
    assert spans.totals()["vcf.index_native"][1] == before + 1
    with open(tmp_path / "native.tbi", "rb") as a, open(tmp_path / "python.tbi", "rb") as b:
        assert a.read() == b.read()


# rows the native parser leaves to the Python indexer, which indexes them
DECLINED = {
    "pos_with_plus": "chr1\t+5\t.\tA\tT",
    "pos_with_spaces": "chr1\t 7 \t.\tA\tT",
    "pos_with_underscore": "chr1\t1_000\t.\tA\tT",
    "pos_of_eleven_digits": "chr1\t00000000005\t.\tA\tT",
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_declined_rows_are_indexed_in_python(case, tmp_path):
    path = _write_vcf(str(tmp_path / "x.vcf.gz"), [_row("chr1", 3), DECLINED[case]])
    assert native.tabix_payload_native(path) is None
    _same_index_as_jax(path, tmp_path)


# rows the Python indexer rejects: both routes raise what it raises, and
# write no index
REJECTED = {
    "no_ref_column": ("chr1\t5\t.", IndexError),
    "one_column": ("chr1", IndexError),
    "pos_not_a_number": ("chr1\tfive\t.\tA\tT", ValueError),
    "contig_not_utf8": (b"chr\xff\t5\t.\tA\tT", UnicodeDecodeError),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_rows_raise_as_before(case, tmp_path, monkeypatch):
    bad, exc = REJECTED[case]
    bad = bad if isinstance(bad, bytes) else bad.encode()
    path = _write_blocks(str(tmp_path / "x.vcf.gz"),
                         [(HEADER + "\n" + _row("chr1", 3) + "\n").encode() + bad + b"\n"])
    assert native.tabix_payload_native(path) is None
    with pytest.raises(exc):
        jax_write_tabix_index(path, str(tmp_path / "jax.tbi"))
    with pytest.raises(exc):
        write_tabix_index(path)
    monkeypatch.setattr(native, "get_lib", _unavailable)
    with pytest.raises(exc):
        write_tabix_index(path)
    assert not os.path.exists(path + ".tbi")
