"""Native (C++) host extractors with lazy compilation and ctypes bindings.

The shared library is built on first use with g++ (no pybind11 in this
image; the C API is plain structs + arrays).  Outputs are bit-identical to
the numpy reference extractors — enforced by differential tests.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "clair3t_arith.cc"),
         os.path.join(_DIR, "clair3t_pileup.cc"),
         os.path.join(_DIR, "clair3t_fullalign.cc"),
         os.path.join(_DIR, "clair3t_align.cc"),
         os.path.join(_DIR, "clair3t_dbg.cc"),
         os.path.join(_DIR, "clair3t_decode.cc"),
         os.path.join(_DIR, "clair3t_gvcf.cc"),
         os.path.join(_DIR, "clair3t_rans.cc"),
         os.path.join(_DIR, "clair3t_rans_nx16.cc"),
         os.path.join(_DIR, "clair3t_cram.cc"),
         os.path.join(_DIR, "clair3t_bzip2.cc"),
         os.path.join(_DIR, "clair3t_xz.cc"),
         os.path.join(_DIR, "clair3t_pack.cc"),
         os.path.join(_DIR, "clair3t_phase.cc"),
         os.path.join(_DIR, "clair3t_tabix.cc")]
_HDRS = [os.path.join(_DIR, "common.h")]
_SO = os.path.join(_DIR, "libclair3t.so")
_lock = threading.Lock()
_lib = None


class _PileupOut(ctypes.Structure):
    _fields_ = [
        ("counts", ctypes.POINTER(ctypes.c_int32)),
        ("depth", ctypes.POINTER(ctypes.c_int32)),
        ("pos_ref_count", ctypes.POINTER(ctypes.c_int64)),
        ("pos_total_count", ctypes.POINTER(ctypes.c_int64)),
        ("alt_infos", ctypes.POINTER(ctypes.c_char_p)),
        ("cand_pos", ctypes.POINTER(ctypes.c_int64)),
        ("n_candidates", ctypes.c_int32),
        ("L", ctypes.c_int32),
        ("error", ctypes.c_int32),
        ("external", ctypes.c_int32),
    ]


def _build() -> str:
    # CLAIR3T_TORCH_NATIVE_SO overrides the library (e.g. an ASan build from
    # build_sanitizer(); the preloading subprocess test uses this)
    override = os.environ.get("CLAIR3T_TORCH_NATIVE_SO")
    if override:
        return override
    newest_src = max(os.path.getmtime(p) for p in _SRCS + _HDRS)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_src:
        return _SO
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
    return _SO


def build_sanitizer(kind: str = "address") -> str:
    """Build an AddressSanitizer/UBSan instrumented copy of the native
    library (CI-style memory-safety check; run the consuming python under
    LD_PRELOAD=libasan.so)."""
    so = os.path.join(_DIR, f"libclair3t_{kind[:4]}.so")
    newest_src = max(os.path.getmtime(p) for p in _SRCS + _HDRS)
    if os.path.exists(so) and os.path.getmtime(so) >= newest_src:
        return so
    tmp = so + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O1", "-g", f"-fsanitize={kind}", "-fno-omit-frame-pointer",
        "-std=c++17", "-shared", "-fPIC", "-pthread", *_SRCS, "-o", tmp, "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.clair3t_pileup.restype = ctypes.POINTER(_PileupOut)
            lib.clair3t_pileup.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.clair3t_pileup_free.argtypes = [ctypes.POINTER(_PileupOut)]
            _lib = lib
    return _lib


_meta_lock = threading.Lock()
_header_cache: dict = {}   # (path, mtime) -> {name: tid}
_bai_cache: dict = {}      # (path, mtime) -> BaiIndex | None


def _bam_meta(bam_path: str):
    """Cached (tid_map, BaiIndex|None); re-parsing headers and multi-MB BAI
    indexes per chunk would dwarf the native extraction they gate."""
    from clair3_tpu_torch.io.bam import read_bam_header

    key = (bam_path, os.path.getmtime(bam_path))
    with _meta_lock:
        if key not in _header_cache:
            _, refs, _ = read_bam_header(bam_path)
            _header_cache[key] = {n: i for i, n in enumerate(refs)}
            bai_path = bam_path + ".bai"
            bai = None
            if os.path.exists(bai_path):
                from clair3_tpu_torch.io.bai import BaiIndex

                try:
                    bai = BaiIndex(bai_path)
                except ValueError:
                    bai = None
            _bai_cache[key] = bai
        return _header_cache[key], _bai_cache[key]


def _bai_windows(bam_path: str, ctg_name: str, start: int, end: int):
    """(tid, voffs_array|None, n_win): merged chunk windows from the .bai
    index; n_win == 0 means full scan (no index), voffs None with n_win == -1
    means the region provably has no reads."""
    tid_map, bai = _bam_meta(bam_path)
    if ctg_name not in tid_map:
        raise KeyError(f"contig {ctg_name!r} not in {bam_path}")
    tid = tid_map[ctg_name]
    if bai is None:
        return tid, None, 0
    chunks = bai.query_chunks(tid, start, end)
    if chunks is None:
        return tid, None, -1
    flat = []
    for cb, ce in chunks:
        flat.extend((cb, ce))
    return tid, (ctypes.c_uint64 * len(flat))(*flat), len(chunks)


def native_available() -> bool:
    # kill switch for differential runs against the pure-Python oracles
    # (reference: run_clair3.py --disable_c_impl)
    if os.environ.get("CLAIR3T_DISABLE_NATIVE"):
        return False
    try:
        get_lib()
        return True
    except Exception:
        return False


def pileup_region_native(
    bam_path: str,
    ref_seq: str,
    ref_offset: int,
    ctg_name: str,
    start: int,
    end: int,
    *,
    min_mq: int = 5,
    min_depth: int = 2,
    min_snp_af: float = 0.08,
    min_indel_af: float = 0.15,
    max_indel_length: int = 50,
    call_snp_only: bool = False,
    gvcf: bool = False,
    call_ht: bool = False,
    threads: int = 1,
):
    """Native counterpart of clair3_tpu_torch.pileup.extractor.pileup_region,
    returning a PileupResult with identical contents."""
    from clair3_tpu_torch.pileup.extractor import PileupCandidate, PileupResult

    lib = get_lib()
    tid, voffs, n_win = _bai_windows(bam_path, ctg_name, start, end)
    if n_win < 0:  # indexed and provably empty region
        L = end - start
        return PileupResult(
            start=start, counts=np.zeros((L, 18), np.int32),
            depth=np.zeros(L, np.int32), candidates=[],
            pos_ref_count=np.zeros(L, np.int64) if gvcf else None,
            pos_total_count=np.zeros(L, np.int64) if gvcf else None)
    # caller-owned output buffers: the native side fills them in place, so
    # there is no internal 2x alloc+memcpy and no ctypes copy-out
    L = end - start
    counts = np.zeros((L, 18), np.int32)
    depth = np.zeros(L, np.int32)
    pos_ref = pos_tot = None
    _i32p = ctypes.POINTER(ctypes.c_int32)
    _i64p = ctypes.POINTER(ctypes.c_int64)
    pr_ptr = pt_ptr = ctypes.cast(None, _i64p)
    if gvcf:
        pos_ref = np.zeros(L, np.int64)
        pos_tot = np.zeros(L, np.int64)
        pr_ptr = pos_ref.ctypes.data_as(_i64p)
        pt_ptr = pos_tot.ctypes.data_as(_i64p)
    out_p = lib.clair3t_pileup(
        bam_path.encode(), ctg_name.encode(), start, end,
        ref_seq.encode(), ref_offset,
        min_mq, min_depth, min_snp_af, min_indel_af,
        max_indel_length, int(call_snp_only), int(gvcf), int(call_ht),
        voffs, n_win, tid, threads,
        counts.ctypes.data_as(_i32p), depth.ctypes.data_as(_i32p),
        pr_ptr, pt_ptr,
    )
    out = out_p.contents
    try:
        if out.error:
            raise RuntimeError(
                f"native pileup failed (error={out.error}) for {bam_path} {ctg_name}")
        candidates: List[PileupCandidate] = []
        for i in range(out.n_candidates):
            alt = out.alt_infos[i].decode()
            pos = int(out.cand_pos[i])
            head, _, rest = alt.partition("-")
            depth_s, _, rest2 = rest.partition("-")
            ref_base, _, tail = rest2.partition("-")
            candidates.append(
                PileupCandidate(pos, int(depth_s), ref_base, f"{depth_s}-{tail}"))
        return PileupResult(
            start=start, counts=counts, depth=depth, candidates=candidates,
            pos_ref_count=pos_ref, pos_total_count=pos_tot)
    finally:
        lib.clair3t_pileup_free(out_p)


class _FaOut(ctypes.Structure):
    _fields_ = [
        ("matrix", ctypes.POINTER(ctypes.c_int8)),
        ("alt_infos", ctypes.POINTER(ctypes.c_char_p)),
        ("cand_pos", ctypes.POINTER(ctypes.c_int64)),
        ("n_cand", ctypes.c_int32),
        ("depth", ctypes.c_int32),
        ("positions", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("error", ctypes.c_int32),
        ("external", ctypes.c_int32),
    ]


def _bind_fa(lib):
    if getattr(lib, "_fa_bound", False):
        return
    lib.clair3t_fullalign.restype = ctypes.POINTER(_FaOut)
    lib.clair3t_fullalign.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.clair3t_fullalign_free.argtypes = [ctypes.POINTER(_FaOut)]
    lib._fa_bound = True


def fa_region_native(
    bam_path: str,
    ref_seq: str,
    ref_offset: int,
    ctg_name: str,
    candidates0,
    variants=(),
    *,
    matrix_depth: int = 89,
    min_mq: int = 5,
    max_indel_length: int = 50,
    need_haplotagging: bool = True,
    enable_dwell: bool = False,
    seed: int = 0,
):
    """Native counterpart of clair3_tpu_torch.fullalign.extractor.fa_region.

    ``variants`` are PhasedVariant namedtuple-likes (position, ref_base,
    alt_base, genotype, phase_set).  Returns (tensor, cand_positions,
    alt_infos) identical to the Python oracle."""
    lib = get_lib()
    _bind_fa(lib)

    cands = sorted(set(int(c) for c in candidates0))
    n_cand = len(cands)
    channels = 9 if enable_dwell else 8
    if n_cand == 0:
        return (np.zeros((0, matrix_depth, 33, channels), np.int8), [], [])
    cand_arr = (ctypes.c_int64 * n_cand)(*cands)

    variants = sorted(variants, key=lambda v: v.position)
    n_var = len(variants)
    var_pos = (ctypes.c_int64 * max(n_var, 1))(*[v.position for v in variants])
    var_ref = "".join(v.ref_base[0] for v in variants).encode() or b"\x00"
    var_alt = "".join(v.alt_base[0] for v in variants).encode() or b"\x00"
    var_gt = (ctypes.c_int32 * max(n_var, 1))(*[v.genotype for v in variants])
    var_ps = (ctypes.c_int32 * max(n_var, 1))(*[v.phase_set for v in variants])

    region_start = max(0, cands[0] - 16)
    region_end = cands[-1] + 17
    tid, voffs, n_win = _bai_windows(bam_path, ctg_name, region_start, region_end)
    if n_win < 0:
        # indexed and provably empty: zero tensor + "0-" alt-infos, no BAM IO
        return (np.zeros((n_cand, matrix_depth, 33, channels), np.int8),
                cands, ["0-"] * n_cand)
    # caller-owned tensor: the native fill writes in place (no alloc/copy)
    matrix = np.zeros((n_cand, matrix_depth, 33, channels), np.int8)
    out_p = lib.clair3t_fullalign(
        bam_path.encode(), ctg_name.encode(),
        ref_seq.encode(), ref_offset,
        cand_arr, n_cand,
        var_pos, var_ref, var_alt, var_gt, var_ps, n_var,
        int(need_haplotagging), min_mq, matrix_depth,
        max_indel_length, int(enable_dwell), seed,
        voffs, n_win, tid,
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    out = out_p.contents
    try:
        if out.error:
            raise RuntimeError(
                f"native fullalign failed (error={out.error}) for {bam_path} {ctg_name}")
        alt_infos = [out.alt_infos[i].decode() for i in range(out.n_cand)]
        cand_pos = [int(out.cand_pos[i]) for i in range(out.n_cand)]
        return matrix, cand_pos, alt_infos
    finally:
        lib.clair3t_fullalign_free(out_p)


class _PhaseAllelesOut(ctypes.Structure):
    _fields_ = [
        ("read", ctypes.POINTER(ctypes.c_int32)),
        ("snp", ctypes.POINTER(ctypes.c_int32)),
        ("allele", ctypes.POINTER(ctypes.c_int8)),
        ("n", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def _bind_phase(lib):
    if getattr(lib, "_phase_bound", False):
        return
    lib.clair3t_phase_alleles.restype = ctypes.POINTER(_PhaseAllelesOut)
    lib.clair3t_phase_alleles.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.clair3t_phase_alleles_free.argtypes = [ctypes.POINTER(_PhaseAllelesOut)]
    lib._phase_bound = True


def phase_alleles_native(
    bam_path: str,
    ctg_name: str,
    start: int,
    end: int,
    snp_positions,
    snp_ref: bytes,
    snp_alt: bytes,
    *,
    min_mq: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native counterpart of ``BamReader.fetch(ctg_name, start, end,
    min_mq=min_mq)`` followed by phase.phaser.read_alleles_at_snps on
    every read.

    ``snp_positions`` are sorted, distinct 0-based positions; ``snp_ref`` and
    ``snp_alt`` hold one byte per position.  Returns three arrays in BAM
    order, positions ascending within a read: the read's ordinal among the
    reads kept (int32), the index of the SNP in ``snp_positions`` (int32) and
    the allele (int8: 0 ref, 1 alt).  None when the native library is not
    available."""
    try:
        lib = get_lib()
    except Exception:
        return None
    _bind_phase(lib)
    pos = np.ascontiguousarray(snp_positions, dtype=np.int64)
    n = len(pos)
    if len(snp_ref) != n or len(snp_alt) != n:
        raise ValueError("one REF and one ALT byte per SNP position")
    if n > 1 and not np.all(pos[1:] > pos[:-1]):
        raise ValueError("SNP positions must be sorted and distinct")
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int8))
    tid, voffs, n_win = _bai_windows(bam_path, ctg_name, start, end)
    if n == 0 or n_win < 0:  # nothing to scan, or indexed and provably empty
        return empty
    out_p = lib.clair3t_phase_alleles(
        bam_path.encode(), tid, start, end, min_mq,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), snp_ref, snp_alt, n,
        voffs, n_win)
    out = out_p.contents
    try:
        if out.error == 2:
            raise IndexError(f"a read of {bam_path} {ctg_name} aligns past its sequence")
        if out.error:
            raise RuntimeError(
                f"native phase scan failed (error={out.error}) for {bam_path} {ctg_name}")
        if out.n == 0:
            return empty
        return (np.ctypeslib.as_array(out.read, (out.n,)).copy(),
                np.ctypeslib.as_array(out.snp, (out.n,)).copy(),
                np.ctypeslib.as_array(out.allele, (out.n,)).copy())
    finally:
        lib.clair3t_phase_alleles_free(out_p)


class _TabixOut(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("n", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def _bind_tabix(lib):
    if getattr(lib, "_tabix_bound", False):
        return
    lib.clair3t_tabix_index.restype = ctypes.POINTER(_TabixOut)
    lib.clair3t_tabix_index.argtypes = [ctypes.c_char_p]
    lib.clair3t_tabix_free.argtypes = [ctypes.POINTER(_TabixOut)]
    lib._tabix_bound = True


def tabix_payload_native(vcf_gz_path: str) -> Optional[bytes]:
    """Native counterpart of io.tabix.tabix_payload_python: the uncompressed
    .tbi payload of a coordinate-sorted BGZF VCF, byte for byte.

    None when the native library is not available, or where it declines the
    file: one it does not read as BGZF, a row with fewer than four columns or
    a POS other than plain digits in [1, 2^31), or a contig name that is not
    UTF-8.  The Python indexer then builds the same payload or raises."""
    try:
        lib = get_lib()
    except Exception:
        return None
    _bind_tabix(lib)
    out_p = lib.clair3t_tabix_index(os.fsencode(vcf_gz_path))
    out = out_p.contents
    try:
        if out.error:
            return None
        payload = ctypes.string_at(out.data, out.n)
    finally:
        lib.clair3t_tabix_free(out_p)
    # the Python indexer decodes each contig name (l_nm at byte 32, the names after it)
    l_nm = int.from_bytes(payload[32:36], "little")
    try:
        payload[36:36 + l_nm].decode()
    except UnicodeDecodeError:
        return None
    return payload


class _DecodeOut(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.POINTER(ctypes.c_char_p)),
        ("n", ctypes.c_int32),
        ("error", ctypes.c_int32),
    ]


def _bind_decode(lib):
    if getattr(lib, "_decode_bound", False):
        return
    lib.clair3t_decode.restype = ctypes.POINTER(_DecodeOut)
    lib.clair3t_decode.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.clair3t_decode_free.argtypes = [ctypes.POINTER(_DecodeOut)]
    lib._decode_bound = True


def decode_batch_native(position_infos, alt_infos, batch_probabilities,
                        config, threads: int = 0) -> List[str]:
    """Native counterpart of clair3_tpu_torch.decode.decoder.batch_decode —
    byte-identical VCF rows (suppressed candidates omitted).

    ``config`` is a decode.decoder.DecodeConfig."""
    lib = get_lib()
    _bind_decode(lib)
    n = len(position_infos)
    if n == 0:
        return []
    pos_arr = (ctypes.c_char_p * n)(*[p.encode() for p in position_infos])
    alt_arr = (ctypes.c_char_p * n)(*[
        (a if isinstance(a, bytes) else str(a).encode()) for a in alt_infos])
    probs = np.ascontiguousarray(batch_probabilities, dtype=np.float64)
    if probs.ndim != 2 or probs.shape[0] != n:
        raise ValueError(f"probabilities shape {probs.shape} != ({n}, W)")
    out_p = lib.clair3t_decode(
        pos_arr, alt_arr,
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, probs.shape[1],
        int(config.add_indel_length), int(config.pileup),
        int(config.show_ref_calls), int(config.gvcf),
        int(config.quality_score_for_pass is not None),
        float(config.quality_score_for_pass or 0.0),
        int(config.haploid_precise), int(config.haploid_sensitive),
        int(config.enable_long_indel),
        int(config.maximum_variant_length_that_need_infer),
        int(config.keep_iupac_bases), int(config.cal_precise_long_indel_af),
        float(config.long_indel_distance_proportion),
        int(config.max_variant_length_infer_default), int(threads),
    )
    out = out_p.contents
    try:
        if out.error:
            raise RuntimeError("native decode failed")
        return [out.rows[i].decode() for i in range(out.n) if out.rows[i]]
    finally:
        lib.clair3t_decode_free(out_p)


def rans_decode_native(payload: bytes) -> Optional[bytes]:
    """Native rANS 4x8 decode of a CRAM block payload; None when the native
    library is unavailable (caller falls back to io/rans.py)."""
    try:
        lib = get_lib()
    except Exception:
        return None
    if not getattr(lib, "_rans_bound", False):
        lib.clair3t_rans_decode.restype = ctypes.c_int
        lib.clair3t_rans_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib._rans_bound = True
    import struct

    if len(payload) < 9:
        raise ValueError("truncated rANS stream")
    out_sz = struct.unpack_from("<I", payload, 5)[0]
    out = (ctypes.c_uint8 * out_sz)()
    rc = lib.clair3t_rans_decode(payload, len(payload), out, out_sz)
    if rc != 0:
        raise ValueError("native rANS decode failed")
    return bytes(out)


def bzip2_decode_native(payload: bytes, raw_size: int) -> Optional[bytes]:
    """Native bzip2 decode (clair3t_bzip2.cc; also backs CRAM method-2
    blocks and the arith codec's EXT transform in-library); None when the
    native library is unavailable (caller falls back to stdlib bz2)."""
    try:
        lib = get_lib()
    except Exception:
        return None
    if not getattr(lib, "_bzxz_bound", False):
        _bind_bzxz(lib)
    out = ctypes.create_string_buffer(max(1, raw_size))
    rc = lib.clair3t_bzip2_decode(payload, len(payload), out, raw_size)
    if rc != raw_size:
        raise ValueError(f"native bzip2 decode failed (rc={rc})")
    return out.raw[:raw_size]


def xz_decode_native(payload: bytes, raw_size: int) -> Optional[bytes]:
    """Native .xz/LZMA2 decode (clair3t_xz.cc; backs CRAM method-3
    blocks in-library); None when the native library is unavailable
    (caller falls back to stdlib lzma)."""
    try:
        lib = get_lib()
    except Exception:
        return None
    if not getattr(lib, "_bzxz_bound", False):
        _bind_bzxz(lib)
    out = ctypes.create_string_buffer(max(1, raw_size))
    rc = lib.clair3t_xz_decode(payload, len(payload), out, raw_size)
    if rc != raw_size:
        raise ValueError(f"native xz decode failed (rc={rc})")
    return out.raw[:raw_size]


def _bind_bzxz(lib) -> None:
    for fn in (lib.clair3t_bzip2_decode, lib.clair3t_xz_decode):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                       ctypes.c_char_p, ctypes.c_int64]
    lib._bzxz_bound = True


class _GvcfRows(ctypes.Structure):
    # '\n'-joined row blob: one bulk decode on the Python side instead of
    # a per-row decode (a WGS run drains millions of rows)
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_char)),
        ("len", ctypes.c_int64),
        ("n", ctypes.c_int32),
    ]


def _bind_gvcf(lib):
    if getattr(lib, "_gvcf_bound", False):
        return
    lib.clair3t_gvcf_new.restype = ctypes.c_void_p
    lib.clair3t_gvcf_new.argtypes = [ctypes.c_double, ctypes.c_int, ctypes.c_int]
    lib.clair3t_gvcf_set_contig_length.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.clair3t_gvcf_feed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64]
    lib.clair3t_gvcf_take_rows.restype = ctypes.POINTER(_GvcfRows)
    lib.clair3t_gvcf_take_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.clair3t_gvcf_rows_free.argtypes = [ctypes.POINTER(_GvcfRows)]
    lib.clair3t_gvcf_free.argtypes = [ctypes.c_void_p]
    lib._gvcf_bound = True


class NativeGvcfWriter:
    """Native counterpart of clair3_tpu_torch.gvcf.NonVariantBlockWriter —
    byte-identical rows (tests/test_native_gvcf.py), streaming across
    chunk boundaries, built for WGS-scale position counts."""

    def __init__(self, p_err: float = 0.001, gq_bin_size: int = 5,
                 bp_resolution: bool = False, contig_lengths=None):
        self._lib = get_lib()
        _bind_gvcf(self._lib)
        self._st = self._lib.clair3t_gvcf_new(p_err, gq_bin_size,
                                              int(bp_resolution))
        for name, length in (contig_lengths or {}).items():
            self._lib.clair3t_gvcf_set_contig_length(
                self._st, name.encode(), int(length))
        self.rows: List[str] = []

    def feed(self, chrom: str, start_pos1: int, ref_seq: str,
             n_ref, n_total) -> None:
        """Bulk per-position counts for [start_pos1, start_pos1 + n)."""
        n = len(ref_seq)
        ref_arr = np.ascontiguousarray(n_ref, np.int64)
        tot_arr = np.ascontiguousarray(n_total, np.int64)
        if len(ref_arr) != n or len(tot_arr) != n:
            raise ValueError("count arrays must match ref_seq length")
        self._lib.clair3t_gvcf_feed(
            self._st, chrom.encode(), start_pos1, ref_seq.encode(),
            ref_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tot_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)

    def add_site(self, chrom: str, pos: int, ref: str, n_ref: int,
                 n_total: int) -> None:
        self.feed(chrom, pos, ref,
                  np.array([n_ref], np.int64), np.array([n_total], np.int64))

    def _take(self, finish: bool) -> List[str]:
        out_p = self._lib.clair3t_gvcf_take_rows(self._st, int(finish))
        out = out_p.contents
        try:
            if out.n == 0:
                return []
            blob = ctypes.string_at(out.data, out.len)
            rows = blob.decode().split("\n")
            rows.pop()  # trailing '\n'
            return rows
        finally:
            self._lib.clair3t_gvcf_rows_free(out_p)

    def drain(self) -> List[str]:
        """Completed rows so far (streaming spill support); the open block
        stays internal until flush()/finish()."""
        out = self.rows + self._take(False)
        self.rows = []
        return out

    def flush(self) -> None:
        """Close the open block (chunk-boundary closure, matching the
        reference's per-chunk .tmp.gvcf semantics); rows surface at the
        next drain().  The writer stays usable for further feeds."""
        self.rows.extend(self._take(True))

    def finish(self) -> List[str]:
        self.rows.extend(self._take(True))
        return self.rows

    def close(self) -> None:
        if self._st is not None:
            self._lib.clair3t_gvcf_free(self._st)
            self._st = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _DbgOut(ctypes.Structure):
    _fields_ = [
        ("haps", ctypes.c_char_p),
        ("n_haps", ctypes.c_int32),
        ("error", ctypes.c_int32),
    ]


def _bind_dbg(lib):
    if getattr(lib, "_dbg_bound", False):
        return
    lib.clair3t_dbg.restype = ctypes.POINTER(_DbgOut)
    lib.clair3t_dbg.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.clair3t_dbg_free.argtypes = [ctypes.POINTER(_DbgOut)]
    lib._dbg_bound = True


def dbg_consensus_native(
    reads,
    ref_window: str,
    k_range,
    min_edge_weight: int,
    max_haplotypes: int,
) -> Optional[List[str]]:
    """Native counterpart of clair3_tpu_torch.realign.dbg.consensus_haplotypes
    (set-identical haplotypes; order may differ).  Returns None when the
    native path cannot serve the request (k > 31 exceeds 2-bit packing)."""
    lib = get_lib()
    _bind_dbg(lib)
    n = len(reads)
    read_arr = (ctypes.c_char_p * max(n, 1))(*[r.encode() for r in reads])
    ks = list(k_range)
    k_arr = (ctypes.c_int32 * max(len(ks), 1))(*ks)
    out_p = lib.clair3t_dbg(read_arr, n, ref_window.encode(),
                            k_arr, len(ks), min_edge_weight, max_haplotypes)
    out = out_p.contents
    try:
        if out.error:
            return None
        blob = out.haps.decode() if out.haps else ""
        return blob.split("\n") if blob else []
    finally:
        lib.clair3t_dbg_free(out_p)


def _bind_pack(lib) -> bool:
    """False when the loaded library predates the pack symbols (e.g. a
    CLAIR3T_TORCH_NATIVE_SO override of an older build) — callers fall back to
    the numpy packers instead of raising."""
    if getattr(lib, "_pack_bound", None) is not None:
        return lib._pack_bound
    if not hasattr(lib, "clair3t_fa_pack_sparse"):
        lib._pack_bound = False
        return False
    _i8p = ctypes.POINTER(ctypes.c_int8)
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.clair3t_fa_pack_sparse.restype = ctypes.c_int
    lib.clair3t_fa_pack_sparse.argtypes = [
        _i8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        _i8p, _u8p, _i8p, _i8p, ctypes.POINTER(ctypes.c_uint16), _i8p,
        _i8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.clair3t_fa_band.restype = None
    lib.clair3t_fa_band.argtypes = [
        _i8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.clair3t_pileup_pack.restype = ctypes.c_int
    lib.clair3t_pileup_pack.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        _u8p, _i8p]
    lib._pack_bound = True
    return True


def pack_native_available() -> bool:
    """True when the loaded library exports the wire-form pack symbols
    (False for CLAIR3T_TORCH_NATIVE_SO overrides of pre-pack builds)."""
    if not native_available():
        return False
    try:
        return _bind_pack(get_lib())
    except Exception:
        return False


def fa_band_native(matrix: np.ndarray):
    """Smallest depth-row window [lo, hi) covering every nonzero row of an
    [N, D, 33, C] int8 batch (early-exit C scan; the numpy equivalent
    reads the whole batch).  None when the native path is unavailable."""
    if (matrix.ndim != 4 or matrix.shape[2] != 33 or matrix.dtype != np.int8
            or not matrix.flags.c_contiguous):
        return None
    lib = get_lib()
    if not _bind_pack(lib):
        return None
    N, D, _, C = matrix.shape
    lo = ctypes.c_int64(0)
    hi = ctypes.c_int64(0)
    lib.clair3t_fa_band(
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), N, D, C,
        ctypes.byref(lo), ctypes.byref(hi))
    return int(lo.value), int(hi.value)


def fa_pack_sparse_native(matrix: np.ndarray, k_buckets, row_off: int = 0,
                          rows: Optional[int] = None) -> Optional[dict]:
    """Native counterpart of ops.fa_compact.pack_fa_sparse (the numpy
    packer is the differential oracle).  ``row_off``/``rows`` pack only a
    depth-row window without materializing the crop (rows outside must be
    zero — the band from fa_band_native).  Returns the packed dict with
    sidx/sval narrowed to the smallest fitting K bucket, or None on a
    structure violation / overflow (callers fall back)."""
    if (matrix.ndim != 4 or matrix.shape[2] != 33
            or matrix.shape[3] not in (8, 9) or matrix.dtype != np.int8
            or not matrix.flags.c_contiguous):
        return None
    lib = get_lib()
    if not _bind_pack(lib):
        return None
    N, full_D, _, C = matrix.shape
    D = full_D - row_off if rows is None else int(rows)
    if row_off < 0 or D <= 0 or row_off + D > full_D:
        return None
    kmax = int(k_buckets[-1])
    bq = np.empty((N, D, 33), np.int8)
    bitmask = np.empty((N, D, 5), np.uint8)
    scalars = np.empty((N, D, 4), np.int8)
    refcol = np.empty((N, 33), np.int8)
    sidx = np.empty((N, kmax), np.uint16)
    sval = np.empty((N, kmax), np.int8)
    dwell = np.empty((N, D, 33), np.int8) if C == 9 else None
    max_count = ctypes.c_int64(0)
    _i8p = ctypes.POINTER(ctypes.c_int8)
    rc = lib.clair3t_fa_pack_sparse(
        matrix.ctypes.data_as(_i8p), N, full_D, C, row_off, D,
        bq.ctypes.data_as(_i8p),
        bitmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scalars.ctypes.data_as(_i8p), refcol.ctypes.data_as(_i8p),
        sidx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        sval.ctypes.data_as(_i8p),
        dwell.ctypes.data_as(_i8p) if dwell is not None else None,
        kmax, ctypes.byref(max_count))
    if rc != 0:
        return None
    k = next((kb for kb in k_buckets if max_count.value <= kb), None)
    if k is None:
        return None
    if k < kmax:
        sidx = np.ascontiguousarray(sidx[:, :k])
        sval = np.ascontiguousarray(sval[:, :k])
    packed = {"bq": bq, "bitmask": bitmask, "scalars": scalars,
              "refcol": refcol, "sidx": sidx, "sval": sval}
    if dwell is not None:
        packed["dwell"] = dwell
    return packed


def pileup_pack_native(matrix: np.ndarray) -> Optional[dict]:
    """Native counterpart of ops.pileup_compact.pack_pileup (the numpy
    packer is the differential oracle)."""
    if (matrix.ndim != 3 or matrix.shape[1] != 33 or matrix.shape[2] != 18
            or matrix.dtype not in (np.int16, np.int32)
            or not matrix.flags.c_contiguous):
        return None
    lib = get_lib()
    if not _bind_pack(lib):
        return None
    N = matrix.shape[0]
    mags = np.empty((N, 33, 18), np.uint8)
    negidx = np.empty((N, 33), np.int8)
    rc = lib.clair3t_pileup_pack(
        matrix.ctypes.data_as(ctypes.c_void_p), N, matrix.dtype.itemsize,
        mags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        negidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if rc != 0:
        return None
    return {"mags": mags, "negidx": negidx}


_CRAM_ERRORS = {
    1: "io error",
    2: "not a CRAM file",
    3: "unsupported CRAM feature (3.1 codecs / bzip2 / lzma / exotic codec)",
    4: "corrupt CRAM stream",
    5: "records not coordinate-sorted",
    6: "reference unavailable",
}


def cram_to_bam_native(cram_path: str, ref_fn: str, out_bam: str):
    """Native CRAM 3.0 -> indexed BAM conversion (clair3t_cram.cc).

    Returns the BAM path on success, or None when the native path cannot
    serve this file (the caller should fall back to the Python converter
    in io/cram.py, which supports the full codec surface)."""
    lib = get_lib()
    if not getattr(lib, "_cram_bound", False):
        lib.clair3t_cram_to_bam.restype = ctypes.c_int
        lib.clair3t_cram_to_bam.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib._cram_bound = True
    rc = lib.clair3t_cram_to_bam(
        cram_path.encode(), (ref_fn or "").encode(), out_bam.encode())
    if rc == 0:
        return out_bam
    import sys

    print(f"[INFO] native CRAM decode unavailable "
          f"({_CRAM_ERRORS.get(rc, rc)}); using the Python converter",
          file=sys.stderr)
    return None
