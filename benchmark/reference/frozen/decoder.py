"""Genotype decoding: network head probabilities -> VCF rows.

Behavioral port of the reference decode core (clair3/CallVariants.py:375-1454:
``possible_outcome_probabilites_from`` / ``output_from`` / ``output_with`` /
``compute_PL``).  The four softmax heads are combined into ~10 outcome
families; the winner is selected by argmax with a *fallback loop* — if the
winning outcome cannot be materialized from the observed read evidence
(alt-info), its probability is zeroed and the next-best is tried.  Actual
indel bases are recovered from the alt-info read evidence.

This runs on host CPU (a process pool in the pipeline); it is deliberately
plain Python operating on numpy rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.frozen.config import LABEL_CUM
from benchmark.reference.frozen.task.labels import (
    GT21,
    HETERO_SNP_GT21,
    HETERO_SNP_LABELS,
    HOMO_SNP_GT21,
    HOMO_SNP_LABELS,
    Genotype,
    VariantLength,
    genotype_enum_for_task,
    genotype_enum_from,
    genotype_string_from,
    gt21_enum_from_label,
    mix_two_partial_labels,
    partial_label_from,
)
from benchmark.reference.frozen.utils.common import IUPAC_TO_ACGT, convert_iupac_to_n

ACGT = "ACGT"
_PHRED = -10 * math.log10(math.e)
_VL_OFF = VariantLength.index_offset
_VL_MAX = VariantLength.max


@dataclass
class DecodeConfig:
    add_indel_length: bool = False
    pileup: bool = True
    show_ref_calls: bool = False
    gvcf: bool = False
    quality_score_for_pass: Optional[float] = None
    haploid_precise: bool = False
    haploid_sensitive: bool = False
    enable_long_indel: bool = False
    maximum_variant_length_that_need_infer: int = 50
    keep_iupac_bases: bool = False
    # long-indel flanking aggregation (CallVariants.py:384-403)
    cal_precise_long_indel_af: bool = False
    long_indel_distance_proportion: float = 0.1
    max_variant_length_infer_default: int = 50
    # debug mode prints each candidate's raw head probabilities instead of
    # emitting its VCF row (reference: CallVariants.py:259-277,1342-1351)
    debug: bool = False


def quality_score_from(probability: float) -> float:
    """QUAL = max(-10*log10(e) * ln((1-p)/p) + 10, 0) (CallVariants.py:375-381)."""
    p = float(probability)
    tmp = max(_PHRED * math.log(((1.0 - p) + 1e-10) / (p + 1e-10)) + 10, 0)
    return float(round(tmp, 2))


def _filtration_value(quality_score_for_pass, quality_score, is_reference=False) -> str:
    if is_reference:
        return "RefCall"
    if quality_score_for_pass is None or quality_score >= quality_score_for_pass:
        return "PASS"
    return "LowQual"


# ---------------------------------------------------------------------------
# alt-info parsing and indel base recovery
# ---------------------------------------------------------------------------

def parse_alt_info(alt_info: str) -> Tuple[int, Dict[str, int]]:
    """'depth-Xa n Ic.. n Dc.. n Rr n ' -> (read_depth, {key: count})."""
    parts = alt_info.rstrip().split("-")
    read_depth = int(parts[0])
    indel_str = parts[1] if len(parts) > 1 else ""
    seqs = indel_str.split(" ")
    alt_dict: Dict[str, int] = {}
    if seqs and seqs[0]:
        alt_dict = dict(zip(seqs[::2], (int(v) for v in seqs[1::2])))
    return read_depth, alt_dict


def insertion_bases_from(
    alt_info_dict: Dict[str, int],
    propose_insertion_length: Optional[int] = None,
    minimum_insertion_length: int = 1,
    maximum_insertion_length: int = 50,
    insertion_bases_to_ignore: str = "",
    return_multi: bool = False,
):
    """Most-supported insertion allele (anchor base included) from alt-info
    (CallVariants.py:117-156)."""
    if propose_insertion_length:
        propose_insertion_length += 1  # include the anchor reference base
    if not alt_info_dict:
        return [] if return_multi else ""
    bases: Dict[str, int] = {}
    proposed: Dict[str, int] = {}
    for raw_key, count in alt_info_dict.items():
        if raw_key[0] != "I":
            continue
        key = raw_key[1:]
        if propose_insertion_length and len(key) == propose_insertion_length and key != insertion_bases_to_ignore:
            proposed[key] = count
        elif minimum_insertion_length <= len(key) <= maximum_insertion_length and key != insertion_bases_to_ignore:
            bases[key] = count
    if propose_insertion_length and proposed:
        return max(proposed, key=proposed.get)
    if return_multi:
        ordered = [k for k, _ in sorted(bases.items(), key=lambda x: x[1])[::-1]]
        return ordered[:2] if ordered else ""
    return max(bases, key=bases.get) if bases else ""


def deletion_bases_from(
    alt_info_dict: Dict[str, int],
    propose_deletion_length: Optional[int] = None,
    minimum_deletion_length: int = 1,
    maximum_deletion_length: int = 50,
    deletion_bases_to_ignore: str = "",
    return_multi: bool = False,
):
    """Most-supported deleted bases from alt-info (CallVariants.py:159-201)."""
    if not alt_info_dict:
        return [] if return_multi else ""
    bases: Dict[str, int] = {}
    proposed: Dict[str, int] = {}
    for raw_key, count in alt_info_dict.items():
        if raw_key[0] != "D":
            continue
        key = raw_key[1:]
        if propose_deletion_length and len(key) == propose_deletion_length and key != deletion_bases_to_ignore:
            proposed[key] = count
        elif minimum_deletion_length <= len(key) <= maximum_deletion_length and key != deletion_bases_to_ignore:
            bases[key] = count
    if propose_deletion_length and proposed:
        return max(proposed, key=proposed.get)
    if return_multi:
        ordered = [k for k, _ in sorted(bases.items(), key=lambda x: x[1])[::-1]]
        if len(ordered) <= 1:
            return ""
        return [ordered[0], ordered[1]] if len(ordered[0]) > len(ordered[1]) else [ordered[1], ordered[0]]
    return max(bases, key=bases.get) if bases else ""


def find_alt_base(alt_info_dict: Dict[str, int], alternate_base: Optional[str] = None):
    """Double-check the SNP alt base against read evidence; switch to the
    most-supported base when the proposed one is absent or trails by >= 9
    reads (CallVariants.py:662-673)."""
    max_depth_gap = 9
    sorted_alt = sorted(
        ((k[1], c) for k, c in alt_info_dict.items() if k[0] == "X"),
        key=lambda x: x[1], reverse=True,
    )
    alt_count = [c for b, c in sorted_alt if b == alternate_base]
    if not sorted_alt:
        return [], None
    if not alt_count or sorted_alt[0][1] - alt_count[0] >= max_depth_gap:
        alternate_base = sorted_alt[0][0]
    return [b for b, _ in sorted_alt], alternate_base


def get_long_indel_read_count(
    alt_info: Dict[str, int],
    config: DecodeConfig,
    proposed_ins_base: str = "",
    propose_del_base_length: int = 0,
    is_del: bool = False,
) -> int:
    """Aggregate flanking indel signals within +-10% length of a proposed
    long indel (CallVariants.py:384-403)."""
    count = 0
    max_infer = config.max_variant_length_infer_default
    if not config.cal_precise_long_indel_af and (
        len(proposed_ins_base) > max_infer or propose_del_base_length > max_infer
    ):
        length = propose_del_base_length if is_del else len(proposed_ins_base) - 1
        lo = max(length * (1.0 - config.long_indel_distance_proportion), max_infer)
        hi = length * (1.0 + config.long_indel_distance_proportion)
        for alt_base, c in alt_info.items():
            if is_del and len(alt_base) == propose_del_base_length:
                continue
            if alt_base == proposed_ins_base:
                continue
            if lo <= len(alt_base) <= hi:
                count += c
    return count


# ---------------------------------------------------------------------------
# outcome probability enumeration (CallVariants.py:303-372, 510-659)
# ---------------------------------------------------------------------------

_HOMO_LENGTHS = list(range(1, _VL_MAX + 1))
_INSINS_PAIRS = [(i, j) for i in range(1, _VL_MAX + 1) for j in range(i, _VL_MAX + 1)]
_INSINS_I = np.array([i - 1 for i, _ in _INSINS_PAIRS])
_INSINS_J = np.array([j - 1 for _, j in _INSINS_PAIRS])
_DELDEL_PAIRS_RAW = [
    (i, j) for i in range(1, _VL_MAX + 1) for j in range(1, _VL_MAX + 1)
    if not (i == j and i != _VL_OFF and j != _VL_OFF)
]
_DELDEL_PAIRS = [(i, j) if i < j else (j, i) for i, j in _DELDEL_PAIRS_RAW]
_DELDEL_I = np.array([i - 1 for i, _ in _DELDEL_PAIRS_RAW])
_DELDEL_J = np.array([j - 1 for _, j in _DELDEL_PAIRS_RAW])
_INSDEL_PAIRS = [(i, j) for i in range(1, _VL_MAX + 1) for j in range(1, _VL_MAX + 1)]
_ACGT_LEN_BASES = [b for _ in _HOMO_LENGTHS for b in ACGT]          # length-major
_ACGT_LEN_LENGTHS = [l for l in _HOMO_LENGTHS for _ in ACGT]
_INS_GT21_IDX = np.array([GT21.AIns, GT21.CIns, GT21.GIns, GT21.TIns])
_DEL_GT21_IDX = np.array([GT21.ADel, GT21.CDel, GT21.GDel, GT21.TDel])


class _Outcomes:
    """Mutable outcome-family probability lists for the fallback loop."""

    __slots__ = (
        "homo_ref", "homo_snp", "hetero_snp",
        "homo_ins_lengths", "homo_ins",
        "het_insins_lengths", "het_insins",
        "het_acgt_ins_bases", "het_acgt_ins_lengths", "het_acgt_ins",
        "homo_del_lengths", "homo_del",
        "het_deldel_lengths", "het_deldel",
        "het_acgt_del_bases", "het_acgt_del_lengths", "het_acgt_del",
        "het_insdel_lengths", "het_insdel",
        "ref_only",
    )


def enumerate_outcomes(gt21, genotype, vl1, vl2, reference_base, add_indel_length) -> _Outcomes:
    o = _Outcomes()
    o.ref_only = False
    p_ref = genotype[Genotype.homo_reference]
    p_hom = genotype[Genotype.homo_variant]
    p_het = genotype[Genotype.hetero_variant]
    ref_gt21 = gt21_enum_from_label(reference_base + reference_base)

    if not add_indel_length:
        o.homo_ref = p_ref * gt21[ref_gt21]
        if p_ref >= 0.5 and gt21[ref_gt21] >= 0.5:
            o.ref_only = True
            return o
        gt21 = np.asarray(gt21)
        o.homo_snp = np.array([p_hom * gt21[g] for g in HOMO_SNP_GT21])
        o.hetero_snp = np.array([p_het * gt21[g] for g in HETERO_SNP_GT21])
        o.homo_ins = np.array([p_hom * gt21[GT21.InsIns]])
        o.homo_ins_lengths = []
        o.het_insins = np.array([p_het * gt21[GT21.InsIns]])
        o.het_insins_lengths = []
        o.het_acgt_ins = gt21[_INS_GT21_IDX] * p_het
        o.het_acgt_ins_bases, o.het_acgt_ins_lengths = [], []
        o.homo_del = np.array([p_hom * gt21[GT21.DelDel]])
        o.homo_del_lengths = []
        o.het_deldel = np.array([p_het * gt21[GT21.DelDel]])
        o.het_deldel_lengths = []
        o.het_acgt_del = gt21[_DEL_GT21_IDX] * p_het
        o.het_acgt_del_bases, o.het_acgt_del_lengths = [], []
        o.het_insdel = np.array([p_het * gt21[GT21.InsDel]])
        o.het_insdel_lengths = []
        return o

    vl0_1 = vl1[0 + _VL_OFF]
    vl0_2 = vl2[0 + _VL_OFF]
    vl0 = vl0_1 * vl0_2
    o.homo_ref = vl0 * p_ref * gt21[ref_gt21]
    if vl0_1 >= 0.5 and vl0_2 >= 0.5 and p_ref >= 0.5 and gt21[ref_gt21] >= 0.5:
        o.ref_only = True
        return o
    o.homo_snp = np.array([vl0 * p_hom * gt21[g] for g in HOMO_SNP_GT21])
    o.hetero_snp = np.array([vl0 * p_het * gt21[g] for g in HETERO_SNP_GT21])

    # vectorized outcome-family values over static index maps (hot path:
    # the reference builds ~1k-element Python lists per candidate here)
    gt21 = np.asarray(gt21)
    v1p = np.asarray(vl1[_VL_OFF + 1:])       # insertion lengths +1..+16
    v2p = np.asarray(vl2[_VL_OFF + 1:])
    v1n = np.asarray(vl1[_VL_OFF - 1::-1])    # deletion lengths -1..-16
    v2n = np.asarray(vl2[_VL_OFF - 1::-1])

    o.homo_ins_lengths = _HOMO_LENGTHS
    o.homo_ins = v1p * v2p * (p_hom * gt21[GT21.InsIns])
    o.het_insins_lengths = _INSINS_PAIRS
    o.het_insins = v1p[_INSINS_I] * v2p[_INSINS_J] * (p_het * gt21[GT21.InsIns])
    o.het_acgt_ins_bases = _ACGT_LEN_BASES
    o.het_acgt_ins_lengths = _ACGT_LEN_LENGTHS
    het_ins_len = vl1[_VL_OFF] * v2p                        # (16,)
    # grouping matches the reference exactly — ((len_p * gt21) * p_het),
    # CallVariants.py:600-607 — so ULP-level float equality decisions in
    # the fallback loop agree bit-for-bit
    o.het_acgt_ins = ((het_ins_len[:, None] * gt21[_INS_GT21_IDX][None, :]) * p_het).ravel()

    o.homo_del_lengths = _HOMO_LENGTHS
    o.homo_del = v1n * v2n * (p_hom * gt21[GT21.DelDel])
    o.het_deldel_lengths = _DELDEL_PAIRS
    o.het_deldel = v1n[_DELDEL_I] * v2n[_DELDEL_J] * (p_het * gt21[GT21.DelDel])
    o.het_acgt_del_bases = _ACGT_LEN_BASES
    o.het_acgt_del_lengths = _ACGT_LEN_LENGTHS
    het_del_len = v1n * vl2[_VL_OFF]
    o.het_acgt_del = ((het_del_len[:, None] * gt21[_DEL_GT21_IDX][None, :]) * p_het).ravel()

    o.het_insdel_lengths = _INSDEL_PAIRS
    o.het_insdel = (v1n[:, None] * v2p[None, :]).ravel() * (p_het * gt21[GT21.InsDel])
    return o


# ---------------------------------------------------------------------------
# outcome selection with evidence fallback (CallVariants.py:676-1012)
# ---------------------------------------------------------------------------

_REF_FLAGS = (True, False, False, False, False, False, False, False, False, False)


def select_output(
    reference_sequence: str,
    tensor_position_center: int,
    gt21: Sequence[float],
    genotype: Sequence[float],
    vl1: Sequence[float],
    vl2: Sequence[float],
    alt_info_dict: Dict[str, int],
    config: DecodeConfig,
):
    """Returns (flags_tuple, (reference_base, alternate_base), probability)."""
    add_indel_length = config.add_indel_length
    center_base = reference_sequence[tensor_position_center]
    reference_base_acgt = IUPAC_TO_ACGT[center_base]
    o = enumerate_outcomes(gt21, genotype, vl1, vl2, reference_base_acgt, add_indel_length)
    if o.ref_only:
        return _REF_FLAGS, (reference_base_acgt, reference_base_acgt), o.homo_ref

    max_infer = config.maximum_variant_length_that_need_infer
    reference_base = None
    alternate_base = None
    flags = None
    maximum_probability = 0.0

    # NOTE the reference quirk this loop preserves exactly
    # (CallVariants.py:722-1012): reference_base/alternate_base are loop
    # state that is NEVER reset — a failure `continue` that happens AFTER a
    # branch assigned both variables terminates the loop with that partial
    # (e.g. single-alt) result, because the while condition sees them set.
    while reference_base is None or alternate_base is None:
        fam_max = {
            name: (float(arr.max()) if arr.size else 0.0)
            for name, arr in (
                ("homo_snp", o.homo_snp), ("hetero_snp", o.hetero_snp),
                ("homo_ins", o.homo_ins), ("homo_del", o.homo_del),
                ("het_acgt_ins", o.het_acgt_ins), ("het_insins", o.het_insins),
                ("het_acgt_del", o.het_acgt_del), ("het_deldel", o.het_deldel),
                ("het_insdel", o.het_insdel),
            )
        }
        maximum_probability = max(o.homo_ref, *fam_max.values())

        if maximum_probability == o.homo_ref:
            return _REF_FLAGS, (reference_base_acgt, reference_base_acgt), maximum_probability

        is_homo_SNP = maximum_probability == fam_max["homo_snp"]
        is_hetero_SNP = maximum_probability == fam_max["hetero_snp"]
        is_homo_insertion = maximum_probability == fam_max["homo_ins"]
        is_hetero_ACGT_Ins = maximum_probability == fam_max["het_acgt_ins"]
        is_hetero_InsIns = maximum_probability == fam_max["het_insins"]
        is_homo_deletion = maximum_probability == fam_max["homo_del"]
        is_hetero_ACGT_Del = maximum_probability == fam_max["het_acgt_del"]
        is_hetero_DelDel = maximum_probability == fam_max["het_deldel"]
        is_insertion_and_deletion = maximum_probability == fam_max["het_insdel"]
        flags = (
            False, is_homo_SNP, is_hetero_SNP,
            is_homo_insertion, is_hetero_ACGT_Ins, is_hetero_InsIns,
            is_homo_deletion, is_hetero_ACGT_Del, is_hetero_DelDel,
            is_insertion_and_deletion,
        )

        if is_homo_SNP:
            idx = int(np.argmax(o.homo_snp))
            reference_base = reference_sequence[tensor_position_center]
            bases = HOMO_SNP_LABELS[int(np.argmax(o.homo_snp))]
            alternate_base = bases[0] if bases[0] != reference_base else bases[1]
            _, alternate_base = find_alt_base(alt_info_dict, alternate_base)
            if alternate_base is None or alternate_base == reference_base:
                o.homo_snp[idx] = 0
                continue

        elif is_hetero_SNP:
            idx = int(np.argmax(o.hetero_snp))
            bases = HETERO_SNP_LABELS[int(np.argmax(o.hetero_snp))]
            base1, base2 = bases[0], bases[1]
            reference_base = reference_sequence[tensor_position_center]
            if base1 != reference_base and base2 != reference_base:
                sorted_bases, _ = find_alt_base(alt_info_dict)
                if len(sorted_bases) < 2:
                    o.hetero_snp[idx] = 0
                    continue
                alternate_base = ",".join(sorted_bases[:2])
            else:
                alternate_base = base1 if base1 != reference_base else base2
                _, alternate_base = find_alt_base(alt_info_dict, alternate_base)
                if alternate_base is None or alternate_base == reference_base:
                    o.hetero_snp[idx] = 0
                    continue

        elif is_homo_insertion:
            idx = int(np.argmax(o.homo_ins))
            variant_length = o.homo_ins_lengths[idx] if add_indel_length else None
            insertion_bases = insertion_bases_from(
                alt_info_dict,
                propose_insertion_length=(
                    variant_length if variant_length and variant_length < _VL_MAX else None),
                maximum_insertion_length=max_infer,
            )
            if len(insertion_bases) == 0:
                o.homo_ins[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center]
            alternate_base = insertion_bases

        elif is_hetero_ACGT_Ins:
            idx = int(np.argmax(o.het_acgt_ins))
            if add_indel_length:
                hetero_ins_base = o.het_acgt_ins_bases[idx]
                variant_length = o.het_acgt_ins_lengths[idx]
            else:
                hetero_ins_base = ACGT[idx]
                variant_length = None
            insertion_bases = insertion_bases_from(
                alt_info_dict,
                propose_insertion_length=(
                    variant_length if variant_length and variant_length < _VL_MAX else None),
                maximum_insertion_length=max_infer,
            )
            if len(insertion_bases) == 0:
                o.het_acgt_ins[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center]
            alternate_base = insertion_bases
            if hetero_ins_base != reference_base:
                sorted_bases, _ = find_alt_base(alt_info_dict)
                if len(sorted_bases) == 0:
                    # quirk: ref/alt already assigned -> the loop exits with
                    # the single-insertion result
                    o.het_acgt_ins[idx] = 0
                    continue
                alternate_base = f"{sorted_bases[0]},{alternate_base}"

        elif is_hetero_InsIns:
            idx = int(np.argmax(o.het_insins))
            insertion_bases_list: List[str] = []
            if add_indel_length:
                vlen1, vlen2 = o.het_insins_lengths[idx]
                bases1 = insertion_bases_from(
                    alt_info_dict,
                    propose_insertion_length=(vlen1 if vlen1 and vlen1 < _VL_MAX else None),
                    maximum_insertion_length=max_infer,
                )
                if len(bases1):
                    bases2 = insertion_bases_from(
                        alt_info_dict,
                        propose_insertion_length=(vlen2 if vlen2 and vlen2 < _VL_MAX else None),
                        insertion_bases_to_ignore=bases1,
                        maximum_insertion_length=max_infer,
                    )
                    if len(bases2):
                        insertion_bases_list = [bases1, bases2]
                if len(insertion_bases_list) < 2:
                    insertion_bases_list = insertion_bases_from(
                        alt_info_dict, return_multi=True,
                        maximum_insertion_length=max_infer,
                    )
            else:
                insertion_bases_list = insertion_bases_from(
                    alt_info_dict, return_multi=True,
                    maximum_insertion_length=max_infer,
                )
            if len(insertion_bases_list) < 2:
                o.het_insins[idx] = 0
                continue
            insertion_bases, another_insertion_bases = insertion_bases_list
            reference_base = reference_sequence[tensor_position_center]
            alternate_base = insertion_bases
            alternate_base_1 = another_insertion_bases
            alternate_base_2 = alternate_base
            if alternate_base_1 != alternate_base_2:
                alternate_base = f"{alternate_base_1},{alternate_base_2}"
            else:
                # quirk: alternate_base stays the single insertion -> exit
                o.het_insins[idx] = 0
                continue

        elif is_homo_deletion:
            idx = int(np.argmax(o.homo_del))
            variant_length = o.homo_del_lengths[idx] if add_indel_length else None
            deletion_bases = deletion_bases_from(
                alt_info_dict,
                propose_deletion_length=(
                    variant_length if variant_length and variant_length < _VL_MAX else None),
                maximum_deletion_length=max_infer,
            )
            if len(deletion_bases) == 0:
                o.homo_del[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = reference_base[0]

        elif is_hetero_ACGT_Del:
            idx = int(np.argmax(o.het_acgt_del))
            if add_indel_length:
                variant_length = o.het_acgt_del_lengths[idx]
                hetero_del_base = o.het_acgt_del_bases[idx]
            else:
                variant_length = None
                hetero_del_base = ACGT[idx]
            deletion_bases = deletion_bases_from(
                alt_info_dict,
                propose_deletion_length=(
                    variant_length if variant_length and variant_length < _VL_MAX else None),
                maximum_deletion_length=max_infer,
            )
            if len(deletion_bases) == 0:
                o.het_acgt_del[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = reference_base[0]
            if hetero_del_base != reference_base[0]:
                alternate_base = f"{alternate_base},{hetero_del_base + reference_base[1:]}"

        elif is_hetero_DelDel:
            idx = int(np.argmax(o.het_deldel))
            deletion_bases_list: List[str] = []
            if add_indel_length:
                vlen1, vlen2 = sorted(o.het_deldel_lengths[idx], reverse=True)
                bases1 = deletion_bases_from(
                    alt_info_dict,
                    propose_deletion_length=(vlen1 if vlen1 and vlen1 < _VL_MAX else None),
                    maximum_deletion_length=max_infer,
                )
                if len(bases1) > 0:
                    bases2 = deletion_bases_from(
                        alt_info_dict,
                        propose_deletion_length=(vlen2 if vlen2 and vlen2 < _VL_MAX else None),
                        deletion_bases_to_ignore=bases1,
                        maximum_deletion_length=max_infer,
                    )
                    if len(bases2) > 0:
                        deletion_bases_list = (
                            [bases1, bases2] if len(bases1) > len(bases2) else [bases2, bases1]
                        )
                if len(deletion_bases_list) < 2:
                    deletion_bases_list = deletion_bases_from(
                        alt_info_dict, return_multi=True,
                        maximum_deletion_length=max_infer,
                    )
            else:
                deletion_bases_list = deletion_bases_from(
                    alt_info_dict, return_multi=True,
                    maximum_deletion_length=max_infer,
                )
            if len(deletion_bases_list) < 2:
                o.het_deldel[idx] = 0
                continue
            deletion_bases, deletion_bases1 = deletion_bases_list
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = reference_base[0]
            alternate_base_1 = alternate_base
            alternate_base_2 = reference_base[0] + reference_base[len(deletion_bases1) + 1:]
            if (
                alternate_base_1 != alternate_base_2
                and reference_base != alternate_base_1
                and reference_base != alternate_base_2
            ):
                alternate_base = f"{alternate_base_1},{alternate_base_2}"
            else:
                # quirk: alternate_base stays reference_base[0] -> exit
                o.het_deldel[idx] = 0
                continue

        elif is_insertion_and_deletion:
            idx = int(np.argmax(o.het_insdel))
            if add_indel_length:
                vlen1, vlen2 = o.het_insdel_lengths[idx]
            else:
                vlen1 = vlen2 = None
            insertion_bases = insertion_bases_from(
                alt_info_dict,
                propose_insertion_length=(vlen2 if vlen2 and vlen2 < _VL_MAX else None),
                maximum_insertion_length=max_infer,
            )
            deletion_bases = deletion_bases_from(
                alt_info_dict,
                propose_deletion_length=(vlen1 if vlen1 and vlen1 < _VL_MAX else None),
                maximum_deletion_length=max_infer,
            )
            if len(insertion_bases) == 0 or len(deletion_bases) == 0:
                o.het_insdel[idx] = 0
                continue
            reference_base = reference_sequence[tensor_position_center] + deletion_bases
            alternate_base = f"{reference_base[0]},{insertion_bases + reference_base[1:]}"

    return flags, (reference_base, alternate_base), maximum_probability


# ---------------------------------------------------------------------------
# PL and row assembly (CallVariants.py:1118-1454)
# ---------------------------------------------------------------------------

def compute_pl(genotype_string, genotype_probs, gt21_probs, reference_base, alternate_base) -> List[int]:
    alt_array = str(alternate_base).split(",")
    alt_num = len(alt_array)
    genotypes = {1: [[0, 0], [0, 1], [1, 1]],
                 2: [[0, 0], [0, 1], [1, 1], [0, 2], [1, 2], [2, 2]]}
    reference_base = IUPAC_TO_ACGT[reference_base] if len(reference_base) == 1 else reference_base
    all_base = [reference_base] + alt_array
    likelihoods = []
    for g1, g2 in genotypes[alt_num]:
        partial_1 = partial_label_from(reference_base, all_base[g1])
        partial_2 = partial_label_from(reference_base, all_base[g2])
        label = mix_two_partial_labels(partial_1, partial_2)
        try:
            gt21_idx = gt21_enum_from_label(label)
        except KeyError:
            if alternate_base == ".":
                return [990]
            return [990] * len(genotypes[alt_num])
        zygosity = genotype_enum_for_task(genotype_enum_from(g1, g2))
        likelihoods.append(float(gt21_probs[gt21_idx]) * float(genotype_probs[zygosity]))
    sum_p = sum(likelihoods)
    likelihoods = [x / sum_p + 1e-8 for x in likelihoods]
    pls = [-10 * math.log10(x) for x in likelihoods]
    min_pl = min(pls)
    return [int(math.ceil(x - min_pl)) for x in pls]


def _decode_alt_types(alt_info_dict: Dict[str, int]):
    """Split alt-info into (SNP, Ins, Del) maps + ref support count."""
    alt_type_list: List[Dict[str, int]] = [{}, {}, {}]
    ref_count = 0
    for alt_type, count in alt_info_dict.items():
        count = int(count)
        if alt_type[0] == "X":
            alt_type_list[0][alt_type[1]] = count
        elif alt_type[0] == "I":
            alt_type_list[1][alt_type[1:]] = count
        elif alt_type[0] == "D":
            alt_type_list[2][alt_type[1:]] = count
        elif alt_type[0] == "R":
            ref_count = count
    return alt_type_list, max(0, ref_count)


def decode_candidate(
    position_info: str,
    alt_info,
    probabilities: Sequence[float],
    config: DecodeConfig,
) -> Optional[str]:
    """One candidate -> one VCF row string (with trailing newline), or None
    when the call is suppressed (hidden ref call / haploid filtering)."""
    if isinstance(alt_info, (bytes, np.bytes_)):
        alt_info = alt_info.decode()
    info_list = position_info.rstrip().split(":")
    if len(info_list) == 3:
        chromosome, position, reference_sequence = info_list
    else:
        position = info_list[-2]
        reference_sequence = info_list[-1]
        chromosome = ":".join(info_list[:-2])
    position = int(position)
    tensor_position_center = 16 if len(reference_sequence) > 1 else 0
    information_string = "P" if config.pileup else "F"

    read_depth, alt_info_dict = parse_alt_info(alt_info)

    probabilities = np.asarray(probabilities, dtype=np.float64)
    gt21_probs = probabilities[: LABEL_CUM[0]]
    genotype_probs = probabilities[LABEL_CUM[0]: LABEL_CUM[1]]
    if config.add_indel_length:
        vl1 = probabilities[LABEL_CUM[1]: LABEL_CUM[2]]
        vl2 = probabilities[LABEL_CUM[2]: LABEL_CUM[3]]
    else:
        vl1 = vl2 = np.zeros(33)

    flags, (reference_base, alternate_base), maximum_probability = select_output(
        reference_sequence, tensor_position_center,
        gt21_probs, genotype_probs, vl1, vl2, alt_info_dict, config,
    )
    (
        is_reference, is_homo_SNP, is_hetero_SNP,
        is_homo_insertion, is_hetero_ACGT_Ins, is_hetero_InsIns,
        is_homo_deletion, is_hetero_ACGT_Del, is_hetero_DelDel,
        is_insertion_and_deletion,
    ) = flags

    if not config.debug and (
        (not config.show_ref_calls and is_reference)
        or (not is_reference and reference_base == alternate_base)
    ):
        return None
    if reference_base is None or alternate_base is None:
        return None

    is_multi = "," in str(alternate_base)

    # haploid filters precede the debug print (reference order:
    # CallVariants.py:1191-1199,1328-1329 return before the :1342 print,
    # so filtered candidates produce no debug line)
    if config.haploid_precise and (
        is_hetero_SNP or is_hetero_ACGT_Ins or is_hetero_InsIns
        or is_hetero_ACGT_Del or is_hetero_DelDel or is_insertion_and_deletion
    ):
        return None
    if config.haploid_sensitive and is_multi:
        return None

    if config.debug:
        # print the raw head probabilities INSTEAD of the VCF row, ref-call
        # hiding bypassed (reference format/order:
        # CallVariants.py:1180-1184,1342-1351 + print_debug_message:259-277)
        print("{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
            chromosome, position,
            ["{:0.8f}".format(x) for x in gt21_probs],
            ["{:0.8f}".format(x) for x in genotype_probs],
            ["{:0.8f}".format(x) for x in vl1],
            ["{:0.8f}".format(x) for x in vl2],
            "Normal output" if not is_reference else "Reference"))
        return None

    if is_reference:
        genotype_string = genotype_string_from(Genotype.homo_reference)
    elif is_homo_SNP or is_homo_insertion or is_homo_deletion:
        genotype_string = genotype_string_from(Genotype.homo_variant)
    elif (is_hetero_SNP or is_hetero_ACGT_Ins or is_hetero_InsIns
          or is_hetero_ACGT_Del or is_hetero_DelDel):
        genotype_string = genotype_string_from(Genotype.hetero_variant)
    else:
        genotype_string = genotype_string_from(Genotype.hetero_variant)
    if is_multi:
        genotype_string = genotype_string_from(Genotype.hetero_variant_multi)

    alt_type_list, ref_count = _decode_alt_types(alt_info_dict)
    supported_reads_count = 0
    alt_list_count: List[int] = []

    if is_reference:
        supported_reads_count = ref_count
        alternate_base = "."
    elif is_homo_SNP or is_hetero_SNP:
        for base in str(alternate_base):
            if base == ",":
                continue
            read_count = alt_type_list[0].get(base, 0)
            supported_reads_count += read_count
            alt_list_count.append(read_count)
    elif is_homo_insertion or is_hetero_InsIns:
        for ins_bases in alternate_base.split(","):
            long_ins = get_long_indel_read_count(
                alt_type_list[1], config, proposed_ins_base=ins_bases,
            ) if config.enable_long_indel else 0
            n = alt_type_list[1].get(ins_bases, 0) + long_ins
            supported_reads_count += n
            alt_list_count.append(n)
    elif is_hetero_ACGT_Ins:
        snp_base = alternate_base.split(",")[0][0] if is_multi else None
        ins_bases = alternate_base.split(",")[1] if is_multi else alternate_base
        supported_reads_for_snp = alt_type_list[0].get(snp_base, 0) if is_multi else 0
        long_ins = get_long_indel_read_count(
            alt_type_list[1], config, proposed_ins_base=ins_bases,
        ) if config.enable_long_indel else 0
        supported_reads_for_ins = alt_type_list[1].get(ins_bases, 0) + long_ins
        supported_reads_count = supported_reads_for_ins + supported_reads_for_snp
        if snp_base:
            alt_list_count.append(supported_reads_for_snp)
        alt_list_count.append(supported_reads_for_ins)
    elif is_homo_deletion or is_hetero_DelDel:
        if len(alt_type_list[2]) > 0:
            if is_homo_deletion:
                del_bases = reference_base[1:] if len(reference_base) > 1 else None
                long_del = get_long_indel_read_count(
                    alt_type_list[2], config,
                    propose_del_base_length=len(del_bases), is_del=True,
                ) if config.enable_long_indel else 0
                supported_reads_count = alt_type_list[2].get(del_bases, 0) + long_del
                alt_list_count.append(supported_reads_count)
            elif is_hetero_DelDel and len(alt_type_list[2]) > 1:
                for _bases in alternate_base.split(","):
                    _alt_len = len(reference_base) - len(_bases)
                    _tmp = [alt_type_list[2][k] for k in alt_type_list[2] if len(k) == _alt_len]
                    long_del = get_long_indel_read_count(
                        alt_type_list[2], config,
                        propose_del_base_length=_alt_len, is_del=True,
                    ) if config.enable_long_indel else 0
                    n = (_tmp[0] if _tmp else 0) + long_del
                    alt_list_count.append(n)
                    supported_reads_count += n
    elif is_hetero_ACGT_Del:
        alt_list = alternate_base.split(",")
        is_snp_del_multi = is_multi and len(alt_list) > 0
        snp_base = (alt_list[1][0] if len(alt_list) > 1 else None) if is_snp_del_multi else None
        supported_reads_for_snp = alt_type_list[0].get(snp_base, 0) if is_snp_del_multi else 0
        del_bases = reference_base[1:] if len(reference_base) > 1 else None
        long_del = get_long_indel_read_count(
            alt_type_list[2], config,
            propose_del_base_length=len(del_bases) if del_bases else 0, is_del=True,
        ) if config.enable_long_indel else 0
        supported_reads_for_del = alt_type_list[2].get(del_bases, 0) + long_del
        supported_reads_count = supported_reads_for_del + supported_reads_for_snp
        if snp_base:
            alt_list_count.append(supported_reads_for_snp)
        alt_list_count.append(supported_reads_for_del)
    elif is_insertion_and_deletion:
        for _bases in alternate_base.split(","):
            _alt_len = len(reference_base) - len(_bases)
            if _alt_len < 0:  # ins allele
                ins_bases = _bases[: -(len(reference_base) - 1)] if len(reference_base) > 1 else _bases
                long_ins = get_long_indel_read_count(
                    alt_type_list[1], config, proposed_ins_base=ins_bases,
                ) if config.enable_long_indel else 0
                n = alt_type_list[1].get(ins_bases, 0) + long_ins
            else:  # del allele
                _tmp = [alt_type_list[2][k] for k in alt_type_list[2] if len(k) == _alt_len]
                long_del = get_long_indel_read_count(
                    alt_type_list[2], config,
                    propose_del_base_length=_alt_len, is_del=True,
                ) if config.enable_long_indel else 0
                n = (_tmp[0] if _tmp else 0) + long_del
            alt_list_count.append(n)
            supported_reads_count += n

    allele_frequency = (supported_reads_count / read_depth) if read_depth != 0 else 0.0
    allele_frequency = min(allele_frequency, 1)

    quality_score = quality_score_from(maximum_probability)

    if config.haploid_precise or config.haploid_sensitive:
        genotype_string = "1" if "1" in genotype_string else "0"

    filtration_value = _filtration_value(
        config.quality_score_for_pass, quality_score, is_reference)

    if not config.keep_iupac_bases:
        reference_base = convert_iupac_to_n(reference_base)
        alternate_base = convert_iupac_to_n(alternate_base)

    ad_alt = "," + ",".join(str(x) for x in alt_list_count)
    allele_depth = str(ref_count) + (ad_alt if alt_list_count else "")
    if len(alt_list_count) <= 1:
        allele_frequency_s = "%.4f" % allele_frequency
    else:
        allele_frequency_s = ",".join(
            "%.4f" % min(1.0, x / read_depth) for x in alt_list_count)

    if config.gvcf:
        pls = compute_pl(genotype_string, genotype_probs, gt21_probs,
                         reference_base, alternate_base)
        pl_str = ",".join(str(x) for x in pls)
        return "%s\t%d\t.\t%s\t%s\t%.2f\t%s\t%s\tGT:GQ:DP:AD:AF:PL\t%s:%d:%d:%s:%s:%s\n" % (
            chromosome, position, reference_base, alternate_base, quality_score,
            filtration_value, information_string, genotype_string,
            quality_score, read_depth, allele_depth, allele_frequency_s, pl_str,
        )
    return "%s\t%d\t.\t%s\t%s\t%.2f\t%s\t%s\tGT:GQ:DP:AD:AF\t%s:%d:%d:%s:%s\n" % (
        chromosome, position, reference_base, alternate_base, quality_score,
        filtration_value, information_string, genotype_string,
        quality_score, read_depth, allele_depth, allele_frequency_s,
    )


def batch_decode(
    position_infos: Sequence[str],
    alt_infos: Sequence,
    batch_probabilities: np.ndarray,
    config: DecodeConfig,
) -> List[str]:
    """Decode a batch of candidates; returns the emitted VCF rows."""
    rows = []
    for pos_info, alt_info, probs in zip(position_infos, alt_infos, batch_probabilities):
        row = decode_candidate(pos_info, alt_info, probs, config)
        if row is not None:
            rows.append(row)
    return rows
