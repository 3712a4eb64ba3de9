"""Multi-task label spaces for the variant-calling heads.

Semantics match the reference label definitions (clair3/task/gt21.py,
clair3/task/genotype.py, clair3/task/variant_length.py, clair3/task/main.py):

* gt21    — 21 classes: 10 unordered SNP base pairs, DelDel, {A,C,G,T}Del,
            InsIns, {A,C,G,T}Ins, InsDel.
* zygosity — 3 classes: 0/0, 1/1, 0/1 (1/2 folds into 0/1 for the task head).
* variant length ×2 — signed indel length in [-16, 16], one-hot of size 33,
            one per allele, sorted ascending.
"""

from __future__ import annotations

from enum import IntEnum

GT21_LABELS: tuple = (
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DelDel", "ADel", "CDel", "GDel", "TDel",
    "InsIns", "AIns", "CIns", "GIns", "TIns",
    "InsDel",
)
_GT21_INDEX = {label: i for i, label in enumerate(GT21_LABELS)}


class GT21(IntEnum):
    AA = 0; AC = 1; AG = 2; AT = 3; CC = 4; CG = 5; CT = 6; GG = 7; GT = 8; TT = 9  # noqa: E702
    DelDel = 10; ADel = 11; CDel = 12; GDel = 13; TDel = 14                          # noqa: E702
    InsIns = 15; AIns = 16; CIns = 17; GIns = 18; TIns = 19                          # noqa: E702
    InsDel = 20


HOMO_SNP_GT21 = (GT21.AA, GT21.CC, GT21.GG, GT21.TT)
HETERO_SNP_GT21 = (GT21.AC, GT21.AG, GT21.AT, GT21.CG, GT21.CT, GT21.GT)
HOMO_SNP_LABELS = tuple(GT21_LABELS[g] for g in HOMO_SNP_GT21)
HETERO_SNP_LABELS = tuple(GT21_LABELS[g] for g in HETERO_SNP_GT21)

GENOTYPES = ("0/0", "1/1", "0/1", "1/2")


class Genotype(IntEnum):
    homo_reference = 0
    homo_variant = 1
    hetero_variant = 2
    hetero_variant_multi = 3


class _VariantLength:
    index_offset = 16
    min = -16
    max = 16
    output_label_count = 33


VariantLength = _VariantLength


def gt21_enum_from_label(label: str) -> int:
    return _GT21_INDEX[label]


def partial_label_from(ref: str, alt: str) -> str:
    """One allele's contribution: 'Del', 'Ins', or its first base."""
    if len(ref) > len(alt):
        return "Del"
    if len(ref) < len(alt):
        return "Ins"
    return alt[0]


def mix_two_partial_labels(label1: str, label2: str) -> str:
    # two SNP bases -> sorted pair (AA..TT)
    if len(label1) == 1 and len(label2) == 1:
        return label1 + label2 if label1 <= label2 else label2 + label1
    # base + indel -> e.g. ADel / CIns
    a, b = label1, label2
    if len(label1) > 1 and len(label2) == 1:
        a, b = label2, label1
    if len(b) > 1 and len(a) == 1:
        return a + b
    # InsIns / DelDel
    if label1 and label2 and label1 == label2:
        return label1 + label2
    return GT21_LABELS[GT21.InsDel]


def genotype_string_from(genotype_enum: int) -> str:
    try:
        return GENOTYPES[genotype_enum]
    except (IndexError, TypeError):
        return ""


def genotype_enum_from(genotype_1: int, genotype_2: int) -> int:
    if genotype_1 == 0 and genotype_2 == 0:
        return Genotype.homo_reference
    if genotype_1 == genotype_2:
        return Genotype.homo_variant
    if genotype_1 != 0 and genotype_2 != 0:
        return Genotype.hetero_variant_multi
    return Genotype.hetero_variant


def genotype_enum_for_task(genotype: int) -> int:
    """The zygosity head folds 1/2 into the het class."""
    if genotype == Genotype.hetero_variant_multi:
        return Genotype.hetero_variant
    return genotype
