"""Typed configuration for clair3_tpu_torch.

Replaces the reference's dynamically-imported constant modules
(``shared/param_p.py`` / ``shared/param_f.py``) and the platform-default
resolution logic of ``run_clair3.py:304-326`` with explicit dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Label space geometry (reference: shared/param_p.py:37-39, clair3/task/*)
# ---------------------------------------------------------------------------

GT21_LABEL_COUNT = 21
GENOTYPE_LABEL_COUNT = 3
VARIANT_LENGTH_OFFSET = 16
VARIANT_LENGTH_LABEL_COUNT = 2 * VARIANT_LENGTH_OFFSET + 1  # 33

LABEL_SHAPE = (
    GT21_LABEL_COUNT,
    GENOTYPE_LABEL_COUNT,
    VARIANT_LENGTH_LABEL_COUNT,
    VARIANT_LENGTH_LABEL_COUNT,
)
LABEL_CUM = tuple(
    sum(LABEL_SHAPE[: i + 1]) for i in range(len(LABEL_SHAPE))
)  # (21, 24, 57, 90)

FLANKING_BASE_NUM = 16
NO_OF_POSITIONS = 2 * FLANKING_BASE_NUM + 1  # 33

# Pileup tensor channels (reference: shared/param_p.py:32)
PILEUP_CHANNELS = (
    "A", "C", "G", "T", "I", "I1", "D", "D1", "*",
    "a", "c", "g", "t", "i", "i1", "d", "d1", "#",
)
PILEUP_CHANNEL_SIZE = len(PILEUP_CHANNELS)  # 18

# Full-alignment tensor channels (reference: shared/param_f.py:23-25)
FA_CHANNELS = (
    "reference_base", "alternative_base", "mapping_quality", "base_quality",
    "strand_info", "variant_type", "insert_base", "phasing_info",
)
FA_CHANNEL_SIZE = len(FA_CHANNELS)  # 8 (+1 with dwell)


# ---------------------------------------------------------------------------
# Platform presets
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlatformPreset:
    """Per-platform defaults (reference: run_clair3.py:304-326, param_*.py)."""

    name: str
    snp_min_af: float
    indel_min_af: float
    var_pct_full: float
    ref_pct_full: float
    var_pct_phasing: float
    matrix_depth: int          # full-alignment tensor read rows (param_f.py:11)
    max_depth: int = 144       # pileup rescale threshold base (param_p.py:14)


PLATFORMS = {
    "ont": PlatformPreset(
        name="ont", snp_min_af=0.08, indel_min_af=0.15,
        var_pct_full=0.7, ref_pct_full=0.1, var_pct_phasing=0.7,
        matrix_depth=89,
    ),
    "hifi": PlatformPreset(
        name="hifi", snp_min_af=0.08, indel_min_af=0.08,
        var_pct_full=0.3, ref_pct_full=0.3, var_pct_phasing=0.7,
        matrix_depth=55,
    ),
    "ilmn": PlatformPreset(
        name="ilmn", snp_min_af=0.08, indel_min_af=0.08,
        var_pct_full=0.3, ref_pct_full=0.3, var_pct_phasing=0.7,
        matrix_depth=55,
    ),
}


# ---------------------------------------------------------------------------
# Calling configuration
# ---------------------------------------------------------------------------

@dataclass
class CallConfig:
    """End-to-end calling configuration (reference: run_clair3.py arg surface)."""

    platform: str = "ont"
    bam_fn: str = ""
    ref_fn: str = ""
    output_dir: str = ""
    sample_name: str = "SAMPLE"
    bed_fn: Optional[str] = None
    vcf_fn: Optional[str] = None       # genotyping-at-sites mode
    ctg_name: Optional[str] = None

    # Candidate selection (reference: clair3_pileup.c:373-390)
    snp_min_af: Optional[float] = None
    indel_min_af: Optional[float] = None
    min_coverage: int = 2              # param_p.py:22
    min_mq: int = 5                    # param_p.py:20
    min_contig_size: int = 0           # skip contigs shorter than this (run_clair3.py --min_contig_size)
    chunk_num: Optional[int] = None    # per-contig chunk count override (CheckEnvs --chunk_num)
    min_bq: int = 0

    # Cascade routing (run_clair3.py:304-313)
    var_pct_full: Optional[float] = None
    ref_pct_full: Optional[float] = None
    var_pct_phasing: Optional[float] = None

    # Modes
    pileup_only: bool = False
    gvcf: bool = False
    print_ref_calls: bool = False
    haploid_precise: bool = False
    haploid_sensitive: bool = False
    enable_long_indel: bool = False
    enable_dwell_time: bool = False
    call_snp_only: bool = False
    fast_mode: bool = False            # ONT: clamp SNP AF>=0.15, min_coverage>=4
    include_all_ctgs: bool = False     # default: major contigs chr{1..22,X,Y} only
    remove_intermediate_dir: bool = False
    output_all_contigs_in_gvcf_header: bool = False
    call_low_seq_entropy: bool = False  # route low-entropy windows to FA
    seq_entropy_pro: float = 0.05
    enable_variant_calling_at_sequence_head_and_tail: bool = False
    no_phasing_for_fa: bool = False
    keep_iupac_bases: bool = False
    use_phasing_for_final_output: bool = False
    use_haplotagging_for_final_output: bool = False
    qual: Optional[int] = 2            # QUAL cutoff marking LowQual (run_clair3.py --qual default 2)
    output_probabilities_fn: Optional[str] = None  # debug: dump raw head probs
    debug: bool = False                # print raw head probabilities per
                                       # candidate instead of VCF rows
                                       # (CallVariants.py:259-277,1342-1351)
    base_err: float = 0.001            # gVCF (param_p.py:27)
    gq_bin_size: int = 5               # gVCF (param_p.py:28)

    # Execution
    threads: int = 4
    chunk_size: int = 5_000_000        # run_clair3.py:50
    batch_size: int = 2048             # device batch (statically padded)
    use_bf16: bool = True
    # Multi-host (pod slice): this process owns every
    # dist_process_count-th genome chunk (parallel/distributed.py;
    # reference analogue: manual contig splits / torchrun RANK)
    dist_process_id: int = 0
    dist_process_count: int = 1

    # Models
    pileup_model: Optional[str] = None
    full_alignment_model: Optional[str] = None

    # Long indel inference bound (param_p.py:16-17)
    maximum_variant_length_that_need_infer: int = 50
    maximum_variant_length_that_need_infer_long: int = 100_000

    def resolved(self) -> "CallConfig":
        """Fill platform-derived defaults (reference: run_clair3.py:304-326)."""
        if self.platform not in PLATFORMS:
            raise ValueError(f"unknown platform {self.platform!r}; expected one of {sorted(PLATFORMS)}")
        p = PLATFORMS[self.platform]
        out = dataclasses.replace(self)
        if out.vcf_fn:
            # Genotyping-at-known-sites mode: zero the AF thresholds so every
            # known site is tensorized and model-genotyped, never silently
            # dropped by the platform AF gates (run_clair3.py:393-395).
            out.snp_min_af = 0.0
            out.indel_min_af = 0.0
        if out.snp_min_af is None:
            out.snp_min_af = p.snp_min_af
        if out.indel_min_af is None:
            out.indel_min_af = p.indel_min_af
        if out.fast_mode and out.platform == "ont":
            # Fast mode (ONT only): raise the SNP AF floor to the platform
            # min_af (0.15) and require >=4x coverage, trading recall for
            # speed (reference: CreateTensorPileupFromCffi.py:276-278,
            # shared/param_p.py:12 min_af_dict).
            out.snp_min_af = max(out.snp_min_af, 0.15)
            out.min_coverage = max(out.min_coverage, 4)
        if out.var_pct_full is None:
            out.var_pct_full = p.var_pct_full
        if out.ref_pct_full is None:
            out.ref_pct_full = p.ref_pct_full
        if out.var_pct_phasing is None:
            out.var_pct_phasing = p.var_pct_phasing
        return out

    @property
    def preset(self) -> PlatformPreset:
        return PLATFORMS[self.platform]

    @property
    def matrix_depth(self) -> int:
        return PLATFORMS[self.platform].matrix_depth

    @property
    def max_indel_length(self) -> int:
        return (
            self.maximum_variant_length_that_need_infer_long
            if self.enable_long_indel
            else self.maximum_variant_length_that_need_infer
        )

    @property
    def fa_channels(self) -> int:
        return FA_CHANNEL_SIZE + (1 if self.enable_dwell_time else 0)


# ---------------------------------------------------------------------------
# Training configuration (reference: clair3/Train.py, shared/param_*.py:47-56)
# ---------------------------------------------------------------------------
